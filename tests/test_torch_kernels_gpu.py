"""The port's CUDA kernels on the card, held against their plain versions.

Needs a CUDA card, nvcc and no JAX; every test here is marked ``gpu`` and
skips without a card.  Run on a card machine with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels_gpu.py

(``--noconftest``: the suite's conftest imports JAX, which the card machine
need not have).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import skiplist as tsl
from repro_torch.kernels import ops as tops
from repro_torch.kernels import foresight_traverse as tft

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _keys(n, seed, span=1 << 22):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(span, n, replace=False)).astype(np.int32)


def _queries(keys, batch, seed, span=1 << 22):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.choice(keys, batch // 2),
                           rng.integers(0, span, batch - batch // 2)]
                          ).astype(np.int32)


def _tables(st):
    return (st.fused,) if st.foresight else (st.nxt, st.keys)


def _kernel(st):
    if st.foresight:
        return tft.foresight_traverse, tft.foresight_traverse_plain
    return tft.base_traverse, tft.base_traverse_plain


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("n,cap,levels", [(16, 64, 4), (4000, 8192, 14)])
def test_card_build_equals_cpu_build(cuda, n, cap, levels, foresight):
    keys = _keys(n, n)
    args = dict(capacity=cap, levels=levels, foresight=foresight, seed=n)
    st = tsl.build(keys, keys + 1, **args)          # device=None: the card
    cpu = tsl.build(keys, keys + 1, device="cpu", **args)
    assert st.device.type == "cuda"
    for name, t in st._asdict().items():
        if t is not None:
            assert torch.equal(t.cpu(), getattr(cpu, name)), name


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("batch", [1, 37, 256, 257, 4096])
def test_kernel_equals_plain_on_card(cuda, foresight, batch):
    keys = _keys(4000, 3)
    st = tsl.build(keys, keys + 1, capacity=8192, levels=14,
                   foresight=foresight, seed=3, device=cuda)
    q = torch.from_numpy(_queries(keys, batch, batch)).to(cuda)
    wrapper, plain = _kernel(st)
    before = wrapper.launches
    got = wrapper(*_tables(st), q)
    assert wrapper.launches == before + 1
    want = plain(*_tables(st), q)
    cpu = plain(*(t.cpu() for t in _tables(st)), q.cpu())
    for g, w, c in zip(got, want, cpu):
        assert torch.equal(g, w)
        assert torch.equal(g.cpu(), c)


@pytest.mark.parametrize("foresight", [True, False])
def test_kernel_max_steps_truncates_like_plain(cuda, foresight):
    keys = _keys(1000, 5)
    st = tsl.build(keys, keys + 1, capacity=2048, levels=12,
                   foresight=foresight, seed=5, device=cuda)
    q = torch.from_numpy(_queries(keys, 512, 6)).to(cuda)
    wrapper, plain = _kernel(st)
    for max_steps in (1, 3, 9):
        got = wrapper(*_tables(st), q, max_steps=max_steps)
        want = plain(*_tables(st), q, max_steps=max_steps)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_empty_batch_launches_nothing(cuda):
    keys = _keys(100, 7)
    st = tsl.build(keys, keys + 1, capacity=256, levels=8, device=cuda)
    before = tft.foresight_traverse.launches
    node, key = tft.foresight_traverse(st.fused, torch.empty(0, dtype=torch.int32,
                                                            device=cuda))
    assert node.shape == key.shape == (0,)
    assert tft.foresight_traverse.launches == before


@pytest.mark.parametrize("foresight", [True, False])
def test_search_kernel_on_card_matches_cpu(cuda, foresight):
    keys = _keys(1000, 8)
    args = dict(capacity=2048, levels=12, foresight=foresight, seed=8)
    st = tsl.build(keys, keys + 1, device=cuda, **args)
    cpu = tsl.build(keys, keys + 1, device="cpu", **args)
    q = _queries(keys, 1000, 9)
    got = tops.search_kernel(st, torch.from_numpy(q).to(cuda))
    want = tops.search_kernel(cpu, torch.from_numpy(q))
    for f in got._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    fast = tsl.search_fast(st, torch.from_numpy(q).to(cuda))
    assert torch.equal(fast[0], got.found) and torch.equal(fast[1], got.vals)


def test_wrapper_rejects_wrong_dtype(cuda):
    keys = _keys(100, 10)
    st = tsl.build(keys, keys + 1, capacity=256, levels=8, device=cuda)
    q = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tft.foresight_traverse(st.fused.long(), q)
    with pytest.raises(ValueError):
        tft.foresight_traverse(st.fused, q.cpu())
