"""The port's CUDA kernels on the card, held against their plain versions:
K1/K2, and their key-range grouping pass (``group_by_key``) against its
plain version and a stable argsort, and the grouped K1 and K2 against their
launch on the lanes in batch order.

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
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import foresight_traverse as tft
from repro_torch.kernels import shard_group as tsg

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


KEY_MIN, KEY_MAX = -2**31, 2**31 - 1


def _key_lanes(traffic, batch, seed):
    """Queries: uniform over [0, 2^26), Zipf(1.2) by rank over 4096 keys,
    all equal, negative, or both ends of int32 mixed in."""
    rng = np.random.default_rng(seed)
    if traffic == "uniform":
        q = rng.integers(0, 1 << 26, batch)
    elif traffic == "zipf":
        keys = np.sort(rng.choice(1 << 26, 4096, replace=False))
        q = keys[(rng.zipf(1.2, batch) - 1) % len(keys)]
    elif traffic == "all_equal":
        q = np.full(batch, 777)
    elif traffic == "negative":
        q = rng.integers(KEY_MIN + 1, 0, batch)
    else:
        q = rng.integers(KEY_MIN, KEY_MAX, batch, endpoint=True)
        q[::3], q[1::3] = KEY_MIN, KEY_MAX
    return q.astype(np.int32)


@pytest.mark.parametrize("traffic", ["uniform", "zipf", "all_equal",
                                     "negative", "extremes"])
@pytest.mark.parametrize("batch", [1, 37, 2047, 2048, 2049, 2**20])
def test_group_by_key_equals_plain_and_stable_argsort_on_card(cuda, batch,
                                                              traffic):
    q = torch.from_numpy(_key_lanes(traffic, batch, batch)).to(cuda)
    before = tsg.group_by_key.launches
    q_s, perm = tsg.group_by_key(q)
    assert tsg.group_by_key.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(perm, tsg.group_by_key_plain(q))
    assert torch.equal(perm.long(),
                       torch.argsort(tsg.key_buckets(q), stable=True))
    assert torch.equal(q_s, q[perm.long()])
    cpu = tsg.group_by_key(q.cpu())
    assert torch.equal(q_s.cpu(), cpu[0]) and torch.equal(perm.cpu(), cpu[1])


def _ungrouped_k2(st, q, fat=None, max_steps=0):
    """K2 on the lanes in batch order (out_idx null), through the launcher
    directly: the launch the grouped wrapper is held against; it counts
    nothing."""
    L, cap = st.nxt.shape
    node, key = torch.empty_like(q), torch.empty_like(q)
    _build.launch("base_traverse_launch", st.nxt.data_ptr(),
                  st.keys.data_ptr(), None if fat is None else fat.data_ptr(),
                  None, q.data_ptr(), node.data_ptr(), key.data_ptr(),
                  q.numel(), L, cap, 1 if fat is None else fat.shape[-1],
                  max_steps or tft.traversal_bound(L, cap),
                  torch.cuda.current_stream().cuda_stream)
    return node, key


@pytest.mark.parametrize("max_steps", [0, 9])
@pytest.mark.parametrize("traffic", ["half_hit", "zipf", "all_equal",
                                     "extremes"])
def test_grouped_k2_equals_plain_and_batch_order_on_card(cuda, traffic,
                                                         max_steps):
    keys = _keys(4000, 11)
    st = tsl.build(keys, keys + 1, capacity=8192, levels=14,
                   foresight=False, seed=11, device=cuda)
    rng = np.random.default_rng(12)
    if traffic == "half_hit":
        q = _queries(keys, 2049, 12)
    elif traffic == "zipf":
        q = keys[(rng.zipf(1.2, 2049) - 1) % len(keys)]
    elif traffic == "all_equal":
        q = np.full(2049, keys[2000])
    else:
        q = _key_lanes("extremes", 2049, 12)
    q = torch.from_numpy(q.astype(np.int32)).to(cuda)
    before = tft.base_traverse.launches, tsg.group_by_key.launches
    got = tft.base_traverse(st.nxt, st.keys, q, max_steps=max_steps)
    assert (tft.base_traverse.launches, tsg.group_by_key.launches) == (
        before[0] + 1, before[1] + 1)
    want = tft.base_traverse_plain(st.nxt, st.keys, q, max_steps=max_steps)
    flat = _ungrouped_k2(st, q, max_steps=max_steps)
    cpu = tft.base_traverse_plain(st.nxt.cpu(), st.keys.cpu(), q.cpu(),
                                  max_steps=max_steps)
    for g, w, f, c in zip(got, want, flat, cpu):
        assert torch.equal(g, w) and torch.equal(g, f)
        assert torch.equal(g.cpu(), c)


def _ungrouped_k1(st, q, max_steps=0):
    """K1 on the lanes in batch order (out_idx null), through the launcher
    directly; it counts nothing."""
    L, cap, _ = st.fused.shape
    node, key = torch.empty_like(q), torch.empty_like(q)
    _build.launch("foresight_traverse_launch", st.fused.data_ptr(), None,
                  None, q.data_ptr(), node.data_ptr(), key.data_ptr(),
                  q.numel(), L, cap, 1,
                  max_steps or tft.traversal_bound(L, cap),
                  torch.cuda.current_stream().cuda_stream)
    return node, key


@pytest.mark.parametrize("max_steps", [0, 9])
@pytest.mark.parametrize("batch", [1, 31, 33, 1000])
def test_grouped_k1_equals_plain_and_batch_order_on_card(cuda, batch,
                                                         max_steps):
    keys = _keys(4000, 13)
    st = tsl.build(keys, keys + 1, capacity=8192, levels=14,
                   foresight=True, seed=13, device=cuda)
    q = _queries(keys, batch, batch)
    q[-1:] = [2**31 - 1]                       # the tail sentinel's key
    q = torch.from_numpy(q).to(cuda)
    before = tft.foresight_traverse.launches, tsg.group_by_key.launches
    got = tft.foresight_traverse(st.fused, q, max_steps=max_steps)
    assert (tft.foresight_traverse.launches, tsg.group_by_key.launches) == (
        before[0] + 1, before[1] + 1)
    want = tft.foresight_traverse_plain(st.fused, q, max_steps=max_steps)
    flat = _ungrouped_k1(st, q, max_steps=max_steps)
    cpu = tft.foresight_traverse_plain(st.fused.cpu(), q.cpu(),
                                       max_steps=max_steps)
    for g, w, f, c in zip(got, want, flat, cpu):
        assert torch.equal(g, w) and torch.equal(g, f)
        assert torch.equal(g.cpu(), c)
