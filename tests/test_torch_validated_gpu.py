"""K8 and the write side on the card, held against their CPU versions; the
grouped K8 (lanes ordered by key range first) also against its launch on
the lanes in batch order.

Needs a CUDA card, nvcc and no JAX; every test here is marked ``gpu`` and
skips without a card.  Run on a card machine with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_validated_gpu.py

(``--noconftest``: the suite's conftest imports JAX).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import skiplist as tsl
from repro_torch.core.versioned import VersionedIndex
from repro_torch.kernels import _build
from repro_torch.kernels import shard_group as tsg
from repro_torch.kernels import validated_traverse as tvt

pytestmark = pytest.mark.gpu

SPAN = 1 << 22


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(SPAN, n, replace=False)).astype(np.int32)


def _queries(keys, batch, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.choice(keys, batch // 2),
                           rng.integers(0, SPAN, batch - batch // 2)]
                          ).astype(np.int32)


def _op_stream(keys, n, seed):
    """Reads, inserts and deletes; deletes and half the reads hit."""
    rng = np.random.default_rng(seed)
    ops = rng.choice(np.array([0, 1, 2], np.int32), n)
    ks = np.where(ops == 1, rng.integers(0, SPAN, n),
                  rng.choice(keys, n)).astype(np.int32)
    return ops, ks, ks + 1


def _table(kind, device):
    """(fused, auth_keys) of a clean, a 40%-corrupted or a lag-1 view."""
    keys = _keys(4000, 3)
    st = tsl.build(keys, keys + 1, capacity=8192, levels=14, seed=3,
                   device=device)
    if kind == "clean":
        return st.fused, st.keys, keys
    if kind == "corrupt":
        g = torch.Generator(device=device).manual_seed(4)
        fused = st.fused.clone()
        mask = torch.rand(fused.shape[:2], generator=g, device=device) < 0.4
        noise = torch.randint(-2**31 + 1, 2**31 - 1, fused.shape[:2],
                              generator=g, device=device, dtype=torch.int32)
        fused[..., 1] = torch.where(mask, noise, fused[..., 1])
        return fused, st.keys, keys
    vi = VersionedIndex(st)
    ops, ks, vs = _op_stream(keys, 300, 5)
    vi.update(*(torch.from_numpy(a).to(device) for a in (ops, ks, vs)))
    view = vi.read_view(lag=1)
    return view.fused, view.auth_keys, keys


@pytest.mark.parametrize("kind", ["clean", "corrupt", "lag1"])
@pytest.mark.parametrize("batch", [1, 37, 257, 4096])
def test_k8_equals_plain_on_card(cuda, kind, batch):
    fused, auth, keys = _table(kind, cuda)
    q = torch.from_numpy(_queries(keys, batch, batch)).to(cuda)
    before = tvt.validated_traverse.launches
    got = tvt.validated_traverse(fused, auth, q)
    assert tvt.validated_traverse.launches == before + 1
    want = tvt.validated_traverse_plain(fused, auth, q)
    cpu = tvt.validated_traverse_plain(fused.cpu(), auth.cpu(), q.cpu())
    for g, w, c in zip(got, want, cpu):
        assert torch.equal(g, w)
        assert torch.equal(g.cpu(), c)


@pytest.mark.parametrize("kind", ["corrupt", "lag1"])
def test_k8_max_steps_truncates_like_plain(cuda, kind):
    fused, auth, keys = _table(kind, cuda)
    q = torch.from_numpy(_queries(keys, 512, 6)).to(cuda)
    for max_steps in (1, 3, 9):
        got = tvt.validated_traverse(fused, auth, q, max_steps=max_steps)
        want = tvt.validated_traverse_plain(fused, auth, q,
                                            max_steps=max_steps)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("foresight", [True, False])
def test_apply_ops_on_card_equals_cpu(cuda, foresight):
    keys = _keys(1000, 7)
    args = dict(capacity=2048, levels=12, foresight=foresight, seed=7)
    ops, ks, vs = (torch.from_numpy(a) for a in _op_stream(keys, 400, 8))
    st, res = tsl.apply_ops(tsl.build(keys, keys + 1, device=cuda, **args),
                            ops.to(cuda), ks.to(cuda), vs.to(cuda))
    cpu, cres = tsl.apply_ops(tsl.build(keys, keys + 1, device="cpu",
                                        **args), ops, ks, vs)
    assert res.device.type == "cuda" and torch.equal(res.cpu(), cres)
    for name, t in st._asdict().items():
        if t is not None:
            assert torch.equal(t.cpu(), getattr(cpu, name)), name


@pytest.mark.parametrize("foresight", [True, False])
def test_exhaustion_on_card_equals_cpu(cuda, foresight):
    """The would-be node id of an insert into a full list is ``capacity``;
    no write may use it (on the card it would trip a device-side assert)."""
    ks = torch.arange(1, 11, dtype=torch.int32)
    ops = torch.ones(10, dtype=torch.int32)
    st, res = tsl.apply_ops(tsl.empty(8, 4, foresight=foresight, device=cuda),
                            ops.to(cuda), ks.to(cuda), ks.to(cuda))
    cpu, cres = tsl.apply_ops(tsl.empty(8, 4, foresight=foresight,
                                        device="cpu"), ops, ks, ks)
    torch.cuda.synchronize()
    assert res.tolist() == [1] * 6 + [0] * 4 and torch.equal(res.cpu(), cres)
    for name, t in st._asdict().items():
        if t is not None:
            assert torch.equal(t.cpu(), getattr(cpu, name)), name
    for k in range(11, 14):
        st, ok = tsl.insert(st, k, k)
        assert not bool(ok)


def test_versioned_kernel_search_on_card_equals_cpu(cuda):
    keys = _keys(4000, 9)
    ops, ks, vs = (torch.from_numpy(a) for a in _op_stream(keys, 300, 10))
    q = torch.from_numpy(_queries(keys, 3000, 11))
    results = []
    for dev in (cuda, torch.device("cpu")):
        vi = VersionedIndex(tsl.build(keys, keys + 1, capacity=8192,
                                      levels=14, seed=9, device=dev))
        vi.update(ops.to(dev), ks.to(dev), vs.to(dev))
        results.append([vi.search(q.to(dev), lag=lag, use_kernel=k)
                        for lag in (0, 1) for k in (False, True)])
    for got, want in zip(*results):
        for name, g, w in zip(got._fields, got, want):
            assert torch.equal(g.cpu(), w), name


def _ungrouped_k8(fused, auth, q, max_steps):
    """K8 on the lanes in batch order (out_idx null), through the launcher
    directly; it counts nothing."""
    L, cap, _ = fused.shape
    node, key = torch.empty_like(q), torch.empty_like(q)
    _build.launch("validated_traverse_launch", fused.data_ptr(),
                  auth.data_ptr(), None, q.data_ptr(), node.data_ptr(),
                  key.data_ptr(), q.numel(), L, cap,
                  max_steps or tvt.default_max_steps(L),
                  torch.cuda.current_stream().cuda_stream)
    return node, key


@pytest.mark.parametrize("traffic", ["half_hit", "zipf"])
@pytest.mark.parametrize("max_steps", [0, 9])
@pytest.mark.parametrize("kind", ["clean", "corrupt", "lag1"])
def test_grouped_k8_equals_plain_and_batch_order_on_card(cuda, kind,
                                                         max_steps, traffic):
    fused, auth, keys = _table(kind, cuda)
    if traffic == "zipf":
        rng = np.random.default_rng(13)
        q = keys[(rng.zipf(1.2, 2049) - 1) % len(keys)].astype(np.int32)
    else:
        q = _queries(keys, 2049, 13)
    q = torch.from_numpy(q).to(cuda)
    before = tvt.validated_traverse.launches, tsg.group_by_key.launches
    got = tvt.validated_traverse(fused, auth, q, max_steps=max_steps)
    assert (tvt.validated_traverse.launches, tsg.group_by_key.launches) == (
        before[0] + 1, before[1] + 1)
    want = tvt.validated_traverse_plain(fused, auth, q, max_steps=max_steps)
    flat = _ungrouped_k8(fused, auth, q, max_steps)
    cpu = tvt.validated_traverse_plain(fused.cpu(), auth.cpu(), q.cpu(),
                                       max_steps=max_steps)
    for g, w, f, c in zip(got, want, flat, cpu):
        assert torch.equal(g, w) and torch.equal(g, f)
        assert torch.equal(g.cpu(), c)
