"""The port's sharded CUDA kernels (K3-K6) and K7 on the card, held against
their plain versions and the CPU.

Needs a CUDA card, nvcc and no JAX; every test here is marked ``gpu`` and
skips without a card.  Run on a card machine with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_sharded_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import sharded as tsh
from repro_torch.kernels import foresight_traverse as tft
from repro_torch.kernels import ops as tops

pytestmark = pytest.mark.gpu
QBLK = tft.QBLK


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _index(device, n_shards, foresight, n=1500, levels=12, seed=0):
    """The reference tests' index (n=1500 keys in [0, 2^22), vals 3*keys);
    S=9 is S=8 with shard 0 split at its median."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(1 << 22, n, replace=False)).astype(np.int32)
    shl = tsh.build_sharded(keys, keys * 3, n_shards=min(n_shards, 8),
                            levels=levels, foresight=foresight, seed=seed,
                            device=device)
    if n_shards == 9:
        shl = tsh.split_shard(shl, 0)
    return shl, keys


def _tables(shl):
    return ((shl.shards.fused,) if shl.foresight
            else (shl.shards.nxt, shl.shards.keys))


def _kernels(shl):
    if shl.foresight:
        return ((tft.foresight_traverse_sharded,
                 tft.foresight_traverse_sharded_plain),
                (tft.foresight_traverse_clustered,
                 tft.foresight_traverse_clustered_plain))
    return ((tft.base_traverse_sharded, tft.base_traverse_sharded_plain),
            (tft.base_traverse_clustered, tft.base_traverse_clustered_plain))


def _straddle_stream(boundaries, n_blocks=4, tail_per_shard=2):
    b = boundaries.cpu().numpy().astype(np.int64)
    S = b.shape[0]
    n_tail = tail_per_shard * (S - 1)
    rng = np.random.default_rng(99)
    hot = rng.integers(0, b[1], n_blocks * QBLK - n_tail)
    tail = np.concatenate([
        np.linspace(b[i], (b[i + 1] if i + 1 < S else b[-1] + 2) - 1,
                    tail_per_shard, dtype=np.int64) for i in range(1, S)])
    return np.concatenate([hot, tail]).astype(np.int32)


def _check(got, want, cpu=None):
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w)
        if cpu is not None:
            assert torch.equal(g.cpu(), cpu[i])


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("n_shards", [1, 8, 9])
@pytest.mark.parametrize("batch", [1, 37, 128, 300, 4096])
def test_sharded_kernels_equal_plain_on_card(cuda, n_shards, foresight,
                                             batch):
    shl, keys = _index(cuda, n_shards, foresight)
    rng = np.random.default_rng(batch)
    q = np.concatenate([rng.choice(keys, batch // 2),
                        rng.integers(0, 1 << 22, batch - batch // 2)])
    q = torch.from_numpy(q.astype(np.int32)).to(cuda)
    sid = tsh.route(shl.boundaries, q)
    (dense, dense_plain), (clus, clus_plain) = _kernels(shl)
    before = dense.launches
    got = dense(*_tables(shl), sid, q)
    assert dense.launches == before + 1
    _check(got, dense_plain(*_tables(shl), sid, q),
           dense_plain(*(t.cpu() for t in _tables(shl)), sid.cpu(), q.cpu()))
    for max_steps in (1, 9):
        _check(dense(*_tables(shl), sid, q, max_steps=max_steps),
               dense_plain(*_tables(shl), sid, q, max_steps=max_steps))
    plan = tops.cluster_queries(shl.boundaries, tops._pad(q)[0])
    args = (plan.block_sids, plan.ndist, plan.sid_sorted, plan.q_sorted)
    before = clus.launches
    got = clus(*_tables(shl), *args)
    assert clus.launches == before + 1
    _check(got, clus_plain(*_tables(shl), *args))
    cut = (plan.block_sids[:, :1].contiguous(), *args[1:])   # unserved lanes
    _check(clus(*_tables(shl), *cut), clus_plain(*_tables(shl), *cut))


@pytest.mark.parametrize("foresight", [True, False])
def test_unrouted_lanes_give_zero_on_card(cuda, foresight):
    shl, keys = _index(cuda, 8, foresight)
    q = torch.from_numpy(keys[:300].copy()).to(cuda)
    sid = tsh.route(shl.boundaries, q)
    sid[::7] = -1
    sid[3::7] = 8
    (dense, dense_plain), _ = _kernels(shl)
    got = dense(*_tables(shl), sid, q)
    _check(got, dense_plain(*_tables(shl), sid, q))
    assert int(got[0][::7].abs().sum()) == 0


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("n_shards", [8, 9])
def test_straddle_stream_takes_k7_and_equals_cpu(cuda, n_shards, foresight):
    shl, keys = _index(cuda, n_shards, foresight)
    cpu, _ = _index("cpu", n_shards, foresight)
    q = torch.from_numpy(_straddle_stream(shl.boundaries)).to(cuda)
    plan = tops.cluster_queries(shl.boundaries, tops._pad(q)[0])
    assert tops.plan_degeneration_split(plan.ndist, n_shards) is not None
    (dense, _), (clus, _) = _kernels(shl)
    d0, c0 = dense.launches, clus.launches
    got = tops.search_kernel_sharded(shl, q, cluster=True)
    assert (dense.launches, clus.launches) == (d0 + 1, c0 + 1)   # K7
    want = tops.search_kernel_sharded(cpu, q.cpu(), cluster=True)
    for f in got._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    dense_res = tops.search_kernel_sharded(shl, q, cluster=False)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(dense_res, f)), f
    f, v = tsh.search_sharded(shl, q)
    assert torch.equal(f, got.found) and torch.equal(v, got.vals)
    with pytest.raises(ValueError, match="k_shards"):
        tops.search_kernel_sharded(shl, q, k_shards=2)


@pytest.mark.parametrize("foresight", [True, False])
def test_sharded_build_and_updates_on_card_equal_cpu(cuda, foresight):
    shl, keys = _index(cuda, 8, foresight)
    cpu, _ = _index("cpu", 8, foresight)
    for a, b in zip(shl.shards, cpu.shards):
        assert (a is None and b is None) or torch.equal(a.cpu(), b)
    rng = np.random.default_rng(4)
    ops = rng.integers(0, 3, 200).astype(np.int32)
    kk = np.concatenate([rng.choice(keys, 100),
                         rng.integers(0, 1 << 22, 100)]).astype(np.int32)
    got, res = tsh.apply_ops_sharded(shl, ops, kk, kk, rebalance=True)
    want, res_c = tsh.apply_ops_sharded(cpu, ops, kk, kk, rebalance=True)
    assert torch.equal(res.cpu(), res_c)
    assert got.n_shards == want.n_shards
    for a, b in zip(got.shards, want.shards):
        assert (a is None and b is None) or torch.equal(a.cpu(), b)
    assert torch.equal(got.boundaries.cpu(), want.boundaries)


def test_empty_batch_launches_nothing(cuda):
    shl, _ = _index(cuda, 4, True)
    q = torch.empty(0, dtype=torch.int32, device=cuda)
    before = tft.foresight_traverse_sharded.launches
    node, key = tft.foresight_traverse_sharded(shl.shards.fused, q, q)
    assert node.shape == key.shape == (0,)
    assert tft.foresight_traverse_sharded.launches == before
