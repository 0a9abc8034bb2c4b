"""The port's sharded CUDA kernels (K3-K6) and K7 on the card, held against
their plain versions and the CPU; the grouping pass of K3/K4
(``group_by_shard``) against its plain version and a stable argsort; and
the tile-sorted K5/K6 against their plain versions and the plan-order
launch, at batches around the tile size, on skewed, unserved and
out-of-range lanes and on K7's keep blocks, with no grouping pass
launched.

Needs a CUDA card, nvcc and no JAX; every test here is marked ``gpu`` and
skips without a card.  Run on a card machine with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_sharded_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import sharded as tsh
from repro_torch.kernels import _build
from repro_torch.kernels import foresight_traverse as tft
from repro_torch.kernels import ops as tops
from repro_torch.kernels import shard_group as tsg

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


def _shard_ids(traffic, batch, n_shards, seed):
    """Lane shard ids: uniform, all in one shard, Zipf(1.2) by rank (shard 0
    hottest), or uniform over [-1, S] (ids -1 and S are outside)."""
    rng = np.random.default_rng(seed)
    if traffic == "uniform":
        sid = rng.integers(0, n_shards, batch)
    elif traffic == "one_shard":
        sid = np.full(batch, n_shards // 2)
    elif traffic == "zipf":
        sid = (rng.zipf(1.2, batch) - 1) % n_shards
    else:
        sid = rng.integers(-1, n_shards + 1, batch)
    return sid.astype(np.int32)


def _check_grouping(cuda, sid_np, n_shards, seed=0):
    sid = torch.from_numpy(sid_np).to(cuda)
    q = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 1 << 30, sid_np.shape[0]).astype(np.int32)).to(cuda)
    before = tsg.group_by_shard.launches
    q_s, sid_s, perm, offsets = tsg.group_by_shard(sid, q, n_shards)
    assert tsg.group_by_shard.launches == before + 1
    torch.cuda.synchronize()
    _check((perm, offsets), tsg.group_by_shard_plain(sid, n_shards))
    mapped = torch.where((sid >= 0) & (sid < n_shards), sid, n_shards)
    assert torch.equal(perm.long(), torch.argsort(mapped, stable=True))
    assert torch.equal(q_s, q[perm.long()])
    assert torch.equal(sid_s, sid[perm.long()])
    _check((q_s, sid_s, perm, offsets),
           tsg.group_by_shard(sid, q, n_shards),
           tsg.group_by_shard(sid.cpu(), q.cpu(), n_shards))


@pytest.mark.parametrize("traffic",
                         ["uniform", "one_shard", "zipf", "out_of_range"])
@pytest.mark.parametrize("batch", [1, 37, 2047, 2048, 2049, 2**20])
@pytest.mark.parametrize("n_shards", [1, 8, 64, 1024])
def test_group_by_shard_equals_plain_and_stable_argsort_on_card(
        cuda, n_shards, batch, traffic):
    _check_grouping(cuda, _shard_ids(traffic, batch, n_shards, batch),
                    n_shards, batch)


def test_group_by_shard_takes_its_cap_and_refuses_past_it(cuda):
    cap = tsg.MAX_GROUP_SHARDS
    assert cap >= 8192
    _check_grouping(cuda, _shard_ids("out_of_range", 2**20, cap, 1), cap)
    sid = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="MAX_GROUP_SHARDS"):
        tsg.group_by_shard(sid, sid, cap + 1)
    fused = torch.zeros((cap + 1, 1, 2, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="MAX_GROUP_SHARDS"):
        tft.foresight_traverse_sharded(fused, sid, sid)
    with pytest.raises(ValueError, match="MAX_GROUP_SHARDS"):
        tft.base_traverse_sharded(fused[..., 0].contiguous(),
                                  fused[:, 0, :, 0].contiguous(), sid, sid)


def _lanes(shl, keys, traffic, batch, seed):
    """(shard ids, queries) on the index: half hits, every lane in shard 0,
    Zipf(1.2) by key rank, or half hits with ids -1 and S mixed in."""
    rng = np.random.default_rng(seed)
    if traffic == "zipf":
        q = keys[(rng.zipf(1.2, batch) - 1) % len(keys)]
    elif traffic == "one_shard":
        b1 = (int(shl.boundaries[1]) if shl.n_shards > 1 else 1 << 22)
        q = rng.choice(keys[keys < b1], batch)
    else:
        q = np.concatenate([rng.choice(keys, batch // 2),
                            rng.integers(0, 1 << 22, batch - batch // 2)])
    q = torch.from_numpy(q.astype(np.int32)).to(shl.device)
    sid = tsh.route(shl.boundaries, q)
    if traffic == "out_of_range":
        sid[::5] = -1
        sid[2::5] = shl.n_shards
    return sid, q


@pytest.mark.parametrize("traffic",
                         ["half_hit", "one_shard", "zipf", "out_of_range"])
@pytest.mark.parametrize("n_shards", [1, 8, 9])
@pytest.mark.parametrize("foresight", [True, False])
def test_grouped_dense_walk_equals_plain_and_cpu_on_card(cuda, foresight,
                                                         n_shards, traffic):
    shl, keys = _index(cuda, n_shards, foresight)
    sid, q = _lanes(shl, keys, traffic, 2049, n_shards)
    (dense, dense_plain), _ = _kernels(shl)
    before = dense.launches, tsg.group_by_shard.launches
    got = dense(*_tables(shl), sid, q)
    assert (dense.launches, tsg.group_by_shard.launches) == (
        before[0] + 1, before[1] + 1)
    _check(got, dense_plain(*_tables(shl), sid, q),
           dense_plain(*(t.cpu() for t in _tables(shl)), sid.cpu(), q.cpu()))
    if traffic == "out_of_range":
        assert int(got[0][::5].abs().sum() + got[1][2::5].abs().sum()) == 0


# ---------------------------------------------------------------------------
# The tile-sorted K5 / K6: one launch that sorts each tile of plan lanes by
# key in shared memory, then walks it
# ---------------------------------------------------------------------------

T = tft.CLUSTERED_TILE       # plan lanes a block sorts and walks


def _plan_args(shl, q):
    plan = tops.cluster_queries(shl.boundaries, tops._pad(q)[0])
    return plan, (plan.block_sids, plan.ndist, plan.sid_sorted,
                  plan.q_sorted)


def _plan_order(shl, args, fat=None, max_steps=0):
    """K5 / K6 in the plan's lane order, one thread a lane (the launch the
    tile sort replaced, kept as a yardstick), through the launcher
    directly; it counts nothing."""
    tables = _tables(shl)
    S, L, cap = tables[0].shape[:3]
    bs, nd, sid, q = args
    node, key = torch.empty_like(q), torch.empty_like(q)
    _build.launch("foresight_clustered_plan_order_launch" if shl.foresight
                  else "base_clustered_plan_order_launch",
                  *(t.data_ptr() for t in tables),
                  None if fat is None else fat.data_ptr(),
                  *(t.data_ptr() for t in args), node.data_ptr(),
                  key.data_ptr(), q.numel(), S, bs.shape[1], L, cap,
                  1 if fat is None else fat.shape[-1],
                  max_steps or tft.traversal_bound(L, cap),
                  torch.cuda.current_stream().cuda_stream)
    return node, key


def _check_tile_sorted(shl, args, fat=None):
    """The wrapper (the tile-sorted launch, counted once) equals the plain
    version, on the card and on the CPU, and the plan-order launch, at the
    default step cap and at 9 steps."""
    _, (clus, clus_plain) = _kernels(shl)
    fk = () if fat is None else (fat,)
    for max_steps in (0, 9):
        before = clus.launches
        got = clus(*_tables(shl), *args, *fk, max_steps=max_steps)
        assert clus.launches == before + 1
        _check(got, clus_plain(*_tables(shl), *args, *fk,
                               max_steps=max_steps),
               clus_plain(*(t.cpu() for t in _tables(shl)),
                          *(a.cpu() for a in args),
                          *(f.cpu() for f in fk), max_steps=max_steps))
        _check(got, _plan_order(shl, args, fat, max_steps))


@pytest.mark.parametrize("batch", [128, 3 * 128, T - 128, T + 128,
                                   5 * T + 384])
@pytest.mark.parametrize("foresight", [True, False])
def test_tile_sorted_k5_k6_equal_plain_and_plan_order_on_card(
        cuda, foresight, batch):
    shl, keys = _index(cuda, 9, foresight)
    rng = np.random.default_rng(batch)
    q = np.concatenate([rng.choice(keys, batch // 2),
                        rng.integers(0, 1 << 22, batch - batch // 2)])
    _, args = _plan_args(shl, torch.from_numpy(q.astype(np.int32)).to(cuda))
    assert args[3].numel() == batch
    _check_tile_sorted(shl, args)


def _tile_lanes(shl, keys, traffic, rng):
    """A batch of 3 tiles + 384 lanes and its plan arguments, for
    ``traffic``: every lane on one key, Zipf(1.2) by key rank, half hits
    with every block's slots cut to one (ndist kept: the lanes of a
    block's other shards are not served), or half hits with shard ids -1
    and S written into the plan's lanes."""
    batch = 3 * T + 384
    if traffic == "one_key":
        q = np.full(batch, keys[700])
    elif traffic == "zipf":
        q = keys[(rng.zipf(1.2, batch) - 1) % len(keys)]
    else:
        q = np.concatenate([rng.choice(keys, batch // 2),
                            rng.integers(0, 1 << 22, batch - batch // 2)])
    plan, args = _plan_args(shl, torch.from_numpy(q.astype(np.int32)).to(
        shl.device))
    bs, nd, sid, q = args
    if traffic == "slots_cut":
        bs = bs[:, :1].contiguous()
    elif traffic == "out_of_range":
        sid = sid.clone()
        sid[::5] = -1
        sid[2::5] = shl.n_shards
    return plan, (bs, nd, sid, q)


@pytest.mark.parametrize("traffic",
                         ["one_key", "zipf", "slots_cut", "out_of_range"])
@pytest.mark.parametrize("foresight", [True, False])
def test_tile_sorted_k5_k6_on_skewed_and_unserved_lanes_on_card(
        cuda, foresight, traffic):
    shl, keys = _index(cuda, 9, foresight)
    plan, args = _tile_lanes(shl, keys, traffic, np.random.default_rng(3))
    if traffic in ("slots_cut", "out_of_range"):
        # tiles that hold lanes of three shards or more, some not walking
        tiles = plan.sid_sorted[:3 * T].reshape(3, T)
        assert max(int(torch.unique(t).numel()) for t in tiles) >= 3
    _check_tile_sorted(shl, args)
    if traffic == "out_of_range":
        _, (clus, _) = _kernels(shl)
        node, key = clus(*_tables(shl), *args)
        assert int(node[::5].abs().sum() + key[2::5].abs().sum()) == 0


@pytest.mark.parametrize("foresight", [True, False])
def test_k7_keep_blocks_on_tiles_equal_cpu(cuda, foresight):
    """The straddle stream takes K7's split: its keep blocks go through
    the tile-sorted K5 / K6 with their slots cut to k_small."""
    shl, _ = _index(cuda, 9, foresight)
    cpu, _ = _index("cpu", 9, foresight)
    q = torch.from_numpy(_straddle_stream(shl.boundaries, n_blocks=40)
                         ).to(cuda)
    plan = tops.cluster_queries(shl.boundaries, tops._pad(q)[0])
    assert tops.plan_degeneration_split(plan.ndist, 9) is not None
    _, (clus, _) = _kernels(shl)
    before = clus.launches
    got = tops.search_kernel_sharded(shl, q)
    assert clus.launches == before + 1
    want = tops.search_kernel_sharded(cpu, q.cpu())
    for f in got._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.parametrize("foresight", [True, False])
def test_clustered_call_launches_no_grouping_pass(cuda, foresight):
    """A K5 / K6 call is one launch: neither grouping pass runs, through
    the wrapper or through search_kernel_sharded's clustered path."""
    shl, keys = _index(cuda, 9, foresight)
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.choice(keys, 3 * T).astype(np.int32)).to(cuda)
    _, args = _plan_args(shl, q)
    (dense, _), (clus, _) = _kernels(shl)
    passes = (tsg.group_by_key.launches, tsg.group_by_shard.launches)
    before = clus.launches, dense.launches
    clus(*_tables(shl), *args)
    tops.search_kernel_sharded(shl, q, cluster=True)
    assert (clus.launches, dense.launches) == (before[0] + 2, before[1])
    assert (tsg.group_by_key.launches,
            tsg.group_by_shard.launches) == passes
