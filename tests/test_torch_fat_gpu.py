"""The fat-node layout on the card: K1-K6 with the K9 postlude, and K9 alone,
held against their plain versions, and fat builds and updates against the
CPU, at node widths 6 (rows not 16-byte aligned), 8, 33 (not a multiple
of 4), 128 and 256 (more than one pass of K9's warp-cooperative row
compare); on partial warps (batch 1, 31, 33), on K5/K6 blocks with
unserved lanes, on owners that are the head, the tail or the last row, and
on a table shifted off 16-byte alignment; the grouped dense walks (K3/K4
after ``group_by_shard``) with K9 on lane sets grouped every way; K1 and K2
with K9 on lanes grouped by key range (``group_by_key``), also against
their launch on the lanes in batch order.

Needs a CUDA card, nvcc and no JAX; every test here is marked ``gpu`` and
skips without a card.  Run on a card machine with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_fat_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import sharded as tsh
from repro_torch.core import skiplist as tsl
from repro_torch.kernels import _build
from repro_torch.kernels import foresight_traverse as tft
from repro_torch.kernels import ops as tops
from repro_torch.kernels import shard_group as tsg

pytestmark = pytest.mark.gpu
WIDTHS = [6, 8, 33, 128, 256]
SPAN = 1 << 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(SPAN, n, replace=False)).astype(np.int32), rng


def _half_hit(keys, rng, batch):
    return np.concatenate([rng.choice(keys, batch // 2),
                           rng.integers(0, SPAN, batch - batch // 2),
                           [2**31 - 1, 0]]).astype(np.int32)


def _mono(device, nw, foresight, n=700, seed=5):
    keys, rng = _keys(n, seed)
    cap = tsl.node_slots_for(2 * n, nw) + 8
    st = tsl.build(keys, keys * 3, capacity=cap, levels=8,
                   foresight=foresight, node_width=nw, seed=seed,
                   device=device)
    return st, keys, rng


def _sharded(device, nw, foresight, n_shards, n=1500, seed=0):
    keys, rng = _keys(n, seed)
    shl = tsh.build_sharded(keys, keys * 3, n_shards=min(n_shards, 8),
                            levels=10, foresight=foresight, node_width=nw,
                            seed=seed, device=device)
    if n_shards == 9:
        shl = tsh.split_shard(shl, 3)
    return shl, keys, rng


def _tables(st):
    return (st.fused,) if st.foresight else (st.nxt, st.keys)


def _same(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


def _same_state(a, b):
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("nw", WIDTHS)
def test_k1_k2_with_k9_equal_plain_on_card(cuda, nw, foresight):
    st, keys, rng = _mono(cuda, nw, foresight)
    kernel, plain = ((tft.foresight_traverse, tft.foresight_traverse_plain)
                     if foresight else
                     (tft.base_traverse, tft.base_traverse_plain))
    q = torch.from_numpy(_half_hit(keys, rng, 1000)).to(cuda)
    for max_steps in (0, 9):
        before = kernel.launches, kernel.fat_launches, tft.fat_resolve.launches
        got = kernel(*_tables(st), q, st.fat_keys, max_steps=max_steps)
        assert (kernel.launches, kernel.fat_launches,
                tft.fat_resolve.launches) == tuple(b + 1 for b in before)
        _same(got, plain(*_tables(st), q, st.fat_keys, max_steps=max_steps))
        cpu = [t.cpu() for t in _tables(st)]
        _same(got, plain(*cpu, q.cpu(), st.fat_keys.cpu(),
                         max_steps=max_steps))


@pytest.mark.parametrize("batch", [1, 31, 33, 777])
@pytest.mark.parametrize("nw", WIDTHS)
def test_k9_alone_equals_plain_on_card(cuda, nw, batch):
    st, keys, rng = _mono(cuda, nw, True)
    q = torch.from_numpy(_half_hit(keys, rng, batch)[-batch:]).to(cuda)
    x = torch.randint(0, int(st.bump), q.shape, dtype=torch.int32,
                      device=cuda)
    x[::5] = 0                                    # the head
    x[1::7] = 1                                   # the tail
    x[2::9] = st.capacity - 1                     # the last row, unused
    q[3::9] = 0             # an unused slot's record is (0, 0): owner head
    x[3::9] = st.capacity - 2
    before = tft.fat_resolve.launches
    got = tft.fat_resolve(st.fused, st.fat_keys, x, q)
    assert tft.fat_resolve.launches == before + 1
    _same(got, tft.fat_resolve_plain(st.fused, st.fat_keys, x, q))


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("nw", WIDTHS)
def test_k9_on_rows_not_16_byte_aligned(cuda, nw, foresight):
    """A fat table one int past a 16-byte boundary takes the 4-byte loads
    on every row; the answers are the same, in K1 / K2 and K9 alone."""
    st, keys, rng = _mono(cuda, nw, foresight)
    buf = torch.empty(st.fat_keys.numel() + 1, dtype=torch.int32,
                      device=cuda)
    shifted = buf[1:].view(st.fat_keys.shape)
    shifted.copy_(st.fat_keys)
    assert shifted.data_ptr() % 16 == 4
    q = torch.from_numpy(_half_hit(keys, rng, 500)).to(cuda)
    if foresight:
        _same(tft.foresight_traverse(st.fused, q, shifted),
              tft.foresight_traverse_plain(st.fused, q, st.fat_keys))
        x = torch.randint(0, int(st.bump), q.shape, dtype=torch.int32,
                          device=cuda)
        _same(tft.fat_resolve(st.fused, shifted, x, q),
              tft.fat_resolve_plain(st.fused, st.fat_keys, x, q))
    else:
        _same(tft.base_traverse(st.nxt, st.keys, q, shifted),
              tft.base_traverse_plain(st.nxt, st.keys, q, st.fat_keys))


@pytest.mark.parametrize("batch", [1, 31, 33])
@pytest.mark.parametrize("nw", WIDTHS)
def test_k1_to_k4_with_k9_on_partial_warps_on_card(cuda, nw, batch):
    """A batch that leaves lanes of its last warp empty: K9 runs on the
    warp's live lanes only."""
    for foresight in (True, False):
        st, keys, rng = _mono(cuda, nw, foresight)
        q = torch.from_numpy(_half_hit(keys, rng, batch)[-batch:]).to(cuda)
        kernel, plain = ((tft.foresight_traverse,
                          tft.foresight_traverse_plain) if foresight else
                         (tft.base_traverse, tft.base_traverse_plain))
        _same(kernel(*_tables(st), q, st.fat_keys),
              plain(*_tables(st), q, st.fat_keys))
        shl, keys, rng = _sharded(cuda, nw, foresight, 9)
        tables, fat = tops._tables(shl), shl.shards.fat_keys
        q = torch.from_numpy(_half_hit(keys, rng, batch)[-batch:]).to(cuda)
        sid = tsh.route(shl.boundaries, q)
        sid[::3] = -1                               # not served
        dense, dense_plain = ((tft.foresight_traverse_sharded,
                               tft.foresight_traverse_sharded_plain)
                              if foresight else
                              (tft.base_traverse_sharded,
                               tft.base_traverse_sharded_plain))
        _same(dense(*tables, sid, q, fat), dense_plain(*tables, sid, q, fat))


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("nw", WIDTHS)
def test_search_kernel_fat_on_card_equals_cpu(cuda, nw, foresight):
    st, keys, rng = _mono(cuda, nw, foresight)
    cpu, _, _ = _mono("cpu", nw, foresight)
    _same_state(st, cpu)
    q = _half_hit(keys, rng, 600)
    got = tops.search_kernel(st, torch.from_numpy(q).to(cuda))
    _same(got, tops.search_kernel(cpu, torch.from_numpy(q)))
    assert np.array_equal(got.found.cpu().numpy()[:-2], np.isin(q[:-2], keys))


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("n_shards", [8, 9])
@pytest.mark.parametrize("nw", WIDTHS)
def test_k3_to_k6_with_k9_equal_plain_on_card(cuda, nw, n_shards, foresight):
    shl, keys, rng = _sharded(cuda, nw, foresight, n_shards)
    tables, fat = tops._tables(shl), shl.shards.fat_keys
    q = torch.from_numpy(_half_hit(keys, rng, 1000)).to(cuda)
    sid = tsh.route(shl.boundaries, q)
    dense, dense_plain, clus, clus_plain = (
        (tft.foresight_traverse_sharded, tft.foresight_traverse_sharded_plain,
         tft.foresight_traverse_clustered,
         tft.foresight_traverse_clustered_plain) if foresight else
        (tft.base_traverse_sharded, tft.base_traverse_sharded_plain,
         tft.base_traverse_clustered, tft.base_traverse_clustered_plain))
    for max_steps in (0, 9):
        before = dense.fat_launches
        _same(dense(*tables, sid, q, fat, max_steps=max_steps),
              dense_plain(*tables, sid, q, fat, max_steps=max_steps))
        assert dense.fat_launches == before + 1
    plan = tops.cluster_queries(shl.boundaries, tops._pad(q)[0])
    args = (plan.block_sids, plan.ndist, plan.sid_sorted, plan.q_sorted)
    for max_steps in (0, 9):
        _same(clus(*tables, *args, fat, max_steps=max_steps),
              clus_plain(*tables, *args, fat, max_steps=max_steps))
    cut = (plan.block_sids[:, :1].contiguous(), *args[1:])   # unserved lanes
    _same(clus(*tables, *cut, fat), clus_plain(*tables, *cut, fat))


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("nw", [8, 128])
def test_fat_straddle_takes_k7_and_equals_cpu(cuda, nw, foresight):
    shl, keys, _ = _sharded(cuda, nw, foresight, 9)
    cpu, _, _ = _sharded("cpu", nw, foresight, 9)
    _same_state(shl.shards, cpu.shards)
    S = shl.n_shards
    sids = tsh.route(cpu.boundaries, torch.from_numpy(keys)).numpy()
    picks = np.array([keys[sids == s][0] for s in range(S)], np.int32)
    block = np.sort(np.concatenate([picks, keys[:tft.QBLK - S]]))
    q = torch.from_numpy(np.concatenate([keys[:3 * tft.QBLK], block])
                         ).to(cuda)
    plan = tops.cluster_queries(shl.boundaries, tops._pad(q)[0])
    assert tops.plan_degeneration_split(plan.ndist, S) is not None
    got = tops.search_kernel_sharded(shl, q)
    _same(got, tops.search_kernel_sharded(cpu, q.cpu()))
    assert bool(got.found.all())
    _same(got, tops.search_kernel_sharded(shl, q, cluster=False))
    f, v = tsh.search_sharded(shl, q)
    assert torch.equal(f, got.found) and torch.equal(v, got.vals)


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("nw", [8, 128])
def test_fat_updates_on_card_equal_cpu(cuda, nw, foresight):
    st, keys, rng = _mono(cuda, nw, foresight, n=300)
    cpu, _, _ = _mono("cpu", nw, foresight, n=300)
    ops = rng.integers(0, 3, 150).astype(np.int32)
    kk = np.concatenate([rng.choice(keys, 75),
                         rng.integers(0, SPAN, 75)]).astype(np.int32)
    got, res = tsl.apply_ops(st, ops, kk, kk * 7)
    want, res_c = tsl.apply_ops(cpu, ops, kk, kk * 7)
    assert torch.equal(res.cpu(), res_c)
    _same_state(got, want)
    assert bool(tsl.check_fat_invariant(got))
    for lo, hi in ((0, SPAN), (1000, 9000)):
        _same(tsl.range_scan(got, lo, hi, 64),
              tsl.range_scan(want, lo, hi, 64))


@pytest.mark.parametrize("nw", [8, 128])
def test_fat_sharded_rebalance_on_card_equals_cpu(cuda, nw):
    shl, keys, rng = _sharded(cuda, nw, True, 8, n=600)
    cpu, _, _ = _sharded("cpu", nw, True, 8, n=600)
    hot = int(keys[2])
    kk = (hot + (rng.zipf(1.2, 200) - 1) % 4096).astype(np.int32)
    ins = np.full(200, tsl.OP_INSERT, np.int32)
    got, res = tsh.apply_ops_sharded(shl, ins, kk, kk, rebalance=True)
    want, res_c = tsh.apply_ops_sharded(cpu, ins, kk, kk, rebalance=True)
    assert torch.equal(res.cpu(), res_c)
    assert got.n_shards == want.n_shards
    _same_state(got.shards, want.shards)
    assert torch.equal(got.boundaries.cpu(), want.boundaries)
    _same(tsh.range_scan_sharded(got, 0, SPAN, 200),
          tsh.range_scan_sharded(want, 0, SPAN, 200))


@pytest.mark.parametrize("traffic",
                         ["half_hit", "one_shard", "zipf", "out_of_range"])
@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("nw", [8, 128])
def test_grouped_k3_k4_with_k9_equal_plain_and_cpu_on_card(cuda, nw,
                                                           foresight,
                                                           traffic):
    shl, keys, rng = _sharded(cuda, nw, foresight, 9)
    cpu, _, _ = _sharded("cpu", nw, foresight, 9)
    tables, fat = tops._tables(shl), shl.shards.fat_keys
    if traffic == "zipf":
        q = keys[(rng.zipf(1.2, 2049) - 1) % len(keys)]
    elif traffic == "one_shard":
        q = rng.choice(keys[keys < int(shl.boundaries[1])], 2049)
    else:
        q = _half_hit(keys, rng, 2047)
    q = torch.from_numpy(q.astype(np.int32)).to(cuda)
    sid = tsh.route(shl.boundaries, q)
    if traffic == "out_of_range":
        sid[::5] = -1
        sid[2::5] = shl.n_shards
    dense, dense_plain = ((tft.foresight_traverse_sharded,
                           tft.foresight_traverse_sharded_plain) if foresight
                          else (tft.base_traverse_sharded,
                                tft.base_traverse_sharded_plain))
    before = dense.fat_launches, tsg.group_by_shard.launches
    got = dense(*tables, sid, q, fat)
    assert (dense.fat_launches, tsg.group_by_shard.launches) == (
        before[0] + 1, before[1] + 1)
    _same(got, dense_plain(*tables, sid, q, fat))
    _same(got, dense_plain(*tops._tables(cpu), sid.cpu(), q.cpu(),
                           cpu.shards.fat_keys))


def _batch_order(st, q):
    """K1 or K2 with K9 on the lanes in batch order (out_idx null), through
    the launcher directly; it counts nothing."""
    L, cap = st.levels, st.capacity
    node, key = torch.empty_like(q), torch.empty_like(q)
    tables = ((st.fused.data_ptr(),) if st.foresight
              else (st.nxt.data_ptr(), st.keys.data_ptr()))
    _build.launch("foresight_traverse_launch" if st.foresight
                  else "base_traverse_launch", *tables,
                  st.fat_keys.data_ptr(), None, q.data_ptr(),
                  node.data_ptr(), key.data_ptr(), q.numel(), L, cap,
                  st.fat_keys.shape[-1], tft.traversal_bound(L, cap),
                  torch.cuda.current_stream().cuda_stream)
    return node, key


@pytest.mark.parametrize("traffic", ["half_hit", "zipf"])
@pytest.mark.parametrize("nw", WIDTHS)
def test_grouped_k1_with_k9_equals_plain_and_batch_order_on_card(cuda, nw,
                                                                 traffic):
    st, keys, rng = _mono(cuda, nw, True)
    if traffic == "zipf":
        q = keys[(rng.zipf(1.2, 2049) - 1) % len(keys)].astype(np.int32)
    else:
        q = _half_hit(keys, rng, 2047)
    q = torch.from_numpy(q).to(cuda)
    before = (tft.foresight_traverse.fat_launches, tft.fat_resolve.launches,
              tsg.group_by_key.launches)
    got = tft.foresight_traverse(st.fused, q, st.fat_keys)
    assert (tft.foresight_traverse.fat_launches, tft.fat_resolve.launches,
            tsg.group_by_key.launches) == tuple(b + 1 for b in before)
    _same(got, tft.foresight_traverse_plain(st.fused, q, st.fat_keys))
    _same(got, _batch_order(st, q))
    _same(got, tft.foresight_traverse_plain(st.fused.cpu(), q.cpu(),
                                            st.fat_keys.cpu()))


@pytest.mark.parametrize("traffic", ["half_hit", "zipf"])
@pytest.mark.parametrize("nw", WIDTHS)
def test_grouped_k2_with_k9_equals_plain_and_batch_order_on_card(cuda, nw,
                                                                 traffic):
    st, keys, rng = _mono(cuda, nw, False)
    if traffic == "zipf":
        q = keys[(rng.zipf(1.2, 2049) - 1) % len(keys)].astype(np.int32)
    else:
        q = _half_hit(keys, rng, 2047)
    q = torch.from_numpy(q).to(cuda)
    before = (tft.base_traverse.fat_launches, tft.fat_resolve.launches,
              tsg.group_by_key.launches)
    got = tft.base_traverse(st.nxt, st.keys, q, st.fat_keys)
    assert (tft.base_traverse.fat_launches, tft.fat_resolve.launches,
            tsg.group_by_key.launches) == tuple(b + 1 for b in before)
    _same(got, tft.base_traverse_plain(st.nxt, st.keys, q, st.fat_keys))
    _same(got, _batch_order(st, q))
    _same(got, tft.base_traverse_plain(st.nxt.cpu(), st.keys.cpu(), q.cpu(),
                                       st.fat_keys.cpu()))
