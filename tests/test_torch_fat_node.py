"""The port's fat-node layout (``node_width`` > 1) against repro's, bit for
bit, on the CPU, at node widths 8 and 128 (the K1-K6 + K9 comparisons also
at ``EDGE_WIDTHS``).

Twins of ``tests/test_fat_node.py`` (all but the mesh case, which waits
for the mesh's own slice; the slow hypothesis sweep runs as a seeded
fuzz): states move across through ``convert`` and every state array,
result, node id and shard count of build, search, range scan, updates,
split, merge and repack is held equal to the reference's; the plain K1-K6
with the K9 postlude are held against repro's Pallas kernels in interpret
mode.  Each twin also keeps the reference test's own check: the fat layout
answers as the scalar one and as a ``DictOracle``.  Plus the reference's
``KEY_MAX`` faults on fat lists, reproduced (ROADMAP Queue 3), and the
int32 guards on element-flat ids.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sharded as shd
from repro.core import skiplist as sl
from repro.core.oracle import DictOracle
from repro.kernels import ops as kops
from repro_torch.convert import (sharded_from_numpy, sharded_to_numpy,
                                 state_from_numpy, state_to_numpy)
from repro_torch.core import sharded as tsh
from repro_torch.core import skiplist as tsl
from repro_torch.kernels import foresight_traverse as tft
from repro_torch.kernels import ops as tops

jft = importlib.import_module("repro.kernels.foresight_traverse")

SPAN = 1 << 16
WIDTHS = [8, 128]
# Where the card's row tiling of K9 has its edges: rows not 16-byte
# aligned (6), not a multiple of 4 (33), wider than one pass (256).
EDGE_WIDTHS = [6, 33, 256]
QBLK = tft.QBLK
KEY_MAX = 2**31 - 1


def _keys(n, seed=0, span=SPAN):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(span, n, replace=False)).astype(np.int32), rng


def _probe(keys, rng, extra=64):
    """Live keys + their neighbours + uniform misses, QBLK-padded."""
    probe = np.concatenate([
        keys, keys + 1, rng.integers(0, SPAN, extra)]).astype(np.int32)
    pad = (-len(probe)) % QBLK
    return np.concatenate([probe, probe[:1].repeat(pad)]).astype(np.int32)


def _arrays(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()
            if v is not None}


def _sharded_arrays(shl):
    out = {f"shards.{k}": np.asarray(v)
           for k, v in shl.shards._asdict().items() if v is not None}
    out["boundaries"] = np.asarray(shl.boundaries)
    return out


def _same_state(port, ref):
    got, want = state_to_numpy(port), _arrays(ref)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _same_sharded(port, ref):
    got, want = sharded_to_numpy(port), _sharded_arrays(ref)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _mono_pair(keys, vals, **kw):
    ref = sl.build(jnp.asarray(keys), jnp.asarray(vals), **kw)
    port = tsl.build(keys, vals, device="cpu", **kw)
    _same_state(port, ref)
    return ref, port


def _oracle(keys, mult=3):
    oracle = DictOracle()
    for k in keys:
        oracle.insert(int(k), int(k) * mult)
    return oracle


def _expected(oracle, ops, kk, vv):
    out = []
    for o, k, v in zip(ops, kk, vv):
        if o == sl.OP_INSERT:
            out.append(int(oracle.insert(int(k), int(v))))
        elif o == sl.OP_DELETE:
            out.append(int(oracle.delete(int(k))))
        else:
            out.append(int(oracle.search(int(k))[0]))
    return out


# ---------------------------------------------------------------------------
# State, build, capacity arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("nw", WIDTHS)
@pytest.mark.parametrize("n", [1, 37, 1000])
def test_build_equals_repro(n, nw, foresight):
    keys, _ = _keys(n, n)
    ref, port = _mono_pair(keys, keys + 1, capacity=tsl.node_slots_for(
        2 * n, nw) + 4, levels=9, foresight=foresight, seed=n,
        node_width=nw)
    assert port.node_width == nw and int(port.n) == n
    assert bool(tsl.check_fat_invariant(port))


@pytest.mark.parametrize("nw", WIDTHS)
def test_build_valid_prefix_and_empty_equal_repro(nw):
    keys, _ = _keys(300, 2)
    valid = np.arange(300) < 211
    ref = sl.build(jnp.asarray(keys), jnp.asarray(keys * 2), capacity=128,
                   levels=7, seed=2, valid=jnp.asarray(valid),
                   node_width=nw)
    port = tsl.build(keys, keys * 2, capacity=128, levels=7, seed=2,
                     valid=valid, node_width=nw, device="cpu")
    _same_state(port, ref)
    _same_state(tsl.empty(16, 5, seed=3, node_width=nw, device="cpu"),
                sl.empty(16, 5, seed=3, node_width=nw))


@pytest.mark.parametrize("foresight", [True, False])
def test_fat_build_of_no_keys_is_empty_with_split_key(foresight):
    """repro's fat build raises at n=0 (it builds 0 nodes through the
    scalar builder, see ROADMAP Queue 3); the port builds the empty fat
    list, with the rng advanced by the build's split."""
    import jax
    port = tsl.build(np.zeros(0, np.int32), np.zeros(0, np.int32),
                     capacity=8, levels=3, foresight=foresight, seed=4,
                     node_width=8, device="cpu")
    want = sl.empty(8, 3, foresight=foresight, seed=4, node_width=8)
    _same_state(port, want._replace(rng=jax.random.split(want.rng)[0]))
    with pytest.raises(ValueError, match="capacity"):
        tsl.build(np.arange(40, dtype=np.int32), np.arange(40), capacity=11,
                  levels=3, node_width=8, device="cpu")


def test_capacity_arithmetic_equals_repro():
    from repro.analysis.kernel_budget import tile_bytes
    for nw in (1, 6, 8, 128):
        for n in (0, 1, 63, 64, 65, 2**25):
            assert tsl.node_slots_for(n, nw) == sl.node_slots_for(n, nw)
        for cap in (8, 2**15, 2**21):
            assert tsl.usable_capacity(cap, nw) == sl.usable_capacity(cap,
                                                                      nw)
            for fs in (True, False):
                assert tops.tile_bytes(21, cap, fs, nw) == \
                    tile_bytes(21, cap, fs, nw)
        for n, S in ((2**25, 64), (1500, 8), (10, 3)):
            assert tsh.shard_capacity_for(n, S, nw) == \
                shd.shard_capacity_for(n, S, nw)
        for fs in (True, False):
            assert tops.auto_shards(2**20, 16, fs, nw) == \
                kops.auto_shards(2**20, 16, fs, nw)
    assert tsh.shard_capacity_for(2**25, 64, 128) == 2**15


# ---------------------------------------------------------------------------
# Monolithic core: search / search_fast / updates / range scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nw", WIDTHS)
def test_core_search_matches_scalar(nw):
    keys, rng = _keys(500)
    scalar = tsl.build(keys, keys * 3, capacity=2048, levels=8,
                       device="cpu")
    cap = tsl.node_slots_for(1000, nw) + 8
    ref, fat = _mono_pair(keys, keys * 3, capacity=cap, levels=8,
                          node_width=nw)
    q = _probe(keys, rng)
    qt = torch.from_numpy(q)
    r0, r1 = tsl.search(scalar, qt), tsl.search(fat, qt)
    want = sl.search(ref, jnp.asarray(q))
    for f in want._fields:
        np.testing.assert_array_equal(getattr(r1, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(r0.found.numpy(), r1.found.numpy())
    np.testing.assert_array_equal(r0.vals.numpy(), r1.vals.numpy())
    f1, v1 = tsl.search_fast(fat, qt)
    _eq((f1, v1), sl.search_fast(ref, jnp.asarray(q)))
    np.testing.assert_array_equal(f1.numpy(), r0.found.numpy())
    np.testing.assert_array_equal(v1.numpy(), r0.vals.numpy())
    # fat gathers tiles: strictly fewer dependent gathers than scalar
    assert int(r1.gathers) < int(r0.gathers)
    hit = r1.found.numpy()
    flat_v = fat.fat_vals.reshape(-1).numpy()
    np.testing.assert_array_equal(flat_v[r1.node.numpy()[hit]],
                                  r1.vals.numpy()[hit])


@pytest.mark.parametrize("nw", WIDTHS)
def test_core_update_stream_matches_oracle(nw):
    keys, rng = _keys(200, seed=3)
    oracle = _oracle(keys)
    cap = tsl.node_slots_for(2048, nw) + 8
    ref, st = _mono_pair(keys, keys * 3, capacity=cap, levels=8,
                         node_width=nw)
    for r in range(3):
        kk = rng.integers(0, SPAN, 64).astype(np.int32)
        ops = rng.integers(0, 3, 64).astype(np.int32)
        vv = (kk * 7 + r).astype(np.int32)
        expected = _expected(oracle, ops, kk, vv)
        ref, res_r = sl.apply_ops(ref, jnp.asarray(ops), jnp.asarray(kk),
                                  jnp.asarray(vv))
        st, res = tsl.apply_ops(st, ops, kk, vv)
        assert res.numpy().tolist() == expected
        np.testing.assert_array_equal(res.numpy(), np.asarray(res_r))
        _same_state(st, ref)
        assert int(st.n) == len(oracle.d)
        assert bool(tsl.check_fat_invariant(st))
    live = np.sort(np.fromiter(oracle.d, np.int32, len(oracle.d)))
    f, _ = tsl.search_fast(st, torch.from_numpy(live))
    assert bool(f.all())
    _eq(tsl.sorted_live_kv(st), sl.sorted_live_kv(ref))
    lo, hi = int(SPAN * 0.2), int(SPAN * 0.8)
    ks, vs, cnt = tsl.range_scan(st, lo, hi, 256)
    _eq((ks, vs, cnt), sl.range_scan(ref, jnp.int32(lo), jnp.int32(hi), 256))
    expect = [k for k in oracle.sorted_keys() if lo <= k < hi][:256]
    assert ks[:int(cnt)].tolist() == expect


def _case_stream(nw, rng):
    """Ops on the dense range [0, 1.25 * nw) that reach every fat case:
    the first node of an empty list, shifts with room, a median split,
    upserts, deletes of a run's minimum and of an inner lane, runs
    emptied, the list emptied and a first node again."""
    span = nw + nw // 4
    fill = rng.permutation(span).astype(np.int32)
    mixed = rng.integers(0, span, 32).astype(np.int32)
    mixed_ops = rng.integers(1, 3, 32).astype(np.int32)
    drain = rng.permutation(span).astype(np.int32)
    kk = np.concatenate([fill, fill[:4], mixed, drain, fill[:3]])
    ops = np.concatenate([np.full(span, sl.OP_INSERT), np.full(4, 1),
                          mixed_ops, np.full(span, sl.OP_DELETE),
                          np.full(3, sl.OP_INSERT)]).astype(np.int32)
    return ops, kk, (kk * 5 + 1).astype(np.int32)


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("nw", WIDTHS)
def test_every_insert_and_delete_case_equals_repro(nw, foresight):
    rng = np.random.default_rng(nw)
    ref = sl.empty(8, 6, foresight=foresight, seed=1, node_width=nw)
    st = tsl.empty(8, 6, foresight=foresight, seed=1, node_width=nw,
                   device="cpu")
    ops, kk, vv = _case_stream(nw, rng)
    tsl.FAT_CASES.clear()
    ref2, res_r = sl.apply_ops(ref, jnp.asarray(ops), jnp.asarray(kk),
                               jnp.asarray(vv))
    st2, res = tsl.apply_ops(st, ops, kk, vv)
    np.testing.assert_array_equal(res.numpy(), np.asarray(res_r))
    _same_state(st2, ref2)
    _same_state(st, sl.empty(st.capacity, 6, foresight=foresight, seed=1,
                             node_width=nw))         # input unchanged
    assert bool(tsl.check_fat_invariant(st2))
    for case in ("insert_first", "insert_room", "insert_split",
                 "insert_upsert", "delete_plain", "delete_min",
                 "delete_emptied"):
        assert tsl.FAT_CASES[case] > 0, (case, dict(tsl.FAT_CASES))
    assert int(st2.n) == 3


@pytest.mark.parametrize("foresight", [True, False])
def test_split_and_first_node_without_a_free_slot_equal_repro(foresight):
    """A full run (or an empty list) with no node slot left: the insert
    reports False and writes nothing but the advanced rng."""
    keys = np.arange(10, 170, 10, dtype=np.int32)             # 16 keys
    ref, st = _mono_pair(keys, keys, capacity=6, levels=4,
                         foresight=foresight, node_width=8)
    ops = np.array([1, 1, 1, 1, 1, 1], np.int32)
    kk = np.array([11, 12, 13, 14, 15, 16], np.int32)        # fill, then
    ref2, res_r = sl.apply_ops(ref, jnp.asarray(ops), jnp.asarray(kk),
                               jnp.asarray(kk))               # split x2
    st2, res = tsl.apply_ops(st, ops, kk, kk)
    np.testing.assert_array_equal(res.numpy(), np.asarray(res_r))
    _same_state(st2, ref2)
    e_ref = sl.empty(2, 3, foresight=foresight, node_width=8)
    e_ref2, ok_r = sl.insert(e_ref, jnp.int32(5), jnp.int32(6))
    e2, ok = tsl.insert(tsl.empty(2, 3, foresight=foresight, node_width=8,
                                  device="cpu"), 5, 6)
    assert not bool(ok) and not bool(ok_r)
    _same_state(e2, e_ref2)


@pytest.mark.parametrize("nw", WIDTHS)
def test_range_scan_stops_where_repro_stops(nw):
    """The fixed trip count ``2 * max_out + B + 4`` is part of the
    result: a scan that has not reached ``hi`` by then stops there."""
    keys, rng = _keys(400, 4)
    ref, st = _mono_pair(keys, keys * 3, capacity=tsl.node_slots_for(
        800, nw) + 4, levels=8, node_width=nw)
    for lo, hi, m in ((0, SPAN, 1), (0, SPAN, 5), (keys[7] + 1, keys[9], 8),
                      (-5, 3, 2), (keys[-1], KEY_MAX, 4), (500, 40000, 300)):
        _eq(tsl.range_scan(st, lo, hi, m),
            sl.range_scan(ref, jnp.int32(lo), jnp.int32(hi), m))


# ---------------------------------------------------------------------------
# The reference's KEY_MAX faults on a fat list (ROADMAP Queue 3)
# ---------------------------------------------------------------------------

def _fault_list():
    keys = np.arange(100, 2900, 100, dtype=np.int32)          # 28 keys
    return _mono_pair(keys, keys + 1, capacity=16, levels=5, node_width=8)


def test_fat_delete_of_key_max_succeeds_like_repro():
    ref, st = _fault_list()
    ref2, ok_r = sl.delete(ref, jnp.int32(KEY_MAX))
    st2, ok = tsl.delete(st, KEY_MAX)
    assert bool(ok) and bool(ok_r)
    _same_state(st2, ref2)
    assert int(st2.n) == 27 and int(st2.nlen[tsl.TAIL]) == -1
    assert not bool(sl.check_fat_invariant(ref2))
    assert not bool(tsl.check_fat_invariant(st2))


def test_fat_insert_of_key_max_upserts_the_tail_like_repro():
    ref, st = _fault_list()
    ref2, ok_r = sl.insert(ref, jnp.int32(KEY_MAX), jnp.int32(77))
    st2, ok = tsl.insert(st, KEY_MAX, 77)
    assert not bool(ok) and not bool(ok_r)
    _same_state(st2, ref2)
    assert int(st2.fat_vals[tsl.TAIL, 0]) == 77
    r = tsl.search(st2, torch.tensor([KEY_MAX], dtype=torch.int32))
    assert bool(r.found[0]) and int(r.vals[0]) == 77
    assert int(r.node[0]) == tsl.TAIL * 8
    _eq(tops.search_kernel(st2, torch.tensor([KEY_MAX], dtype=torch.int32)),
        kops.search_kernel(ref2, jnp.asarray([KEY_MAX], jnp.int32)))
    # the tail row's vals now differ: a stable sort keeps repro's order
    _eq(tsl.sorted_live_kv(st2), sl.sorted_live_kv(ref2))


# ---------------------------------------------------------------------------
# Kernels: plain K1-K6 with K9 against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("foresight", [False, True])
@pytest.mark.parametrize("nw", WIDTHS + EDGE_WIDTHS)
def test_kernel_monolithic_matches_scalar(nw, foresight):
    keys, rng = _keys(700, seed=5)
    scalar = tsl.build(keys, keys * 3, capacity=2048, levels=8,
                       foresight=foresight, device="cpu")
    cap = tsl.node_slots_for(1400, nw) + 8
    ref, fat = _mono_pair(keys, keys * 3, capacity=cap, levels=8,
                          foresight=foresight, node_width=nw)
    q = _probe(keys, rng)
    r1 = tops.search_kernel(fat, torch.from_numpy(q))
    _eq(r1, kops.search_kernel(ref, jnp.asarray(q)))
    r0 = tops.search_kernel(scalar, torch.from_numpy(q))
    np.testing.assert_array_equal(r0.found.numpy(), r1.found.numpy())
    np.testing.assert_array_equal(r0.vals.numpy(), r1.vals.numpy())
    tables = (fat.fused,) if foresight else (fat.nxt, fat.keys)
    jtables = (ref.fused,) if foresight else (ref.nxt, ref.keys)
    kern = jft.foresight_traverse if foresight else jft.base_traverse
    plain = (tft.foresight_traverse_plain if foresight
             else tft.base_traverse_plain)
    for max_steps in (0, 9):
        _eq(plain(*tables, torch.from_numpy(q), fat.fat_keys,
                  max_steps=max_steps),
            kern(*jtables, jnp.asarray(q), ref.fat_keys,
                 max_steps=max_steps))


@pytest.mark.parametrize("nw", WIDTHS)
def test_k9_alone_equals_the_postlude_of_k1(nw):
    keys, rng = _keys(300, seed=8)
    _, fat = _mono_pair(keys, keys, capacity=tsl.node_slots_for(600, nw) + 4,
                        levels=7, node_width=nw)
    q = torch.from_numpy(_probe(keys, rng))
    gather = tft._fused_gather(fat.fused)
    for max_steps in (0, 3):
        x = tft._traverse_loop(q, gather, levels=7,
                               max_steps=max_steps or 10**6)
        _eq(tft.fat_resolve(fat.fused, fat.fat_keys, x, q),
            tft.foresight_traverse(fat.fused, q, fat.fat_keys,
                                   max_steps=max_steps))
    with pytest.raises(ValueError, match="B > 1"):
        tft.fat_resolve(fat.fused, fat.fat_keys[:, :1], x, q)


def _sharded_pair(keys, vals, **kw):
    ref = shd.build_sharded(jnp.asarray(keys), jnp.asarray(vals), **kw)
    port = tsh.build_sharded(keys, vals, device="cpu", **kw)
    _same_sharded(port, ref)
    return ref, port


@pytest.mark.parametrize("cluster", [False, True])
@pytest.mark.parametrize("nw", WIDTHS)
def test_kernel_sharded_matches_scalar(nw, cluster):
    keys, rng = _keys(900, seed=6)
    ref, fat = _sharded_pair(keys, keys * 3, n_shards=4, levels=8,
                             node_width=nw)
    scalar = tsh.build_sharded(keys, keys * 3, n_shards=4, levels=8,
                               device="cpu")
    q = torch.from_numpy(_probe(keys, rng))
    r1 = tops.search_kernel_sharded(fat, q, cluster=cluster)
    _eq(r1, kops.search_kernel_sharded(ref, jnp.asarray(q.numpy()),
                                       cluster=cluster))
    r0 = tops.search_kernel_sharded(scalar, q, cluster=cluster)
    np.testing.assert_array_equal(r0.found.numpy(), r1.found.numpy())
    np.testing.assert_array_equal(r0.vals.numpy(), r1.vals.numpy())
    # element-flat fat node ids dereference to the probed key's value
    hit = r1.found.numpy()
    flat_v = fat.shards.fat_vals.reshape(-1).numpy()
    np.testing.assert_array_equal(flat_v[r1.node.numpy()[hit]],
                                  r1.vals.numpy()[hit])


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("nw", WIDTHS + EDGE_WIDTHS)
def test_plain_sharded_and_clustered_k9_match_pallas(nw, foresight):
    """K3-K6 with K9 on S = 9 (a split), at the default cap and at
    ``max_steps=9``, and with a plan cut to one slot (unserved lanes)."""
    keys, rng = _keys(1000, seed=7)
    ref, shl = _sharded_pair(keys, keys * 3, n_shards=8, levels=9,
                             foresight=foresight, node_width=nw)
    ref, shl = shd.split_shard(ref, 3), tsh.split_shard(shl, 3)
    _same_sharded(shl, ref)
    q = _probe(keys[::3], rng)
    sid = tsh.route(shl.boundaries, torch.from_numpy(q))
    plan = tops.cluster_queries(shl.boundaries, torch.from_numpy(q))
    jplan = kops.cluster_queries(ref.boundaries, jnp.asarray(q))
    tables, fat = tops._tables(shl), shl.shards.fat_keys
    jtables = ((ref.shards.fused,) if foresight
               else (ref.shards.nxt, ref.shards.keys))
    dense = (tft.foresight_traverse_sharded if foresight
             else tft.base_traverse_sharded)
    jdense = (jft.foresight_traverse_sharded if foresight
              else jft.base_traverse_sharded)
    clus = (tft.foresight_traverse_clustered if foresight
            else tft.base_traverse_clustered)
    jclus = (jft.foresight_traverse_clustered if foresight
             else jft.base_traverse_clustered)
    args = (plan.block_sids, plan.ndist, plan.sid_sorted, plan.q_sorted)
    jargs = (jplan.block_sids, jplan.ndist, jplan.sid_sorted, jplan.q_sorted)
    for max_steps in (0, 9):
        _eq(dense(*tables, sid, torch.from_numpy(q), fat,
                  max_steps=max_steps),
            jdense(*jtables, jnp.asarray(sid.numpy()), jnp.asarray(q),
                   ref.shards.fat_keys, max_steps=max_steps))
    _eq(clus(*tables, *args, fat),
        jclus(*jtables, *jargs, ref.shards.fat_keys))
    # at max_steps=9, with the plan cut to one slot (unserved lanes)
    cut = (plan.block_sids[:, :1].contiguous(), *args[1:])
    jcut = (jplan.block_sids[:, :1], *jargs[1:])
    _eq(clus(*tables, *cut, fat, max_steps=9),
        jclus(*jtables, *jcut, ref.shards.fat_keys, max_steps=9))


def test_straddle_stream_s9_fat():
    """Post-split S = 9 with one block straddling all shards: K7's split,
    on the fat layout."""
    keys, rng = _keys(1200, seed=11)
    ref, shl = _sharded_pair(keys, keys * 3, n_shards=8, levels=10,
                             node_width=8)
    ref, shl = shd.split_shard(ref, 3), tsh.split_shard(shl, 3)
    _same_sharded(shl, ref)
    S = shl.n_shards
    sids = tsh.route(shl.boundaries, torch.from_numpy(keys)).numpy()
    picks = np.array([keys[sids == s][0] for s in range(S)], np.int32)
    block = np.sort(np.concatenate(
        [picks, keys[:QBLK - S]])).astype(np.int32)
    q = np.concatenate([keys[:2 * QBLK], block])
    plan = tops.cluster_queries(shl.boundaries, torch.from_numpy(q))
    assert tops.plan_degeneration_split(plan.ndist, S) is not None
    res = tops.search_kernel_sharded(shl, torch.from_numpy(q))
    _eq(res, kops.search_kernel_sharded(ref, jnp.asarray(q)))
    assert bool(res.found.all())
    np.testing.assert_array_equal(res.vals.numpy(), q.astype(np.int64) * 3)


@pytest.mark.parametrize("nw", WIDTHS)
def test_shard_state_of_a_fat_list_equals_repro(nw):
    keys, rng = _keys(600, seed=12)
    ref, st = _mono_pair(keys, keys * 2, capacity=tsl.node_slots_for(
        1200, nw) + 4, levels=8, node_width=nw)
    ops = rng.integers(1, 3, 40).astype(np.int32)
    kk = rng.integers(0, SPAN, 40).astype(np.int32)
    ref, _ = sl.apply_ops(ref, jnp.asarray(ops), jnp.asarray(kk),
                          jnp.asarray(kk))
    st = state_from_numpy(_arrays(ref), "cpu")
    shl = tops.shard_state(st, 4)
    _same_sharded(shl, kops.shard_state(ref, 4))
    assert shl.node_width == nw
    assert int(tsh.total_n(shl)) == int(st.n)
    q = torch.from_numpy(_probe(keys[::4], rng))
    _eq(tsh.search_sharded(shl, q), tsl.search_fast(st, q))
    assert tops.vmem_footprint(shl) == kops.vmem_footprint(
        kops.shard_state(ref, 4))
    assert tops.fits_vmem(st) == kops.fits_vmem(ref)


def test_dma_model_bytes_leaves_out_the_run_tile_like_repro():
    """The reference's cost model passes no node_width (ROADMAP Queue 3):
    a fat shard's modelled tile is the skip tables alone.  Copied as it
    is."""
    keys, rng = _keys(900, seed=6)
    ref, shl = _sharded_pair(keys, keys, n_shards=4, levels=8, node_width=8)
    q = _probe(keys, rng)
    plan = tops.cluster_queries(shl.boundaries, torch.from_numpy(q))
    jplan = kops.cluster_queries(ref.boundaries, jnp.asarray(q))
    assert tops.dma_model_bytes(shl, len(q)) == \
        kops.dma_model_bytes(ref, len(q))
    assert tops.dma_model_bytes(shl, len(q), plan.block_sids) == \
        kops.dma_model_bytes(ref, len(q), jplan.block_sids)
    nblk = len(q) // QBLK
    assert tops.dma_model_bytes(shl, len(q)) == nblk * 4 * tops.tile_bytes(
        8, shl.shard_capacity, True)
    assert tops.tile_bytes(8, shl.shard_capacity, True, 8) > \
        tops.tile_bytes(8, shl.shard_capacity, True)


# ---------------------------------------------------------------------------
# Sharded engine: build, split / merge / repack, scans, routed updates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("nw", WIDTHS)
def test_sharded_build_split_merge_repack_equal_repro(nw, foresight):
    keys, _ = _keys(1500, 3)
    ref, shl = _sharded_pair(keys, keys + 1, n_shards=8, levels=9,
                             foresight=foresight, seed=5, node_width=nw)
    assert shl.shard_capacity == shd.shard_capacity_for(1500, 8, nw)
    r9, s9 = shd.split_shard(ref, 0), tsh.split_shard(shl, 0)
    _same_sharded(s9, r9)
    _same_sharded(tsh.merge_shards(s9, 2, seed=1),
                  shd.merge_shards(r9, 2, seed=1))
    _same_sharded(tsh.repack(s9, 5, seed=2), shd.repack(r9, 5, seed=2))
    assert bool(tsh.check_sharded_invariant(s9, expect_n=1500))
    _same_sharded(tsh.empty_sharded(n_shards=3, capacity=8, levels=5,
                                    foresight=foresight, node_width=nw,
                                    device="cpu"),
                  shd.empty_sharded(n_shards=3, capacity=8, levels=5,
                                    foresight=foresight, node_width=nw))


@pytest.mark.parametrize("nw", WIDTHS)
def test_range_scan_sharded_equals_repro(nw):
    keys, rng = _keys(700, 9)
    ref, shl = _sharded_pair(keys, keys * 3, n_shards=8, levels=8,
                             node_width=nw, seed=1)
    b = shl.boundaries.numpy()
    for lo, hi, m in ((0, SPAN, 4), (int(b[2]) - 300, int(b[4]) + 5, 96),
                      (int(b[3]), int(b[3]) + 1, 4)):
        got = tsh.range_scan_sharded(shl, lo, hi, m)
        _eq(got, shd.range_scan_sharded(ref, jnp.int32(lo), jnp.int32(hi),
                                        m))
        expect = [int(k) for k in keys if lo <= k < hi][:m]
        assert got[0][:int(got[2])].tolist() == expect
    # through empty trailing shards
    few = np.arange(10, 110, 10, dtype=np.int32)
    ref, shl = _sharded_pair(few, few, n_shards=8, levels=6, node_width=nw)
    for lo, hi, m in ((15, 200, 96), (0, 10**6, 4), (95, 96, 4)):
        _eq(tsh.range_scan_sharded(shl, lo, hi, m),
            shd.range_scan_sharded(ref, jnp.int32(lo), jnp.int32(hi), m))


def test_shard_boundary_keys_exact():
    """Keys on and next to every shard boundary: the fat owner rule
    (predecessor node vs foreseen successor) must pick the right run."""
    keys, _ = _keys(800, seed=7)
    ref, shl = _sharded_pair(keys, keys * 3, n_shards=8, levels=8,
                             node_width=8)
    b = shl.boundaries.numpy().astype(np.int64)[1:]
    probe = np.concatenate([b - 1, b, b + 1]).astype(np.int32)
    f, v = tsh.search_sharded(shl, torch.from_numpy(probe))
    _eq((f, v), shd.search_sharded(ref, jnp.asarray(probe)))
    in_set = np.isin(probe, keys)
    np.testing.assert_array_equal(f.numpy(), in_set)
    np.testing.assert_array_equal(v.numpy()[in_set],
                                  probe[in_set].astype(np.int64) * 3)


def _replay_sharded(seed, nw, *, rounds=1, batch=36, zipf=False, n_init=24,
                    n_shards=4, levels=8):
    """A rebalancing stream through the port's fat, the port's scalar and
    repro's fat sharded engines, each batch checked against the oracle
    and the port's fat state against repro's."""
    keys, rng = _keys(n_init, seed=seed)
    oracle = _oracle(keys)
    args = dict(n_shards=n_shards, levels=levels, seed=seed)
    ref, shl = _sharded_pair(keys, keys * 3, node_width=nw, **args)
    scalar = tsh.build_sharded(keys, keys * 3, device="cpu", **args)
    for r in range(rounds):
        if zipf:
            hot = int(rng.integers(0, SPAN - 4096))
            kk = (hot + (rng.zipf(1.2, batch) - 1) % 4096).astype(np.int32)
        else:
            kk = rng.integers(0, SPAN, batch).astype(np.int32)
        ops = rng.integers(0, 3, batch).astype(np.int32)
        vv = (kk * 7 + r).astype(np.int32)
        expected = _expected(oracle, ops, kk, vv)
        ref, res_r = shd.apply_ops_sharded(ref, jnp.asarray(ops),
                                           jnp.asarray(kk), jnp.asarray(vv),
                                           rebalance=True)
        shl, res = tsh.apply_ops_sharded(shl, ops, kk, vv, rebalance=True)
        scalar, res_s = tsh.apply_ops_sharded(scalar, ops, kk, vv,
                                              rebalance=True)
        assert res.numpy().tolist() == expected
        np.testing.assert_array_equal(res.numpy(), np.asarray(res_r))
        np.testing.assert_array_equal(res_s.numpy(), res.numpy())
        _same_sharded(shl, ref)
        probe = torch.from_numpy(_probe(kk, rng))
        f1, v1 = tsh.search_sharded(shl, probe)
        _eq((f1, v1), tsh.search_sharded(scalar, probe))
        lo = int(rng.integers(0, SPAN // 2))
        hi = lo + int(rng.integers(1, SPAN // 2))
        k1, vv1, c1 = tsh.range_scan_sharded(shl, lo, hi, 96)
        _eq((k1, vv1, c1), shd.range_scan_sharded(ref, jnp.int32(lo),
                                                  jnp.int32(hi), 96))
        expect = [k for k in oracle.sorted_keys() if lo <= k < hi][:96]
        assert k1[:int(c1)].tolist() == expect
    return shl


@pytest.mark.parametrize("nw", WIDTHS)
def test_sharded_streams_match_scalar_and_oracle(nw):
    _replay_sharded(0, nw)
    _replay_sharded(1, nw, zipf=True)


@pytest.mark.parametrize("seed,zipf,nw,batch", [
    (202, True, 8, 44), (404, False, 128, 17)])
def test_fat_differential_seeded_fuzz(seed, zipf, nw, batch):
    """The reference's hypothesis sweep (marked slow there), as a seeded
    fuzz over the same space: seed, key skew, width and batch."""
    _replay_sharded(seed, nw, batch=batch, zipf=zipf)


@pytest.mark.parametrize("nw", WIDTHS)
def test_fat_updates_leave_their_input_unchanged(nw):
    keys, rng = _keys(400, seed=13)
    _, st = _mono_pair(keys, keys, capacity=tsl.node_slots_for(800, nw) + 4,
                       levels=7, node_width=nw)
    shl = tsh.build_sharded(keys, keys, n_shards=4, levels=7, node_width=nw,
                            device="cpu")
    before, before_s = state_to_numpy(st), sharded_to_numpy(shl)
    ops = rng.integers(0, 3, 120).astype(np.int32)
    kk = np.concatenate([rng.choice(keys, 60),
                         rng.integers(0, SPAN, 60)]).astype(np.int32)
    tsl.apply_ops(st, ops, kk, kk)
    tsh.apply_ops_sharded(shl, ops, kk, kk, rebalance=True)
    for got, want in ((state_to_numpy(st), before),
                      (sharded_to_numpy(shl), before_s)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_two_fat_inserts_into_one_shard_advance_its_rng():
    keys, _ = _keys(400, 14)
    ref, shl = _sharded_pair(keys, keys, n_shards=4, levels=8, node_width=8)
    b1 = int(shl.boundaries[1])
    new = np.setdiff1d(np.arange(b1 - 40, b1), keys)[-2:].astype(np.int32)
    ins = np.full(2, tsl.OP_INSERT, np.int32)
    r1, _ = shd.apply_ops_sharded(ref, jnp.asarray(ins), jnp.asarray(new),
                                  jnp.asarray(new))
    p1, res = tsh.apply_ops_sharded(shl, ins, new, new)
    np.testing.assert_array_equal(res.numpy(), [1, 1])
    _same_sharded(p1, r1)
    assert not torch.equal(p1.shards.rng[0], shl.shards.rng[0])


# ---------------------------------------------------------------------------
# Guards: element-flat ids past int32
# ---------------------------------------------------------------------------

def test_index_guards_refuse_element_ids_past_int32():
    """The reference computes ``owner * B + lane`` and ``(sid * cap +
    node) * B + lane`` in int32; past ``2**31 - 1`` they wrap, so the port
    refuses such shapes (meta-device tensors: shapes without storage)."""
    meta = lambda *shape: torch.empty(shape, dtype=torch.int32,
                                      device="meta")
    tops.check_index_range(27, 2**21, 1, 128)
    tops.check_index_range(21, 2**15, 64, 128)
    tops.check_index_range(4, 2**24, 1, 2**7 - 1)            # just under
    with pytest.raises(ValueError, match="node_width"):
        tops.check_index_range(4, 2**24, 1, 2**7 + 1)        # just past
    with pytest.raises(ValueError, match="sid \\* capacity \\* node_width"):
        tops.check_index_range(21, 2**15, 2**9, 128)
    st = tsl.empty(8, 4, node_width=8, device="cpu")
    big = st._replace(keys=meta(2**24), fused=meta(4, 2**24, 2),
                      fat_keys=meta(2**24, 129), fat_vals=meta(2**24, 129))
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tops.search_kernel(big, torch.zeros(4, dtype=torch.int32))
    shl = tsh.ShardedSkipList(
        st._replace(keys=meta(2**9, 2**15), fused=meta(2**9, 4, 2**15, 2),
                    fat_keys=meta(2**9, 2**15, 128)),
        torch.zeros(2**9, dtype=torch.int32))
    assert 2**9 * 4 * 2**15 <= 2**31 - 1        # the record index fits
    with pytest.raises(ValueError, match="S \\* capacity \\* node_width"):
        tsh.check_stack_index(shl)
    with pytest.raises(ValueError, match="S \\* capacity \\* node_width"):
        tsh.search_sharded(shl, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tops.search_kernel_sharded(shl, torch.zeros(4, dtype=torch.int32))
    ok = tsh.ShardedSkipList(
        st._replace(keys=meta(2**9 - 1, 2**15),
                    fused=meta(2**9 - 1, 4, 2**15, 2),
                    fat_keys=meta(2**9 - 1, 2**15, 128)),
        torch.zeros(2**9 - 1, dtype=torch.int32))
    tsh.check_stack_index(ok)                   # just under: taken
