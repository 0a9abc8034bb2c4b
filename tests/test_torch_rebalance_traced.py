"""The port's in-place rebalancing at a static ceiling against repro's
``core.rebalance_traced`` under ``jax.jit``, bit for bit, on the CPU.

Twins of ``tests/test_traced_rebalance.py``: ``pad_shards``, the in-place
split and merge, the watermark pass, the exhaustion guard with its seeds,
and ``apply_ops_sharded(rebalance=True)`` on padded, ``empty_sharded`` and
fully live states (the last through the private ``_in_place`` switch the
mesh index uses, against the reference's jitted call).  Every state array
(``rng`` and the boundaries included), every result and the split / merge
counts equal the reference's; the reference test's own checks hold on the
port.  Both layouts: scalar and fat (``node_width=8``).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rebalance_traced as rbt
from repro.core import sharded as shd
from repro.core.oracle import DictOracle
from repro_torch.core import rebalance_traced as trbt
from repro_torch.core import sharded as tsh
from repro_torch.core import skiplist as tsl
from test_torch_rebalance import (SPAN, _assert_matches_oracle, _assert_same,
                                  _build, _zipf_stream)

WIDTHS = [1, 8]


def _build_w(nw, n=60, n_shards=4, levels=8, capacity=0, seed=0):
    """(repro index, the port's build of it, oracle, keys, rng) at node
    width ``nw``."""
    if nw == 1:
        return _build(n=n, n_shards=n_shards, levels=levels,
                      capacity=capacity, seed=seed)
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(SPAN, n, replace=False)).astype(np.int32)
    args = dict(n_shards=n_shards, levels=levels, capacity=capacity,
                seed=seed, node_width=nw)
    ref = shd.build_sharded(jnp.asarray(keys), jnp.asarray(keys * 3), **args)
    shl = tsh.build_sharded(keys, keys * 3, device="cpu", **args)
    _assert_same(shl, ref)
    oracle = DictOracle()
    for k in keys:
        oracle.insert(int(k), int(k) * 3)
    return ref, shl, oracle, keys, rng


_APPLY_JIT = jax.jit(functools.partial(shd.apply_ops_sharded,
                                       rebalance=True))


def _jit_apply(ref, ops, kk, vv, seed=0):
    """The reference's jitted rebalancing apply (one trace a shape)."""
    return _APPLY_JIT(ref, jnp.asarray(ops), jnp.asarray(kk),
                      jnp.asarray(vv), seed=jnp.int32(seed))


# ---------------------------------------------------------------------------
# Counters and padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("live,routed", [
    ([3, 0, 9, 1], [5, 5, 5, 5]),
    ([0, 0], [0, 0]),
    ([7], [0]),
    ([2**20, 1, 3, 5, 0, 0, 11, 2**19], [1, 2, 3, 4, 5, 6, 7, 9]),
])
def test_cross_device_load_equals_repro_bitwise(live, routed):
    want = rbt.cross_device_load(jnp.asarray(live, jnp.int32),
                                 jnp.asarray(routed, jnp.int32))
    got = trbt.cross_device_load(torch.tensor(live, dtype=torch.int32),
                                 torch.tensor(routed, dtype=torch.int32))
    for name in want._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("nw", WIDTHS)
def test_pad_shards_is_search_invisible(nw):
    ref, shl, oracle, keys, rng = _build_w(nw, n=60, n_shards=4)
    padded = trbt.pad_shards(shl, 12)
    _assert_same(padded, rbt.pad_shards(ref, 12))
    assert padded.n_shards == 12
    assert trbt.live_shard_count(padded) == int(rbt.live_shard_count(
        rbt.pad_shards(ref, 12))) <= 4
    assert bool(tsh.check_sharded_invariant(padded, expect_n=len(oracle.d)))
    _assert_matches_oracle(padded, oracle, rng)
    with pytest.raises(ValueError, match="below current"):
        trbt.pad_shards(padded, 8)
    assert trbt.pad_shards(shl, 4) is shl


# ---------------------------------------------------------------------------
# In-place split and merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nw", WIDTHS)
def test_split_merge_in_place_equal_repro(nw):
    ref, shl, oracle, keys, rng = _build_w(nw, n=60, n_shards=4)
    ref_p, shl_p = rbt.pad_shards(ref, 8), trbt.pad_shards(shl, 8)
    b = shl.boundaries.numpy()
    at = int(b[1]) + 1                          # just inside shard 1
    ref_s = jax.jit(rbt.split_shard_traced)(ref_p, jnp.int32(1),
                                            jnp.int32(at), seed=5)
    split = trbt.split_shard_traced(shl_p, 1, at, seed=5)
    _assert_same(split, ref_s)
    assert split.n_shards == 8 and int(split.boundaries[2]) == at
    assert bool(tsh.check_sharded_invariant(split, expect_n=len(oracle.d)))
    _assert_matches_oracle(split, oracle, rng)
    _assert_same(shl_p, ref_p)                  # the input is unchanged
    ref_m = jax.jit(rbt.merge_shards_traced)(ref_s, jnp.int32(1), seed=3)
    merged = trbt.merge_shards_traced(split, 1, seed=3)
    _assert_same(merged, ref_m)
    assert merged.n_shards == 8
    np.testing.assert_array_equal(merged.boundaries.numpy()[:4], b)
    assert bool(tsh.check_sharded_invariant(merged, expect_n=len(oracle.d)))
    _assert_matches_oracle(merged, oracle, rng)


# ---------------------------------------------------------------------------
# Rebalancing passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nw", WIDTHS)
def test_watermark_pass_equals_repro(nw):
    """Splits above high water, then merges after deletes, in place."""
    n, cap = (100, 64) if nw == 1 else (400, 64)
    ref, shl, oracle, keys, rng = _build_w(nw, n=n, n_shards=2, capacity=cap)
    ref_p, shl_p = rbt.pad_shards(ref, 8), trbt.pad_shards(shl, 8)
    ref_w, stats_r = jax.jit(rbt.watermark_rebalance_traced)(ref_p)
    st, stats = trbt.watermark_rebalance_traced(shl_p)
    _assert_same(st, ref_w)
    assert stats == (int(stats_r.splits), int(stats_r.merges))
    assert stats.splits >= 1
    usable = tsl.usable_capacity(cap, nw)
    assert np.all(st.shards.n.numpy() <= 0.75 * usable)
    assert bool(tsh.check_sharded_invariant(st, expect_n=len(oracle.d)))
    _assert_matches_oracle(st, oracle, rng)
    drop = keys[: int(0.8 * n)]
    ops = np.full(drop.size, tsl.OP_DELETE, np.int32)
    zeros = np.zeros(drop.size, np.int32)
    ref2, res_r = _jit_apply(ref_w, ops, drop, zeros)
    st2, res = tsh.apply_ops_sharded(st, ops, drop, zeros, rebalance=True)
    np.testing.assert_array_equal(res.numpy(), np.asarray(res_r))
    _assert_same(st2, ref2)
    assert (res.numpy() == 1).all()
    for k in drop:
        oracle.delete(int(k))
    assert trbt.live_shard_count(st2) < trbt.live_shard_count(st)
    assert bool(tsh.check_sharded_invariant(st2, expect_n=len(oracle.d)))
    _assert_matches_oracle(st2, oracle, rng)


@pytest.mark.parametrize("nw", WIDTHS)
@pytest.mark.parametrize("per_shard", ["over", "under"])
def test_watermark_ties_pick_the_first_extreme(nw, per_shard):
    """Every shard equally full: each split takes the first of the fullest
    shards and each merge the first of the least-filled pairs, as
    ``jnp.argmax`` / ``argmin`` do."""
    usable = tsl.usable_capacity(16, nw)
    # over: every shard above high water; under: below low water, and two
    # merged pairs too full to merge again, so the order shows
    m = int(0.75 * usable) + 1 if per_shard == "over" else \
        math.ceil(0.25 * usable) - 1
    ref, shl, oracle, _, rng = _build_w(nw, n=4 * m, n_shards=4,
                                        capacity=16)
    assert (shl.shards.n.numpy() == m).all()
    ref_p, shl_p = rbt.pad_shards(ref, 8), trbt.pad_shards(shl, 8)
    ref_w, stats_r = jax.jit(rbt.watermark_rebalance_traced)(ref_p)
    st, stats = trbt.watermark_rebalance_traced(shl_p)
    _assert_same(st, ref_w)
    assert stats == (int(stats_r.splits), int(stats_r.merges))
    assert stats.splits if per_shard == "over" else stats.merges
    _assert_matches_oracle(st, oracle, rng)


@pytest.mark.parametrize("nw", WIDTHS)
def test_exhaustion_guard_with_seeds_equals_repro(nw):
    ref, shl, _, keys, rng = _build_w(nw, n=48, n_shards=4, capacity=16)
    ref_p, shl_p = rbt.pad_shards(ref, 16), trbt.pad_shards(shl, 16)
    hot, batch = int(keys[2]), 60 if nw == 1 else 240
    kk = (hot + (rng.zipf(1.2, batch) - 1) % 4096).astype(np.int32)
    ops = np.where(rng.random(batch) < 0.8, tsl.OP_INSERT,
                   tsl.OP_READ).astype(np.int32)
    heights = []
    for seed, max_shards in ((0, 0), (11, 0), (0, 6)):
        guard = jax.jit(functools.partial(rbt.exhaustion_guard_traced,
                                          max_shards=max_shards))
        ref2, n_r = guard(ref_p, jnp.asarray(ops), jnp.asarray(kk),
                          seed=jnp.int32(seed))
        shl2, n_s = trbt.exhaustion_guard_traced(
            shl_p, torch.from_numpy(ops), torch.from_numpy(kk),
            max_shards=max_shards, seed=seed)
        assert n_s == int(n_r) > 0
        _assert_same(shl2, ref2)
        assert trbt.live_shard_count(shl2) <= (max_shards or 16)
        heights.append(shl2.shards.height.numpy())
    assert (heights[0] != heights[1]).any(), "seed did not reach the splits"
    reads = np.zeros_like(ops)
    assert trbt.exhaustion_guard_traced(shl_p, reads, kk)[1] == 0
    assert trbt.exhaustion_guard_traced(shl_p, reads[:0], kk[:0])[1] == 0


def test_rebalance_on_a_static_ceiling_takes_the_in_place_pass():
    """``rebalance`` and an eager ``apply_ops_sharded(rebalance=True)`` on a
    padded state keep the ceiling, as the reference's do."""
    ref, shl, oracle, keys, rng = _build(n=48, n_shards=4, capacity=16)
    ref_p, shl_p = rbt.pad_shards(ref, 16), trbt.pad_shards(shl, 16)
    kk = rng.integers(0, SPAN, 8).astype(np.int32)
    ops = np.full(kk.size, tsl.OP_INSERT, np.int32)
    ref2, res_r = shd.apply_ops_sharded(ref_p, jnp.asarray(ops),
                                        jnp.asarray(kk), jnp.asarray(kk * 2),
                                        rebalance=True)
    out, res = tsh.apply_ops_sharded(shl_p, ops, kk, kk * 2, rebalance=True)
    np.testing.assert_array_equal(res.numpy(), np.asarray(res_r))
    _assert_same(out, ref2)
    assert out.n_shards == 16
    ref3, stats_r = shd.rebalance(ref_p)
    out2, stats = tsh.rebalance(shl_p)
    _assert_same(out2, ref3)
    assert stats == (int(stats_r.splits), int(stats_r.merges))
    live = trbt.live_shard_count(out2)
    assert (out2.boundaries.numpy()[live:] == tsl.KEY_MAX).all()
    assert bool(tsh.check_sharded_invariant(out2, expect_n=len(oracle.d)))
    _assert_matches_oracle(out2, oracle, rng)


# ---------------------------------------------------------------------------
# apply_ops_sharded(rebalance=True): the reference's jitted streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nw", WIDTHS)
def test_zipf_acceptance_stream_equals_jitted_repro(nw):
    """BENCH_rebalance's Zipf(1.2) inserts on a state padded to 32: 0
    failed inserts, results equal the jitted reference and a monolithic
    list, every array equal after every batch, the ceiling held."""
    ref0, shl0, oracle0, keys, rng = _build_w(nw, n=48, n_shards=4,
                                              capacity=16)
    ref, shl = rbt.pad_shards(ref0, 32), trbt.pad_shards(shl0, 32)
    batches = list(_zipf_stream(np.random.default_rng(7), n_batches=6,
                                hot_lo=int(keys[2])))
    mono = tsl.build(keys, keys * 3, capacity=1024, levels=8, seed=0,
                     device="cpu")
    oracle = DictOracle()
    oracle.d.update(oracle0.d)
    for kk in batches:
        ops = np.full(kk.size, tsl.OP_INSERT, np.int32)
        ref, res_r = _jit_apply(ref, ops, kk, kk * 2)
        shl, res = tsh.apply_ops_sharded(shl, ops, kk, kk * 2,
                                         rebalance=True)
        mono, res_m = tsl.apply_ops(mono, ops, kk, kk * 2)
        np.testing.assert_array_equal(res.numpy(), np.asarray(res_r))
        np.testing.assert_array_equal(res.numpy(), res_m.numpy())
        _assert_same(shl, ref)
        for k in kk:
            oracle.insert(int(k), int(k) * 2)
        assert bool(tsh.check_sharded_invariant(shl, expect_n=len(oracle.d)))
        assert shl.n_shards == 32
    new_keys = torch.from_numpy(np.unique(np.concatenate(batches)))
    f, v = tsh.search_sharded(shl, new_keys)
    assert bool(f.all())
    np.testing.assert_array_equal(v.numpy(), new_keys.numpy() * 2)
    assert trbt.live_shard_count(shl) > 4
    _assert_matches_oracle(shl, oracle, rng)


@pytest.mark.parametrize("nw", WIDTHS)
def test_mixed_stream_equals_jitted_repro(nw):
    ref0, shl0, oracle, keys, rng = _build_w(nw, n=24, n_shards=4,
                                             capacity=16, seed=5)
    ref, shl = rbt.pad_shards(ref0, 16), trbt.pad_shards(shl0, 16)
    for r in range(4):
        if r % 2:
            hot = int(rng.integers(0, SPAN - 4096))
            kk = (hot + (rng.zipf(1.2, 36) - 1) % 4096).astype(np.int32)
        else:
            kk = rng.integers(0, SPAN, 36).astype(np.int32)
        ops = rng.integers(0, 3, 36).astype(np.int32)
        vv = (kk * 7 + r).astype(np.int32)
        expected = []
        for o, k, v in zip(ops, kk, vv):
            if o == tsl.OP_INSERT:
                expected.append(int(oracle.insert(int(k), int(v))))
            elif o == tsl.OP_DELETE:
                expected.append(int(oracle.delete(int(k))))
            else:
                expected.append(int(oracle.search(int(k))[0]))
        ref, res_r = _jit_apply(ref, ops, kk, vv, seed=r)
        shl, res = tsh.apply_ops_sharded(shl, ops, kk, vv, rebalance=True,
                                         seed=r)
        assert res.numpy().tolist() == expected
        np.testing.assert_array_equal(res.numpy(), np.asarray(res_r))
        _assert_same(shl, ref)
        assert bool(tsh.check_sharded_invariant(shl, expect_n=len(oracle.d)))
        _assert_matches_oracle(shl, oracle, rng)


def test_empty_sharded_grows_in_place_like_repro():
    """``empty_sharded`` with S > 1 carries a ceiling: eager rebalancing
    applies grow it in place, in the reference and the port (the fat
    layout's in-place streams run under ``jax.jit`` above)."""
    args = dict(n_shards=4, capacity=16, levels=6)
    ref = shd.empty_sharded(**args)
    shl = tsh.empty_sharded(device="cpu", **args)
    assert tsh._has_static_ceiling(shl) and shd._has_static_ceiling(ref)
    _assert_same(shl, ref)
    counts = []
    for b in range(2):
        kk = np.arange(1 + b, 120, 3, dtype=np.int32)
        ops = np.full(kk.shape, tsl.OP_INSERT, np.int32)
        ref, res_r = shd.apply_ops_sharded(ref, jnp.asarray(ops),
                                           jnp.asarray(kk),
                                           jnp.asarray(kk * 2),
                                           rebalance=True, seed=b)
        shl, res = tsh.apply_ops_sharded(shl, ops, kk, kk * 2,
                                         rebalance=True, seed=b)
        np.testing.assert_array_equal(res.numpy(), np.asarray(res_r))
        _assert_same(shl, ref)
        counts.append(shl.n_shards)
    # in place while a dead slot is left; once every slot is live the
    # ceiling is gone and the host passes may grow the axis, as in repro
    assert counts[0] == 4 and trbt.live_shard_count(shl) > 1, counts


@pytest.mark.parametrize("nw", WIDTHS)
def test_fully_live_state_in_place_equals_jitted_repro(nw):
    """A fully live state: the reference's jitted apply rebalances it in
    place (the mesh's case), as the port does with ``_in_place``.  Deletes
    empty the upper shards, whose merges free slots; inserts into shard 0
    then split into them, with the caller's seed."""
    ref0, shl0, _, keys, rng = _build_w(nw, n=40, n_shards=4, capacity=16)
    assert not tsh._has_static_ceiling(shl0)
    drop = keys[20:]
    dels = np.full(drop.size, tsl.OP_DELETE, np.int32)
    kk = np.setdiff1d(np.unique(rng.integers(0, int(keys[8]), 40)
                                .astype(np.int32)), keys)
    ins = np.full(kk.size, tsl.OP_INSERT, np.int32)
    heights = []
    for seed in (0, 1234):
        ref, shl = ref0, shl0
        for ops, k, v in ((dels, drop, 0 * drop), (ins, kk, kk * 2)):
            ref, res_r = _jit_apply(ref, ops, k, v, seed=seed)
            shl, res = tsh.apply_ops_sharded(shl, ops, k, v, rebalance=True,
                                             seed=seed, _in_place=True)
            np.testing.assert_array_equal(res.numpy(), np.asarray(res_r))
            _assert_same(shl, ref)
            assert shl.n_shards == 4
        heights.append(shl.shards.height.numpy())
    assert (heights[0] != heights[1]).any(), "seed did not reach the splits"
    out, _ = tsh.apply_ops_sharded(shl0, dels, drop, 0 * drop,
                                   rebalance=True)
    assert out.n_shards < 4                     # the host passes shrink it
