"""The port's shard split / merge / repack and watermark rebalancing against
repro's, bit for bit, on the CPU.

Twins of ``tests/test_rebalance.py``: every state array (``rng`` and the
boundaries included), every result and the shard count equal the
reference's after each operation, and the reference test's own checks
hold on the port.  Its jit case and the padded-ceiling cases are the
in-place passes' (``tests/test_torch_rebalance_traced.py``); the
static-ceiling case here holds them to the reference's eager dispatch.
The seeded fuzz differential runs at a small size.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sharded as shd
from repro.core.oracle import DictOracle
from repro.kernels import ops as kops
from repro_torch.convert import sharded_to_numpy
from repro_torch.core import sharded as tsh
from repro_torch.core import skiplist as tsl
from repro_torch.kernels import ops as tops

SPAN = 1 << 16


def _np(shl):
    out = {f"shards.{k}": np.asarray(v)
           for k, v in shl.shards._asdict().items() if v is not None}
    out["boundaries"] = np.asarray(shl.boundaries)
    return out


def _assert_same(port, ref):
    got, want = sharded_to_numpy(port), _np(ref)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _build(n=60, n_shards=4, levels=8, capacity=0, seed=0, span=SPAN):
    """(repro index, the port's own build of it, oracle, keys, rng)."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(span, n, replace=False)).astype(np.int32)
    ref = shd.build_sharded(jnp.asarray(keys), jnp.asarray(keys * 3),
                            n_shards=n_shards, levels=levels,
                            capacity=capacity, seed=seed)
    shl = tsh.build_sharded(keys, keys * 3, n_shards=n_shards, levels=levels,
                            capacity=capacity, seed=seed, device="cpu")
    _assert_same(shl, ref)
    oracle = DictOracle()
    for k in keys:
        oracle.insert(int(k), int(k) * 3)
    return ref, shl, oracle, keys, rng


def _apply(ref, shl, ops, kk, vv, **kw):
    """The same batch through both; results and states must agree."""
    ref2, res_r = shd.apply_ops_sharded(ref, jnp.asarray(ops),
                                        jnp.asarray(kk), jnp.asarray(vv),
                                        **kw)
    shl2, res_s = tsh.apply_ops_sharded(shl, ops, kk, vv, **kw)
    np.testing.assert_array_equal(res_s.numpy(), np.asarray(res_r))
    _assert_same(shl2, ref2)
    return ref2, shl2, res_s.numpy()


def _assert_matches_oracle(shl, oracle, rng, n_probe=48):
    """Search + range-scan differential against the DictOracle."""
    live = np.fromiter(oracle.d, np.int32, len(oracle.d)) if oracle.d \
        else np.zeros(0, np.int32)
    probe = np.concatenate([live,
                            rng.integers(0, SPAN, n_probe)]).astype(np.int32)
    f, v = tsh.search_sharded(shl, torch.from_numpy(probe))
    np.testing.assert_array_equal(f.numpy(),
                                  np.array([k in oracle.d for k in probe]))
    np.testing.assert_array_equal(
        v.numpy(), np.array([oracle.d.get(int(k), int(tsl.NULL_VAL))
                             for k in probe], np.int32))
    lo = int(rng.integers(0, SPAN))
    hi = lo + int(rng.integers(1, SPAN // 2))
    ks, vs, count = tsh.range_scan_sharded(shl, lo, hi, 96)
    expect = [k for k in oracle.sorted_keys() if lo <= k < hi][:96]
    assert ks[:int(count)].tolist() == expect
    np.testing.assert_array_equal(
        vs[:int(count)].numpy(),
        np.array([oracle.d[k] for k in expect], np.int32))


# ---------------------------------------------------------------------------
# Structural units: split / merge / repack preserve contents + invariants
# ---------------------------------------------------------------------------

def test_split_at_median_preserves_contents():
    ref, shl, oracle, keys, rng = _build()
    n0 = int(tsh.total_n(shl))
    shl2 = tsh.split_shard(shl, 1, seed=5)
    _assert_same(shl2, shd.split_shard(ref, 1, seed=5))
    assert shl2.n_shards == shl.n_shards + 1
    assert bool(tsh.check_sharded_invariant(shl2, expect_n=n0))
    assert np.all(np.diff(shl2.boundaries.numpy().astype(np.int64)) >= 0)
    _assert_matches_oracle(shl2, oracle, rng)


def test_split_at_explicit_key_and_range_guard():
    ref, shl, oracle, keys, rng = _build()
    b = shl.boundaries.numpy()
    at = int(b[1]) + 1
    shl2 = tsh.split_shard(shl, 1, at_key=at)
    _assert_same(shl2, shd.split_shard(ref, 1, at_key=at))
    assert int(shl2.boundaries[2]) == at
    assert bool(tsh.check_sharded_invariant(shl2, expect_n=len(oracle.d)))
    _assert_matches_oracle(shl2, oracle, rng)
    with pytest.raises(ValueError, match="outside"):
        tsh.split_shard(shl, 1, at_key=int(b[1]))
    with pytest.raises(ValueError, match="outside"):
        tsh.split_shard(shl, 1, at_key=int(b[2]))
    with pytest.raises(ValueError, match="out of range"):
        tsh.split_shard(shl, 4)
    with pytest.raises(ValueError, match="median"):
        tsh.split_shard(tsh.build_sharded(np.array([7], np.int32),
                                          np.array([1], np.int32),
                                          n_shards=1, device="cpu"), 0)


def test_merge_preserves_contents_and_rejects_overflow():
    ref, shl, oracle, keys, rng = _build()
    shl2 = tsh.merge_shards(shl, 2, seed=3)
    _assert_same(shl2, shd.merge_shards(ref, 2, seed=3))
    assert shl2.n_shards == shl.n_shards - 1
    assert bool(tsh.check_sharded_invariant(shl2, expect_n=len(oracle.d)))
    _assert_matches_oracle(shl2, oracle, rng)
    _, full, _, _, _ = _build(n=100, n_shards=2, capacity=64)
    with pytest.raises(ValueError, match="exceeds"):
        tsh.merge_shards(full, 0)                  # 50 + 50 + 2 > 64
    with pytest.raises(ValueError, match="capacity"):
        tsh.repack(full, 1)                        # 100 + 2 > 64
    with pytest.raises(ValueError, match="neighbour"):
        tsh.merge_shards(full, 1)


def test_repack_equalizes_occupancy():
    ref, shl, oracle, keys, rng = _build(n=60, n_shards=4)
    ref2 = shd.split_shard(shd.split_shard(ref, 0), 0)
    shl2 = tsh.split_shard(tsh.split_shard(shl, 0), 0)
    _assert_same(shl2, ref2)
    ns_before = shl2.shards.n.numpy()
    shl3 = tsh.repack(shl2, seed=2)
    _assert_same(shl3, shd.repack(ref2, seed=2))
    ns = shl3.shards.n.numpy()
    assert shl3.n_shards == shl2.n_shards
    assert ns.max() - ns.min() <= 1
    assert ns.max() < ns_before.max() or ns_before.max() - ns_before.min() <= 1
    assert bool(tsh.check_sharded_invariant(shl3, expect_n=len(oracle.d)))
    _assert_matches_oracle(shl3, oracle, rng)
    shl4 = tsh.repack(shl2, n_shards=2)
    _assert_same(shl4, shd.repack(ref2, n_shards=2))
    assert shl4.n_shards == 2
    assert bool(tsh.check_sharded_invariant(shl4, expect_n=len(oracle.d)))
    _assert_matches_oracle(shl4, oracle, rng)


def test_rebalance_driver_watermarks():
    # capacity 64 -> usable 62; 50 keys a shard is above 0.75 * 62
    ref, shl, oracle, keys, rng = _build(n=100, n_shards=2, capacity=64)
    assert shl.shards.n.numpy().max() > 0.75 * 62
    shl2, stats = tsh.rebalance(shl, seed=4)
    ref2, stats_r = shd.rebalance(ref, seed=4)
    assert stats == tuple(stats_r) and stats.splits >= 1
    _assert_same(shl2, ref2)
    assert np.all(shl2.shards.n.numpy() <= 0.75 * 62)
    assert bool(tsh.check_sharded_invariant(shl2, expect_n=len(oracle.d)))
    _assert_matches_oracle(shl2, oracle, rng)
    drop = keys[::2]
    ops = np.full(drop.size, tsl.OP_DELETE, np.int32)
    ref3, shl3, res = _apply(ref2, shl2, ops, drop,
                             np.zeros(drop.size, np.int32))
    for k in drop:
        oracle.delete(int(k))
    assert (res == 1).all()
    shl4, stats2 = tsh.rebalance(shl3)
    ref4, stats2_r = shd.rebalance(ref3)
    assert stats2 == tuple(stats2_r) and stats2.merges >= 1
    _assert_same(shl4, ref4)
    assert shl4.n_shards < shl3.n_shards
    assert bool(tsh.check_sharded_invariant(shl4, expect_n=len(oracle.d)))
    _assert_matches_oracle(shl4, oracle, rng)
    with pytest.raises(ValueError, match="high_water"):
        tsh.rebalance(shl4, high_water=0.5)
    with pytest.raises(ValueError, match="low_water"):
        tsh.rebalance(shl4, low_water=0.8)


def test_empty_sharded_grows_under_rebalance():
    ref = shd.empty_sharded(n_shards=1, capacity=16, levels=6)
    shl = tsh.empty_sharded(n_shards=1, capacity=16, levels=6, device="cpu")
    kk = np.arange(1, 100, 3, dtype=np.int32)
    ops = np.full(kk.shape, tsl.OP_INSERT, np.int32)
    _, shl2, res = _apply(ref, shl, ops, kk, kk * 2, rebalance=True)
    assert (res == 1).all()
    assert shl2.n_shards > 1
    assert bool(tsh.check_sharded_invariant(shl2, expect_n=int(kk.size)))
    f, v = tsh.search_sharded(shl2, torch.from_numpy(kk))
    assert bool(f.all())
    np.testing.assert_array_equal(v.numpy(), kk * 2)


def test_static_ceiling_rebalance_is_not_ported():
    """A state whose last boundary is KEY_MAX (every empty_sharded with
    S > 1) rebalances in place through core.rebalance_traced, in the
    reference and the port alike: equal arrays, results and stats.  (The
    name predates the port of those in-place passes.)"""
    ref = shd.empty_sharded(n_shards=4, capacity=16, levels=6)
    shl = tsh.empty_sharded(n_shards=4, capacity=16, levels=6, device="cpu")
    assert tsh._has_static_ceiling(shl)
    assert shd._has_static_ceiling(ref)
    kk = np.arange(1, 30, 3, dtype=np.int32)
    ops = np.full(kk.shape, tsl.OP_INSERT, np.int32)
    shl2, stats = tsh.rebalance(shl)
    ref2, stats_r = shd.rebalance(ref)
    assert stats == (int(stats_r.splits), int(stats_r.merges))
    _assert_same(shl2, ref2)
    ref3, shl3, res = _apply(ref, shl, ops, kk, kk, rebalance=True)
    assert (res == 1).all() and shl3.n_shards == 4
    # a built state whose last shard came out empty carries one too
    ref_b, built, _, _, _ = _build(n=10, n_shards=8, levels=6)
    assert tsh._has_static_ceiling(built)
    built2, stats = tsh.rebalance(built)
    ref_b2, stats_r = shd.rebalance(ref_b)
    assert stats == (int(stats_r.splits), int(stats_r.merges))
    _assert_same(built2, ref_b2)
    _, _, res = _apply(ref, shl, ops, kk, kk)           # no rebalance
    assert (res == 1).all()


def test_exhaustion_guard_equals_repro():
    ref, shl, _, keys, rng = _build(n=48, n_shards=4, capacity=16)
    hot = int(keys[2])
    kk = (hot + (rng.zipf(1.2, 40) - 1) % 4096).astype(np.int32)
    ops = np.where(rng.random(40) < 0.8, tsl.OP_INSERT,
                   tsl.OP_READ).astype(np.int32)
    for seed in (0, 11):
        ref2, n_r = shd._exhaustion_guard(ref, jnp.asarray(ops),
                                          jnp.asarray(kk), max_shards=1024,
                                          seed=seed)
        shl2, n_s = tsh._exhaustion_guard(shl, torch.from_numpy(ops),
                                          torch.from_numpy(kk),
                                          max_shards=1024, seed=seed)
        assert n_s == n_r > 0
        _assert_same(shl2, ref2)
    ref3, n_r = shd._exhaustion_guard(ref, jnp.asarray(ops), jnp.asarray(kk),
                                      max_shards=5)
    shl3, n_s = tsh._exhaustion_guard(shl, torch.from_numpy(ops),
                                      torch.from_numpy(kk), max_shards=5)
    assert n_s == n_r == 1
    _assert_same(shl3, ref3)
    reads = np.zeros_like(ops)
    assert tsh._exhaustion_guard(shl, torch.from_numpy(reads),
                                 torch.from_numpy(kk), max_shards=9)[1] == 0


# ---------------------------------------------------------------------------
# Zipf(1.2) inserts: fixed boundaries exhaust, rebalanced ones complete
# ---------------------------------------------------------------------------

def _zipf_stream(rng, n_batches=4, batch=32, hot_lo=0, hot_span=4096):
    for _ in range(n_batches):
        yield (hot_lo + (rng.zipf(1.2, batch) - 1) % hot_span).astype(np.int32)


def test_zipf_exhaustion_fixed_fails_rebalanced_completes():
    ref0, shl0, oracle0, keys, rng = _build(n=48, n_shards=4, capacity=16)
    hot_lo = int(keys[2])
    batches = list(_zipf_stream(np.random.default_rng(7), hot_lo=hot_lo))

    # Fixed boundaries, the port alone (the reference's own test runs it).
    shl = shl0
    oracle = DictOracle()
    oracle.d.update(oracle0.d)
    failed = 0
    for kk in batches:
        ops = np.full(kk.size, tsl.OP_INSERT, np.int32)
        shl, res = tsh.apply_ops_sharded(shl, ops, kk, kk * 2)
        res = res.numpy()
        for i, k in enumerate(kk):
            expect_new = int(oracle.insert(int(k), int(k) * 2))
            if expect_new and not res[i]:
                failed += 1
            else:
                assert res[i] == expect_new
    assert failed > 0, "stream too small to exhaust the fixed shard"

    ref, shl = ref0, shl0
    oracle = DictOracle()
    oracle.d.update(oracle0.d)
    mono = tsl.build(keys, keys * 3, capacity=512, levels=8, seed=0,
                     device="cpu")
    for kk in batches:
        ops = np.full(kk.size, tsl.OP_INSERT, np.int32)
        ref, shl, res = _apply(ref, shl, ops, kk, kk * 2, rebalance=True)
        mono, res_m = tsl.apply_ops(mono, ops, kk, kk * 2)
        np.testing.assert_array_equal(res, res_m.numpy())
        for k in kk:
            oracle.insert(int(k), int(k) * 2)
        assert bool(tsh.check_sharded_invariant(shl,
                                                expect_n=len(oracle.d)))
    assert shl.n_shards > shl0.n_shards
    probe = torch.from_numpy(np.concatenate(
        [keys, np.unique(np.concatenate(batches)),
         rng.integers(0, SPAN, 64)]).astype(np.int32))
    f_m, v_m = tsl.search_fast(mono, probe)
    f_s, v_s = tsh.search_sharded(shl, probe)
    np.testing.assert_array_equal(f_s.numpy(), f_m.numpy())
    np.testing.assert_array_equal(v_s.numpy(), v_m.numpy())
    _assert_matches_oracle(shl, oracle, rng)


# ---------------------------------------------------------------------------
# Differential fuzz (seeded, small)
# ---------------------------------------------------------------------------

def _replay_stream(seed, *, rounds=3, batch=36, zipf=False, n_init=24,
                   n_shards=4, capacity=16, levels=8, repack_every=2):
    """A random op stream through both packages against the DictOracle,
    rebalancing on; after every batch and repack the states, results,
    invariant, searches and scans agree."""
    ref, shl, oracle, keys, rng = _build(n=n_init, n_shards=n_shards,
                                         capacity=capacity, levels=levels,
                                         seed=seed)
    for r in range(rounds):
        if zipf:
            hot = int(rng.integers(0, SPAN - 4096))
            kk = (hot + (rng.zipf(1.2, batch) - 1) % 4096).astype(np.int32)
        else:
            kk = rng.integers(0, SPAN, batch).astype(np.int32)
        ops = rng.integers(0, 3, batch).astype(np.int32)
        vv = (kk * 7 + r).astype(np.int32)
        expected = []
        for o, k, v in zip(ops, kk, vv):
            if o == tsl.OP_INSERT:
                expected.append(int(oracle.insert(int(k), int(v))))
            elif o == tsl.OP_DELETE:
                expected.append(int(oracle.delete(int(k))))
            else:
                expected.append(int(oracle.search(int(k))[0]))
        ref, shl, res = _apply(ref, shl, ops, kk, vv, rebalance=True,
                               seed=r)
        assert res.tolist() == expected
        assert bool(tsh.check_sharded_invariant(shl, expect_n=len(oracle.d)))
        _assert_matches_oracle(shl, oracle, rng)
        if repack_every and (r + 1) % repack_every == 0:
            ref, shl = shd.repack(ref), tsh.repack(shl)
            _assert_same(shl, ref)
            assert bool(tsh.check_sharded_invariant(shl,
                                                    expect_n=len(oracle.d)))
            _assert_matches_oracle(shl, oracle, rng)
    return shl


def test_fuzz_differential_seeded():
    _replay_stream(0, rounds=2, batch=30, repack_every=1)
    _replay_stream(1, rounds=2, batch=30, zipf=True)


# ---------------------------------------------------------------------------
# A sorted block straddling all shards after a split (S = 9)
# ---------------------------------------------------------------------------

def test_sorted_block_straddling_all_shards_cluster_plan():
    ref, shl, _, keys, _ = _build(n=1200, n_shards=8, levels=10,
                                  capacity=512)
    ref, shl = shd.split_shard(ref, 3), tsh.split_shard(shl, 3)
    _assert_same(shl, ref)
    S = shl.n_shards
    sids = tsh.route(shl.boundaries, torch.from_numpy(keys)).numpy()
    picks = np.array([keys[sids == s][0] for s in range(S)], np.int32)
    q = torch.from_numpy(np.sort(picks))
    plan = tops.cluster_queries(shl.boundaries, tops._pad(q)[0])
    assert plan.block_sids.shape == (1, S)
    assert int(plan.ndist[0]) == S
    rc = tops.search_kernel_sharded(shl, q, cluster=True)
    rd = tops.search_kernel_sharded(shl, q, cluster=False)
    for a, c in zip(rc, rd):
        np.testing.assert_array_equal(a.numpy(), c.numpy())
    assert bool(rc.found.all())
    np.testing.assert_array_equal(rc.vals.numpy(), np.sort(picks) * 3)
    want = kops.search_kernel_sharded(ref, jnp.asarray(q.numpy()))
    for a, w in zip(rc, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
