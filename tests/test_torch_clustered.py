"""The port's sharded kernels K3-K6, the clustered plan and K7 against
repro's, bit for bit, on the CPU (Pallas in interpret mode).

Twins of ``tests/test_clustered_traversal.py``; its three jit cases and the
traced half of the undersized-K case have no eager counterpart (ROADMAP
item 7).  Also: plain K3-K6 against the Pallas kernels at the default step
cap and at ``max_steps=9``, the five plan arrays (which depend on the zero
padding to whole 128-lane blocks), the degeneration split and the TPU
cost model arithmetic.  The CUDA kernels themselves are tested on a card by
``tests/test_torch_sharded_gpu.py``.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.foresight_traverse  # noqa: F401  (the module, below)
from repro.core import sharded as shd
from repro.kernels import ops as kops
from repro_torch.convert import sharded_from_numpy
from repro_torch.core import sharded as tsh
from repro_torch.core import skiplist as tsl
from repro_torch.kernels import foresight_traverse as tft
from repro_torch.kernels import ops as tops

jft = sys.modules["repro.kernels.foresight_traverse"]
QBLK = tft.QBLK


def _index(n=1500, n_shards=8, levels=12, foresight=True, seed=0,
           span=1 << 22):
    """(repro index, the port's copy of it, keys, rng)."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(span, n, replace=False)).astype(np.int32)
    ref = shd.build_sharded(jnp.asarray(keys), jnp.asarray(keys * 3),
                            n_shards=n_shards, levels=levels,
                            foresight=foresight, seed=seed)
    return ref, _port(ref), keys, rng


def _port(ref):
    arrays = {f"shards.{k}": np.asarray(v)
              for k, v in ref.shards._asdict().items() if v is not None}
    arrays["boundaries"] = np.asarray(ref.boundaries)
    return sharded_from_numpy(arrays, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _assert_clustered_matches(ref, shl, q):
    """Clustered = dense = eager search in the port, and = repro."""
    rc = tops.search_kernel_sharded(shl, _t(q), cluster=True)
    rd = tops.search_kernel_sharded(shl, _t(q), cluster=False)
    _eq(rc, rd)
    _eq(rc, kops.search_kernel_sharded(ref, jnp.asarray(q), cluster=True))
    _eq(rc[:2], tsh.search_sharded(shl, _t(q)))


def _assert_same_plan(ref, shl, q_padded, **kw):
    want = kops.cluster_queries(ref.boundaries, jnp.asarray(q_padded), **kw)
    got = tops.cluster_queries(shl.boundaries, _t(q_padded), **kw)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    return got


@pytest.mark.parametrize("foresight", [True, False])
def test_clustered_bit_identical_mixed_batch(foresight):
    ref, shl, keys, rng = _index(foresight=foresight)
    q = np.concatenate([rng.choice(keys, 150),
                        rng.integers(0, 1 << 22, 106)]).astype(np.int32)
    _assert_clustered_matches(ref, shl, q)


def test_clustered_all_lanes_one_shard():
    ref, shl, keys, _ = _index()
    b = shl.boundaries.numpy()
    inside = keys[(keys >= b[2]) & (keys < b[3])]
    q = np.resize(inside, 2 * QBLK).astype(np.int32)
    plan = _assert_same_plan(ref, shl, q)
    assert plan.block_sids.shape[1] == 1
    assert bool((plan.ndist == 1).all())
    _assert_clustered_matches(ref, shl, q)


def test_clustered_one_lane_per_shard():
    """A single block straddles every shard -> K = S."""
    ref, shl, _, _ = _index(n_shards=8)
    b = shl.boundaries.numpy().astype(np.int64)
    q = np.concatenate([b[1:], [b[-1] + 1]]).astype(np.int32)
    plan = _assert_same_plan(ref, shl, tops._pad(_t(q))[0].numpy())
    assert plan.block_sids.shape[1] == shl.n_shards
    _assert_clustered_matches(ref, shl, q)


def test_clustered_padded_tail():
    """B not a multiple of QBLK: pad lanes ride along and are dropped."""
    ref, shl, keys, rng = _index()
    for B in (1, QBLK - 1, QBLK + 1, 3 * QBLK + 7):
        _assert_clustered_matches(ref, shl,
                                  rng.choice(keys, B).astype(np.int32))


def test_cluster_plan_is_permutation_and_covers_lanes():
    ref, shl, keys, rng = _index()
    q = rng.integers(0, 1 << 22, 4 * QBLK).astype(np.int32)
    plan = _assert_same_plan(ref, shl, q)
    np.testing.assert_array_equal(plan.q_sorted[plan.inv].numpy(), q)
    sid_sorted = plan.sid_sorted.numpy()
    assert np.all(np.diff(sid_sorted) >= 0)
    bs, nd = plan.block_sids.numpy(), plan.ndist.numpy()
    for j in range(bs.shape[0]):
        blk = sid_sorted[j * QBLK:(j + 1) * QBLK]
        distinct = np.unique(blk)
        assert nd[j] == len(distinct)
        np.testing.assert_array_equal(bs[j, :nd[j]], distinct)
        assert np.all(bs[j, nd[j]:] == blk[-1])


def test_cluster_plan_depends_on_the_zero_padding():
    """The reference pads with zeros BEFORE planning: 28 pad lanes route
    to shard 0, take part in the stable sort and widen the first block,
    and auto-K follows.  The port's plan is the same, array for array,
    and so is an explicit K."""
    ref, shl, keys, rng = _index(n_shards=8)
    b = shl.boundaries.numpy()
    q = np.concatenate([keys[keys >= b[4]][:50], keys[keys >= b[7]][:50]])
    q = rng.permutation(q).astype(np.int32)
    qp = tops._pad(_t(q))[0].numpy()
    assert qp.shape[0] == QBLK and (qp[100:] == 0).all()
    plan = _assert_same_plan(ref, shl, qp)
    assert plan.ndist.tolist() == [3]            # shards 0 (pad), 4 and 7
    assert plan.sid_sorted[:28].tolist() == [0] * 28
    assert plan.block_sids.shape[1] == 4         # 3 rounded up to 4
    _assert_same_plan(ref, shl, qp, k_shards=8)
    _assert_clustered_matches(ref, shl, q)


def test_dma_model_equals_repro_and_shows_the_zipf_reduction():
    """The TPU cost model is host arithmetic: the port's copy equals the
    reference's, dense and clustered (a Zipf batch at S=16 models >= 2x
    fewer tile bytes clustered)."""
    from benchmarks.common import zipf_queries
    ref, shl, keys, _ = _index(n=2**13, n_shards=16)
    q = np.asarray(zipf_queries(keys, 1024))
    qp = tops._pad(_t(q))[0].numpy()
    plan = _assert_same_plan(ref, shl, qp)
    ref_plan = kops.cluster_queries(ref.boundaries, jnp.asarray(qp))
    dense = tops.dma_model_bytes(shl, 1024)
    clustered = tops.dma_model_bytes(shl, 1024, plan.block_sids)
    assert dense == kops.dma_model_bytes(ref, 1024)
    assert clustered == kops.dma_model_bytes(ref, 1024, ref_plan.block_sids)
    assert tops.dma_model_tile_loads(plan.block_sids) == \
        kops.dma_model_tile_loads(ref_plan.block_sids)
    assert dense >= 2 * clustered
    for n, s in ((1000, 4), (2**20, 64)):
        for fs in (True, False):
            assert tops.shard_vmem_footprint(12, 2**n.bit_length(), fs) == \
                kops.shard_vmem_footprint(12, 2**n.bit_length(), fs)
        assert tops.auto_shards(n, 12) == kops.auto_shards(n, 12)


@pytest.mark.parametrize("foresight", [True, False])
def test_clustered_random_batches_seeded(foresight):
    ref, shl, keys, _ = _index(n=800, n_shards=4, levels=10,
                               foresight=foresight)
    for seed in range(3):
        rng = np.random.default_rng(seed)
        B = int(rng.integers(1, 2 * QBLK))
        q = np.concatenate([rng.integers(0, 1 << 22, B),
                            rng.choice(keys, int(rng.integers(0, 50)))])
        _assert_clustered_matches(ref, shl, q.astype(np.int32))


# ---------------------------------------------------------------------------
# Plain K3-K6 against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("max_steps", [0, 9])
def test_plain_sharded_and_clustered_kernels_match_pallas(foresight,
                                                          max_steps):
    ref, shl, keys, rng = _index(n_shards=8, levels=12, foresight=foresight)
    ref = shd.split_shard(ref, 0)                  # S = 9
    shl = _port(ref)
    q = np.concatenate([rng.choice(keys, 200),
                        rng.integers(0, 1 << 22, 184)]).astype(np.int32)
    sid = np.array(shd.route(ref.boundaries, jnp.asarray(q)))
    sid[::37] = -1                                 # unrouted lanes: (0, 0)
    plan = kops.cluster_queries(ref.boundaries, jnp.asarray(q))
    tabs_j = ((ref.shards.fused,) if foresight
              else (ref.shards.nxt, ref.shards.keys))
    tabs_t = ((shl.shards.fused,) if foresight
              else (shl.shards.nxt, shl.shards.keys))
    dense_j = (jft.foresight_traverse_sharded if foresight
               else jft.base_traverse_sharded)
    dense_t = (tft.foresight_traverse_sharded if foresight
               else tft.base_traverse_sharded)
    clus_j = (jft.foresight_traverse_clustered if foresight
              else jft.base_traverse_clustered)
    clus_t = (tft.foresight_traverse_clustered if foresight
              else tft.base_traverse_clustered)
    got = dense_t(*tabs_t, _t(sid), _t(q), max_steps=max_steps)
    _eq(got, dense_j(*tabs_j, jnp.asarray(sid), jnp.asarray(q),
                     max_steps=max_steps))
    assert (got[0].numpy()[::37] == 0).all()
    # a plan whose blocks leave lanes unserved: slots cut to 1, ndist kept
    for bs, nd in ((plan.block_sids, plan.ndist),
                   (plan.block_sids[:, :1], plan.ndist)):
        got = clus_t(*tabs_t, _t(bs), _t(nd), _t(plan.sid_sorted),
                     _t(plan.q_sorted), max_steps=max_steps)
        _eq(got, clus_j(*tabs_j, bs, nd, plan.sid_sorted, plan.q_sorted,
                        max_steps=max_steps))


def test_clustered_wrappers_refuse_stale_and_misshapen_plans():
    """K never exceeds the current S: a plan built for a larger S is
    refused (the reference asserts ``stale``), and so is a batch that is
    not the plan's blocks."""
    ref, shl, keys, rng = _index(n=400, n_shards=4, levels=8)
    qp = tops._pad(_t(rng.choice(keys, 64).astype(np.int32)))[0]
    plan_old = tops.cluster_queries(shl.boundaries, qp, k_shards=4)
    merged = tsh.merge_shards(tsh.merge_shards(shl, 0), 1)   # S = 2
    with pytest.raises(ValueError, match="stale"):
        tft.foresight_traverse_clustered(merged.shards.fused,
                                         plan_old.block_sids, plan_old.ndist,
                                         plan_old.sid_sorted,
                                         plan_old.q_sorted)
    with pytest.raises(ValueError, match="blocks"):
        tft.foresight_traverse_clustered(shl.shards.fused,
                                         plan_old.block_sids, plan_old.ndist,
                                         plan_old.sid_sorted[:64],
                                         plan_old.q_sorted[:64])
    with pytest.raises(ValueError, match="differ"):
        tft.foresight_traverse_sharded(shl.shards.fused,
                                       plan_old.sid_sorted[:3], qp)
    f, v = tsh.search_sharded(merged, qp)
    rc = tops.search_kernel_sharded(merged, qp)
    np.testing.assert_array_equal(rc.found.numpy(), f.numpy())
    np.testing.assert_array_equal(rc.vals.numpy(), v.numpy())


# ---------------------------------------------------------------------------
# Segment-scoped apply_ops_sharded
# ---------------------------------------------------------------------------

def test_shard_segments_bounds():
    sid_sorted = [0, 0, 0, 2, 2, 5, 5, 5, 5]
    starts, lens = tsh.shard_segments(torch.tensor(sid_sorted,
                                                   dtype=torch.int32), 8)
    want = shd.shard_segments(jnp.asarray(sid_sorted, jnp.int32), 8)
    _eq((starts, lens), want)
    np.testing.assert_array_equal(starts.numpy(), [0, 3, 3, 5, 5, 5, 9, 9])
    np.testing.assert_array_equal(lens.numpy(), [3, 0, 2, 0, 0, 4, 0, 0])
    assert int(lens.max()) == 4 < len(sid_sorted)
    for B, S in ((1, 1), (64, 4), (300, 8), (7, 16), (1000, 3)):
        assert tsh.default_segment_window(B, S) == \
            shd.default_segment_window(B, S)
    for W in (1, 8, 9, 100):
        assert tsh._segment_window(W) == shd._segment_window(W)


def test_apply_ops_sharded_segment_scoped_matches_monolithic():
    rng = np.random.default_rng(3)
    keys = np.sort(rng.choice(1 << 22, 1000, replace=False)).astype(np.int32)
    cap = int(2 ** np.ceil(np.log2(2 * 1000 + 4)))
    mono = tsl.build(keys, keys * 3, capacity=cap, levels=12, seed=0,
                     device="cpu")
    ref = shd.build_sharded(jnp.asarray(keys), jnp.asarray(keys * 3),
                            n_shards=8, levels=12, seed=0)
    shl = _port(ref)
    b1, b2 = int(shl.boundaries[1]), int(shl.boundaries[2])
    kk = rng.integers(b1, b2, 200).astype(np.int32)   # all on one shard
    ops = rng.integers(0, 3, 200).astype(np.int32)
    mono2, res_m = tsl.apply_ops(mono, ops, kk, kk * 5)
    shl2, res_s = tsh.apply_ops_sharded(shl, ops, kk, kk * 5)
    ref2, res_r = shd.apply_ops_sharded(ref, jnp.asarray(ops),
                                        jnp.asarray(kk), jnp.asarray(kk * 5))
    np.testing.assert_array_equal(res_s.numpy(), res_m.numpy())
    np.testing.assert_array_equal(res_s.numpy(), np.asarray(res_r))
    for name, t in shl2.shards._asdict().items():
        if t is not None:
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(getattr(ref2.shards, name)),
                err_msg=name)
    assert bool(tsh.check_sharded_invariant(shl2))
    assert int(tsh.total_n(shl2)) == int(mono2.n)
    q = _t(rng.integers(0, 1 << 22, 300).astype(np.int32))
    _eq(tsh.search_sharded(shl2, q), tsl.search_fast(mono2, q))


def test_traversal_bound_safe_ceiling_scales_with_occupancy():
    assert tft.traversal_bound(16, 2**18) == 16 + 2**18 - 2 + 16
    for L, cap in ((12, 2**12), (16, 2**8), (20, 64)):
        assert tft.traversal_bound(L, cap) >= 4 * L + 16 or cap < 4 * L
        assert tft.traversal_bound(L, cap) == jft.traversal_bound(L, cap)
    assert tft.traversal_bound(16, 2**8) < tft.traversal_bound(16, 2**18)


def test_undersized_k_shards_raises():
    """An explicit k_shards below a block's distinct-shard count raises
    (the reference's eager guard); a sufficient K serves every lane."""
    ref, shl, keys, _ = _index(n=1200, n_shards=8, levels=10)
    sids = tsh.route(shl.boundaries, _t(keys)).numpy()
    picks = np.sort(np.array([keys[sids == s][0] for s in range(8)],
                             np.int32))
    with pytest.raises(ValueError, match="k_shards"):
        tops.search_kernel_sharded(shl, _t(picks), k_shards=2)
    with pytest.raises(ValueError, match="k_shards"):
        kops.search_kernel_sharded(ref, jnp.asarray(picks), k_shards=2)
    ok = tops.search_kernel_sharded(shl, _t(picks), k_shards=8)
    assert bool(ok.found.all())
    np.testing.assert_array_equal(ok.vals.numpy(), picks * 3)
    _eq(ok, kops.search_kernel_sharded(ref, jnp.asarray(picks), k_shards=8))


def test_search_kernel_sharded_after_rebalance_shard_count_change():
    ref, shl, keys, rng = _index(n=800, n_shards=4, levels=10)
    q = np.concatenate([rng.choice(keys, 96),
                        rng.integers(0, 1 << 22, 64)]).astype(np.int32)
    before = tops.search_kernel_sharded(shl, _t(q))
    shl2 = tsh.split_shard(tsh.split_shard(shl, 0), 3)     # S: 4 -> 6
    assert shl2.n_shards == 6
    after = tops.search_kernel_sharded(shl2, _t(q))
    np.testing.assert_array_equal(before.found.numpy(), after.found.numpy())
    np.testing.assert_array_equal(before.vals.numpy(), after.vals.numpy())
    _eq(after[:2], tsh.search_sharded(shl2, _t(q)))
    ref2 = shd.split_shard(shd.split_shard(ref, 0), 3)
    _eq(after, kops.search_kernel_sharded(ref2, jnp.asarray(q)))


# ---------------------------------------------------------------------------
# K-degeneration: one straggler block must not snap K back to S (K7)
# ---------------------------------------------------------------------------

def _straddle_stream(boundaries, n_blocks=4, tail_per_shard=2):
    """A batch whose LAST sorted block straddles every shard (the twin of
    the reference test's stream, same seed)."""
    b = np.asarray(boundaries).astype(np.int64)
    S = b.shape[0]
    n_tail = tail_per_shard * (S - 1)
    n_hot = n_blocks * QBLK - n_tail
    rng = np.random.default_rng(99)
    hot = rng.integers(0, b[1], n_hot)
    tail = np.concatenate([
        np.linspace(b[i], (b[i + 1] if i + 1 < S else b[-1] + 2) - 1,
                    tail_per_shard, dtype=np.int64)
        for i in range(1, S)])
    return np.concatenate([hot, tail]).astype(np.int32)


def test_degeneration_split_rescues_straggler_block():
    """S = 9: the split keeps K small for the hot blocks and runs only the
    straggler through the dense kernel."""
    ref8, _, _, _ = _index(n_shards=8)
    ref = shd.split_shard(ref8, 0)
    shl = _port(ref)
    S = shl.n_shards
    assert S == 9
    q = _straddle_stream(shl.boundaries.numpy())
    plan = _assert_same_plan(ref, shl, tops._pad(_t(q))[0].numpy())
    nd = plan.ndist.numpy()
    assert nd[-1] == S and (nd[:-1] <= 2).all()
    assert plan.block_sids.shape[1] == S
    split = tops.plan_degeneration_split(plan.ndist, S)
    want = kops.plan_degeneration_split(jnp.asarray(nd), S)
    assert split is not None
    k_small, keep, strag = split
    assert k_small == want[0]
    np.testing.assert_array_equal(keep, want[1])
    np.testing.assert_array_equal(strag, want[2])
    assert k_small < S and strag.tolist() == [len(nd) - 1]
    assert keep.tolist() == list(range(len(nd) - 1))
    assert len(keep) * k_small + len(strag) * S < len(nd) * S
    _assert_clustered_matches(ref, shl, q)
    # K7 equals one full-K clustered launch of the same plan
    tabs = (shl.shards.fused,)
    full = tft.foresight_traverse_clustered(*tabs, plan.block_sids,
                                            plan.ndist, plan.sid_sorted,
                                            plan.q_sorted)
    _eq(tops._degenerate_launch(shl, plan, split, max_steps=0), full)


@pytest.mark.parametrize("foresight", [True, False])
def test_degeneration_split_bit_identical_both_variants(foresight):
    ref, shl, _, _ = _index(n_shards=8, foresight=foresight)
    q = _straddle_stream(shl.boundaries.numpy(), n_blocks=3)
    plan = tops.cluster_queries(shl.boundaries, tops._pad(_t(q))[0])
    assert tops.plan_degeneration_split(plan.ndist, shl.n_shards) is not None
    _assert_clustered_matches(ref, shl, q)


def test_degeneration_split_declines_when_uniform():
    ref, shl, keys, _ = _index(n_shards=8)
    b = shl.boundaries.numpy()
    inside = keys[(keys >= b[2]) & (keys < b[3])]
    q = np.resize(inside, 2 * QBLK).astype(np.int32)
    plan = tops.cluster_queries(shl.boundaries, _t(q))
    assert tops.plan_degeneration_split(plan.ndist, shl.n_shards) is None
    assert kops.plan_degeneration_split(
        np.asarray(plan.ndist.numpy()), shl.n_shards) is None
    assert tops.plan_degeneration_split(np.zeros(0, np.int32), 4) is None


@pytest.mark.parametrize("cluster", [True, False])
def test_empty_batch_answers_empty(cluster):
    """repro raises on an empty batch (a zero-size max when clustered, a
    128-lane slice of 0 lanes when dense; ROADMAP Queue 3); the port
    answers it with empty results on both paths."""
    ref, shl, _, _ = _index(n=200, n_shards=4, levels=6)
    with pytest.raises((TypeError, ValueError)):
        kops.search_kernel_sharded(ref, jnp.zeros(0, jnp.int32),
                                   cluster=cluster)
    got = tops.search_kernel_sharded(shl, torch.zeros(0, dtype=torch.int32),
                                     cluster=cluster)
    assert [t.shape for t in got] == [(0,)] * 3
    assert [t.dtype for t in got] == [torch.bool, torch.int32, torch.int32]
