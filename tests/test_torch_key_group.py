"""The key-range grouping of K1, K2 and K8, held to numpy and repro on the
CPU.

``group_by_key_plain`` (``repro_torch.kernels.shard_group``) orders a
monolithic batch's lanes by key bucket exactly as numpy's stable argsort of
the same bucket ids does, and each bucket is one key range.  Walking the
grouped lanes with the plain K2 / K8 and storing each result at its lane's
batch index gives the batch-order walk and the reference's Pallas kernel
(``repro.kernels.foresight_traverse.foresight_traverse`` /
``base_traverse``,
``repro.kernels.validated_traverse.validated_traverse``, interpret mode),
bit for bit, lanes cut off at the step cap included.  The CUDA pass itself
is held to this plain version on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import skiplist as sl
from repro.kernels.foresight_traverse import base_traverse, foresight_traverse
from repro_torch.core import skiplist as tsl
from repro_torch.kernels import foresight_traverse as tft
from repro_torch.kernels import shard_group as tsg
from repro_torch.kernels import validated_traverse as tvt
from test_torch_validated import (_built, _corrupt, _lag1_view, _pallas_k8,
                                  _queries)

KEY_MIN, KEY_MAX = -2**31, 2**31 - 1
SPAN = 1 << 22


def _np_buckets(q):
    """Each lane's bucket in numpy: the query as uint32 less the least,
    shifted right until at most 2^13 buckets are left."""
    u = q.astype(np.int64) + 2**31
    shift = max(0, int(u.max() - u.min()).bit_length() - 13)
    return (u - u.min()) >> shift


def _lanes(traffic, batch, seed):
    rng = np.random.default_rng(seed)
    if traffic == "uniform":
        q = rng.integers(0, 1 << 26, batch)
    elif traffic == "zipf":                       # benchmarks/common.py:55-60
        keys = np.sort(rng.choice(1 << 26, 4096, replace=False))
        q = keys[(rng.zipf(1.2, batch) - 1) % len(keys)]
    elif traffic == "all_equal":
        q = np.full(batch, 777)
    elif traffic == "negative":
        q = rng.integers(KEY_MIN + 1, 0, batch)
    else:                                         # both ends of int32
        q = rng.integers(KEY_MIN, KEY_MAX, batch, endpoint=True)
        q[::3], q[1::3] = KEY_MIN, KEY_MAX
    return q.astype(np.int32)


@pytest.mark.parametrize("batch", [1, 2047, 2048, 2049])
@pytest.mark.parametrize("traffic", ["uniform", "zipf", "all_equal",
                                     "negative", "extremes"])
def test_key_grouping_is_a_stable_argsort_of_key_ranges(traffic, batch):
    q = _lanes(traffic, batch, batch)
    b = _np_buckets(q)
    assert b.max() < tsg.MAX_KEY_BUCKETS
    qt = torch.from_numpy(q)
    np.testing.assert_array_equal(tsg.key_buckets(qt).numpy(), b)
    perm = tsg.group_by_key_plain(qt)
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), np.argsort(b, kind="stable"))
    before = tsg.group_by_key.launches
    q_s, perm_w = tsg.group_by_key(qt)
    assert tsg.group_by_key.launches == before       # the CPU launches none
    assert torch.equal(perm_w, perm) and torch.equal(q_s, qt[perm.long()])
    # Each bucket is one key range: buckets rise along the grouped lanes,
    # and a bucket's greatest key is below the next bucket's least.
    bs, qs = b[perm.numpy()], q_s.numpy()
    assert (np.diff(bs) >= 0).all()
    starts = np.flatnonzero(np.r_[True, np.diff(bs) > 0])
    lo, hi = np.minimum.reduceat(qs, starts), np.maximum.reduceat(qs, starts)
    assert (hi[:-1] < lo[1:]).all()


@pytest.mark.parametrize("span", [0, 1, 8191, 8192, 1 << 26, 2**32 - 1])
def test_key_buckets_take_the_least_shift(span):
    q = torch.tensor([KEY_MIN, KEY_MIN + span // 2, KEY_MIN + span],
                     dtype=torch.int64).to(torch.int32)
    b = tsg.key_buckets(q)
    assert b.tolist() == sorted(b.tolist()) and b[0] == 0
    assert int(b[-1]) < tsg.MAX_KEY_BUCKETS
    shift = max(0, span.bit_length() - 13)
    assert int(b[-1]) == span >> shift
    if shift:                                     # one less would overflow
        assert span >> (shift - 1) >= tsg.MAX_KEY_BUCKETS


def _scattered_back(walk, q):
    """``walk`` on the lanes grouped by key, each result stored at its
    lane's batch index."""
    q_s, perm = tsg.group_by_key(q)
    got = walk(q_s)
    out = [torch.empty_like(q) for _ in got]
    for o, g in zip(out, got):
        o[perm.long()] = g
    return out


def _padded(fn, q):
    """repro's kernel on queries padded to its 128-lane block."""
    qp = np.concatenate([q, np.zeros(-len(q) % 128, np.int32)])
    return [np.asarray(t)[:len(q)] for t in fn(jnp.asarray(qp))]


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("max_steps", [0, 9])
@pytest.mark.parametrize("traffic", ["half_hit", "zipf", "all_equal"])
def test_grouped_k2_scattered_back_equals_batch_order_and_repro(traffic,
                                                                max_steps,
                                                                foresight):
    """K2 (``foresight=False``) and K1 (``True``) on grouped lanes."""
    rng = np.random.default_rng(11)
    keys = np.sort(rng.choice(SPAN, 1000, replace=False)).astype(np.int32)
    js = sl.build(jnp.asarray(keys), jnp.asarray(keys + 1), capacity=2048,
                  levels=12, foresight=foresight, seed=11)
    ts = tsl.build(keys, keys + 1, capacity=2048, levels=12,
                   foresight=foresight, seed=11, device="cpu")
    if traffic == "half_hit":
        q = np.concatenate([rng.choice(keys, 150), rng.integers(0, SPAN, 150)])
    elif traffic == "zipf":
        q = keys[(rng.zipf(1.2, 300) - 1) % len(keys)]
    else:
        q = np.full(300, keys[500])
    q = q.astype(np.int32)
    if foresight:
        plain = lambda qs: tft.foresight_traverse_plain(  # noqa: E731
            ts.fused, qs, max_steps=max_steps)
        wrapper = tft.foresight_traverse(ts.fused, torch.from_numpy(q),
                                         max_steps=max_steps)
        ref = _padded(lambda qp: foresight_traverse(
            js.fused, qp, max_steps=max_steps), q)
    else:
        plain = lambda qs: tft.base_traverse_plain(  # noqa: E731
            ts.nxt, ts.keys, qs, max_steps=max_steps)
        wrapper = tft.base_traverse(ts.nxt, ts.keys, torch.from_numpy(q),
                                    max_steps=max_steps)
        ref = _padded(lambda qp: base_traverse(js.nxt, js.keys, qp,
                                               max_steps=max_steps), q)
    got = _scattered_back(plain, torch.from_numpy(q))
    _eq(got, wrapper)
    _eq(got, ref)


@pytest.mark.parametrize("max_steps", [0, 9])
@pytest.mark.parametrize("table", ["clean", "corrupt", "lag1"])
def test_grouped_k8_scattered_back_equals_batch_order_and_repro(table,
                                                                max_steps):
    rng = np.random.default_rng(12)
    if table == "lag1":
        fused, auth, _, keys = _lag1_view(13)
    else:
        js, _, keys = _built(500, 1024, 10, 14)
        fused = _corrupt(js.fused, 0.4 if table == "corrupt" else 0.0, rng)
        auth = np.array(js.keys)
    q = _queries(keys, 300, rng)
    ft_, at_ = torch.from_numpy(fused), torch.from_numpy(auth)
    got = _scattered_back(lambda qs: tvt.validated_traverse_plain(
        ft_, at_, qs, max_steps=max_steps), torch.from_numpy(q))
    _eq(got, tvt.validated_traverse(ft_, at_, torch.from_numpy(q),
                                    max_steps=max_steps))
    _eq(got, _pallas_k8(fused, auth, q, max_steps))
