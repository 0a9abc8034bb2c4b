"""Optimistic Validation, K8's plain version and the versioned index,
bit for bit against repro (its Pallas K8 in interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import skiplist as sl
from repro.core import validated as val
from repro.core.versioned import VersionedIndex
from repro.kernels.validated_traverse import validated_traverse
from repro_torch.core import skiplist as tsl
from repro_torch.core import validated as tval
from repro_torch.core.versioned import VersionedIndex as TVersionedIndex
from repro_torch.kernels import validated_traverse as tvt
from test_torch_skiplist import _keys

SPAN = 1 << 20


def _built(n, cap, levels, seed):
    keys = _keys(n, seed, span=SPAN)
    js = sl.build(jnp.asarray(keys), jnp.asarray(keys + 7), capacity=cap,
                  levels=levels, foresight=True, seed=seed)
    ts = tsl.build(keys, keys + 7, capacity=cap, levels=levels, seed=seed,
                   device="cpu")
    return js, ts, keys


def _corrupt(fused, share, rng):
    """``fused`` with a ``share`` of its foreseen keys replaced by random
    int32 values (the pointer lanes stay valid)."""
    fused = np.array(fused)
    mask = rng.random(fused[..., 1].shape) < share
    fused[..., 1] = np.where(
        mask, rng.integers(-2**31 + 1, 2**31 - 1, fused[..., 1].shape),
        fused[..., 1])
    return fused


def _queries(keys, batch, rng):
    return np.concatenate([rng.choice(keys, batch // 2),
                           rng.integers(0, SPAN, batch - batch // 2)]
                          ).astype(np.int32)


def _eq(got, want, fields=None):
    for name, g, w in zip(fields or range(len(want)), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=str(name))


@pytest.mark.parametrize("share", [0.0, 0.4, 1.0])
def test_search_validated_matches_repro(share):
    js, ts, keys = _built(800, 2048, 11, 3)
    rng = np.random.default_rng(int(share * 10))
    fused = _corrupt(js.fused, share, rng)
    q = _queries(keys, 256, rng)
    want = val.search_validated(jnp.asarray(fused), js.keys, js.vals,
                                jnp.asarray(q))
    got = tval.search_validated(torch.from_numpy(fused), ts.keys, ts.vals,
                                torch.from_numpy(q))
    _eq(got, want, want._fields)
    np.testing.assert_array_equal(got.found.numpy(), np.isin(q, keys))


@pytest.mark.parametrize("share", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("preds_from", ["search", "random"])
def test_validate_preds_matches_repro(share, preds_from):
    js, ts, keys = _built(500, 1024, 10, 4)
    rng = np.random.default_rng(5)
    fused = _corrupt(js.fused, share, rng)
    q = _queries(keys, 128, rng)
    if preds_from == "search":
        preds = np.array(val.search_validated(
            jnp.asarray(fused), js.keys, js.vals, jnp.asarray(q)).preds)
    else:                                   # mostly violations
        preds = rng.integers(0, 1024, (128, 10)).astype(np.int32)
    heights = rng.integers(0, 11, 128).astype(np.int32)
    want = val.validate_preds(jnp.asarray(fused), js.keys,
                              jnp.asarray(preds), jnp.asarray(heights),
                              jnp.asarray(q))
    got = tval.validate_preds(torch.from_numpy(fused), ts.keys,
                              torch.from_numpy(preds),
                              torch.from_numpy(heights), torch.from_numpy(q))
    _eq(got, want, want._fields)
    assert got.bad_level.dtype == torch.int32
    # A clean search's preds are tight; corrupt foreseen keys make it
    # descend early (which this flags), and random preds mostly fail.
    if share == 0.0 and preds_from == "search":
        assert bool(got.ok.all())
    else:
        assert not bool(got.ok.all())


def _pallas_k8(fused, auth, q, max_steps=0):
    """repro's K8 on queries padded to its 128-lane block."""
    B = q.shape[0]
    pad = -B % 128
    qp = np.concatenate([q, np.zeros(pad, np.int32)])
    node, key = validated_traverse(jnp.asarray(fused), jnp.asarray(auth),
                                   jnp.asarray(qp), max_steps=max_steps)
    return np.asarray(node)[:B], np.asarray(key)[:B]


def _lag1_view(seed):
    """(stale fused, current keys, current vals, stale keys) after one
    update batch with deletes, through repro's VersionedIndex."""
    js, _, keys = _built(300, 1024, 10, seed)
    vi = VersionedIndex(js)
    rng = np.random.default_rng(seed)
    ops = rng.choice(np.array([1, 2], np.int32), 120)
    ks = np.where(ops == 2, rng.choice(keys, 120),
                  rng.integers(0, SPAN, 120)).astype(np.int32)
    vi.update(jnp.asarray(ops), jnp.asarray(ks), jnp.asarray(ks + 7))
    view = vi.read_view(lag=1)
    return (np.array(view.fused), np.array(view.auth_keys),
            np.array(view.vals), keys)


@pytest.mark.parametrize("table", ["clean", "corrupt", "lag1"])
@pytest.mark.parametrize("max_steps", [0, 9])
def test_plain_k8_matches_pallas(table, max_steps):
    rng = np.random.default_rng(6)
    if table == "lag1":
        fused, auth, _, keys = _lag1_view(8)
    else:
        js, _, keys = _built(500, 1024, 10, 7)
        fused = _corrupt(js.fused, 0.4 if table == "corrupt" else 0.0, rng)
        auth = np.array(js.keys)
    q = _queries(keys, 200, rng)
    got = tvt.validated_traverse(torch.from_numpy(fused),
                                 torch.from_numpy(auth), torch.from_numpy(q),
                                 max_steps=max_steps)
    _eq(got, _pallas_k8(fused, auth, q, max_steps))
    _eq(tvt.validated_traverse_plain(torch.from_numpy(fused),
                                     torch.from_numpy(auth),
                                     torch.from_numpy(q),
                                     max_steps=max_steps), got)


def test_k8_step_cap_is_the_references():
    assert tvt.default_max_steps(27) == 124
    fused, auth, _, keys = _lag1_view(9)
    q = _queries(keys, 128, np.random.default_rng(1))
    args = [torch.from_numpy(a) for a in (fused, auth, q)]
    _eq(tvt.validated_traverse(*args),
        tvt.validated_traverse(*args, max_steps=4 * 10 + 16))


def _two_batches(seed):
    """repro's and the port's VersionedIndex after the same two batches."""
    js, ts, keys = _built(300, 1024, 10, seed)
    jvi, tvi = VersionedIndex(js, history=4), TVersionedIndex(ts, history=4)
    rng = np.random.default_rng(seed)
    for _ in range(2):
        ops = rng.choice(np.array([0, 1, 2], np.int32), 80)
        ks = np.where(ops == 2, rng.choice(keys, 80),
                      rng.integers(0, SPAN, 80)).astype(np.int32)
        jr = jvi.update(jnp.asarray(ops), jnp.asarray(ks),
                        jnp.asarray(ks + 1))
        tr = tvi.update(torch.from_numpy(ops), torch.from_numpy(ks),
                        torch.from_numpy(ks + 1))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert tvi.version == jvi.version == 2
    return jvi, tvi, keys, rng


@pytest.mark.parametrize("lag", [0, 1, 2])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_versioned_search_matches_repro(lag, use_kernel):
    jvi, tvi, keys, rng = _two_batches(11)
    q = _queries(keys, 160, rng)
    jview, tview = jvi.read_view(lag), tvi.read_view(lag)
    assert tview.mixed == jview.mixed == (lag > 0)
    for f in ("fused", "auth_keys", "vals"):
        np.testing.assert_array_equal(getattr(tview, f).numpy(),
                                      np.asarray(getattr(jview, f)))
    want = jvi.search(jnp.asarray(q), lag=lag, use_kernel=use_kernel)
    got = tvi.search(torch.from_numpy(q), lag=lag, use_kernel=use_kernel)
    _eq(got, want, want._fields)
    for name, t in zip(got._fields, got):
        assert t.dtype == getattr(torch, str(np.asarray(getattr(
            want, name)).dtype)), name


def test_versioned_insert_only_lag1_is_stale_membership():
    """Stale pointers cannot reach fresh nodes: after an insert-only batch a
    lag-1 read answers for the stale key set, and a lag-0 read for the
    current one (tests/test_properties.py's contract)."""
    _, ts, keys = _built(64, 256, 10, 12)
    vi = TVersionedIndex(ts)
    rng = np.random.default_rng(12)
    newk = rng.choice(SPAN, 16, replace=False).astype(np.int32)
    vi.update(torch.ones(16, dtype=torch.int32), torch.from_numpy(newk),
              torch.from_numpy(newk * 2))
    q = np.concatenate([newk, _queries(keys, 64, rng)])
    for use_kernel in (False, True):
        res = vi.search(torch.from_numpy(q), lag=1, use_kernel=use_kernel)
        np.testing.assert_array_equal(res.found.numpy(), np.isin(q, keys))
    cur = np.union1d(keys, newk)
    np.testing.assert_array_equal(
        vi.search(torch.from_numpy(q)).found.numpy(), np.isin(q, cur))


def test_versioned_history_and_publish_match_repro():
    js, ts, keys = _built(50, 128, 6, 13)
    jvi, tvi = VersionedIndex(js, history=3), TVersionedIndex(ts, history=3)
    q = _queries(keys, 32, np.random.default_rng(2))
    for i in range(5):
        ops = np.full(4, 1, np.int32)
        ks = np.arange(4, dtype=np.int32) + 1000 * (i + 1)
        jvi.update(jnp.asarray(ops), jnp.asarray(ks), jnp.asarray(ks))
        tvi.update(torch.from_numpy(ops), torch.from_numpy(ks),
                   torch.from_numpy(ks))
    assert tvi.version == jvi.version == 5
    for lag in (1, 2, 3, 9):                 # lag clamps to the history
        np.testing.assert_array_equal(
            tvi.read_view(lag).fused.numpy(),
            np.asarray(jvi.read_view(lag).fused))
        got = tvi.search(torch.from_numpy(q), lag=lag)
        want = jvi.search(jnp.asarray(q), lag=lag)
        _eq(got, want, want._fields)


def test_update_keeps_the_published_version_intact():
    """A lag-1 read must see the old fused table: the update may not write
    into the state it started from."""
    _, ts, keys = _built(300, 1024, 10, 14)
    before = ts.fused.clone(), ts.keys.clone()
    vi = TVersionedIndex(ts)
    ops = np.array([1, 2, 1, 2] * 10, np.int32)
    ks = np.where(ops == 2, keys[:40], np.arange(40) + 5).astype(np.int32)
    vi.update(torch.from_numpy(ops), torch.from_numpy(ks),
              torch.from_numpy(ks))
    view = vi.read_view(lag=1)
    assert view.fused is ts.fused
    assert torch.equal(ts.fused, before[0]) and torch.equal(ts.keys, before[1])
    assert not torch.equal(vi.current.fused, ts.fused)


def test_versioned_index_refuses_base_states():
    _, ts, _ = _built(10, 32, 4, 15)
    base = tsl.build(_keys(10, 15, span=SPAN), _keys(10, 15, span=SPAN),
                     capacity=32, levels=4, foresight=False, device="cpu")
    TVersionedIndex(ts)
    with pytest.raises(ValueError, match="foresight"):
        TVersionedIndex(base)


def test_cpu_validated_reads_launch_no_kernel():
    jvi, tvi, keys, rng = _two_batches(16)
    before = tvt.validated_traverse.launches
    tvi.search(torch.from_numpy(_queries(keys, 64, rng)), lag=1,
               use_kernel=True)
    assert tvt.validated_traverse.launches == before
