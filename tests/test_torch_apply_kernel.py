"""The update kernel's wrapper (``repro_torch.kernels.apply_ops``) on the
CPU, where it runs its plain version, against the reference's
``apply_ops`` and ``apply_ops_sharded`` bit for bit; the sharded engine's
device-tensor segment path against the host-list loop it replaced; and
the arguments the wrapper hands the launcher, on the meta device.

The card's cases (kernel against plain on seeded streams) are in
``tests/test_torch_apply_kernel_gpu.py``.
"""
import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sharded as shd
from repro.core import skiplist as sl
from repro_torch.analysis.kernel_budget import constants
from repro_torch.convert import (sharded_from_numpy, sharded_to_numpy,
                                 state_from_numpy, state_to_numpy)
from repro_torch.core import sharded as tsh
from repro_torch.core import skiplist as tsl
from repro_torch.kernels import _build
from repro_torch.kernels import apply_ops as tap

KEY_MAX = 2**31 - 1
SPAN = 1 << 12


def _np(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()
            if v is not None}


def _stream(seed, n, keys, span=SPAN, fill=0):
    """A seeded stream: ``fill`` inserts of fresh keys (to fill a small
    list), then ``n`` mixed ops of types -1 .. 3 (``lax.switch`` clamps
    them) on keys half of them present, then ``KEY_MAX``'s insert, read,
    delete and read (last: a scalar delete frees the tail's slot, which a
    later insert would reuse)."""
    rng = np.random.default_rng(seed)
    fresh = rng.choice(np.setdiff1d(np.arange(span), keys), fill,
                       replace=False)
    ops = np.concatenate([np.full(fill, 1), rng.integers(-1, 4, n),
                          [1, 0, 2, 0]]).astype(np.int32)
    ks = np.concatenate([fresh, np.where(
        rng.random(n) < 0.5, rng.choice(keys, n), rng.integers(0, span, n)),
        np.full(4, KEY_MAX)]).astype(np.int32)
    return ops, ks, (ks * 5 + 3).astype(np.int32)


def _mono_start(foresight, width):
    keys = np.sort(np.random.default_rng(1).choice(
        SPAN, 60, replace=False)).astype(np.int32)
    # few slots: the fresh inserts fill the list (allocation refused)
    cap = 80 if width == 1 else 18
    return keys, dict(capacity=cap, levels=7, foresight=foresight, seed=4,
                      node_width=width)


FILL = 40


@functools.cache
def _mono_case(foresight, width):
    """(start arrays, stream, reference's state and results), once."""
    keys, kw = _mono_start(foresight, width)
    ref = sl.build(jnp.asarray(keys), jnp.asarray(keys * 2), **kw)
    stream = _stream(7 + width, 240, keys, fill=FILL)
    out, res = sl.apply_ops(ref, *map(jnp.asarray, stream))
    return _np(ref), stream, _np(out), np.asarray(res)


def _one_shard(state):
    return tsl.SkipListState(*(None if t is None else t.unsqueeze(0)
                               for t in state))


def _seg(*lens):
    lens = torch.tensor(lens, dtype=torch.int32)
    return torch.cumsum(lens, 0).to(torch.int32) - lens, lens


@pytest.mark.parametrize("width", [1, 8])
@pytest.mark.parametrize("foresight", [True, False])
def test_monolithic_batch_equals_reference_apply_ops(foresight, width):
    start, stream, want, want_res = _mono_case(foresight, width)
    st = state_from_numpy(start, "cpu")
    ops, ks, vs = map(torch.from_numpy, stream)
    res = tap.apply_ops_batch(_one_shard(st), ops, ks, vs, *_seg(len(ks)))
    np.testing.assert_array_equal(res.numpy(), want_res)
    got = state_to_numpy(st)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # every kind of op ran to both outcomes, and fresh inserts were
    # refused for want of a slot
    clamped = np.clip(stream[0], 0, 2)
    for t in (0, 1, 2):
        assert set(res.numpy()[clamped == t]) == {0, 1}, t
    assert 0 < (res.numpy()[:FILL] == 0).sum() < FILL


def test_empty_batch_changes_nothing():
    start, *_ = _mono_case(True, 1)
    st = state_from_numpy(start, "cpu")
    e = torch.zeros(0, dtype=torch.int32)
    res = tap.apply_ops_batch(_one_shard(st), e, e, e, *_seg(0))
    assert res.shape == (0,) and res.dtype == torch.int32
    got = state_to_numpy(st)
    for k, v in start.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    st2, res2 = tsl.apply_ops(st, e, e, e)
    assert res2.shape == (0,)


@functools.cache
def _sharded_case(foresight, width, layout):
    """A stack of 4 shards and a stream routed to some of them:
    ``spread`` leaves shard 2 without ops, ``one`` gives every op to
    shard 1.  The reference's ``apply_ops_sharded`` on it, once."""
    keys = np.sort(np.random.default_rng(2).choice(
        1 << 16, 300, replace=False)).astype(np.int32)
    ref = shd.build_sharded(jnp.asarray(keys), jnp.asarray(keys * 3),
                            n_shards=4, capacity=64 if width > 1 else 256,
                            levels=8, foresight=foresight, seed=6,
                            node_width=width)
    b = np.asarray(ref.boundaries)
    ops, ks, vs = _stream(11 + width, 160, keys, span=1 << 16, fill=8)
    lo, hi = (b[1], b[2]) if layout == "one" else (b[2], b[3])
    inside = (ks >= lo) & (ks < hi)
    if layout == "one":
        ks = np.where(inside, ks, lo + ks % (hi - lo)).astype(np.int32)
    else:
        ks = np.where(inside, (ks + (hi - lo)) % (1 << 16), ks
                      ).astype(np.int32)
        ks = np.where((ks >= lo) & (ks < hi), b[3], ks).astype(np.int32)
    vs = (ks * 5 + 3).astype(np.int32)
    out, res = shd.apply_ops_sharded(ref, *map(jnp.asarray, (ops, ks, vs)))
    arrays = {f"shards.{k}": v for k, v in _np(ref.shards).items()}
    arrays["boundaries"] = b
    want = {f"shards.{k}": v for k, v in _np(out.shards).items()}
    want["boundaries"] = np.asarray(out.boundaries)
    return arrays, (ops, ks, vs), want, np.asarray(res)


def _routed(shl, ops, ks, vs):
    """The route-sorted batch and its segments, as apply_ops_sharded
    makes them."""
    sid = tsh.route(shl.boundaries, ks)
    perm = torch.argsort(sid, stable=True)
    starts, lens = tsh.shard_segments(sid[perm], shl.n_shards)
    return perm, starts, lens


@pytest.mark.parametrize("layout", ["spread", "one"])
@pytest.mark.parametrize("width", [1, 8])
@pytest.mark.parametrize("foresight", [True, False])
def test_stacked_batch_equals_reference_apply_ops_sharded(foresight, width,
                                                          layout):
    arrays, stream, want, want_res = _sharded_case(foresight, width, layout)
    shl = sharded_from_numpy(arrays, "cpu")
    ops, ks, vs = map(torch.from_numpy, stream)
    perm, starts, lens = _routed(shl, ops, ks, vs)
    if layout == "one":
        assert lens.tolist() == [0, len(ks), 0, 0]
    else:
        assert lens[2] == 0 and (lens > 0).sum() == 3
    res_sorted = tap.apply_ops_batch(shl.shards, ops[perm], ks[perm],
                                     vs[perm], starts, lens)
    res = torch.empty_like(res_sorted)
    res[perm] = res_sorted
    np.testing.assert_array_equal(res.numpy(), want_res)
    got = sharded_to_numpy(shl)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the public entry point gives the same, and leaves its input as it was
    shl0 = sharded_from_numpy(arrays, "cpu")
    out, res2 = tsh.apply_ops_sharded(shl0, ops, ks, vs)
    np.testing.assert_array_equal(res2.numpy(), want_res)
    for k, v in sharded_to_numpy(out).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    for k, v in sharded_to_numpy(shl0).items():
        np.testing.assert_array_equal(v, arrays[k], err_msg=k)


def _host_list_passes(shl, op_types, keys, vals, perm, starts, lens):
    """The segment passes as they ran before the kernel: host lists of
    the sorted ops and of the segments, one shard view at a time."""
    ops_h, keys_h, vals_h = tsl.host_ops(op_types[perm], keys[perm],
                                         vals[perm])
    shards = tsl._clone(shl.shards)
    res_sorted = [0] * keys.shape[0]
    for s, (a, ln) in enumerate(zip(starts.tolist(), lens.tolist())):
        if ln:
            res_sorted[a:a + ln] = tsl.apply_ops_inplace(
                tsh.shard_view(shards, s), ops_h[a:a + ln], keys_h[a:a + ln],
                vals_h[a:a + ln])
    results = torch.empty_like(keys)
    results[perm] = torch.tensor(res_sorted, dtype=torch.int32)
    return shl._replace(shards=shards), results


@pytest.mark.parametrize("width", [1, 8])
def test_segment_passes_on_device_tensors_equal_the_host_lists(width):
    arrays, stream, _, _ = _sharded_case(True, width, "spread")
    shl = sharded_from_numpy(arrays, "cpu")
    ops, ks, vs = map(torch.from_numpy, stream)
    perm, starts, lens = _routed(shl, ops, ks, vs)
    got, res = tsh._apply_segment_passes(shl, ops, ks, vs, perm, starts,
                                         lens)
    want, want_res = _host_list_passes(shl, ops, ks, vs, perm, starts, lens)
    np.testing.assert_array_equal(res.numpy(), want_res.numpy())
    w = sharded_to_numpy(want)
    for k, v in sharded_to_numpy(got).items():
        np.testing.assert_array_equal(v, w[k], err_msg=k)
    for k, v in sharded_to_numpy(shl).items():        # input unchanged
        np.testing.assert_array_equal(v, arrays[k], err_msg=k)


def _record(st, lvl: int, x: int):
    """Node ``x``'s level-``lvl`` record as a walk reads it: (successor,
    its key)."""
    if st.foresight:
        ptr, fk = st.fused[lvl, x].tolist()
        return ptr, fk
    ptr = int(st.nxt[lvl, x])
    return ptr, int(st.keys[ptr])


def _stands(st, p: int, lvl: int, q: int) -> bool:
    """The kernel's check: ``p`` is the head, or linked at ``lvl`` with a
    key below ``q``, and its record there foresees a key >= ``q``."""
    linked = p == tsl.HEAD or (int(st.height[p]) > lvl and
                               int(st.keys[p]) < q)
    return linked and _record(st, lvl, p)[1] >= q


def _resumed(st, preds, f: int, q: int):
    """The walk resumed at level ``f`` from the level above's predecessor
    (the head at the top) down to level 0: every level's predecessor."""
    preds = list(preds)
    x = tsl.HEAD if f == st.levels - 1 else preds[f + 1]
    for lvl in range(f, -1, -1):
        while True:
            ptr, fk = _record(st, lvl, x)
            if fk >= q:
                break
            x = ptr
        preds[lvl] = x
    return preds


def _hot_stream(seed, n, keys):
    """Runs of consecutive keys below and among the list's own, as a page
    table's grants are: mostly inserts, and reads and deletes (types -1 ..
    3), so that most of a window's ops land beside an earlier one's."""
    rng = np.random.default_rng(seed)
    ks = (int(keys[0]) - n // 2 + np.arange(n) % (n // 2 + 8)
          ).astype(np.int32)
    ops = rng.choice(np.array([-1, 0, 1, 1, 1, 1, 2, 3], np.int32), n)
    return ops, ks, (ks * 5 + 3).astype(np.int32)


@pytest.mark.parametrize("kind", ["spread", "hot"])
@pytest.mark.parametrize("width", [1, 8])
@pytest.mark.parametrize("foresight", [True, False])
def test_window_predecessors_that_pass_the_check_are_the_fresh_walks(
        foresight, width, kind):
    """The kernel's window design on the plain version: every op of a
    window of ``WINDOW`` walks on the window's start state (the eager
    ``search``); the ops then apply one at a time.  Before each, a level
    whose recorded predecessor passes the check holds the fresh walk's
    predecessor, and the walk resumed below the highest level that fails
    gives the fresh walk's every level.  ``hot``: a 3-level list and keys
    beside each other, where most ops find a level failed."""
    keys = np.sort(np.random.default_rng(width).choice(
        SPAN, 60, replace=False)).astype(np.int32)
    levels = 3 if kind == "hot" else 7
    cap = 120 if width == 1 else 24
    st = tsl.build(keys, keys * 2, capacity=cap, levels=levels,
                   foresight=foresight, seed=4, node_width=width,
                   device="cpu")
    if kind == "hot":
        stream = _hot_stream(5 + width, 96, keys)
    else:
        stream = _stream(7 + width, 120, keys, fill=8 * width)
    ops, ks, vs = (a.tolist() for a in stream)
    W, failed = tap.WINDOW, 0
    for w0 in range(0, len(ks), W):
        window = torch.tensor(ks[w0:w0 + W], dtype=torch.int32)
        recorded = tsl.search(st, window).preds.tolist()
        for j, q in enumerate(ks[w0:w0 + W]):
            fresh = tsl.search(st, torch.tensor([q], dtype=torch.int32)
                               ).preds[0].tolist()
            ok = [_stands(st, p, lvl, q) for lvl, p in
                  enumerate(recorded[j])]
            for lvl in range(levels):
                if ok[lvl]:
                    assert recorded[j][lvl] == fresh[lvl], (w0 + j, lvl)
            if not all(ok):
                failed += 1
                f = max(lvl for lvl in range(levels) if not ok[lvl])
                assert _resumed(st, recorded[j], f, q) == fresh, w0 + j
            tsl.apply_ops_inplace(st, ops[w0 + j:w0 + j + 1], [q],
                                  vs[w0 + j:w0 + j + 1])
    if kind == "hot":
        assert failed > len(ks) // 2, failed


class _Recorder:
    """A stand-in for the loaded library: records each launcher call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launcher(*args):
            self.calls.append((name, args))
            return 0
        return launcher


@pytest.mark.parametrize("width", [1, 8])
@pytest.mark.parametrize("foresight", [True, False])
def test_launch_passes_the_declared_arity_and_widths(monkeypatch, foresight,
                                                     width):
    """On meta tensors (shapes, no storage): the wrapper's call matches
    ``_SIGNATURES["apply_ops_launch"]`` argument for argument, every
    pointer declared as a 64-bit ``c_void_p``, and counts one launch."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: rec)
    S, L, cap = 3, 5, 2**21
    stack = tsl.allocate((S,), cap, L, foresight=foresight, node_width=width,
                         device="meta")
    i32 = dict(dtype=torch.int32, device="meta")
    ops = [torch.empty(10, **i32) for _ in range(3)]
    starts, lens = torch.empty(S, **i32), torch.empty(S, **i32)
    before = tap.apply_ops_batch.launches
    res = tap._launch(stack, *ops, starts, lens, 0)
    assert tap.apply_ops_batch.launches == before + 1
    assert res.shape == (10,) and res.device.type == "meta"
    (name, args), = rec.calls
    sig = _build._SIGNATURES[name]
    assert name == "apply_ops_launch" and len(args) == len(sig) == 27
    assert ctypes.sizeof(ctypes.c_void_p) == 8
    for a, t in zip(args, sig):
        if t is ctypes.c_void_p:
            assert a is None or isinstance(a, int)
        else:
            assert isinstance(a, int) and t(a).value == a   # no narrowing
    ints = [a for a, t in zip(args, sig) if t is not ctypes.c_void_p]
    assert ints == [S, L, cap, width,
                    tap.traversal_bound(L, cap)]
    # the null pointers are the other variant's table and, on the scalar
    # layout, the three fat arrays (a meta tensor's pointer is 0 too, so
    # count the pointer slots by position)
    assert sig[:21] == [ctypes.c_void_p] * 21 and sig[-1] is ctypes.c_void_p
    fat_slots = args[10:13]
    assert (fat_slots == (None, None, None)) == (width == 1)
    assert (args[0] is None) != foresight and (args[1] is None) == foresight


def test_wrapper_refuses_other_devices_and_wide_shapes():
    stack = tsl.allocate((1,), 16, 4, foresight=True, device="meta")
    e = torch.empty(0, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        tap.apply_ops_batch(stack, e, e, e, torch.empty(1, dtype=torch.int32,
                                                        device="meta"),
                            torch.empty(1, dtype=torch.int32, device="meta"))
    seg = [torch.empty(1, dtype=torch.int32, device="meta")] * 2
    deep = tsl.allocate((1,), 16, 33, foresight=True, device="meta")
    with pytest.raises(ValueError, match="at most 32 levels"):
        tap._launch(deep, e, e, e, *seg, 0)
    wide = tsl.allocate((1,), 16, 4, foresight=True, device="meta",
                        node_width=tap.MAX_WIDTH + 1)
    with pytest.raises(ValueError, match=f"node width {tap.MAX_WIDTH}"):
        tap._launch(wide, e, e, e, *seg, 0)
    # the limit is the launcher's shared memory at the kernel's window: a
    # run of MAX_WIDTH fits the default 48 KiB, one lane more does not,
    # and every configuration here (B <= 256) fits
    c = constants((_build.SOURCE_DIR / "apply_ops.cu").read_text())
    assert (c["kWindow"], c["kMaxLevels"]) == (tap.WINDOW, tap.MAX_LEVELS)
    smem = lambda b: 4 * (c["kWindow"] * (c["kPredStride"] + 6)
                          + c["kMaxLevels"] + 2 * b)
    assert smem(tap.MAX_WIDTH) <= 48 * 1024 < smem(tap.MAX_WIDTH + 1)
    assert tap.MAX_WIDTH >= 256
