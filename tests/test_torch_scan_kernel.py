"""The scan kernel's wrapper (``repro_torch.kernels.range_scan``) on the
CPU, where it runs its plain version: ``range_scan``, ``to_sorted_keys``
and ``range_scan_sharded`` against the reference's ``lax.fori_loop`` scans
bit for bit (keys, vals and count), on the cases the kernel must meet:
``max_out`` hit, ``lo`` past every key, ``hi`` at ``KEY_MAX``, a spill
across shards, across emptied shards and into the dead slots, and a fat
run straddling ``lo``; node widths 1, 8 and 128, foresight and base.  Also
the wrapper's dispatch and the arguments it hands the launcher, on meta.
The card's cases are in ``tests/test_torch_scan_kernel_gpu.py``.
"""
import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rebalance_traced as rbt
from repro.core import sharded as shd
from repro.core import skiplist as sl
from repro_torch.analysis.kernel_budget import constants
from repro_torch.convert import sharded_from_numpy, state_from_numpy
from repro_torch.core import sharded as tsh
from repro_torch.core import skiplist as tsl
from repro_torch.kernels import _build
from repro_torch.kernels import range_scan as trs

KEY_MAX = 2**31 - 1
SPAN = 1 << 16


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(SPAN, n, replace=False)).astype(np.int32)


def _cases(keys, width):
    """(lo, hi, max_out): max_out hit, the whole list, lo past every key,
    hi at KEY_MAX, lo below every key, an empty range, lo inside a run
    (fat: the run straddles it), a long range."""
    k = keys
    mid = int(k[k.size // 2])
    return [(int(k[3]), int(k[-3]), 5), (int(k[0]), int(k[-1]) + 1, k.size),
            (int(k[-1]) + 1, KEY_MAX, 8), (mid, KEY_MAX, 40),
            (-5, int(k[10]), 64), (mid, mid, 4),
            (mid + 1, mid + 3 * max(1, width), 30),
            (int(k[k.size // 3]), int(k[k.size // 3]) + 500, 200)]


def _eq(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _arrays(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()
            if v is not None}


@functools.cache
def _mono(width, foresight, n=240):
    keys = _keys(n)
    cap = 2 * n + 16 if width == 1 else 2 * n // tsl.pack_fill(width) + 16
    ref = sl.build(jnp.asarray(keys), jnp.asarray(keys * 3 + 1),
                   capacity=cap, levels=9, foresight=foresight, seed=2,
                   node_width=width)
    return keys, ref, state_from_numpy(_arrays(ref), device="cpu")


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("width", [1, 8, 128])
def test_monolithic_scans_equal_repro(width, foresight):
    keys, ref, st = _mono(width, foresight)
    for lo, hi, m in _cases(keys, width):
        _eq(tsl.range_scan(st, lo, hi, m),
            sl.range_scan(ref, jnp.int32(lo), jnp.int32(hi), m))


@pytest.mark.parametrize("width", [1, 8])
def test_to_sorted_keys_equals_repro(width):
    keys, ref, st = _mono(width, True)
    for m in (1, 40, 300):
        _eq([tsl.to_sorted_keys(st, m)], [sl.to_sorted_keys(ref, m)])


@functools.cache
def _sharded(width, foresight):
    """400 keys over 8 shards of 128 node slots, padded to 12 slots, the
    keys of shards 2 and 3 then deleted (live, empty shards)."""
    keys = _keys(400, seed=1)
    ref = rbt.pad_shards(shd.build_sharded(
        jnp.asarray(keys), jnp.asarray(keys * 5), n_shards=8, capacity=128,
        levels=8, foresight=foresight, seed=3, node_width=width), 12)
    b = np.asarray(ref.boundaries)
    gone = keys[(keys >= b[2]) & (keys < b[4])]
    ref, _ = shd.apply_ops_sharded(
        ref, jnp.full(gone.size, sl.OP_DELETE, jnp.int32), jnp.asarray(gone),
        jnp.asarray(gone))
    arrays = {f"shards.{k}": v for k, v in _arrays(ref.shards).items()}
    arrays["boundaries"] = np.asarray(ref.boundaries)
    return (np.setdiff1d(keys, gone), b, ref,
            sharded_from_numpy(arrays, device="cpu"))


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("width", [1, 8, 128])
def test_sharded_scans_spill_like_repro(width, foresight):
    keys, b, ref, shl = _sharded(width, foresight)
    cases = _cases(keys, width) + [
        (int(b[1]) + 1, int(b[6]), 200),       # across two emptied shards
        (int(b[7]), KEY_MAX, 100),              # the last live shard, then
        (int(keys[-1]), KEY_MAX, 3),            # the dead slots
        (int(b[2]), int(b[4]), 10)]             # only emptied shards
    for lo, hi, m in cases:
        got = tsh.range_scan_sharded(shl, lo, hi, m)
        _eq(got, shd.range_scan_sharded(ref, jnp.int32(lo), jnp.int32(hi),
                                        m))
        sel = keys[(keys >= lo) & (keys < hi)][:m]
        assert int(got[2]) == sel.size


def test_batch_of_scans_runs_each_through_its_plain_version():
    keys, ref, st = _mono(8, True)
    cases = _cases(keys, 8)
    lo = torch.tensor([c[0] for c in cases], dtype=torch.int32)
    hi = torch.tensor([c[1] for c in cases], dtype=torch.int32)
    k, v, c = trs.range_scan_batch(tsl._stack_of_one(st), None, lo, hi, 64)
    assert k.shape == v.shape == (len(cases), 64) and c.shape == (len(cases),)
    for i, (a, b_, _) in enumerate(cases):
        _eq((k[i], v[i], c[i]), tsl.range_scan_plain(st, a, b_, 64))


class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launcher(*args):
            self.calls.append((name, args))
            return 0
        return launcher


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("width", [1, 8])
@pytest.mark.parametrize("foresight", [True, False])
def test_launch_passes_the_declared_arity_and_widths(monkeypatch, foresight,
                                                     width, sharded):
    """On meta tensors: the wrapper's call matches
    ``_SIGNATURES["range_scan_launch"]`` argument for argument, every
    pointer a 64-bit ``c_void_p``, one launch counted, outputs shaped
    [Q, max_out] / [Q]."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: rec)
    S, L, cap, Q, m = (5 if sharded else 1), 6, 2**21, 3, 17
    meta = dict(dtype=torch.int32, device="meta")
    stack = tsl.allocate((S,), cap, L, foresight=foresight, node_width=width,
                         device="meta")
    b = torch.empty(S, **meta) if sharded else None
    before = trs.range_scan_batch.launches
    k, v, c = trs._launch(stack, b, torch.empty(Q, **meta),
                          torch.empty(Q, **meta), m, False, 0)
    assert trs.range_scan_batch.launches == before + 1
    assert k.shape == v.shape == (Q, m) and c.shape == (Q,)
    (name, args), = rec.calls
    sig = _build._SIGNATURES[name]
    assert name == "range_scan_launch" and len(args) == len(sig) == 23
    for a, t in zip(args, sig):
        if t is ctypes.c_void_p:
            assert a is None or isinstance(a, int)
        else:
            assert isinstance(a, int) and t(a).value == a
    assert list(args[14:22]) == [Q, S, L, cap, width, m, 0,
                                 trs.traversal_bound(L, cap)]
    assert (args[0] is None) != foresight and (args[1] is None) == foresight
    assert (args[4:7] == (None, None, None)) == (width == 1)
    assert (args[7] is None) != sharded
    assert args[13] is not None              # the frontiers' scratch


def test_wrapper_refuses_other_devices_and_bad_arguments():
    meta = dict(dtype=torch.int32, device="meta")
    stack = tsl.allocate((2,), 16, 4, foresight=True, device="meta")
    q = torch.empty(1, **meta)
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        trs.range_scan_batch(stack, torch.empty(2, **meta), q, q, 4)
    with pytest.raises(ValueError, match="needs its boundaries"):
        trs._launch(stack, None, q, q, 4, False, 0)
    with pytest.raises(ValueError, match="max_out"):
        trs._launch(stack, torch.empty(2, **meta), q, q, 0, False, 0)
    deep = tsl.allocate((2,), 16, 33, foresight=True, device="meta")
    with pytest.raises(ValueError, match="at most 32 levels"):
        trs._launch(deep, torch.empty(2, **meta), q, q, 4, False, 0)


def test_wrapper_mirrors_the_kernels_constants():
    """``GATHER_FROM`` (from which the wrapper allocates the gathers'
    frontiers) and ``MAX_LEVELS`` (its refusal) are the kernel's own."""
    c = constants((_build.SOURCE_DIR / "range_scan.cu").read_text())
    assert (c["kGatherFrom"], c["kMaxLevels"]) == (trs.GATHER_FROM,
                                                   trs.MAX_LEVELS)


def test_scan_bounds_wrap_to_int32_like_the_reference():
    assert int(trs.bound_lanes(2**31, "cpu")[0]) == -2**31
    assert int(trs.bound_lanes(torch.tensor(7), "cpu")[0]) == 7
