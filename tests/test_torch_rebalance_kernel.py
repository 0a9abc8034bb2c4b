"""The rebalance kernel's wrapper (``repro_torch.kernels.rebalance``) on the
CPU, where it runs its plain version: the rebalancing apply's new order
(one clone, the guard on it, routing on the boundaries the guard left, the
update kernel, the watermark pass on the same clone) against the jitted
``repro.core.sharded.apply_ops_sharded(rebalance=True)`` bit for bit; the
wrapper's dispatch; and the arguments it hands the launcher, on meta.

Streams on a padded state at its ceiling: tests/test_rebalance.py:220's
Zipf inserts on 48 keys (splits), then deletes (merges), a ceiling with one
dead slot (the slots run out), and the guard on a slot whose count
outruns its keys (the median at the minimum, an indivisible key mass).
Node widths 1, 8 and 128, foresight and base; every state array (``rng``
and the boundaries included), every result and every count equal, and the
input state unchanged.  The card's cases are in
``tests/test_torch_rebalance_kernel_gpu.py``.
"""
import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rebalance_traced as rbt
from repro.core import sharded as shd
from repro.core import skiplist as rsl
from repro_torch.analysis.kernel_budget import constants
from repro_torch.convert import sharded_from_numpy, sharded_to_numpy
from repro_torch.core import rebalance_traced as trbt
from repro_torch.core import sharded as tsh
from repro_torch.core import skiplist as tsl
from repro_torch.kernels import _build
from repro_torch.kernels import rebalance as trk
from test_torch_rebalance import _assert_same

SPAN = 1 << 22
_APPLY = jax.jit(functools.partial(shd.apply_ops_sharded, rebalance=True))
_GUARD = jax.jit(rbt.exhaustion_guard_traced)



@functools.cache
def _start(width, foresight, ceiling):
    """(keys, the reference's padded start as numpy arrays): 48 keys a
    fill unit over 4 shards of 16 node slots, 12 of 14 full."""
    fill = tsl.pack_fill(width)
    keys = np.sort(np.random.default_rng(0).choice(
        SPAN, 48 * fill, replace=False)).astype(np.int32)
    ref = rbt.pad_shards(shd.build_sharded(
        jnp.asarray(keys), jnp.asarray(keys * 3), n_shards=4, capacity=16,
        levels=8, foresight=foresight, seed=0, node_width=width), ceiling)
    return keys, _ref_arrays(ref)


def _ref_arrays(ref):
    out = {f"shards.{k}": np.asarray(v)
           for k, v in ref.shards._asdict().items() if v is not None}
    out["boundaries"] = np.asarray(ref.boundaries)
    return out


def _ref_from(arrays):
    """The reference's state from numpy arrays."""
    fields = {k.split(".", 1)[1]: jnp.asarray(v) for k, v in arrays.items()
              if k.startswith("shards.")}
    return shd.ShardedSkipList(
        shards=rsl.SkipListState(**{f: fields.get(f)
                                    for f in rsl.SkipListState._fields}),
        boundaries=jnp.asarray(arrays["boundaries"]))


def _streams(keys, width, n_insert):
    """Batches of one size: Zipf(1.2) inserts into shard 0's range, then
    the start keys deleted (the last batch topped up with reads)."""
    fill = tsl.pack_fill(width)
    B = 32 * fill
    rng = np.random.default_rng(7)
    hot = int(keys[2])
    out = [(np.full(B, tsl.OP_INSERT, np.int32),
            (hot + (rng.zipf(1.2, B) - 1) % (4096 * fill)).astype(np.int32))
           for _ in range(n_insert)]
    for part in (keys[:B], keys[B:]):
        ops = np.full(B, tsl.OP_READ, np.int32)
        ops[:part.size] = tsl.OP_DELETE
        kk = np.concatenate([part, keys[:B - part.size]]).astype(np.int32)
        out.append((ops, kk))
    return out


def _run_stream(width, foresight, ceiling, n_insert):
    keys, arrays = _start(width, foresight, ceiling)
    ref = _ref_from(arrays)
    shl = sharded_from_numpy(arrays, device="cpu")
    _assert_same(shl, ref)
    counts = []
    for b, (ops, kk) in enumerate(_streams(keys, width, n_insert)):
        ref, res_r = _APPLY(ref, jnp.asarray(ops), jnp.asarray(kk),
                            jnp.asarray(kk * 2), seed=jnp.int32(b))
        before = sharded_to_numpy(shl)
        out, res = tsh.apply_ops_sharded(shl, ops, kk, kk * 2,
                                         rebalance=True, seed=b,
                                         _in_place=True)
        for k, v in sharded_to_numpy(shl).items():   # the input unchanged
            np.testing.assert_array_equal(v, before[k], err_msg=k)
        np.testing.assert_array_equal(res.numpy(), np.asarray(res_r))
        _assert_same(out, ref)
        shl = out
        counts.append(int(trbt.live_shard_count(shl)))
    return counts, res.numpy()


@pytest.mark.parametrize("foresight", [True, False])
@pytest.mark.parametrize("width", [1, 8, 128])
def test_split_then_merge_stream_equals_jitted_repro(width, foresight):
    counts, _ = _run_stream(width, foresight, 16,
                            n_insert=2 if width == 128 else 3)
    assert max(counts) > 4, "the stream split no shard"
    assert counts[-1] < max(counts), "the deletes merged no shard"


@pytest.mark.parametrize("width", [1, 8])
def test_dead_slots_run_out_like_jitted_repro(width):
    counts, res = _run_stream(width, True, 5, n_insert=3)
    assert max(counts) == 5


@pytest.mark.parametrize("case", ["dead", "live"])
@pytest.mark.parametrize("width", [1, 8])
def test_guard_median_at_minimum_and_indivisible_mass_equal_repro(width,
                                                                  case):
    """A slot whose count outruns its keys overflows its projection: a
    dead slot (no key: the median is the minimum, KEY_MAX, and so is the
    next larger key) or a live shard with one incoming key (the median
    lies past its keys).  The key mass is indivisible and the guard stops
    without a split, as the reference's does."""
    keys, arrays = _start(width, True, 16)
    arrays = {k: v.copy() for k, v in arrays.items()}
    usable = tsl.usable_capacity(16, width)
    if case == "dead":
        s, kk, op = 15, keys[:1], tsl.OP_READ
    else:
        kk = np.asarray([int(keys[-1]) + 7], np.int32)
        s = int(np.searchsorted(arrays["boundaries"], kk[0], "right")) - 1
        op = tsl.OP_INSERT
    # the median's index stays inside the reference's combined array
    arrays["shards.n"][s] = 2 * usable - (op == tsl.OP_INSERT)
    ops = np.full(1, op, np.int32)
    ref, splits_r = _GUARD(_ref_from(arrays), jnp.asarray(ops),
                           jnp.asarray(kk), seed=jnp.int32(1))
    shl = sharded_from_numpy(arrays, device="cpu")
    out, splits = trbt.exhaustion_guard_traced(shl, ops, kk, seed=1)
    _assert_same(out, ref)
    assert int(splits) == int(splits_r) == 0
    assert splits.dtype == torch.int32 and splits.dim() == 0


def test_plain_pass_runs_in_place_and_returns_its_counts():
    keys, arrays = _start(1, True, 16)
    shl = sharded_from_numpy(arrays, device="cpu")
    ops = np.full(64, tsl.OP_INSERT, np.int32)
    kk = (int(keys[2]) + np.arange(64) * 3 + 1).astype(np.int32)
    shl, _ = tsh.apply_ops_sharded(shl, ops, kk, kk, _in_place=True)
    want, stats = trbt.watermark_rebalance_traced(shl, seed=4)
    work = trbt.working_copy(shl)
    counts = trk.rebalance_pass(work, "watermark", seed=4)
    assert counts.dtype == torch.int32 and counts.shape == (2,)
    assert counts.tolist() == [int(stats.splits), int(stats.merges)]
    assert counts[0] > 0
    for k, v in sharded_to_numpy(want).items():
        np.testing.assert_array_equal(sharded_to_numpy(work)[k], v,
                                      err_msg=k)
    assert trbt.live_shard_count(shl).dtype == torch.int32


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("width", [1, 8])
@pytest.mark.parametrize("foresight", [True, False])
def test_build_reads_nothing_back_on_meta_tensors(foresight, width, valid):
    """The bulk build links its levels without a host read (the plain
    rebuilds of the rebalance passes run it): on ``meta`` tensors, where
    any data-dependent read raises, a list and a stack build."""
    with pytest.raises((RuntimeError, NotImplementedError)):
        int(torch.zeros((), dtype=torch.int32, device="meta"))
    keys = np.arange(0, 400, 3, dtype=np.int32)
    v = (np.arange(keys.size) < 100) if valid else None
    st = tsl.build(keys, keys * 2, capacity=512, levels=7,
                   foresight=foresight, seed=3, valid=v, node_width=width,
                   device="meta")
    assert st.keys.device.type == "meta" and st.n.shape == ()
    shl = tsh.build_sharded(keys, keys * 2, n_shards=4, levels=6,
                            foresight=foresight, seed=1, valid=v,
                            node_width=width, device="meta")
    assert shl.shards.keys.device.type == "meta"


class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launcher(*args):
            self.calls.append((name, args))
            return 0
        return launcher


@pytest.mark.parametrize("mode", ["watermark", "guard", "split", "merge"])
@pytest.mark.parametrize("width", [1, 8])
@pytest.mark.parametrize("foresight", [True, False])
def test_launch_passes_the_declared_arity_and_widths(monkeypatch, foresight,
                                                     width, mode):
    """On meta tensors: the wrapper's call matches
    ``_SIGNATURES["rebalance_launch"]`` argument for argument, every
    pointer a 64-bit ``c_void_p``, the float marks exact, one launch
    counted, and the counts [2] returned on the state's device."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: rec)
    S, L, cap = 6, 5, 2**20
    meta = dict(dtype=torch.int32, device="meta")
    stack = tsl.allocate((S,), cap, L, foresight=foresight, node_width=width,
                         device="meta")
    shl = tsh.ShardedSkipList(stack, torch.empty(S, **meta))
    guard = ((torch.empty(40, **meta), torch.empty(41, **meta),
              torch.empty(41, **meta)) if mode == "guard" else None)
    given = (torch.empty(2, **meta) if mode in ("split", "merge")
             else None)
    before = trk.rebalance_pass.launches
    counts = trk._launch(shl, mode, guard, given, high_water=0.8,
                         low_water=0.3, max_shards=4, seed=2**33 + 5,
                         stream=0)
    assert trk.rebalance_pass.launches == before + 1
    assert counts.shape == (2,) and counts.device.type == "meta"
    (name, args), = rec.calls
    sig = _build._SIGNATURES[name]
    assert name == "rebalance_launch" and len(args) == len(sig) == 39
    for a, t in zip(args, sig):
        if t is ctypes.c_void_p:
            assert a is None or isinstance(a, int)
        elif t is ctypes.c_float:
            assert t(a).value == a                    # a float32 already
        else:
            assert isinstance(a, int) and t(a).value == a
    usable = tsl.usable_capacity(cap, width)
    hi, lo = trk.marks(usable, 0.8, 0.3)
    assert list(args[26:38]) == [
        trk.MODES[mode], S, L, cap, width, 40 if guard else 0, usable, 4,
        hi, lo, 5, trk.traversal_bound(L, cap)]
    assert (args[0] is None) != foresight and (args[1] is None) == foresight
    assert (args[10:13] == (None, None, None)) == (width == 1)
    assert (args[14] is None) == (guard is None)
    assert (args[17] is None) == (given is None)
    front, sums, ctrl = trk._scratch(stack.keys.device, cap, L, width)[3:6]
    assert args[22] is not None and args[23] is not None
    assert front.shape == (cap + 1,) and front.dtype == torch.int32
    assert sums.shape == (trk.GRID_BLOCKS,) and sums.dtype == torch.int64
    assert ctrl.shape == (trk.CTRL,) and trk.STAMPS % 2 == 0
    assert trk.CTRL == trk.STAMPS + 2 * (len(trk.PHASES) + 1)


def test_wrapper_mirrors_the_kernels_constants():
    """The wrapper's scratch sizes and refusal use the kernel's own
    ``kChunk``, ``kMaxGridBlocks`` and ``kMaxLevels``."""
    c = constants((_build.SOURCE_DIR / "rebalance.cu").read_text())
    assert (c["kChunk"], c["kMaxGridBlocks"], c["kMaxLevels"]) == (
        trk.CHUNK, trk.GRID_BLOCKS, trk.MAX_LEVELS)


def test_last_phases_reads_the_stamps_of_the_states_shape():
    """``last_phases`` turns the control record's int64 ns stamps (the
    first trip's start, then each phase's end) into ms a phase, from the
    scratch of the state's own shape."""
    keys, arrays = _start(1, True, 16)
    shl = sharded_from_numpy(arrays, device="cpu")
    st = shl.shards
    ctrl = trk._scratch(torch.device("cpu"), st.keys.shape[1],
                        st.fused.shape[1], st.node_width)[5]
    ns = torch.tensor([10**9 + 7 * 10**6 * i * i
                       for i in range(len(trk.PHASES) + 1)])
    ctrl[trk.STAMPS:] = ns.view(torch.int32)
    got = trk.last_phases(shl)
    assert list(got) == list(trk.PHASES)
    assert list(got.values()) == [7.0 * (2 * i + 1)
                                  for i in range(len(trk.PHASES))]
    ctrl.zero_()
    assert set(trk.last_phases(shl).values()) == {0.0}


def test_wrapper_refuses_other_devices_and_deep_stacks():
    meta = dict(dtype=torch.int32, device="meta")
    stack = tsl.allocate((2,), 16, 4, foresight=True, device="meta")
    shl = tsh.ShardedSkipList(stack, torch.empty(2, **meta))
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        trk.rebalance_pass(shl, "watermark")
    deep = tsh.ShardedSkipList(
        tsl.allocate((2,), 16, 33, foresight=True, device="meta"),
        torch.empty(2, **meta))
    with pytest.raises(ValueError, match="at most 32 levels"):
        trk._launch(deep, "watermark", None, None, high_water=0.75,
                    low_water=0.25, max_shards=0, seed=0, stream=0)
    with pytest.raises(ValueError, match="unknown mode"):
        trk.rebalance_pass_plain(
            trbt.working_copy(tsh.empty_sharded(
                n_shards=2, capacity=8, levels=2, device="cpu")),
            "spread", high_water=0.75, low_water=0.25, max_shards=0, seed=0)
