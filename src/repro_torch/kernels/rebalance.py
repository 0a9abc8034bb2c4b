"""In-place shard rebalancing: a hand-written CUDA kernel and its plain
version.

The device counterpart of the reference's traced rebalancing
(``repro.core.rebalance_traced``: ``lax.while_loop`` / ``lax.cond`` over
``split_shard_traced`` and ``merge_shards_traced``); there is no Pallas
kernel behind it.

``rebalance_pass(shl, mode, ...)`` runs one pass in place on the working
copy ``shl`` (a stacked state at its static ceiling, boundaries included)
and returns ``counts [2]`` int32, the splits and merges it made:

* ``"watermark"``: split above ``high_water`` while dead slots remain,
  then merge under it (``watermark_rebalance_traced``);
* ``"guard"``: split ahead of the shards the batch ``op_types, keys``
  would overfill (``exhaustion_guard_traced``);
* ``"split"`` / ``"merge"``: one split at ``(s, at)`` or merge at ``s``.

On CUDA tensors it launches ``csrc/rebalance.cu`` (one cooperative launch
a pass; the guard's presence search is one dense K3/K4 launch before it)
and counts the launch in ``rebalance_pass.launches``: nothing is read back
to the host, and the counts stay on the card.  On CPU tensors it runs
``rebalance_pass_plain``, the host loops of ``core.rebalance_traced``,
and copies their result into ``shl``.  Any other device raises.  A failed
build or launch raises: there is no fallback.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import skiplist as sl
from repro_torch.kernels import _build
from repro_torch.kernels.foresight_traverse import traversal_bound

MODES = {"watermark": 0, "guard": 1, "split": 2, "merge": 3}
MAX_LEVELS = 32          # kMaxLevels: a chunk's per-level cursor
CHUNK = 64               # kChunk: the positions a thread links
CTRL = 26                # kCtrlSize: the control record's ints

_SCRATCH: Dict[tuple, Tuple[torch.Tensor, ...]] = {}
_REF_CTZ: Dict[torch.device, torch.Tensor] = {}


def marks(usable: int, high_water: float, low_water: float
          ) -> Tuple[float, float]:
    """The watermarks as the float32 values the passes compare against."""
    hi = np.float32(high_water * usable)
    lo = np.float32(low_water * usable)
    return float(hi), float(lo)  # trace-ok: Python floats, no tensor


def ceiling(n_shards: int, max_shards: int) -> int:
    """The live-shard ceiling: the axis, or ``max_shards`` if smaller."""
    cap = int(max_shards)  # trace-ok: a static Python knob
    return min(cap, n_shards) if cap else n_shards


def rebalance_pass(shl, mode: str, *, high_water: float = 0.75,
                   low_water: float = 0.25, max_shards: int = 0, seed=0,
                   op_types: Optional[torch.Tensor] = None,
                   keys: Optional[torch.Tensor] = None, s=None, at=None
                   ) -> torch.Tensor:
    """Run pass ``mode`` on ``shl`` in place; (splits, merges) [2] int32."""
    if shl.boundaries.device.type == "cpu":
        return rebalance_pass_plain(shl, mode, high_water=high_water,
                                    low_water=low_water,
                                    max_shards=max_shards, seed=seed,
                                    op_types=op_types, keys=keys, s=s, at=at)
    dev = shl.boundaries.device
    if dev.type != "cuda":
        raise ValueError(f"rebalance_pass: tensors on {dev}; the kernel "
                         "runs on CUDA and the plain version on the CPU")
    guard = None
    if mode == "guard":
        guard = guard_inputs(shl, op_types, keys)
    given = None
    if mode in ("split", "merge"):
        given = torch.stack([_i32(s, dev), _i32(0 if at is None else at,
                                                dev)])
    return _launch(shl, mode, guard, given, high_water=high_water,
                   low_water=low_water, max_shards=max_shards, seed=seed,
                   stream=torch.cuda.current_stream(dev).cuda_stream)


rebalance_pass.launches = 0


def _i32(v, dev) -> torch.Tensor:
    """A 0-d int32 on ``dev``: a tensor moved there, a Python int wrapped
    as the int32 the reference casts it to."""
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=torch.int32).reshape(())
    v = int(np.int64(v).astype(np.int32))  # trace-ok: a Python int here
    return torch.tensor(v, dtype=torch.int32, device=dev)


def guard_inputs(shl, op_types, keys) -> Tuple[torch.Tensor, ...]:
    """(k_sorted, pdist, pnew): the batch's insert keys sorted (the rest
    ``KEY_MAX``) and the prefix counts of the distinct ones and of the new
    ones (distinct and absent: one dense K3/K4 search), on the card."""
    from repro_torch.kernels import ops

    dev = shl.boundaries.device
    op_types = torch.as_tensor(op_types, device=dev).to(torch.int32)
    keys = torch.as_tensor(keys, device=dev).to(torch.int32)
    k_sorted = torch.sort(torch.where(op_types == sl.OP_INSERT, keys,
                                      sl.KEY_MAX)).values.contiguous()
    first = torch.ones_like(k_sorted, dtype=torch.bool)
    first[1:] = k_sorted[1:] != k_sorted[:-1]
    distinct = (k_sorted != sl.KEY_MAX) & first
    present = ops.search_kernel_sharded(shl, k_sorted, cluster=False).found
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    pdist = torch.cat([zero, torch.cumsum(distinct, 0, dtype=torch.int32)])
    pnew = torch.cat([zero, torch.cumsum(distinct & ~present, 0,
                                         dtype=torch.int32)])
    return k_sorted, pdist, pnew


def rebalance_pass_plain(shl, mode: str, *, high_water: float = 0.75,
                         low_water: float = 0.25, max_shards: int = 0,
                         seed=0, op_types=None, keys=None, s=None, at=None
                         ) -> torch.Tensor:
    """The host loops of ``core.rebalance_traced``, their result copied
    into ``shl``'s tensors; (splits, merges) [2] int32 on ``shl``'s
    device."""
    from repro_torch.core import rebalance_traced as rbt

    splits = merges = 0
    if mode == "watermark":
        out, splits, merges = rbt.watermark_plain(
            shl, high_water=high_water, low_water=low_water,
            max_shards=max_shards, seed=seed)
    elif mode == "guard":
        out, splits = rbt.guard_plain(shl, op_types, keys,
                                      max_shards=max_shards, seed=seed)
    elif mode == "split":
        out = rbt.split_plain(shl, int(s), int(at), seed=seed)
        splits = 1
    elif mode == "merge":
        out = rbt.merge_plain(shl, int(s), seed=seed)
        merges = 1
    else:
        raise ValueError(f"rebalance_pass: unknown mode {mode!r}")
    if out is not shl:
        for dst, src in zip(shl.shards, out.shards):
            if dst is not None:
                dst.copy_(src)
        shl.boundaries.copy_(out.boundaries)
    return torch.tensor([splits, merges], dtype=torch.int32,
                        device=shl.boundaries.device)


def _scratch(dev: torch.device, cap: int, levels: int, width: int):
    """(run_keys, run_vals, chunk_first, ctrl, ref_ctz) of a state shape on
    ``dev``, made once."""
    key = (dev, cap, levels, width)
    if key not in _SCRATCH:
        i32 = dict(dtype=torch.int32, device=dev)
        chunks = math.ceil((cap - 2) / CHUNK)
        _SCRATCH[key] = (torch.empty(2 * cap * width, **i32),
                         torch.empty(2 * cap * width, **i32),
                         torch.empty(2 * levels * max(1, chunks), **i32),
                         torch.zeros(CTRL, **i32))
    if dev not in _REF_CTZ:
        _REF_CTZ[dev] = torch.tensor(sl._REF_CTZ, dtype=torch.int32,
                                     device=dev)
    return (*_SCRATCH[key], _REF_CTZ[dev])


def _check(shl, tensors) -> None:
    st = shl.shards
    dev = shl.boundaries.device
    S, cap = st.keys.shape
    for t in (*(t for t in st if t is not None), shl.boundaries, *tensors):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("rebalance_pass: every tensor must be "
                             f"contiguous on {dev}; got one on {t.device}")
    for name, t in st._asdict().items():
        want = torch.uint32 if name == "rng" else torch.int32
        if t is not None and (t.dtype != want or t.shape[0] != S):
            raise ValueError(f"rebalance_pass: {name} must be {want} with "
                             f"a leading [{S}] axis; got {t.dtype} "
                             f"{list(t.shape)}")
    for t in (shl.boundaries, *tensors):
        if t.dtype != torch.int32:
            raise ValueError("rebalance_pass: boundaries and the batch "
                             f"inputs must be int32; got {t.dtype}")
    L = (st.fused if st.foresight else st.nxt).shape[1]
    if L > MAX_LEVELS:
        raise ValueError(f"rebalance_pass: the kernel takes at most "
                         f"{MAX_LEVELS} levels; got {L}")
    if st.foresight and st.fused.data_ptr() % 8:
        raise ValueError("rebalance_pass: fused must be 8-byte aligned")


def _launch(shl, mode: str, guard, given, *, high_water: float,
            low_water: float, max_shards: int, seed, stream: int
            ) -> torch.Tensor:
    """Check the arguments and launch ``rebalance_launch`` on ``stream``."""
    st = shl.shards
    dev = shl.boundaries.device
    S, cap = st.keys.shape
    L = (st.fused if st.foresight else st.nxt).shape[1]
    width = st.node_width
    _check(shl, (guard or ()) + (() if given is None else (given,)))
    run_k, run_v, chunk_first, ctrl, ref_ctz = _scratch(dev, cap, L, width)
    usable = sl.usable_capacity(cap, width)
    hi, lo = marks(usable, high_water, low_water)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    k_sorted, pdist, pnew = guard or (None, None, None)
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.launch(
        "rebalance_launch",
        *map(ptr, (st.fused, st.nxt, st.keys, st.vals, st.height, st.n,
                   st.free_top, st.free_list, st.bump, st.rng, st.fat_keys,
                   st.fat_vals, st.nlen, shl.boundaries, k_sorted, pdist,
                   pnew, given, ref_ctz, run_k, run_v, chunk_first, ctrl,
                   counts)),
        MODES[mode], S, L, cap, width,
        0 if k_sorted is None else k_sorted.shape[0], usable,
        ceiling(S, max_shards), hi, lo,
        int(seed) & 0xFFFFFFFF,  # trace-ok: the caller's Python seed
        traversal_bound(L, cap), stream)
    rebalance_pass.launches += 1
    return counts
