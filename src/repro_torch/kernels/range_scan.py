"""Ordered range scans: a hand-written CUDA kernel and its plain version.

The device counterpart of the reference's scans (``repro.core.skiplist
.range_scan`` and ``repro.core.sharded.range_scan_sharded``, each a
``lax.fori_loop``); there is no Pallas kernel behind them.

``range_scan_batch(stack, boundaries, lo, hi, max_out)`` runs ``Q`` scans
``(lo[i], hi[i])`` over a stacked state (``boundaries`` ``None``: one list
as a stack of one) and returns ``(keys [Q, max_out], vals [Q, max_out],
count [Q])`` int32, padded with ``KEY_MAX`` / ``NULL_VAL``; ``raw=True`` is
``to_sorted_keys``' walk, ``max_out`` successor keys from the head.  On
CUDA tensors it launches ``csrc/range_scan.cu`` (one warp a scan) and
counts the launch in ``range_scan_batch.launches``, with nothing read back
to the host; on CPU tensors it runs ``range_scan_batch_plain``, the host
loops of ``core.skiplist`` and ``core.sharded``; any other device raises.
A failed build or launch raises: there is no fallback.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import skiplist as sl
from repro_torch.kernels import _build
from repro_torch.kernels.foresight_traverse import traversal_bound

Scan = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def bound_lanes(v, device) -> torch.Tensor:
    """A scan bound as the int32 [1] the reference casts it to: a tensor
    moved to ``device``, an int wrapped on the host and filled there."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32).reshape(1)
    v = int(np.int64(v).astype(np.int32))  # trace-ok: a Python int here
    return torch.full((1,), v, dtype=torch.int32, device=device)


def range_scan_batch(stack: sl.SkipListState,
                     boundaries: Optional[torch.Tensor], lo: torch.Tensor,
                     hi: torch.Tensor, max_out: int, *, raw: bool = False
                     ) -> Scan:
    """``Q`` scans over ``stack`` (a list when ``boundaries`` is None)."""
    if stack.keys.device.type == "cpu":
        return range_scan_batch_plain(stack, boundaries, lo, hi, max_out,
                                      raw=raw)
    dev = stack.keys.device
    if dev.type != "cuda":
        raise ValueError(f"range_scan_batch: tensors on {dev}; the kernel "
                         "runs on CUDA and the plain version on the CPU")
    return _launch(stack, boundaries, lo, hi, max_out, raw,
                   torch.cuda.current_stream(dev).cuda_stream)


range_scan_batch.launches = 0


def range_scan_batch_plain(stack: sl.SkipListState,
                           boundaries: Optional[torch.Tensor],
                           lo: torch.Tensor, hi: torch.Tensor, max_out: int,
                           *, raw: bool = False) -> Scan:
    """The host loops, one scan at a time."""
    from repro_torch.core import sharded as shd

    outs = []
    for a, b in zip(lo.tolist(), hi.tolist()):
        if raw:
            k = sl.to_sorted_keys_plain(shd.shard_view(stack, 0), max_out)
            outs.append((k, torch.full_like(k, sl.NULL_VAL),
                         torch.tensor(max_out, dtype=torch.int32)))
        elif boundaries is None:
            outs.append(sl.range_scan_plain(shd.shard_view(stack, 0), a, b,
                                            max_out))
        else:
            outs.append(shd.range_scan_sharded_plain(
                shd.ShardedSkipList(stack, boundaries), a, b, max_out))
    if not outs:
        e = torch.empty((0, max_out), dtype=torch.int32)
        return e, e.clone(), torch.empty(0, dtype=torch.int32)
    return tuple(torch.stack(t) for t in zip(*outs))


def _launch(stack: sl.SkipListState, boundaries, lo: torch.Tensor,
            hi: torch.Tensor, max_out: int, raw: bool, stream: int) -> Scan:
    """Check the arguments and launch ``range_scan_launch`` on ``stream``."""
    dev = stack.keys.device
    S, cap = stack.keys.shape
    L = (stack.fused if stack.foresight else stack.nxt).shape[1]
    tensors = [t for t in stack if t is not None] + [lo, hi]
    if boundaries is not None:
        tensors.append(boundaries)
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("range_scan_batch: every tensor must be "
                             f"contiguous on {dev}; got one on {t.device}")
    if lo.dtype != torch.int32 or hi.dtype != torch.int32 or \
            lo.shape != hi.shape or lo.dim() != 1:
        raise ValueError("range_scan_batch: lo and hi must be int32 [Q]")
    if boundaries is None and S != 1:
        raise ValueError("range_scan_batch: a stack of S > 1 needs its "
                         "boundaries")
    if max_out < 1:
        raise ValueError(f"range_scan_batch: max_out {max_out} must be >= 1")
    Q = lo.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    out_k = torch.empty((Q, max_out), **i32)
    out_v = torch.empty((Q, max_out), **i32)
    count = torch.empty((Q,), **i32)
    if Q == 0:
        return out_k, out_v, count
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.launch(
        "range_scan_launch",
        *map(ptr, (stack.fused, stack.nxt, stack.keys, stack.vals,
                   stack.fat_keys, stack.fat_vals, boundaries, lo, hi,
                   out_k, out_v, count)),
        Q, S, L, cap, stack.node_width, max_out,
        int(raw),  # trace-ok: a Python bool
        traversal_bound(L, cap), stream)
    range_scan_batch.launches += 1
    return out_k, out_v, count
