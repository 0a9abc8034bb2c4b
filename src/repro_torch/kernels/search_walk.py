"""The recording search walk (K14): the eager reads as one CUDA launch.

The device counterpart of two of the reference's eager reads, each one
``lax.while_loop`` and none a Pallas kernel: ``repro.core.skiplist.search``
(and ``contains``) and ``repro.core.validated.search_validated``.
``core.skiplist.search`` and ``core.validated.search_validated`` route
through the wrappers here:

* ``search_walk(state, q, stop_level=)`` is ``search``: a
  ``SearchResult`` with ``preds [B, L]`` and the lock-step loop's ``steps``
  and ``gathers``;
* ``search_walk_validated(fused, auth_keys, vals, q)`` is
  ``search_validated``, Optimistic Validation on a mixed view.

The third eager read, ``search_fast``, records nothing, so on the card it
is the K1/K2 lookup (``kernels.ops.search_kernel``), not K14.

On CUDA tensors each wrapper is one launch of ``csrc/search_walk.cu``,
counted in ``search_walk.launches`` (both wrappers count there), with
nothing read back to the host: ``steps`` and ``gathers`` are 0-dim views of
the kernel's counter buffer.  On CPU tensors they run their plain versions,
the host loops ``core.skiplist.search_plain`` and
``core.validated.search_validated_plain``; any other device raises.  A
failed build or launch raises: there is no fallback.

Signature differences from the reference: ``stop_level`` must lie in
``[0, L)`` and, on the card, ``L`` is at most ``MAX_LEVELS``; element ids
past int32 are refused (``kernels.ops.check_index_range``); on the card a
walk longer than ``traversal_bound(L, cap)`` (a corrupt table) traps where
the reference loops for ever.
"""
from __future__ import annotations

import torch

from repro_torch.core import skiplist as sl
from repro_torch.core import validated as vd
from repro_torch.kernels import _build
from repro_torch.kernels.foresight_traverse import traversal_bound
from repro_torch.kernels.ops import check_index_range

MAX_LEVELS = 32          # kMaxLevels: the preds a block stages
_FORESIGHT, _BASE, _VALIDATED = 0, 1, 2


def search_walk(state: sl.SkipListState, queries: torch.Tensor, *,
                stop_level: int = 0) -> sl.SearchResult:
    """``search`` of int32 ``queries`` [B] on ``state``'s device."""
    _check_state(state, stop_level)
    if state.keys.device.type == "cpu":
        return sl.search_plain(state, queries, stop_level=stop_level)
    return _launch(_FORESIGHT if state.foresight else _BASE, state.fused,
                   state.nxt, state.keys, state.vals, state.fat_keys,
                   state.fat_vals, queries, stop_level)


search_walk.launches = 0


def search_walk_validated(fused: torch.Tensor, auth_keys: torch.Tensor,
                          vals: torch.Tensor, queries: torch.Tensor
                          ) -> sl.SearchResult:
    """``search_validated``: ``fused`` [L, cap, 2] (foreseen keys may be
    stale or corrupt), ``auth_keys`` and ``vals`` [cap]."""
    L, cap, _ = fused.shape
    check_index_range(L, cap)
    if fused.device.type == "cpu":
        return vd.search_validated_plain(fused, auth_keys, vals, queries)
    return _launch(_VALIDATED, fused, None, auth_keys, vals, None, None,
                   queries, 0)


def _check_state(state: sl.SkipListState, stop_level: int) -> None:
    L = state.levels
    if not 0 <= stop_level < L:
        raise ValueError(f"search_walk: stop_level {stop_level} must lie "
                         f"in [0, {L})")
    check_index_range(L, state.capacity, 1, state.node_width)


def _launch(mode: int, fused, nxt, keys, vals, fat_keys, fat_vals,
            q: torch.Tensor, stop_level: int) -> sl.SearchResult:
    """Check the arguments and launch ``search_walk_launch`` on the current
    stream; count the launch on ``search_walk``."""
    table = fused if nxt is None else nxt
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"search_walk: tensors on {dev}; the kernel runs on "
                         "CUDA and the plain version on the CPU")
    L, cap = table.shape[:2]
    inputs = [t for t in (fused, nxt, keys, vals, fat_keys, fat_vals, q)
              if t is not None]
    for t in inputs:
        if t.device != dev or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError("search_walk: every tensor must be contiguous "
                             f"int32 on {dev}; got {t.dtype} on {t.device}")
    if keys.shape != (cap,) or vals.shape != (cap,) or q.dim() != 1:
        raise ValueError(f"search_walk: keys and vals must be [{cap}] and "
                         "the queries [B]")
    if fused is not None and fused.data_ptr() % 8:
        raise ValueError("search_walk: fused must be 8-byte aligned (the "
                         "kernel reads each record as one int2)")
    if L > MAX_LEVELS:
        raise ValueError(f"search_walk: the kernel takes at most "
                         f"{MAX_LEVELS} levels; got {L}")
    width = 1
    if fat_keys is not None:
        width = fat_keys.shape[-1]
        if fat_keys.shape != (cap, width) or fat_vals.shape != (cap, width):
            raise ValueError(f"search_walk: fat_keys and fat_vals must be "
                             f"[{cap}, node_width]")
    B = q.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    found = torch.empty((B,), dtype=torch.bool, device=dev)
    out_vals = torch.empty((B,), **i32)
    node = torch.empty((B,), **i32)
    preds = torch.empty((B, L), **i32)
    counters = torch.zeros((2,), **i32)
    if B:
        ptr = lambda t: None if t is None else t.data_ptr()
        with torch.cuda.device(dev):
            _build.launch(
                "search_walk_launch",
                *map(ptr, (fused, nxt, keys, vals, fat_keys, fat_vals, q,
                           found, out_vals, node, preds, counters)),
                mode, B, L, cap, width, stop_level, traversal_bound(L, cap),
                torch.cuda.current_stream().cuda_stream)
        search_walk.launches += 1
    return sl.SearchResult(found, out_vals, node, preds, counters[0],
                           counters[1])
