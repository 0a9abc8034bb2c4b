"""Batched skiplist traversal: hand-written CUDA kernels and plain versions.

Port of the monolithic kernels of ``repro.kernels.foresight_traverse``:

* ``foresight_traverse`` (K1): ONE read of the fused ``(ptr, key)`` record
  per step.
* ``base_traverse`` (K2): TWO dependent reads per step, the pointer and
  then the pointee's key; the paper's baseline.

Each wrapper launches its kernel (``csrc/traverse.cu``) on CUDA tensors and
runs its plain version on CPU tensors; any other device raises.  Each has a
``launches`` counter that goes up by one per kernel launch, and nowhere
else, so a run can show its lookups went through the kernel.

Semantics are those of the reference's ``_traverse_loop``: every query
starts at the head on level ``L-1`` and advances or descends once per
step until it is below level 0 or ``max_steps`` steps have run.  The
kernels give each query its own thread and loop; the reference's 128-lane
blocks (``QBLK``) and their padding have no counterpart, and the batch may
have any length.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.kernels import _build


def traversal_bound(levels: int, capacity: int) -> int:
    """Safety ceiling on the steps of one traversal over a well-formed index.

    Every step either descends (at most ``levels`` of those) or advances to
    a strictly larger key, and at most ``capacity - 2`` keys are live, so a
    search never needs more than ``levels + capacity - 2`` steps.  The loop
    exits early at the real path length; the bound is never paid.
    """
    return levels + max(2, capacity) - 2 + 16


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _traverse_loop(q: torch.Tensor, gather: Callable, *, levels: int,
                   max_steps: int) -> torch.Tensor:
    """The lock-step loop; returns the final predecessors [B]."""
    x = torch.zeros_like(q)
    lvl = torch.full_like(q, levels - 1)
    step = 0
    while step < max_steps and bool((lvl >= 0).any()):
        active = lvl >= 0
        ptr, fk = gather(lvl.clamp(min=0), x)
        go = active & (fk < q)
        x = torch.where(go, ptr, x)
        lvl = torch.where(go | ~active, lvl, lvl - 1)
        step += 1
    return x


def _fused_gather(fused: torch.Tensor):
    cap = fused.shape[1]
    flat = fused.reshape(-1, 2)

    def gather(lvl, x):
        rec = flat[lvl.long() * cap + x.long()]
        return rec[:, 0], rec[:, 1]
    return gather


def _base_gather(nxt: torch.Tensor, keys: torch.Tensor):
    cap = nxt.shape[1]
    flat = nxt.reshape(-1)

    def gather(lvl, x):
        ptr = flat[lvl.long() * cap + x.long()]          # read 1
        return ptr, keys[ptr.long()]                     # read 2, dependent
    return gather


def foresight_traverse_plain(fused: torch.Tensor, queries: torch.Tensor, *,
                             max_steps: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-tensor K1: (node [B], cand_key [B])."""
    L, cap, _ = fused.shape
    gather = _fused_gather(fused)
    x = _traverse_loop(queries, gather, levels=L,
                       max_steps=max_steps or traversal_bound(L, cap))
    return gather(torch.zeros_like(x), x)      # level-0 successor


def base_traverse_plain(nxt: torch.Tensor, keys: torch.Tensor,
                        queries: torch.Tensor, *, max_steps: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-tensor K2: (node [B], cand_key [B])."""
    L, cap = nxt.shape
    gather = _base_gather(nxt, keys)
    x = _traverse_loop(queries, gather, levels=L,
                       max_steps=max_steps or traversal_bound(L, cap))
    return gather(torch.zeros_like(x), x)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name: str, queries: torch.Tensor, *tables: torch.Tensor):
    dev = tables[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; the kernel runs on "
                         "CUDA and the plain version on the CPU")
    for t in (*tables, queries):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous int32 "
                             f"on {dev}; got {t.dtype} on {t.device}")


def foresight_traverse(fused: torch.Tensor, queries: torch.Tensor, *,
                       max_steps: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched foresight search: (node [B], cand_key [B]) int32.

    ``fused`` is [L, cap, 2] int32; ``max_steps`` 0 means
    ``traversal_bound(L, cap)``.
    """
    L, cap, _ = fused.shape
    q = queries.to(torch.int32)
    if fused.device.type == "cpu":
        return foresight_traverse_plain(fused, q, max_steps=max_steps)
    _check_cuda("foresight_traverse", q, fused)
    if fused.data_ptr() % 8:
        raise ValueError("foresight_traverse: fused must be 8-byte aligned "
                         "(the kernel reads each record as one int2)")
    node, key = torch.empty_like(q), torch.empty_like(q)
    if q.numel():
        with torch.cuda.device(fused.device):
            _build.launch("foresight_traverse_launch", fused.data_ptr(),
                          q.data_ptr(), node.data_ptr(), key.data_ptr(),
                          q.numel(), L, cap,
                          max_steps or traversal_bound(L, cap),
                          torch.cuda.current_stream().cuda_stream)
        foresight_traverse.launches += 1
    return node, key


def base_traverse(nxt: torch.Tensor, keys: torch.Tensor,
                  queries: torch.Tensor, *, max_steps: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched base search: (node [B], cand_key [B]) int32.

    ``nxt`` is [L, cap] int32 and ``keys`` [cap] int32.
    """
    L, cap = nxt.shape
    q = queries.to(torch.int32)
    if nxt.device.type == "cpu":
        return base_traverse_plain(nxt, keys, q, max_steps=max_steps)
    _check_cuda("base_traverse", q, nxt, keys)
    node, key = torch.empty_like(q), torch.empty_like(q)
    if q.numel():
        with torch.cuda.device(nxt.device):
            _build.launch("base_traverse_launch", nxt.data_ptr(),
                          keys.data_ptr(), q.data_ptr(), node.data_ptr(),
                          key.data_ptr(), q.numel(), L, cap,
                          max_steps or traversal_bound(L, cap),
                          torch.cuda.current_stream().cuda_stream)
        base_traverse.launches += 1
    return node, key


foresight_traverse.launches = 0
base_traverse.launches = 0
