"""Plain-tensor oracles for the traversal kernels (port of ``repro.kernels.ref``).

Raw tensors in, raw tensors out, with the semantics of
``core.skiplist.search``: exact integer results, so tests assert equality.
"""
from __future__ import annotations

from typing import Tuple

import torch

_INT32_MIN = -(2**31)


def foresight_search_ref(fused: torch.Tensor, queries: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle for the foresight kernel.

    Args:
      fused: [L, cap, 2] int32 (next_ptr, next_key) records.
      queries: [B] int32.
    Returns:
      (node, cand_key): [B] int32 each, the level-0 successor of the final
      predecessor and its key (found iff cand_key == query).
    """
    L, cap, _ = fused.shape
    flat = fused.reshape(-1, 2)
    q = queries.to(torch.int32)
    x = torch.zeros_like(q)
    lvl = torch.full_like(q, L - 1)
    while bool((lvl >= 0).any()):
        active = lvl >= 0
        rec = flat[lvl.clamp(min=0).long() * cap + x.long()]
        go = active & (rec[:, 1] < q)
        x = torch.where(go, rec[:, 0], x)
        lvl = torch.where(go | ~active, lvl, lvl - 1)
    rec = flat[x.long()]                     # level 0: index = 0*cap + x
    return rec[:, 0], rec[:, 1]


def base_search_ref(nxt: torch.Tensor, keys: torch.Tensor,
                    queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle for the base (no-foresight) kernel: two dependent gathers."""
    L, cap = nxt.shape
    flat = nxt.reshape(-1)
    q = queries.to(torch.int32)
    x = torch.zeros_like(q)
    lvl = torch.full_like(q, L - 1)
    while bool((lvl >= 0).any()):
        active = lvl >= 0
        ptr = flat[lvl.clamp(min=0).long() * cap + x.long()]
        fk = keys[ptr.long()]
        go = active & (fk < q)
        x = torch.where(go, ptr, x)
        lvl = torch.where(go | ~active, lvl, lvl - 1)
    ptr = flat[x.long()]
    return ptr, keys[ptr.long()]


def encode_float_keys(f: torch.Tensor) -> torch.Tensor:
    """Order-preserving float32 -> int32 transform (Redis-style double keys).

    For non-negative floats the IEEE bit pattern is already ordered; for
    negative floats flipping all bits restores order.  NaNs are not allowed.
    """
    bits = f.to(torch.float32).view(torch.int32)
    return torch.where(bits < 0, _INT32_MIN + ~bits, bits)


def decode_float_keys(i: torch.Tensor) -> torch.Tensor:
    bits = torch.where(i < 0, ~(i - _INT32_MIN), i)
    return bits.view(torch.float32)
