"""Batched point lookup through the traversal kernels (port of ``repro.kernels.ops``).

``search_kernel`` runs K1 (foresight) or K2 (base) on a monolithic
scalar-layout state and resolves ``found`` / ``vals``.  The kernels take
any batch length, so the reference's padding to its 128-lane block has
nothing to do here.

Size limit: the reference refuses a table over its 12 MiB VMEM budget; the
kernels here read the index straight from device memory, so device memory
is the only limit of that kind.  What remains is the record index
``lvl * capacity + x``, which the reference computes in int32: past
``2**31 - 1`` it wraps there, so a state with ``levels * capacity`` above
that has no reference answer and is refused.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.skiplist import NULL_VAL, SkipListState
from repro_torch.kernels.foresight_traverse import (base_traverse,
                                                    foresight_traverse)
from repro_torch.kernels.ref import encode_float_keys

MAX_RECORDS = 2**31 - 1


class KernelSearchResult(NamedTuple):
    found: torch.Tensor   # [B] bool
    vals: torch.Tensor    # [B] int32
    node: torch.Tensor    # [B] int32 level-0 candidate (the key's node if found)


def tile_bytes(levels: int, capacity: int, foresight: bool) -> int:
    """Bytes of the index a traversal reads from (scalar layout).

    foresight: ``levels * capacity`` fused (ptr, key) int32 pairs;
    base: ``levels * capacity`` int32 pointers + ``capacity`` int32 keys.
    """
    return (levels * capacity * 2 * 4 if foresight
            else levels * capacity * 4 + capacity * 4)


def check_index_range(levels: int, capacity: int) -> None:
    """Raise ValueError where the reference's int32 record index would wrap."""
    if levels * capacity > MAX_RECORDS:
        raise ValueError(
            f"levels * capacity = {levels * capacity} exceeds 2**31 - 1: the "
            "reference's int32 record index lvl * capacity + x would wrap")


def search_kernel(state: SkipListState, queries: torch.Tensor, *,
                  max_steps: int = 0) -> KernelSearchResult:
    """Kernel-backed batched search on a monolithic state.

    Runs on the state's device: the CUDA kernel there, the plain version
    on the CPU.  Sharded and mesh states are not ported yet.
    """
    if not isinstance(state, SkipListState):
        raise NotImplementedError(
            f"search_kernel on {type(state).__name__}: sharded and mesh "
            "states are not ported yet (ROADMAP.md Queue 1, sharded engine "
            "and mesh-distributed index)")
    check_index_range(state.levels, state.capacity)
    q = torch.as_tensor(queries, device=state.device).to(torch.int32)
    if state.foresight:
        node, ckey = foresight_traverse(state.fused, q, max_steps=max_steps)
    else:
        node, ckey = base_traverse(state.nxt, state.keys, q,
                                   max_steps=max_steps)
    found = ckey == q
    vals = torch.where(found, state.vals[node.long()], NULL_VAL)
    return KernelSearchResult(found, vals, node)


def search_kernel_float(state: SkipListState, float_queries: torch.Tensor, *,
                        max_steps: int = 0) -> KernelSearchResult:
    """Float-keyed search (keys must have been encoded at build time)."""
    return search_kernel(state, encode_float_keys(float_queries),
                         max_steps=max_steps)
