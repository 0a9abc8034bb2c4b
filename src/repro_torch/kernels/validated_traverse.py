"""Validated traversal (K8): Optimistic Validation as a CUDA kernel.

Port of ``repro.kernels.validated_traverse``: the torn-read-safe search of
``core.validated.search_validated`` reduced to its outputs (node,
authoritative key).  The fused table may be stale or corrupt in its
foreseen keys; upper levels advance iff the foreseen key AND the pointee's
authoritative key are below the query; level 0 trusts the authoritative
key only.  The serving path for mixed-view reads
(``core.versioned.VersionedIndex.search(lag > 0, use_kernel=True)``).

The wrapper launches ``csrc/validated_traverse.cu`` on CUDA tensors and
runs the plain version on CPU tensors; any other device raises.  It counts
its launches in ``validated_traverse.launches``.  On the card it first
groups the lanes by key range (``kernels.shard_group.group_by_key``, as
K2 does, counted in ``group_by_key.launches``), walks them in that order
and stores each result at its lane's index.

The step cap is the reference's fixed ``4 * L + 16``, not
``traversal_bound``: a lane whose path is longer stops there, in the
kernel, the plain version and the reference alike.  Every lane has its own
early exit; a finished lane does nothing in the reference's fixed-count
loop, so the outputs are the same.  Any batch length is taken.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.foresight_traverse import (_check_cuda, _check_int2,
                                                    _traverse_loop,
                                                    key_grouped_lanes,
                                                    launch_walk)


def default_max_steps(levels: int) -> int:
    """The reference's fixed trip count, ``4 * levels + 16``."""
    return 4 * levels + 16


def _validated_gather(fused: torch.Tensor, auth_keys: torch.Tensor):
    """(ptr, key to compare) per lane; the lane advances iff key < q.

    On levels >= 1 that key is max(foreseen, authoritative), which is below
    q iff both are; on level 0 it is the authoritative key alone.
    """
    cap = fused.shape[1]
    flat = fused.reshape(-1, 2)

    def gather(lvl, x):
        rec = flat[lvl.long() * cap + x.long()]
        ptr, real = rec[:, 0], auth_keys[rec[:, 0].long()]
        return ptr, torch.where(lvl == 0, real, torch.maximum(rec[:, 1], real))
    return gather


def validated_traverse_plain(fused: torch.Tensor, auth_keys: torch.Tensor,
                             queries: torch.Tensor, *, max_steps: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-tensor K8: (node [B], auth_keys[node] [B])."""
    L = fused.shape[0]
    gather = _validated_gather(fused, auth_keys)
    x = _traverse_loop(queries, gather, levels=L,
                       max_steps=max_steps or default_max_steps(L))
    return gather(torch.zeros_like(x), x)      # level-0 successor


def validated_traverse(fused: torch.Tensor, auth_keys: torch.Tensor,
                       queries: torch.Tensor, *, max_steps: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched validated search: (node [B], cand_key [B]) int32.

    ``fused`` is [L, cap, 2] int32 (foreseen keys may be stale), and
    ``auth_keys`` [cap] int32 the authoritative keys.  ``max_steps`` 0
    means ``4 * L + 16``.  On the card the lanes are grouped by key range
    first and walked in that order; the results come back in lane order.
    """
    L, cap, _ = fused.shape
    q = queries.to(torch.int32)
    if fused.device.type == "cpu":
        return validated_traverse_plain(fused, auth_keys, q,
                                        max_steps=max_steps)
    _check_cuda("validated_traverse", q, fused, auth_keys)
    if auth_keys.shape != (cap,):
        raise ValueError(f"validated_traverse: auth_keys must be [{cap}]; "
                         f"got {list(auth_keys.shape)}")
    _check_int2("validated_traverse", fused)
    return launch_walk(validated_traverse, "validated_traverse_launch",
                       (fused, auth_keys, None, q), (L, cap),
                       max_steps or default_max_steps(L),
                       grouped=key_grouped_lanes((fused, auth_keys), q))


validated_traverse.launches = 0
