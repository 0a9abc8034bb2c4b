"""Group a batch's lanes by shard: a hand-written CUDA counting sort.

``group_by_shard`` (``csrc/shard_group.cu``) orders the lanes of a routed
batch by shard id, stably, over ``S + 1`` buckets: bucket ``b < S`` holds
the lanes of shard ``b`` and bucket ``S`` every lane whose id is outside
``[0, S)``.  The dense sharded walks (K3 / K4 in
``kernels.foresight_traverse``) run it first, so that each warp walks the
lanes of one shard; it stands in for the stable ``argsort`` that the
reference's clustered plan makes (``repro.kernels.ops.cluster_queries``),
with no library sort and no host sync.

``group_by_shard_plain`` is the same function in plain torch: a stable
``argsort`` of the bucket ids and their ``bincount``.  The wrapper runs it
on CPU tensors and launches the kernel on CUDA tensors, counting each
launch in ``group_by_shard.launches``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

GROUP_TILE = 2048         # lanes a block of the histogram and scatter passes
# The kernel keeps S + 1 int32 counters a block in shared memory; 8192
# shards take 32 KB, under the 48 KB a block gets without opting in.
MAX_GROUP_SHARDS = 8192


def _buckets(shard_ids: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Each lane's bucket: its shard id, or ``n_shards`` outside [0, S)."""
    return torch.where((shard_ids >= 0) & (shard_ids < n_shards), shard_ids,
                       n_shards)


def group_by_shard_plain(shard_ids: torch.Tensor, n_shards: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-tensor grouping: (perm [B], offsets [S + 2]) int32.

    ``perm`` is the stable ``argsort`` of the lanes' buckets (lane ids in
    bucket order, batch order within a bucket); bucket ``b``'s lanes are
    ``perm[offsets[b]:offsets[b + 1]]``.
    """
    b = _buckets(shard_ids, n_shards)
    perm = torch.argsort(b, stable=True).to(torch.int32)
    counts = torch.bincount(b.long(), minlength=n_shards + 1)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return perm, offsets.to(torch.int32)


def check_group_cap(name: str, n_shards: int) -> None:
    """Raise ``ValueError`` for a shard count the kernel cannot group."""
    if n_shards > MAX_GROUP_SHARDS:
        raise ValueError(f"{name}: n_shards={n_shards} exceeds "
                         f"MAX_GROUP_SHARDS={MAX_GROUP_SHARDS}, the grouping "
                         "kernel's shared-memory counters")


def group_by_shard(shard_ids: torch.Tensor, queries: torch.Tensor,
                   n_shards: int):
    """The lanes grouped by shard: (q_sorted, sid_sorted, perm, offsets).

    ``perm`` and ``offsets`` are those of ``group_by_shard_plain``;
    ``q_sorted = queries[perm]`` and ``sid_sorted = shard_ids[perm]`` (a
    lane outside ``[0, S)`` keeps its own id).  On CUDA tensors it launches
    the kernel's three passes (histogram, scan, scatter) on the current
    stream and takes ``1 <= n_shards <= MAX_GROUP_SHARDS`` (8192: the
    kernel's shared-memory counters), raising ``ValueError`` above it.
    """
    sid, q = shard_ids.to(torch.int32), queries.to(torch.int32)
    if sid.dim() != 1 or sid.shape != q.shape:
        raise ValueError(f"group_by_shard: shard_ids {list(sid.shape)} and "
                         f"queries {list(q.shape)} must be one [B] each")
    if n_shards < 1:
        raise ValueError(f"group_by_shard: n_shards={n_shards} must be >= 1")
    if sid.device.type == "cpu":
        perm, offsets = group_by_shard_plain(sid, n_shards)
        return q[perm.long()], sid[perm.long()], perm, offsets
    if sid.device.type != "cuda":
        raise ValueError(f"group_by_shard: tensors on {sid.device}; the "
                         "kernel runs on CUDA and the plain version on the "
                         "CPU")
    check_group_cap("group_by_shard", n_shards)
    if q.device != sid.device or not (sid.is_contiguous()
                                      and q.is_contiguous()):
        raise ValueError("group_by_shard: shard_ids and queries must be "
                         "contiguous on one device")
    if not q.numel():
        perm = torch.empty_like(q)
        return q.clone(), sid.clone(), perm, torch.zeros(
            n_shards + 2, dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        return launch_grouping(sid, q, n_shards,
                               torch.cuda.current_stream().cuda_stream)


def launch_grouping(sid: torch.Tensor, q: torch.Tensor, n_shards: int,
                    stream: int):
    """``group_by_shard``'s launch on checked, non-empty CUDA lanes, on
    ``stream`` of the current device (the sharded walks call it inside
    their own device context, with their stream)."""
    B, S = q.numel(), n_shards
    table = (S + 1) * -(-B // GROUP_TILE)     # [S+1, nblocks] a table
    # One allocation: q_sorted, sid_sorted, perm, offsets, then the count
    # table and its scan (scratch).
    q_sorted, sid_sorted, perm, offsets, counts = torch.empty(
        3 * B + S + 2 + 2 * table, dtype=torch.int32, device=q.device
    ).split([B, B, B, S + 2, 2 * table])
    _build.launch("group_by_shard_launch", sid.data_ptr(), q.data_ptr(),
                  counts.data_ptr(), counts.data_ptr() + 4 * table,
                  offsets.data_ptr(), q_sorted.data_ptr(),
                  sid_sorted.data_ptr(), perm.data_ptr(), B, S, stream)
    group_by_shard.launches += 1
    return q_sorted, sid_sorted, perm, offsets


group_by_shard.launches = 0
