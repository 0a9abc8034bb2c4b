"""Group a batch's lanes by shard or by key range: hand-written CUDA sorts.

``group_by_shard`` (``csrc/shard_group.cu``) orders the lanes of a routed
batch by shard id, stably, over ``S + 1`` buckets: bucket ``b < S`` holds
the lanes of shard ``b`` and bucket ``S`` every lane whose id is outside
``[0, S)``.  The dense sharded walks (K3 / K4 in
``kernels.foresight_traverse``) run it first, so that each warp walks the
lanes of one shard; it stands in for the stable ``argsort`` that the
reference's clustered plan makes (``repro.kernels.ops.cluster_queries``),
with no library sort and no host sync.

``group_by_key`` orders the lanes of a monolithic batch by key bucket,
stably: ``key_buckets`` maps each query to ``(u - lo) >> shift`` with ``u``
the query as an unsigned 32-bit value (``q + 2^31``), ``lo`` the batch's
least ``u`` and ``shift`` the least that leaves at most
``MAX_KEY_BUCKETS`` (8192) buckets.  The bucket is monotone in the key, so
each bucket is one key range.  K1, K2 and K8 (``foresight_traverse``,
``base_traverse``, ``validated_traverse``) run it first and store each
result at its lane's batch index; on the card ``lo`` and ``shift`` are
found by a min/max pass and the sort takes two digit passes, all on the
device.

``group_by_shard_plain`` and ``group_by_key_plain`` are the same functions
in plain torch: a stable ``argsort`` of the bucket ids (and, by shard,
their ``bincount``).  The wrappers run them on CPU tensors and launch the
kernels on CUDA tensors, counting each call in ``group_by_shard.launches``
/ ``group_by_key.launches``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

GROUP_TILE = 2048         # lanes a block of the histogram and scatter passes
# The kernel keeps S + 1 int32 counters a block in shared memory; 8192
# shards take 32 KB, under the 48 KB a block gets without opting in.
MAX_GROUP_SHARDS = 8192
KEY_BUCKET_BITS = 13      # at most 2^13 key buckets a batch
MAX_KEY_BUCKETS = 1 << KEY_BUCKET_BITS
_KEY_RADIX = 1 << 7       # buckets of the key sort's first (larger) digit
_SPAN_PARTIALS = 2 * 256  # the min/max pass's (least, greatest) a block


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


def key_buckets(queries: torch.Tensor) -> torch.Tensor:
    """Each lane's key bucket [B] int64: ``(u - lo) >> shift``.

    ``u = q + 2^31`` is the query as an unsigned 32-bit value (order
    kept), ``lo`` the least ``u`` of the batch and ``shift`` the least
    that leaves the span's largest bucket below ``MAX_KEY_BUCKETS``.  In
    64 bits, so a batch from ``KEY_MIN`` to ``KEY_MAX`` does not overflow.
    """
    u = queries.long() + 2**31
    if not u.numel():
        return u
    lo = u.min()
    shift = max(0, int(u.max() - lo).bit_length() - KEY_BUCKET_BITS)
    return (u - lo) >> shift


def group_by_key_plain(queries: torch.Tensor) -> torch.Tensor:
    """Plain-tensor key grouping: ``perm [B]`` int32, the stable ``argsort``
    of ``key_buckets(queries)`` (lane ids in key-bucket order, batch order
    within a bucket)."""
    return torch.argsort(key_buckets(queries), stable=True).to(torch.int32)


def group_by_key(queries: torch.Tensor):
    """The lanes grouped by key range: (q_sorted, perm).

    ``perm`` is ``group_by_key_plain``'s and ``q_sorted = queries[perm]``.
    On CUDA tensors it launches the kernel's passes (min/max, then a
    histogram, scan and scatter a digit) on the current stream.
    """
    q = queries.to(torch.int32)
    if q.dim() != 1:
        raise ValueError(f"group_by_key: queries {list(q.shape)} must be "
                         "one [B]")
    if q.device.type == "cpu":
        perm = group_by_key_plain(q)
        return q[perm.long()], perm
    if q.device.type != "cuda":
        raise ValueError(f"group_by_key: queries on {q.device}; the kernel "
                         "runs on CUDA and the plain version on the CPU")
    if not q.is_contiguous():
        raise ValueError("group_by_key: queries must be contiguous")
    if not q.numel():
        return q.clone(), torch.empty_like(q)
    with torch.cuda.device(q.device):
        return launch_key_grouping(q, torch.cuda.current_stream().cuda_stream)


def launch_key_grouping(q: torch.Tensor, stream: int):
    """``group_by_key``'s launch on checked, non-empty CUDA lanes, on
    ``stream`` of the current device (K1, K2 and K8 call it inside their
    own device context, with their stream)."""
    B = q.numel()
    table = (_KEY_RADIX + 1) * -(-B // GROUP_TILE)  # a digit pass's table
    # One allocation: q_sorted, perm, then scratch: the first digit pass's
    # q and perm, the offsets, the min/max partials and the count table and
    # its scan (both digit passes use them in turn).
    q_sorted, perm, q_mid, perm_mid, offsets, partials, counts = torch.empty(
        4 * B + _KEY_RADIX + 2 + _SPAN_PARTIALS + 2 * table,
        dtype=torch.int32, device=q.device
    ).split([B, B, B, B, _KEY_RADIX + 2, _SPAN_PARTIALS, 2 * table])
    _build.launch("group_by_key_launch", q.data_ptr(), partials.data_ptr(),
                  counts.data_ptr(), counts.data_ptr() + 4 * table,
                  offsets.data_ptr(), q_mid.data_ptr(), perm_mid.data_ptr(),
                  q_sorted.data_ptr(), perm.data_ptr(), B, stream)
    group_by_key.launches += 1
    return q_sorted, perm


group_by_key.launches = 0
