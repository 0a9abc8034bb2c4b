"""Batched skiplist traversal: hand-written CUDA kernels and plain versions.

Port of the kernels of ``repro.kernels.foresight_traverse``:

* ``foresight_traverse`` (K1): ONE read of the fused ``(ptr, key)`` record
  per step.  On the card it first groups the lanes by key range
  (``kernels.shard_group.group_by_key``, a CUDA counting sort by key
  bucket), walks them in that order and stores each result at its lane's
  index.
* ``base_traverse`` (K2): TWO dependent reads per step, the pointer and
  then the pointee's key; the paper's baseline.  Grouped as K1.
* ``foresight_traverse_sharded`` / ``base_traverse_sharded`` (K3 / K4):
  the same walks over stacked shard tables, each lane in the shard its
  ``shard_ids`` entry names.  On the card they first group the lanes by
  shard (``kernels.shard_group.group_by_shard``, a CUDA counting sort),
  walk them in that order and store each result at its lane's index.
* ``foresight_traverse_clustered`` / ``base_traverse_clustered`` (K5 /
  K6): K3 / K4 on a shard-sorted batch of 128-lane blocks (``QBLK``),
  serving lane ``i`` of block ``j`` only if its shard is one of the
  block's ``block_sids[j, :ndist[j]]`` (``kernels.ops.cluster_queries``).
  On the card one launch sorts each tile of consecutive plan lanes
  (``CLUSTERED_TILE``) by key in shared memory and walks it in that
  order; no pass runs before it.
* K9, the fat-node postlude (``_fat_resolve`` in the reference): given
  ``fat_keys`` (``[cap, B]``, or ``[S, cap, B]`` for K3-K6), every kernel
  above ends by finding the query's run and its position in it, and
  returns the element-flat id ``owner * B + lane`` and the key there
  (``KEY_MAX`` past the run).  On the card a warp resolves its lanes'
  runs together, a few coalesced rows at a time.  ``fat_resolve``
  launches the postlude alone, on given final predecessors, to check and
  time it.

Each wrapper launches its kernel (``csrc/traverse.cu``) on CUDA tensors and
runs its plain version on CPU tensors; any other device raises.  Each has a
``launches`` counter that goes up by one per kernel launch, and nowhere
else, so a run can show its lookups went through the kernel; a launch
with ``fat_keys`` also counts in the wrapper's ``fat_launches`` and in
``fat_resolve.launches``, since K9 ran inside it.  K3 / K4's grouping pass
counts in ``group_by_shard.launches``, K1's and K2's in
``group_by_key.launches``; K5 / K6 run neither.

Semantics are those of the reference's ``_traverse_loop``: every query
starts at the head on level ``L-1`` and advances or descends once per
step until it is below level 0 or ``max_steps`` steps have run.  The
kernels give each query its own loop; the reference's 128-lane blocks and
their padding have no counterpart in K1-K4, and the batch may have any
length.  K5 / K6 keep ``QBLK`` only as the block that ``block_sids`` and
``ndist`` describe; a lane whose shard is outside ``[0, S)`` or, in K5 /
K6, not among its block's slots is not served and gets ``(0, 0)``, the
reference's initial output.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.shard_group import (check_group_cap, launch_grouping,
                                            launch_key_grouping)

QBLK = 128     # query lanes per block of the clustered launch plan
_KEY_MAX = 2**31 - 1
# Plan lanes a block of the tile-sorted K5 / K6 sorts and walks, one a
# thread (kTile in csrc/traverse.cu, fixed there at compile time).
CLUSTERED_TILE = 1024


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


def _fat_resolve_plain(gather, fat_keys: torch.Tensor, q: torch.Tensor,
                       x: torch.Tensor, row_base=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-tensor K9: (element-flat node [B], key [B]) of the run that
    holds each query's position, from the final predecessors ``x``.

    The owner is the level-0 successor ``cand`` when its key (the run's
    minimum) equals the query or ``x`` is the head, else ``x``; ``pos``
    counts the owner's lanes below the query over all ``B`` lanes.  The
    run is row ``row_base + owner`` of ``fat_keys`` viewed as ``[-1, B]``
    (``row_base`` is the shard's ``sid * cap`` for K3-K6).
    """
    nw = fat_keys.shape[-1]
    cand, ck = gather(torch.zeros_like(x), x)
    owner = torch.where((ck == q) | (x == 0), cand, x).long()
    rows = owner if row_base is None else row_base + owner
    run = fat_keys.reshape(-1, nw)[rows]                  # [B, nw]
    pos = (run < q[:, None]).sum(dim=1)
    pos_c = pos.clamp(max=nw - 1)
    hit = run.gather(1, pos_c[:, None])[:, 0]
    return ((owner * nw + pos_c).to(torch.int32),
            torch.where(pos < nw, hit, _KEY_MAX).to(torch.int32))


def _postlude(gather, fat_keys, q, x, row_base=None):
    """The level-0 record of ``x``, or K9 with ``fat_keys``."""
    if fat_keys is None:
        return gather(torch.zeros_like(x), x)  # level-0 successor
    return _fat_resolve_plain(gather, fat_keys, q, x, row_base)


def foresight_traverse_plain(fused: torch.Tensor, queries: torch.Tensor,
                             fat_keys=None, *, max_steps: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-tensor K1 (K1 + K9 with ``fat_keys``): (node [B], cand_key
    [B])."""
    L, cap, _ = fused.shape
    gather = _fused_gather(fused)
    x = _traverse_loop(queries, gather, levels=L,
                       max_steps=max_steps or traversal_bound(L, cap))
    return _postlude(gather, fat_keys, queries, x)


def base_traverse_plain(nxt: torch.Tensor, keys: torch.Tensor,
                        queries: torch.Tensor, fat_keys=None, *,
                        max_steps: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-tensor K2 (K2 + K9 with ``fat_keys``): (node [B], cand_key
    [B])."""
    L, cap = nxt.shape
    gather = _base_gather(nxt, keys)
    x = _traverse_loop(queries, gather, levels=L,
                       max_steps=max_steps or traversal_bound(L, cap))
    return _postlude(gather, fat_keys, queries, x)


def fat_resolve_plain(fused: torch.Tensor, fat_keys: torch.Tensor,
                      x: torch.Tensor, queries: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K9 alone, from final predecessors ``x`` on a foresight table."""
    return _fat_resolve_plain(_fused_gather(fused), fat_keys, queries, x)


def _lane_shards(shard_ids: torch.Tensor, S: int) -> torch.Tensor:
    """Each lane's shard as an index (a shard id outside ``[0, S)`` reads
    shard 0)."""
    return torch.where((shard_ids >= 0) & (shard_ids < S), shard_ids,
                       0).long()


def _sharded_gather(tables, shard_ids: torch.Tensor):
    """K1's or K2's gather over stacked tables, in shard ``shard_ids[i]``
    per lane."""
    S = tables[0].shape[0]
    sid = _lane_shards(shard_ids, S)
    if len(tables) == 1:                       # fused [S, L, cap, 2]
        _, L, cap, _ = tables[0].shape
        gather = _fused_gather(tables[0].reshape(S * L, cap, 2))
        return lambda lvl, x: gather(sid * L + lvl.long(), x)
    nxt, keys = tables                         # [S, L, cap], [S, cap]
    _, L, cap = nxt.shape
    flat_nxt, flat_keys = nxt.reshape(-1), keys.reshape(-1)

    def gather(lvl, x):
        ptr = flat_nxt[(sid * L + lvl.long()) * cap + x.long()]
        return ptr, flat_keys[sid * cap + ptr.long()]
    return gather


def _clustered_served(block_sids, ndist, shard_ids):
    """Lane ``i`` of block ``j = i // QBLK`` is served iff its shard is
    ``block_sids[j, k]`` for some ``k < ndist[j]``."""
    nblk, K = block_sids.shape
    j = torch.arange(shard_ids.shape[0], device=shard_ids.device) // QBLK
    slots = torch.arange(K, device=shard_ids.device)
    hit = (block_sids[j] == shard_ids[:, None]) & \
        (slots[None, :] < ndist[j][:, None])
    return hit.any(dim=1)


def _sharded_plain(tables, shard_ids, queries, max_steps, plan=(),
                   fat_keys=None):
    """Every lane's walk in its shard, then its level-0 record or, with
    ``fat_keys [S, cap, B]``, K9 in the shard's runs; a lane whose shard is
    outside ``[0, S)`` or, given a ``plan`` ``(block_sids, ndist)``, not
    among its block's slots is not served and gives (0, 0)."""
    S, L, cap = tables[0].shape[:3]
    served = (shard_ids >= 0) & (shard_ids < S)
    if plan:
        served &= _clustered_served(*plan, shard_ids)
    gather = _sharded_gather(tables, shard_ids)
    x = _traverse_loop(queries, gather, levels=L,
                       max_steps=max_steps or traversal_bound(L, cap))
    node, key = _postlude(gather, fat_keys, queries, x,
                          _lane_shards(shard_ids, S) * cap)
    return torch.where(served, node, 0), torch.where(served, key, 0)


def foresight_traverse_sharded_plain(fused, shard_ids, queries,
                                     fat_keys=None, *, max_steps: int = 0):
    """Plain-tensor K3: (node [B], cand_key [B]), node ids shard-local."""
    return _sharded_plain((fused,), shard_ids, queries, max_steps,
                          fat_keys=fat_keys)


def base_traverse_sharded_plain(nxt, keys, shard_ids, queries,
                                fat_keys=None, *, max_steps: int = 0):
    """Plain-tensor K4: (node [B], cand_key [B]), node ids shard-local."""
    return _sharded_plain((nxt, keys), shard_ids, queries, max_steps,
                          fat_keys=fat_keys)


def foresight_traverse_clustered_plain(fused, block_sids, ndist, shard_ids,
                                       queries, fat_keys=None, *,
                                       max_steps: int = 0):
    """Plain-tensor K5: (node [B], cand_key [B]) in the sorted order."""
    return _sharded_plain((fused,), shard_ids, queries, max_steps,
                          (block_sids, ndist), fat_keys)


def base_traverse_clustered_plain(nxt, keys, block_sids, ndist, shard_ids,
                                  queries, fat_keys=None, *,
                                  max_steps: int = 0):
    """Plain-tensor K6: (node [B], cand_key [B]) in the sorted order."""
    return _sharded_plain((nxt, keys), shard_ids, queries, max_steps,
                          (block_sids, ndist), fat_keys)


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


def _check_int2(name: str, fused: torch.Tensor):
    if fused.data_ptr() % 8:
        raise ValueError(f"{name}: fused must be 8-byte aligned (the kernel "
                         "reads each record as one int2)")


def _fat_table(name: str, fat_keys, lead: Tuple[int, ...]):
    """``fat_keys`` if it makes the launch fat (width > 1), else ``None``;
    it must be ``lead + (B,)``: ``[cap, B]``, or ``[S, cap, B]``."""
    if fat_keys is None or fat_keys.shape[-1] == 1:
        return None
    if tuple(fat_keys.shape[:-1]) != lead:
        raise ValueError(f"{name}: fat_keys {list(fat_keys.shape)} must be "
                         f"{list(lead)} + [node_width]")
    return fat_keys


def launch_walk(wrapper, symbol: str, inputs, sizes, max_steps: int,
                fat_keys=None, grouped=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``symbol`` (a ``csrc`` launcher) on the batch.

    Its C arguments are the pointers of ``inputs`` (queries last; ``None``
    passes a null pointer), of the outputs node and key, then the batch,
    ``sizes`` and ``max_steps``, and the current stream.  ``grouped``, if
    given, is called with that stream first and returns the inputs to
    launch with instead (K3 / K4 group their lanes by shard there, K1, K2
    and K8 by key range).  Counts the launch on ``wrapper`` and, when
    ``fat_keys`` is set (K9 runs inside), in ``wrapper.fat_launches`` and
    ``fat_resolve.launches``; an empty batch launches nothing.
    """
    q = inputs[-1]
    if not q.numel():
        return torch.empty_like(q), torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if grouped is not None:      # first, so the device starts sooner
            inputs = grouped(stream)
        node, key = torch.empty_like(q), torch.empty_like(q)
        _build.launch(symbol,
                      *(None if t is None else t.data_ptr()
                        for t in inputs),
                      node.data_ptr(), key.data_ptr(), q.numel(), *sizes,
                      max_steps, stream)
    wrapper.launches += 1
    if fat_keys is not None:
        wrapper.fat_launches += 1
        fat_resolve.launches += 1
    return node, key


def _width(fat_keys) -> int:
    return 1 if fat_keys is None else fat_keys.shape[-1]


def _cuda_tables(name: str, q, *tables, fat_keys=None, fused=None):
    """The checks of a launch on CUDA tensors (``fat_keys`` too)."""
    _check_cuda(name, q, *tables,
                *(() if fat_keys is None else (fat_keys,)))
    if fused is not None:
        _check_int2(name, fused)


def foresight_traverse(fused: torch.Tensor, queries: torch.Tensor,
                       fat_keys=None, *, max_steps: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched foresight search: (node [B], cand_key [B]) int32.

    ``fused`` is [L, cap, 2] int32; ``max_steps`` 0 means
    ``traversal_bound(L, cap)``.  With ``fat_keys [cap, B]`` the walk ends
    in K9: ``node`` is element-flat (``owner * B + lane``) and
    ``cand_key`` the key there.  On the card the lanes are grouped by key
    range first (``group_by_key``'s kernel) and walked in that order; the
    results come back in lane order.
    """
    L, cap, _ = fused.shape
    q = queries.to(torch.int32)
    fat = _fat_table("foresight_traverse", fat_keys, (cap,))
    if fused.device.type == "cpu":
        return foresight_traverse_plain(fused, q, fat, max_steps=max_steps)
    _cuda_tables("foresight_traverse", q, fused, fat_keys=fat, fused=fused)
    return launch_walk(foresight_traverse, "foresight_traverse_launch",
                       (fused, fat, None, q), (L, cap, _width(fat)),
                       max_steps or traversal_bound(L, cap), fat,
                       key_grouped_lanes((fused, fat), q))


def base_traverse(nxt: torch.Tensor, keys: torch.Tensor,
                  queries: torch.Tensor, fat_keys=None, *,
                  max_steps: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched base search: (node [B], cand_key [B]) int32.

    ``nxt`` is [L, cap] int32 and ``keys`` [cap] int32; ``fat_keys``, and
    the grouping on the card, as in ``foresight_traverse``.
    """
    L, cap = nxt.shape
    q = queries.to(torch.int32)
    fat = _fat_table("base_traverse", fat_keys, (cap,))
    if nxt.device.type == "cpu":
        return base_traverse_plain(nxt, keys, q, fat, max_steps=max_steps)
    _cuda_tables("base_traverse", q, nxt, keys, fat_keys=fat)
    return launch_walk(base_traverse, "base_traverse_launch",
                       (nxt, keys, fat, None, q), (L, cap, _width(fat)),
                       max_steps or traversal_bound(L, cap), fat,
                       key_grouped_lanes((nxt, keys, fat), q))


def fat_resolve(fused: torch.Tensor, fat_keys: torch.Tensor,
                x: torch.Tensor, queries: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9 alone: (element-flat node [B], key [B]) from the final
    predecessors ``x`` of a foresight walk over ``fused [L, cap, 2]``
    (only level 0 is read) and ``fat_keys [cap, B]``.

    K1-K6 run the same postlude inside their launch; this entry point
    launches it by itself, so that it can be checked and timed alone.
    """
    L, cap, _ = fused.shape
    q, x = queries.to(torch.int32), x.to(torch.int32)
    _check_lanes("fat_resolve", x, q)
    if _fat_table("fat_resolve", fat_keys, (cap,)) is None:
        raise ValueError("fat_resolve: fat_keys must be [cap, B] with B > 1")
    if fused.device.type == "cpu":
        return fat_resolve_plain(fused, fat_keys, x, q)
    _cuda_tables("fat_resolve", q, fused, x, fat_keys=fat_keys, fused=fused)
    node, key = torch.empty_like(q), torch.empty_like(q)
    if q.numel():
        with torch.cuda.device(q.device):
            _build.launch("fat_resolve_launch", fused.data_ptr(),
                          fat_keys.data_ptr(), x.data_ptr(), q.data_ptr(),
                          node.data_ptr(), key.data_ptr(), q.numel(),
                          fat_keys.shape[-1],
                          torch.cuda.current_stream().cuda_stream)
        fat_resolve.launches += 1
    return node, key


def _check_lanes(name: str, shard_ids: torch.Tensor, queries: torch.Tensor):
    if shard_ids.shape != queries.shape:
        raise ValueError(f"{name}: shard_ids {list(shard_ids.shape)} and "
                         f"queries {list(queries.shape)} differ")


def _check_plan(name: str, n_shards: int, block_sids: torch.Tensor,
                ndist: torch.Tensor, queries: torch.Tensor):
    nblk, K = block_sids.shape
    if ndist.shape != (nblk,) or queries.shape[0] != nblk * QBLK:
        raise ValueError(f"{name}: the batch must be the plan's {nblk} "
                         f"blocks of {QBLK} lanes, with ndist [{nblk}]")
    if K > n_shards:
        raise ValueError(f"{name}: a plan with K={K} > S={n_shards} was "
                         "built for another shard count (stale after a "
                         "rebalance?); rebuild it from the current "
                         "boundaries")


def _grouped_lanes(tables, sid, q, S: int):
    """K3 / K4's launch inputs on grouped lanes: given the stream, run
    ``group_by_shard``'s kernel and return ``tables`` + (sid_sorted, perm
    as ``out_idx``, q_sorted), so lane ``i`` of the walk writes its result
    at ``perm[i]``, its batch index."""
    def grouped(stream):
        q_s, sid_s, perm, _ = launch_grouping(sid, q, S, stream)
        return (*tables, sid_s, perm, q_s)
    return grouped


def key_grouped_lanes(tables, q):
    """K1, K2 and K8's launch inputs on lanes grouped by key range: given
    the stream, run ``group_by_key``'s kernel and return ``tables`` +
    (perm as ``out_idx``, q_sorted), so lane ``i`` of the walk writes its
    result at ``perm[i]``, its batch index."""
    def grouped(stream):
        q_s, perm = launch_key_grouping(q, stream)
        return (*tables, perm, q_s)
    return grouped


def foresight_traverse_sharded(fused: torch.Tensor, shard_ids: torch.Tensor,
                               queries: torch.Tensor, fat_keys=None, *,
                               max_steps: int = 0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense sharded foresight search (K3) over ``fused [S, L, cap, 2]``.

    Lane ``i`` walks shard ``shard_ids[i]``; returns (node [B], cand_key
    [B]) in lane order, with shard-local node ids (element-flat with
    ``fat_keys [S, cap, B]``, K9).  ``max_steps`` 0 means
    ``traversal_bound(L, cap)`` of one shard.  On the card the lanes are
    grouped by shard first (``group_by_shard``'s kernel, which takes S up
    to ``MAX_GROUP_SHARDS``, raising ``ValueError`` above it) and walked in
    that order.
    """
    S, L, cap, _ = fused.shape
    q, sid = queries.to(torch.int32), shard_ids.to(torch.int32)
    _check_lanes("foresight_traverse_sharded", sid, q)
    fat = _fat_table("foresight_traverse_sharded", fat_keys, (S, cap))
    if fused.device.type == "cpu":
        return foresight_traverse_sharded_plain(fused, sid, q, fat,
                                                max_steps=max_steps)
    _cuda_tables("foresight_traverse_sharded", q, fused, sid, fat_keys=fat,
                 fused=fused)
    check_group_cap("foresight_traverse_sharded", S)
    return launch_walk(foresight_traverse_sharded,
                       "foresight_sharded_launch", (fused, fat, sid, None, q),
                       (S, L, cap, _width(fat)),
                       max_steps or traversal_bound(L, cap), fat,
                       _grouped_lanes((fused, fat), sid, q, S))


def base_traverse_sharded(nxt: torch.Tensor, keys: torch.Tensor,
                          shard_ids: torch.Tensor, queries: torch.Tensor,
                          fat_keys=None, *, max_steps: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense sharded base search (K4) over ``nxt [S, L, cap]`` and
    ``keys [S, cap]``; lanes grouped on the card as in K3."""
    S, L, cap = nxt.shape
    q, sid = queries.to(torch.int32), shard_ids.to(torch.int32)
    _check_lanes("base_traverse_sharded", sid, q)
    fat = _fat_table("base_traverse_sharded", fat_keys, (S, cap))
    if nxt.device.type == "cpu":
        return base_traverse_sharded_plain(nxt, keys, sid, q, fat,
                                           max_steps=max_steps)
    _cuda_tables("base_traverse_sharded", q, nxt, keys, sid, fat_keys=fat)
    check_group_cap("base_traverse_sharded", S)
    return launch_walk(base_traverse_sharded, "base_sharded_launch",
                       (nxt, keys, fat, sid, None, q),
                       (S, L, cap, _width(fat)),
                       max_steps or traversal_bound(L, cap), fat,
                       _grouped_lanes((nxt, keys, fat), sid, q, S))


def foresight_traverse_clustered(fused: torch.Tensor,
                                 block_sids: torch.Tensor,
                                 ndist: torch.Tensor,
                                 shard_ids: torch.Tensor,
                                 queries: torch.Tensor, fat_keys=None, *,
                                 max_steps: int = 0
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clustered foresight search (K5) over ``fused [S, L, cap, 2]``.

    ``queries`` / ``shard_ids`` are shard-sorted, ``nblk * QBLK`` lanes,
    with ``block_sids [nblk, K]`` and ``ndist [nblk]`` built for that
    order (``kernels.ops.cluster_queries``).  Returns (node, cand_key) in
    the sorted order; ``fat_keys`` as in K3.  On the card it is always one
    launch of the tile-sorted walk: each block sorts a tile of consecutive
    plan lanes (``CLUSTERED_TILE``) by key in shared memory, so a warp's
    lanes lie in one narrow key range of one shard, walks them in that
    order and stores each result at its plan index.  What bounds it is
    each lane's chain of dependent misses below the levels its warp
    shares.
    """
    S, L, cap, _ = fused.shape
    q, sid = queries.to(torch.int32), shard_ids.to(torch.int32)
    bs, nd = block_sids.to(torch.int32), ndist.to(torch.int32)
    _check_lanes("foresight_traverse_clustered", sid, q)
    _check_plan("foresight_traverse_clustered", S, bs, nd, q)
    fat = _fat_table("foresight_traverse_clustered", fat_keys, (S, cap))
    if fused.device.type == "cpu":
        return foresight_traverse_clustered_plain(fused, bs, nd, sid, q, fat,
                                                  max_steps=max_steps)
    _cuda_tables("foresight_traverse_clustered", q, fused, bs, nd, sid,
                 fat_keys=fat, fused=fused)
    return launch_walk(foresight_traverse_clustered,
                       "foresight_clustered_launch",
                       (fused, fat, bs, nd, sid, q),
                       (S, bs.shape[1], L, cap, _width(fat)),
                       max_steps or traversal_bound(L, cap), fat)


def base_traverse_clustered(nxt: torch.Tensor, keys: torch.Tensor,
                            block_sids: torch.Tensor, ndist: torch.Tensor,
                            shard_ids: torch.Tensor, queries: torch.Tensor,
                            fat_keys=None, *, max_steps: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clustered base search (K6) over ``nxt [S, L, cap]`` and
    ``keys [S, cap]``; on the card the tile-sorted walk of K5, two
    dependent loads a step."""
    S, L, cap = nxt.shape
    q, sid = queries.to(torch.int32), shard_ids.to(torch.int32)
    bs, nd = block_sids.to(torch.int32), ndist.to(torch.int32)
    _check_lanes("base_traverse_clustered", sid, q)
    _check_plan("base_traverse_clustered", S, bs, nd, q)
    fat = _fat_table("base_traverse_clustered", fat_keys, (S, cap))
    if nxt.device.type == "cpu":
        return base_traverse_clustered_plain(nxt, keys, bs, nd, sid, q, fat,
                                             max_steps=max_steps)
    _cuda_tables("base_traverse_clustered", q, nxt, keys, bs, nd, sid,
                 fat_keys=fat)
    return launch_walk(base_traverse_clustered, "base_clustered_launch",
                       (nxt, keys, fat, bs, nd, sid, q),
                       (S, bs.shape[1], L, cap, _width(fat)),
                       max_steps or traversal_bound(L, cap), fat)


WALKS = (foresight_traverse, base_traverse, foresight_traverse_sharded,
         base_traverse_sharded, foresight_traverse_clustered,
         base_traverse_clustered)
for _wrapper in WALKS:
    _wrapper.launches = 0
    _wrapper.fat_launches = 0
del _wrapper
fat_resolve.launches = 0
