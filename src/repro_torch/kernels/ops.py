"""Batched point lookup through the traversal kernels (port of ``repro.kernels.ops``).

``search_kernel`` runs K1 (foresight) or K2 (base) on a monolithic state,
the sharded kernels on a ``ShardedSkipList`` (``search_kernel_sharded``)
and K10 on a mesh index (``kernels.mesh_launch``), and resolves
``found`` / ``vals``; on a fat-layout state every launch ends in K9 and
the values come from ``fat_vals`` at the element-flat id.  The monolithic
kernels take any batch length, so nothing is padded there.

Size limits: the reference refuses a table, or a per-shard tile, over its
12 MiB VMEM budget; the kernels here read the index straight from device
memory, so device memory is the only limit of that kind, and the port
refuses neither.  What remains are the indices the reference computes in
int32: the record index ``lvl * capacity + x`` and, on the sharded path,
the global node id ``sid * capacity + node``; under the fat layout the
element id ``owner * node_width + lane`` and its global form ``sid *
capacity * node_width + id``.  Past ``2**31 - 1`` they wrap there, so a
state whose ``levels * capacity`` or ``S * capacity * node_width`` is
above that has no reference answer and is refused with ``ValueError``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import sharded as shd
from repro_torch.core.mesh_index import MeshShardedIndex
from repro_torch.core.sharded import ShardedSkipList
from repro_torch.core.skiplist import NULL_VAL, SkipListState, sorted_live_kv
from repro_torch.kernels import foresight_traverse as ft
from repro_torch.kernels.foresight_traverse import QBLK
from repro_torch.kernels.ref import encode_float_keys

MAX_RECORDS = 2**31 - 1
MAX_SHARDS = shd.MAX_SHARDS
# The reference's VMEM budget for one index tile (12 MiB of a TPU core's
# ~16 MiB).  Only its shard-sizing rule uses it here: the card has no such
# limit, and no path of the port refuses a tile over it.
VMEM_BUDGET_BYTES = 12 * 1024 * 1024


class KernelSearchResult(NamedTuple):
    found: torch.Tensor   # [B] bool
    vals: torch.Tensor    # [B] int32
    node: torch.Tensor    # [B] int32 level-0 candidate (the key's node if
                          # found); on the sharded path sid * cap + node;
                          # fat: element-flat, stride cap * node_width


def tile_bytes(levels: int, capacity: int, foresight: bool,
               node_width: int = 1) -> int:
    """Bytes of the index a traversal reads from.

    foresight: ``levels * capacity`` fused (ptr, key) int32 pairs;
    base: ``levels * capacity`` int32 pointers + ``capacity`` int32 keys;
    the fat layout adds the ``capacity * node_width`` int32 run keys
    (``fat_vals`` is read outside the kernels).  A copy of
    ``repro.analysis.kernel_budget.tile_bytes``.
    """
    base = (levels * capacity * 2 * 4 if foresight
            else levels * capacity * 4 + capacity * 4)
    if node_width > 1:
        base += capacity * node_width * 4
    return base


def check_index_range(levels: int, capacity: int, n_shards: int = 1,
                      node_width: int = 1) -> None:
    """Raise ValueError where the reference's int32 record index
    (``lvl * capacity + x``), global node id (``sid * capacity + node``)
    or, under the fat layout, element id (``owner * node_width + lane``)
    or its global form would wrap."""
    if levels * capacity > MAX_RECORDS:
        raise ValueError(
            f"levels * capacity = {levels * capacity} exceeds 2**31 - 1: the "
            "reference's int32 record index lvl * capacity + x would wrap")
    if node_width > 1 and capacity * node_width > MAX_RECORDS:
        raise ValueError(
            f"capacity * node_width = {capacity * node_width} exceeds "
            "2**31 - 1: the reference's int32 element id owner * node_width "
            "+ lane would wrap")
    if n_shards * capacity * node_width > MAX_RECORDS:
        what = ("sid * capacity + node" if node_width == 1 else
                "sid * capacity * node_width + element")
        raise ValueError(
            f"S * capacity * node_width = {n_shards * capacity * node_width}"
            f" exceeds 2**31 - 1: the reference's int32 node id {what} "
            "would wrap")


def _pad(q: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``q`` padded with zeros to a multiple of ``QBLK``, and its length."""
    B = q.shape[0]
    pad = (-B) % QBLK
    if pad:
        q = torch.cat([q, q.new_zeros(pad)])
    return q, B


# ---------------------------------------------------------------------------
# The reference's shard sizing (a TPU rule, kept for callers that size by it)
# ---------------------------------------------------------------------------

def shard_vmem_footprint(levels: int, capacity: int, foresight: bool,
                         node_width: int = 1) -> int:
    """Bytes of one shard's tile in the reference's VMEM accounting."""
    return tile_bytes(levels, capacity, foresight, node_width)


def vmem_footprint(state) -> int:
    """Bytes the (per-shard) index tile occupies in the reference's VMEM."""
    if isinstance(state, ShardedSkipList):
        return shard_vmem_footprint(state.levels, state.shard_capacity,
                                    state.foresight, state.node_width)
    return shard_vmem_footprint(state.levels, state.capacity,
                                state.foresight, state.node_width)


def fits_vmem(state) -> bool:
    """Would the reference's kernels take this state's tile?  The card has
    no VMEM; the port's kernels take either answer."""
    return vmem_footprint(state) <= VMEM_BUDGET_BYTES


def auto_shards(n: int, levels: int, foresight: bool = True,
                node_width: int = 1) -> int:
    """The reference's sizing rule: the smallest power-of-two shard count
    whose per-shard tile fits its 12 MiB VMEM budget.  Nothing on the card
    needs it; callers that want the reference's partition use it."""
    s = 1
    while s <= MAX_SHARDS:
        cap = shd.shard_capacity_for(n, s, node_width)
        if shard_vmem_footprint(levels, cap, foresight,
                                node_width) <= VMEM_BUDGET_BYTES:
            return s
        s *= 2
    raise ValueError(f"index with n={n}, levels={levels} cannot be sharded "
                     f"into <= {MAX_SHARDS} VMEM-sized tiles")


def shard_state(state: SkipListState, n_shards: int) -> ShardedSkipList:
    """Re-build a monolithic list as ``n_shards`` key-range shards.

    The live keys come back in order from one stable argsort of the key
    array (the head sorts first, dead slots last), or under the fat layout
    of the run lanes (``sorted_live_kv``); node ids are not kept.
    """
    if state.fat_keys is not None:
        keys_sorted, vals_sorted = sorted_live_kv(state)
        valid = torch.arange(keys_sorted.shape[0],
                             device=state.device) < state.n
        return shd.build_sharded(keys_sorted, vals_sorted,
                                 n_shards=n_shards, levels=state.levels,
                                 foresight=state.foresight, valid=valid,
                                 node_width=state.node_width,
                                 device=state.device)
    cap = state.capacity
    m_total = cap - 2
    order = torch.argsort(state.keys, stable=True)
    keys_sorted = state.keys[order][1:m_total + 1]
    vals_sorted = state.vals[order][1:m_total + 1]
    valid = torch.arange(m_total, device=state.device) < state.n
    return shd.build_sharded(keys_sorted, vals_sorted, n_shards=n_shards,
                             levels=state.levels, foresight=state.foresight,
                             valid=valid, device=state.device)


# ---------------------------------------------------------------------------
# Query clustering: shard-sort the batch so each block touches few shards
# ---------------------------------------------------------------------------

class ClusterPlan(NamedTuple):
    """Shard-sorted launch plan for the clustered kernels (K5 / K6)."""

    q_sorted: torch.Tensor     # [Bp] queries in shard-sorted order
    sid_sorted: torch.Tensor   # [Bp] matching shard ids (non-decreasing)
    inv: torch.Tensor          # [Bp] inverse permutation: sorted -> original
    block_sids: torch.Tensor   # [nblk, K] k-th distinct shard of each block
    ndist: torch.Tensor        # [nblk] distinct-shard count per block


def cluster_queries(boundaries: torch.Tensor, q_padded: torch.Tensor, *,
                    k_shards: int = 0) -> ClusterPlan:
    """The clustered launch plan of a batch padded to whole ``QBLK`` blocks.

    A stable sort by routed shard makes each shard's queries contiguous;
    ``inv`` restores the original order.  ``block_sids[j, k]`` is block
    ``j``'s ``k``-th distinct shard; slots past ``ndist[j]`` repeat its
    last shard.  ``k_shards=0`` sizes K as the widest block's count,
    rounded up to a power of two and clamped to S; an explicit
    ``k_shards`` below that count raises ``ValueError``.  (The reference's
    traced branch, where that check cannot run, has no eager counterpart.)
    An empty batch gives an empty plan with K = 1; the reference raises.
    """
    S = boundaries.shape[0]
    Bp = q_padded.shape[0]
    if Bp % QBLK:
        raise ValueError(f"pad the queries to a multiple of {QBLK} first")
    nblk = Bp // QBLK
    sid = shd.route(boundaries, q_padded)
    perm = torch.argsort(sid, stable=True)
    q_sorted = q_padded[perm].to(torch.int32)
    sid_sorted = sid[perm]
    inv = torch.argsort(perm, stable=True)

    sid_blk = sid_sorted.reshape(nblk, QBLK)
    # first lane of each within-block run of equal shard ids
    first = torch.cat([torch.ones((nblk, 1), dtype=torch.bool,
                                  device=sid.device),
                       sid_blk[:, 1:] != sid_blk[:, :-1]], dim=1)
    slot = torch.cumsum(first, dim=1) - 1            # distinct-run index
    ndist = (slot[:, -1] + 1).to(torch.int32)
    widest = int(ndist.max()) if nblk else 0
    if k_shards == 0:
        K = min(1 << (widest - 1).bit_length() if widest > 1 else 1, S)
    else:
        K = k_shards
        if K < widest:
            raise ValueError(f"k_shards={K} < widest block's {widest} "
                             "shards: lanes would be dropped")
    if K < 1:
        raise ValueError(f"k_shards={K} must be >= 1")
    rows = torch.arange(nblk, device=sid.device)[:, None].expand(nblk, QBLK)
    block_sids = torch.zeros((nblk, K), dtype=torch.int32, device=sid.device)
    block_sids[rows, slot.clamp(max=K - 1)] = sid_blk
    # padding slots repeat the last distinct shard
    pad = torch.arange(K, device=sid.device)[None, :] >= ndist[:, None]
    block_sids = torch.where(pad, sid_blk[:, -1:], block_sids)
    return ClusterPlan(q_sorted, sid_sorted, inv, block_sids, ndist)


def plan_degeneration_split(ndist, n_shards: int):
    """Split a clustered plan's blocks into a small-K set and stragglers.

    One block straddling every shard snaps the auto-sized K to S for all
    blocks.  This picks the power-of-two ``k`` below the full K that
    minimizes the reference's grid-step cost ``n_keep * k + n_straggler *
    S``.  Returns ``None`` (no ``k`` beats one launch) or ``(k_small,
    keep_rows, straggler_rows)`` as host arrays.
    """
    nd = np.asarray(ndist.cpu() if isinstance(ndist, torch.Tensor)
                    else ndist)
    nblk = int(nd.size)
    if nblk == 0:
        return None
    kmax = int(nd.max())
    k_full = min(1 << (kmax - 1).bit_length() if kmax > 1 else 1, n_shards)
    best_cost = nblk * k_full
    best = None
    k = 1
    while k < k_full:
        strag = nd > k
        n_s = int(strag.sum())
        cost = (nblk - n_s) * k + n_s * n_shards
        if cost < best_cost:
            best_cost = cost
            best = (k, np.flatnonzero(~strag), np.flatnonzero(strag))
        k <<= 1
    return best


def dma_model_tile_loads(block_sids) -> int:
    """The reference's TPU cost model: tiles its clustered grid would copy
    to VMEM (index-map transitions + 1).  Host arithmetic, not a card
    measurement."""
    seq = np.asarray(block_sids.cpu() if isinstance(block_sids, torch.Tensor)
                     else block_sids).reshape(-1)
    if seq.size == 0:
        return 0
    return 1 + int(np.sum(seq[1:] != seq[:-1]))


def dma_model_bytes(shl: ShardedSkipList, n_queries: int,
                    block_sids=None) -> int:
    """The reference's TPU cost model: HBM->VMEM tile bytes of one sharded
    search (dense grid, or the clustered grid of ``block_sids``).  Host
    arithmetic, not a card measurement.  Copied as it is: like the
    reference it leaves a fat shard's ``[cap, B]`` run tile out."""
    nblk = -(-n_queries // QBLK)
    tile = shard_vmem_footprint(shl.levels, shl.shard_capacity,
                                shl.foresight)
    if block_sids is None:
        return nblk * shl.n_shards * tile
    return dma_model_tile_loads(block_sids) * tile


# ---------------------------------------------------------------------------
# Sharded launches
# ---------------------------------------------------------------------------

def _tables(shl: ShardedSkipList):
    return ((shl.shards.fused,) if shl.foresight
            else (shl.shards.nxt, shl.shards.keys))


def _dense(shl, sid, q, max_steps):
    kernel = (ft.foresight_traverse_sharded if shl.foresight
              else ft.base_traverse_sharded)
    return kernel(*_tables(shl), sid, q, shl.shards.fat_keys,
                  max_steps=max_steps)


def _clustered(shl, block_sids, ndist, sid, q, max_steps):
    kernel = (ft.foresight_traverse_clustered if shl.foresight
              else ft.base_traverse_clustered)
    return kernel(*_tables(shl), block_sids, ndist, sid, q,
                  shl.shards.fat_keys, max_steps=max_steps)


def _degenerate_launch(shl: ShardedSkipList, plan: ClusterPlan, split, *,
                       max_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: the clustered kernel on the keep blocks with ``block_sids``
    cut to ``k_small`` slots, the dense kernel on the straggler blocks,
    scattered back by block row.  Equal to one full-K clustered launch:
    a keep block's distinct shards fit ``k_small`` slots."""
    k_small, keep, strag = split
    dev = plan.q_sorted.device
    nblk = plan.block_sids.shape[0]
    qs = plan.q_sorted.reshape(nblk, QBLK)
    ss = plan.sid_sorted.reshape(nblk, QBLK)
    keep = torch.as_tensor(keep, dtype=torch.long, device=dev)
    strag = torch.as_tensor(strag, dtype=torch.long, device=dev)
    node_s = torch.zeros((nblk, QBLK), dtype=torch.int32, device=dev)
    ckey_s = torch.zeros_like(node_s)
    nk, ck = _clustered(shl, plan.block_sids[keep][:, :k_small].contiguous(),
                        plan.ndist[keep], ss[keep].reshape(-1),
                        qs[keep].reshape(-1), max_steps)
    node_s[keep] = nk.reshape(-1, QBLK)
    ckey_s[keep] = ck.reshape(-1, QBLK)
    nn, cn = _dense(shl, ss[strag].reshape(-1), qs[strag].reshape(-1),
                    max_steps)
    node_s[strag] = nn.reshape(-1, QBLK)
    ckey_s[strag] = cn.reshape(-1, QBLK)
    return node_s.reshape(-1), ckey_s.reshape(-1)


def search_kernel_sharded(shl: ShardedSkipList, queries, *,
                          max_steps: int = 0, cluster: bool = True,
                          k_shards: int = 0) -> KernelSearchResult:
    """Kernel-backed search over a partitioned index.

    ``cluster=True`` builds the clustered plan (``cluster_queries``) of the
    batch padded with zeros to whole ``QBLK`` blocks, as the reference
    does, so the plan (and auto-K) sees the pad lanes too; it runs K5/K6,
    or K7's split when auto-K would degenerate, and unsorts.
    ``cluster=False`` routes and runs K3/K4.  Both give the same ``found``,
    ``vals`` and global ``node = sid * cap + node`` (fat: ``sid * cap *
    node_width`` + the element-flat id).  An explicit ``k_shards`` below
    the widest block's shard count raises.
    """
    check_index_range(shl.levels, shl.shard_capacity, shl.n_shards,
                      shl.node_width)
    q0 = torch.as_tensor(queries, device=shl.device).to(torch.int32)
    q, B = _pad(q0)
    if cluster:
        plan = cluster_queries(shl.boundaries, q,
                               k_shards=min(k_shards, shl.n_shards))
        split = (plan_degeneration_split(plan.ndist, shl.n_shards)
                 if k_shards == 0 else None)
        if split is not None:
            node, ckey = _degenerate_launch(shl, plan, split,
                                            max_steps=max_steps)
        else:
            node, ckey = _clustered(shl, plan.block_sids, plan.ndist,
                                    plan.sid_sorted, plan.q_sorted,
                                    max_steps)
        node, ckey = node[plan.inv], ckey[plan.inv]
        sid = plan.sid_sorted[plan.inv]
    else:
        sid = shd.route(shl.boundaries, q)
        node, ckey = _dense(shl, sid, q, max_steps)
    node, ckey, sid = node[:B], ckey[:B], sid[:B]
    found = ckey == q0
    nw = shl.node_width
    gnode = sid.long() * (shl.shard_capacity * nw) + node.long()
    flat_vals = (shl.shards.vals if nw == 1 else shl.shards.fat_vals
                 ).reshape(-1)
    vals = torch.where(found, flat_vals[gnode], NULL_VAL)
    return KernelSearchResult(found, vals, gnode.to(torch.int32))


def search_kernel(state, queries: torch.Tensor, *, max_steps: int = 0,
                  cluster: bool = True, k_shards: int = 0, mesh=None
                  ) -> KernelSearchResult:
    """Kernel-backed batched search: a ``MeshShardedIndex`` takes
    ``mesh_launch.search_kernel_mesh`` (``mesh`` required: the index mesh
    it was partitioned for; ``queries`` is this rank's chunk), a
    ``ShardedSkipList`` ``search_kernel_sharded``, a monolithic state
    K1 / K2.

    Runs on the state's device: the CUDA kernels there, the plain versions
    on the CPU.  Any other state (``repro``'s among them) is refused.
    """
    if isinstance(state, MeshShardedIndex):
        if mesh is None:
            raise ValueError("search_kernel on a MeshShardedIndex needs "
                             "mesh= (see launch.mesh.make_index_mesh)")
        from repro_torch.kernels.mesh_launch import search_kernel_mesh
        return search_kernel_mesh(state, queries, mesh=mesh,
                                  max_steps=max_steps, k_shards=k_shards)
    if isinstance(state, ShardedSkipList):
        return search_kernel_sharded(state, queries, max_steps=max_steps,
                                     cluster=cluster, k_shards=k_shards)
    if not isinstance(state, SkipListState):
        raise TypeError(
            f"search_kernel on {type(state).__name__}: not a repro_torch "
            "state (repro's arrays convert through repro_torch.convert)")
    check_index_range(state.levels, state.capacity, 1, state.node_width)
    q = torch.as_tensor(queries, device=state.device).to(torch.int32)
    if state.foresight:
        node, ckey = ft.foresight_traverse(state.fused, q, state.fat_keys,
                                           max_steps=max_steps)
    else:
        node, ckey = ft.base_traverse(state.nxt, state.keys, q,
                                      state.fat_keys, max_steps=max_steps)
    found = ckey == q
    flat_vals = (state.vals if state.fat_keys is None
                 else state.fat_vals.reshape(-1))
    vals = torch.where(found, flat_vals[node.long()], NULL_VAL)
    return KernelSearchResult(found, vals, node)


def search_kernel_float(state, float_queries: torch.Tensor, *,
                        max_steps: int = 0, cluster: bool = True,
                        k_shards: int = 0) -> KernelSearchResult:
    """Float-keyed search (keys must have been encoded at build time)."""
    return search_kernel(state, encode_float_keys(float_queries),
                         max_steps=max_steps, cluster=cluster,
                         k_shards=k_shards)
