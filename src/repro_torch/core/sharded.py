"""Sharded key-space skiplist in PyTorch (port of ``repro.core.sharded``).

The key space is cut into ``S`` contiguous ranges, one independent
``SkipListState`` each, held as ONE stacked state whose every tensor has a
leading ``[S]`` axis (``fused [S, L, cap, 2]``, ``keys [S, cap]``, ``n
[S]`` ...), plus ``boundaries [S]`` int32: ``boundaries[s]`` is the
smallest key of shard ``s`` and ``boundaries[0]`` is pinned to
``KEY_MIN``.  Shard ``s`` owns ``[boundaries[s], boundaries[s+1])``; an
empty shard's boundary is ``KEY_MAX``, so routing never selects it.
Everything here is bit-identical to the reference on the same inputs and
seed: the stacked arrays (``rng`` included), the boundaries, every search
and update result and the shard count after a rebalance.

Both layouts: under the fat layout (``node_width`` > 1) every shard is a
fat list (``fat_keys [S, cap, B]`` ...), ``shard_capacity`` counts node
slots, and lookups and scans resolve within the owning run.

What differs from the reference, and why the results do not:

* ``build_sharded`` builds every shard in place into preallocated stacked
  tensors (no per-shard states stacked afterwards: at 64 shards of 21
  levels x 2^21 slots that would be a second 22.5 GB copy).
* ``apply_ops_sharded`` runs each shard's own segment of the route-sorted
  batch, ``B`` ops in all.  The reference scans ``S`` windows of the
  widest segment's width and masks the positions past a segment to reads,
  which touch neither state nor rng, so the results are the same.  It
  clones the whole stacked state once per batch and leaves its input
  unchanged, as ``core.skiplist.apply_ops`` does.  There is no
  ``max_segment`` window: it only shapes the reference's traced scan.
* Rebalancing runs the reference's eager host passes (numpy, the same
  tie order) on a fully live state.  A state with a static shard ceiling
  (``S > 1`` and a last boundary of ``KEY_MAX``, e.g. every
  ``empty_sharded`` with ``S > 1``) rebalances in place inside that
  ceiling (``core.rebalance_traced``), as the reference does; so does
  every state of the mesh index, which the reference applies under
  ``shard_map`` (``apply_ops_sharded``'s private ``_in_place``).  On the
  card those in-place passes, the scans and ``search_sharded`` run
  hand-written kernels and read nothing back.
* The plain searches (``search_sharded``, ``range_scan_sharded``) index
  the flattened stack as ``(sid * L + lvl) * cap + x``, and under the fat
  layout its runs as ``(sid * cap + node) * B + lane``, which the
  reference computes in int32.  Past ``S * L * cap`` or ``S * cap * B =
  2**31 - 1`` that wraps and there is no reference answer, so the port
  refuses such a stack with ``ValueError``
  (``kernels.ops.search_kernel_sharded`` indexes per shard and takes it).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.skiplist import (HEAD, KEY_MAX, KEY_MIN, NULL_VAL,
                                       OP_INSERT, TAIL, SkipListState,
                                       _clone, _to_i32, allocate, build,
                                       build_into, check_foresight_invariant,
                                       fat_scan_step, fill_empty,
                                       node_slots_for, resolve_device,
                                       run_position, scan_result,
                                       search_plain, sorted_live_kv,
                                       usable_capacity)
from repro_torch.kernels import apply_ops as apply_kernel

MAX_INDEX = 2**31 - 1


class ShardedSkipList(NamedTuple):
    """``S`` key-range shards (one stacked state) + the routing array."""

    shards: SkipListState    # every tensor has a leading [S] axis
    boundaries: torch.Tensor  # [S] int32, inclusive lower key bound per shard

    @property
    def n_shards(self) -> int:
        return self.boundaries.shape[0]

    @property
    def levels(self) -> int:
        arr = self.shards.nxt if self.shards.nxt is not None \
            else self.shards.fused
        return arr.shape[1]

    @property
    def shard_capacity(self) -> int:
        return self.shards.keys.shape[1]

    @property
    def foresight(self) -> bool:
        return self.shards.fused is not None

    @property
    def node_width(self) -> int:
        return self.shards.node_width

    @property
    def device(self) -> torch.device:
        return self.boundaries.device


def shard_view(shards: SkipListState, s: int) -> SkipListState:
    """Shard ``s`` of a stacked state, as views (writes go to the stack)."""
    return SkipListState(*(None if t is None else t[s] for t in shards))


def _stack(*states: SkipListState) -> SkipListState:
    return SkipListState(*(None if ts[0] is None else torch.stack(ts)
                           for ts in zip(*states)))


def route(boundaries: torch.Tensor, queries) -> torch.Tensor:
    """Shard id per query [B] int32: the shard whose key range holds it."""
    q = torch.as_tensor(queries, device=boundaries.device).to(torch.int32)
    sid = torch.searchsorted(boundaries, q.contiguous(), right=True) - 1
    return sid.clamp(0, boundaries.shape[0] - 1).to(torch.int32)


def shard_capacity_for(n: int, n_shards: int, node_width: int = 1) -> int:
    """Per-shard capacity for ``n`` total keys: ``m = ceil(n / S)`` keys a
    shard (under the fat layout the node slots they pack into), 2x
    headroom, the next power of two, at least 8."""
    m = max(1, -(-n // n_shards))
    if node_width > 1:
        m = node_slots_for(m, node_width)
    return max(8, 1 << (2 * m + 4 - 1).bit_length())


def partition_boundaries(sorted_keys: torch.Tensor, stride: int
                         ) -> torch.Tensor:
    """Lower bounds ``sorted_keys[::stride]`` with slot 0 pinned to KEY_MIN.

    ``sorted_keys`` is non-decreasing with dead slots ``KEY_MAX`` as a
    suffix, so an all-dead slice gets the boundary ``KEY_MAX``.
    """
    b = sorted_keys[::stride].to(torch.int32).clone()
    b[0] = KEY_MIN
    return b


def build_sharded(keys, vals, *, n_shards: int, capacity: int = 0,
                  levels: int = 16, foresight: bool = True, seed: int = 0,
                  valid=None, node_width: int = 1,
                  device=None) -> ShardedSkipList:
    """Partition sorted unique int32 ``keys`` into ``n_shards`` range shards.

    Shard ``s`` is built with seed ``seed + s`` from the ``m = ceil(n/S)``
    keys ``[s*m, (s+1)*m)``, padded with ``KEY_MAX`` and an invalid
    suffix.  ``valid`` (optional prefix mask) marks the real entries.  The
    shards are built one by one into preallocated stacked tensors on
    ``device`` (``None``: the GPU); ``node_width`` > 1 builds fat shards.
    """
    dev = resolve_device(device)
    keys = torch.as_tensor(keys, device=dev).to(torch.int32)
    vals = torch.as_tensor(vals, device=dev).to(torch.int32)
    n, S = keys.shape[0], n_shards
    capacity = capacity or shard_capacity_for(n, S, node_width)
    m = max(1, -(-n // S))
    slots = node_slots_for(m, node_width)
    if slots + 2 > capacity:
        raise ValueError(f"shard capacity {capacity} must exceed the "
                         f"{slots} node slots of a shard's keys + 2")
    valid = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
             else torch.as_tensor(valid, device=dev).to(torch.bool))
    keys = torch.where(valid, keys, KEY_MAX)
    pad = S * m - n
    if pad:
        keys = torch.cat([keys, keys.new_full((pad,), KEY_MAX)])
        vals = torch.cat([vals, vals.new_full((pad,), NULL_VAL)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    stacked = allocate((S,), capacity, levels, foresight=foresight,
                       node_width=node_width, device=dev)
    fill_empty(stacked, levels)
    for s in range(S):
        shard = shard_view(stacked, s)
        shard.rng.copy_(prng.PRNGKey(seed + s, device=dev))
        sl_ = slice(s * m, (s + 1) * m)
        build_into(shard, keys[sl_], vals[sl_], valid[sl_])
    return ShardedSkipList(stacked, partition_boundaries(keys, m))


def empty_sharded(*, n_shards: int, capacity: int, levels: int = 16,
                  foresight: bool = True, seed: int = 0, node_width: int = 1,
                  device=None) -> ShardedSkipList:
    """An empty partitioned index: every shard holds only the sentinels and
    every boundary but shard 0's is ``KEY_MAX``."""
    z = torch.zeros((0,), dtype=torch.int32)
    return build_sharded(z, z, n_shards=n_shards, capacity=capacity,
                         levels=levels, foresight=foresight, seed=seed,
                         node_width=node_width, device=device)


def total_n(shl: ShardedSkipList) -> torch.Tensor:
    return shl.shards.n.sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# Eager batched search and range scan across shards
# ---------------------------------------------------------------------------

def check_stack_index(shl: ShardedSkipList) -> None:
    """Raise where the reference's int32 flat stack index would wrap: the
    record index, and under the fat layout the element index."""
    S, L, cap, B = (shl.n_shards, shl.levels, shl.shard_capacity,
                    shl.node_width)
    if S * L * cap > MAX_INDEX:
        raise ValueError(
            f"S * levels * capacity = {S * L * cap} exceeds 2**31 - 1: the "
            "reference's int32 stack index (sid * L + lvl) * cap + x would "
            "wrap (kernels.ops.search_kernel_sharded indexes per shard)")
    if S * cap * B > MAX_INDEX:
        raise ValueError(
            f"S * capacity * node_width = {S * cap * B} exceeds 2**31 - 1: "
            "the reference's int32 run index (sid * cap + node) * B + lane "
            "would wrap (kernels.ops.search_kernel_sharded indexes per "
            "shard)")


def _effective_tops(shl: ShardedSkipList) -> torch.Tensor:
    """[S] int32: per-shard highest level with a real head successor, +1."""
    sh = shl.shards
    head_next = (sh.fused[:, :, HEAD, 0] if shl.foresight
                 else sh.nxt[:, :, HEAD])
    lv = torch.arange(shl.levels, dtype=torch.int32, device=shl.device)
    top = torch.where(head_next != TAIL, lv, -1).max(dim=1).values
    return torch.clamp(top + 1, max=shl.levels - 1).to(torch.int32)


def _stack_gather(shl: ShardedSkipList, sid: torch.Tensor):
    """gather(lvl, x) -> (next_ptr, next_key) in shard ``sid`` per lane."""
    L, cap = shl.levels, shl.shard_capacity
    sid = sid.long()
    if shl.foresight:
        flat = shl.shards.fused.reshape(-1, 2)

        def gather(lvl, x):
            rec = flat[(sid * L + lvl.long()) * cap + x.long()]
            return rec[:, 0], rec[:, 1]
    else:
        flat_nxt = shl.shards.nxt.reshape(-1)
        flat_keys = shl.shards.keys.reshape(-1)

        def gather(lvl, x):
            ptr = flat_nxt[(sid * L + lvl.long()) * cap + x.long()]
            return ptr, flat_keys[sid * cap + ptr.long()]
    return gather


def search_sharded(shl: ShardedSkipList, queries
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched lookup across the partitioned index: (found [B], vals [B]).

    Each lane walks only its own shard.  On the card that is one dense
    K3/K4 launch (``kernels.ops.search_kernel_sharded(cluster=False)``,
    fat through K9), with nothing read back; on the CPU its plain version,
    ``core.skiplist.search_fast`` with one more index term, from each
    shard's effective top level.  Both refuse a stack past the reference's
    int32 index first (``check_stack_index``).
    """
    check_stack_index(shl)
    if shl.device.type == "cuda":
        from repro_torch.kernels import ops
        r = ops.search_kernel_sharded(shl, queries, cluster=False)
        return r.found, r.vals
    q = torch.as_tensor(queries, device=shl.device).to(torch.int32)
    sid = route(shl.boundaries, q)
    gather = _stack_gather(shl, sid)
    x = torch.zeros_like(q)
    lvl = _effective_tops(shl)[sid.long()]
    while bool((lvl >= 0).any()):
        active = lvl >= 0
        ptr, fk = gather(lvl.clamp(min=0), x)
        go = active & (fk < q)
        x = torch.where(go, ptr, x)
        lvl = torch.where(go | ~active, lvl, lvl - 1)
    cand, ck = gather(torch.zeros_like(q), x)
    cap = shl.shard_capacity
    if shl.node_width > 1:
        # the owning run, as in core.skiplist._fat_resolve_batch
        nw = shl.node_width
        owner = torch.where((ck == q) | (x == HEAD), cand, x)
        rows = sid.long() * cap + owner.long()
        _, pos_c, found = run_position(
            shl.shards.fat_keys.reshape(-1, nw), rows, q)
        vals = shl.shards.fat_vals.reshape(-1)[rows * nw + pos_c]
        return found, torch.where(found, vals, NULL_VAL)
    found = ck == q
    vals = shl.shards.vals.reshape(-1)[sid.long() * cap + cand.long()]
    return found, torch.where(found, vals, NULL_VAL)


def contains_sharded(shl: ShardedSkipList, queries) -> torch.Tensor:
    return search_sharded(shl, queries)[0]


def range_scan_sharded(shl: ShardedSkipList, lo, hi, max_out: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to ``max_out`` (key, val) pairs with lo <= key < hi, in order.

    Routes ``lo`` to its shard, positions with that shard's predecessor
    search, then walks level 0; a shard's tail spills into the next
    shard's head.  Returns (keys [max_out], vals [max_out], count []);
    unused slots hold KEY_MAX / NULL_VAL.  The walk stops where the
    reference's fixed ``max_out + S`` iterations stop changing anything;
    the fat layout walks a (shard, node, lane) cursor instead.  Runs
    through ``kernels.range_scan.range_scan_batch`` (on the card one
    launch, with nothing read back; on the CPU
    ``range_scan_sharded_plain``), after ``check_stack_index``.
    """
    from repro_torch.kernels import range_scan as rs

    check_stack_index(shl)
    dev = shl.device
    k, v, c = rs.range_scan_batch(shl.shards, shl.boundaries,
                                  rs.bound_lanes(lo, dev),
                                  rs.bound_lanes(hi, dev), max_out)
    return k[0], v[0], c[0]


def range_scan_sharded_plain(shl: ShardedSkipList, lo, hi, max_out: int
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``range_scan_sharded``'s host loop (the scan kernel's plain
    version)."""
    lo, hi = _to_i32(lo), _to_i32(hi)
    S, dev = shl.n_shards, shl.device
    sid = int(route(shl.boundaries, torch.tensor([lo]))[0])
    shard = shard_view(shl.shards, sid)
    x = int(search_plain(shard, torch.tensor([lo], dtype=torch.int32,
                                             device=dev)).preds[0, 0])
    if shl.node_width > 1:
        return _fat_range_scan_sharded(shl, lo, hi, max_out, sid, x)
    keys_out: List[int] = []
    vals_out: List[int] = []
    for _ in range(max_out + S):
        if shl.foresight:
            ptr, k = shl.shards.fused[sid, 0, x].tolist()
        else:
            ptr = int(shl.shards.nxt[sid, 0, x])
            k = int(shl.shards.keys[sid, ptr])
        if k != KEY_MAX and lo <= k < hi and len(keys_out) < max_out:
            keys_out.append(k)
            vals_out.append(int(shl.shards.vals[sid, ptr]))
            x = ptr
        elif k == KEY_MAX and sid < S - 1:   # shard exhausted: spill
            sid, x = sid + 1, HEAD
        else:
            break
    return scan_result(keys_out, vals_out, max_out, dev)


def _fat_range_scan_sharded(shl: ShardedSkipList, lo: int, hi: int,
                            max_out: int, sid: int, node: int
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The cross-shard scan over fat runs: a (shard, node, lane) cursor
    from node ``node`` of shard ``sid``.  At a run's end it hops to the
    level-0 successor, or, where that is the tail, spills into the next
    shard's head; it stops at the last shard's tail, a key at or past
    ``hi`` or ``max_out`` pairs, and like the reference after at most
    ``2 * max_out + node_width + 2 * S + 4`` steps."""
    S, nw, sh = shl.n_shards, shl.node_width, shl.shards

    def row(sid, node):
        if shl.foresight:
            ptr, pk = sh.fused[sid, 0, node].tolist()
        else:
            ptr = int(sh.nxt[sid, 0, node])
            pk = int(sh.keys[sid, ptr])
        return ((sh.fat_keys[sid, node].tolist(),
                 sh.fat_vals[sid, node].tolist()), ptr, pk)

    lane, taken = 0, []
    run, ptr, pk = row(sid, node)
    for _ in range(2 * max_out + nw + 2 * S + 4):
        at_end, stop = fat_scan_step(run, lane, nw, lo, hi, taken, max_out)
        succ_tail = pk == KEY_MAX              # level-0 successor is the tail
        if (at_end and succ_tail and sid >= S - 1) or stop or \
                len(taken) >= max_out:
            break
        if at_end:
            sid, node = (sid + 1, HEAD) if succ_tail else (sid, ptr)
            lane = 0
            run, ptr, pk = row(sid, node)
        else:
            lane += 1
    return scan_result([k for k, _ in taken], [v for _, v in taken],
                       max_out, shl.device)


# ---------------------------------------------------------------------------
# Rebalancing: shard split / merge, watermark driver, one-pass repack
# ---------------------------------------------------------------------------

HIGH_WATER = 0.75       # split a shard above this fraction of usable capacity
LOW_WATER = 0.25        # merge-eligible below this fraction
MAX_SHARDS = 1024       # hard ceiling on split growth


class RebalanceStats(NamedTuple):
    splits: int
    merges: int


def _shard_sorted_kv(shard: SkipListState
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's live (key, val) pairs in key order, padded to cap - 2."""
    return sorted_live_kv(shard)


def _set_shard_slice(shl: ShardedSkipList, s: int, width: int,
                     replacement: SkipListState,
                     boundaries: torch.Tensor) -> ShardedSkipList:
    """Splice ``replacement`` (leading axis = new shards) over shards
    ``[s, s + width)``."""
    shards = SkipListState(*(
        None if full is None else torch.cat([full[:s], ins, full[s + width:]])
        for full, ins in zip(shl.shards, replacement)))
    return ShardedSkipList(shards, boundaries)


def _boundaries_with(shl: ShardedSkipList, s: int, width: int,
                     middle: List[int]) -> torch.Tensor:
    """``boundaries`` with ``[s + 1, s + 1 + width)`` replaced by
    ``middle``."""
    b = shl.boundaries
    return torch.cat([b[:s + 1], b.new_tensor(middle), b[s + 1 + width:]])


def split_shard(shl: ShardedSkipList, s: int, at_key: Optional[int] = None,
                *, seed: int = 0) -> ShardedSkipList:
    """Split shard ``s`` in two at ``at_key`` (default: its median key).

    The left shard keeps keys ``< at_key`` (rebuilt with ``seed``), the
    right keys ``>= at_key`` (``seed + 1``); ``at_key`` becomes the right
    shard's boundary and must lie strictly inside shard ``s``'s range.
    """
    s, S = int(s), shl.n_shards
    if not 0 <= s < S:
        raise ValueError(f"shard {s} out of range for {S} shards")
    cap, L, fs, nw, dev = (shl.shard_capacity, shl.levels, shl.foresight,
                           shl.node_width, shl.device)
    shard = shard_view(shl.shards, s)
    ks, vs = _shard_sorted_kv(shard)
    n = int(shard.n)
    ks_np = ks.cpu().numpy()
    if at_key is None:
        if n < 2:
            raise ValueError("cannot median-split a shard with < 2 keys; "
                             "pass an explicit at_key")
        at_key = int(ks_np[n // 2])
    at_key = int(at_key)
    b_np = shl.boundaries.cpu().numpy()
    hi = int(b_np[s + 1]) if s + 1 < S else KEY_MAX
    if not int(b_np[s]) < at_key < hi:
        raise ValueError(f"at_key={at_key} outside shard {s}'s open range "
                         f"({int(b_np[s])}, {hi})")
    n_left = int((ks_np[:n] < at_key).sum())
    # rebuilds pack at build fill, so each half must fit the fill mass
    W = usable_capacity(cap, nw)
    if n_left > W or n - n_left > W:
        raise ValueError(f"split halves {n_left}/{n - n_left} exceed the "
                         f"build-fill capacity {W} (node_width={nw})")
    idx = torch.arange(W, device=dev)
    args = dict(capacity=cap, levels=L, foresight=fs, node_width=nw,
                device=dev)
    left = build(ks[:W], vs[:W], seed=seed, valid=idx < n_left, **args)
    right = build(torch.roll(ks, -n_left)[:W], torch.roll(vs, -n_left)[:W],
                  seed=seed + 1, valid=idx < n - n_left, **args)
    return _set_shard_slice(shl, s, 1, _stack(left, right),
                            _boundaries_with(shl, s, 0, [at_key]))


def merge_shards(shl: ShardedSkipList, s: int, *, seed: int = 0
                 ) -> ShardedSkipList:
    """Merge adjacent shards ``s`` and ``s + 1`` into one (rebuilt with
    ``seed``); their combined live count must fit the shard capacity."""
    s, S = int(s), shl.n_shards
    if not 0 <= s < S - 1:
        raise ValueError("merge needs a right-hand neighbour")
    cap, L, fs, nw, dev = (shl.shard_capacity, shl.levels, shl.foresight,
                           shl.node_width, shl.device)
    a, b = shard_view(shl.shards, s), shard_view(shl.shards, s + 1)
    ka, va = _shard_sorted_kv(a)
    kb, vb = _shard_sorted_kv(b)
    na, nb = int(a.n), int(b.n)
    if node_slots_for(na + nb, nw) + 2 > cap:
        raise ValueError(f"merged occupancy {na}+{nb} exceeds shard "
                         f"capacity {cap} (node_width={nw})")
    width = usable_capacity(cap, nw)         # the rebuild packs at fill
    pad = width - na - nb
    ks = torch.cat([ka[:na], kb[:nb], ka.new_full((pad,), KEY_MAX)])
    vs = torch.cat([va[:na], vb[:nb], va.new_full((pad,), NULL_VAL)])
    merged = build(ks, vs, capacity=cap, levels=L, foresight=fs, seed=seed,
                   valid=torch.arange(width, device=dev) < na + nb,
                   node_width=nw, device=dev)
    return _set_shard_slice(shl, s, 2, _stack(merged),
                            _boundaries_with(shl, s, 1, []))


def repack(shl: ShardedSkipList, n_shards: int = 0, *, seed: int = 0
           ) -> ShardedSkipList:
    """Re-partition every live key evenly over ``n_shards`` (default: the
    current count) at the same per-shard capacity, in one pass."""
    S = shl.n_shards
    S2 = int(n_shards) or S
    cap, nw = shl.shard_capacity, shl.node_width
    nn = int(total_n(shl))
    if node_slots_for(-(-max(1, nn) // S2), nw) + 2 > cap:
        raise ValueError(f"{nn} keys over {S2} shards exceed per-shard "
                         f"capacity {cap} (node_width={nw})")
    if nw > 1:
        # Fat lanes sort directly: the sentinel rows are all KEY_MAX (no
        # KEY_MIN lane), so the live elements lead the order.
        flat_k, flat_v, first = (shl.shards.fat_keys.reshape(-1),
                                 shl.shards.fat_vals.reshape(-1), 0)
    else:
        # The S head sentinels (KEY_MIN) sort first and dead slots
        # (KEY_MAX) last, so the live keys are positions S .. S + nn.
        flat_k, flat_v, first = (shl.shards.keys.reshape(-1),
                                 shl.shards.vals.reshape(-1), S)
    order = torch.argsort(flat_k, stable=True)
    ks = flat_k[order][first:first + nn]
    vs = flat_v[order][first:first + nn]
    return build_sharded(ks, vs, n_shards=S2, capacity=cap,
                         levels=shl.levels, foresight=shl.foresight,
                         seed=seed, node_width=nw, device=shl.device)


def validate_watermarks(high_water: float, low_water: float) -> None:
    if not 0.5 < high_water <= 1.0:
        raise ValueError(f"high_water={high_water} must be in (0.5, 1.0] "
                         "(split halves must land below the high mark)")
    if not 0.0 < low_water < high_water:
        raise ValueError(f"low_water={low_water} must be in "
                         f"(0, high_water={high_water})")


def _has_static_ceiling(shl: ShardedSkipList) -> bool:
    """Does the state carry dead ceiling slots (a KEY_MAX last boundary)?"""
    return shl.n_shards > 1 and int(shl.boundaries[-1]) == KEY_MAX


def _watermark_rebalance(shl: ShardedSkipList, *, high_water: float,
                         low_water: float, max_shards: int, seed: int = 0
                         ) -> Tuple[ShardedSkipList, RebalanceStats]:
    """Split every shard above ``high_water`` (largest first), then merge
    the adjacent pair of least combined occupancy that fits under it and
    has a shard below ``low_water``, until neither applies."""
    validate_watermarks(high_water, low_water)
    usable = usable_capacity(shl.shard_capacity, shl.node_width)
    splits = merges = 0
    while shl.n_shards < max_shards:
        ns = shl.shards.n.cpu().numpy()
        over = np.flatnonzero(ns > high_water * usable)
        if over.size == 0:
            break
        s = int(over[np.argmax(ns[over])])
        if ns[s] < 2:
            break
        shl = split_shard(shl, s, seed=seed + splits)
        splits += 1
    while shl.n_shards > 1:
        ns = shl.shards.n.cpu().numpy()
        b = shl.boundaries.cpu().numpy()
        comb = ns[:-1] + ns[1:]
        ok = (b[1:] < KEY_MAX) & (comb <= high_water * usable) & \
             ((ns[:-1] < low_water * usable) | (ns[1:] < low_water * usable))
        cand = np.flatnonzero(ok)
        if cand.size == 0:
            break
        s = int(cand[np.argmin(comb[cand])])
        shl = merge_shards(shl, s, seed=seed + merges)
        merges += 1
    return shl, RebalanceStats(splits, merges)


def rebalance(shl: ShardedSkipList, *, high_water: float = HIGH_WATER,
              low_water: float = LOW_WATER, max_shards: int = MAX_SHARDS,
              seed: int = 0) -> Tuple[ShardedSkipList, RebalanceStats]:
    """Watermark-driven split/merge pass: (new state, stats).

    Contents are preserved; only the partition and tower heights change.
    A state with a static ceiling re-levels in place inside it
    (``rebalance_traced.watermark_rebalance_traced``).
    """
    if _has_static_ceiling(shl):
        from repro_torch.core import rebalance_traced as rbt
        return rbt.watermark_rebalance_traced(
            shl, high_water=high_water, low_water=low_water,
            max_shards=max_shards, seed=seed)
    return _watermark_rebalance(shl, high_water=high_water,
                                low_water=low_water, max_shards=max_shards,
                                seed=seed)


def _exhaustion_guard(shl: ShardedSkipList, op_types: torch.Tensor,
                      keys: torch.Tensor, *, max_shards: int, seed: int = 0
                      ) -> Tuple[ShardedSkipList, int]:
    """Split ahead of any shard that this batch's new keys would overfill.

    Projects each shard's occupancy as ``n_s`` + the distinct new keys
    routed to it, and splits the worst at the median of its live and
    incoming keys until every projection fits or the keys are indivisible.
    Contents never change, so the following apply is unaffected.
    """
    usable = usable_capacity(shl.shard_capacity, shl.node_width)
    ins = op_types.cpu().numpy() == OP_INSERT
    if not ins.any():
        return shl, 0
    ins_keys = np.unique(keys.cpu().numpy()[ins]).astype(np.int32)
    # Every insert counted as new first; only if a shard could overflow is
    # the presence search paid for.
    sid0 = route(shl.boundaries, torch.from_numpy(ins_keys)).cpu().numpy()
    ns0 = shl.shards.n.cpu().numpy()
    bound = ns0 + np.bincount(sid0, minlength=shl.n_shards)[:ns0.size]
    if not (bound > usable).any():
        return shl, 0
    present = search_sharded(shl, torch.from_numpy(ins_keys))[0]
    new_keys = ins_keys[~present.cpu().numpy()]
    splits = 0
    while new_keys.size and shl.n_shards < max_shards:
        sid = route(shl.boundaries, torch.from_numpy(new_keys)).cpu().numpy()
        ns = shl.shards.n.cpu().numpy()
        proj = ns + np.bincount(sid, minlength=shl.n_shards)[:ns.size]
        over = np.flatnonzero(proj > usable)
        if over.size == 0:
            break
        s = int(over[np.argmax(proj[over])])
        shard = shard_view(shl.shards, s)
        live = _shard_sorted_kv(shard)[0][:int(shard.n)].cpu().numpy()
        combined = np.sort(np.concatenate([live, new_keys[sid == s]]))
        at = int(combined[combined.size // 2])
        if at == int(combined[0]):                 # median won't separate
            bigger = combined[combined > combined[0]]
            if bigger.size == 0:                   # indivisible key mass
                break
            at = int(bigger[0])
        shl = split_shard(shl, s, at_key=at, seed=seed + splits)
        splits += 1
    return shl, splits


# ---------------------------------------------------------------------------
# Routed batched updates
# ---------------------------------------------------------------------------

def shard_segments(sid_sorted: torch.Tensor, n_shards: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard ``(start, len)`` [S] int32 of a shard-sorted id array;
    an empty shard gets a zero-length segment at its insertion point."""
    s = torch.arange(n_shards, dtype=torch.int32, device=sid_sorted.device)
    starts = torch.searchsorted(sid_sorted, s).to(torch.int32)
    ends = torch.searchsorted(sid_sorted, s, right=True).to(torch.int32)
    return starts, ends - starts


def _segment_window(W: int) -> int:
    """A window width rounded up to a power of two (>= 8)."""
    return max(8, 1 << (W - 1).bit_length())


def default_segment_window(batch: int, n_shards: int) -> int:
    """The reference's traced window hint: twice the balanced segment
    width, pow2-rounded, at most the batch."""
    return min(max(1, batch), _segment_window(2 * (-(-batch // n_shards))))


def apply_ops_sharded(shl: ShardedSkipList, op_types, keys, vals, *,
                      rebalance: bool = False,
                      high_water: float = HIGH_WATER,
                      low_water: float = LOW_WATER,
                      max_shards: int = MAX_SHARDS, seed: int = 0,
                      _in_place: bool = False
                      ) -> Tuple[ShardedSkipList, torch.Tensor]:
    """Apply a linearized mixed-op batch, routed per shard: (new state,
    results [B] int32).

    The batch is stably sorted by routed shard, so each shard's ops keep
    their order; shards hold disjoint key ranges, so the results equal the
    monolithic ``apply_ops``'s.  ``shl`` is left unchanged.  With
    ``rebalance`` a pre-pass splits ahead of any shard the batch's inserts
    would exhaust (``_exhaustion_guard``) and a post-pass re-levels the
    watermarks; ``seed`` feeds the towers of those rebuilds.  On a state
    with a static ceiling, or with ``_in_place`` (the mesh index, which
    the reference applies under ``shard_map``, and the page table), both
    passes are the in-place passes of ``core.rebalance_traced`` on one
    clone, around the update kernel (``_apply_in_place_passes``), and the
    shard axis keeps its length.
    """
    dev = shl.device
    op_types, keys, vals = (torch.as_tensor(a, device=dev).to(torch.int32)
                            for a in (op_types, keys, vals))
    if rebalance and (_in_place or _has_static_ceiling(shl)):
        return _apply_in_place_passes(shl, op_types, keys, vals,
                                      high_water=high_water,
                                      low_water=low_water,
                                      max_shards=max_shards, seed=seed)
    if rebalance:
        shl, _ = _exhaustion_guard(shl, op_types, keys,
                                   max_shards=max_shards, seed=seed)
    B = keys.shape[0]
    if B == 0:
        return shl, torch.zeros((0,), dtype=torch.int32, device=dev)
    perm, starts, lens = _route_batch(shl, keys)
    out, results = _apply_segment_passes(shl, op_types, keys, vals, perm,
                                         starts, lens)
    if rebalance:
        out, _ = _watermark_rebalance(out, high_water=high_water,
                                      low_water=low_water,
                                      max_shards=max_shards, seed=seed)
    return out, results


def _route_batch(shl: ShardedSkipList, keys: torch.Tensor):
    """(perm, starts, lens): the batch's stable sort by routed shard and
    each shard's segment of it, on the state's device."""
    sid = route(shl.boundaries, keys)
    perm = torch.argsort(sid, stable=True)
    starts, lens = shard_segments(sid[perm], shl.n_shards)
    return perm, starts, lens


def _apply_in_place_passes(shl: ShardedSkipList, op_types: torch.Tensor,
                           keys: torch.Tensor, vals: torch.Tensor, *,
                           high_water: float, low_water: float,
                           max_shards: int, seed
                           ) -> Tuple[ShardedSkipList, torch.Tensor]:
    """The rebalancing apply at a fixed shard axis: one clone of the state
    (the update kernel's), the exhaustion guard on it in place, the batch
    routed on the boundaries as the guard left them, the update kernel,
    then the watermark pass on the same clone.  On the card that is K12,
    K11 and K12 again, with nothing read back."""
    from repro_torch.core import rebalance_traced as rbt

    if keys.shape[0] == 0:
        return shl, torch.zeros((0,), dtype=torch.int32, device=shl.device)
    work = rbt.working_copy(shl)
    rbt.exhaustion_guard_inplace(work, op_types, keys,
                                 max_shards=max_shards, seed=seed)
    perm, starts, lens = _route_batch(work, keys)
    results = _apply_segments_inplace(work.shards, op_types, keys, vals,
                                      perm, starts, lens)
    rbt.watermark_rebalance_inplace(work, high_water=high_water,
                                    low_water=low_water,
                                    max_shards=max_shards, seed=seed)
    return work, results


def _apply_segment_passes(shl: ShardedSkipList, op_types: torch.Tensor,
                          keys: torch.Tensor, vals: torch.Tensor,
                          perm: torch.Tensor, starts: torch.Tensor,
                          lens: torch.Tensor
                          ) -> Tuple[ShardedSkipList, torch.Tensor]:
    """Run each shard's segment ``[starts[s], starts[s] + lens[s])`` of the
    route-sorted batch on a clone of the stack, in order; unsort results.
    ``perm``, ``starts`` and ``lens`` stay on the state's device."""
    shards = _clone(shl.shards)
    results = _apply_segments_inplace(shards, op_types, keys, vals, perm,
                                      starts, lens)
    return shl._replace(shards=shards), results


def _apply_segments_inplace(shards: SkipListState, op_types: torch.Tensor,
                            keys: torch.Tensor, vals: torch.Tensor,
                            perm: torch.Tensor, starts: torch.Tensor,
                            lens: torch.Tensor) -> torch.Tensor:
    """The segments on ``shards`` itself (one launch of
    ``kernels.apply_ops.apply_ops_batch`` on the card); results [B] in
    batch order."""
    res_sorted = apply_kernel.apply_ops_batch(
        shards, op_types[perm], keys[perm], vals[perm], starts, lens)
    results = torch.empty_like(keys)
    results[perm] = res_sorted
    return results


# ---------------------------------------------------------------------------
# Invariants
# ---------------------------------------------------------------------------

def check_sharded_invariant(shl: ShardedSkipList, expect_n=None
                            ) -> torch.Tensor:
    """[] bool: per-shard foresight records, boundaries sorted from
    ``KEY_MIN``, every live key inside its shard's range, and (with
    ``expect_n``) the total live count."""
    ok = torch.ones((), dtype=torch.bool, device=shl.device)
    if shl.foresight:
        for s in range(shl.n_shards):
            ok &= check_foresight_invariant(shard_view(shl.shards, s))
    b = shl.boundaries
    ok &= (b[0] == KEY_MIN) & (b[1:] >= b[:-1]).all()
    keys = shl.shards.keys
    live = (keys != KEY_MAX) & (keys != KEY_MIN)
    hi_b = torch.cat([b[1:], b.new_tensor([KEY_MAX])])[:, None]
    ok &= torch.where(live, (keys >= b[:, None]) & (keys < hi_b), True).all()
    if expect_n is not None:
        ok &= total_n(shl) == int(expect_n)
    return ok
