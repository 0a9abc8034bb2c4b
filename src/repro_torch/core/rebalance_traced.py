"""In-place shard rebalancing at a static ceiling (port of
``repro.core.rebalance_traced``).

The eager passes of ``core.sharded`` (``split_shard`` / ``merge_shards`` /
``_watermark_rebalance`` / ``_exhaustion_guard``) change the length of the
shard axis.  The reference runs these passes instead wherever the axis
must stay fixed: under ``jit`` and ``shard_map`` (so on every device of
the mesh index) and on a state that carries a static ceiling.  The state
is padded to ``S`` slots (``pad_shards``); dead slots hold an empty list
and a ``KEY_MAX`` boundary, so routing never selects them; a split
consumes the last (dead) slot and a merge appends a fresh one.  "Traced"
names those semantics here: in-place edits inside the ceiling, with seed
``seed + k`` for the k-th split or merge, bit-identical to the reference
on every array, result and split or merge count.

On the card every pass is one launch of ``csrc/rebalance.cu`` (K12,
``kernels.rebalance``): the loops run on the device, nothing is read back
to the host, and the split and merge counts come back as 0-d int32
tensors on the card, as the reference's traced counts are.  The guard's
presence search is one dense K3/K4 launch before it.  On the CPU the
passes run their plain versions (``watermark_plain``, ``guard_plain``,
``split_plain``, ``merge_plain``): host loops that read the shard counts
each trip and take the same branches as the reference's ``lax.while_loop``
/ ``lax.cond``.  Both run in place on a working copy; the public functions
here clone first and leave their input unchanged.

What differs from the reference, and why the results do not:

* Watermark comparisons are made in float32, as the reference's traced
  ``int32 > python float`` is.
* Ties pick the first extreme (``torch.argmax`` / ``argmin``, as ``jnp``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.sharded import (HIGH_WATER, LOW_WATER, RebalanceStats,
                                      ShardedSkipList, route, search_sharded,
                                      shard_view, validate_watermarks)
from repro_torch.core.skiplist import (KEY_MAX, NULL_VAL, OP_INSERT,
                                       SkipListState, _clone, build, empty,
                                       sorted_live_kv, usable_capacity)
from repro_torch.kernels import rebalance as rk

_I32_MAX = 2**31 - 1


class DeviceLoadStats(NamedTuple):
    """Cross-device load of the mesh index (``core.mesh_index``).

    Rebalancing on the mesh stays device-local and the device boundaries
    are fixed at build time, so sustained skew is surfaced here, never
    absorbed: the fix is a re-partition (a rebuild).
    """

    live: torch.Tensor              # [D] int32 live keys per device
    routed: torch.Tensor            # [D] int32 batch lanes routed per device
    live_imbalance: torch.Tensor    # [] float32 max / mean live (1.0 = even)
    routed_imbalance: torch.Tensor  # [] float32 max / mean routed lanes


def cross_device_load(live, routed) -> DeviceLoadStats:
    """``max(c) * D / max(sum(c), 1)`` per counter in float32; an empty
    index or batch reports 1.0."""
    live = torch.as_tensor(live).to(torch.int32)
    routed = torch.as_tensor(routed).to(torch.int32)
    D = live.shape[0]

    def ratio(c):
        tot = c.sum(dtype=torch.int32)
        r = c.max().to(torch.float32) * D / torch.clamp(tot, min=1)
        return torch.where(tot > 0, r, torch.ones_like(r))

    return DeviceLoadStats(live, routed, ratio(live), ratio(routed))


def live_shard_count(shl: ShardedSkipList) -> torch.Tensor:
    """Shards with a real (below ``KEY_MAX``) boundary, [] int32; the rest
    of the axis is split headroom."""
    return (shl.boundaries < KEY_MAX).sum(dtype=torch.int32)


def _dead_shard(capacity: int, levels: int, foresight: bool,
                node_width: int = 1, device=None) -> SkipListState:
    """One dead slot: sentinels only, seed 0, never routed to."""
    return empty(capacity, levels, foresight=foresight, seed=0,
                 node_width=node_width, device=device)


def pad_shards(shl: ShardedSkipList, max_shards: int) -> ShardedSkipList:
    """Pad the shard axis to ``max_shards`` with dead slots.

    Searches and scans are unchanged (dead slots are never routed to); the
    in-place passes get ``max_shards - S`` slots to split into.  Returns
    ``shl`` itself when it already has ``max_shards`` shards.
    """
    S, M = shl.n_shards, int(max_shards)
    if M < S:
        raise ValueError(f"max_shards={M} below current shard count {S}; "
                         "use repack(shl, n_shards=...) to shrink first")
    if M == S:
        return shl
    dead = _dead_shard(shl.shard_capacity, shl.levels, shl.foresight,
                       shl.node_width, shl.device)
    shards = SkipListState(*(
        None if full is None else torch.cat(
            [full, d[None].expand((M - S,) + d.shape)])
        for full, d in zip(shl.shards, dead)))
    boundaries = torch.cat([shl.boundaries,
                            shl.boundaries.new_full((M - S,), KEY_MAX)])
    return ShardedSkipList(shards, boundaries)


# ---------------------------------------------------------------------------
# The passes: a working copy, then one K12 launch (the plain version on CPU)
# ---------------------------------------------------------------------------

def working_copy(shl: ShardedSkipList) -> ShardedSkipList:
    """A clone of every tensor, boundaries included, for in-place passes."""
    return ShardedSkipList(_clone(shl.shards), shl.boundaries.clone())


def split_shard_traced(shl: ShardedSkipList, s, at_key, *, seed=0
                       ) -> ShardedSkipList:
    """Split shard ``s`` at ``at_key`` without changing the shard axis.

    Shards right of ``s`` shift one slot toward the tail and the last
    (dead) slot drops off; the left half keeps keys ``< at_key`` (rebuilt
    with ``seed``), the right the rest (``seed + 1``), both at build fill.
    ``s`` and ``at_key`` may be ints or 0-d tensors (on the card they stay
    there).  Preconditions, as in the reference, which its callers
    guarantee and nothing here checks: the last slot is dead and
    ``at_key`` lies inside shard ``s``'s range (halves that do not fit the
    fill mass lose keys there as they do here).
    """
    out = working_copy(shl)
    rk.rebalance_pass(out, "split", s=s, at=at_key, seed=seed)
    return out


def merge_shards_traced(shl: ShardedSkipList, s, *, seed=0
                        ) -> ShardedSkipList:
    """Merge shards ``s`` and ``s + 1`` in place (rebuilt with ``seed``);
    the shards right of them shift left and a dead slot appends.
    Preconditions (the watermark pass's): both shards are live and their
    keys fit the build-fill mass."""
    out = working_copy(shl)
    rk.rebalance_pass(out, "merge", s=s, seed=seed)
    return out


def watermark_rebalance_traced(shl: ShardedSkipList, *,
                               high_water: float = HIGH_WATER,
                               low_water: float = LOW_WATER,
                               max_shards: int = 0, seed=0
                               ) -> Tuple[ShardedSkipList, RebalanceStats]:
    """Split the fullest shard above ``high_water`` while dead slots remain
    (``seed + k`` for the k-th), then merge the adjacent live pair of least
    combined count that fits under it and has a shard below ``low_water``
    (``seed + j``); each loop runs at most ``S`` times.  The counts are
    0-d int32 tensors on the state's device."""
    out = working_copy(shl)
    stats = watermark_rebalance_inplace(out, high_water=high_water,
                                        low_water=low_water,
                                        max_shards=max_shards, seed=seed)
    return out, stats


def watermark_rebalance_inplace(shl: ShardedSkipList, *,
                                high_water: float = HIGH_WATER,
                                low_water: float = LOW_WATER,
                                max_shards: int = 0, seed=0
                                ) -> RebalanceStats:
    """``watermark_rebalance_traced`` on ``shl`` itself."""
    validate_watermarks(high_water, low_water)
    counts = rk.rebalance_pass(shl, "watermark", high_water=high_water,
                               low_water=low_water, max_shards=max_shards,
                               seed=seed)
    return RebalanceStats(counts[0], counts[1])


def exhaustion_guard_traced(shl: ShardedSkipList, op_types, keys, *,
                            max_shards: int = 0, seed=0
                            ) -> Tuple[ShardedSkipList, torch.Tensor]:
    """Split ahead of any shard this batch's new inserts would overfill.

    A shard's projection is ``n_s`` + the distinct new keys routed to it.
    Every distinct insert counts as new first; only if some shard could
    overflow is the presence search's answer used.  The worst shard splits
    at the median of its live and incoming keys (the next larger key where
    the median is the smallest), with ``seed + k``, until every projection
    fits, the dead slots run out, the keys are indivisible or ``S``
    splits ran.  Contents never change.  The split count is a 0-d int32
    tensor on the state's device.
    """
    out = working_copy(shl)
    return out, exhaustion_guard_inplace(out, op_types, keys,
                                         max_shards=max_shards, seed=seed)


def exhaustion_guard_inplace(shl: ShardedSkipList, op_types, keys, *,
                             max_shards: int = 0, seed=0) -> torch.Tensor:
    """``exhaustion_guard_traced`` on ``shl`` itself: the split count."""
    dev = shl.device
    op_types = torch.as_tensor(op_types, device=dev).to(torch.int32)
    keys = torch.as_tensor(keys, device=dev).to(torch.int32)
    if keys.shape[0] == 0:
        return torch.zeros((), dtype=torch.int32, device=dev)
    return rk.rebalance_pass(shl, "guard", op_types=op_types, keys=keys,
                             max_shards=max_shards, seed=seed)[0]


# ---------------------------------------------------------------------------
# The plain versions: host loops over fixed-shape structural edits
# ---------------------------------------------------------------------------

def _take(t: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``t[src]``; the uint32 ``rng`` is gathered as int32 bits."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32)[src].view(torch.uint32)
    return t[src]


def _place(shl: ShardedSkipList, src: torch.Tensor, slots
           ) -> SkipListState:
    """``shards[src]``, then each ``(slot, state)`` of ``slots`` written
    over its slot (a slot past the axis is dropped, as ``jnp.where``
    drops it)."""
    S = shl.n_shards
    out = SkipListState(*(None if t is None else _take(t, src)
                          for t in shl.shards))
    for slot, st in slots:
        if slot < S:
            for dst, t in zip(out, st):
                if dst is not None:
                    dst[slot].copy_(t)
    return out


def split_plain(shl: ShardedSkipList, s: int, at_key: int, *, seed=0
                ) -> ShardedSkipList:
    """The split of ``split_shard_traced`` with host indices."""
    S, dev = shl.n_shards, shl.device
    cap, L, fs, nw = (shl.shard_capacity, shl.levels, shl.foresight,
                      shl.node_width)
    shard = shard_view(shl.shards, s)
    ks, vs = sorted_live_kv(shard)
    n = int(shard.n)
    n_left = int((ks < at_key).sum())           # padding is KEY_MAX
    W = usable_capacity(cap, nw)
    idx = torch.arange(W, device=dev)
    args = dict(capacity=cap, levels=L, foresight=fs, node_width=nw,
                device=dev)
    left = build(ks[:W], vs[:W], seed=seed, valid=idx < n_left, **args)
    right = build(torch.roll(ks, -n_left)[:W], torch.roll(vs, -n_left)[:W],
                  seed=seed + 1, valid=idx < n - n_left, **args)
    i = torch.arange(S, device=dev)
    src = torch.where(i <= s, i, i - 1)          # shift right from s + 1
    boundaries = shl.boundaries[src]
    if s + 1 < S:
        boundaries[s + 1] = at_key
    return ShardedSkipList(_place(shl, src, ((s, left), (s + 1, right))),
                           boundaries)


def merge_plain(shl: ShardedSkipList, s: int, *, seed=0) -> ShardedSkipList:
    """The merge of ``merge_shards_traced`` with a host index."""
    S, dev = shl.n_shards, shl.device
    cap, L, fs, nw = (shl.shard_capacity, shl.levels, shl.foresight,
                      shl.node_width)
    a, b = shard_view(shl.shards, s), shard_view(shl.shards, s + 1)
    ka, va = sorted_live_kv(a)
    kb, vb = sorted_live_kv(b)
    na, nb = int(a.n), int(b.n)
    width = usable_capacity(cap, nw)
    i = torch.arange(width, device=dev)
    j = torch.clamp(i - na, 0, width - 1)
    ks = torch.where(i < na, ka[:width],
                     torch.where(i < na + nb, kb[j], KEY_MAX))
    vs = torch.where(i < na, va[:width],
                     torch.where(i < na + nb, vb[j], NULL_VAL))
    merged = build(ks, vs, capacity=cap, levels=L, foresight=fs, seed=seed,
                   valid=i < na + nb, node_width=nw, device=dev)
    dead = _dead_shard(cap, L, fs, nw, dev)
    i = torch.arange(S, device=dev)
    src = torch.where(i <= s, i, torch.clamp(i + 1, max=S - 1))
    boundaries = shl.boundaries[src]
    boundaries[S - 1] = KEY_MAX
    return ShardedSkipList(_place(shl, src, ((s, merged), (S - 1, dead))),
                           boundaries)


def _live(shl: ShardedSkipList) -> int:
    return int(live_shard_count(shl))


def watermark_plain(shl: ShardedSkipList, *, high_water: float,
                    low_water: float, max_shards: int, seed=0
                    ) -> Tuple[ShardedSkipList, int, int]:
    """The watermark pass's host loops: (state, splits, merges)."""
    S = shl.n_shards
    usable = usable_capacity(shl.shard_capacity, shl.node_width)
    ceil_ = rk.ceiling(S, max_shards)
    hi, lo = rk.marks(usable, high_water, low_water)
    hi_mark = torch.tensor(hi, dtype=torch.float32)
    lo_mark = torch.tensor(lo, dtype=torch.float32)
    seed = int(seed)

    splits = 0
    while splits < S and _live(shl) < ceil_:
        ns = shl.shards.n.cpu()
        ov = (ns.to(torch.float32) > hi_mark) & (ns >= 2)
        if not bool(ov.any()):
            break
        s = int(torch.argmax(torch.where(ov, ns, -1)))
        ks, _ = sorted_live_kv(shard_view(shl.shards, s))
        at = int(ks[int(ns[s]) // 2])            # median; keys are unique
        shl = split_plain(shl, s, at, seed=seed + splits)
        splits += 1

    merges = 0
    while merges < S and _live(shl) > 1:
        ns, b = shl.shards.n.cpu(), shl.boundaries.cpu()
        comb = ns[:-1] + ns[1:]
        ok = (b[1:] < KEY_MAX) & (comb.to(torch.float32) <= hi_mark) & (
            (ns[:-1].to(torch.float32) < lo_mark)
            | (ns[1:].to(torch.float32) < lo_mark))
        if not bool(ok.any()):
            break
        s = int(torch.argmin(torch.where(ok, comb, _I32_MAX)))
        shl = merge_plain(shl, s, seed=seed + merges)
        merges += 1
    return shl, splits, merges


def guard_plain(shl: ShardedSkipList, op_types, keys, *, max_shards: int,
                seed=0) -> Tuple[ShardedSkipList, int]:
    """The exhaustion guard's host loop: (state, splits)."""
    S, dev = shl.n_shards, shl.device
    usable = usable_capacity(shl.shard_capacity, shl.node_width)
    ceil_ = rk.ceiling(S, max_shards)
    op_types = torch.as_tensor(op_types, device=dev).to(torch.int32)
    keys = torch.as_tensor(keys, device=dev).to(torch.int32)
    if keys.shape[0] == 0:
        return shl, 0
    k_sorted = torch.sort(torch.where(op_types == OP_INSERT, keys,
                                      KEY_MAX)).values
    first_of_run = torch.ones_like(k_sorted, dtype=torch.bool)
    first_of_run[1:] = k_sorted[1:] != k_sorted[:-1]
    distinct = (k_sorted != KEY_MAX) & first_of_run

    def count(st, mask):
        sid = route(st.boundaries, k_sorted)
        add = torch.zeros(S, dtype=torch.int32, device=dev)
        add.index_add_(0, sid.long(), mask.to(torch.int32))
        return sid, add

    _, add0 = count(shl, distinct)
    if not bool((shl.shards.n + add0 > usable).any()):
        return shl, 0
    new_mask = distinct & ~search_sharded(shl, k_sorted)[0]
    seed = int(seed)
    splits = 0
    while splits < S:
        sid, add = count(shl, new_mask)
        proj = shl.shards.n + add
        if not (bool((proj > usable).any()) and _live(shl) < ceil_):
            break
        s = int(torch.argmax(torch.where(proj > usable, proj, -1)))
        shard = shard_view(shl.shards, s)
        live_keys, _ = sorted_live_kv(shard)     # KEY_MAX padded
        incoming = torch.where(new_mask & (sid == s), k_sorted, KEY_MAX)
        combined = torch.sort(torch.cat([live_keys, incoming])).values
        m = int(shard.n) + int(add[s])
        at, first = int(combined[m // 2]), int(combined[0])
        if at == first:                          # the median will not cut
            bigger = combined[combined > first]
            at = int(bigger.min()) if bigger.numel() else KEY_MAX
        if at >= KEY_MAX:                        # indivisible key mass
            break
        shl = split_plain(shl, s, at, seed=seed + splits)
        splits += 1
    return shl, splits
