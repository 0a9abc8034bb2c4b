"""Foresight skiplist state, bulk build and eager batched search in PyTorch.

Port of ``repro.core.skiplist``, scalar and fat-node layouts: the same
structure-of-arrays state, the same node numbering and tower heights, so
a build, search or update here is bit-identical to the JAX one on the
same inputs and seed.

* **Base** stores ``nxt [L, cap]`` pointers: a traversal step reads the
  successor pointer, then (dependently) the successor's key.
* **Foresight** stores ``fused [L, cap, 2]`` records ``(next_ptr,
  next_key)``: one read per step fetches both.

Node 0 is the head sentinel (key ``KEY_MIN``) and node 1 the tail sentinel
(key ``KEY_MAX``); keys are int32 in the open interval between them.  The
eager reads run on the card as kernels and on the CPU as their plain
versions (``*_plain``), the host loops here: ``search`` and ``contains``
as one launch of the recording walk (K14, ``kernels.search_walk``),
``search_fast`` as the K1/K2 lookup ``kernels.ops.search_kernel``.

Fat-node layout (``node_width`` = B > 1, B-Skiplist style): each node holds
a sorted run of up to B keys in ``fat_keys [cap, B]`` / ``fat_vals [cap,
B]`` (padded with ``KEY_MAX`` / ``NULL_VAL`` past ``nlen[node]`` live
lanes), ``keys[node]`` is the run's minimum and the skip structure links
nodes, unchanged in shape.  A search walks the nodes, then counts the
owner's run lanes below the query; its ``node`` is the element-flat id
``owner * B + lane``.  Builds pack runs at ``pack_fill(B) = B // 2``; a
full run splits at its median on insert and an emptied one splices out.
``n`` counts elements and ``capacity`` node slots.
"""
from __future__ import annotations

from collections import Counter
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import prng

KEY_MIN = -(2**31)          # head sentinel key (-inf)
KEY_MAX = 2**31 - 1         # tail sentinel key (+inf)
HEAD = 0                    # node id of head sentinel
TAIL = 1                    # node id of tail sentinel
NULL_VAL = -1

# ``repro``'s ctz goes through float32 ``log2`` (XLA: log(x) / log(2)),
# which lands one below the exact answer for 2**13, 2**15, 2**26, 2**27,
# 2**30 and 2**31.  Tower heights inherit that, so the port maps the exact
# ctz (index; 32 for x == 0) through the same values.
_REF_CTZ = list(range(33))
for _k, _v in ((13, 12), (15, 14), (26, 25), (27, 26), (30, 29), (31, 30)):
    _REF_CTZ[_k] = _v


class SkipListState(NamedTuple):
    """Skiplist state: tensors on one device.

    Exactly one of ``nxt`` (base) / ``fused`` (foresight) is set; the
    three fat fields are set together, and only under the fat layout.
    """

    keys: torch.Tensor                # [cap] int32 (KEY_MAX for unused)
    vals: torch.Tensor                # [cap] int32
    height: torch.Tensor              # [cap] int32 (sentinels = L)
    nxt: Optional[torch.Tensor]       # [L, cap] int32, base only
    fused: Optional[torch.Tensor]     # [L, cap, 2] int32, foresight only
    n: torch.Tensor                   # [] int32 live elements
    free_top: torch.Tensor            # [] int32
    free_list: torch.Tensor           # [cap] int32
    bump: torch.Tensor                # [] int32 next never-used slot
    rng: torch.Tensor                 # [2] uint32 threefry key
    fat_keys: Optional[torch.Tensor] = None   # [cap, B] int32, fat only
    fat_vals: Optional[torch.Tensor] = None   # [cap, B] int32, fat only
    nlen: Optional[torch.Tensor] = None       # [cap] int32 live run lanes

    @property
    def levels(self) -> int:
        arr = self.nxt if self.nxt is not None else self.fused
        return arr.shape[0]

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def foresight(self) -> bool:
        return self.fused is not None

    @property
    def node_width(self) -> int:
        # shape[-1], so it also answers on stacked (sharded) states
        return 1 if self.fat_keys is None else self.fat_keys.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.keys.device


def resolve_device(device) -> torch.device:
    """``None`` means the GPU; without one that raises, never falls back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to build "
                               "on the CPU")
        return torch.device("cuda")
    return torch.device(device)


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def pack_fill(node_width: int) -> int:
    """Elements packed per node at build time: 1 on the scalar layout."""
    return max(1, node_width // 2)


def node_slots_for(n_elems: int, node_width: int) -> int:
    """Node slots that hold ``n_elems`` elements at build fill (>= 1)."""
    return max(1, -(-n_elems // pack_fill(node_width)))


def usable_capacity(capacity: int, node_width: int = 1) -> int:
    """Insertable elements at ``capacity`` node slots: every slot but the
    two sentinels, at build fill (``capacity - 2`` on the scalar layout)."""
    return (capacity - 2) * pack_fill(node_width)


def empty(capacity: int, levels: int = 20, *, foresight: bool = True,
          seed: int = 0, node_width: int = 1, device=None) -> SkipListState:
    """An empty skiplist with ``capacity`` node slots (two are sentinels)."""
    dev = resolve_device(device)
    st = allocate((), capacity, levels, foresight=foresight,
                  node_width=node_width, device=dev)
    fill_empty(st, levels)
    st.rng.copy_(prng.PRNGKey(seed, device=dev))
    return st


def allocate(lead: Tuple[int, ...], capacity: int, levels: int, *,
             foresight: bool, node_width: int = 1, device) -> SkipListState:
    """Uninitialised state tensors, each with the leading axes ``lead``.

    ``lead == ()`` is one list; ``(S,)`` the stacked state of ``S`` shards.
    """
    i32 = dict(dtype=torch.int32, device=device)
    vec = lambda: torch.empty(lead + (capacity,), **i32)
    scalar = lambda: torch.empty(lead, **i32)
    table = lead + (levels, capacity)
    runs = lambda: torch.empty(lead + (capacity, node_width), **i32)
    fat = node_width > 1
    return SkipListState(
        keys=vec(), vals=vec(), height=vec(),
        nxt=None if foresight else torch.empty(table, **i32),
        fused=torch.empty(table + (2,), **i32) if foresight else None,
        n=scalar(), free_top=scalar(), free_list=vec(), bump=scalar(),
        rng=torch.empty(lead + (2,), dtype=torch.uint32, device=device),
        fat_keys=runs() if fat else None, fat_vals=runs() if fat else None,
        nlen=vec() if fat else None)


def fill_empty(st: SkipListState, levels: int) -> None:
    """Write the empty list into ``st``'s tensors in place (all but ``rng``).

    Works on any leading axes, so one call empties every shard of a stack.
    """
    if st.fat_keys is not None:
        st.fat_keys.fill_(KEY_MAX)
        st.fat_vals.fill_(NULL_VAL)
        st.nlen.zero_()
    st.keys.fill_(KEY_MAX)
    st.keys[..., HEAD] = KEY_MIN
    st.vals.fill_(NULL_VAL)
    st.height.zero_()
    st.height[..., [HEAD, TAIL]] = levels
    if st.fused is not None:
        st.fused.zero_()
        st.fused[..., [HEAD, TAIL], :] = torch.tensor(
            [TAIL, KEY_MAX], dtype=torch.int32, device=st.keys.device)
    else:
        st.nxt.zero_()
        st.nxt[..., [HEAD, TAIL]] = TAIL
    st.n.zero_()
    st.free_top.zero_()
    st.free_list.zero_()
    st.bump.fill_(2)


def sample_heights(rng: torch.Tensor, shape, levels: int) -> torch.Tensor:
    """Geometric(1/2) tower heights in [1, levels] (Synchrobench's G(1/2))."""
    bits = prng.bits(rng, shape).to(torch.int64)
    # height = 1 + number of trailing one-bits, capped at levels.
    ctz = _count_trailing_zeros(~bits & 0xFFFFFFFF)
    return torch.clamp(ctz + 1, max=levels)


def _count_trailing_zeros(x: torch.Tensor) -> torch.Tensor:
    """ctz of uint32 values (32 for x == 0), as ``repro`` computes it.

    ``x`` holds the values in any integer dtype; the result is int32.
    """
    x = x.to(torch.int64)
    lsb = x & -x
    exact = torch.frexp(lsb.to(torch.float64)).exponent.to(torch.int64) - 1
    exact = torch.where(x == 0, 32, exact)
    return torch.tensor(_REF_CTZ, dtype=torch.int32, device=x.device)[exact]


def build(keys, vals, *, capacity: int, levels: int = 20,
          foresight: bool = True, seed: int = 0, valid=None,
          node_width: int = 1, device=None) -> SkipListState:
    """Bulk-build from sorted, unique int32 keys.

    Elements get node ids ``2 .. n+1`` in key order.  On every level ``l``
    the nodes whose tower reaches ``l`` form the linked list, each pointing
    at the next such node (the tail after the last).  ``valid`` (optional,
    [n] bool) marks real entries; invalid positions must form a suffix and
    are built as height-0, never-linked padding.  ``node_width`` > 1 packs
    the elements into runs of ``pack_fill(node_width)`` and links the run
    minima instead (``build_into``).

    ``keys`` / ``vals`` / ``valid`` may be numpy arrays or tensors; they
    are moved to ``device`` (``None``: the GPU).
    """
    dev = resolve_device(device)
    keys = torch.as_tensor(keys, device=dev)
    slots = -(-keys.shape[0] // pack_fill(node_width))
    if slots + 2 > capacity:
        raise ValueError(f"capacity {capacity} must exceed the {slots} "
                         "node slots the keys pack into + 2 sentinels")
    st = empty(capacity, levels, foresight=foresight, seed=seed,
               node_width=node_width, device=dev)
    build_into(st, keys, vals, valid)
    return st


def build_into(st: SkipListState, keys, vals, valid=None) -> None:
    """Bulk-build into the fresh empty list ``st``, in place (``build``).

    ``st`` holds ``empty``'s arrays and the seed's key; its tensors may be
    views into a stacked (sharded) state.  Its ``rng`` advances by one
    split, as the reference's build does.  Under the fat layout the
    elements reshape into ``[nodes, pack_fill]`` runs (the last padded
    with ``KEY_MAX``) and the node level is built over the run minima with
    ``NULL_VAL`` node vals; dead trailing nodes (an all-invalid run) come
    out as height-0 padding, which the bump allocator reuses.  ``n``
    counts the elements; ``bump`` stays where the node build left it.
    """
    dev = st.device
    keys = torch.as_tensor(keys, device=dev).to(torch.int32)
    vals = torch.as_tensor(vals, device=dev).to(torch.int32)
    if valid is not None:
        valid = torch.as_tensor(valid, device=dev).to(torch.bool)
        keys = torch.where(valid, keys, KEY_MAX)
        vals = torch.where(valid, vals, NULL_VAL)
    if st.fat_keys is None:
        _link_nodes(st, keys, vals, valid)
        return
    fill = pack_fill(st.node_width)
    n_in = keys.shape[0]
    n_nodes = -(-n_in // fill)
    pad = n_nodes * fill - n_in
    runs_k = torch.cat([keys, keys.new_full((pad,), KEY_MAX)]
                       ).reshape(n_nodes, fill)
    runs_v = torch.cat([vals, vals.new_full((pad,), NULL_VAL)]
                       ).reshape(n_nodes, fill)
    node_valid = (None if valid is None else
                  torch.cat([valid, valid.new_zeros(pad)])[::fill])
    _link_nodes(st, runs_k[:, 0], keys.new_full((n_nodes,), NULL_VAL),
                node_valid)
    n_live = (valid.sum(dtype=torch.int32) if valid is not None
              else torch.full((), n_in, dtype=torch.int32, device=dev))
    st.fat_keys[2:n_nodes + 2, :fill] = runs_k
    st.fat_vals[2:n_nodes + 2, :fill] = runs_v
    first = torch.arange(n_nodes, dtype=torch.int32, device=dev) * fill
    st.nlen[2:n_nodes + 2] = torch.clamp(n_live - first, 0, fill)
    st.n.copy_(n_live)


def _link_nodes(st: SkipListState, keys: torch.Tensor, vals: torch.Tensor,
                valid: Optional[torch.Tensor]) -> None:
    """The scalar build of ``keys`` (already ``KEY_MAX`` where invalid)
    into node ids ``2 .. n+1`` of ``st``, in place.

    The reference's links, one level at a time: position ``i``'s successor
    on level ``l`` is the first position ``j > i`` whose tower reaches
    ``l`` (a reversed cumulative minimum), the head's the first at all.
    Nothing is read back to the host.
    """
    levels = st.levels
    n = keys.shape[0]
    dev = st.device
    rng, sub = prng.split(st.rng)
    heights = sample_heights(sub, (n,), levels)
    if valid is not None:
        heights = torch.where(valid, heights, 0)   # padding: no tower, no links
    n_live = (valid.sum(dtype=torch.int32) if valid is not None
              else torch.full((), n, dtype=torch.int32, device=dev))

    st.keys[2:n + 2] = keys
    st.vals[2:n + 2] = vals
    st.height[2:n + 2] = heights
    table = st.fused if st.foresight else st.nxt
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    for lvl in range(levels):
        reach = heights > lvl
        # first reaching position at or after each position (n: none)
        first = torch.flip(torch.cummin(torch.flip(
            torch.where(reach, pos, n), [0]), 0).values, [0])
        succ = torch.cat([first[1:], first.new_full((1,), n)])
        head = first[:1] if n else pos.new_full((1,), n)
        ids, nkeys = _link_targets(torch.cat([head, succ]), keys, n)
        if st.foresight:
            rec = torch.stack([ids, nkeys], dim=1)
            table[lvl, HEAD] = rec[0]
            row = table[lvl, 2:n + 2]
            row.copy_(torch.where(reach[:, None], rec[1:], row))
        else:
            table[lvl, HEAD] = ids[0]
            row = table[lvl, 2:n + 2]
            row.copy_(torch.where(reach, ids[1:], row))
    st.n.copy_(n_live)
    st.bump.copy_(n_live + 2)
    st.rng.copy_(rng)


def _link_targets(succ_pos: torch.Tensor, keys: torch.Tensor, n: int):
    """(node id, key) of successor positions (``n``: the tail)."""
    tail = succ_pos >= n
    ids = torch.where(tail, TAIL, succ_pos + 2).to(torch.int32)
    nkeys = (keys[succ_pos.clamp(max=n - 1).long()] if n
             else torch.zeros_like(succ_pos))
    return ids, torch.where(tail, KEY_MAX, nkeys).to(torch.int32)


# ---------------------------------------------------------------------------
# Gather helpers: the base-vs-foresight distinction
# ---------------------------------------------------------------------------

def _gather_fused(fused: torch.Tensor, lvl: torch.Tensor, x: torch.Tensor):
    """ONE gather: (next_ptr, next_key) of nodes ``x`` at levels ``lvl``."""
    cap = fused.shape[1]
    rec = fused.view(-1, 2)[lvl.long() * cap + x.long()]     # [B, 2]
    return rec[:, 0], rec[:, 1]


def _gather_base(nxt: torch.Tensor, keys: torch.Tensor, lvl: torch.Tensor,
                 x: torch.Tensor):
    """TWO dependent gathers: next_ptr, then that node's key."""
    cap = nxt.shape[1]
    ptr = nxt.view(-1)[lvl.long() * cap + x.long()]            # gather 1
    return ptr, keys[ptr.long()]                               # gather 2


def _gather(state: SkipListState, lvl: torch.Tensor, x: torch.Tensor):
    if state.foresight:
        return _gather_fused(state.fused, lvl, x)
    return _gather_base(state.nxt, state.keys, lvl, x)


# ---------------------------------------------------------------------------
# Batched level-synchronous search (the paper's Algorithm 1 / 2, vectorized)
# ---------------------------------------------------------------------------

class SearchResult(NamedTuple):
    found: torch.Tensor     # [B] bool
    vals: torch.Tensor      # [B] int32 (NULL_VAL when absent)
    node: torch.Tensor      # [B] int32 node holding the key (TAIL if absent)
    preds: torch.Tensor     # [B, L] int32 last node visited per level
    steps: torch.Tensor     # [] int32 lock-step iterations executed
    gathers: torch.Tensor   # [] int32 dependent-gather count


def _search_loop(state: SkipListState, q: torch.Tensor, stop_level: int):
    """The level-synchronous loop: (x, preds, steps, gathers)."""
    B, L = q.shape[0], state.levels
    i32 = dict(dtype=torch.int32, device=q.device)
    x = torch.zeros((B,), **i32)                  # start at head
    lvl = torch.full((B,), L - 1, **i32)
    preds = torch.zeros((B, L), **i32)
    steps = torch.zeros((), **i32)
    gathers = torch.zeros((), **i32)
    g = 1 if state.foresight else 2
    while bool((lvl >= stop_level).any()):
        active = lvl >= stop_level
        safe_lvl = lvl.clamp(min=0)
        ptr, fk = _gather(state, safe_lvl, x)
        go_right = active & (fk < q)
        # On descend, record the predecessor for the level being left.
        desc = active & ~go_right
        _scatter_rows(preds, safe_lvl, x, desc)
        x = torch.where(go_right, ptr, x)
        lvl = torch.where(desc, lvl - 1, lvl)
        steps += 1
        gathers += g * active.sum(dtype=torch.int32)
    return x, preds, steps, gathers


def search(state: SkipListState, queries: torch.Tensor, *,
           stop_level: int = 0) -> SearchResult:
    """Batched search for int32 ``queries`` [B] on the state's device.

    Level-synchronous: every query advances right or descends once per
    lock-step iteration.  Foresight needs ONE dependent gather per
    iteration; base needs TWO.  ``preds`` records the last node visited
    per level (the predecessors array updates use); ``steps`` and
    ``gathers`` count the lock-step loop's iterations and dependent
    gathers.  Under the fat layout the walk is over nodes and ``node`` is
    the element-flat id ``owner * node_width + lane`` (``TAIL`` when
    absent).  Runs through ``kernels.search_walk.search_walk``: on the
    card one launch of the recording walk (K14), nothing read back; on
    the CPU ``search_plain``.
    """
    from repro_torch.kernels.search_walk import search_walk

    q = torch.as_tensor(queries, device=state.device).to(torch.int32)
    return search_walk(state, q.contiguous(), stop_level=stop_level)


def search_plain(state: SkipListState, queries: torch.Tensor, *,
                 stop_level: int = 0) -> SearchResult:
    """``search``'s host loop (K14's plain version): one lock-step
    iteration of tensor ops a step, a flag read back after each."""
    q = torch.as_tensor(queries, device=state.device).to(torch.int32)
    x, preds, steps, gathers = _search_loop(state, q, stop_level)
    # The candidate is the successor of the level-``stop_level`` predecessor.
    cand, cand_key = _gather(state, torch.full_like(q, stop_level), x)
    if state.fat_keys is not None:
        found, vals, node = _fat_lookup(state, q, x, cand, cand_key)
        return SearchResult(found, vals, torch.where(found, node, TAIL),
                            preds, steps, gathers)
    found = cand_key == q
    vals = torch.where(found, state.vals[cand.long()], NULL_VAL)
    node = torch.where(found, cand, TAIL)
    return SearchResult(found, vals, node, preds, steps, gathers)


def _fat_resolve_batch(state: SkipListState, q: torch.Tensor,
                       x: torch.Tensor, cand: torch.Tensor,
                       cand_key: torch.Tensor):
    """Owner node and run position of fat-layout queries [B]:
    (owner, pos, pos_c, found).

    ``x`` is the level-0 predecessor node and ``cand`` its successor.  The
    query's run is ``cand``'s when it equals that run's minimum or nothing
    precedes it (``x`` is the head), else ``x``'s; ``pos`` counts the run's
    lanes below the query, over all ``node_width`` lanes.
    """
    owner = torch.where((cand_key == q) | (x == HEAD), cand, x)
    return (owner, *run_position(state.fat_keys, owner.long(), q))


def run_position(fat_rows: torch.Tensor, rows: torch.Tensor,
                 q: torch.Tensor):
    """(pos, pos_c, found) of queries ``q`` [B] in the runs
    ``fat_rows[rows]`` (``fat_rows`` is ``[R, node_width]``): the lanes
    below the query, that count clamped to the last lane, and whether the
    key there is the query."""
    Bw = fat_rows.shape[-1]
    run = fat_rows[rows]                                  # [B, Bw]
    pos = (run < q[:, None]).sum(dim=1, dtype=torch.int32)
    pos_c = pos.clamp(max=Bw - 1)
    hit = run.gather(1, pos_c.long()[:, None])[:, 0]
    return pos, pos_c, (pos < Bw) & (hit == q)


def _fat_lookup(state: SkipListState, q, x, cand, cand_key):
    """(found, vals, element-flat node ``owner * B + pos_c``) of a fat
    search whose walk ended at ``x``."""
    owner, _, pos_c, found = _fat_resolve_batch(state, q, x, cand, cand_key)
    flat = owner * state.node_width + pos_c
    vals = torch.where(found, state.fat_vals.reshape(-1)[flat.long()],
                       NULL_VAL)
    return found, vals, flat


def contains(state: SkipListState, queries: torch.Tensor) -> torch.Tensor:
    return search(state, queries).found


def effective_top_level(state: SkipListState) -> torch.Tensor:
    """Highest level where the head has a real successor (+1 slack), [] int32.

    Starting traversals here instead of at L-1 skips the empty upper levels.
    """
    head_next = (state.fused[:, HEAD, 0] if state.foresight
                 else state.nxt[:, HEAD])
    lv = torch.arange(state.levels, dtype=torch.int32, device=state.device)
    top = torch.where(head_next != TAIL, lv, -1).max()
    return torch.clamp(top + 1, max=state.levels - 1).to(torch.int32)


def search_fast(state: SkipListState, queries: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Read-only lookup: (found [B], vals [B]).

    Versus ``search``: no predecessor tracking, and the loop starts at the
    effective top level.  On the card this is the K1/K2 lookup
    (``kernels.ops.search_kernel``, K9 on the fat layout): the start level
    does not change the level-0 predecessor, so the answers are the
    same.  On the CPU ``search_fast_plain``.  Element ids past int32 are
    refused on either device (``kernels.ops.check_index_range``).
    """
    from repro_torch.kernels import ops

    ops.check_index_range(state.levels, state.capacity, 1, state.node_width)
    q = torch.as_tensor(queries, device=state.device).to(torch.int32)
    if state.keys.device.type == "cpu":
        return search_fast_plain(state, q)
    found, vals, _ = ops.search_kernel(state, q.contiguous())
    return found, vals


def search_fast_plain(state: SkipListState, queries: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``search_fast``'s host loop (its plain version)."""
    q = torch.as_tensor(queries, device=state.device).to(torch.int32)
    x = torch.zeros_like(q)
    lvl = effective_top_level(state).expand(q.shape[0])
    while bool((lvl >= 0).any()):
        active = lvl >= 0
        ptr, fk = _gather(state, lvl.clamp(min=0), x)
        go = active & (fk < q)
        x = torch.where(go, ptr, x)
        lvl = torch.where(go | ~active, lvl, lvl - 1)
    cand, ck = _gather(state, torch.zeros_like(q), x)
    if state.fat_keys is not None:
        return _fat_lookup(state, q, x, cand, ck)[:2]
    found = ck == q
    return found, torch.where(found, state.vals[cand.long()], NULL_VAL)


def _scatter_rows(preds: torch.Tensor, lvl: torch.Tensor, x: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """preds[b, lvl[b]] = x[b] where mask[b], in place (returns ``preds``)."""
    rows = torch.nonzero(mask).squeeze(1)
    preds[rows, lvl[rows].long()] = x[rows]
    return preds


# ---------------------------------------------------------------------------
# Single-element insert / delete
# ---------------------------------------------------------------------------
#
# ``repro`` updates functionally: every update returns a new state and the
# old one stays readable, which ``core.versioned`` relies on to keep stale
# versions for mixed-view reads.  Here the public ``insert`` / ``delete`` /
# ``apply_ops`` never modify their input state either: each clones the
# state's tensors once (``apply_ops`` once per batch) and then updates the
# clone in place, on the card with the update kernel
# (``kernels.apply_ops``), on the CPU op by op through the ``_*_inplace``
# helpers below, its plain version.
#
# The reference is branch-free (``jnp.where`` over every level, with
# out-of-range scatters dropped); the port branches on the host instead and
# writes only what changes, which gives the same arrays.  In particular an
# insert into a full list (free list empty, ``bump == capacity``) writes
# nothing: its would-be node id is ``capacity``, which must never index.

def _clone(state: SkipListState) -> SkipListState:
    return SkipListState(*(None if t is None else t.clone() for t in state))


def _to_i32(v) -> int:
    """A key or value as the int32 the reference casts it to (wrapping)."""
    return int(torch.as_tensor(v).to(torch.int32))


def _alloc(state: SkipListState) -> Tuple[int, bool]:
    """Pop a node id from the free list, else bump, in place: (id, ok).

    With neither (free list empty, ``bump == capacity``) it returns
    ``(capacity, False)`` and changes nothing.  With ``free_top`` past
    ``capacity`` (pushes onto a full free list are dropped) the pop reads
    the last slot, ``free_list[capacity - 1]``, as the reference's clamped
    gather does.
    """
    top = int(state.free_top)
    if top > 0:
        state.free_top.sub_(1)
        return int(state.free_list[min(top, state.capacity) - 1]), True
    bump = int(state.bump)
    if bump < state.capacity:
        state.bump.add_(1)
    return bump, bump < state.capacity


def _locate(state: SkipListState, key: int):
    """(found, node, preds [L]) of one key, through ``search_plain``."""
    res = search_plain(state, torch.tensor([key], dtype=torch.int32,
                                           device=state.device))
    return bool(res.found[0]), int(res.node[0]), res.preds[0].long()


def _splice_node(state: SkipListState, nid: int, nkey: int, h: int,
                 preds: torch.Tensor) -> None:
    """Link node ``nid`` (key ``nkey``, height ``h``) after ``preds`` on
    levels ``0 .. h-1``, in place.

    The new node inherits each predecessor's successor; under foresight
    the predecessor gets the pair (new node, key), both halves at once.
    """
    lv = torch.arange(h, device=state.device)   # the levels to splice
    p = preds[:h]
    if state.foresight:
        state.fused[lv, nid] = state.fused[lv, p]
        state.fused[lv, p] = torch.tensor([nid, nkey], dtype=torch.int32,
                                          device=state.device)
    else:
        state.nxt[lv, nid] = state.nxt[lv, p]
        state.nxt[lv, p] = nid
    state.keys[nid] = nkey
    state.height[nid] = h


def _unsplice_node(state: SkipListState, d: int, preds: torch.Tensor
                   ) -> None:
    """Unlink node ``d`` from ``preds`` and push it on the free list, in
    place: each predecessor takes over ``d``'s record at that level.  A
    push onto a full free list is dropped, as the reference's scatter is;
    the stale records stay until reuse."""
    h = int(state.height[d])
    lv = torch.arange(h, device=state.device)
    table = state.fused if state.foresight else state.nxt
    table[lv, preds[:h]] = table[lv, d]
    top = int(state.free_top)
    if top < state.capacity:
        state.free_list[top] = d
    state.free_top.add_(1)
    state.keys[d] = KEY_MAX
    state.height[d] = 0


def _insert_inplace(state: SkipListState, key: int, val: int) -> bool:
    """Insert (upsert) into ``state``'s own tensors; True iff the key is new.

    The rng key advances on every call, as in the reference: after an
    upsert and after an insert that finds no free slot too.  It is written
    in place like every other field, so ``state`` may be a view of one
    shard of a stacked state.
    """
    if state.fat_keys is not None:
        return _fat_insert_inplace(state, key, val)
    found, node, preds = _locate(state, key)
    rng, sub = prng.split(state.rng)
    state.rng.copy_(rng)
    if found:                                   # upsert: overwrite the value
        state.vals[node] = val
        return False
    nid, ok = _alloc(state)
    if not ok:
        return False
    _splice_node(state, nid, key, int(sample_heights(sub, (), state.levels)),
                 preds)
    state.vals[nid] = val
    state.n.add_(1)
    return True


def _delete_inplace(state: SkipListState, key: int) -> bool:
    """Delete from ``state``'s own tensors; True iff the key was there."""
    if state.fat_keys is not None:
        return _fat_delete_inplace(state, key)
    found, d, preds = _locate(state, key)
    if not found:
        return False
    _unsplice_node(state, d, preds)
    state.n.sub_(1)
    return True


# ---------------------------------------------------------------------------
# Fat-layout single-element updates (node_width > 1)
# ---------------------------------------------------------------------------
#
# The reference picks a case with ``lax.switch`` and writes every case's
# arrays through ``jnp.where``; here the host picks the case and writes only
# what it changes, which gives the same arrays.  A failed allocation (free
# list empty, ``bump == capacity``) writes nothing but the advanced rng: the
# reference's writes at node id ``capacity`` are dropped.

# How often each case ran in this process (``chip_smoke.py`` reports it).
FAT_CASES: Counter = Counter()


def _fat_locate(state: SkipListState, key: int):
    """(owner, pos, present, preds [L], x) of one key in a fat list."""
    q = torch.tensor([key], dtype=torch.int32, device=state.device)
    x, preds, _, _ = _search_loop(state, q, 0)
    cand, ck = _gather(state, torch.zeros_like(q), x)
    owner, pos, _, present = _fat_resolve_batch(state, q, x, cand, ck)
    owner, pos, present, x = torch.stack(
        [owner[0], pos[0], present[0].to(torch.int32), x[0]]).tolist()
    return owner, pos, bool(present), preds[0].long(), x


def _set_node_min(state: SkipListState, owner: int, new_min: int,
                  preds: torch.Tensor) -> None:
    """Make ``new_min`` node ``owner``'s routing key, and the foreseen key
    of every record in ``preds`` that points at it.

    ``preds`` is the predecessor chain of the owner's old or new minimum,
    so the records pointing at ``owner`` are exactly the stale ones.
    """
    state.keys[owner] = new_min
    if state.foresight:
        lv = torch.arange(state.levels, device=state.device)
        fix = state.fused[lv, preds, 0] == owner
        state.fused[lv[fix], preds[fix], 1] = new_min


def _shift_in(row_k: torch.Tensor, row_v: torch.Tensor, p: int, key: int,
              val: int) -> None:
    """Insert (key, val) at lane ``p`` of a run, shifting the lanes from
    ``p`` up by one (the last lane falls off), in place."""
    row_k[p + 1:] = row_k[p:-1].clone()
    row_v[p + 1:] = row_v[p:-1].clone()
    row_k[p] = key
    row_v[p] = val


def _fat_insert_inplace(state: SkipListState, key: int, val: int) -> bool:
    """Fat-layout insert into ``state``'s own tensors: (0) value upsert,
    (1) shift into a run with room, (2) median split of a full run, (3)
    the first node of an empty list.  True iff the key is new.

    The rng advances and a tower height is drawn on every call, before the
    case is chosen.  A new global minimum (``x`` is the head) also becomes
    its run's routing key.
    """
    Bw = state.node_width
    half = Bw // 2
    owner, pos, present, preds, x = _fat_locate(state, key)
    rng, sub = prng.split(state.rng)
    state.rng.copy_(rng)
    at_front = x == HEAD and not present
    if present:
        FAT_CASES["insert_upsert"] += 1
        state.fat_vals[owner, min(pos, Bw - 1)] = val
        return False
    if owner == TAIL:
        FAT_CASES["insert_first"] += 1
        nid, ok = _alloc(state)
        if not ok:
            return False
        _splice_node(state, nid, key,
                     int(sample_heights(sub, (), state.levels)), preds)
        state.fat_keys[nid] = KEY_MAX
        state.fat_vals[nid] = NULL_VAL
        state.fat_keys[nid, 0] = key
        state.fat_vals[nid, 0] = val
        state.nlen[nid] = 1
        state.n.add_(1)
        return True
    if int(state.nlen[owner]) < Bw:
        FAT_CASES["insert_room"] += 1
        _shift_in(state.fat_keys[owner], state.fat_vals[owner], pos, key,
                  val)
        state.nlen[owner] += 1
        state.n.add_(1)
        if at_front:
            _set_node_min(state, owner, key, preds)
        return True
    FAT_CASES["insert_split"] += 1
    nid, ok = _alloc(state)
    if not ok:
        return False
    run_k = state.fat_keys[owner].clone()
    run_v = state.fat_vals[owner].clone()
    new_min = int(run_k[half])
    # The median's predecessors: its level-0 one is the owner itself, so
    # the new node lands after the owner and ``preds`` stays valid.
    _, preds2, _, _ = _search_loop(
        state, torch.tensor([new_min], dtype=torch.int32,
                            device=state.device), 0)
    _splice_node(state, nid, new_min,
                 int(sample_heights(sub, (), state.levels)),
                 preds2[0].long())
    lo_k, hi_k = state.fat_keys[owner], state.fat_keys[nid]
    lo_v, hi_v = state.fat_vals[owner], state.fat_vals[nid]
    for row, run, pad in ((lo_k, run_k, KEY_MAX), (lo_v, run_v, NULL_VAL),
                          (hi_k, run_k, KEY_MAX), (hi_v, run_v, NULL_VAL)):
        row.fill_(pad)
    lo_k[:half], lo_v[:half] = run_k[:half], run_v[:half]
    hi_k[:Bw - half], hi_v[:Bw - half] = run_k[half:], run_v[half:]
    if key < new_min:                       # == is impossible: not present
        _shift_in(lo_k, lo_v, pos, key, val)
        state.nlen[owner], state.nlen[nid] = half + 1, Bw - half
    else:
        _shift_in(hi_k, hi_v, pos - half, key, val)
        state.nlen[owner], state.nlen[nid] = half, Bw - half + 1
    state.n.add_(1)
    if at_front:
        _set_node_min(state, owner, key, preds)
    return True


def _fat_delete_inplace(state: SkipListState, key: int) -> bool:
    """Fat-layout delete from ``state``'s own tensors: shift the lane out
    of its run; a run left empty splices its node out to the free list,
    and a run that lost its minimum gets a new routing key.  True iff the
    key was there.

    ``KEY_MAX`` is "there" (the tail's row holds it): its delete lowers
    ``n`` and ``nlen[TAIL]`` below 0, as the reference's does.
    """
    Bw = state.node_width
    owner, pos, present, preds, _ = _fat_locate(state, key)
    if not present:
        return False
    for row, pad in ((state.fat_keys[owner], KEY_MAX),
                     (state.fat_vals[owner], NULL_VAL)):
        row[pos:Bw - 1] = row[pos + 1:].clone()
        row[Bw - 1] = pad
    new_len = int(state.nlen[owner]) - 1
    state.nlen[owner] = new_len
    state.n.sub_(1)
    if new_len == 0:
        FAT_CASES["delete_emptied"] += 1
        _unsplice_node(state, owner, preds)
    elif new_len > 0 and pos == 0:
        FAT_CASES["delete_min"] += 1
        _set_node_min(state, owner, int(state.fat_keys[owner, 0]), preds)
    else:
        FAT_CASES["delete_plain"] += 1
    return True


def insert(state: SkipListState, key, val) -> Tuple[SkipListState,
                                                    torch.Tensor]:
    """Insert (upsert) one key: (new state, inserted_new [] bool).

    ``state`` is left unchanged.  A full list (no free slot) inserts
    nothing and reports False; the rng key still advances.  A batch of
    one through ``apply_ops``.
    """
    st, res = apply_ops(state, OP_INSERT, key, val)
    return st, res[0] != 0


def delete(state: SkipListState, key) -> Tuple[SkipListState, torch.Tensor]:
    """Delete one key: (new state, deleted [] bool).  ``state`` is left
    unchanged.  A batch of one through ``apply_ops``."""
    st, res = apply_ops(state, OP_DELETE, key, 0)
    return st, res[0] != 0


# ---------------------------------------------------------------------------
# Batched (linearized) update application
# ---------------------------------------------------------------------------

OP_READ, OP_INSERT, OP_DELETE = 0, 1, 2


def host_ops(op_types, keys, vals) -> List[List[int]]:
    """The three op arrays as host lists of int32 values."""
    return [torch.as_tensor(a).to(torch.int32).cpu().tolist()
            for a in (op_types, keys, vals)]


def apply_ops_inplace(st: SkipListState, op_types: List[int],
                      keys: List[int], vals: List[int]) -> List[int]:
    """Run host-list ops on ``st``'s own tensors in order; per-op 0/1.

    As ``lax.switch`` does, an op type below 0 runs as a read and one
    above 2 as a delete.  A read touches neither the state nor its rng.
    """
    results = []
    for t, k, v in zip(op_types, keys, vals):
        t = min(max(t, OP_READ), OP_DELETE)
        if t == OP_READ:
            ok = _locate(st, k)[0]
        elif t == OP_INSERT:
            ok = _insert_inplace(st, k, v)
        else:
            ok = _delete_inplace(st, k)
        results.append(int(ok))
    return results


def apply_ops(state: SkipListState, op_types, keys, vals
              ) -> Tuple[SkipListState, torch.Tensor]:
    """Apply a linearized batch of mixed ops: (new state, results [B] int32).

    ``results`` is each op's outcome as 0/1: found (read), inserted new
    (insert), deleted (delete).  The batch linearizes in order, like the
    reference's ``lax.scan``.  ``state`` is left unchanged: its tensors are
    cloned once for the batch and the clone is updated in place.

    The batch runs through ``kernels.apply_ops.apply_ops_batch`` on a
    leading-1 view of the clone: on the card one launch of the update
    kernel, on the CPU the host loop ``apply_ops_inplace``.
    """
    from repro_torch.kernels.apply_ops import apply_ops_batch

    dev = state.device
    op_types, keys, vals = (
        torch.as_tensor(a, device=dev).to(torch.int32).reshape(-1)
        .contiguous() for a in (op_types, keys, vals))
    st = _clone(state)
    i32 = dict(dtype=torch.int32, device=dev)
    results = apply_ops_batch(_stack_of_one(st), op_types, keys, vals,
                              torch.zeros((1,), **i32),
                              torch.full((1,), keys.shape[0], **i32))
    return st, results


# ---------------------------------------------------------------------------
# Introspection / invariants
# ---------------------------------------------------------------------------

def check_foresight_invariant(state: SkipListState) -> torch.Tensor:
    """True iff every live fused record has next_key == keys[next_ptr].

    Checked one level at a time (the reference gathers the whole table at
    once, which at 27 levels x 2^26 slots would need ~30 GB of
    temporaries); the answer is the same [] bool.
    """
    if not state.foresight:
        raise ValueError("check_foresight_invariant needs a foresight state")
    ok = torch.ones((), dtype=torch.bool, device=state.device)
    for lvl in range(state.levels):
        ptr, fk = state.fused[lvl].unbind(1)
        live = state.height > lvl
        live[HEAD] = True
        ok &= torch.where(live, fk == state.keys[ptr.long()], True).all()
    return ok


def check_fat_invariant(state: SkipListState) -> torch.Tensor:
    """[] bool: the fat layout's invariants.

    A live node's routing key is its run's first lane; runs ascend
    strictly over their live lanes; lanes past ``nlen`` hold ``KEY_MAX``;
    live nodes are non-empty, others have ``nlen`` 0, and the live lane
    counts sum to ``n``.
    """
    if state.fat_keys is None:
        raise ValueError("check_fat_invariant needs a fat-layout state")
    cap, Bw = state.fat_keys.shape
    fk = state.fat_keys
    ids = torch.arange(cap, device=state.device)
    live = (ids >= 2) & (state.height > 0)
    in_run = torch.arange(Bw, device=state.device)[None, :] < \
        state.nlen[:, None]
    ok = torch.where(live, fk[:, 0] == state.keys, True).all()
    ok &= torch.where(in_run[:, 1:], fk[:, 1:] > fk[:, :-1], True).all()
    ok &= torch.where(in_run, True, fk == KEY_MAX).all()
    ok &= torch.where(live, state.nlen, 0).sum() == state.n
    ok &= torch.where(live, state.nlen >= 1, state.nlen == 0).all()
    return ok


def sorted_live_kv(state: SkipListState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Live (key, val) pairs in key order, padded to ``capacity - 2``
    (``(capacity - 2) * node_width`` under the fat layout).

    Unused, deleted and tail slots hold ``KEY_MAX`` and the head
    ``KEY_MIN``, so one stable sort puts the live run at positions
    ``1 .. n``; everything past ``state.n`` is padding.  Fat: all lanes
    sort flat; the sentinels' rows are ``KEY_MAX`` too, so the live
    elements come first.  The sort must be stable there: the tail row's
    vals can differ (a ``KEY_MAX`` upsert writes one).
    """
    cap = state.capacity
    if state.fat_keys is not None:
        flat_k = state.fat_keys.reshape(-1)
        order = torch.argsort(flat_k, stable=True)
        w = (cap - 2) * state.node_width
        return flat_k[order][:w], state.fat_vals.reshape(-1)[order][:w]
    order = torch.argsort(state.keys, stable=True)
    return state.keys[order][1:cap - 1], state.vals[order][1:cap - 1]


def _level0_record(state: SkipListState, x: int) -> Tuple[int, int]:
    """(next_ptr, next_key) of node ``x`` on level 0."""
    if state.foresight:
        ptr, key = state.fused[0, x].tolist()
        return ptr, key
    ptr = int(state.nxt[0, x])
    return ptr, int(state.keys[ptr])


def to_sorted_keys(state: SkipListState, max_n: int) -> torch.Tensor:
    """Walk level 0 and return keys in order (KEY_MAX padded), for tests:
    ``max_n`` steps of ``kernels.range_scan.range_scan_batch`` (on the
    card one launch, nothing read back)."""
    from repro_torch.kernels import range_scan as rs

    q = rs.bound_lanes(KEY_MIN, state.device)
    return rs.range_scan_batch(_stack_of_one(state), None, q, q, max_n,
                               raw=True)[0][0]


def to_sorted_keys_plain(state: SkipListState, max_n: int) -> torch.Tensor:
    """``to_sorted_keys``' host loop (the scan kernel's plain version)."""
    out, x = [], HEAD
    for _ in range(max_n):
        x, key = _level0_record(state, x)
        out.append(key)
    return torch.tensor(out, dtype=torch.int32, device=state.device)


def _stack_of_one(state: SkipListState) -> SkipListState:
    return SkipListState(*(None if t is None else t.unsqueeze(0)
                           for t in state))


def range_scan(state: SkipListState, lo, hi, max_out: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to ``max_out`` (key, val) pairs with lo <= key < hi.

    Positions with a search for ``lo``, then walks level 0 (the fat layout
    walks a (node, lane) cursor).  Returns (keys [max_out], vals
    [max_out], count []); unused slots hold KEY_MAX / NULL_VAL.  Runs
    through ``kernels.range_scan.range_scan_batch``: on the card one
    launch, with nothing read back; on the CPU ``range_scan_plain``.
    """
    from repro_torch.kernels import range_scan as rs

    dev = state.device
    k, v, c = rs.range_scan_batch(_stack_of_one(state), None,
                                  rs.bound_lanes(lo, dev),
                                  rs.bound_lanes(hi, dev), max_out)
    return k[0], v[0], c[0]


def range_scan_plain(state: SkipListState, lo, hi, max_out: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``range_scan``'s host loop (the scan kernel's plain version)."""
    lo, hi = _to_i32(lo), _to_i32(hi)
    if state.fat_keys is not None:
        return _fat_range_scan(state, lo, hi, max_out)
    res = search_plain(state, torch.tensor([lo], dtype=torch.int32,
                                           device=state.device))
    x = int(res.preds[0, 0])                  # level-0 predecessor of lo
    keys_out, vals_out = [], []
    while len(keys_out) < max_out:
        ptr, key = _level0_record(state, x)
        if not lo <= key < hi:                # the reference stops here too
            break
        keys_out.append(key)
        vals_out.append(int(state.vals[ptr]))
        x = ptr
    return scan_result(keys_out, vals_out, max_out, state.device)


def scan_result(keys_out: List[int], vals_out: List[int], max_out: int,
                device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(keys [max_out], vals [max_out], count []) of a range scan's pairs,
    padded with KEY_MAX / NULL_VAL."""
    count = len(keys_out)
    pad = max_out - count
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.tensor(keys_out + [KEY_MAX] * pad, **i32),
            torch.tensor(vals_out + [NULL_VAL] * pad, **i32),
            torch.tensor(count, **i32))


def fat_scan_step(run, lane: int, width: int, lo: int, hi: int,
                  taken: List[Tuple[int, int]], max_out: int):
    """One step of a fat range scan's (node, lane) cursor: (at_end, stop).

    ``run`` is the node's (keys, vals) as host lists.  The cursor emits a
    live lane in ``[lo, hi)`` into ``taken`` while there is room; it is at
    the run's end on ``KEY_MAX`` padding or past the last lane, and a live
    lane at or past ``hi`` stops the scan.
    """
    k = run[0][min(lane, width - 1)]
    at_end = k == KEY_MAX or lane >= width
    if not at_end and lo <= k < hi and len(taken) < max_out:
        taken.append((k, run[1][min(lane, width - 1)]))
    return at_end, not at_end and k >= hi


def _fat_range_scan(state: SkipListState, lo: int, hi: int, max_out: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fat-layout range scan: a (node, lane) cursor walk from the level-0
    predecessor node of ``lo`` (its run may straddle ``lo``), lane by
    lane, hopping to the next node at a run's end, until the tail's
    self-loop, a key at or past ``hi``, or ``max_out`` pairs.  Like the
    reference it runs at most ``2 * max_out + node_width + 4`` steps.
    """
    Bw = state.node_width
    x, _, _, _ = _search_loop(state, torch.tensor(
        [lo], dtype=torch.int32, device=state.device), 0)
    node, lane, taken = int(x[0]), 0, []
    run, ptr = _fat_row(state, node)
    for _ in range(2 * max_out + Bw + 4):
        at_end, stop = fat_scan_step(run, lane, Bw, lo, hi, taken, max_out)
        if (at_end and ptr == node) or stop or len(taken) >= max_out:
            break
        if at_end:                          # hop to the next node
            node, lane = ptr, 0
            run, ptr = _fat_row(state, node)
        else:
            lane += 1
    return scan_result([k for k, _ in taken], [v for _, v in taken],
                       max_out, state.device)


def _fat_row(state: SkipListState, node: int):
    """((run keys, run vals) as host lists, level-0 successor) of a node."""
    return ((state.fat_keys[node].tolist(), state.fat_vals[node].tolist()),
            _level0_record(state, node)[0])
