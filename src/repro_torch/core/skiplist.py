"""Foresight skiplist state, bulk build and eager batched search in PyTorch.

Port of ``repro.core.skiplist`` (scalar layout, ``node_width == 1``): the
same structure-of-arrays state, the same node numbering and tower heights,
so a build or search here is bit-identical to the JAX one on the same
inputs and seed.

* **Base** stores ``nxt [L, cap]`` pointers: a traversal step reads the
  successor pointer, then (dependently) the successor's key.
* **Foresight** stores ``fused [L, cap, 2]`` records ``(next_ptr,
  next_key)``: one read per step fetches both.

Node 0 is the head sentinel (key ``KEY_MIN``) and node 1 the tail sentinel
(key ``KEY_MAX``); keys are int32 in the open interval between them.  The
search functions here are plain tensor code that runs wherever the state
lives; ``kernels.ops.search_kernel`` is the hand-written-kernel lookup.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import prng

KEY_MIN = -(2**31)          # head sentinel key (-inf)
KEY_MAX = 2**31 - 1         # tail sentinel key (+inf)
HEAD = 0                    # node id of head sentinel
TAIL = 1                    # node id of tail sentinel
NULL_VAL = -1

_FAT_TODO = ("node_width > 1 (the fat-node layout) is not ported yet: "
             "ROADMAP.md Queue 1, fat-node layout")

# ``repro``'s ctz goes through float32 ``log2`` (XLA: log(x) / log(2)),
# which lands one below the exact answer for 2**13, 2**15, 2**26, 2**27,
# 2**30 and 2**31.  Tower heights inherit that, so the port maps the exact
# ctz (index; 32 for x == 0) through the same values.
_REF_CTZ = list(range(33))
for _k, _v in ((13, 12), (15, 14), (26, 25), (27, 26), (30, 29), (31, 30)):
    _REF_CTZ[_k] = _v


class SkipListState(NamedTuple):
    """Skiplist state: tensors on one device.

    Exactly one of ``nxt`` (base) / ``fused`` (foresight) is set.
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
    """Insertable elements at ``capacity`` slots: ``capacity - 2`` on the
    scalar layout (every slot but the two sentinels)."""
    return (capacity - 2) * pack_fill(node_width)


def empty(capacity: int, levels: int = 20, *, foresight: bool = True,
          seed: int = 0, node_width: int = 1, device=None) -> SkipListState:
    """An empty skiplist with room for ``capacity - 2`` elements."""
    if node_width > 1:
        raise NotImplementedError(_FAT_TODO)
    dev = resolve_device(device)
    st = allocate((), capacity, levels, foresight=foresight, device=dev)
    fill_empty(st, levels)
    st.rng.copy_(prng.PRNGKey(seed, device=dev))
    return st


def allocate(lead: Tuple[int, ...], capacity: int, levels: int, *,
             foresight: bool, device) -> SkipListState:
    """Uninitialised state tensors, each with the leading axes ``lead``.

    ``lead == ()`` is one list; ``(S,)`` the stacked state of ``S`` shards.
    """
    i32 = dict(dtype=torch.int32, device=device)
    vec = lambda: torch.empty(lead + (capacity,), **i32)
    scalar = lambda: torch.empty(lead, **i32)
    table = lead + (levels, capacity)
    return SkipListState(
        keys=vec(), vals=vec(), height=vec(),
        nxt=None if foresight else torch.empty(table, **i32),
        fused=torch.empty(table + (2,), **i32) if foresight else None,
        n=scalar(), free_top=scalar(), free_list=vec(), bump=scalar(),
        rng=torch.empty(lead + (2,), dtype=torch.uint32, device=device))


def fill_empty(st: SkipListState, levels: int) -> None:
    """Write the empty list into ``st``'s tensors in place (all but ``rng``).

    Works on any leading axes, so one call empties every shard of a stack.
    """
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
    are built as height-0, never-linked padding.

    ``keys`` / ``vals`` / ``valid`` may be numpy arrays or tensors; they
    are moved to ``device`` (``None``: the GPU).
    """
    if node_width > 1:
        raise NotImplementedError(_FAT_TODO)
    dev = resolve_device(device)
    keys = torch.as_tensor(keys, device=dev)
    if keys.shape[0] + 2 > capacity:
        raise ValueError(f"capacity {capacity} must exceed n + 2 = "
                         f"{keys.shape[0] + 2}")
    st = empty(capacity, levels, foresight=foresight, seed=seed, device=dev)
    build_into(st, keys, vals, valid)
    return st


def build_into(st: SkipListState, keys, vals, valid=None) -> None:
    """Bulk-build into the fresh empty list ``st``, in place (``build``).

    ``st`` holds ``empty``'s arrays and the seed's key; its tensors may be
    views into a stacked (sharded) state.  Its ``rng`` advances by one
    split, as the reference's build does.
    """
    dev, levels = st.device, st.levels
    keys = torch.as_tensor(keys, device=dev).to(torch.int32)
    vals = torch.as_tensor(vals, device=dev).to(torch.int32)
    n = keys.shape[0]
    rng, sub = prng.split(st.rng)
    heights = sample_heights(sub, (n,), levels)
    if valid is not None:
        valid = torch.as_tensor(valid, device=dev).to(torch.bool)
        heights = torch.where(valid, heights, 0)   # padding: no tower, no links
        keys = torch.where(valid, keys, KEY_MAX)
        vals = torch.where(valid, vals, NULL_VAL)
    n_live = n if valid is None else int(valid.sum())

    st.keys[2:n + 2] = keys
    st.vals[2:n + 2] = vals
    st.height[2:n + 2] = heights
    table = st.fused if st.foresight else st.nxt
    for lvl in range(levels):
        # The head and each node reaching this level point at the next
        # node reaching it; the last one points at the tail.
        pos = torch.nonzero(heights > lvl).squeeze(1)      # ascending
        rows = torch.cat([pos.new_tensor([HEAD]), pos + 2])
        ids = torch.cat([pos + 2, pos.new_tensor([TAIL])]).to(torch.int32)
        nkey = torch.cat([keys[pos], keys.new_tensor([KEY_MAX])])
        if st.foresight:
            table[lvl, rows] = torch.stack([ids, nkey], dim=1)
        else:
            table[lvl, rows] = ids
    st.n.fill_(n_live)
    st.bump.fill_(n_live + 2)
    st.rng.copy_(rng)


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
    per level (the predecessors array updates use).
    """
    q = torch.as_tensor(queries, device=state.device).to(torch.int32)
    x, preds, steps, gathers = _search_loop(state, q, stop_level)
    # The candidate is the successor of the level-``stop_level`` predecessor.
    cand, cand_key = _gather(state, torch.full_like(q, stop_level), x)
    found = cand_key == q
    vals = torch.where(found, state.vals[cand.long()], NULL_VAL)
    node = torch.where(found, cand, TAIL)
    return SearchResult(found, vals, node, preds, steps, gathers)


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
    effective top level.
    """
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
# clone in place op by op through the ``_*_inplace`` helpers.
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
    ``(capacity, False)`` and changes nothing.
    """
    top = int(state.free_top)
    if top > 0:
        state.free_top.sub_(1)
        return int(state.free_list[top - 1]), True
    bump = int(state.bump)
    if bump < state.capacity:
        state.bump.add_(1)
    return bump, bump < state.capacity


def _locate(state: SkipListState, key: int):
    """(found, node, preds [L]) of one key, through the eager ``search``."""
    res = search(state, torch.tensor([key], dtype=torch.int32,
                                     device=state.device))
    return bool(res.found[0]), int(res.node[0]), res.preds[0].long()


def _insert_inplace(state: SkipListState, key: int, val: int) -> bool:
    """Insert (upsert) into ``state``'s own tensors; True iff the key is new.

    The rng key advances on every call, as in the reference: after an
    upsert and after an insert that finds no free slot too.  It is written
    in place like every other field, so ``state`` may be a view of one
    shard of a stacked state.
    """
    found, node, preds = _locate(state, key)
    rng, sub = prng.split(state.rng)
    state.rng.copy_(rng)
    if found:                                   # upsert: overwrite the value
        state.vals[node] = val
        return False
    nid, ok = _alloc(state)
    if not ok:
        return False
    h = int(sample_heights(sub, (), state.levels))
    lv = torch.arange(h, device=state.device)   # the levels to splice
    p = preds[:h]
    if state.foresight:
        # The new node inherits each predecessor's (next_ptr, next_key)
        # pair; the predecessor gets (new node, key), both halves at once.
        state.fused[lv, nid] = state.fused[lv, p]
        state.fused[lv, p] = torch.tensor([nid, key], dtype=torch.int32,
                                          device=state.device)
    else:
        state.nxt[lv, nid] = state.nxt[lv, p]
        state.nxt[lv, p] = nid
    state.keys[nid] = key
    state.vals[nid] = val
    state.height[nid] = h
    state.n.add_(1)
    return True


def _delete_inplace(state: SkipListState, key: int) -> bool:
    """Delete from ``state``'s own tensors; True iff the key was there.

    Each predecessor takes over the deleted node's pair at that level.  The
    slot goes on the free list; its stale records stay until reuse.
    """
    found, d, preds = _locate(state, key)
    if not found:
        return False
    h = int(state.height[d])
    lv = torch.arange(h, device=state.device)
    table = state.fused if state.foresight else state.nxt
    table[lv, preds[:h]] = table[lv, d]
    state.free_list[int(state.free_top)] = d
    state.free_top.add_(1)
    state.keys[d] = KEY_MAX
    state.height[d] = 0
    state.n.sub_(1)
    return True


def insert(state: SkipListState, key, val) -> Tuple[SkipListState,
                                                    torch.Tensor]:
    """Insert (upsert) one key: (new state, inserted_new [] bool).

    ``state`` is left unchanged.  A full list (no free slot) inserts
    nothing and reports False; the rng key still advances.
    """
    st = _clone(state)
    ok = _insert_inplace(st, _to_i32(key), _to_i32(val))
    return st, torch.tensor(ok, device=state.device)


def delete(state: SkipListState, key) -> Tuple[SkipListState, torch.Tensor]:
    """Delete one key: (new state, deleted [] bool).  ``state`` is left
    unchanged."""
    st = _clone(state)
    ok = _delete_inplace(st, _to_i32(key))
    return st, torch.tensor(ok, device=state.device)


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

    The ops run one after another on the host, each through the eager
    ``search`` with its per-step host sync, so an op costs milliseconds on
    a card at large sizes.
    """
    st = _clone(state)
    results = apply_ops_inplace(st, *host_ops(op_types, keys, vals))
    return st, torch.tensor(results, dtype=torch.int32, device=st.device)


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


def sorted_live_kv(state: SkipListState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Live (key, val) pairs in key order, padded to ``capacity - 2``.

    Unused, deleted and tail slots hold ``KEY_MAX`` and the head
    ``KEY_MIN``, so one stable sort puts the live run at positions
    ``1 .. n``; everything past ``state.n`` is padding.
    """
    cap = state.capacity
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
    """Walk level 0 and return keys in order (KEY_MAX padded), for tests."""
    out, x = [], HEAD
    for _ in range(max_n):
        x, key = _level0_record(state, x)
        out.append(key)
    return torch.tensor(out, dtype=torch.int32, device=state.device)


def range_scan(state: SkipListState, lo, hi, max_out: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to ``max_out`` (key, val) pairs with lo <= key < hi.

    Positions with a search for ``lo``, then walks level 0.  Returns (keys
    [max_out], vals [max_out], count []); unused slots hold KEY_MAX /
    NULL_VAL.
    """
    lo, hi = _to_i32(lo), _to_i32(hi)
    res = search(state, torch.tensor([lo], dtype=torch.int32,
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
    count = len(keys_out)
    pad = max_out - count
    i32 = dict(dtype=torch.int32, device=state.device)
    return (torch.tensor(keys_out + [KEY_MAX] * pad, **i32),
            torch.tensor(vals_out + [NULL_VAL] * pad, **i32),
            torch.tensor(count, **i32))
