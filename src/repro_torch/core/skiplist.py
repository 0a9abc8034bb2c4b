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

from typing import NamedTuple, Optional, Tuple

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

def empty(capacity: int, levels: int = 20, *, foresight: bool = True,
          seed: int = 0, node_width: int = 1, device=None) -> SkipListState:
    """An empty skiplist with room for ``capacity - 2`` elements."""
    if node_width > 1:
        raise NotImplementedError(_FAT_TODO)
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    keys = torch.full((capacity,), KEY_MAX, **i32)
    keys[HEAD] = KEY_MIN
    height = torch.zeros((capacity,), **i32)
    height[[HEAD, TAIL]] = levels
    nxt = fused = None
    if foresight:
        fused = torch.zeros((levels, capacity, 2), **i32)
        fused[:, [HEAD, TAIL]] = torch.tensor([TAIL, KEY_MAX], **i32)
    else:
        nxt = torch.zeros((levels, capacity), **i32)
        nxt[:, [HEAD, TAIL]] = TAIL
    scalar = lambda v: torch.tensor(v, **i32)
    return SkipListState(
        keys=keys, vals=torch.full((capacity,), NULL_VAL, **i32),
        height=height, nxt=nxt, fused=fused, n=scalar(0), free_top=scalar(0),
        free_list=torch.zeros((capacity,), **i32), bump=scalar(2),
        rng=prng.PRNGKey(seed, device=dev))


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
    keys = torch.as_tensor(keys, device=dev).to(torch.int32)
    vals = torch.as_tensor(vals, device=dev).to(torch.int32)
    n = keys.shape[0]
    if n + 2 > capacity:
        raise ValueError(f"capacity {capacity} must exceed n + 2 = {n + 2}")
    st = empty(capacity, levels, foresight=foresight, seed=seed, device=dev)
    rng, sub = prng.split(st.rng)
    heights = sample_heights(sub, (n,), levels)
    if valid is not None:
        valid = torch.as_tensor(valid, device=dev).to(torch.bool)
        heights = torch.where(valid, heights, 0)   # padding: no tower, no links
        keys = torch.where(valid, keys, KEY_MAX)
        vals = torch.where(valid, vals, NULL_VAL)
    n_live = n if valid is None else int(valid.sum())

    # The build fills the fresh tables of ``st`` in place.
    st.keys[2:n + 2] = keys
    st.vals[2:n + 2] = vals
    st.height[2:n + 2] = heights
    table = st.fused if foresight else st.nxt
    for lvl in range(levels):
        # The head and each node reaching this level point at the next
        # node reaching it; the last one points at the tail.
        pos = torch.nonzero(heights > lvl).squeeze(1)      # ascending
        rows = torch.cat([pos.new_tensor([HEAD]), pos + 2])
        ids = torch.cat([pos + 2, pos.new_tensor([TAIL])]).to(torch.int32)
        nkey = torch.cat([keys[pos], keys.new_tensor([KEY_MAX])])
        if foresight:
            table[lvl, rows] = torch.stack([ids, nkey], dim=1)
        else:
            table[lvl, rows] = ids
    return st._replace(n=torch.tensor(n_live, dtype=torch.int32, device=dev),
                       bump=torch.tensor(n_live + 2, dtype=torch.int32,
                                         device=dev),
                       rng=rng)


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
