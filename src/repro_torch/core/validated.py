"""Optimistic Validation (the paper's Algorithm 3), port of ``repro.core.validated``.

A published version is internally consistent, so plain foresight search is
safe on it.  A reader whose fused table is stale while the authoritative
key table has moved on (``core.versioned``'s mixed view) may see a foreseen
key that disagrees with the actual key of the node its pointer references:
the paper's torn ``(next, next_key)`` read.

* levels >= 1: advance on the foreseen key, but only if the pointee's
  authoritative key agrees (else descend: the paper's ``break``);
* level 0: foresight is not used; decide on the authoritative key alone.

For any corruption of the foreseen-key lane the answers equal a base search
on the authoritative state.  ``search_validated`` runs K14 on the card
(``kernels.search_walk``) and its plain version on the CPU; K8
(``kernels.validated_traverse``) is the capped kernel form of the
traversal that ``VersionedIndex.search(use_kernel=True)`` takes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.skiplist import NULL_VAL, TAIL, SearchResult, _scatter_rows


def search_validated(fused: torch.Tensor, auth_keys: torch.Tensor,
                     vals: torch.Tensor, queries) -> SearchResult:
    """Algorithm 3, batched and level-synchronous, on ``fused``'s device.

    ``fused`` [L, cap, 2] may carry stale or corrupt foreseen keys; its
    pointer lanes must form a valid linked structure over ``auth_keys``.
    ``gathers`` counts 2 per active lane per step (the fused record and
    the validation read).  ``node`` is the key's node where found, else 1.
    Runs through ``kernels.search_walk.search_walk_validated``: on the card
    the key pass and one launch of the recording walk (K14), nothing read
    back; on the CPU ``search_validated_plain``.
    """
    from repro_torch.kernels.search_walk import search_walk_validated

    q = torch.as_tensor(queries, device=fused.device).to(torch.int32)
    return search_walk_validated(fused, auth_keys, vals, q.contiguous())


def search_validated_plain(fused: torch.Tensor, auth_keys: torch.Tensor,
                           vals: torch.Tensor, queries) -> SearchResult:
    """``search_validated``'s host loop (K14's plain version)."""
    q = torch.as_tensor(queries, device=fused.device).to(torch.int32)
    B = q.shape[0]
    L, cap, _ = fused.shape
    flat = fused.reshape(-1, 2)
    i32 = dict(dtype=torch.int32, device=q.device)
    x = torch.zeros((B,), **i32)
    lvl = torch.full((B,), L - 1, **i32)
    preds = torch.zeros((B, L), **i32)
    steps = torch.zeros((), **i32)
    gathers = torch.zeros((), **i32)
    while bool((lvl >= 0).any()):
        active = lvl >= 0
        safe_lvl = lvl.clamp(min=0)
        rec = flat[safe_lvl.long() * cap + x.long()]
        ptr, fk = rec[:, 0], rec[:, 1]
        valid = auth_keys[ptr.long()] < q              # validation read
        go = active & torch.where(lvl == 0, valid, (fk < q) & valid)
        desc = active & ~go
        _scatter_rows(preds, safe_lvl, x, desc)
        x = torch.where(go, ptr, x)
        lvl = torch.where(desc, lvl - 1, lvl)
        steps += 1
        gathers += 2 * active.sum(dtype=torch.int32)
    cand = flat[x.long(), 0]                           # level-0 successor
    found = auth_keys[cand.long()] == q
    out_vals = torch.where(found, vals[cand.long()], NULL_VAL)
    node = torch.where(found, cand, TAIL)
    return SearchResult(found, out_vals, node, preds, steps, gathers)


class PredValidation(NamedTuple):
    ok: torch.Tensor          # [B] bool, every relevant level consistent
    bad_level: torch.Tensor   # [B] int32 lowest failing level (or -1)


def validate_preds(fused: torch.Tensor, auth_keys: torch.Tensor,
                   preds: torch.Tensor, heights: torch.Tensor,
                   queries) -> PredValidation:
    """Post-search predecessor/successor validation for modifying ops.

    At every level below ``heights[b]`` the predecessor's authoritative key
    must be < q and its successor's >= q.  A Premature Descent during a
    stale-view search shows up as a violation here; the caller then falls
    back to a strong search on the fresh state.
    """
    q = torch.as_tensor(queries, device=fused.device).to(torch.int32)[:, None]
    L, cap, _ = fused.shape
    lvls = torch.arange(L, dtype=torch.int32, device=fused.device)[None, :]
    pk = auth_keys[preds.long()]
    succ = fused.reshape(-1, 2)[lvls.long() * cap + preds.long(), 0]
    sk = auth_keys[succ.long()]
    relevant = lvls < heights[:, None]
    level_ok = ~relevant | ((pk < q) & (sk >= q))
    ok = level_ok.all(dim=1)
    bad_level = torch.where(level_ok, L, lvls).min(dim=1).values
    return PredValidation(ok, torch.where(ok, -1, bad_level))
