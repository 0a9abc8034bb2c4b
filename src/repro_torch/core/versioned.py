"""Versioned index with mixed-view reads, port of ``repro.core.versioned``.

Readers issue batched searches against a published version while an update
batch is folded into the next one.  The paper's hazard window, a traversal
that sees a ``(next, next_key)`` pair whose halves belong to different
moments, appears as a reader whose fused table and authoritative key table
straddle a version boundary:

* ``publish`` installs a new version (monotonic version counter);
* ``read_view(lag)`` returns a *mixed* view: fused records from version
  ``t - lag``, authoritative keys and values from version ``t``;
* plain foresight search runs only on an unmixed view; a mixed view goes
  through Optimistic Validation (``search_validated``, or K8 with
  ``use_kernel=True``).

Old versions stay readable because an update never modifies its input
state: ``apply_ops`` clones the state once per batch (the reference relies
on JAX arrays being immutable for the same thing).  Each kept version is a
full copy of the state, about 15.6 GB at 27 levels x 2^26 slots; dropping
the oldest beyond ``history`` is the reclamation.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from repro_torch.core import skiplist as sl
from repro_torch.core.validated import search_validated
from repro_torch.kernels.ops import check_index_range
from repro_torch.kernels.validated_traverse import validated_traverse


class IndexView(NamedTuple):
    fused: torch.Tensor       # possibly stale fused records [L, cap, 2]
    auth_keys: torch.Tensor   # authoritative keys [cap]
    vals: torch.Tensor        # authoritative payloads [cap]
    mixed: bool               # True: must use validated search


class VersionedIndex:
    """Host-side version manager around the skiplist state."""

    def __init__(self, state: sl.SkipListState, history: int = 4):
        if not state.foresight:
            raise ValueError("VersionedIndex requires the foresight variant")
        self._versions: List[sl.SkipListState] = [state]
        self._history = history
        self.version = 0

    @property
    def current(self) -> sl.SkipListState:
        return self._versions[-1]

    def publish(self, state: sl.SkipListState) -> int:
        self._versions.append(state)
        if len(self._versions) > self._history:
            self._versions.pop(0)          # reclaim the oldest version
        self.version += 1
        return self.version

    def read_view(self, lag: int = 0) -> IndexView:
        lag = min(lag, len(self._versions) - 1)
        stale = self._versions[-1 - lag]
        cur = self._versions[-1]
        return IndexView(fused=stale.fused, auth_keys=cur.keys,
                         vals=cur.vals, mixed=lag > 0)

    def search(self, queries, *, lag: int = 0,
               use_kernel: bool = False) -> sl.SearchResult:
        """Batched search; validated automatically iff the view is mixed.

        With ``use_kernel`` a mixed view runs K8 and returns, as the
        reference does, the raw level-0 candidate as ``node`` (not TAIL
        where absent), ``preds`` as zeros [B, 1] and ``steps`` and
        ``gathers`` as 0.
        """
        view = self.read_view(lag)
        if not view.mixed:
            return sl.search(self.current, queries)
        if not use_kernel:
            return search_validated(view.fused, view.auth_keys, view.vals,
                                    queries)
        L, cap, _ = view.fused.shape
        check_index_range(L, cap)
        q = torch.as_tensor(queries, device=view.fused.device).to(torch.int32)
        node, ck = validated_traverse(view.fused, view.auth_keys, q)
        found = ck == q
        vals = torch.where(found, view.vals[node.long()], sl.NULL_VAL)
        zero = torch.zeros((), dtype=torch.int32, device=q.device)
        return sl.SearchResult(found, vals, node,
                               torch.zeros((q.shape[0], 1), dtype=torch.int32,
                                           device=q.device), zero, zero)

    def update(self, op_types, keys, vals) -> torch.Tensor:
        """Fold a linearized op batch into a new version and publish it."""
        new_state, results = sl.apply_ops(self.current, op_types, keys, vals)
        self.publish(new_state)
        return results
