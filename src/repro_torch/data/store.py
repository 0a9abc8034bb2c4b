"""Skiplist-indexed in-memory sample store (port of ``repro.data.store``).

Training samples live in a flat token array (``rows [N, seq_len + 1]``
int32, on the store's device); an ordered index maps sample *keys* (stable
31-bit ids) to storage rows.  The data pipeline looks samples up by key, a
batched foresight traversal, and can range-scan for shard assignment.  The
index variant (base / foresight / kernel) is selectable, as in the paper's
DBx1000 experiment, where a skiplist indexes table rows.

Every index array (``rng`` included), every result and the rows equal the
reference's for the same config and inputs: the corpus is the same numpy
draw (``_markov_corpus``), the keys stay on the host (``keys_np``) and the
index is built by the port's ``core.skiplist`` / ``core.sharded``.

Partitioning: ``n_shards=0`` keeps the reference's rule, monolithic unless
``use_kernel`` is set and the table's tile exceeds the reference's 12 MiB
VMEM budget (``kernels.ops.VMEM_BUDGET_BYTES``), then the smallest power
of two shard count whose tile fits (``kernels.ops.auto_shards``).  The card
has no VMEM and the port's kernels take a tile of any size; the rule stays
only so that the partition, and with it every state array, equals the
reference's.  With ``rebalance`` on (the default) ``apply_ops_sharded``
splits ahead of any shard an ingest batch would exhaust and re-levels the
watermarks after, and every ``repack_every`` update batches the store
repacks.  ``max_shards`` caps that growth.

Lookups: ``use_kernel`` goes through ``kernels.ops.search_kernel``: K1/K2
on a monolithic store, K3/K4 on a sharded one with ``clustered=False``,
K5/K6 (or K7's split) with ``clustered=True``; without it the eager
``search_fast`` / ``search_sharded``.  ``device=None`` means the GPU and
raises without one, as ``core.skiplist.build`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import sharded as shd
from repro_torch.core import skiplist as sl
from repro_torch.kernels import ops


@dataclasses.dataclass
class StoreConfig:
    n_samples: int = 4096
    seq_len: int = 128
    vocab: int = 256
    index_levels: int = 16
    foresight: bool = True
    use_kernel: bool = False
    n_shards: int = 0        # 0 = auto (shard only past the VMEM budget)
    clustered: bool = True   # kernel lookups through the clustered plan
                             # (K5/K6); False keeps the dense K3/K4 walk
    rebalance: bool = True   # sharded only: split/merge around skewed ingest
    max_shards: int = 0      # shard-count ceiling for rebalancing growth
                             # (0 = core.sharded.MAX_SHARDS)
    repack_every: int = 0    # update batches between amortized repacks
                             # (0 = never; sharded + rebalance only)
    seed: int = 0


class IndexedSampleStore:
    """rows: [N, seq_len+1] tokens; index: key -> row (Foresight skiplist)."""

    index: Union[sl.SkipListState, shd.ShardedSkipList]

    def __init__(self, cfg: StoreConfig, rows=None,
                 keys: Optional[np.ndarray] = None, device=None):
        """``rows`` (numpy or a tensor, ``[n_samples, seq_len + 1]``) and
        sorted unique ``keys`` (numpy) default to the reference's seeded
        draws; a tensor already on ``device`` is kept, not copied."""
        self.cfg = cfg
        dev = sl.resolve_device(device)
        rng = np.random.default_rng(cfg.seed)
        if rows is None:
            rows = _markov_corpus(rng, cfg.n_samples, cfg.seq_len + 1,
                                  cfg.vocab)
        if keys is None:
            keys = np.sort(rng.choice(2**30, cfg.n_samples, replace=False))
        self.rows = torch.as_tensor(rows, device=dev).to(torch.int32)
        self.keys_np = np.asarray(keys).astype(np.int64)
        cap = int(2 ** np.ceil(np.log2(cfg.n_samples * 2 + 4)))
        self.n_shards = cfg.n_shards
        if self.n_shards == 0:
            mono_tile = ops.tile_bytes(cfg.index_levels, cap, cfg.foresight)
            needs_shards = cfg.use_kernel and \
                mono_tile > ops.VMEM_BUDGET_BYTES
            self.n_shards = ops.auto_shards(
                cfg.n_samples, cfg.index_levels,
                cfg.foresight) if needs_shards else 1
        self._updates_since_repack = 0
        keys_t = torch.from_numpy(self.keys_np.astype(np.int32))
        row_ids = torch.arange(cfg.n_samples, dtype=torch.int32)
        if self.n_shards > 1:
            self.index = shd.build_sharded(
                keys_t, row_ids, n_shards=self.n_shards,
                levels=cfg.index_levels, foresight=cfg.foresight,
                seed=cfg.seed, device=dev)
        else:
            self.index = sl.build(
                keys_t, row_ids, capacity=cap, levels=cfg.index_levels,
                foresight=cfg.foresight, seed=cfg.seed, device=dev)

    @property
    def sharded(self) -> bool:
        return isinstance(self.index, shd.ShardedSkipList)

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def _lanes(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device).to(torch.int32)

    # -- lookups ------------------------------------------------------------

    def lookup(self, keys) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched key lookup -> (found [B], row_ids [B])."""
        keys = self._lanes(keys)
        if self.cfg.use_kernel:
            r = ops.search_kernel(self.index, keys,
                                  cluster=self.cfg.clustered)
            return r.found, r.vals
        if self.sharded:
            return shd.search_sharded(self.index, keys)
        return sl.search_fast(self.index, keys)   # preds-free read path

    def get_batch(self, keys) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fetch token rows for keys (missing keys fall back to row 0)."""
        found, row_ids = self.lookup(keys)
        safe = torch.where(found, row_ids, 0)
        return self.rows[safe.long()], found

    def range_scan(self, lo, hi, max_out: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Ordered (key, row_id) scan of [lo, hi); crosses shard boundaries."""
        if self.sharded:
            return shd.range_scan_sharded(self.index, lo, hi, max_out)
        return sl.range_scan(self.index, lo, hi, max_out)

    # -- updates (streaming ingestion) ---------------------------------------

    def _apply(self, ops_: torch.Tensor, keys: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
        if self.sharded:
            self.index, results = shd.apply_ops_sharded(
                self.index, ops_, keys, vals,
                rebalance=self.cfg.rebalance,
                max_shards=self.cfg.max_shards or shd.MAX_SHARDS,
                seed=self.cfg.seed)
            self._updates_since_repack += 1
            if (self.cfg.rebalance and self.cfg.repack_every and
                    self._updates_since_repack >= self.cfg.repack_every):
                self.index = shd.repack(self.index, seed=self.cfg.seed)
                self._updates_since_repack = 0
        else:
            self.index, results = sl.apply_ops(self.index, ops_, keys, vals)
        return results

    def ingest(self, keys, row_ids) -> torch.Tensor:
        """Insert new key->row mappings (linearized batch)."""
        keys = self._lanes(keys)
        ops_ = torch.full_like(keys, sl.OP_INSERT)
        return self._apply(ops_, keys, self._lanes(row_ids))

    def evict(self, keys) -> torch.Tensor:
        keys = self._lanes(keys)
        ops_ = torch.full_like(keys, sl.OP_DELETE)
        return self._apply(ops_, keys, torch.zeros_like(keys))


def _markov_corpus(rng: np.random.Generator, n: int, width: int,
                   vocab: int) -> np.ndarray:
    """Order-1 Markov token rows — learnable structure for train examples."""
    trans = rng.dirichlet(np.full(vocab, 0.05), size=vocab)
    cum = np.cumsum(trans, axis=1)
    out = np.empty((n, width), np.int32)
    state = rng.integers(0, vocab, size=n)
    out[:, 0] = state
    for t in range(1, width):
        u = rng.random(n)
        state = (cum[state] < u[:, None]).sum(axis=1)
        state = np.minimum(state, vocab - 1)
        out[:, t] = state
    return out
