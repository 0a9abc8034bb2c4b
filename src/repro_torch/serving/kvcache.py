"""Paged KV-cache with a Foresight-skiplist page table (port of
``repro.serving.kvcache``).

Logical KV blocks of live sequences map to physical pages of a fixed pool.
The page table is an ordered index over the composite key ``seq_id << 12 |
block_id``: every decode step finds a sequence's pages (a batched lookup)
and eviction range-deletes them, the skiplist read / update workload the
paper accelerates.  Every index array (``rng`` included), result, free
list and page equals the reference's on the same op stream.

The table is a ``core.sharded.ShardedSkipList`` built, with ``rebalance``
on (the default), at a static ``max_shards`` ceiling (spare shards are
dead ``KEY_MAX``-boundary slots).  Every apply runs the in-place passes of
``core.rebalance_traced`` inside that ceiling, as the reference's jitted
apply does, so a seq-id-skewed burst cannot exhaust one shard while its
neighbours sit empty and the shard axis never changes length.  There is
no ``jax.jit`` here and nothing to trace; batches are still pow2-padded
with no-op reads of key 0 (no state, rng or routing effect), so that
every state array equals the reference's.

Composite keys must stay inside int31: ``alloc`` / ``lookup`` /
``release`` validate ``seq_id < MAX_SEQS`` and ``block_id <
2**BLOCK_BITS`` and raise ``ValueError`` otherwise.

Mesh: past ``mesh_min_pages`` with ``mesh_devices=0`` (auto: the world size
of the initialised default process group, 1 without one), or with
``mesh_devices >= 2``, the table is a ``core.mesh_index.MeshShardedIndex``
over the ``("index",)`` mesh of ``launch.mesh.make_index_mesh``.  The mesh
is SPMD, one process a device, and the free list is host state that every
rank must keep identical; so every rank calls each method with the same
global batch, passes its own chunk (``mesh_index.chunk``) to the
collectives and all-gathers the chunk results in rank order, trimmed to
the batch.  Each rank then sees the whole batch's results and makes the
same free-list decisions.  Per-device shard capacity is sized for the full
pool; cross-device skew is surfaced through ``load_stats``.

``use_kernel`` lookups go through ``kernels.ops.search_kernel`` (K5/K6 or
K7's split; K10 on a mesh).  The partition keeps the reference's VMEM
sizing rule (``kernels.ops.auto_shards``): the card has no VMEM, and the
rule stays only so that the partition equals the reference's.

Robustness: ``try_alloc`` is the soft-fail allocation path (a per-block
success mask, a prefix granted when the pool or a shard runs out);
``alloc`` raises on any failed grant.  Pool watermarks (``fill_fraction``
against ``high_water`` / ``low_water``) give the engine a preemption
trigger before exhaustion.  The ``chaos`` hook threads a
``runtime.chaos.FaultInjector`` into the ``kvcache.alloc`` site (forced
pool exhaustion and forced capacity failure).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import mesh_index as mshi
from repro_torch.core import sharded as shd
from repro_torch.core import skiplist as sl
from repro_torch.kernels import ops
from repro_torch.launch import mesh as lmesh
from repro_torch.runtime import chaos as rchaos

BLOCK_BITS = 12                  # up to 4096 blocks per sequence
MAX_SEQS = 1 << 18


def page_key(seq_id, block_id):
    return (seq_id << BLOCK_BITS) | block_id


@dataclasses.dataclass
class PagedCacheConfig:
    n_pages: int = 4096
    page_tokens: int = 16
    levels: int = 16
    foresight: bool = True
    use_kernel: bool = False
    n_shards: int = 1            # minimum shard count (kernel path may raise)
    rebalance: bool = True       # split/merge shards as the table evolves
    max_shards: int = 0          # static ceiling for in-place rebalancing
                                 # (0 = auto: max(8, n_shards, kernel tiling))
    seed: int = 0
    high_water: float = 0.85     # pool fill fraction: preempt above this
    low_water: float = 0.60      # ... down to this (hysteresis band)
    mesh_devices: int = 1        # 1 = single-device table; >=2 = a D-device
                                 # mesh table; 0 = auto (the default process
                                 # group's world size once n_pages crosses
                                 # mesh_min_pages)
    mesh_min_pages: int = 1 << 16  # auto-mode size threshold
    node_width: int = 1          # >1 = fat-node table layout (B keys per
                                 # node); bit-identical results


class PageTable:
    """Ordered (seq, block) -> physical page index, sharded-skiplist-backed."""

    def __init__(self, cfg: PagedCacheConfig,
                 chaos: Optional[rchaos.FaultInjector] = None, device=None):
        self.cfg = cfg
        self.chaos = chaos
        shd.validate_watermarks(cfg.high_water, cfg.low_water)
        dev = sl.resolve_device(device)
        n_shards = cfg.n_shards
        if cfg.use_kernel:
            n_shards = max(n_shards, ops.auto_shards(
                cfg.n_pages, cfg.levels, cfg.foresight,
                node_width=cfg.node_width))
        if cfg.rebalance:
            # build AT the ceiling: spare shards are the dead slots the
            # in-place splits spend
            n_shards = max(n_shards, cfg.max_shards or 8)
        cap = shd.shard_capacity_for(cfg.n_pages, n_shards, cfg.node_width)
        n_dev = cfg.mesh_devices
        if n_dev == 0:       # auto: every rank of the default process
            # group, once the table outgrows a device
            n_dev = dist.get_world_size() if (
                dist.is_initialized()
                and cfg.n_pages >= cfg.mesh_min_pages) else 1
        self.mesh = None
        self.load_stats = None   # last apply's DeviceLoadStats (mesh only)
        if n_dev > 1:
            # raises (never shrinks) when the process group is short
            self.mesh = lmesh.make_index_mesh(n_dev, device=dev)
            # capacity sized for the FULL pool on every device: a skewed
            # stream may land everything on one device's slice
            self.index = mshi.empty_mesh_index(
                n_devices=n_dev, n_shards=n_shards, capacity=cap,
                levels=cfg.levels, foresight=cfg.foresight, seed=cfg.seed,
                key_span=MAX_SEQS << BLOCK_BITS, node_width=cfg.node_width,
                device=dev)
        else:
            self.index = shd.empty_sharded(
                n_shards=n_shards, capacity=cap, levels=cfg.levels,
                foresight=cfg.foresight, seed=cfg.seed,
                node_width=cfg.node_width, device=dev)
        self.free = list(range(cfg.n_pages - 1, -1, -1))

    @property
    def device(self) -> torch.device:
        return self.index.device

    # -- the mesh's chunked collectives ------------------------------------

    def _chunk(self, lanes: torch.Tensor, fill: int = 0) -> torch.Tensor:
        return mshi.chunk(lanes, self.index.n_devices, self.index.rank, fill)

    def _joined(self, n: int, *chunks: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``[C]`` chunk results in rank order, trimmed to the
        global batch of ``n`` lanes."""
        D = self.index.n_devices
        group = self.mesh.get_group(lmesh.INDEX_AXIS)
        out = []
        for c in chunks:
            got = mshi._all_gather(c.to(torch.int32), D, group).reshape(-1)
            out.append(got[:n].to(c.dtype))
        return out

    # -- apply / search ------------------------------------------------------

    def _apply(self, ops_: torch.Tensor, keys: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
        n = ops_.shape[0]
        pad = (1 if n == 0 else 1 << int(n - 1).bit_length()) - n
        if pad:  # no-op reads of key 0: no state, RNG, or routing effect
            ops_ = torch.cat([ops_, ops_.new_full((pad,), sl.OP_READ)])
            keys = torch.cat([keys, keys.new_zeros(pad)])
            vals = torch.cat([vals, vals.new_zeros(pad)])
        if self.mesh is not None:
            self.index, res, self.load_stats = mshi.apply_ops_mesh(
                self.index, self._chunk(ops_, sl.OP_READ), self._chunk(keys),
                self._chunk(vals), mesh=self.mesh,
                rebalance=self.cfg.rebalance, seed=self.cfg.seed)
            results, = self._joined(n + pad, res)
        else:
            # in place at the ceiling, whether or not a dead slot is left
            self.index, results = shd.apply_ops_sharded(
                self.index, ops_, keys, vals, rebalance=self.cfg.rebalance,
                seed=self.cfg.seed, _in_place=True)
        return results[:n]

    def _search(self, keys: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Traversal-loop lookup on whichever table variant is live."""
        if self.mesh is not None:
            found, vals = mshi.search_mesh(self.index, self._chunk(keys),
                                           mesh=self.mesh)
            return tuple(self._joined(keys.shape[0], found, vals))
        return shd.search_sharded(self.index, keys)

    def _keys(self, seq_ids, block_ids) -> torch.Tensor:
        k = page_key(np.asarray(seq_ids, np.int64),
                     np.asarray(block_ids, np.int64)).astype(np.int32)
        return torch.from_numpy(np.atleast_1d(k)).to(self.device)

    def _validate_ids(self, seq_ids, block_ids) -> None:
        seq = np.atleast_1d(np.asarray(seq_ids, np.int64))
        blk = np.atleast_1d(np.asarray(block_ids, np.int64))
        if seq.size and (seq.min() < 0 or seq.max() >= MAX_SEQS):
            raise ValueError(
                f"seq_id out of range [0, {MAX_SEQS}): got "
                f"[{seq.min()}, {seq.max()}] — page_key would wrap negative "
                "in int32 and collide with the sentinel key space")
        if blk.size and (blk.min() < 0 or blk.max() >= (1 << BLOCK_BITS)):
            raise ValueError(
                f"block_id out of range [0, {1 << BLOCK_BITS}): got "
                f"[{blk.min()}, {blk.max()}] — blocks past 2**BLOCK_BITS "
                "alias the next sequence's key range")

    # -- allocation -----------------------------------------------------------

    def _insert_pages(self, keys: torch.Tensor, pages: np.ndarray
                      ) -> np.ndarray:
        """Insert key->page mappings; returns the LOST mask.

        A result of 0 is either an upsert of an already-mapped block (the
        mapping updated in place; counts as a success) or a capacity-failed
        insert (mapping LOST).  Lost pages go back to the free list here,
        so callers only decide how loudly to report them.
        """
        n = keys.shape[0]
        ops_ = torch.full_like(keys, sl.OP_INSERT)
        res = self._apply(ops_, keys,
                          torch.from_numpy(pages).to(self.device)).cpu()
        lost = np.zeros(n, bool)
        if not bool(res.all()):
            failed = (res == 0).numpy()
            still_absent = ~self._search(
                keys[torch.from_numpy(failed).to(self.device)])[0].cpu(
                ).numpy()
            if still_absent.any():
                lost[np.flatnonzero(failed)[still_absent]] = True
                for p in pages[lost]:
                    self.free.append(int(p))
        return lost

    def alloc(self, seq_ids: np.ndarray, block_ids: np.ndarray
              ) -> np.ndarray:
        """Allocate physical pages for (seq, block) pairs; returns pages.

        Strict path: raises on pool exhaustion or a capacity-failed insert
        (lost pages reclaimed first).  The serving plane uses ``try_alloc``.
        """
        self._validate_ids(seq_ids, block_ids)
        n = len(seq_ids)
        if n > len(self.free):
            raise RuntimeError("KV page pool exhausted")
        pages = np.array([self.free.pop() for _ in range(n)], np.int32)
        lost = self._insert_pages(self._keys(seq_ids, block_ids), pages)
        if lost.any():
            raise RuntimeError(
                f"page-table insert failed for {int(lost.sum())} block(s): "
                "shard capacity exhausted (rebalance off or shards "
                "indivisible); their pages were returned to the pool")
        return pages

    def try_alloc(self, seq_ids: np.ndarray, block_ids: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Soft-fail allocation: ``(ok_mask, pages)``, never raises on
        exhaustion.

        Grants a *prefix* of the request while pages last; a capacity-
        failed insert inside the grant flips just that block's ``ok`` off
        (its page is reclaimed).  ``pages`` holds -1 where ``ok`` is False.
        Id-range violations still raise ``ValueError``.  This is the
        ``kvcache.alloc`` chaos site: a due ``pool_exhausted`` fault forces
        a zero grant, a due ``capacity_fail`` fault fails the whole grant
        (pages reclaimed).
        """
        self._validate_ids(seq_ids, block_ids)
        n = len(seq_ids)
        ok = np.zeros(n, bool)
        pages = np.full(n, -1, np.int32)
        kinds = self.chaos.poll("kvcache.alloc") if self.chaos is not None \
            else ()
        grant = 0 if rchaos.POOL_EXHAUSTED in kinds else min(n,
                                                             len(self.free))
        if grant == 0:
            return ok, pages
        got = np.array([self.free.pop() for _ in range(grant)], np.int32)
        if rchaos.CAPACITY_FAIL in kinds:
            # forced capacity failure: mappings lost, pages reclaimed
            self.free.extend(int(p) for p in got)
            return ok, pages
        keys = self._keys(np.asarray(seq_ids)[:grant],
                          np.asarray(block_ids)[:grant])
        granted_ok = ~self._insert_pages(keys, got)
        ok[:grant] = granted_ok
        pages[:grant][granted_ok] = got[granted_ok]
        return ok, pages

    def lookup(self, seq_ids: np.ndarray, block_ids: np.ndarray
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched page lookup -> (found, physical_pages), device tensors
        (no host sync here)."""
        self._validate_ids(seq_ids, block_ids)
        keys = self._keys(seq_ids, block_ids)
        if self.cfg.use_kernel:
            if self.mesh is not None:
                r = ops.search_kernel(self.index, self._chunk(keys),
                                      mesh=self.mesh)
                return tuple(self._joined(keys.shape[0], r.found, r.vals))
            r = ops.search_kernel(self.index, keys)
            return r.found, r.vals
        return self._search(keys)

    def release(self, seq_id: int, n_blocks: int) -> int:
        """Free all pages of a finished sequence (ordered range delete)."""
        if n_blocks > (1 << BLOCK_BITS):
            raise ValueError(
                f"n_blocks={n_blocks} exceeds the {1 << BLOCK_BITS}-block "
                "per-sequence ceiling (2**BLOCK_BITS)")
        return self.release_blocks(seq_id, np.arange(n_blocks,
                                                     dtype=np.int64))

    def release_blocks(self, seq_id: int, block_ids: np.ndarray) -> int:
        """Free specific blocks of a sequence (the non-prefix counterpart
        of ``release``, for returning a partial ``try_alloc`` grant)."""
        blocks = np.atleast_1d(np.asarray(block_ids, np.int64))
        n_blocks = blocks.size
        if n_blocks == 0:
            return 0
        self._validate_ids(seq_id, blocks)
        keys = self._keys(np.full(n_blocks, seq_id), blocks)
        found, pages = self.lookup(np.full(n_blocks, seq_id), blocks)
        self._apply(torch.full_like(keys, sl.OP_DELETE), keys,
                    torch.zeros_like(keys))
        # one batched device->host copy: the free list is host state
        fnp = found.cpu().numpy().astype(bool)
        live = pages.cpu().numpy()[fnp]
        self.free.extend(int(p) for p in live.tolist())
        return int(fnp.sum())

    # -- pool pressure ---------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self.free)

    @property
    def fill_fraction(self) -> float:
        return 1.0 - len(self.free) / self.cfg.n_pages

    @property
    def above_high_water(self) -> bool:
        """Pool pressure past the preemption trigger."""
        return self.fill_fraction > self.cfg.high_water

    @property
    def below_low_water(self) -> bool:
        return self.fill_fraction <= self.cfg.low_water

    @property
    def n_live(self) -> int:
        if self.mesh is not None:
            return int(mshi.total_n_mesh(self.index, mesh=self.mesh))
        return int(shd.total_n(self.index))
