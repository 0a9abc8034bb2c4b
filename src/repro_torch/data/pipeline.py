"""Deterministic, shardable data pipeline over the indexed sample store
(port of ``repro.data.pipeline``).

Key derivation is a pure function of (seed, step, position), in numpy and
bit-identical to the reference: every host computes its own shard of the
batch with no coordination, and restart at step k reproduces the exact
stream (data determinism across restarts and across host counts).  The
batch's lookups and row gathers run on the store's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.data.store import IndexedSampleStore


def _mix(a: np.ndarray) -> np.ndarray:
    """splitmix64-style integer hash (vectorized, deterministic)."""
    a = a.astype(np.uint64)
    a = (a ^ (a >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    a = (a ^ (a >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return a ^ (a >> np.uint64(31))


@dataclasses.dataclass
class PipelineConfig:
    global_batch: int = 32
    seed: int = 17
    n_hosts: int = 1
    host_id: int = 0


class DataPipeline:
    def __init__(self, store: IndexedSampleStore, cfg: PipelineConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError(f"global_batch={cfg.global_batch} does not "
                             f"divide over {cfg.n_hosts} hosts")
        self.store = store
        self.cfg = cfg
        self._n = store.cfg.n_samples

    def batch_keys(self, step: int) -> np.ndarray:
        """Sample keys for this host's slice of the global batch at ``step``,
        drawn from the store's key population by hashed position."""
        cfg = self.cfg
        per_host = cfg.global_batch // cfg.n_hosts
        pos = np.arange(per_host, dtype=np.uint64)
        gpos = pos + np.uint64(cfg.host_id * per_host)
        seed_mix = np.uint64((cfg.seed * 0x9E3779B97F4A7C15) % (1 << 64))
        with np.errstate(over="ignore"):
            h = _mix(gpos + _mix(np.full_like(gpos, step)) + seed_mix)
        idx = (h % np.uint64(self._n)).astype(np.int64)
        return self.store.keys_np[idx]

    def get_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """``tokens`` / ``labels`` ``[B, seq_len]`` and ``found`` ``[B]``,
        device tensors."""
        keys = torch.from_numpy(self.batch_keys(step).astype(np.int32))
        rows, found = self.store.get_batch(keys)
        return {
            "tokens": rows[:, :-1],
            "labels": rows[:, 1:],
            "found": found,
        }

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.get_batch(step)
            step += 1
