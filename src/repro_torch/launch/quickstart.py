"""Quickstart: the Foresight skiplist in 60 seconds (port of the entry
point ``examples/quickstart.py``).

Builds an index, runs batched searches (base vs foresight, counting the
dependent gathers — the paper's cache-miss analogue), applies an update
batch, and demonstrates validated search on a torn view.

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import skiplist as sl
from repro_torch.core.validated import search_validated


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run "
                         "without one)")
    args = ap.parse_args(argv)
    dev = sl.resolve_device(args.device)
    rng = np.random.default_rng(0)
    keys = np.sort(rng.choice(100_000, 10_000, replace=False)).astype(np.int32)
    kt = torch.from_numpy(keys).to(dev)

    print("== build (10k keys) ==")
    fore = sl.build(kt, kt * 10, capacity=32768, levels=16, foresight=True,
                    device=dev)
    base = sl.build(kt, kt * 10, capacity=32768, levels=16, foresight=False,
                    device=dev)

    q = torch.from_numpy(rng.integers(0, 100_001, 256).astype(np.int32)
                         ).to(dev)
    rf, rb = sl.search(fore, q), sl.search(base, q)
    assert bool((rf.found == rb.found).all())
    print(f"256 searches | lock-step iterations: {int(rf.steps)}")
    print(f"dependent gathers  foresight: {int(rf.gathers):6d}   "
          f"base: {int(rb.gathers):6d}   "
          f"(saving {100 * (1 - int(rf.gathers) / int(rb.gathers)):.0f}% — "
          f"the paper's mechanism)")

    print("\n== update batch (linearized) ==")
    ops = torch.tensor([sl.OP_INSERT] * 50 + [sl.OP_DELETE] * 50,
                       dtype=torch.int32)
    upd_keys = torch.from_numpy(
        np.concatenate([rng.integers(100_001, 120_000, 50),
                        keys[:50]]).astype(np.int32))
    fore, results = sl.apply_ops(fore, ops, upd_keys, upd_keys)
    print(f"applied: {int(results.sum())}/100 ops took effect; "
          f"invariant holds: {bool(sl.check_foresight_invariant(fore))}")

    print("\n== optimistic validation on a torn view ==")
    torn = fore.fused.cpu().numpy().copy()
    flip = rng.random(torn[..., 1].shape) < 0.25
    torn[..., 1] = np.where(flip, rng.integers(-2**31 + 1, 2**31 - 1,
                                               torn[..., 1].shape),
                            torn[..., 1])
    rv = search_validated(torch.from_numpy(torn).to(dev), fore.keys,
                          fore.vals, q)
    rt = sl.search(fore, q)
    ok = bool((rv.found == rt.found).all())
    print(f"25% of foreseen keys corrupted -> validated search still "
          f"exact: {ok}")


if __name__ == "__main__":
    main()
