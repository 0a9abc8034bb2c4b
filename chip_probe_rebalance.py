#!/usr/bin/env python3
"""Times of the rebalance kernel (K12) and the scan kernel (K13) on one
CUDA card, for side-by-side runs of two trees.

    python3 chip_probe_rebalance.py [--tree DIR] [--label NAME]

``chip_smoke.py`` checks both kernels; this script decides nothing.  It
times the port in ``DIR`` (default: this script's own tree) with
``chip_smoke.py``'s timers, ``k12_timed`` and ``scan_times``, which hold
every timed run against the plain version: ``repro_torch`` is imported
from ``DIR/src`` before ``chip_smoke.py`` is, so a parent unpacked under
``chip_archive/`` is timed by the same yardstick as the change.  It
times:

- K12 at the page table's geometry (``chip_smoke.page_table_states``: 8
  slots of 16,384 node slots, 16 levels): a pass with nothing to do, by
  CUDA events around the call (the median of 20) and by the host's rate
  (``ENQUEUED`` passes back to back, nothing read back: the wrapper's and
  the launcher's host time a pass, the median of 5 rounds); the watermark
  pass splitting one shard filled to 0.8 and the given merge of its
  halves, ``REPS`` runs each on fresh clones, with the kernel's device
  time (``torch.profiler``) and, where the kernel leaves them, the first
  trip's phases;
- K13 on one list of the chip_smoke keys' every other key (2^24 keys,
  2^26 slots, 26 levels), a scan from the middle key of each of
  ``SCAN_OUTS`` pairs (the median of 20 runs and the kernel's device
  time), with node ids in key order (foresight and base), and on the
  foresight list with its node ids permuted at random (the records of
  consecutive keys no longer share cache lines, as in a list that has
  taken many updates).

Prints one JSON line a measurement, then the card's name and power limit.
A parent beside the change, in one call:

    python3 chip_probe_rebalance.py --tree chip_archive/parent \\
        --label parent && python3 chip_probe_rebalance.py --label change
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPS = 5
ENQUEUED = 200
# the scans: both sides of the scan kernel's GATHER_FROM, then long ones
SCAN_OUTS = (32, 48, 63, 64, 96, 128, 192, 256, 512, 2048, 65536)


def enqueue_us(fn) -> float:
    """The host's time a call of ``fn`` (microseconds), ``ENQUEUED`` calls
    back to back with nothing read back, the median of 5 rounds."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(ENQUEUED):
            fn()
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) / ENQUEUED * 1e6)
    return statistics.median(rounds)


def k12(cs, rk, label: str) -> None:
    base, full, _ = cs.page_table_states()
    noop = lambda: rk.rebalance_pass(base, "watermark")
    s = int(torch.argmax(full.shards.n))
    halves, _, split = cs.k12_timed(full, "watermark", reps=REPS,
                                    device_time=True)
    _, _, merge = cs.k12_timed(halves, "merge", reps=REPS, device_time=True,
                               s=s, seed=1)
    cs.emit({"phase": "probe_k12", "label": label,
             "noop_ms": cs.time_ms(noop, 20), "noop_enqueue_us":
             enqueue_us(noop), "noop_device_ms": cs.device_breakdown(
                 noop, calls=5, walk="rebalance_kernel")["walk_device_ms"],
             "split": split, "merge": merge})


def permuted(st, seed: int):
    """``st`` (foresight, no free slots) with its live node ids permuted at
    random, one level at a time: the same list, its records scattered."""
    dev, cap = st.keys.device, st.capacity
    live = int(st.bump) - 2
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    m = torch.arange(cap, dtype=torch.int64, device=dev)
    m[2:2 + live] = 2 + torch.randperm(live, generator=g, device=dev)
    out = []
    for t in (st.keys, st.vals, st.height):
        u = t.clone()
        u[m] = t
        out.append(u)
    fused = torch.empty_like(st.fused)
    for lvl in range(st.levels):
        rec = st.fused[lvl]
        fused[lvl, m, 0] = m[rec[:, 0].long()].int()
        fused[lvl, m, 1] = rec[:, 1]
    return st._replace(keys=out[0], vals=out[1], height=out[2], fused=fused)


def k13(cs, sl, label: str) -> None:
    rng = np.random.default_rng(cs.SEED)
    keys = np.sort(rng.choice(cs.FULL_SPAN, cs.FULL_N, replace=False)
                   ).astype(np.int32)[::2]
    dev = torch.device(cs.DEVICE)
    for layout in ("foresight", "base", "foresight, ids permuted"):
        st = sl.build(torch.from_numpy(keys).to(dev),
                      torch.arange(keys.size, dtype=torch.int32, device=dev),
                      capacity=2 * cs.MONO_STORE_N * 2,
                      levels=cs.MONO_STORE_LEVELS,
                      foresight=layout != "base", seed=cs.SEED, device=dev)
        if layout.endswith("permuted"):
            st = permuted(st, cs.SEED + 3)
        lo = int(keys[keys.size // 2])
        scans = {m: cs.scan_times(st, lo, cs.FULL_SPAN, m, reps=20,
                                  device_time=True) for m in SCAN_OUTS}
        cs.check(all(sc["count"] == m for m, sc in scans.items()),
                 "every timed scan filled its max_out")
        cs.emit({"phase": "probe_k13", "label": label, "layout": layout,
                 "ms": {m: sc["ms"] for m, sc in scans.items()},
                 "device_ms": {m: sc["device_ms"]
                               for m, sc in scans.items()}})
        del st
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent),
                    help="the tree whose port is timed")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import repro_torch  # the timed tree's, pinned before chip_smoke's
    if not torch.cuda.is_available():
        sys.exit("chip_probe_rebalance: no CUDA device")
    sys.path.insert(1, str(Path(__file__).resolve().parent))
    import chip_smoke as cs
    from repro_torch.core import skiplist as sl
    from repro_torch.kernels import rebalance as rk
    if not hasattr(rk, "last_phases"):     # a tree whose kernel stamps none
        rk.last_phases = lambda shl: None
    cs.emit({"phase": "probe_tree", "label": args.label,
             "port": str(Path(repro_torch.__file__).parent)})
    smi = cs.card_identity()
    k12(cs, rk, args.label)
    k13(cs, sl, args.label)
    print(smi)


if __name__ == "__main__":
    main()
