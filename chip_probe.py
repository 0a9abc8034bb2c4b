#!/usr/bin/env python3
"""Times of one kernel's rows on one CUDA card, for side-by-side runs of
two trees.

    python3 chip_probe.py --rows k14|rebalance [--tree DIR] [--label NAME]

``chip_smoke.py`` checks every kernel; this script decides nothing.  It
times the port in ``DIR`` (default: this script's own tree) with
``chip_smoke.py``'s timers: ``repro_torch`` is imported from ``DIR/src``
before ``chip_smoke.py`` is, so a parent unpacked under ``chip_archive/``
is timed by the same yardstick as the change.  The rows:

``k14``: the recording search walk, on ``chip_smoke.py``'s 2^25 keys (27
levels, capacity 2^26) and its two traffics (2^20 uniform and 2^20
Zipf(1.2) queries): ``search`` on the foresight and the base list, on
both traffics; ``search_validated`` on the lag-1 view of a
``VersionedIndex`` after ``chip_smoke.py``'s 65,536-op update batch, on
both traffics; ``search`` on the fat lists (B = 128 both variants, B = 8
foresight), on the uniform traffic.  Each row's result is held against
its plain version on the card, every field, then timed by
``chip_smoke.k14_times`` (events, enqueue, the walk's and the pass's
device time in profiles of single calls; in a tree whose K14 call runs
the key pass, the walk and the pass apart by events).

``rebalance``: the rebalance kernel (K12) and the scan kernel (K13):

- K12 at the page table's geometry (``chip_smoke.page_table_states``: 8
  slots of 16,384 node slots, 16 levels): a pass with nothing to do, by
  CUDA events around the call (the median of 20) and by the host's rate
  (``ENQUEUED`` passes back to back, nothing read back: the wrapper's and
  the launcher's host time a pass, the median of 5 rounds); the watermark
  pass splitting one shard filled to 0.8 and the given merge of its
  halves, ``REPS`` runs each on fresh clones (``chip_smoke.k12_timed``,
  every run held against the plain version), with the kernel's device
  time (``torch.profiler``) and, where the kernel leaves them, the first
  trip's phases;
- K13 on one list of the chip_smoke keys' every other key (2^24 keys,
  2^26 slots, 26 levels), a scan from the middle key of each of
  ``SCAN_OUTS`` pairs (``chip_smoke.scan_times``: the median of 20 runs
  and the kernel's device time), with node ids in key order (foresight
  and base), and on the foresight list with its node ids permuted at
  random (the records of consecutive keys no longer share cache lines,
  as in a list that has taken many updates).

Prints one JSON line a row, then the card's name and power limit.  A
parent beside the change, in one call:

    python3 chip_probe.py --rows k14 --tree chip_archive/parent \\
        --label parent && python3 chip_probe.py --rows k14 --label change
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


def k12(cs, label: str) -> None:
    from repro_torch.kernels import rebalance as rk
    if not hasattr(rk, "last_phases"):   # a tree whose kernel stamps none
        rk.last_phases = lambda shl: None
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


def k13(cs, label: str) -> None:
    from repro_torch.core import skiplist as sl
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


def k14(cs, label: str) -> None:
    from repro_torch.core import skiplist as sl
    from repro_torch.core.validated import (search_validated,
                                            search_validated_plain)
    from repro_torch.core.versioned import VersionedIndex
    from repro_torch.kernels import shard_group as sg
    rng = np.random.default_rng(cs.SEED)
    keys_np = np.sort(rng.choice(cs.FULL_SPAN, cs.FULL_N, replace=False)
                      ).astype(np.int32)
    q_np = np.random.default_rng(cs.SEED + 1).integers(
        0, cs.FULL_SPAN, cs.FULL_BATCH).astype(np.int32)
    dev = torch.device(cs.DEVICE)
    keys = torch.from_numpy(keys_np).to(dev)
    qs = {"uniform": torch.from_numpy(q_np).to(dev),
          "zipf": torch.from_numpy(cs.zipf_queries(keys_np,
                                                   cs.FULL_BATCH)).to(dev)}

    def row(name: str, fn, plain_fn, lanes) -> None:
        passes = sg.group_by_key.launches
        got = fn()
        # the parent's K14 call: no key pass, the counters' zeroing and
        # the walk
        grouped = sg.group_by_key.launches > passes
        err = cs.result_err(got, plain_fn(), cs.SEARCH_FIELDS,
                            f"{name} equals its plain version ({label})")
        cs.emit({"phase": "probe_k14", "label": label, "row": name,
                 "max_abs_err": err, **cs.k14_times(
                     fn, f"{name}, {label}", lanes if grouped else None,
                     cs.K14_CALL_KERNELS if grouped else 2)})

    def lists(foresight: bool, width: int = 1):
        cap = cs.FULL_CAP if width == 1 else cs.fat_capacity(cs.FULL_N,
                                                              width)
        return sl.build(keys, keys + 1, capacity=cap, levels=cs.FULL_LEVELS,
                        foresight=foresight, seed=cs.SEED, node_width=width,
                        device=dev)

    for foresight in (True, False):
        st = lists(foresight)
        for tname, q in qs.items():
            row(f"search/{cs.variant(foresight)}/{tname}",
                lambda: sl.search(st, q), lambda: sl.search_plain(st, q),
                (*cs.k14_tables(st), q, 0))
        del st
        torch.cuda.empty_cache()
    vi = VersionedIndex(lists(True))
    vi.update(*cs.on(dev, *cs.synchrobench_ops(cs.UPDATE_OPS, cs.SEED + 2)))
    view = vi.read_view(lag=1)
    args = (view.fused, view.auth_keys, view.vals)
    for tname, q in qs.items():
        row(f"search_validated/lag1/{tname}",
            lambda: search_validated(*args, q),
            lambda: search_validated_plain(*args, q),
            (2, (view.fused, None, view.auth_keys, view.vals, None, None),
             q, 0))
    del vi, view, args
    torch.cuda.empty_cache()
    for width, foresight in ((128, True), (128, False), (8, True)):
        st = lists(foresight, width)
        q = qs["uniform"]
        row(f"search/fat{width}/{cs.variant(foresight)}/uniform",
            lambda: sl.search(st, q), lambda: sl.search_plain(st, q),
            (*cs.k14_tables(st), q, 0))
        del st
        torch.cuda.empty_cache()


def rebalance(cs, label: str) -> None:
    k12(cs, label)
    k13(cs, label)


ROWS = {"k14": k14, "rebalance": rebalance}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", required=True, choices=sorted(ROWS))
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent),
                    help="the tree whose port is timed")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import repro_torch  # the timed tree's, pinned before chip_smoke's
    if not torch.cuda.is_available():
        sys.exit("chip_probe: no CUDA device")
    sys.path.insert(1, str(Path(__file__).resolve().parent))
    import chip_smoke as cs
    cs.emit({"phase": "probe_tree", "label": args.label, "rows": args.rows,
             "port": str(Path(repro_torch.__file__).parent)})
    smi = cs.card_identity()
    ROWS[args.rows](cs, args.label)
    print(smi)


if __name__ == "__main__":
    main()
