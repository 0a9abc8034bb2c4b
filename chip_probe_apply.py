#!/usr/bin/env python3
"""One-off measurements of the update kernel's window size on one CUDA card.

    python3 chip_probe_apply.py [--other NAME=FILE ...] [--windows 32,64,128]

``chip_smoke.py`` checks the update kernel (``csrc/apply_ops.cu``) and
times it at its committed window; this script decides nothing.  It builds
``apply_ops.cu`` alone once a window size W (the source's ``kWindow``
rewritten) and, with ``--other``, each FILE (another version of
``apply_ops.cu`` with the same C interface, named NAME), each into a
library of its own under ``src/repro_torch/build/probe_apply/``, all
nvcc processes started together, and prints each one's ``ptxas -v``
lines.  Then, on each
layout, it runs every library on a fresh clone of the same state, in turns
(the libraries in order, then in reverse), holds every run's results and
state (position-weighted sums of every array) against the first run's, and
reports each library's CUDA-event ms, µs an op and window checks:

- fig3's 50% mix, 65,536 ops (``chip_smoke.synchrobench_ops``, the seeds
  of ``chip_smoke.py``'s update phases) on the 2^25 keys: one list (27
  levels), 64 shards (21 levels), and the same at B = 128 (one list of
  2^21 node slots, 64 shards of 2^15), foresight and base;
- the hot case, on the one list: 4,096 grants of 16 consecutive keys from
  random starts (a page table's), inserts.

Prints one JSON line a build and a layout, then the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from repro_torch.core import sharded as shd
from repro_torch.core import skiplist as sl
from repro_torch.kernels import _build
from repro_torch.kernels import apply_ops as ak

WINDOW_LINE = re.compile(r"constexpr int kWindow = (\d+);")
CHUNK = 1 << 26
HOT_GRANTS, HOT_RUN = 4096, 16


def build_variants(windows, others) -> dict:
    """name -> the loaded library of that version of apply_ops.cu."""
    out = _build.BUILD_DIR / "probe_apply"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.SOURCE_DIR / "apply_ops.cu").read_text()
    assert WINDOW_LINE.search(src), "apply_ops.cu has no kWindow"
    sources = {f"window_{w}": WINDOW_LINE.sub(
        f"constexpr int kWindow = {w};", src) for w in windows}
    for other in others:
        name, path = other.split("=", 1)
        sources[name] = Path(path).read_text()
    procs, libs = [], {}
    for name, text in sources.items():
        cu, so = out / f"{name}.cu", out / f"lib{name}.so"
        cu.write_text(text)
        libs[name] = so
        procs.append(_build._start([_build._nvcc(), *_build.NVCC_FLAGS,
                                    "-shared", "-o", str(so), str(cu)]))
    reports = _build._run(procs)
    loaded = {}
    for (name, so), report in zip(libs.items(), reports):
        lib = ctypes.CDLL(str(so))
        lib.apply_ops_launch.argtypes = _build._SIGNATURES["apply_ops_launch"]
        lib.apply_ops_launch.restype = ctypes.c_int
        loaded[name] = lib
        cs.emit({"phase": "probe_build", "variant": name, "ptxas": [
            line.strip() for line in report.splitlines()
            if "registers" in line or "spill" in line]})
    return loaded


def route_to(libs: dict, current: dict) -> None:
    """Send the wrapper's ``apply_ops_launch`` to ``current["name"]``'s
    library."""
    real = _build.launch

    def launch(name, *args):
        if name != "apply_ops_launch":
            return real(name, *args)
        code = libs[current["name"]].apply_ops_launch(*args)
        if code != 0:
            raise RuntimeError(f"apply_ops_launch ({current['name']}): CUDA "
                               f"error {code}")

    _build.launch = launch


def digest(stack: sl.SkipListState) -> list:
    """Position-weighted sums of every array, in chunks of 2^26 words."""
    out = []
    for t in stack:
        if t is None:
            continue
        v = cs.as_i32(t).reshape(-1)
        acc = torch.zeros((), dtype=torch.int64, device=v.device)
        for i in range(0, v.numel(), CHUNK):
            c = v[i:i + CHUNK].long()
            acc += (c * torch.arange(i + 1, i + 1 + c.numel(),
                                     device=c.device)).sum()
        out.append(int(acc))
    return out


def run_layout(label: str, stack: sl.SkipListState, batch, libs: dict,
               current: dict) -> None:
    """Every library on a clone of ``stack``, forward then reversed."""
    names = list(libs)
    times = {n: [] for n in names}
    checks, first = {}, None
    for name in names + names[::-1]:
        current["name"] = name
        after = sl._clone(stack)
        ak.reset_fat_cases(cs.DEVICE)
        res, ms = cs.event_ms(lambda: ak.apply_ops_batch(
            after, *batch.ops, batch.starts, batch.lens))
        times[name].append(ms)
        checks[name] = ak.window_checks(cs.DEVICE)
        got = (res.cpu(), digest(after))
        del after
        if first is None:
            first = got
        cs.check(torch.equal(got[0], first[0]) and got[1] == first[1],
                 f"{label}: {name} equals {names[0]}")
    cs.emit({"phase": "probe_layout", "layout": label, "ops": batch.n,
             "shards_with_ops": batch.shards,
             "variants": {n: {"ms": times[n],
                              "us_per_op": min(times[n]) * 1e3 / batch.n,
                              "window_checks": checks[n]} for n in names}})


def hot_grants(keys_np: np.ndarray):
    """Inserts of ``HOT_GRANTS`` runs of ``HOT_RUN`` consecutive keys."""
    rng = np.random.default_rng(cs.SEED + 9)
    starts = rng.integers(0, cs.FULL_SPAN - HOT_RUN, HOT_GRANTS)
    ks = (starts[:, None] + np.arange(HOT_RUN)).reshape(-1).astype(np.int32)
    return np.full(ks.size, sl.OP_INSERT, np.int32), ks, ks + 1


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=FILE",
                    help="another apply_ops.cu to time beside, named NAME")
    ap.add_argument("--windows", default="32,64,128")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_probe_apply: no CUDA device")
    smi = cs.card_identity()
    libs = build_variants([int(w) for w in args.windows.split(",")],
                          args.other)
    current = {}
    route_to(libs, current)
    dev = torch.device(cs.DEVICE)
    rng = np.random.default_rng(cs.SEED)
    keys_np = np.sort(rng.choice(cs.FULL_SPAN, cs.FULL_N, replace=False)
                      ).astype(np.int32)
    keys = torch.from_numpy(keys_np).to(dev)
    one = cs.synchrobench_ops(cs.UPDATE_OPS, cs.SEED + 2)
    many = cs.synchrobench_ops(cs.SHARD_UPDATE_OPS, cs.SEED + 5)
    for width in (1, 128):
        for foresight in (True, False):
            v = f"{cs.variant(foresight)}, B = {width}"
            cap = cs.FULL_CAP if width == 1 else cs.fat_capacity(cs.FULL_N,
                                                                 width)
            st = sl.build(keys, keys + 1, capacity=cap,
                          levels=cs.FULL_LEVELS, foresight=foresight,
                          seed=cs.SEED, node_width=width, device=dev)
            run_layout(f"one list, {v}", cs.one_shard(st),
                       cs.route_sorted(None, 1, *one), libs, current)
            if width == 1:
                run_layout(f"one list, {v}, hot grants", cs.one_shard(st),
                           cs.route_sorted(None, 1, *hot_grants(keys_np)),
                           libs, current)
            del st
            torch.cuda.empty_cache()
            shl = shd.build_sharded(keys, keys + 1, n_shards=cs.SHARDS,
                                    levels=cs.SHARD_LEVELS,
                                    foresight=foresight, seed=cs.SEED,
                                    node_width=width, device=dev)
            run_layout(f"64 shards, {v}", shl.shards, cs.route_sorted(
                shl.boundaries, cs.SHARDS, *many), libs, current)
            del shl
            torch.cuda.empty_cache()
    print(smi)


if __name__ == "__main__":
    main()
