#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and check every result.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, one JSON line each:

1. card identity (nvidia-smi name and power limit, torch's device name);
2. build of the traversal kernels from ``src/repro_torch/csrc`` (nvcc);
3. small check: foresight and base skiplists (n=4000, cap=8192, L=14)
   built on the card equal their CPU builds, and K1 / K2 equal their plain
   versions on a half-hit, half-miss batch;
4. the paper's configuration, once per variant: 2^25 keys drawn from
   [0, 2^26) (Synchrobench: key range twice the size), vals = keys + 1,
   27 levels, capacity 2^26, built on the card with
   ``repro_torch.core.skiplist.build``; 2^20 uniform lookups through
   ``repro_torch.kernels.ops.search_kernel`` held against a numpy
   membership oracle; the kernel held against its plain version on the
   same 2^20 queries; kernel, plain and ``torch.searchsorted`` times
   (median of CUDA-event timings) and the byte bound of the batch's paths;
5. the ``kernels`` line: every ported kernel with its main-path launches.

Then the nvidia-smi line and, last, ``{"ok": true, "device": {...}}``.
Any failed check, build or launch raises, and the script exits non-zero.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.core import skiplist as sl  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import foresight_traverse as ft  # noqa: E402

SEED = 0
# benchmarks/fig4_batch_sweep.py:3-4 (2^25 elements), benchmarks/common.py
# (key range 2x the size, capacity the next power of two)
FULL_N, FULL_SPAN, FULL_CAP, FULL_LEVELS = 2**25, 2**26, 2**26, 27
FULL_BATCH = 2**20
SMALL = dict(n=4000, capacity=8192, levels=14)
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12         # H100 SXM non-tensor float32 peak
KERNEL_REPS, PLAIN_REPS = 20, 5
CUDA_SOURCE = "src/repro_torch/csrc/traverse.cu"
KERNELS = {   # name -> (wrapper, plain version, TPU kernel it replaces)
    "foresight_traverse": (ft.foresight_traverse, ft.foresight_traverse_plain,
                           "src/repro/kernels/foresight_traverse.py:303"),
    "base_traverse": (ft.base_traverse, ft.base_traverse_plain,
                      "src/repro/kernels/foresight_traverse.py:698"),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def reset_launches() -> None:
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0


def table_args(st: sl.SkipListState):
    return (st.fused,) if st.foresight else (st.nxt, st.keys)


def kernel_name(st: sl.SkipListState) -> str:
    return "foresight_traverse" if st.foresight else "base_traverse"


def max_abs_err(a, b) -> int:
    return max(int((x.long() - y.long()).abs().max()) for x, y in zip(a, b))


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def path_footprint(st: sl.SkipListState, q: torch.Tensor) -> dict:
    """Distinct index entries the batch's paths read, and the path lengths.

    Replays the traversal with plain tensor ops, keeps every index each
    active lane reads (the loop's reads and the final level-0 read) and
    counts the distinct ones with ``torch.unique``.  Foresight reads 8-byte
    fused records; base reads 4-byte ``nxt`` entries and 4-byte ``keys``.
    Also counts the distinct 32-byte sectors (the smallest unit HBM serves).
    """
    L, cap = st.levels, st.capacity
    x = torch.zeros_like(q)
    lvl = torch.full_like(q, L - 1)
    rec_idx, key_idx, steps = [], [], 0
    while bool((lvl >= 0).any()):
        active = lvl >= 0
        idx = lvl.clamp(min=0).long() * cap + x.long()
        if st.foresight:
            rec = st.fused.view(-1, 2)[idx]
            ptr, fk = rec[:, 0], rec[:, 1]
        else:
            ptr = st.nxt.view(-1)[idx]
            fk = st.keys[ptr.long()]
            key_idx.append(ptr[active].long())
        rec_idx.append(idx[active])
        steps += int(active.sum())
        go = active & (fk < q)
        x = torch.where(go, ptr, x)
        lvl = torch.where(go | ~active, lvl, lvl - 1)
    rec_idx.append(x.long())
    if not st.foresight:
        key_idx.append(st.nxt.view(-1)[x.long()].long())
    rec_bytes = 8 if st.foresight else 4
    arrays = [(torch.cat(rec_idx), rec_bytes)]
    if key_idx:
        arrays.append((torch.cat(key_idx), 4))
    distinct = sum(int(torch.unique(i).numel()) * b for i, b in arrays)
    sectors = sum(int(torch.unique(i * b // 32).numel()) * 32
                  for i, b in arrays)
    return dict(distinct_bytes=distinct, sector_bytes=sectors, steps=steps)


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    line = out.strip().splitlines()[0]
    emit({"phase": "card", "nvidia_smi": line,
          "torch_device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return line


def build_kernels() -> None:
    t0 = time.perf_counter()
    lib = _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": Path(lib._name).name,
          "nvcc_flags": " ".join(_build.NVCC_FLAGS)})


def small_check() -> None:
    rng = np.random.default_rng(SEED)
    keys = np.sort(rng.choice(1 << 22, SMALL["n"], replace=False))
    keys = keys.astype(np.int32)
    q_np = np.concatenate([rng.choice(keys, 2048),
                           rng.integers(0, 1 << 22, 2048)]).astype(np.int32)
    q = torch.from_numpy(q_np).to(DEVICE)
    report = {"phase": "small_check", **SMALL, "batch": q.numel()}
    for foresight in (True, False):
        args = dict(capacity=SMALL["capacity"], levels=SMALL["levels"],
                    foresight=foresight, seed=SEED)
        st = sl.build(keys, keys + 1, device=DEVICE, **args)
        cpu = sl.build(keys, keys + 1, device="cpu", **args)
        for name, t in st._asdict().items():
            if t is not None:
                check(torch.equal(t.cpu(), getattr(cpu, name)),
                      f"card build equals CPU build ({name})")
        wrapper, plain, _ = KERNELS[kernel_name(st)]
        before = wrapper.launches
        got = wrapper(*table_args(st), q)
        want = plain(*table_args(st), q)
        check(wrapper.launches == before + 1, f"{kernel_name(st)} launched")
        err = max_abs_err(got, want)
        check(err == 0, f"{kernel_name(st)} equals its plain version")
        report[kernel_name(st)] = {"max_abs_err": err}
    emit(report)


def full_size(keys_np: np.ndarray, q_np: np.ndarray, foresight: bool) -> dict:
    """Build at the paper's size, run the main path, check, time, bound."""
    dev = torch.device(DEVICE)
    keys = torch.from_numpy(keys_np).to(dev)
    q = torch.from_numpy(q_np).to(dev)
    torch.cuda.reset_peak_memory_stats()

    # The main path, with every launch counter at 0 just before it.
    reset_launches()
    t0 = time.perf_counter()
    st = sl.build(keys, keys + 1, capacity=FULL_CAP, levels=FULL_LEVELS,
                  foresight=foresight, seed=SEED, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = ops.search_kernel(st, q)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    launches = {name: w.launches for name, (w, _, _) in KERNELS.items()}
    name = kernel_name(st)
    check(launches[name] >= 1, f"main path launched {name}")

    idx = np.minimum(np.searchsorted(keys_np, q_np), len(keys_np) - 1)
    hit = keys_np[idx] == q_np
    check(np.array_equal(res.found.cpu().numpy(), hit), "found == oracle")
    check(np.array_equal(res.vals.cpu().numpy(),
                         np.where(hit, q_np + 1, sl.NULL_VAL)),
          "vals == oracle")

    wrapper, plain, replaces = KERNELS[name]
    tables = table_args(st)
    err = max_abs_err(wrapper(*tables, q), plain(*tables, q))
    check(err == 0, f"{name} equals its plain version at full size")

    kernel_ms = time_ms(lambda: wrapper(*tables, q), KERNEL_REPS)
    plain_ms = time_ms(lambda: plain(*tables, q), PLAIN_REPS)
    library_ms = time_ms(lambda: torch.searchsorted(keys, q), KERNEL_REPS)

    fp = path_footprint(st, q)
    io_bytes = q.numel() * 4 * 3             # queries in, node + key out
    bytes_ms = (fp["distinct_bytes"] + io_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = fp["steps"] / SCALAR_OPS_PER_S * 1e3   # one compare a step
    bound_ms = max(bytes_ms, ops_ms)
    row = {"name": name, "route": "cuda", "source": CUDA_SOURCE,
           "replaces": replaces, "launches": launches[name],
           "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms}
    emit({"phase": "full_size", "n": FULL_N, "levels": FULL_LEVELS,
          "capacity": FULL_CAP, "batch": q.numel(),
          "table_gb": ops.tile_bytes(FULL_LEVELS, FULL_CAP, foresight) / 1e9,
          "build_s": build_s, "search_kernel_s": search_s,
          "hits": int(hit.sum()), **row,
          "mops": q.numel() / kernel_ms / 1e3,
          "mean_path_steps": fp["steps"] / q.numel(),
          "distinct_bytes": fp["distinct_bytes"],
          "distinct_count": "torch.unique over the read indices of a plain "
                            "replay of the batch's paths",
          "sector_bytes": fp["sector_bytes"],
          "sector_bound_ms": (fp["sector_bytes"] + io_bytes)
          / HBM_BYTES_PER_S * 1e3,
          "bound_share": bound_ms / kernel_ms,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    del st, res, tables
    torch.cuda.empty_cache()
    return row


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    smi = card_identity()
    build_kernels()
    small_check()
    rng = np.random.default_rng(SEED)
    keys_np = np.sort(rng.choice(FULL_SPAN, FULL_N, replace=False))
    keys_np = keys_np.astype(np.int32)
    q_np = np.random.default_rng(SEED + 1).integers(
        0, FULL_SPAN, FULL_BATCH).astype(np.int32)
    rows = [full_size(keys_np, q_np, foresight) for foresight in (True, False)]
    emit({"phase": "ratio",
          "foresight_over_base_ms": rows[0]["ms"] / rows[1]["ms"]})
    emit({"kernels": rows})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
