#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and check every result.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, one JSON line each:

1. card identity (nvidia-smi name and power limit, torch's device name);
2. build of the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together);
3. small check: foresight and base skiplists (n=4000, cap=8192, L=14)
   built on the card equal their CPU builds, and K1 / K2 equal their plain
   versions on a half-hit, half-miss batch; each runs its key-range
   grouping pass (``group_by_key``), which equals its plain version, and
   equals its launch on the lanes in batch order;
4. small update check, same size: a 2000-op mixed stream through
   ``apply_ops`` on the card equals the CPU run in every state array and
   result (both variants) and leaves its input unchanged; K8 (grouped by
   key range) equals its plain version and its batch-order launch on a
   clean, a 40%-corrupted and a lag-1 table, at the default step cap and
   at 9 steps; after an insert-only batch, lag-1 reads answer for the
   stale key set;
5. the paper's configuration, once per variant: 2^25 keys drawn from
   [0, 2^26) (Synchrobench: key range twice the size), vals = keys + 1,
   27 levels, capacity 2^26, built on the card with
   ``repro_torch.core.skiplist.build``; 2^20 uniform and 2^20 Zipf(1.2)
   lookups through ``repro_torch.kernels.ops.search_kernel`` held against
   a numpy membership oracle; the kernel held against its plain version on
   the same queries; kernel, plain and ``torch.searchsorted`` times
   (median of CUDA-event timings) and the byte and sector bounds of the
   batch's paths.  K1 and K2 group their lanes by key range first: the
   pass is held against its plain version and a stable argsort and timed
   alone (``group_ms``, beside ``torch.sort``), the walk is also timed on
   the lanes in batch order (``ungrouped_ms``, checked equal) and on lanes
   grouped beforehand (``grouped_walk_ms``), and five calls are profiled
   (the pass's device time against the walk's);
6. updates and versioned reads at the same size: the foresight build in a
   ``VersionedIndex``, ``update`` with 1024 ops of fig3's upd=50% mix
   (each result held against a host oracle, then the foresight invariant),
   on both traffics 2^20 lag-1 reads through K8 (``search(lag=1,
   use_kernel=True)``) and lag-0 reads through ``search`` and K1, held
   against the oracle, the plain K8 and ``search_validated``; K8's times
   (grouped, in batch order, the pass alone, a profile), bound, path
   lengths and the queries its ``4L+16`` step cap cuts;
7. small sharded check (n=1500 keys in [0, 2^22), vals 3*keys, S=8,
   L=12, both variants): ``build_sharded``, ``split_shard``,
   ``merge_shards`` and ``repack`` on the card equal the CPU; on S=9 (a
   split) K3-K6 equal their plain versions (K5/K6, the tile-sorted walk,
   also their plan-order launch) on a half-hit batch and on the straddle
   stream, which takes K7's split and equals the CPU; an
   undersized ``k_shards`` raises; ``apply_ops_sharded(rebalance=True)``
   on 4 batches of 32 Zipf inserts equals the CPU in every array, result
   and shard count;
7b. small mesh check, the mesh index at D = 1 on one process group of one
   rank (NCCL for the card, gloo for the CPU run; an in-process store):
   ``build_mesh_index`` (n=1500, S=8, L=12, both variants, node widths 1
   and 8), ``search_mesh``, ``search_kernel_mesh`` (K10) and
   ``search_kernel(mesh=)`` on the card equal the CPU in every state
   array, found, vals and node; K5/K6 on the mesh's plan equal their plain
   versions and their plan-order launch; ``apply_ops_mesh(rebalance=True)``
   on an ``empty_mesh_index`` under 4 batches of 32 Zipf inserts, and
   ``pad_shards`` with the
   in-place split, merge, watermark pass and guard, equal the CPU in every
   array, result, shard count and ``DeviceLoadStats``;
8. the sharded engine at the paper's size, once per variant: the same
   2^25 keys over 64 shards of 2^21 slots, 21 levels, built with
   ``build_sharded``; 2^20 uniform and 2^20 Zipf(1.2) queries through
   ``search_kernel_sharded`` dense (K3/K4) and clustered (K5/K6),
   held against the numpy oracle, each other and the other variant; each
   kernel against its plain version; 256 updates of fig3's upd=50% mix
   through ``apply_ops_sharded`` against a host oracle, then the sharded
   invariant and an unchanged input; kernel, plain, plan, end-to-end and
   ``torch.searchsorted`` times, bounds from a per-shard replay, path
   lengths, auto-K and the ``ndist`` histogram.  K3/K4 group their lanes
   by shard first (``group_by_shard``): the pass is held against its plain
   version and a stable argsort and timed alone (``group_ms``, beside
   ``torch.sort``), and the dense walk is also timed without the pass,
   on the lanes in batch order (``ungrouped_ms``).  K5/K6 sort each tile
   of plan lanes by key inside their one launch: each is also timed in
   the plan's lane order (``plan_order_ms``, the launch the tile sort
   replaced), checked equal, and one call of each is profiled;
8b. the mesh index at the paper's size, after each sharded variant (its
   stack freed first): ``build_mesh_index(n_devices=1, n_shards=64)``
   equal to ``build_sharded``'s build (fingerprint); both traffics
   through ``search_kernel_mesh`` held against the oracle and the sharded
   clustered answers (found, vals, node); 256 updates of fig3's mix
   through ``apply_ops_mesh`` (rebalancing off) against the host oracle,
   then ``check_mesh_invariant`` and ``DeviceLoadStats``; times of the
   whole path, its exchange (route, sort, both ``all_to_all``s), its
   K5/K6 launch (beside their plan-order launch, checked equal, and a
   profile of one launch) and the same index's ``search_kernel_sharded``,
   the launch's bound and ``torch.searchsorted``;
9. small fat check, node widths B = 8 and 128, both variants: a fat
   ``build`` (n=4000), ``build_sharded`` (n=1500, S=8), ``split_shard`` to
   S=9, ``merge_shards`` and ``repack`` on the card equal the CPU; K1-K6
   with the K9 postlude equal their plain versions on a half-hit batch at
   the default step cap and at 9 steps; the S=9 straddle stream takes K7
   and equals the CPU; a mixed ``apply_ops`` stream on a dense key range
   runs every insert case (upsert, room, split, first node) and every
   delete case (plain, minimum lane, node emptied) and equals the CPU;
   ``apply_ops_sharded(rebalance=True)`` on Zipf inserts, ``range_scan``,
   ``range_scan_sharded`` and ``check_fat_invariant`` equal the CPU; K1
   with K9 at B = 6 (rows not 16-byte aligned), 33 (not a multiple of 4)
   and 256 (two passes of K9's row compare) equals its plain version;
10. the fat layout at the paper's size: the same 2^25 keys packed into
   runs (``benchmarks/common.py:26-41``, ``benchmarks/fig_fat_node.py``):
   B = 128 (2^19 nodes, capacity 2^21, L = 27), both variants, and B = 8
   (capacity 2^25), foresight, through ``search_kernel`` (K1/K2 + K9,
   grouped by key range, and timed in batch order as in 5); B = 128 over
   S = 64 shards (2^15 node slots a shard, L = 21), both traffics through
   the dense and clustered paths (K3-K6 + K9, K7; the dense walk grouped,
   and timed ungrouped as in 8) and the eager ``search_sharded``; answers
   held against the numpy oracle and the scalar phases' answers, every
   kernel against its plain version, node ids dereferenced into
   ``fat_vals``; 256 updates of fig3's upd=50%
   mix through ``apply_ops`` (B = 128 monolith) and ``apply_ops_sharded``
   against the host oracle, then ``check_fat_invariant`` and an unchanged
   input; K9 alone (``fat_resolve``, at B = 128 and 8) checked and timed
   on the final predecessors; times, bounds from a replay that counts
   distinct records plus distinct runs x B x 4 bytes, path lengths, peak
   memory;
11. the ``kernels`` line: every ported kernel with its main-path launches
   (K5/K6's include those K10 made), the fat launches of K1-K6 as rows of
   their own, ``fat_resolve``, ``search_kernel_mesh`` (K10),
   ``group_by_shard`` (its launches on the four sharded main paths) and
   ``group_by_key`` (its launches on the K1, K2, K8 and fat K1/K2 main
   paths).

Then the nvidia-smi line and, last, ``{"ok": true, "device": {...}}``.
Any failed check, build or launch raises, and the script exits non-zero.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.convert import mesh_to_numpy  # noqa: E402
from repro_torch.core import mesh_index as mi  # noqa: E402
from repro_torch.core import rebalance_traced as rbt  # noqa: E402
from repro_torch.core import sharded as shd  # noqa: E402
from repro_torch.core import skiplist as sl  # noqa: E402
from repro_torch.core.validated import search_validated  # noqa: E402
from repro_torch.core.versioned import VersionedIndex  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import foresight_traverse as ft  # noqa: E402
from repro_torch.kernels import mesh_launch as ml  # noqa: E402
from repro_torch.kernels import shard_group as sg  # noqa: E402
from repro_torch.kernels import validated_traverse as vt  # noqa: E402
from repro_torch.launch.mesh import make_index_mesh  # noqa: E402

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
# benchmarks/fig3_sequential.py at upd=50% (benchmarks/common.py:63-73):
# 25% insert, 25% delete, 50% read, keys uniform over the key range
UPDATE_OPS = 1024
# The sharded configuration: S = 64, the largest shard count of
# benchmarks/fig_shard_skew.py:37, over the same 2^25 keys: m = 2^19 keys
# and shard_capacity_for(2^25, 64) = 2^21 slots a shard; L = 21 is
# benchmarks/common.py:35's ceil(log2(n)) + 2 for a shard's 2^19 keys.
SHARDS, SHARD_LEVELS = 64, 21
SHARD_UPDATE_OPS = 256
ZIPF_A = 1.2             # benchmarks/common.py:55-60, YCSB-style hot keys
# The fat configuration: fig_fat_node's acceptance width B = 128 and its
# narrowest B = 8 (benchmarks/fig_fat_node.py:42), capacity as
# benchmarks/common.py:37-38 sizes it; the sharded one keeps S = 64.
FAT_WIDTHS = (128, 8)
TRAVERSE_CU = "src/repro_torch/csrc/traverse.cu"
SHARD_GROUP_CU = "src/repro_torch/csrc/shard_group.cu"
FT_PY = "src/repro/kernels/foresight_traverse.py"
KERNELS = {   # name -> (wrapper, plain version, source, TPU kernel replaced)
    "foresight_traverse": (ft.foresight_traverse, ft.foresight_traverse_plain,
                           TRAVERSE_CU, f"{FT_PY}:303"),
    "base_traverse": (ft.base_traverse, ft.base_traverse_plain, TRAVERSE_CU,
                      f"{FT_PY}:698"),
    "validated_traverse": (vt.validated_traverse, vt.validated_traverse_plain,
                           "src/repro_torch/csrc/validated_traverse.cu",
                           "src/repro/kernels/validated_traverse.py:60"),
    "foresight_traverse_sharded": (ft.foresight_traverse_sharded,
                                   ft.foresight_traverse_sharded_plain,
                                   TRAVERSE_CU, f"{FT_PY}:416"),
    "base_traverse_sharded": (ft.base_traverse_sharded,
                              ft.base_traverse_sharded_plain, TRAVERSE_CU,
                              f"{FT_PY}:462"),
    "foresight_traverse_clustered": (ft.foresight_traverse_clustered,
                                     ft.foresight_traverse_clustered_plain,
                                     TRAVERSE_CU, f"{FT_PY}:585"),
    "base_traverse_clustered": (ft.base_traverse_clustered,
                                ft.base_traverse_clustered_plain,
                                TRAVERSE_CU, f"{FT_PY}:645"),
    # K3/K4's grouping pass: a new kernel that stands in for no TPU kernel
    "group_by_shard": (sg.group_by_shard, sg.group_by_shard_plain,
                       SHARD_GROUP_CU, "none (a new pass; no TPU kernel)"),
    # K2/K8's key-range grouping pass, the same
    "group_by_key": (sg.group_by_key, sg.group_by_key_plain, SHARD_GROUP_CU,
                     "none (a new pass; no TPU kernel)"),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def reset_launches() -> None:
    for wrapper, *_ in KERNELS.values():
        wrapper.launches = 0
    for wrapper in ft.WALKS:
        wrapper.fat_launches = 0
    ft.fat_resolve.launches = 0
    ml.search_kernel_mesh.launches = 0


def read_launches() -> dict:
    out = {name: w.launches for name, (w, *_) in KERNELS.items()}
    out.update({f"{w.__name__}/fat": w.fat_launches for w in ft.WALKS})
    out["fat_resolve"] = ft.fat_resolve.launches
    out["search_kernel_mesh"] = ml.search_kernel_mesh.launches
    return out


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


def path_footprint(tables, q: torch.Tensor, sid=None, fat_keys=None
                   ) -> dict:
    """Distinct index entries the batch's paths read, and the path lengths.

    ``tables`` is ``(fused,)`` or ``(nxt, keys)`` with a leading shard axis
    (``[None]`` for a monolithic list); lane ``i`` walks shard ``sid[i]``
    (all 0 when ``sid`` is None), at that shard's offsets.  Replays the
    traversal with plain tensor ops, keeps every index each active lane
    reads (the loop's reads and the final level-0 read) and counts the
    distinct ones with ``torch.unique``.  Foresight reads 8-byte fused
    records; base reads 4-byte ``nxt`` entries and 4-byte ``keys``.  With
    ``fat_keys [S, cap, B]`` the K9 postlude also reads each query's owner
    run, ``B`` 4-byte keys: distinct runs x B x 4 bytes, and ``B``
    compares a query.  Also counts the distinct 32-byte sectors (the
    smallest unit HBM serves).
    """
    foresight = len(tables) == 1
    S, L, cap = tables[0].shape[:3]
    flat = tables[0].reshape(-1, 2) if foresight else tables[0].reshape(-1)
    sid = torch.zeros_like(q).long() if sid is None else sid.long()
    x = torch.zeros_like(q)
    lvl = torch.full_like(q, L - 1)
    path = torch.zeros_like(q)
    rec_idx, key_idx = [], []
    while bool((lvl >= 0).any()):
        active = lvl >= 0
        idx = (sid * L + lvl.clamp(min=0).long()) * cap + x.long()
        if foresight:
            ptr, fk = flat[idx].unbind(1)
        else:
            ptr = flat[idx]
            kidx = sid * cap + ptr.long()
            fk = tables[1].reshape(-1)[kidx]
            key_idx.append(kidx[active])
        rec_idx.append(idx[active])
        path += active.int()
        go = active & (fk < q)
        x = torch.where(go, ptr, x)
        lvl = torch.where(go | ~active, lvl, lvl - 1)
    last = sid * L * cap + x.long()            # the final level-0 read
    rec_idx.append(last)
    if not foresight:
        key_idx.append(sid * cap + flat[last].long())
    arrays = [(torch.cat(rec_idx), 8 if foresight else 4)]
    if key_idx:
        arrays.append((torch.cat(key_idx), 4))
    distinct = sum(int(torch.unique(i).numel()) * b for i, b in arrays)
    sectors = sum(int(torch.unique(i * b // 32).numel()) * 32
                  for i, b in arrays)
    out = dict(distinct_bytes=distinct, sector_bytes=sectors,
               steps=int(path.sum()), path=path, x=x)
    if fat_keys is not None:
        B = fat_keys.shape[-1]
        if foresight:
            cand, ck = flat[last].unbind(1)
        else:
            cand = flat[last]
            ck = tables[1].reshape(-1)[sid * cap + cand.long()]
        owner = torch.where((ck == q) | (x == 0), cand, x)
        runs = int(torch.unique(sid * cap + owner.long()).numel())
        out.update(distinct_runs=runs, compares=B * q.numel())
        out["distinct_bytes"] += runs * B * 4
        out["sector_bytes"] += runs * -(-B * 4 // 32) * 32
    return out


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


def monolith_launch(name: str, tables, q: torch.Tensor, fat_keys=None,
                    max_steps: int = 0, out_idx=None) -> tuple:
    """K1 (``foresight_traverse``), K2 (``base_traverse``) or K8
    (``validated_traverse``) launched through ``_build.launch`` directly,
    without the wrapper's key grouping:
    lane i walks q[i] and writes at ``out_idx[i]``.  ``out_idx`` None is the
    launch on the lanes in batch order; ``group_by_key``'s (q_sorted, perm)
    as (q, out_idx) is the grouped walk without its pass.  It counts no
    launch."""
    node, key = torch.empty_like(q), torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    idx = None if out_idx is None else out_idx.data_ptr()
    if name == "validated_traverse":
        fused, auth = tables
        L, cap, _ = fused.shape
        _build.launch("validated_traverse_launch", fused.data_ptr(),
                      auth.data_ptr(), idx, q.data_ptr(), node.data_ptr(),
                      key.data_ptr(), q.numel(), L, cap,
                      max_steps or vt.default_max_steps(L), stream)
        return node, key
    L, cap = tables[0].shape[:2]
    _build.launch(f"{name}_launch", *(t.data_ptr() for t in tables),
                  None if fat_keys is None else fat_keys.data_ptr(), idx,
                  q.data_ptr(), node.data_ptr(), key.data_ptr(), q.numel(), L,
                  cap, 1 if fat_keys is None else fat_keys.shape[-1],
                  max_steps or ft.traversal_bound(L, cap), stream)
    return node, key


WALK_KERNELS = {"foresight_traverse": "foresight_kernel",
                "base_traverse": "base_kernel",
                "validated_traverse": "validated_kernel"}


def split_times(name: str, tables, q: torch.Tensor, fat_keys=None) -> dict:
    """K1's, K2's or K8's call taken apart, by CUDA events: the walk on the
    lanes in batch order (``ungrouped_ms``, checked equal to the wrapper's
    answer) and on lanes grouped beforehand (``grouped_walk_ms``, the call
    without its pass); and a profile of five calls, pass against walk."""
    fat = () if fat_keys is None else (fat_keys,)
    want = KERNELS[name][0](*tables, q, *fat)
    check(max_abs_err(want, monolith_launch(name, tables, q, fat_keys)) == 0,
          f"grouped {name} equals its batch-order launch")
    q_s, perm = sg.group_by_key(q)
    check(max_abs_err(want, monolith_launch(name, tables, q_s, fat_keys,
                                            out_idx=perm)) == 0,
          f"{name} on lanes grouped beforehand equals the wrapper")
    walk = WALK_KERNELS[name]
    prof = device_breakdown(lambda: KERNELS[name][0](*tables, q, *fat),
                            calls=5, walk=walk)
    return {
        "ungrouped_ms": time_ms(
            lambda: monolith_launch(name, tables, q, fat_keys), KERNEL_REPS),
        "grouped_walk_ms": time_ms(
            lambda: monolith_launch(name, tables, q_s, fat_keys,
                                    out_idx=perm), KERNEL_REPS),
        "profile": prof,
        "ungrouped_profile": device_breakdown(
            lambda: monolith_launch(name, tables, q, fat_keys), calls=5,
            walk=walk)}


def check_key_grouping(q: torch.Tensor, what: str) -> int:
    """``group_by_key`` on the card equals its plain version, ``perm`` is a
    stable argsort of the key buckets and ``q_sorted = q[perm]``; returns
    the max abs error."""
    q_s, perm = sg.group_by_key(q)
    err = max_abs_err((perm,), (sg.group_by_key_plain(q),))
    check(err == 0, f"group_by_key equals its plain version ({what})")
    check(torch.equal(perm.long(), torch.argsort(sg.key_buckets(q),
                                                 stable=True)),
          f"group_by_key's perm is a stable argsort ({what})")
    check(torch.equal(q_s, q[perm.long()]),
          f"group_by_key's q_sorted ({what})")
    return err


def key_group_times(q: torch.Tensor) -> dict:
    """The key pass alone: its time, its plain version's and a stable
    ``torch.sort`` of the queries' (the library's nearest call)."""
    return dict(
        ms=time_ms(lambda: sg.group_by_key(q), KERNEL_REPS),
        plain_ms=time_ms(lambda: sg.group_by_key_plain(q), PLAIN_REPS),
        library_ms=time_ms(lambda: torch.sort(q, stable=True), KERNEL_REPS),
        # q read once; q_sorted and perm written once
        bound_ms=q.numel() * 12 / HBM_BYTES_PER_S * 1e3)


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
        wrapper, plain, *_ = KERNELS[kernel_name(st)]
        before = wrapper.launches, sg.group_by_key.launches
        got = wrapper(*table_args(st), q)
        want = plain(*table_args(st), q)
        check(wrapper.launches == before[0] + 1,
              f"{kernel_name(st)} launched")
        err = max_abs_err(got, want)
        check(err == 0, f"{kernel_name(st)} equals its plain version")
        report[kernel_name(st)] = {"max_abs_err": err}
        # K1 and K2 group their lanes by key
        check(sg.group_by_key.launches == before[1] + 1,
              f"{kernel_name(st)} ran group_by_key")
        check(max_abs_err(got, monolith_launch(
            kernel_name(st), table_args(st), q)) == 0,
              f"grouped {kernel_name(st)} equals its batch-order launch")
    report["group_by_key_err"] = check_key_grouping(q, "small")
    emit(report)


def small_keys() -> np.ndarray:
    rng = np.random.default_rng(SEED)
    return np.sort(rng.choice(1 << 22, SMALL["n"], replace=False)
                   ).astype(np.int32)


def mixed_ops(keys: np.ndarray, n: int, span: int, seed: int):
    """(op types, keys, vals) of a read/insert/delete stream; deletes and
    half the reads name present keys, inserts uniform keys."""
    rng = np.random.default_rng(seed)
    types = rng.choice(np.array([sl.OP_READ, sl.OP_INSERT, sl.OP_DELETE],
                                np.int32), n)
    ks = np.where((types == sl.OP_DELETE) | (rng.random(n) < 0.5),
                  rng.choice(keys, n), rng.integers(0, span, n))
    ks = ks.astype(np.int32)
    return types, ks, ks + 1


def on(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


def check_same_state(got: sl.SkipListState, want: sl.SkipListState,
                     what: str) -> None:
    for name, t in got._asdict().items():
        if t is not None:
            check(torch.equal(t.cpu(), getattr(want, name).cpu()),
                  f"{what} ({name})")


def check_k8(fused, auth, q, report: dict, label: str) -> None:
    """K8 (grouped by key) equals its plain version and its launch on the
    lanes in batch order bit for bit, at the default step cap and at a
    truncating one."""
    for max_steps in (0, 9):
        before = sg.group_by_key.launches
        got = vt.validated_traverse(fused, auth, q, max_steps=max_steps)
        check(sg.group_by_key.launches == before + 1,
              f"K8 ran group_by_key ({label})")
        want = vt.validated_traverse_plain(fused, auth, q,
                                           max_steps=max_steps)
        err = max(max_abs_err(got, want), max_abs_err(
            got, monolith_launch("validated_traverse", (fused, auth), q,
                                 max_steps=max_steps)))
        check(err == 0, f"grouped K8 equals its plain version and its "
                        f"batch-order launch ({label}, "
                        f"max_steps={max_steps})")
        report[f"k8_{label}_max_steps_{max_steps}_err"] = err


def small_update_check() -> None:
    """The write side on the card equals the CPU; K8 equals its plain
    version on a clean, a corrupted and a lag-1 table; insert-only lag-1
    reads answer for the stale key set."""
    keys = small_keys()
    args = dict(capacity=SMALL["capacity"], levels=SMALL["levels"],
                seed=SEED)
    stream = mixed_ops(keys, 2000, 1 << 22, SEED + 3)
    report = {"phase": "small_update_check", **SMALL, "ops": 2000}
    t_phase = t0 = time.perf_counter()
    for foresight in (True, False):
        st = sl.build(keys, keys + 1, foresight=foresight, device=DEVICE,
                      **args)
        cpu = sl.build(keys, keys + 1, foresight=foresight, device="cpu",
                       **args)
        new, res = sl.apply_ops(st, *on(DEVICE, *stream))
        new_cpu, res_cpu = sl.apply_ops(cpu, *on("cpu", *stream))
        check(torch.equal(res.cpu(), res_cpu), "apply_ops results, card "
              "equals CPU")
        check_same_state(new, new_cpu, "apply_ops state, card equals CPU")
        check_same_state(st, sl.build(keys, keys + 1, foresight=foresight,
                                      device="cpu", **args),
                         "apply_ops leaves its input unchanged")
        report[f"{'foresight' if foresight else 'base'}_results"] = \
            int(res.sum())
    report["apply_ops_s"] = time.perf_counter() - t0

    st = sl.build(keys, keys + 1, device=DEVICE, **args)
    rng = np.random.default_rng(SEED + 4)
    q, = on(DEVICE, np.concatenate([rng.choice(keys, 2048), rng.integers(
        0, 1 << 22, 2048)]).astype(np.int32))
    check_k8(st.fused, st.keys, q, report, "clean")
    fused = st.fused.cpu().numpy().copy()       # a copy, on any device
    fused[..., 1] = np.where(rng.random(fused.shape[:2]) < 0.4,
                             rng.integers(-2**31 + 1, 2**31 - 1,
                                          fused.shape[:2]), fused[..., 1])
    check_k8(on(DEVICE, fused)[0], st.keys, q, report, "corrupt40")
    vi = VersionedIndex(st)
    vi.update(*on(DEVICE, *stream))
    view = vi.read_view(lag=1)
    check_k8(view.fused, view.auth_keys, q, report, "lag1")

    vi = VersionedIndex(st)
    newk = rng.integers(0, 1 << 22, 512).astype(np.int32)
    vi.update(*on(DEVICE, np.full(512, sl.OP_INSERT, np.int32), newk,
                  newk + 1))
    q2 = torch.cat([q, on(DEVICE, newk)[0]])
    stale = np.isin(q2.cpu().numpy(), keys)
    for use_kernel in (True, False):
        found = vi.search(q2, lag=1, use_kernel=use_kernel).found
        check(np.array_equal(found.cpu().numpy(), stale),
              f"insert-only lag-1 read is stale membership "
              f"(use_kernel={use_kernel})")
    report["insert_only_stale_hits"] = int(stale.sum())
    report["seconds"] = time.perf_counter() - t_phase
    emit(report)


def synchrobench_ops(n: int, seed: int):
    """fig3_sequential's upd=50% mix: 25% insert, 25% delete, 50% read,
    keys uniform over [0, FULL_SPAN), inserted vals = key + 1."""
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    types = np.where(u < 0.25, sl.OP_INSERT,
                     np.where(u < 0.5, sl.OP_DELETE, sl.OP_READ))
    ks = rng.integers(0, FULL_SPAN, n).astype(np.int32)
    return types.astype(np.int32), ks, ks + 1


def host_oracle(keys_np: np.ndarray, types, ks):
    """Per-op results of the stream on the sorted keys, and the key set
    after it."""
    idx = np.minimum(np.searchsorted(keys_np, ks), len(keys_np) - 1)
    present = dict(zip(ks.tolist(), (keys_np[idx] == ks).tolist()))
    results = []
    for t, k in zip(types.tolist(), ks.tolist()):
        p = present[k]
        if t == sl.OP_INSERT:
            present[k] = True
        elif t == sl.OP_DELETE:
            present[k] = False
        results.append(int(not p if t == sl.OP_INSERT else p))
    gone = [k for k, v in present.items() if not v]
    new = [k for k, v in present.items() if v]
    current = np.union1d(np.setdiff1d(keys_np, gone), new).astype(np.int32)
    return np.array(results, np.int32), current


def check_lookups(found, vals, q_np, keys_np, what: str) -> None:
    idx = np.minimum(np.searchsorted(keys_np, q_np), len(keys_np) - 1)
    hit = keys_np[idx] == q_np
    check(np.array_equal(found.cpu().numpy(), hit), f"{what}: found")
    check(np.array_equal(vals.cpu().numpy(),
                         np.where(hit, q_np + 1, sl.NULL_VAL)),
          f"{what}: vals")


def validated_footprint(fused, auth, q, max_steps: int) -> dict:
    """What K8 reads on this batch, and each query's untruncated path.

    Replays the validated traversal with plain tensor ops.  Up to
    ``max_steps`` it keeps every fused record index each active lane reads
    and every ``auth`` index the kernel loads (level 0, and above it only
    where the foreseen key says advance), plus the final level-0 record
    and its key.  Past ``max_steps`` it only counts steps, for the path
    lengths the cap cuts.
    """
    L, cap, _ = fused.shape
    flat = fused.view(-1, 2)
    x = torch.zeros_like(q)
    lvl = torch.full_like(q, L - 1)
    path = torch.zeros_like(q)
    rec_idx, key_idx, loads, step = [], [], 0, 0
    x_at_cap = x
    while bool((lvl >= 0).any()):
        active = lvl >= 0
        idx = lvl.clamp(min=0).long() * cap + x.long()
        ptr, fk = flat[idx].unbind(1)
        need = active & ((lvl == 0) | (fk < q))
        go = need & (auth[ptr.long()] < q)
        if step < max_steps:
            rec_idx.append(idx[active])
            key_idx.append(ptr[need].long())
            loads += int(active.sum()) + int(need.sum())
        path += active.int()
        x = torch.where(go, ptr, x)
        lvl = torch.where(go | ~active, lvl, lvl - 1)
        step += 1
        if step == max_steps:
            x_at_cap = x
    if step < max_steps:
        x_at_cap = x
    rec_idx.append(x_at_cap.long())
    key_idx.append(flat[x_at_cap.long(), 0].long())
    arrays = [(torch.cat(rec_idx), 8), (torch.cat(key_idx), 4)]
    return dict(
        distinct_bytes=sum(int(torch.unique(i).numel()) * b
                           for i, b in arrays),
        sector_bytes=sum(int(torch.unique(i * b // 32).numel()) * 32
                         for i, b in arrays),
        loads=loads, path=path)


def versioned_full_size(keys_np: np.ndarray, traffic: dict) -> dict:
    """Updates and mixed-view reads at the paper's size: build, one update
    batch through ``VersionedIndex.update``, then on each traffic 2^20
    lag-1 reads through K8 and lag-0 reads through ``search`` and K1, each
    held against a host oracle.  K8 groups its lanes by key range: it is
    also timed on the lanes in batch order and the pass alone, and five
    calls are profiled (``split_times``).  Returns ({traffic: K8's
    kernels-line row}, the key pass's launches on the main path)."""
    stage_s, t_stage = {}, time.perf_counter()
    t_phase = t_stage

    def lap(stage: str) -> None:
        """Seconds since the last lap, device work included."""
        nonlocal t_stage
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage_s[stage] = stage_s.get(stage, 0.0) + now - t_stage
        t_stage = now

    dev = torch.device(DEVICE)
    types, ks, vs = synchrobench_ops(UPDATE_OPS, SEED + 2)
    want_results, current = host_oracle(keys_np, types, ks)
    lap("host_oracle")
    qs = {name: torch.from_numpy(q).to(dev) for name, q in traffic.items()}
    torch.cuda.reset_peak_memory_stats()

    # The main path, with every launch counter at 0 just before it.
    reset_launches()
    t0 = time.perf_counter()
    vi = VersionedIndex(sl.build(torch.from_numpy(keys_np).to(dev),
                                 torch.from_numpy(keys_np + 1).to(dev),
                                 capacity=FULL_CAP, levels=FULL_LEVELS,
                                 seed=SEED, device=dev))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = vi.update(*on(dev, types, ks, vs))
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    reads = {name: (vi.search(q, lag=1, use_kernel=True), vi.search(q, lag=0),
                    ops.search_kernel(vi.current, q))
             for name, q in qs.items()}
    torch.cuda.synchronize()
    launches = read_launches()
    lap("main_path")
    for name in ("validated_traverse", "foresight_traverse"):
        check(launches[name] >= 1, f"versioned path launched {name}")
    check(launches["group_by_key"] == 2 * len(qs),
          "versioned path ran group_by_key once a K8 and a K1 call")

    check(np.array_equal(results.cpu().numpy(), want_results),
          "every apply_ops result equals the oracle")
    check(bool(sl.check_foresight_invariant(vi.current)),
          "foresight invariant holds after the update")
    for name, (_, lag0, k1) in reads.items():
        check_lookups(lag0.found, lag0.vals, traffic[name], current,
                      f"lag-0 search ({name})")
        check_lookups(k1.found, k1.vals, traffic[name], current,
                      f"K1 on vi.current ({name})")
    n_live = int(vi.current.n)
    live_keys = sl.sorted_live_kv(vi.current)[0][:n_live]
    check(np.array_equal(live_keys.cpu().numpy(), current),
          "sorted_live_kv equals the oracle's key set")
    lap("oracle_checks")

    view = vi.read_view(lag=1)
    fused, auth = view.fused, view.auth_keys
    tables = (fused, auth)
    max_steps = vt.default_max_steps(FULL_LEVELS)
    wrapper, plain, source, replaces = KERNELS["validated_traverse"]
    rows = {}
    for name, q in qs.items():
        lag1 = reads[name][0]
        fp = validated_footprint(fused, auth, q, max_steps)
        cut = fp["path"] > max_steps
        lap("footprint_replay")
        got = vt.validated_traverse(fused, auth, q)
        err = max_abs_err(got, vt.validated_traverse_plain(fused, auth, q))
        check(err == 0, f"K8 equals its plain version at full size ({name})")
        check(torch.equal(got[0], lag1.node),
              f"K8 node is the lag-1 read's ({name})")
        ref = search_validated(fused, auth, view.vals, q)
        keep = ~cut            # a lane cut at max_steps has no equal there
        check(torch.equal(lag1.found[keep], ref.found[keep]),
              f"K8 found equals search_validated ({name})")
        check(torch.equal(lag1.vals[keep], ref.vals[keep]),
              f"K8 vals equals search_validated ({name})")
        hit = keep & ref.found
        check(torch.equal(lag1.node[hit], ref.node[hit]),
              f"K8 node equals search_validated where found ({name})")
        g_err = check_key_grouping(q, f"versioned {name}")
        lap("k8_checks")

        kernel_ms = time_ms(lambda: vt.validated_traverse(fused, auth, q),
                            KERNEL_REPS)
        split = split_times("validated_traverse", tables, q)
        plain_ms = time_ms(lambda: vt.validated_traverse_plain(fused, auth,
                                                               q),
                           PLAIN_REPS)
        library_ms = time_ms(lambda: torch.searchsorted(live_keys, q),
                             KERNEL_REPS)
        k1_ms = time_ms(lambda: ft.foresight_traverse(vi.current.fused, q),
                        KERNEL_REPS)
        group = {**key_group_times(q), "max_abs_err": g_err}
        lap("timing")
        io_bytes = q.numel() * 4 * 3           # queries in, node + key out
        bytes_ms = (fp["distinct_bytes"] + io_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = fp["loads"] / SCALAR_OPS_PER_S * 1e3   # one compare a load
        bound_ms = max(bytes_ms, ops_ms)
        sector_ms = (fp["sector_bytes"] + io_bytes) / HBM_BYTES_PER_S * 1e3
        rows[name] = {
            "name": "validated_traverse", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches["validated_traverse"],
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "sector_bound_ms": sector_ms,
            "ungrouped_ms": split["ungrouped_ms"]}
        emit({"phase": "versioned_full_size", "traffic": name, "n": FULL_N,
              "levels": FULL_LEVELS, "capacity": FULL_CAP,
              "batch": q.numel(), "update_ops": UPDATE_OPS,
              "op_mix": "25% insert, 25% delete, 50% read",
              "results_by_op": {t: int(want_results[types == code].sum())
                                for t, code in (("read_hits", sl.OP_READ),
                                                ("inserted", sl.OP_INSERT),
                                                ("deleted", sl.OP_DELETE))},
              "build_s": build_s, "update_s": update_s,
              "update_us_per_op": update_s / UPDATE_OPS * 1e6,
              "n_after": n_live, "lag0_hits": int(reads[name][1].found.sum()),
              "lag1_hits": int(lag1.found.sum()), **rows[name],
              **split, "group": group,
              "grouped_over_ungrouped_ms": kernel_ms / split["ungrouped_ms"],
              "mops": q.numel() / kernel_ms / 1e3,
              "k1_ms": k1_ms, "k8_over_k1_ms": kernel_ms / k1_ms,
              "validation_load": "on level 0, and above it only on a "
                                 "foreseen advance",
              "mean_path_steps": float(fp["path"].float().mean()),
              "max_path_steps": int(fp["path"].max()),
              "max_steps": max_steps,
              "queries_over_max_steps": int(cut.sum()),
              "distinct_bytes": fp["distinct_bytes"],
              "sector_bytes": fp["sector_bytes"],
              "bound_share": bound_ms / kernel_ms,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "stage_s": stage_s, "seconds": time.perf_counter() - t_phase})
        del fp, got, ref, lag1
    del vi, view, fused, auth, tables, reads, live_keys
    torch.cuda.empty_cache()
    return rows, launches["group_by_key"]


def full_size(keys_np: np.ndarray, traffic: dict, foresight: bool) -> dict:
    """Build at the paper's size, run the main path on each traffic, check,
    time, bound.  K1 and K2 group their lanes by key range: each is also
    timed on the lanes in batch order (``ungrouped_ms``, checked equal) and
    the pass alone (``group_ms``), and five calls are profiled
    (``split_times``).  Returns {traffic: its kernels-line row}; a row
    also carries the pass's row under ``group``."""
    dev = torch.device(DEVICE)
    keys = torch.from_numpy(keys_np).to(dev)
    qs = {name: torch.from_numpy(q).to(dev) for name, q in traffic.items()}
    torch.cuda.reset_peak_memory_stats()

    # The main path, with every launch counter at 0 just before it.
    reset_launches()
    t0 = time.perf_counter()
    st = sl.build(keys, keys + 1, capacity=FULL_CAP, levels=FULL_LEVELS,
                  foresight=foresight, seed=SEED, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    search_s, res = {}, {}
    for name, q in qs.items():
        t0 = time.perf_counter()
        res[name] = ops.search_kernel(st, q)
        torch.cuda.synchronize()
        search_s[name] = time.perf_counter() - t0
    launches = read_launches()
    name = kernel_name(st)
    check(launches[name] >= 1, f"main path launched {name}")
    check(launches["group_by_key"] == len(qs),
          f"main path ran group_by_key once a {name} call")

    wrapper, plain, source, replaces = KERNELS[name]
    tables = table_args(st)
    rows = {}
    for tname, q in qs.items():
        check_lookups(res[tname].found, res[tname].vals, traffic[tname],
                      keys_np, f"search_kernel ({tname})")
        got = wrapper(*tables, q)
        err = max_abs_err(got, plain(*tables, q))
        check(err == 0, f"{name} equals its plain version at full size "
                        f"({tname})")
        kernel_ms = time_ms(lambda: wrapper(*tables, q), KERNEL_REPS)
        plain_ms = time_ms(lambda: plain(*tables, q), PLAIN_REPS)
        library_ms = time_ms(lambda: torch.searchsorted(keys, q),
                             KERNEL_REPS)
        # the batch-order launch, the pass
        g_err = check_key_grouping(q, f"full size {tname}")
        extra = {**split_times(name, tables, q),
                 "group": {**key_group_times(q), "max_abs_err": g_err}}
        extra["grouped_over_ungrouped_ms"] = kernel_ms / extra["ungrouped_ms"]

        fp = path_footprint(tuple(t[None] for t in tables), q)
        io_bytes = q.numel() * 4 * 3             # queries in, node + key out
        bytes_ms = (fp["distinct_bytes"] + io_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = fp["steps"] / SCALAR_OPS_PER_S * 1e3   # one compare a step
        bound_ms = max(bytes_ms, ops_ms)
        sector_ms = (fp["sector_bytes"] + io_bytes) / HBM_BYTES_PER_S * 1e3
        rows[tname] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "sector_bound_ms": sector_ms,
            "ungrouped_ms": extra["ungrouped_ms"]}
        emit({"phase": "full_size", "traffic": tname, "n": FULL_N,
              "levels": FULL_LEVELS, "capacity": FULL_CAP,
              "batch": q.numel(),
              "table_gb": ops.tile_bytes(FULL_LEVELS, FULL_CAP,
                                         foresight) / 1e9,
              "build_s": build_s, "search_kernel_s": search_s[tname],
              "hits": int(res[tname].found.sum()), **rows[tname], **extra,
              "mops": q.numel() / kernel_ms / 1e3,
              "mean_path_steps": fp["steps"] / q.numel(),
              "max_path_steps": int(fp["path"].max()),
              "distinct_bytes": fp["distinct_bytes"],
              "distinct_count": "torch.unique over the read indices of a "
                                "plain replay of the batch's paths",
              "sector_bytes": fp["sector_bytes"],
              "bound_share": bound_ms / kernel_ms,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        rows[tname]["group"] = {
            "name": "group_by_key", "route": "cuda",
            "source": SHARD_GROUP_CU,
            "replaces": KERNELS["group_by_key"][3],
            "launches": launches["group_by_key"], **extra["group"],
            "bound_by": "bytes", "sector_bound_ms": extra["group"][
                "bound_ms"]}
        del fp, got
    del st, res, tables
    torch.cuda.empty_cache()
    return rows


def variant(foresight: bool) -> str:
    return "foresight" if foresight else "base"


def shard_tables(shl: shd.ShardedSkipList):
    return ((shl.shards.fused,) if shl.foresight
            else (shl.shards.nxt, shl.shards.keys))


def sharded_names(foresight: bool):
    """(dense kernel, clustered kernel) names of a variant."""
    v = variant(foresight)
    return f"{v}_traverse_sharded", f"{v}_traverse_clustered"


def check_same_sharded(got: shd.ShardedSkipList, want: shd.ShardedSkipList,
                       what: str) -> None:
    check(got.n_shards == want.n_shards, f"{what} (shard count)")
    check(torch.equal(got.boundaries.cpu(), want.boundaries.cpu()),
          f"{what} (boundaries)")
    check_same_state(got.shards, want.shards, what)


def straddle_stream(boundaries: torch.Tensor, n_blocks: int = 4,
                    tail_per_shard: int = 2) -> np.ndarray:
    """tests/test_clustered_traversal.py:308-326: hot shard-0 blocks and one
    last sorted block that straddles every shard."""
    b = boundaries.cpu().numpy().astype(np.int64)
    S = b.shape[0]
    n_tail = tail_per_shard * (S - 1)
    rng = np.random.default_rng(99)
    hot = rng.integers(0, b[1], n_blocks * ft.QBLK - n_tail)
    tail = np.concatenate([
        np.linspace(b[i], (b[i + 1] if i + 1 < S else b[-1] + 2) - 1,
                    tail_per_shard, dtype=np.int64) for i in range(1, S)])
    return np.concatenate([hot, tail]).astype(np.int32)


def check_sharded_kernels(shl, q, report: dict, label: str) -> None:
    """The dense and clustered kernels equal their plain versions on the
    card, on ``q`` routed (dense) and planned (clustered)."""
    dense, clus = sharded_names(shl.foresight)
    sid = shd.route(shl.boundaries, q)
    plan = ops.cluster_queries(shl.boundaries, ops._pad(q)[0])
    for name, args in ((dense, (sid, q)),
                       (clus, (plan.block_sids, plan.ndist, plan.sid_sorted,
                               plan.q_sorted))):
        wrapper, plain, *_ = KERNELS[name]
        before = wrapper.launches
        got = wrapper(*shard_tables(shl), *args)
        check(wrapper.launches == before + 1, f"{name} launched ({label})")
        err = max_abs_err(got, plain(*shard_tables(shl), *args))
        check(err == 0, f"{name} equals its plain version ({label})")
        report[f"{name}_{label}_err"] = err
        if name == clus:
            check(all(torch.equal(a, b) for a, b in zip(
                clustered_walk(shard_tables(shl), args, None), got)),
                f"{name} equals its plan-order launch ({label})")


def small_sharded_check() -> None:
    """The sharded engine on the card equals the CPU: build, split / merge /
    repack, K3-K6 against their plain versions (a half-hit batch and the
    straddle stream through K7), the undersized-K refusal, and a rebalancing
    Zipf insert stream."""
    rng = np.random.default_rng(SEED)
    keys = np.sort(rng.choice(1 << 22, 1500, replace=False)).astype(np.int32)
    args = dict(n_shards=8, levels=12, seed=SEED)
    report = {"phase": "small_sharded_check", "n": 1500, **args}
    t0 = time.perf_counter()
    for foresight in (True, False):
        v = variant(foresight)
        shl = shd.build_sharded(keys, keys * 3, foresight=foresight,
                                device=DEVICE, **args)
        cpu = shd.build_sharded(keys, keys * 3, foresight=foresight,
                                device="cpu", **args)
        check_same_sharded(shl, cpu, f"{v} build_sharded, card equals CPU")
        for name, fn in (("split_shard", lambda x: shd.split_shard(x, 0)),
                         ("merge_shards",
                          lambda x: shd.merge_shards(x, 2, seed=1)),
                         ("repack", lambda x: shd.repack(x, 5, seed=2))):
            check_same_sharded(fn(shl), fn(cpu),
                               f"{v} {name}, card equals CPU")
        shl, cpu = shd.split_shard(shl, 0), shd.split_shard(cpu, 0)   # S = 9
        q_np = np.concatenate([rng.choice(keys, 2048), rng.integers(
            0, 1 << 22, 2048)]).astype(np.int32)
        check_sharded_kernels(shl, on(DEVICE, q_np)[0], report,
                              f"{v}_half_hit")
        q, = on(DEVICE, straddle_stream(shl.boundaries))
        check_sharded_kernels(shl, q, report, f"{v}_straddle")
        plan = ops.cluster_queries(shl.boundaries, ops._pad(q)[0])
        split = ops.plan_degeneration_split(plan.ndist, shl.n_shards)
        check(split is not None, "the straddle stream takes K7's split")
        dense, clus = (KERNELS[n][0] for n in sharded_names(foresight))
        before = dense.launches, clus.launches
        got = ops.search_kernel_sharded(shl, q)
        check((dense.launches, clus.launches) ==
              (before[0] + 1, before[1] + 1), "K7 launched both kernels")
        want = ops.search_kernel_sharded(cpu, q.cpu())
        check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
              f"{v} search_kernel_sharded (K7), card equals CPU")
        report[f"{v}_straddle_k_small"] = split[0]
        try:
            ops.search_kernel_sharded(shl, q, k_shards=2)
        except ValueError:
            report[f"{v}_undersized_k"] = "raised"
        else:
            raise RuntimeError("check failed: undersized k_shards raises")

    # tests/test_rebalance.py:220's stream on a fully live index: 48 keys
    # over 4 shards of 16 slots, 4 batches of 32 Zipf inserts into shard 0
    krng = np.random.default_rng(SEED)
    k48 = np.sort(krng.choice(1 << 16, 48, replace=False)).astype(np.int32)
    results = {}
    for foresight in (True, False):
        v = variant(foresight)
        zrng = np.random.default_rng(7)
        st = {dev: shd.build_sharded(k48, k48 * 3, n_shards=4, capacity=16,
                                     levels=8, seed=SEED, foresight=foresight,
                                     device=dev) for dev in (DEVICE, "cpu")}
        for b in range(4):
            kk = (int(k48[2]) + (zrng.zipf(ZIPF_A, 32) - 1) % 4096
                  ).astype(np.int32)
            ins = np.full(32, sl.OP_INSERT, np.int32)
            res = {}
            for dev in st:
                st[dev], res[dev] = shd.apply_ops_sharded(
                    st[dev], *on(dev, ins, kk, kk * 2), rebalance=True,
                    seed=b)
            check(torch.equal(res[DEVICE].cpu(), res["cpu"]),
                  f"{v} rebalancing apply_ops_sharded results, card = CPU")
            check_same_sharded(st[DEVICE], st["cpu"],
                               f"{v} rebalancing apply_ops_sharded state")
        results[f"{v}_shards_after_zipf"] = st[DEVICE].n_shards
    report.update(results, zipf_ops=4 * 32, seconds=time.perf_counter() - t0)
    emit(report)


def fingerprint(shl: shd.ShardedSkipList) -> list:
    """Position-weighted sums of every stacked tensor, shard by shard."""
    out = [shl.boundaries.cpu().tolist()]
    for t in shl.shards:
        if t is None:
            continue
        for s in range(t.shape[0]):
            v = t[s].reshape(-1).long()
            w = torch.arange(1, v.numel() + 1, device=v.device)
            out.append(int((v * w).sum()))
    return out


def ungrouped_walk(shl: shd.ShardedSkipList, sid: torch.Tensor,
                   q: torch.Tensor, fat_keys) -> tuple:
    """The dense walk without grouping: lane i walks (sid[i], q[i]) in
    batch order and writes at i (``out_idx`` null).
    Called through ``_build.launch`` directly, to time it beside the
    grouped wrapper; it counts no launch."""
    node, key = torch.empty_like(q), torch.empty_like(q)
    tables = shard_tables(shl)
    S, L, cap = tables[0].shape[:3]
    width = 1 if fat_keys is None else fat_keys.shape[-1]
    symbol = ("foresight_sharded_launch" if shl.foresight
              else "base_sharded_launch")
    _build.launch(symbol, *(t.data_ptr() for t in tables),
                  None if fat_keys is None else fat_keys.data_ptr(),
                  sid.data_ptr(), None, q.data_ptr(), node.data_ptr(),
                  key.data_ptr(), q.numel(), S, L, cap, width,
                  ft.traversal_bound(L, cap),
                  torch.cuda.current_stream().cuda_stream)
    return node, key


def clustered_walk(tables, args, fat_keys) -> tuple:
    """K5 / K6 in the plan's lane order, one thread a lane (the launch the
    tile sort replaced, kept only as this yardstick), through the launcher
    directly; it counts no launch.  ``args`` are the wrapper's
    (block_sids, ndist, sid_sorted, q_sorted)."""
    bs, _, _, q = args
    node, key = torch.empty_like(q), torch.empty_like(q)
    S, L, cap = tables[0].shape[:3]
    v = "foresight" if len(tables) == 1 else "base"
    _build.launch(f"{v}_clustered_plan_order_launch",
                  *(t.data_ptr() for t in tables),
                  None if fat_keys is None else fat_keys.data_ptr(),
                  *(t.data_ptr() for t in args), node.data_ptr(),
                  key.data_ptr(), q.numel(), S, bs.shape[1], L, cap,
                  1 if fat_keys is None else fat_keys.shape[-1],
                  ft.traversal_bound(L, cap),
                  torch.cuda.current_stream().cuda_stream)
    return node, key


def clustered_times(tables, args, fat_keys, name: str) -> dict:
    """K5 / K6's wrapper (the tile-sorted walk) checked equal to the
    plan-order launch and timed beside it; the tile size, and profiles of
    one call (one kernel, no pass) and of the plan-order launch."""
    wrapper = KERNELS[name][0]
    fat = () if fat_keys is None else (fat_keys,)
    got = wrapper(*tables, *args, *fat)
    check(all(torch.equal(a, b) for a, b in
              zip(clustered_walk(tables, args, fat_keys), got)),
          f"{name} equals its plan-order launch")
    return {"plan_order_ms": time_ms(
                lambda: clustered_walk(tables, args, fat_keys), KERNEL_REPS),
            "tile_lanes": ft.CLUSTERED_TILE,
            "device_breakdown": device_breakdown(
                lambda: wrapper(*tables, *args, *fat), calls=5),
            "plan_order_device_breakdown": device_breakdown(
                lambda: clustered_walk(tables, args, fat_keys), calls=5)}


def check_grouping(sid: torch.Tensor, q: torch.Tensor, what: str) -> int:
    """``group_by_shard`` on the card equals its plain version (perm and
    offsets), ``perm`` a stable argsort of the bucket ids, and the sorted
    lanes ``q[perm]`` and ``sid[perm]``; returns the max abs error."""
    q_s, sid_s, perm, offsets = sg.group_by_shard(sid, q, SHARDS)
    err = max_abs_err((perm, offsets), sg.group_by_shard_plain(sid, SHARDS))
    check(err == 0, f"group_by_shard equals its plain version ({what})")
    mapped = torch.where((sid >= 0) & (sid < SHARDS), sid, SHARDS)
    check(torch.equal(perm.long(), torch.argsort(mapped, stable=True)),
          f"group_by_shard's perm is a stable argsort ({what})")
    check(torch.equal(q_s, q[perm.long()]) and
          torch.equal(sid_s, sid[perm.long()]),
          f"group_by_shard's q_sorted and sid_sorted ({what})")
    return err


def sharded_full_size(keys_np: np.ndarray, traffic: dict, stream: tuple,
                      foresight: bool, first: dict, width: int = 1,
                      scalar: dict = None) -> tuple:
    """The paper's keys over 64 shards: build, both traffics through the
    dense and clustered paths, one update batch (``stream``: the ops and
    their host-oracle answers), then checks, times and bounds.  ``first``
    carries the foresight run's answers to the base run.  ``width`` > 1
    builds fat shards (K9 in every launch; the eager ``search_sharded``
    and node ids into ``fat_vals`` are checked too, and ``scalar``, the
    scalar runs' answers, must give the same found and vals).  The dense
    kernel is also timed ungrouped (``ungrouped_walk``), and the grouping
    pass alone.  Returns (kernels-line rows, answers, the build's
    fingerprint, the grouping pass's row and times)."""
    stage_s, t_stage = {}, time.perf_counter()
    t_phase = t_stage

    def lap(stage: str) -> None:
        nonlocal t_stage
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage_s[stage] = stage_s.get(stage, 0.0) + now - t_stage
        t_stage = now

    dev = torch.device(DEVICE)
    v = variant(foresight)
    fat = width > 1
    dense, clus = sharded_names(foresight)
    row = (lambda n: fat_row_name(n, width)) if fat else (lambda n: n)
    count = (lambda n: f"{n}/fat") if fat else (lambda n: n)
    (types, ks, vs), want_results, current = stream
    qs = {name: torch.from_numpy(q).to(dev) for name, q in traffic.items()}
    torch.cuda.reset_peak_memory_stats()

    # The main path, with every launch counter at 0 just before it.
    reset_launches()
    t0 = time.perf_counter()
    shl = shd.build_sharded(torch.from_numpy(keys_np).to(dev),
                            torch.from_numpy(keys_np + 1).to(dev),
                            n_shards=SHARDS, levels=SHARD_LEVELS,
                            foresight=foresight, seed=SEED,
                            node_width=width, device=dev)
    fatk = shl.shards.fat_keys                     # None on scalar shards
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    res = {(name, cl): ops.search_kernel_sharded(shl, q, cluster=cl)
           for name, q in qs.items() for cl in (False, True)}
    before = fingerprint(shl)
    t0 = time.perf_counter()
    new, results = shd.apply_ops_sharded(shl, *on(dev, types, ks, vs))
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    after_update = ops.search_kernel_sharded(new, qs["uniform"])
    torch.cuda.synchronize()
    launches = read_launches()
    lap("main_path")
    for name in (dense, clus):
        check(launches[count(name)] >= 1, f"sharded path launched {name} "
                                          f"(width {width})")
    if fat:
        check(launches["fat_resolve"] >= 1, "sharded path ran K9")

    answers = {}
    for (name, cl), r in res.items():
        what = f"{v} width {width} {name} cluster={cl}"
        check_lookups(r.found, r.vals, traffic[name], keys_np, what)
        answers[(name, cl)] = [t.cpu() for t in r]
        if fat:
            hit = r.found
            check(torch.equal(shl.shards.fat_vals.reshape(-1)[
                r.node[hit].long()], r.vals[hit]),
                f"{what}: node ids dereference into fat_vals")
            check(all(torch.equal(a, b) for a, b in zip(
                answers[(name, cl)][:2], scalar[(name, cl)][:2])),
                f"{what}: found and vals equal the scalar run's")
    if fat:            # S * L * cap = 4.4e7: the eager search takes it
        for name, q in qs.items():
            f, vals = shd.search_sharded(shl, q)
            check(torch.equal(f, res[(name, False)].found) and
                  torch.equal(vals, res[(name, False)].vals),
                  f"{v} fat search_sharded equals the kernels ({name})")
    for name in qs:
        check(all(torch.equal(a, b) for a, b in
                  zip(answers[(name, True)], answers[(name, False)])),
              f"{v} {name}: clustered equals dense (found, vals, node)")
    if first:
        check(all(torch.equal(a, b) for key in answers
                  for a, b in zip(answers[key], first[key])),
              "foresight and base give the same found, vals, node")
    check(np.array_equal(results.cpu().numpy(), want_results),
          "every apply_ops_sharded result equals the oracle")
    check_lookups(after_update.found, after_update.vals, traffic["uniform"],
                  current, "search_kernel_sharded after the update")
    check(bool(shd.check_sharded_invariant(new, expect_n=len(current))),
          "sharded invariant and live count after the update")
    if fat:
        check(all(bool(sl.check_fat_invariant(shd.shard_view(new.shards, s)))
                  for s in range(new.n_shards)),
              "check_fat_invariant on every shard after the update")
    check(fingerprint(shl) == before, "apply_ops_sharded leaves its input "
                                      "unchanged")
    del new, after_update
    torch.cuda.empty_cache()
    lap("oracle_checks")

    phase = "fat_sharded_full_size" if fat else "sharded_full_size"
    report = {"phase": phase, "variant": v, "node_width": width,
              "n": FULL_N, "shards": SHARDS, "levels": SHARD_LEVELS,
              "shard_capacity": shl.shard_capacity,
              "index_gb": SHARDS * ops.tile_bytes(
                  SHARD_LEVELS, shl.shard_capacity, foresight, width) / 1e9,
              "stack_gb": sum(t.numel() * t.element_size()
                              for t in shl.shards if t is not None) / 1e9,
              "build_s": build_s, "update_ops": SHARD_UPDATE_OPS,
              "update_s": update_s,
              "update_us_per_op": update_s / SHARD_UPDATE_OPS * 1e6}
    sorted_keys = torch.from_numpy(keys_np).to(dev)
    rows = {}
    grouping = {"dense_ms": {}, "ungrouped_ms": {}}
    for name, q in qs.items():
        sid = shd.route(shl.boundaries, q)
        plan = ops.cluster_queries(shl.boundaries, q)
        split = ops.plan_degeneration_split(plan.ndist, SHARDS)
        clus_args = (plan.block_sids, plan.ndist, plan.sid_sorted,
                     plan.q_sorted)
        fp = path_footprint(shard_tables(shl), q, sid, fatk)
        lap("footprint_replay")
        t = {}
        for kname, args in ((dense, (sid, q)), (clus, clus_args)):
            wrapper, plain, *_ = KERNELS[kname]
            got = wrapper(*shard_tables(shl), *args, fatk)
            err = max_abs_err(got, plain(*shard_tables(shl), *args, fatk))
            check(err == 0, f"{kname} (width {width}) equals its plain "
                            f"version ({name})")
            t[kname] = dict(
                err=err,
                ms=time_ms(lambda: wrapper(*shard_tables(shl), *args, fatk),
                           KERNEL_REPS),
                plain_ms=time_ms(lambda: plain(*shard_tables(shl), *args,
                                               fatk), PLAIN_REPS))
            if kname == dense:     # the ungrouped launch, in the same run
                check(all(torch.equal(a, b) for a, b in zip(
                    ungrouped_walk(shl, sid, q, fatk), got)),
                    f"{kname} ungrouped equals grouped ({name})")
                t[kname]["ungrouped_ms"] = time_ms(
                    lambda: ungrouped_walk(shl, sid, q, fatk), KERNEL_REPS)
                # device time by kernel of one call: the pass and the walk
                t[kname]["profile"] = device_breakdown(
                    lambda: wrapper(*shard_tables(shl), *args, fatk))
                t[kname]["ungrouped_profile"] = device_breakdown(
                    lambda: ungrouped_walk(shl, sid, q, fatk))
            else:           # the plan-order launch, in the same run
                t[kname].update(clustered_times(shard_tables(shl), args,
                                                fatk, kname))
        g_err = check_grouping(sid, q, f"{v} width {width} {name}")
        group = dict(
            err=g_err,
            ms=time_ms(lambda: sg.group_by_shard(sid, q, SHARDS),
                       KERNEL_REPS),
            plain_ms=time_ms(lambda: sg.group_by_shard_plain(sid, SHARDS),
                             PLAIN_REPS),
            library_ms=time_ms(lambda: torch.sort(sid, stable=True),
                               KERNEL_REPS))
        lap("kernel_checks_and_timing")
        plan_ms = time_ms(lambda: ops.cluster_queries(shl.boundaries, q),
                          KERNEL_REPS)
        e2e = {cl: time_ms(lambda: ops.search_kernel_sharded(
            shl, q, cluster=cl), KERNEL_REPS) for cl in (False, True)}
        library_ms = time_ms(lambda: torch.searchsorted(sorted_keys, q),
                             KERNEL_REPS)
        lap("timing")
        B = q.numel()
        nblk, K = plan.block_sids.shape
        io = {dense: B * 4 * 4,                       # q, sid in; node, key
              clus: B * 4 * 4 + (nblk * K + nblk) * 4}   # + the plan
        # one compare a step, and B a query for K9's run
        ops_ms = (fp["steps"] + fp.get("compares", 0)) \
            / SCALAR_OPS_PER_S * 1e3
        nd = plan.ndist.cpu().numpy()
        report[name] = {
            "phase": phase, "variant": v, "node_width": width,
            "traffic": name,
            "batch": B, "hits": int(res[(name, False)].found.sum()),
            "mean_path_steps": fp["steps"] / B,
            "max_path_steps": int(fp["path"].max()),
            "distinct_bytes": fp["distinct_bytes"],
            "distinct_runs": fp.get("distinct_runs"),
            "sector_bytes": fp["sector_bytes"],
            "auto_k": K, "k7_split": None if split is None else {
                "k_small": split[0], "keep_blocks": len(split[1]),
                "straggler_blocks": len(split[2])},
            "ndist_histogram": {int(k): int(c) for k, c in
                                zip(*np.unique(nd, return_counts=True))},
            "lanes_on_busiest_shard": int(torch.bincount(
                plan.sid_sorted.long(), minlength=SHARDS).max()),
            "plan_ms": plan_ms, "search_kernel_sharded_ms": {
                "dense": e2e[False], "clustered": e2e[True]},
            "library_ms": library_ms,
            "group_ms": group["ms"],
            "group_by_shard_launches": launches["group_by_shard"]}
        # sid and q read once; q_sorted, sid_sorted, perm and the offsets
        # written once
        group_bytes_ms = (B * 4 * 5 + (SHARDS + 2) * 4) \
            / HBM_BYTES_PER_S * 1e3
        report[name]["group_by_shard"] = {
            **group, "bound_ms": group_bytes_ms,
            "bound_share": group_bytes_ms / group["ms"]}
        grouping.setdefault("row", {
            "name": "group_by_shard", "route": "cuda",
            "source": SHARD_GROUP_CU, "replaces": KERNELS["group_by_shard"][3],
            "launches": launches["group_by_shard"], "max_abs_err": g_err,
            "ms": group["ms"], "plain_ms": group["plain_ms"],
            "bound_ms": group_bytes_ms, "bound_by": "bytes",
            "library_ms": group["library_ms"]})
        grouping["row"]["max_abs_err"] = max(grouping["row"]["max_abs_err"],
                                             g_err)
        for kname in (dense, clus):
            bytes_ms = (fp["distinct_bytes"] + io[kname]) \
                / HBM_BYTES_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            sector_ms = (fp["sector_bytes"] + io[kname]) \
                / HBM_BYTES_PER_S * 1e3
            report[name][kname] = {
                **t[kname], "mops": B / t[kname]["ms"] / 1e3,
                "bound_ms": bound_ms, "sector_bound_ms": sector_ms,
                "bound_share": bound_ms / t[kname]["ms"]}
            if kname == dense:
                report[name][kname]["grouped_over_ungrouped_ms"] = \
                    t[kname]["ms"] / t[kname]["ungrouped_ms"]
                grouping["dense_ms"][name] = t[kname]["ms"]
                grouping["ungrouped_ms"][name] = t[kname]["ungrouped_ms"]
            wrapper, plain, source, replaces = KERNELS[kname]
            rows.setdefault(kname, {
                "name": row(kname), "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[count(kname)],
                "max_abs_err": t[kname]["err"], "ms": t[kname]["ms"],
                "plain_ms": t[kname]["plain_ms"], "bound_ms": bound_ms,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": library_ms, "sector_bound_ms": sector_ms,
                **({"ungrouped_ms": t[kname]["ungrouped_ms"]}
                   if kname == dense else
                   {"plan_order_ms": t[kname]["plan_order_ms"],
                    "tile_lanes": t[kname]["tile_lanes"]})})
    report["clustered_over_dense_ms"] = {
        name: report[name][clus]["ms"] / report[name][dense]["ms"]
        for name in qs}
    report["clustered_over_plan_order_ms"] = {
        name: report[name][clus]["ms"] / report[name][clus]["plan_order_ms"]
        for name in qs}
    for name in qs:                      # one line a traffic, then the phase
        emit(report.pop(name))
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    report["stage_s"] = stage_s
    report["seconds"] = time.perf_counter() - t_phase
    emit(report)
    del shl, res, sorted_keys, qs, fatk
    torch.cuda.empty_cache()
    return list(rows.values()), answers, before, grouping


# ---------------------------------------------------------------------------
# The mesh index (K10) at D = 1: one process group of one rank
# ---------------------------------------------------------------------------

MESH_PY = "src/repro/kernels/mesh_launch.py"


def init_mesh_group() -> dict:
    """One rank, world size 1, an in-process store (no TCP rendezvous): NCCL
    carries the card's tensors; gloo (on the loopback device) carries the
    CPU run that the card is held against.  {device: its index mesh}."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(),
                            rank=0, world_size=1)
    return {DEVICE: make_index_mesh(1), "cpu": make_index_mesh(1, "cpu")}


def check_same_mesh(got: mi.MeshShardedIndex, want: mi.MeshShardedIndex,
                    what: str) -> None:
    a, b = mesh_to_numpy(got), mesh_to_numpy(want)
    check(sorted(a) == sorted(b), f"{what} (fields)")
    for k in a:
        check(np.array_equal(a[k], b[k]), f"{what} ({k})")


def check_same_stats(got: rbt.DeviceLoadStats, want: rbt.DeviceLoadStats,
                     what: str) -> None:
    for g, w in zip(got, want):
        check(g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu()),
              f"{what} (DeviceLoadStats)")


def mesh_plan(mx: mi.MeshShardedIndex, q: torch.Tensor) -> tuple:
    """K5/K6's arguments for the lanes a one-device mesh receives (``q``
    itself), planned as ``search_kernel_mesh`` plans them."""
    local = mx.local
    plan = ops.cluster_queries(local.boundaries, ops._pad(q)[0],
                               k_shards=min(ft.QBLK, local.n_shards))
    return (plan.block_sids, plan.ndist, plan.sid_sorted, plan.q_sorted,
            local.shards.fat_keys)


def small_mesh_check(meshes: dict) -> None:
    """The mesh index on the card equals the port's CPU run: build, the
    eager and kernel searches, the dispatch, K5/K6 against their plain
    versions, a rebalancing apply on an empty mesh index, and the in-place
    passes on a padded index."""
    rng = np.random.default_rng(SEED)
    keys = np.sort(rng.choice(1 << 22, 1500, replace=False)).astype(np.int32)
    q_np = np.concatenate([rng.choice(keys, 2048), rng.integers(
        0, 1 << 22, 2048)]).astype(np.int32)
    report = {"phase": "small_mesh_check", "n": 1500, "shards": 8,
              "levels": 12, "devices": 1}
    t0 = time.perf_counter()
    for foresight in (True, False):
        for width in (1, 8):
            label = f"{variant(foresight)} B={width}"
            mx, out = {}, {}
            for dev, mesh in meshes.items():
                mx[dev] = mi.build_mesh_index(
                    keys, keys * 3, n_devices=1, n_shards=8, levels=12,
                    seed=SEED, foresight=foresight, node_width=width, rank=0,
                    device=dev)
                q, = on(dev, q_np)
                before = ml.search_kernel_mesh.launches
                out[dev] = [*mi.search_mesh(mx[dev], q, mesh=mesh),
                            *ml.search_kernel_mesh(mx[dev], q, mesh=mesh),
                            *ops.search_kernel(mx[dev], q, mesh=mesh)]
                if dev == DEVICE:
                    check(ml.search_kernel_mesh.launches == before + 2,
                          f"{label}: K10 launched K5/K6")
            check_same_mesh(mx[DEVICE], mx["cpu"],
                            f"{label} build_mesh_index, card equals CPU")
            check(all(torch.equal(a.cpu(), b) for a, b in
                      zip(out[DEVICE], out["cpu"])),
                  f"{label} search_mesh, search_kernel_mesh and search_kernel"
                  "(mesh=): found, vals, node, card equals CPU")
            check(torch.equal(out[DEVICE][0], out[DEVICE][2]) and
                  torch.equal(out[DEVICE][1], out[DEVICE][3]),
                  f"{label}: the kernels equal the eager mesh search")
            name = sharded_names(foresight)[1]
            wrapper, plain, *_ = KERNELS[name]
            local = mx[DEVICE].local
            args = mesh_plan(mx[DEVICE], on(DEVICE, q_np)[0])
            got = wrapper(*shard_tables(local), *args)
            err = max_abs_err(got, plain(*shard_tables(local), *args))
            check(err == 0, f"{label}: {name} equals its plain version")
            check(all(torch.equal(a, b) for a, b in zip(clustered_walk(
                shard_tables(local), args[:4], args[4]), got)),
                f"{label}: {name} equals its plan-order launch")
            report[f"{name}_B{width}_err"] = err

    # rebalancing: the in-place passes on an empty mesh index (8 shards of
    # 16 slots) under 4 batches of 32 Zipf inserts, and on a padded index
    k48 = np.sort(np.random.default_rng(SEED).choice(
        1 << 16, 48, replace=False)).astype(np.int32)
    for foresight in (True, False):
        v = variant(foresight)
        em = {dev: mi.empty_mesh_index(
            n_devices=1, n_shards=8, capacity=16, levels=8, seed=SEED,
            foresight=foresight, key_span=1 << 16, rank=0, device=dev)
            for dev in meshes}
        zrng = np.random.default_rng(7)
        for b in range(4):
            kk = (int(k48[2]) + (zrng.zipf(ZIPF_A, 32) - 1) % 4096
                  ).astype(np.int32)
            ins = np.full(32, sl.OP_INSERT, np.int32)
            res, stats = {}, {}
            for dev, mesh in meshes.items():
                em[dev], res[dev], stats[dev] = mi.apply_ops_mesh(
                    em[dev], *on(dev, ins, kk, kk * 2), mesh=mesh,
                    rebalance=True, seed=b)
            what = f"{v} rebalancing apply_ops_mesh, batch {b}"
            check(torch.equal(res[DEVICE].cpu(), res["cpu"]),
                  f"{what}: results, card equals CPU")
            check_same_mesh(em[DEVICE], em["cpu"], f"{what}: state")
            check_same_stats(stats[DEVICE], stats["cpu"], what)
        report[f"{v}_live_shards_after_zipf"] = rbt.live_shard_count(
            em[DEVICE].local)
        check(report[f"{v}_live_shards_after_zipf"] > 1,
              f"{v}: the in-place passes split the empty mesh index")
        st = {}
        for dev in meshes:
            x = rbt.pad_shards(shd.build_sharded(
                k48, k48 * 3, n_shards=4, capacity=16, levels=8, seed=SEED,
                foresight=foresight, device=dev), 16)
            at = int(x.boundaries[1]) + 1
            x = rbt.split_shard_traced(x, 1, at, seed=5)
            x = rbt.merge_shards_traced(x, 1, seed=3)
            x, stats = rbt.watermark_rebalance_traced(x, seed=2)
            kk = (int(k48[2]) + (np.random.default_rng(9).zipf(ZIPF_A, 96)
                                 - 1) % 4096).astype(np.int32)
            x, splits = rbt.exhaustion_guard_traced(
                x, *on(dev, np.full(96, sl.OP_INSERT, np.int32), kk),
                seed=11)
            st[dev] = (x, stats, splits)
        check_same_sharded(st[DEVICE][0], st["cpu"][0],
                           f"{v} pad_shards + in-place passes")
        check(st[DEVICE][1:] == st["cpu"][1:],
              f"{v} in-place passes: split and merge counts")
        report[f"{v}_in_place_guard_splits"] = st[DEVICE][2]
    report["seconds"] = time.perf_counter() - t0
    emit(report)


def mesh_exchange(mx: mi.MeshShardedIndex, q: torch.Tensor, mesh) -> list:
    """K10's data movement alone: route, sort, the outbound exchange of
    the queries and the return exchange of three result lanes."""
    D, _, group = mi._validate(mx, mesh)
    did = shd.route(mx.device_boundaries, q)
    (rq,), _, perm, starts, did_s = mi._exchange_out(did, (q,), (0,), D,
                                                     group)
    return mi._exchange_back((rq, rq, rq), perm, starts, did_s, D, group)


def device_breakdown(fn, top: int = 10, tries: int = 3, calls: int = 1,
                     walk: str = None) -> dict:
    """``calls`` calls of ``fn`` under ``torch.profiler``: the device
    kernels that ran, by device time a call (the ``top`` largest), and
    their sum.  A profile that recorded no device event (the tracer
    sometimes loses a cycle's events), or with ``walk`` none of that
    kernel, is taken again, at most ``tries`` times in all.  With ``walk``
    the sum is also split into that kernel's time and the rest's (a
    grouping pass)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = sorted(((e.key, e.device_time_total / 1e3 / calls,
                        e.count / calls)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.device_time_total > 0),
                      key=lambda r: -r[1])
        if rows and (walk is None or any(walk in k for k, *_ in rows)):
            break
    out = {"device_ms": sum(r[1] for r in rows), "launches":
           sum(r[2] for r in rows), "top": [[k[:80], ms, n]
                                            for k, ms, n in rows[:top]]}
    if walk is not None:
        out["walk_device_ms"] = sum(ms for k, ms, _ in rows if walk in k)
        out["pass_device_ms"] = out["device_ms"] - out["walk_device_ms"]
        out["calls"] = calls
    return out


def mesh_full_size(keys_np: np.ndarray, traffic: dict, stream: tuple,
                   foresight: bool, sharded: tuple, mesh) -> dict:
    """The paper's keys through ``build_mesh_index(n_devices=1,
    n_shards=64)``: the build against ``build_sharded``'s fingerprint, both
    traffics through ``search_kernel_mesh`` against the oracle and the
    sharded clustered answers (``sharded``: (fingerprint, answers)), 256
    updates through ``apply_ops_mesh``, then times of the whole path, its
    exchange and its K5/K6 launch, with the bound and the library time.
    Returns the phase's report."""
    stage_s, t_stage = {}, time.perf_counter()
    t_phase = t_stage

    def lap(stage: str) -> None:
        nonlocal t_stage
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage_s[stage] = stage_s.get(stage, 0.0) + now - t_stage
        t_stage = now

    dev = torch.device(DEVICE)
    v = variant(foresight)
    clus = sharded_names(foresight)[1]
    fp_sharded, answers = sharded
    (types, ks, vs), want_results, current = stream
    qs = {name: torch.from_numpy(q).to(dev) for name, q in traffic.items()}
    torch.cuda.reset_peak_memory_stats()

    # The main path, with every launch counter at 0 just before it.
    reset_launches()
    t0 = time.perf_counter()
    mx = mi.build_mesh_index(torch.from_numpy(keys_np).to(dev),
                             torch.from_numpy(keys_np + 1).to(dev),
                             n_devices=1, n_shards=SHARDS,
                             levels=SHARD_LEVELS, foresight=foresight,
                             seed=SEED, rank=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    res = {name: ml.search_kernel_mesh(mx, q, mesh=mesh)
           for name, q in qs.items()}
    t0 = time.perf_counter()
    new, results, stats = mi.apply_ops_mesh(mx, *on(dev, types, ks, vs),
                                            mesh=mesh)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    after_update = ml.search_kernel_mesh(new, qs["uniform"], mesh=mesh)
    torch.cuda.synchronize()
    launches = read_launches()
    mesh_launches = launches["search_kernel_mesh"]
    lap("main_path")
    check(mesh_launches >= 1 and launches[clus] == mesh_launches,
          f"the mesh path launched {clus} through K10")

    check(fingerprint(mx.local) == fp_sharded,
          f"{v} build_mesh_index equals build_sharded (fingerprint)")
    for name, r in res.items():
        what = f"{v} search_kernel_mesh {name}"
        check_lookups(r.found, r.vals, traffic[name], keys_np, what)
        check(all(torch.equal(a.cpu(), b) for a, b in
                  zip(r, answers[(name, True)])),
              f"{what}: found, vals, node equal search_kernel_sharded's")
    check(np.array_equal(results.cpu().numpy(), want_results),
          "every apply_ops_mesh result equals the oracle")
    check_lookups(after_update.found, after_update.vals, traffic["uniform"],
                  current, "search_kernel_mesh after the update")
    check(bool(mi.check_mesh_invariant(new, expect_n=len(current),
                                       mesh=mesh)),
          "check_mesh_invariant and the live count after the update")
    check(int(stats.live[0]) == len(current) and
          int(stats.routed[0]) == SHARD_UPDATE_OPS and
          float(stats.live_imbalance) == 1.0,
          "DeviceLoadStats after the update")
    del new, after_update
    torch.cuda.empty_cache()
    lap("oracle_checks")

    report = {"phase": "mesh_full_size", "variant": v, "devices": 1,
              "n": FULL_N, "shards": SHARDS, "levels": SHARD_LEVELS,
              "shard_capacity": mx.shard_capacity, "k_shards":
              min(ft.QBLK, SHARDS), "build_s": build_s,
              "update_ops": SHARD_UPDATE_OPS, "update_s": update_s,
              "update_us_per_op": update_s / SHARD_UPDATE_OPS * 1e6,
              "k10_launches": mesh_launches}
    sorted_keys = torch.from_numpy(keys_np).to(dev)
    wrapper, plain, *_ = KERNELS[clus]
    tables = shard_tables(mx.local)
    for name, q in qs.items():
        args = mesh_plan(mx, q)
        got = wrapper(*tables, *args)
        err = max_abs_err(got, plain(*tables, *args))
        check(err == 0, f"{clus} equals its plain version on the mesh's "
                        f"lanes ({name})")
        check(all(torch.equal(a, b) for a, b in
                  zip(clustered_walk(tables, args[:4], args[4]), got)),
              f"{clus} equals its plan-order launch on the mesh's lanes "
              f"({name})")
        del got
        sid = shd.route(mx.local.boundaries, q)
        fp = path_footprint(tables, q, sid)
        lap("kernel_check_and_replay")
        t = dict(
            e2e_ms=time_ms(lambda: ml.search_kernel_mesh(mx, q, mesh=mesh),
                           KERNEL_REPS),
            # the same index as one ShardedSkipList, the same call as K10's
            sharded_e2e_ms=time_ms(lambda: ops.search_kernel_sharded(
                mx.local, q, cluster=True, k_shards=args[0].shape[1]),
                KERNEL_REPS),
            exchange_ms=time_ms(lambda: mesh_exchange(mx, q, mesh),
                                KERNEL_REPS),
            ms=time_ms(lambda: wrapper(*tables, *args), KERNEL_REPS),
            plan_order_ms=time_ms(
                lambda: clustered_walk(tables, args[:4], args[4]),
                KERNEL_REPS),
            plain_ms=time_ms(lambda: plain(*tables, *args), PLAIN_REPS),
            library_ms=time_ms(lambda: torch.searchsorted(sorted_keys, q),
                               KERNEL_REPS))
        prof = device_breakdown(
            lambda: ml.search_kernel_mesh(mx, q, mesh=mesh))
        prof["idle_share"] = 1 - prof["device_ms"] / t["e2e_ms"]
        t["kernel_device_breakdown"] = device_breakdown(
            lambda: wrapper(*tables, *args), calls=5)
        lap("timing")
        B = q.numel()
        nblk, K = args[0].shape
        io = B * 4 * 4 + (nblk * K + nblk) * 4         # q, sid, node, key
        bytes_ms = (fp["distinct_bytes"] + io) / HBM_BYTES_PER_S * 1e3
        ops_ms = fp["steps"] / SCALAR_OPS_PER_S * 1e3
        report[name] = {**t, "max_abs_err": err, "batch": B,
                        "hits": int(res[name].found.sum()),
                        "mean_path_steps": fp["steps"] / B,
                        "bound_ms": max(bytes_ms, ops_ms),
                        "sector_bound_ms": (fp["sector_bytes"] + io)
                        / HBM_BYTES_PER_S * 1e3,
                        "bound_by": ("bytes" if bytes_ms >= ops_ms
                                     else "operations"),
                        "exchange_share": t["exchange_ms"] / t["e2e_ms"],
                        "mesh_over_sharded_e2e": t["e2e_ms"]
                        / t["sharded_e2e_ms"], "profile": prof}
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    report["stage_s"] = stage_s
    report["seconds"] = time.perf_counter() - t_phase
    emit(report)
    del mx, res, sorted_keys, qs, tables
    torch.cuda.empty_cache()
    report["launches"] = launches
    return report


def mesh_row(reports: list) -> dict:
    """The kernels-line row of K10, from the foresight run on traffic A
    (uniform); launches over both variants' main paths."""
    a = reports[0]["uniform"]
    return {"name": "search_kernel_mesh", "route": "cuda",
            "source": TRAVERSE_CU, "launcher":
            "src/repro_torch/kernels/mesh_launch.py",
            "replaces": f"{MESH_PY}:78",
            "launches": sum(r["k10_launches"] for r in reports),
            "max_abs_err": max(r[t]["max_abs_err"] for r in reports
                               for t in ("uniform", "zipf")),
            "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
            "sector_bound_ms": a["sector_bound_ms"],
            "library_ms": a["library_ms"], "e2e_ms": a["e2e_ms"],
            "exchange_ms": a["exchange_ms"],
            "plan_order_ms": a["plan_order_ms"]}


def fat_tables(st: sl.SkipListState):
    """A fat state's walk tables, then its run keys (the K9 argument)."""
    return (*table_args(st), st.fat_keys)


def fat_row_name(name: str, width: int) -> str:
    return f"{name}/fat{width}"


def check_fat_kernel(name: str, tables, args, report: dict, label: str,
                     max_steps: int = 0) -> None:
    """Kernel ``name`` with K9 equals its plain version on the card; the
    launch is counted as a fat launch.  ``tables`` ends with fat_keys."""
    wrapper, plain, *_ = KERNELS[name]
    *walk, fat = tables
    before = wrapper.fat_launches
    got = wrapper(*walk, *args, fat, max_steps=max_steps)
    check(wrapper.fat_launches == before + 1, f"{name} fat launch counted")
    err = max_abs_err(got, plain(*walk, *args, fat, max_steps=max_steps))
    check(err == 0, f"{name} + K9 equals its plain version ({label}, "
                    f"max_steps={max_steps})")
    report[f"{name}_{label}_steps{max_steps}_err"] = err


def fat_case_stream(width: int, seed: int):
    """Ops on the dense range [0, 1.25 B) that run every fat case: the
    first node of an empty list, shifts with room, a median split,
    upserts, deletes of a run's minimum and of an inner lane, emptied
    runs, the list emptied and a first node again."""
    rng = np.random.default_rng(seed)
    span = width + width // 4
    fill = rng.permutation(span).astype(np.int32)
    mixed = rng.integers(0, span, 32).astype(np.int32)
    drain = rng.permutation(span).astype(np.int32)
    ks = np.concatenate([fill, fill[:4], mixed, drain, fill[:3]])
    types = np.concatenate([
        np.full(span + 4, sl.OP_INSERT), rng.integers(1, 3, 32),
        np.full(span, sl.OP_DELETE), np.full(3, sl.OP_INSERT)])
    return types.astype(np.int32), ks, ks * 5 + 1


def small_fat_check() -> None:
    """The fat layout on the card equals the CPU, at B = 8 and 128, both
    variants; K1-K6 with K9 equal their plain versions; every update case
    runs; K1 + K9 at B = 6, 33 and 256, K9's tiling edges."""
    rng = np.random.default_rng(SEED)
    keys = small_keys()
    keys_sh = np.sort(rng.choice(1 << 22, 1500, replace=False)
                      ).astype(np.int32)
    report = {"phase": "small_fat_check", "n": SMALL["n"], "levels": 14,
              "sharded_n": 1500, "shards": "8, then 9"}
    t0 = time.perf_counter()
    for width in (8, 128):
        for foresight in (True, False):
            v = f"{variant(foresight)}{width}"
            k1 = f"{variant(foresight)}_traverse"
            args = dict(capacity=sl.node_slots_for(2 * SMALL["n"], width)
                        + 4, levels=14, foresight=foresight,
                        node_width=width, seed=SEED)
            st = sl.build(keys, keys + 1, device=DEVICE, **args)
            cpu = sl.build(keys, keys + 1, device="cpu", **args)
            check_same_state(st, cpu, f"{v} fat build, card equals CPU")
            q, = on(DEVICE, np.concatenate([rng.choice(keys, 2048),
                                            rng.integers(0, 1 << 22, 2048)]
                                           ).astype(np.int32))
            for max_steps in (0, 9):
                check_fat_kernel(k1, fat_tables(st), (q,), report, v,
                                 max_steps)
            got = ops.search_kernel(st, q)
            want = ops.search_kernel(cpu, q.cpu())
            check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
                  f"{v} fat search_kernel, card equals CPU")
            for lo, hi, m in ((0, 1 << 22, 300), (int(keys[50]) + 1,
                                                  int(keys[900]), 64)):
                check(all(torch.equal(a.cpu(), b) for a, b in zip(
                    sl.range_scan(st, lo, hi, m),
                    sl.range_scan(cpu, lo, hi, m))),
                      f"{v} fat range_scan, card equals CPU")

            stream = fat_case_stream(width, SEED + width)
            empty = {dev: sl.empty(8, 6, foresight=foresight, seed=SEED,
                                   node_width=width, device=dev)
                     for dev in (DEVICE, "cpu")}
            sl.FAT_CASES.clear()
            new, res = sl.apply_ops(empty[DEVICE], *on(DEVICE, *stream))
            report[f"{v}_update_cases"] = dict(sl.FAT_CASES)
            for case in ("insert_upsert", "insert_room", "insert_split",
                         "insert_first", "delete_plain", "delete_min",
                         "delete_emptied"):
                check(sl.FAT_CASES[case] > 0, f"{v} update case {case} ran")
            new_cpu, res_cpu = sl.apply_ops(empty["cpu"], *on("cpu",
                                                              *stream))
            check(torch.equal(res.cpu(), res_cpu),
                  f"{v} fat apply_ops results, card equals CPU")
            check_same_state(new, new_cpu, f"{v} fat apply_ops state")
            check(bool(sl.check_fat_invariant(new)) and
                  bool(sl.check_fat_invariant(new_cpu)),
                  f"{v} check_fat_invariant after the stream")
            check_same_state(empty[DEVICE], sl.empty(
                8, 6, foresight=foresight, seed=SEED, node_width=width,
                device="cpu"), f"{v} fat apply_ops leaves its input unchanged")

            sargs = dict(n_shards=8, levels=12, foresight=foresight,
                         node_width=width, seed=SEED)
            shl = shd.build_sharded(keys_sh, keys_sh * 3, device=DEVICE,
                                    **sargs)
            shc = shd.build_sharded(keys_sh, keys_sh * 3, device="cpu",
                                    **sargs)
            check_same_sharded(shl, shc, f"{v} fat build_sharded")
            for name, fn in (("split_shard", lambda x: shd.split_shard(x, 0)),
                             ("merge_shards",
                              lambda x: shd.merge_shards(x, 2, seed=1)),
                             ("repack", lambda x: shd.repack(x, 5, seed=2))):
                check_same_sharded(fn(shl), fn(shc), f"{v} fat {name}")
            shl, shc = shd.split_shard(shl, 0), shd.split_shard(shc, 0)
            dense, clus = sharded_names(foresight)
            tables = (*shard_tables(shl), shl.shards.fat_keys)
            q, = on(DEVICE, np.concatenate([
                rng.choice(keys_sh, 2048),
                rng.integers(0, 1 << 22, 2048)]).astype(np.int32))
            sid = shd.route(shl.boundaries, q)
            plan = ops.cluster_queries(shl.boundaries, ops._pad(q)[0])
            for max_steps in (0, 9):
                check_fat_kernel(dense, tables, (sid, q), report, v,
                                 max_steps)
                check_fat_kernel(clus, tables, (plan.block_sids, plan.ndist,
                                                plan.sid_sorted,
                                                plan.q_sorted),
                                 report, v, max_steps)
            q, = on(DEVICE, straddle_stream(shl.boundaries))
            plan = ops.cluster_queries(shl.boundaries, ops._pad(q)[0])
            check(ops.plan_degeneration_split(plan.ndist, 9) is not None,
                  f"{v} fat straddle stream takes K7's split")
            w_d, w_c = (KERNELS[n][0] for n in (dense, clus))
            before = w_d.fat_launches, w_c.fat_launches
            got = ops.search_kernel_sharded(shl, q)
            check((w_d.fat_launches, w_c.fat_launches) ==
                  (before[0] + 1, before[1] + 1), f"{v} fat K7 launched both")
            want = ops.search_kernel_sharded(shc, q.cpu())
            check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
                  f"{v} fat search_kernel_sharded (K7), card equals CPU")
            f, vals = shd.search_sharded(shl, q)
            check(torch.equal(f, got.found) and torch.equal(vals, got.vals),
                  f"{v} fat search_sharded equals the kernels")
            b = shc.boundaries.numpy()
            for lo, hi, m in ((0, 1 << 22, 200), (int(b[2]) - 5000,
                                                  int(b[5]) + 7, 100)):
                check(all(torch.equal(a.cpu(), c) for a, c in zip(
                    shd.range_scan_sharded(shl, lo, hi, m),
                    shd.range_scan_sharded(shc, lo, hi, m))),
                      f"{v} fat range_scan_sharded, card equals CPU")

        # tests/test_rebalance.py:220's Zipf inserts on 48 keys, fat shards
        krng, zrng = np.random.default_rng(SEED), np.random.default_rng(7)
        k48 = np.sort(krng.choice(1 << 16, 48, replace=False)
                      ).astype(np.int32)
        st = {dev: shd.build_sharded(k48, k48 * 3, n_shards=4, levels=8,
                                     seed=SEED, node_width=width, device=dev)
              for dev in (DEVICE, "cpu")}
        for b in range(4):
            kk = (int(k48[2]) + (zrng.zipf(ZIPF_A, 32) - 1) % 4096
                  ).astype(np.int32)
            ins = np.full(32, sl.OP_INSERT, np.int32)
            res = {}
            for dev in st:
                st[dev], res[dev] = shd.apply_ops_sharded(
                    st[dev], *on(dev, ins, kk, kk * 2), rebalance=True,
                    seed=b)
            check(torch.equal(res[DEVICE].cpu(), res["cpu"]),
                  f"fat{width} rebalancing apply_ops_sharded results")
            check_same_sharded(st[DEVICE], st["cpu"],
                               f"fat{width} rebalancing apply_ops_sharded")
        report[f"fat{width}_shards_after_zipf"] = st[DEVICE].n_shards

    # K9's tiling edges: rows not 16-byte aligned (6), a width that is not
    # a multiple of 4 (33), two passes of the row compare (256)
    for width in (6, 33, 256):
        args = dict(capacity=sl.node_slots_for(2 * SMALL["n"], width) + 4,
                    levels=14, node_width=width, seed=SEED)
        st = sl.build(keys, keys + 1, device=DEVICE, **args)
        check_same_state(st, sl.build(keys, keys + 1, device="cpu", **args),
                         f"fat{width} build, card equals CPU")
        q, = on(DEVICE, np.concatenate([rng.choice(keys, 2048), rng.integers(
            0, 1 << 22, 2048)]).astype(np.int32))
        for max_steps in (0, 9):
            check_fat_kernel("foresight_traverse", fat_tables(st), (q,),
                             report, f"foresight{width}", max_steps)
    report["seconds"] = time.perf_counter() - t0
    emit(report)


def fat_capacity(n: int, width: int) -> int:
    """benchmarks/common.py:37-38: the node slots of ``n`` keys at build
    fill, doubled, + 4, to the next power of two."""
    return 1 << (2 * sl.node_slots_for(n, width) + 4 - 1).bit_length()


def fat_full_size(keys_np: np.ndarray, q_np: np.ndarray, width: int,
                  foresight: bool, stream: tuple) -> dict:
    """The paper's keys in runs of ``width``: build, the main path through
    ``search_kernel`` (K1/K2 + K9) and, with ``stream``, one update batch
    through ``apply_ops``; checks, times, the byte bound and, on the
    foresight B = 128 list, K9 alone.  Returns the report; its ``row`` is
    the kernels-line row and ``k9`` K9's own."""
    stage_s, t_stage = {}, time.perf_counter()
    t_phase = t_stage

    def lap(stage: str) -> None:
        nonlocal t_stage
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage_s[stage] = now - t_stage
        t_stage = now

    dev = torch.device(DEVICE)
    v = variant(foresight)
    name = f"{v}_traverse"
    keys = torch.from_numpy(keys_np).to(dev)
    q = torch.from_numpy(q_np).to(dev)
    cap = fat_capacity(FULL_N, width)
    torch.cuda.reset_peak_memory_stats()

    # The main path, with every launch counter at 0 just before it.
    reset_launches()
    t0 = time.perf_counter()
    st = sl.build(keys, keys + 1, capacity=cap, levels=FULL_LEVELS,
                  foresight=foresight, seed=SEED, node_width=width,
                  device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = ops.search_kernel(st, q)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    report = {"phase": "fat_full_size", "variant": v, "node_width": width,
              "n": FULL_N, "levels": FULL_LEVELS, "capacity": cap,
              "nodes": int(st.bump) - 2, "batch": q.numel(),
              "fused_gib": (st.fused if foresight else st.nxt).numel() * 4
              / 2**30, "runs_gib": 2 * st.fat_keys.numel() * 4 / 2**30,
              "build_s": build_s, "search_kernel_s": search_s}
    if stream is not None:
        (types, ks, vs), want_results, current = stream
        saved = [t.clone() for t in st if t is not None]
        t0 = time.perf_counter()
        new, results = sl.apply_ops(st, *on(dev, types, ks, vs))
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
        after = ops.search_kernel(new, q)
    torch.cuda.synchronize()
    launches = read_launches()
    lap("main_path")
    check(launches[f"{name}/fat"] >= 1 and launches["fat_resolve"] >= 1,
          f"main path launched {name} with K9 (width {width})")

    check_lookups(res.found, res.vals, q_np, keys_np,
                  f"fat{width} search_kernel")
    flat_vals = st.fat_vals.reshape(-1)
    check(torch.equal(flat_vals[res.node[res.found].long()],
                      res.vals[res.found]),
          f"fat{width} node ids dereference into fat_vals")
    if stream is not None:
        check(np.array_equal(results.cpu().numpy(), want_results),
              f"fat{width} every apply_ops result equals the oracle")
        check(bool(sl.check_fat_invariant(new)),
              f"fat{width} check_fat_invariant after the update")
        check(all(torch.equal(a, b) for a, b in
                  zip([t for t in st if t is not None], saved)),
              f"fat{width} apply_ops leaves its input unchanged")
        check_lookups(after.found, after.vals, q_np, current,
                      f"fat{width} search_kernel after the update")
        report.update(update_ops=len(types), update_s=update_s,
                      update_us_per_op=update_s / len(types) * 1e6,
                      n_after=int(new.n))
        del new, after, saved
    lap("oracle_checks")

    wrapper, plain, source, replaces = KERNELS[name]
    tables = fat_tables(st)
    walk, fat = tables[:-1], tables[-1]
    err = max_abs_err(wrapper(*walk, q, fat), plain(*walk, q, fat))
    check(err == 0, f"{name} + K9 equals its plain version (width {width})")
    fp = path_footprint(tuple(t[None] for t in walk), q,
                        fat_keys=fat[None])
    lap("footprint_replay")
    kernel_ms = time_ms(lambda: wrapper(*walk, q, fat), KERNEL_REPS)
    plain_ms = time_ms(lambda: plain(*walk, q, fat), PLAIN_REPS)
    library_ms = time_ms(lambda: torch.searchsorted(keys, q), KERNEL_REPS)
    # K1/K2 + K9 group by key: the batch order too
    split = split_times(name, walk, q, fat)
    extra = {"ungrouped_ms": split["ungrouped_ms"]}
    report.update(split, group_by_key_launches=launches["group_by_key"])
    lap("timing")
    io_bytes = q.numel() * 4 * 3             # queries in, node + key out
    bytes_ms = (fp["distinct_bytes"] + io_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = (fp["steps"] + fp["compares"]) / SCALAR_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    report["row"] = {
        "name": fat_row_name(name, width), "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[f"{name}/fat"],
        "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms, **extra}
    report.update(
        hits=int(res.found.sum()), mops=q.numel() / kernel_ms / 1e3, **extra,
        ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_share=bound_ms / kernel_ms,
        mean_path_steps=fp["steps"] / q.numel(),
        max_path_steps=int(fp["path"].max()),
        distinct_bytes=fp["distinct_bytes"],
        distinct_runs=fp["distinct_runs"], sector_bytes=fp["sector_bytes"],
        sector_bound_ms=(fp["sector_bytes"] + io_bytes)
        / HBM_BYTES_PER_S * 1e3)

    if foresight:
        # K9 alone on the batch's final predecessors: what the postlude
        # costs beside the walk.
        x = fp["x"]
        got = ft.fat_resolve(st.fused, fat, x, q)
        err9 = max_abs_err(got, ft.fat_resolve_plain(st.fused, fat, x, q))
        check(err9 == 0,
              f"K9 alone equals its plain version (width {width})")
        check(all(torch.equal(a, b) for a, b in
                  zip(got, wrapper(*walk, q, fat))),
              f"K9 alone equals the postlude of K1 (width {width})")
        cand, ck = st.fused[0, x.long()].unbind(1)
        owner = torch.where((ck == q) | (x == 0), cand, x).long()
        rows = fat[owner]                        # [batch, B] owner runs
        k9_ms = time_ms(lambda: ft.fat_resolve(st.fused, fat, x, q),
                        KERNEL_REPS)
        k9_plain_ms = time_ms(
            lambda: ft.fat_resolve_plain(st.fused, fat, x, q), PLAIN_REPS)
        k9_library_ms = time_ms(lambda: torch.searchsorted(rows, q[:, None]),
                                KERNEL_REPS)
        del rows
        # x's level-0 records and the distinct owner runs; x and q in,
        # node and key out
        k9_bytes = (int(torch.unique(x).numel()) * 8
                    + fp["distinct_runs"] * width * 4 + q.numel() * 16)
        k9_bytes_ms = k9_bytes / HBM_BYTES_PER_S * 1e3
        # the same in 32-byte sectors (a run of B = 128 keys is 16 sectors)
        k9_sectors = (int(torch.unique(x.long() * 8 // 32).numel()) * 32
                      + fp["distinct_runs"] * -(-width * 4 // 32) * 32
                      + q.numel() * 16)
        k9_ops_ms = fp["compares"] / SCALAR_OPS_PER_S * 1e3
        report["k9"] = {
            "name": "fat_resolve", "route": "cuda", "source": TRAVERSE_CU,
            "replaces": f"{FT_PY}:223", "launches": None,
            "max_abs_err": err9, "ms": k9_ms, "plain_ms": k9_plain_ms,
            "bound_ms": max(k9_bytes_ms, k9_ops_ms),
            "bound_by": "bytes" if k9_bytes_ms >= k9_ops_ms
            else "operations", "library_ms": k9_library_ms,
            "sector_bound_ms": k9_sectors / HBM_BYTES_PER_S * 1e3}
        report["k9_share_of_k1_fat"] = k9_ms / kernel_ms
        lap("k9_alone")
    report.update(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                  stage_s=stage_s, seconds=time.perf_counter() - t_phase)
    emit({k: v for k, v in report.items() if k != "row"})
    del st, res, tables, walk, fat, flat_vals, keys, fp
    torch.cuda.empty_cache()
    return report


def zipf_queries(keys: np.ndarray, batch: int, a: float = ZIPF_A,
                 seed: int = 1) -> np.ndarray:
    """benchmarks/common.py:55-60: Zipf(a) over the key population by rank."""
    rng = np.random.default_rng(seed)
    return keys[(rng.zipf(a, batch) - 1) % len(keys)].astype(np.int32)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    smi = card_identity()
    build_kernels()
    small_check()
    small_update_check()
    small_sharded_check()
    meshes = init_mesh_group()
    small_mesh_check(meshes)
    rng = np.random.default_rng(SEED)
    keys_np = np.sort(rng.choice(FULL_SPAN, FULL_N, replace=False))
    keys_np = keys_np.astype(np.int32)
    q_np = np.random.default_rng(SEED + 1).integers(
        0, FULL_SPAN, FULL_BATCH).astype(np.int32)
    traffic = {"uniform": q_np, "zipf": zipf_queries(keys_np, FULL_BATCH)}
    mono = {foresight: full_size(keys_np, traffic, foresight)
            for foresight in (True, False)}
    # K1 over K2: both grouped, and both in batch order
    emit({"phase": "ratio",
          "foresight_over_base_ms": {
              name: {"grouped": mono[True][name]["ms"]
                     / mono[False][name]["ms"],
                     "batch_order": mono[True][name]["ungrouped_ms"]
                     / mono[False][name]["ungrouped_ms"]}
              for name in traffic}})
    versioned, versioned_groups = versioned_full_size(keys_np, traffic)
    # The kernels line takes traffic A's rows; the pass's launches are those
    # of every path that ran it (K1's, K2's, K8's, and the fat K1's and
    # K2's below).
    key_row = mono[False]["uniform"].pop("group")
    key_row["launches"] += mono[True]["uniform"].pop("group")["launches"]
    for foresight in (True, False):
        mono[foresight]["zipf"].pop("group")
    key_row["launches"] += versioned_groups
    rows = [mono[True]["uniform"], mono[False]["uniform"],
            versioned["uniform"], key_row]
    ops_ = synchrobench_ops(SHARD_UPDATE_OPS, SEED + 5)
    t0 = time.perf_counter()
    stream = (ops_, *host_oracle(keys_np, *ops_[:2]))
    emit({"phase": "sharded_host_oracle", "seconds": time.perf_counter() - t0})
    answers, scalar_answers, mesh_reports, grouping = {}, {}, [], {}
    for foresight in (True, False):
        sharded_rows, answers, fp, grouping[(foresight, 1)] = \
            sharded_full_size(keys_np, traffic, stream, foresight, answers)
        scalar_answers = scalar_answers or answers
        rows += sharded_rows
        mesh_reports.append(mesh_full_size(keys_np, traffic, stream,
                                           foresight, (fp, answers),
                                           meshes[DEVICE]))
    group_row = grouping[(True, 1)]["row"]
    group_row["launches"] += grouping[(False, 1)]["row"]["launches"]
    group_row["max_abs_err"] = max(group_row["max_abs_err"],
                                   grouping[(False, 1)]["row"]["max_abs_err"])
    rows.append(group_row)
    by_name = {r["name"]: r for r in rows}
    for r in mesh_reports:          # K10's K5/K6 launches count there too
        for name in KERNELS:
            by_name[name]["launches"] += r["launches"][name]
    rows.append(mesh_row(mesh_reports))
    check(rows[-1]["launches"] > 0, "search_kernel_mesh (K10) launched on "
                                    "the mesh path")
    emit({"phase": "sharded_ratio",
          "foresight_over_base_ms": {
              kind: by_name[f"foresight_traverse_{kind}"]["ms"]
              / by_name[f"base_traverse_{kind}"]["ms"]
              for kind in ("sharded", "clustered")},
          # K5 over K6 tile-sorted (above) and in the plan's order (before)
          "clustered_plan_order_foresight_over_base_ms":
              by_name["foresight_traverse_clustered"]["plan_order_ms"]
              / by_name["base_traverse_clustered"]["plan_order_ms"],
          "sharded_over_monolithic_ms": {
              v: by_name[f"{v}_traverse_sharded"]["ms"]
              / by_name[f"{v}_traverse"]["ms"]
              for v in ("foresight", "base")},
          "dense_foresight_over_base_ms": {
              traffic_name: {
                  "grouped": grouping[(True, 1)]["dense_ms"][traffic_name]
                  / grouping[(False, 1)]["dense_ms"][traffic_name],
                  "ungrouped":
                  grouping[(True, 1)]["ungrouped_ms"][traffic_name]
                  / grouping[(False, 1)]["ungrouped_ms"][traffic_name]}
              for traffic_name in traffic}})
    for name in KERNELS:
        check(by_name[name]["launches"] > 0, f"{name} launched on its path")

    small_fat_check()
    fat = {(w, fs): fat_full_size(keys_np, q_np, w, fs,
                                  stream if (w, fs) == (128, True) else None)
           for w, fs in ((128, True), (128, False), (8, True))}
    fat_rows = [r["row"] for r in fat.values()]
    answers = {}
    for foresight in (True, False):
        sharded_rows, answers, _, grouping[(foresight, 128)] = \
            sharded_full_size(keys_np, traffic, stream, foresight, answers,
                              width=128, scalar=scalar_answers)
        fat_rows += sharded_rows
        g = grouping[(foresight, 128)]["row"]    # the pass's fat-path runs
        group_row["launches"] += g["launches"]
        group_row["max_abs_err"] = max(group_row["max_abs_err"],
                                       g["max_abs_err"])
    key_row["launches"] += sum(f["group_by_key_launches"]
                               for f in fat.values())
    fat_by_name = {r["name"]: r for r in fat_rows}
    k9 = fat[(128, True)]["k9"]
    k9["launches"] = sum(r["launches"] for r in fat_rows)
    check(k9["launches"] > 0, "fat_resolve (K9) launched on the fat paths")
    emit({"phase": "fat_ratio",
          "foresight_over_base_ms": fat[(128, True)]["ms"]
          / fat[(128, False)]["ms"],
          "fat128_over_scalar_k1_ms": fat[(128, True)]["ms"]
          / by_name["foresight_traverse"]["ms"],
          "fat8_over_scalar_k1_ms": fat[(8, True)]["ms"]
          / by_name["foresight_traverse"]["ms"],
          "k9_alone_over_k1_fat128_ms": fat[(128, True)]["k9_share_of_k1_fat"],
          "k9_alone_over_k1_fat8_ms": fat[(8, True)]["k9_share_of_k1_fat"],
          "clustered_foresight_over_base_ms": {
              key: fat_by_name["foresight_traverse_clustered/fat128"][key]
              / fat_by_name["base_traverse_clustered/fat128"][key]
              for key in ("ms", "plan_order_ms")},
          "fat_over_scalar_ms": {
              r["name"]: r["ms"] / by_name[r["name"].split("/")[0]]["ms"]
              for r in fat_rows}})
    for r in fat_rows:
        check(r["launches"] > 0, f"{r['name']} launched on its path")
    rows += fat_rows + [k9]
    dist.destroy_process_group()
    emit({"kernels": rows})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
