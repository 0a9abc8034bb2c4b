"""Build the CUDA sources of ``csrc/`` with nvcc at first use; load with ctypes.

Every ``csrc/*.cu`` is compiled to an object file by its own nvcc process,
all started together, and the objects are linked into one shared library
(``csrc/*.cuh`` holds device code that several sources include).  The
library has a plain C interface (no PyTorch headers), so nvcc takes
seconds.  It lands in ``repro_torch/build/`` under a name carrying a hash
of all the sources, headers included, and the flags (``source_tag``), so
an edit to any of them rebuilds it; a finished file is renamed into
place, so concurrent first uses do not see a half-written one.  A failed
build raises: there is no fallback.

ptxas runs with ``-v``: the build writes what it reports of each kernel
(registers, spills, stack, shared memory) beside the library
(``ptxas_report_path``), for ``repro_torch.analysis.kernel_budget``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# Every walk launcher takes its input pointers (queries last), the node and
# key output pointers, the batch, its sizes, max_steps and the stream.  Every
# pointer is c_void_p, or ctypes would cut it to 32 bits; ``fat`` may be
# null (the scalar layout), and so may ``out_idx`` (K1, K2, K8 and the
# dense sharded walks).
_SIGNATURES = {
    # fused, fat, out_idx, queries | levels, cap, width
    "foresight_traverse_launch": [_P] * 6 + [_LL, _I, _LL, _I, _LL, _P],
    # nxt, keys, fat, out_idx, queries | levels, cap, width
    "base_traverse_launch": [_P] * 7 + [_LL, _I, _LL, _I, _LL, _P],
    # fused, auth_keys, out_idx, queries | levels, cap
    "validated_traverse_launch": [_P] * 6 + [_LL, _I, _LL, _LL, _P],
    # fused, fat, shard_ids, out_idx, queries | shards, levels, cap, width
    "foresight_sharded_launch": [_P] * 7 + [_LL, _I, _I, _LL, _I, _LL, _P],
    # nxt, keys, fat, shard_ids, out_idx, queries | shards, levels, cap,
    # width
    "base_sharded_launch": [_P] * 8 + [_LL, _I, _I, _LL, _I, _LL, _P],
    # fused, fat, block_sids, ndist, shard_ids, queries | shards, K,
    # levels, cap, width (the tile-sorted walk)
    "foresight_clustered_launch": [_P] * 8 + [_LL, _I, _I, _I, _LL, _I, _LL,
                                              _P],
    # nxt, keys, fat, block_sids, ndist, shard_ids, queries | shards, K,
    # levels, cap, width
    "base_clustered_launch": [_P] * 9 + [_LL, _I, _I, _I, _LL, _I, _LL, _P],
    # the same two in the plan's lane order
    "foresight_clustered_plan_order_launch": [_P] * 8 + [_LL, _I, _I, _I,
                                                         _LL, _I, _LL, _P],
    "base_clustered_plan_order_launch": [_P] * 9 + [_LL, _I, _I, _I, _LL,
                                                    _I, _LL, _P],
    # fused, fat, x, queries, node, key | batch, width (no max_steps)
    "fat_resolve_launch": [_P] * 6 + [_LL, _I, _P],
    # shard_ids, queries, counts, scanned, offsets, q_sorted, sid_sorted,
    # perm | batch, shards (no max_steps)
    "group_by_shard_launch": [_P] * 8 + [_LL, _I, _P],
    # queries, partials, counts, scanned, offsets, q_mid, perm_mid,
    # q_sorted, perm | batch (no max_steps)
    "group_by_key_launch": [_P] * 9 + [_LL, _P],
    # fused, nxt, keys, vals, height, n, free_top, free_list, bump, rng,
    # fat_keys, fat_vals, nlen, op_types, op_keys, op_vals, starts, lens,
    # ref_ctz, results, cases | shards, levels, cap, width, max_steps (the
    # update kernel, apply_ops.cu)
    "apply_ops_launch": [_P] * 21 + [_I, _I, _LL, _I, _LL, _P],
    # fused, nxt, keys, vals, height, n, free_top, free_list, bump, rng,
    # fat_keys, fat_vals, nlen, boundaries, k_sorted, pdist, pnew, given,
    # ref_ctz, run_keys, run_vals, chunk_first, front, sums, ctrl, counts |
    # mode, shards, levels, cap, width, batch, usable, ceil, hi_mark,
    # lo_mark, seed, max_steps (the rebalance passes, rebalance.cu)
    "rebalance_launch": [_P] * 26 + [_I, _I, _I, _LL, _I, _LL, _LL, _I, _F,
                                     _F, _LL, _LL, _P],
    # fused, nxt, keys, vals, fat_keys, fat_vals, out_idx, queries, found,
    # out_vals, node, preds, counters | mode, batch, levels, cap, width,
    # stop_level, max_steps (the recording search walk, search_walk.cu);
    # its occupancy query (mode, levels, int* blocks)
    "search_walk_launch": [_P] * 13 + [_I, _LL, _I, _LL, _I, _I, _LL, _P],
    "search_walk_blocks_per_sm": [_I, _I, _P],
    # fused, nxt, keys, vals, fat_keys, fat_vals, nlen, boundaries, lo, hi,
    # out_keys, out_vals, out_count, front | scans, shards, levels, cap,
    # width, max_out, raw, max_steps (the range scans, range_scan.cu)
    "range_scan_launch": [_P] * 14 + [_LL, _I, _I, _LL, _I, _I, _I, _LL,
                                      _P],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels cannot "
                           "be built")
    return nvcc


def _run(procs) -> list:
    """Wait for every (command, process); raise on the first that failed,
    else return each one's stdout + stderr."""
    failed, outputs = None, []
    for cmd, proc in procs:
        out, err = proc.communicate()
        outputs.append(out + err)
        if proc.returncode != 0 and failed is None:
            failed = (f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                      f"{out}{err}")
    if failed:
        raise RuntimeError(failed)
    return outputs


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def source_tag() -> str:
    """The build's hash: sha1 of the flags and of every ``csrc/*.cu*``
    file (name and bytes), its first 12 hex digits."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SOURCE_DIR.glob("*.cu*")):      # the headers too
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return digest.hexdigest()[:12]


def ptxas_report_path(tag: str = "") -> Path:
    """Where the build of ``tag`` (today's by default) keeps its ptxas
    report."""
    return BUILD_DIR / f"libtraverse-{tag or source_tag()}.ptxas.txt"


def ptxas_header(tag: str) -> str:
    return (f"# ptxas -v of src/repro_torch/csrc for sm_90a "
            f"(repro_torch/kernels/_build.py)\n"
            f"# tag {tag}: sha1 of the nvcc flags and every csrc/*.cu* "
            f"file\n# flags {' '.join(NVCC_FLAGS)}\n")


def compile_library() -> Path:
    """Compile the kernels unless this exact build exists; return its path."""
    srcs = sorted(SOURCE_DIR.glob("*.cu"))
    tag = source_tag()
    out = BUILD_DIR / f"libtraverse-{tag}.so"
    if out.exists():
        return out
    work = BUILD_DIR / f"objects-{tag}.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objects = [work / f"{src.stem}.o" for src in srcs]
    reports = _run([_start([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                            str(src)])
                    for src, obj in zip(srcs, objects)])
    report = ptxas_header(tag) + "".join(
        f"## {src.name}\n{text}" for src, text in zip(srcs, reports))
    tmp_report = work / "ptxas.txt"
    tmp_report.write_text(report)
    os.replace(tmp_report, ptxas_report_path(tag))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run([_start([nvcc, "-shared", "-o", str(tmp), *map(str, objects)])])
    os.replace(tmp, out)
    shutil.rmtree(work)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    lib = ctypes.CDLL(str(compile_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.traverse_error_string.argtypes = [ctypes.c_int]
    lib.traverse_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call launcher ``name``; raise if the launch reported a CUDA error."""
    lib = library()
    code = getattr(lib, name)(*args)
    if code != 0:
        msg = lib.traverse_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
