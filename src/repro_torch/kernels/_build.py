"""Build the CUDA sources of ``csrc/`` with nvcc at first use; load with ctypes.

Every ``csrc/*.cu`` is compiled to an object file by its own nvcc process,
all started together, and the objects are linked into one shared library.
The library has a plain C interface (no PyTorch headers), so nvcc takes
seconds.  It lands in ``repro_torch/build/`` under a name carrying a hash
of all the sources and the flags, so an edit to any source rebuilds it; a
finished file is renamed into place, so concurrent first uses do not see a
half-written one.  A failed build raises: there is no fallback.
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
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
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
    # levels, cap, width
    "foresight_clustered_launch": [_P] * 8 + [_LL, _I, _I, _I, _LL, _I, _LL,
                                              _P],
    # nxt, keys, fat, block_sids, ndist, shard_ids, queries | shards, K,
    # levels, cap, width
    "base_clustered_launch": [_P] * 9 + [_LL, _I, _I, _I, _LL, _I, _LL, _P],
    # fused, fat, x, queries, node, key | batch, width (no max_steps)
    "fat_resolve_launch": [_P] * 6 + [_LL, _I, _P],
    # shard_ids, queries, counts, scanned, offsets, q_sorted, sid_sorted,
    # perm | batch, shards (no max_steps)
    "group_by_shard_launch": [_P] * 8 + [_LL, _I, _P],
    # queries, partials, counts, scanned, offsets, q_mid, perm_mid,
    # q_sorted, perm | batch (no max_steps)
    "group_by_key_launch": [_P] * 9 + [_LL, _P],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels cannot "
                           "be built")
    return nvcc


def _run(procs) -> None:
    """Wait for every (command, process); raise on the first that failed."""
    failed = None
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                      f"{out}{err}")
    if failed:
        raise RuntimeError(failed)


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def compile_library() -> Path:
    """Compile the kernels unless this exact build exists; return its path."""
    srcs = sorted(SOURCE_DIR.glob("*.cu"))
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    tag = digest.hexdigest()[:12]
    out = BUILD_DIR / f"libtraverse-{tag}.so"
    if out.exists():
        return out
    work = BUILD_DIR / f"objects-{tag}.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objects = [work / f"{src.stem}.o" for src in srcs]
    _run([_start([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
          for src, obj in zip(srcs, objects)])
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
