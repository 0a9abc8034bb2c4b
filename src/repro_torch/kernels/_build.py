"""Build ``csrc/traverse.cu`` with nvcc at first use and load it with ctypes.

The shared library has a plain C interface (no PyTorch headers), so nvcc
takes seconds.  It lands in ``repro_torch/build/`` under a name carrying a
hash of the source and flags, so an edited source is never served a stale
library; a finished file is renamed into place, so concurrent first uses do
not see a half-written one.  A failed build raises: there is no fallback.
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
SOURCE = _PKG / "csrc" / "traverse.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    # fused, queries, node, key, batch, levels, cap, max_steps, stream
    "foresight_traverse_launch": [_P, _P, _P, _P, _LL, ctypes.c_int, _LL,
                                  _LL, _P],
    # nxt, keys, queries, node, key, batch, levels, cap, max_steps, stream
    "base_traverse_launch": [_P, _P, _P, _P, _P, _LL, ctypes.c_int, _LL,
                             _LL, _P],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels cannot "
                           "be built")
    return nvcc


def compile_library() -> Path:
    """Compile the kernels unless this exact build exists; return its path."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libtraverse-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
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
