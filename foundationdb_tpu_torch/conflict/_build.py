"""Build and load the conflict kernels (csrc/conflict_kernels.cu).

nvcc compiles the source into a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), and ctypes loads it.  The
library lands in `foundationdb_tpu_torch/_build/<hash>/`, keyed by a hash of
the sources and the flags, at first use — so a fresh checkout builds
everything on its first call to a kernel.  A failed build raises with
nvcc's output attached.  Nothing here runs at import time: the CPU tests
import every module on machines without nvcc.
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
SOURCES = (_PKG / "csrc" / "conflict_kernels.cu",)
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libconflict_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the CUDA toolkit's default install location, where nvcc is not on PATH
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # name: argtypes (every entry point ends with the stream)
    "fdb_probe_fused": [_P] * 9 + [_I] * 10 + [_P],
    "fdb_probe": [_P] * 8 + [_I] * 7 + [_P],
    "fdb_intra_query": [_P] * 5 + [_I] * 3 + [_P],
    "fdb_compact_ranks": [_P] * 3 + [_I] * 7 + [_P],
    "fdb_run_to_step": [_P] * 5 + [_I] * 3 + [ctypes.c_uint] + [_I] * 4 + [_P],
    "fdb_intra_fixpoint": [_P] * 14 + [_I] * 7 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(_DEFAULT_NVCC):
        return _DEFAULT_NVCC
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources unless this exact build exists; returns the
    library's path.  The compiler's report (`-Xptxas -v`: registers,
    shared memory and spills per kernel) is kept beside it."""
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    report = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{report}"
        )
    (out / "ptxas.txt").write_text(report)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def ptxas_report() -> str:
    """The `-Xptxas -v` lines of the current build (builds if needed)."""
    build()
    return (build_dir() / "ptxas.txt").read_text()


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.fdb_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fdb_cuda_error_string.restype = ctypes.c_char_p
    lib.fdb_warp_plan_occupancy.argtypes = [_I] * 3
    lib.fdb_warp_plan_occupancy.restype = ctypes.c_int
    lib.fdb_intra_cluster_occupancy.argtypes = [_I] * 2
    lib.fdb_intra_cluster_occupancy.restype = ctypes.c_int
    lib.fdb_probe_tree_occupancy.argtypes = [_I] * 4
    lib.fdb_probe_tree_occupancy.restype = ctypes.c_int
    return lib
