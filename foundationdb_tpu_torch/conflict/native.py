"""Default native (C++ skip list) conflict backend: lazy build + plugin load.

The CPU baseline implementation (native/conflictset.cpp, a copy of the
reference package's) compiled on first use and loaded through the plugin
seam (plugin.py).  This is the performance bar the device kernel is
benchmarked against — the stand-in for the reference's fdbserver/
SkipList.cpp running on a host core.

The library is built with the reference Makefile's compiler and flags into
`foundationdb_tpu_torch/_build/native-<hash>/`, keyed by a hash of the
source, the flags and what `-march=native` means on this host, so a
checkout copied to another machine builds its own library rather than
loading one made for another CPU.  A failed build raises with the
compiler's output attached.  Nothing here runs at import time.
"""

from __future__ import annotations

import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from .plugin import ConflictPlugin

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "conflictset.cpp"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libfdbtpu_conflict.so"
CXX = "g++"
CXXFLAGS = ("-O3", "-std=c++20", "-fPIC", "-Wall", "-Wextra", "-march=native",
            "-shared")
_lock = threading.Lock()


def _target() -> str:
    """What `-march=native` selects on this host, as the compiler says."""
    proc = subprocess.run([CXX, "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed to describe the native target:\n"
                           f"{proc.stderr}")
    return proc.stdout


def build_native() -> Path:
    """Compile the skip list unless this exact build exists; returns the
    library's path."""
    h = hashlib.sha256(" ".join((CXX, *CXXFLAGS)).encode())
    h.update(SOURCE.read_bytes())
    h.update(_target().encode())
    out = BUILD_ROOT / f"native-{h.hexdigest()[:16]}"
    lib = out / LIB_NAME
    with _lock:
        if lib.exists():
            return lib
        out.mkdir(parents=True, exist_ok=True)
        tmp = out / f"{LIB_NAME}.{os.getpid()}.tmp"
        proc = subprocess.run([CXX, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native conflict backend build failed:\n{proc.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.lru_cache(maxsize=1)
def native_plugin() -> ConflictPlugin:
    return ConflictPlugin(str(build_native()))


def NativeConflictSet(oldest_version: int = 0):
    """Factory matching the other backends' constructors."""
    return native_plugin().create(oldest_version)
