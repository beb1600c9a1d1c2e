"""ConflictSet plugin loader — dlopen a backend behind the IConflictSet seam.

Models the reference's plugin pattern (fdbrpc/LoadPlugin.h:30-44: dlopen +
resolve a well-known symbol, used there to load TLS backends and named by the
north star as the seam for alternate conflict backends): a shared library
exporting the `fdbtpu_conflictset_*` C ABI (see native/conflictset.cpp)
becomes a ConflictSet implementation, keeping the resolver role and the
device path intact whichever backend is loaded.

Copy of the reference package's loader: the same ABI table, the same
ConflictSet surface and the packed fast path (`resolve_packed`).
"""

from __future__ import annotations

import ctypes
import time
from typing import Sequence

import numpy as np

from .api import ConflictSet, KernelStats, TxInfo, Verdict, validate_batch

_ABI = {
    "fdbtpu_conflictset_backend_name": (ctypes.c_char_p, []),
    "fdbtpu_conflictset_create": (ctypes.c_void_p, [ctypes.c_int64]),
    "fdbtpu_conflictset_destroy": (None, [ctypes.c_void_p]),
    "fdbtpu_conflictset_resolve": (
        ctypes.c_int,
        [
            ctypes.c_void_p,  # cs
            ctypes.c_int64,  # commit_version
            ctypes.c_int32,  # n_txn
            ctypes.POINTER(ctypes.c_int64),  # snapshots
            ctypes.POINTER(ctypes.c_int32),  # n_read_ranges
            ctypes.POINTER(ctypes.c_int32),  # n_write_ranges
            ctypes.POINTER(ctypes.c_uint8),  # key_bytes
            ctypes.POINTER(ctypes.c_int64),  # key_offsets
            ctypes.POINTER(ctypes.c_uint8),  # out_verdicts
        ],
    ),
    "fdbtpu_conflictset_remove_before": (None, [ctypes.c_void_p, ctypes.c_int64]),
    "fdbtpu_conflictset_oldest": (ctypes.c_int64, [ctypes.c_void_p]),
    "fdbtpu_conflictset_node_count": (ctypes.c_int64, [ctypes.c_void_p]),
}


class ConflictPlugin:
    """A loaded conflict-backend shared library; factory for PluginConflictSet."""

    def __init__(self, path: str) -> None:
        self._lib = ctypes.CDLL(path)  # raises OSError on missing/bad lib
        for name, (restype, argtypes) in _ABI.items():
            try:
                fn = getattr(self._lib, name)
            except AttributeError as e:  # symbol check, LoadPlugin.h:39-43
                raise OSError(f"plugin {path} lacks symbol {name}") from e
            fn.restype = restype
            fn.argtypes = argtypes
        self.path = path

    @property
    def backend_name(self) -> str:
        return self._lib.fdbtpu_conflictset_backend_name().decode()

    def create(self, oldest_version: int = 0) -> "PluginConflictSet":
        return PluginConflictSet(self._lib, oldest_version)


class PluginConflictSet(ConflictSet):
    """ConflictSet calling through the C ABI of a loaded plugin."""

    def __init__(self, lib, oldest_version: int) -> None:
        self._lib = lib
        self._handle = lib.fdbtpu_conflictset_create(oldest_version)
        self._oldest = oldest_version
        self.stats = KernelStats(backend="native")

    @property
    def oldest_version(self) -> int:
        return self._oldest

    def resolve_batch(self, commit_version: int, txns: Sequence[TxInfo]) -> list[Verdict]:
        validate_batch(commit_version, txns, self._oldest)
        n = len(txns)
        t_pack = time.perf_counter()
        snapshots = np.fromiter(
            (t.read_snapshot for t in txns), dtype=np.int64, count=n
        )
        n_reads = np.fromiter(
            (len(t.read_ranges) for t in txns), dtype=np.int32, count=n
        )
        n_writes = np.fromiter(
            (len(t.write_ranges) for t in txns), dtype=np.int32, count=n
        )
        keys: list[bytes] = []
        for t in txns:
            for b, e in t.read_ranges:
                keys.append(b)
                keys.append(e)
            for b, e in t.write_ranges:
                keys.append(b)
                keys.append(e)
        key_bytes = np.frombuffer(b"".join(keys), dtype=np.uint8) if keys else np.zeros(0, np.uint8)
        offsets = np.zeros(len(keys) + 1, dtype=np.int64)
        np.cumsum([len(k) for k in keys], out=offsets[1:])
        self.stats.pack_s += time.perf_counter() - t_pack
        verdicts = self.resolve_packed(
            commit_version, snapshots, n_reads, n_writes, key_bytes, offsets
        )
        return [Verdict(int(v)) for v in verdicts]

    def resolve_packed(
        self,
        commit_version: int,
        snapshots: np.ndarray,  # int64[n]
        n_reads: np.ndarray,  # int32[n]
        n_writes: np.ndarray,  # int32[n]
        key_bytes: np.ndarray,  # uint8[total]
        offsets: np.ndarray,  # int64[n_keys+1]
    ) -> np.ndarray:
        """Packed fast path mirroring the C ABI directly (keys concatenated
        txn-by-txn: read (b,e)* then write (b,e)*).  Counterpart of
        DeviceConflictSet.resolve_arrays for marshal-free benchmarking and
        the packed proxy->resolver wire format."""
        if not self._handle:
            # a closed/destroyed plugin handle must fail loudly, not hand a
            # NULL pointer to the C ABI (a segfault the supervisor could
            # never classify)
            raise RuntimeError("conflict plugin handle closed")
        n = snapshots.shape[0]
        verdicts = np.zeros(max(n, 1), dtype=np.uint8)
        t0 = time.perf_counter()

        def p(arr, ty):
            return arr.ctypes.data_as(ctypes.POINTER(ty))

        rc = self._lib.fdbtpu_conflictset_resolve(
            self._handle,
            commit_version,
            n,
            p(np.ascontiguousarray(snapshots, np.int64), ctypes.c_int64),
            p(np.ascontiguousarray(n_reads, np.int32), ctypes.c_int32),
            p(np.ascontiguousarray(n_writes, np.int32), ctypes.c_int32),
            p(np.ascontiguousarray(key_bytes, np.uint8), ctypes.c_uint8),
            p(np.ascontiguousarray(offsets, np.int64), ctypes.c_int64),
            p(verdicts, ctypes.c_uint8),
        )
        if rc != 0:
            raise ValueError(
                f"commit_version {commit_version} not after the previous batch"
            )
        rows = (offsets.shape[0] - 1) // 2
        self.stats.real_rows += rows
        self.stats.padded_rows += rows  # the C ABI takes exact-size arrays
        self.stats.note_batch(
            n,
            int((verdicts[:n] == int(Verdict.CONFLICT)).sum()),
            time.perf_counter() - t0,
        )
        return verdicts[:n]

    def remove_before(self, version: int) -> None:
        if not self._handle:
            raise RuntimeError("conflict plugin handle closed")
        if version > self._oldest:
            self._oldest = version
            t0 = time.perf_counter()
            before = self.node_count
            self._lib.fdbtpu_conflictset_remove_before(self._handle, version)
            self.stats.gc_calls += 1
            self.stats.rows_reclaimed += max(0, before - self.node_count)
            self.stats.merge_s += time.perf_counter() - t0

    @property
    def node_count(self) -> int:
        if not self._handle:
            raise RuntimeError("conflict plugin handle closed")
        return int(self._lib.fdbtpu_conflictset_node_count(self._handle))

    def close(self) -> None:
        if self._handle:
            self._lib.fdbtpu_conflictset_destroy(self._handle)
            self._handle = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass
