"""Durable memory storage engine — the KeyValueStoreMemory analog
(fdbserver/KeyValueStoreMemory.actor.cpp:57): an ordered in-memory map whose
mutations stream through a DiskQueue, with periodic full snapshots so the
log stays bounded.  Same read interface as MemoryKeyValueStore, so it slots
into StorageServer unchanged (IKeyValueStore seam, fdbserver/IKeyValueStore.h:38).

Record types in the log:
    SNAPSHOT: full key/value dump + meta map (starts a fresh log epoch)
    SET / CLEAR: one mutation
    COMMIT: durability point marker carrying the meta map (e.g. the storage
      server's durable_version) — recovery replays up to the LAST COMMIT
      and discards the tail, so a crash mid-batch never yields a half-
      applied state.

Copy of the reference package's module, on the port's own modules.
"""

from __future__ import annotations

from ..roles.storage import MemoryKeyValueStore
from ..runtime.serialize import BinaryReader, BinaryWriter
from .diskqueue import DiskQueue
from .files import SimFile, SimFilesystem
from .pagecache import maybe_cached

_SNAPSHOT, _SET, _CLEAR, _COMMIT = 0, 1, 2, 3


class DurableMemoryKeyValueStore(MemoryKeyValueStore):
    """Memory engine + DiskQueue write-ahead log.

    Usage: mutate via set/clear_range (buffered in the log), then
    `await commit(meta)` to fsync; only committed batches survive a crash.
    """

    def __init__(self, fs: SimFilesystem, path: str, process) -> None:
        super().__init__()
        self.meta: dict[str, int] = {}
        # the WAL rides the shared file-level page cache when armed (the
        # reference puts AsyncFileCached under EVERY storage file); its
        # read path is the recovery scan + spilled-entry re-reads
        self._dq = DiskQueue(maybe_cached(fs, fs.open(path, process)))
        self._since_snapshot = 0
        self._snapshot_threshold = 1 << 20

    # -- mutations (logged) --------------------------------------------------
    # Log push comes FIRST, memory mutation second: an append refused by
    # the disk's fault plane (ENOSPC / injected error, storage/files.py)
    # must leave the in-memory map and the WAL agreeing — a mutation in
    # memory but not in the log would survive in served reads yet vanish
    # at the next crash, exactly the silent acked-data-loss shape the
    # resource-exhaustion campaign exists to rule out.
    def set(self, key: bytes, value: bytes) -> None:
        w = BinaryWriter().u8(_SET).bytes_(key).bytes_(value)
        self._dq.push(w.data())
        super().set(key, value)
        self._since_snapshot += len(key) + len(value)

    def clear_range(self, begin: bytes, end: bytes) -> None:
        w = BinaryWriter().u8(_CLEAR).bytes_(begin).bytes_(end)
        self._dq.push(w.data())
        super().clear_range(begin, end)
        self._since_snapshot += len(begin) + len(end)

    async def commit(self, meta: dict[str, int] | None = None) -> None:
        """Durability point: everything mutated so far + meta survives any
        later crash.  Snapshots when the log outgrows the data (the memory
        engine's log-vs-data size balance)."""
        if meta:
            self.meta.update(meta)
        w = BinaryWriter().u8(_COMMIT).u32(len(self.meta))
        for k, v in sorted(self.meta.items()):
            w.str_(k).i64(v)
        self._dq.push(w.data())
        if self._since_snapshot > max(
            self._snapshot_threshold, 4 * self._data_bytes()
        ):
            self._write_snapshot()
        await self._dq.sync()

    def _data_bytes(self) -> int:
        return sum(len(k) + len(v) for k, v in self._data.items())

    def disk_usage(self) -> tuple[int, int | None]:
        """(bytes used, capacity|None) of the WAL's disk — the free-space
        input ratekeeper's storage_server_min_free_space analog reads."""
        f = self._dq.file
        return f._fs.usage_for(f.path)

    def page_cache_stats(self) -> dict:
        """Same counter-block shape as the ssd engine's (status schema's
        `storage[*].page_cache`): this engine has no parsed-page cache, so
        those rows stay zero."""
        from .pagecache import file_stats_block

        return file_stats_block((self._dq.file,))

    def _write_snapshot(self) -> None:
        w = BinaryWriter().u8(_SNAPSHOT)
        w.u32(len(self.meta))
        for k, v in sorted(self.meta.items()):
            w.str_(k).i64(v)
        w.u32(len(self._keys))
        for k in self._keys:
            w.bytes_(k).bytes_(self._data[k])
        self._dq.rewrite([w.data()])
        self._since_snapshot = 0

    # -- recovery -----------------------------------------------------------
    @classmethod
    def recover(cls, fs: SimFilesystem, path: str, process) -> "DurableMemoryKeyValueStore":
        store = cls(fs, path, process)
        records = store._dq.recover()
        # replay, remembering state only up to the last COMMIT/SNAPSHOT
        staged: list[tuple] = []

        def apply_staged() -> None:
            for op in staged:
                if op[0] == _SET:
                    MemoryKeyValueStore.set(store, op[1], op[2])
                else:
                    MemoryKeyValueStore.clear_range(store, op[1], op[2])
            staged.clear()

        committed_meta: dict[str, int] = {}
        for rec in records:
            r = BinaryReader(rec)
            t = r.u8()
            if t == _SNAPSHOT:
                store._keys.clear()
                store._data.clear()
                staged.clear()
                meta = {r.str_(): r.i64() for _ in range(r.u32())}
                for _ in range(r.u32()):
                    MemoryKeyValueStore.set(store, r.bytes_(), r.bytes_())
                committed_meta = meta
            elif t == _SET:
                staged.append((_SET, r.bytes_(), r.bytes_()))
            elif t == _CLEAR:
                staged.append((_CLEAR, r.bytes_(), r.bytes_()))
            elif t == _COMMIT:
                apply_staged()
                committed_meta = {r.str_(): r.i64() for _ in range(r.u32())}
        # discard trailing uncommitted mutations (staged non-empty = crash
        # between push and the commit marker)
        store.meta = dict(committed_meta)
        # re-log the recovered state as a fresh snapshot so the log and the
        # in-memory map agree again (uncommitted tail is physically dropped
        # — it MUST be: a later commit marker would otherwise resurrect it
        # on the next replay).  Transient injected disk faults are retried;
        # the journaled truncate un-winds itself between attempts, so the
        # old log stays recoverable throughout.
        for attempt in range(3):
            try:
                store._write_snapshot()
                break
            except IOError:
                if attempt == 2:
                    raise
        return store
