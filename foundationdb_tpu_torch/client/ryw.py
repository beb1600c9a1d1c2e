"""Read-your-writes layer (fdbclient/ReadYourWrites.actor.cpp).

Wraps a Transaction with a WriteMap (fdbclient/WriteMap.h:119): reads see
the transaction's own uncommitted writes merged over snapshot reads, the
semantics every FDB client API exposes by default.  Atomic ops buffered
here fold into literal values when the key has a known local value, else
they pass through for the storage server to apply (the reference's
unreadable-write handling).

Snapshot data flows through a per-transaction SnapshotCache
(client/snapshot_cache.py, the fdbclient/SnapshotCache.h analog): every
point and range read records what it learned at the transaction's read
version, and later reads resolve against (cache, writes) — the
RYWIterator.cpp merge — before falling to the cluster.  A read-twice
transaction issues exactly one cluster fetch; key selectors resolve over
the merged view, so a selector anchored next to a key this transaction
cleared steps past it without any server round trip seeing the write.

Copy of the reference package's module.
"""

from __future__ import annotations

from ..keys import key_after
from ..roles.types import CLIENT_KEYSPACE_END, KeySelector, MutationType, apply_atomic
from .snapshot_cache import SnapshotCache
from .transaction import Database, Transaction, selector_conflict_range


_CLEARED = object()


class WriteMap:
    """Buffered writes: point writes + cleared ranges, mergeable over
    snapshot data for range reads."""

    def __init__(self) -> None:
        self._writes: dict[bytes, object] = {}   # key -> value | _CLEARED
        self._clears: list[tuple[bytes, bytes]] = []

    def set(self, key: bytes, value: bytes) -> None:
        self._writes[key] = value

    def clear_range(self, begin: bytes, end: bytes) -> None:
        for k in list(self._writes):
            if begin <= k < end:
                del self._writes[k]
        self._clears.append((begin, end))

    def lookup(self, key: bytes):
        """Returns value, _CLEARED, or None (unknown locally)."""
        if key in self._writes:
            return self._writes[key]
        for b, e in self._clears:
            if b <= key < e:
                return _CLEARED
        return None

    def overlay_range(self, data: list[tuple[bytes, bytes]], begin: bytes, end: bytes,
                      limit: int) -> list[tuple[bytes, bytes]]:
        merged = {k: v for k, v in data}
        for b, e in self._clears:
            for k in list(merged):
                if b <= k < e:
                    del merged[k]
        for k, v in self._writes.items():
            if begin <= k < end:
                if v is _CLEARED:
                    merged.pop(k, None)
                else:
                    merged[k] = v
        return sorted(merged.items())[:limit]


class ReadYourWritesTransaction:
    def __init__(self, db: Database) -> None:
        self._tr = db.create_transaction()
        self._wm = WriteMap()
        self._cache = SnapshotCache(
            getattr(db, "cache_stats", None),
            getattr(db.knobs, "RYW_CACHE_BYTES", 1 << 22),
        )

    def set_option(self, option: bytes, value: bytes | None = None) -> None:
        self._tr.set_option(option, value)

    # -- reads (merged) ------------------------------------------------------
    async def get(self, key: bytes, snapshot: bool = False) -> bytes | None:
        local = self._wm.lookup(key)
        if local is _CLEARED:
            return None
        if local is not None:
            return local  # served from the write map: no storage read at all
        if key.startswith(b"\xff\xff"):
            # special-key-space module reads regenerate per call (status
            # json, timelines): never cache them
            return await self._tr.get(key, snapshot=snapshot)
        known, val = self._cache.get(key)
        if known:
            # a cache-served read still CONFLICT-protects like the fetch it
            # replaced — OCC correctness does not care where the bytes came
            # from (the reference adds read conflicts above the cache too)
            if not snapshot:
                self._tr.add_read_conflict_range(key, key_after(key))
            return val
        val = await self._tr.get(key, snapshot=snapshot)
        self._cache.insert(key, key_after(key), [] if val is None else [(key, val)])
        return val

    async def get_range(self, begin, end, limit: int = 10000,
                        snapshot: bool = False) -> list[tuple[bytes, bytes]]:
        """Merged range read — the (cache, writes) merge iterator
        (RYWIterator.cpp): walk the window left to right, serving each
        stretch the SnapshotCache already knows locally and fetching only
        the unknown gaps (each fetch extends the cache).  Buffered clears
        can remove snapshot rows and buffered sets can add them, so a
        limited fetch may under-fill the merged window: keep walking until
        the limit is met or the window is exhausted."""
        if isinstance(begin, KeySelector) or isinstance(end, KeySelector):
            b = begin if isinstance(begin, bytes) else await self.get_key(
                begin, snapshot=snapshot
            )
            e = end if isinstance(end, bytes) else await self.get_key(
                end, snapshot=snapshot
            )
            if b >= e:
                return []
            return await self.get_range(b, e, limit=limit, snapshot=snapshot)
        if begin.startswith(b"\xff\xff"):
            return await self._tr.get_range(begin, end, limit=limit,
                                            snapshot=snapshot)
        out: list[tuple[bytes, bytes]] = []
        cursor = begin
        while len(out) < limit and cursor < end:
            covered_end, rows = self._cache.covered_prefix(cursor, end)
            if covered_end > cursor:
                out.extend(
                    self._wm.overlay_range(rows, cursor, covered_end,
                                           limit - len(out))
                )
                cursor = covered_end
                continue
            # unknown at cursor: fetch a chunk (snapshot=True — this layer
            # adds ONE conflict range for the whole window below)
            data = await self._tr.get_range(
                cursor, end, limit=limit, snapshot=True
            )
            exhausted = len(data) < limit
            covered_end = end if exhausted else key_after(data[-1][0])
            self._cache.insert(cursor, covered_end, data)
            out.extend(
                self._wm.overlay_range(data, cursor, covered_end,
                                       limit - len(out))
            )
            if exhausted:
                cursor = covered_end
                break
            cursor = covered_end
        if not snapshot:
            self._tr.add_read_conflict_range(begin, end)
        return out[:limit]

    async def get_key(self, selector: KeySelector, snapshot: bool = False) -> bytes:
        """Resolve a KeySelector against the MERGED view — cache + this
        transaction's writes — so e.g. first_greater_or_equal(k) steps past
        a k this transaction cleared, and lands ON a key it just wrote
        (the RYWIterator selector walk).  Reads underneath are snapshot
        reads; the narrow resolution conflict range (the same formula as
        Transaction.get_key) is added at this layer."""
        if not isinstance(selector, KeySelector):
            raise TypeError("get_key takes a KeySelector")
        if selector.key.startswith(b"\xff\xff"):
            raise ValueError("key selectors are not supported under \\xff\\xff")
        stats = self._cache.stats
        if stats is not None:
            stats.c_selector_reads.add(1)
        sel = selector
        forward = sel.offset > 0
        skip_equal = sel.or_equal == forward
        distance = sel.offset if forward else 1 - sel.offset
        need = distance + (1 if skip_equal else 0)
        if forward:
            anchor = min(sel.key, CLIENT_KEYSPACE_END)
            rows = await self.get_range(
                anchor, CLIENT_KEYSPACE_END, limit=need, snapshot=True
            )
            index = distance - 1
            if skip_equal and rows and rows[0][0] == sel.key:
                index += 1
            rep = rows[index][0] if index < len(rows) else CLIENT_KEYSPACE_END
        else:
            # backward: the merged view has no reverse cursor, so walk
            # BOUNDED windows leftward, server-guided: each probe asks the
            # cluster (server-side getKey, cheap) for the floor of the next
            # `remaining` live server keys below the window, then the
            # merged read over [floor, hi) filters them through
            # cache+writes.  Local sets only add candidates (fewer probes);
            # a local clear can kill a whole probe's keys and pushes the
            # window further left — each pass moves `hi` strictly down, so
            # the worst case (everything below the anchor cleared) degrades
            # to the full scan, never worse.
            hi = min(key_after(sel.key), CLIENT_KEYSPACE_END)
            desc: list[bytes] = []  # merged live keys, descending
            while len(desc) < need:
                remaining = need - len(desc)
                floor = await self._tr.get_key(
                    KeySelector(hi, False, -(remaining - 1)), snapshot=True
                )
                rows = await self.get_range(floor, hi, limit=1 << 30,
                                            snapshot=True)
                desc.extend(k for k, _ in reversed(rows))
                if floor == b"":
                    break
                hi = floor
            index = distance - 1
            if skip_equal and desc and desc[0] == sel.key:
                index += 1
            rep = desc[index] if index < len(desc) else b""
        if not snapshot:
            cr = selector_conflict_range(selector, rep)
            if cr is not None:
                self._tr.add_read_conflict_range(*cr)
        return rep

    # -- writes (buffered in both layers) ------------------------------------
    def set(self, key: bytes, value: bytes) -> None:
        self._wm.set(key, value)
        self._tr.set(key, value)

    def clear(self, key: bytes) -> None:
        self.clear_range(key, key_after(key))

    def clear_range(self, begin: bytes, end: bytes) -> None:
        self._wm.clear_range(begin, end)
        self._tr.clear_range(begin, end)

    def atomic_op(self, op: MutationType, key: bytes, operand: bytes) -> None:
        local = self._wm.lookup(key)
        if local is not None and local is not _CLEARED:
            # fold into a literal so later reads see it (RYWIterator folding)
            new = apply_atomic(op, local, operand)
            self.set(key, new)
        else:
            self._tr.atomic_op(op, key, operand)
            # subsequent local reads of this key are undefined until commit
            # (reference: unreadable ranges); keep it absent from the WriteMap
            # AND from the snapshot cache — the stored value is stale the
            # moment this commits
            self._cache.clear()

    def add_read_conflict_range(self, begin: bytes, end: bytes) -> None:
        self._tr.add_read_conflict_range(begin, end)

    def add_write_conflict_range(self, begin: bytes, end: bytes) -> None:
        self._tr.add_write_conflict_range(begin, end)

    async def get_read_version(self):
        return await self._tr.get_read_version()

    async def commit(self):
        return await self._tr.commit()

    async def on_error(self, e: BaseException) -> None:
        """Retry protocol (tr.onError): delegate backoff/fence to the inner
        transaction and drop the write map + snapshot cache for the fresh
        attempt (the retry reads at a NEW version)."""
        await self._tr.on_error(e)
        self._wm = WriteMap()
        self._cache.clear()

    def reset(self) -> None:
        self._tr.reset()
        self._wm = WriteMap()
        self._cache.clear()

    @property
    def committed_version(self):
        return self._tr.committed_version
