"""Read-your-writes snapshot cache (fdbclient/SnapshotCache.h:116).

A transaction's reads all happen at ONE read version, so everything a read
learns stays true for the rest of the transaction: a fetched value, and —
just as important — the *absence* of keys inside a fetched window.  The
reference models this as a keyspace partitioned into "known" and "unknown"
ranges, where a known range carries the exact set of (key, value) pairs
inside it; RYWIterator then merges that knowledge with the uncommitted
write map.  This module is that structure: disjoint, sorted *segments* of
complete knowledge, populated by point and range reads, consulted before
any cluster fetch.  A read-twice transaction touches the cluster once.

Segments are capped by the RYW_CACHE_BYTES client knob with LRU-ish
eviction (least-recently-touched segment goes first; the most recent
survivor is never evicted, so the cap degrades throughput, not
correctness).  Counters aggregate per-Database in `CacheStats`, surfaced
in `cluster_status` and the periodic ClientMetrics trace event
(docs/OBSERVABILITY.md).

Copy of the reference package's module.
"""

from __future__ import annotations

import bisect
import weakref


class CacheStats:
    """Per-Database aggregate over every transaction's SnapshotCache:
    lifetime hit/miss/insert/evict counters (CounterCollection, so the
    ClientMetrics emitter can rate-convert them) plus a live-bytes gauge
    summed over the still-referenced caches."""

    def __init__(self) -> None:
        from ..runtime.trace import CounterCollection

        self.counters = CounterCollection("RywCache")
        self.c_hits = self.counters.counter("cache_hits")
        self.c_misses = self.counters.counter("cache_misses")
        self.c_inserts = self.counters.counter("cache_inserts")
        self.c_evictions = self.counters.counter("cache_evictions")
        self.c_selector_reads = self.counters.counter("selector_reads")
        self._live: "weakref.WeakSet[SnapshotCache]" = weakref.WeakSet()

    def snapshot(self) -> dict:
        return {
            **self.counters.snapshot(),
            "bytes": sum(c._bytes for c in self._live),
            "transactions": len(self._live),
        }


class _Seg:
    """One known range [begin, end): every live key inside it is listed in
    `keys`/`vals` (sorted); a key in the range but not listed is KNOWN
    ABSENT at the transaction's read version."""

    __slots__ = ("begin", "end", "keys", "vals", "bytes", "last_use")

    def __init__(self, begin: bytes, end: bytes, keys: list[bytes],
                 vals: list[bytes], last_use: int) -> None:
        self.begin = begin
        self.end = end
        self.keys = keys
        self.vals = vals
        self.bytes = (
            len(begin) + len(end)
            + sum(map(len, keys)) + sum(map(len, vals)) + 64
        )
        self.last_use = last_use


class SnapshotCache:
    def __init__(self, stats: CacheStats | None = None,
                 max_bytes: int = 1 << 22) -> None:
        self.stats = stats
        self.max_bytes = max_bytes
        self._segs: list[_Seg] = []       # disjoint, sorted by begin
        self._begins: list[bytes] = []    # parallel bisect index
        self._bytes = 0
        self._clock = 0                   # LRU tick
        if stats is not None:
            stats._live.add(self)

    # -- internals -----------------------------------------------------------
    def _touch(self, seg: _Seg) -> None:
        self._clock += 1
        seg.last_use = self._clock

    def _seg_covering(self, key: bytes) -> _Seg | None:
        i = bisect.bisect_right(self._begins, key) - 1
        if i >= 0:
            seg = self._segs[i]
            if seg.begin <= key < seg.end:
                return seg
        return None

    def _rows_in(self, seg: _Seg, begin: bytes, end: bytes) -> list[tuple[bytes, bytes]]:
        lo = bisect.bisect_left(seg.keys, begin)
        hi = bisect.bisect_left(seg.keys, end)
        return list(zip(seg.keys[lo:hi], seg.vals[lo:hi]))

    # -- reads ---------------------------------------------------------------
    def get(self, key: bytes) -> tuple[bool, bytes | None]:
        """(known, value): known=True means the answer is authoritative at
        the read version — value None is a KNOWN-ABSENT key, not a miss."""
        seg = self._seg_covering(key)
        if seg is None:
            if self.stats is not None:
                self.stats.c_misses.add(1)
            return False, None
        self._touch(seg)
        if self.stats is not None:
            self.stats.c_hits.add(1)
        i = bisect.bisect_left(seg.keys, key)
        if i < len(seg.keys) and seg.keys[i] == key:
            return True, seg.vals[i]
        return True, None

    def covered_prefix(self, begin: bytes, end: bytes) -> tuple[bytes, list[tuple[bytes, bytes]]]:
        """(covered_end, rows): knowledge is CONTIGUOUS over [begin,
        covered_end) and `rows` are exactly the live keys inside it.
        covered_end == begin means the cache knows nothing at `begin`.
        Counts one hit when it advances, one miss when it cannot."""
        cursor = begin
        rows: list[tuple[bytes, bytes]] = []
        while cursor < end:
            seg = self._seg_covering(cursor)
            if seg is None or seg.end <= cursor:
                break
            self._touch(seg)
            stop = min(seg.end, end)
            rows.extend(self._rows_in(seg, cursor, stop))
            cursor = stop
        if self.stats is not None:
            (self.stats.c_hits if cursor > begin else self.stats.c_misses).add(1)
        return cursor, rows

    # -- writes of knowledge -------------------------------------------------
    def insert(self, begin: bytes, end: bytes,
               rows: list[tuple[bytes, bytes]]) -> None:
        """Record complete knowledge of [begin, end): `rows` are ALL the
        live keys inside it at the transaction's read version.  Overlapping
        segments merge — both sides are truth at the same version, so the
        union is too (MVCC guarantees the overlap agrees)."""
        if begin > end:
            raise ValueError("inverted cache insert")
        if begin == end:
            return
        lo = bisect.bisect_right(self._begins, begin) - 1
        if lo >= 0 and self._segs[lo].end < begin:
            lo += 1
        elif lo < 0:
            lo = 0
        hi = lo
        nb, ne = begin, end
        merged: dict[bytes, bytes] = {}
        while hi < len(self._segs) and self._segs[hi].begin <= end:
            seg = self._segs[hi]
            nb = min(nb, seg.begin)
            ne = max(ne, seg.end)
            merged.update(zip(seg.keys, seg.vals))
            self._bytes -= seg.bytes
            hi += 1
        merged.update(rows)
        keys = sorted(merged)
        seg = _Seg(nb, ne, keys, [merged[k] for k in keys], self._clock + 1)
        self._clock += 1
        self._segs[lo:hi] = [seg]
        self._begins[lo:hi] = [nb]
        self._bytes += seg.bytes
        if self.stats is not None:
            self.stats.c_inserts.add(1)
        self._evict()

    def _evict(self) -> None:
        """LRU-ish: drop least-recently-touched segments until under the
        byte cap.  The most recent survivor always stays — a single read
        larger than the cap still completes and stays consistent."""
        while self._bytes > self.max_bytes and len(self._segs) > 1:
            i = min(range(len(self._segs)), key=lambda j: self._segs[j].last_use)
            self._bytes -= self._segs[i].bytes
            del self._segs[i]
            del self._begins[i]
            if self.stats is not None:
                self.stats.c_evictions.add(1)

    def clear(self) -> None:
        """Forget everything (reset / on_error: the next attempt reads at a
        NEW version, so nothing cached remains true)."""
        self._segs = []
        self._begins = []
        self._bytes = 0
