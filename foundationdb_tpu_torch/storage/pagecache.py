"""File-level page cache with read-ahead — the AsyncFileCached analog
(fdbrpc/AsyncFileCached.actor.cpp: an 828-LoC page cache slotted under
every storage file, serving fixed-size pages out of one byte-bounded
process-wide pool).

`CachedFile` wraps a `SimFile` and serves `pread` out of fixed-size cache
pages held in a `PageCachePool` shared by every cached file of the
filesystem (the per-process pool: one budget, LRU across ALL files, so a
hot B-tree steals pages from a cold WAL and not vice versa).  The write
path is write-through for this runtime's append-only engines: appends go
straight to the underlying file (which IS the OS page-cache model —
buffered until fsync) and the cache never holds a dirty page, so eviction
is always free and a power-kill can never lose cached-only data.

Coherence is event-driven, not polled.  File contents BELOW the last full
page boundary change only through three events — `truncate`,
`cancel_truncate`, and the kill-path `_drop_unsynced` — and `SimFile`
notifies the pool on each (storage/files.py), dropping the file's pages.
Appends only extend the file, and the pool refuses to cache a partial
tail page (`len < page_size`), so a cached page can never go stale by
growth.  Cached pages die with the process lifetime: the pool hangs off
the cluster assembly (a fresh pool per boot), never off the disks.

Fault-plane layering (the correctness seam the cache-vs-faults tests
pin): the `disk.corrupt_read` transient flip is applied ABOVE the cache —
page fills read the file with `faults=False` and `CachedFile.pread` runs
the same per-call flip on the assembled result — so a corrupt read is
never cached and the caller's retry heals it from a clean page, exactly
as a checksummed re-read heals a transient media error.  `DiskFull`,
injected `IOError`s, and stall windows live on the append/sync path,
which passes through untouched.

Read-ahead: a miss that continues the previous fetched run (a sequential
scan's signature) fetches `readahead_pages` extra pages in the SAME
underlying `pread` — one disk op brings in the whole run, the classic
sequential-read-ahead AsyncFileCached implements and the cold range-scan
perf smoke measures.

Knobs (runtime/knobs.py): `PAGE_CACHE_BYTES` (pool budget; 0 disables),
`PAGE_CACHE_4K` (page size), `READAHEAD_PAGES`.

Copy of the reference package's module, on the port's own modules.
"""

from __future__ import annotations

from collections import OrderedDict

from ..runtime.buggify import buggify
from ..runtime.coverage import testcov


class PageCachePool:
    """The shared byte-bounded page pool: (path, page_index) -> page bytes,
    LRU over every cached file's pages together.  Only FULL pages are
    admitted (a short tail page would go stale the moment an append
    extends it); eviction pops least-recently-used until the byte gauge
    is back under budget."""

    def __init__(self, page_size: int = 4096, capacity_bytes: int = 2 << 20,
                 readahead_pages: int = 8) -> None:
        assert page_size > 0 and capacity_bytes >= 0
        self.page_size = page_size
        self.capacity_bytes = capacity_bytes
        self.readahead_pages = max(readahead_pages, 0)
        self._pages: OrderedDict[tuple[str, int], bytes] = OrderedDict()
        # first-touch read-ahead attribution: pages brought in beyond the
        # requested run, not yet hit (a hit pops membership and counts as
        # the fetching file's readahead_hit)
        self._prefetched: set[tuple[str, int]] = set()
        self.bytes = 0
        self.evictions = 0
        self.invalidations = 0
        self.readahead_batches = 0

    def contains(self, path: str, idx: int) -> bool:
        """Membership without the LRU touch / prefetch-flag pop — the miss
        run detector's probe (a `get` here would strip read-ahead
        attribution from pages the caller is about to hit for real)."""
        return (path, idx) in self._pages

    def get(self, path: str, idx: int) -> tuple[bytes, bool] | None:
        """The page, plus whether this is the first touch of a page that
        read-ahead (not demand) brought in — None on miss."""
        key = (path, idx)
        page = self._pages.get(key)
        if page is None:
            return None
        self._pages.move_to_end(key)
        was_prefetched = key in self._prefetched
        if was_prefetched:
            self._prefetched.discard(key)
        return page, was_prefetched

    def put(self, path: str, idx: int, page: bytes,
            prefetched: bool = False) -> None:
        """Admit one FULL page (short tail pages are served but never
        cached — they would go stale on the next append)."""
        if len(page) != self.page_size:
            return
        key = (path, idx)
        old = self._pages.pop(key, None)
        if old is not None:
            self.bytes -= len(old)
            self._prefetched.discard(key)
        # chaos: rarely drop the whole pool (a memory-pressure flush) —
        # always safe, the cache is clean by construction; stresses the
        # refill/miss paths a steady-state hot cache never exercises
        if buggify("cache.evict_all"):
            self.clear()
        self._pages[key] = page
        self.bytes += len(page)
        if prefetched:
            self._prefetched.add(key)
        while self.bytes > self.capacity_bytes and len(self._pages) > 1:
            k, v = self._pages.popitem(last=False)
            self.bytes -= len(v)
            self._prefetched.discard(k)
            self.evictions += 1
            testcov("cache.evict")

    def invalidate_file(self, path: str) -> None:
        """Drop every page of `path` — the truncate / cancel_truncate /
        kill-time-unsynced-drop coherence hook (SimFile calls this on each
        content-mutating event below the append-only tail)."""
        doomed = [k for k in self._pages if k[0] == path]
        for k in doomed:
            self.bytes -= len(self._pages.pop(k))
            self._prefetched.discard(k)
        if doomed:
            self.invalidations += 1
            testcov("cache.invalidate_file")

    def clear(self) -> None:
        self._pages.clear()
        self._prefetched.clear()
        self.bytes = 0

    def stats(self) -> dict:
        """Pool-level gauges for the status document's shared block (the
        per-file hit/miss counters live on each CachedFile)."""
        return {
            "page_size": self.page_size,
            "capacity_bytes": self.capacity_bytes,
            "bytes": self.bytes,
            "pages": len(self._pages),
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "readahead_batches": self.readahead_batches,
        }


class CachedFile:
    """A SimFile wearing the page cache: same surface (append / sync /
    truncate / pread / sizes), reads served out of the shared pool.  The
    write path delegates untouched — ENOSPC, injected IOErrors, stalls,
    and the io_timeout kill all reach the caller exactly as they would on
    the bare file."""

    def __init__(self, file, pool: PageCachePool) -> None:
        self._f = file
        self._pool = pool
        self.hits = 0
        self.misses = 0
        self.readahead_pages = 0
        self.readahead_hits = 0
        # read-ahead trigger: the page one past the last fetched run — a
        # miss landing exactly there is a sequential scan continuing
        self._seq_next = -1

    # -- delegated surface ---------------------------------------------------
    @property
    def path(self) -> str:
        return self._f.path

    @property
    def _fs(self):
        return self._f._fs

    @property
    def _st(self):
        return self._f._st

    def append(self, data: bytes) -> None:
        # write-through: the underlying file buffers (it IS the fsync
        # model); appends never touch cached pages — only full pages are
        # cached and appends happen past the last full page boundary
        self._f.append(data)

    async def sync(self) -> None:
        await self._f.sync()

    def truncate(self) -> None:
        self._f.truncate()  # SimFile.truncate invalidates our pages

    def cancel_truncate(self) -> None:
        self._f.cancel_truncate()

    def read_all(self) -> bytes:
        return self._f.read_all()

    def read_durable(self) -> bytes:
        return self._f.read_durable()

    def synced_size(self) -> int:
        return self._f.synced_size()

    def size(self) -> int:
        return self._f.size()

    def _drop_unsynced(self) -> None:
        self._f._drop_unsynced()  # invalidates via the SimFile hook

    def close(self) -> None:
        self._f.close()

    # -- the cached read path ------------------------------------------------
    def pread(self, offset: int, length: int) -> bytes:
        """Positional read assembled from cache pages; misses fill from
        the underlying file in ONE pread per contiguous run (read-ahead
        extends a sequential run's fetch).  The transient corrupt-read
        flip is applied to the assembled RESULT — never to a cached page —
        so a checksum-failed retry re-reads clean bytes and heals."""
        fsize = self._f.size()
        end = min(offset + max(length, 0), fsize)
        if offset >= end:
            return b""
        S = self._pool.page_size
        p0, p1 = offset // S, (end - 1) // S
        pages: list[bytes] = []
        p = p0
        while p <= p1:
            got = self._pool.get(self.path, p)
            if got is not None:
                page, was_prefetched = got
                self.hits += 1
                if was_prefetched:
                    self.readahead_hits += 1
                    testcov("cache.readahead_hit")
                pages.append(page)
                p += 1
                continue
            # contiguous miss run [p, run_end)
            run_end = p + 1
            while run_end <= p1 and not self._pool.contains(self.path, run_end):
                run_end += 1
            need = run_end - p
            extra = 0
            if p == self._seq_next and self._pool.readahead_pages > 0:
                # sequential scan detected: fetch ahead in the same pread
                last_page = (fsize - 1) // S
                extra = min(self._pool.readahead_pages,
                            max(last_page - (run_end - 1), 0))
                if extra:
                    self._pool.readahead_batches += 1
                    testcov("cache.readahead")
            raw = self._f.pread(p * S, (need + extra) * S, faults=False)
            self.misses += need
            for i in range((len(raw) + S - 1) // S):
                pg = raw[i * S: (i + 1) * S]
                if i < need:
                    self._pool.put(self.path, p + i, pg)
                    pages.append(pg)
                elif not self._pool.contains(self.path, p + i):
                    # admit only pages read-ahead NEWLY brought in: an
                    # already-cached page must keep its demand history
                    # (and its bytes), or the readahead_hits gauge the
                    # runbook tunes READAHEAD_PAGES by over-counts
                    self._pool.put(self.path, p + i, pg, prefetched=True)
                    self.readahead_pages += 1
            self._seq_next = p + need + extra
            p = run_end
        out = b"".join(pages)[offset - p0 * S: end - p0 * S]
        # the fault plane stays BELOW callers but ABOVE the cache: the
        # flip rides the returned copy only
        flipped = self._f._maybe_corrupt(out)
        if flipped is not out:
            testcov("cache.corrupt_read_not_cached")
        return flipped

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "readahead_pages": self.readahead_pages,
            "readahead_hits": self.readahead_hits,
        }


def file_stats_block(files, parsed_hits: int = 0, parsed_misses: int = 0,
                     parsed_bytes: int = 0) -> dict:
    """The canonical per-store `page_cache` counter block (status schema
    `storage[*].page_cache`): CachedFile counters summed over `files`
    (raw SimFiles contribute nothing) plus the caller's parsed-page
    gauges.  One definition, so a counter added to CachedFile.stats()
    can never drift out of the stores' blocks."""
    out = {
        "hits": 0, "misses": 0, "readahead_pages": 0, "readahead_hits": 0,
        "parsed_hits": parsed_hits,
        "parsed_misses": parsed_misses,
        "parsed_bytes": parsed_bytes,
    }
    for f in files:
        st = getattr(f, "stats", None)
        if st is not None:
            for k, v in st().items():
                out[k] = out.get(k, 0) + v
    return out


def maybe_cached(fs, file):
    """Wrap `file` in the filesystem's shared page pool when one is armed
    (cluster assembly sets `fs.page_pool` from the PAGE_CACHE_* knobs;
    bare unit-test filesystems default to None = raw file, bit-identical
    behavior)."""
    pool = getattr(fs, "page_pool", None)
    if pool is None:
        return file
    return CachedFile(file, pool)
