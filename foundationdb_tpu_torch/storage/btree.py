"""ssd-class storage engine: an append-only copy-on-write B+tree
(the KeyValueStoreSQLite / Redwood VersionedBTree slot of the reference —
fdbserver/KeyValueStoreSQLite.actor.cpp:1408, fdbserver/VersionedBTree.actor.cpp:439
— re-designed around this runtime's append-only journaled file seam).

Unlike the memory engines, data volume is DISK-bounded: resident memory is
the uncommitted memtable, an LRU page cache, and a leaf DIRECTORY of
(first_key, page_offset, count) — 1/fanout of the data, the classic
B+tree trade with the branch levels held hot.

Layout
  <path>.a / <path>.b   append-only page files (alternating compaction
                        epochs: a compaction bulk-writes the live tree into
                        the OTHER file, so a crash mid-compaction can never
                        damage the tree the header still points at)
  <path>.hdr            a DiskQueue holding ONE root record (file id,
                        branch-root offset, key count, meta); its journaled
                        rewrite makes the root swap atomic

Commit protocol (strict ordering = crash safety):
  1. fold the memtable: COW-rewrite ONLY the leaves the dirty keys / clear
     ranges touch (new pages appended; untouched leaves stay by offset)
  2. serialize the leaf directory as branch pages (1/fanout of the leaves)
  3. sync the data file          (pages durable before anything names them)
  4. rewrite + sync the header   (the atomic root swap)
A crash between 3 and 4 recovers the PREVIOUS root, whose pages are all
still present because data files are append-only within an epoch.

Copy of the reference package's module, on the port's own modules.
"""

from __future__ import annotations

import bisect
import zlib
from collections import OrderedDict

from ..runtime.serialize import BinaryReader, BinaryWriter
from .diskqueue import DiskQueue
from .files import SimFilesystem
from .pagecache import maybe_cached

_LEAF, _BRANCH = 0, 1
_FANOUT = 128  # entries per page: fanout**2 = 16K leaves ≈ 2M keys at 1 branch level

_TOP = b"\xff" * 64  # sorts above any real key in this codebase

# first-read chunk for _read_page: one bounded pread covers the 8-byte
# header AND the whole body for any page up to this size (the common
# case); only an oversized page pays a second read for its tail
_READ_CHUNK = 4096

# parsed-page cache accounting overhead: per-page / per-entry constants
# approximating the Python object cost around the raw key/value bytes, so
# the byte budget tracks the real heap, not just payload
_PAGE_OVERHEAD = 96
_ENTRY_OVERHEAD = 48


class BTreeKeyValueStore:
    """IKeyValueStore with on-disk pages + bounded memory (StorageServer
    slots it in via the same get/set/clear_range/range_read/commit seam as
    the memory engines; data distribution uses count_range/middle_key)."""

    def __init__(
        self,
        fs: SimFilesystem,
        path: str,
        process,
        cache_bytes: int = 4 << 20,
    ) -> None:
        self._fs = fs
        self._path = path
        self._process = process
        # parsed-page cache budget in BYTES (was a page COUNT, blind to
        # page size — a few huge leaves could blow the host heap)
        self._cache_budget = cache_bytes
        self._cache_bytes = 0
        # data + header files ride the shared file-level page cache when
        # the filesystem has one armed (storage/pagecache.py)
        self._files = [
            maybe_cached(fs, fs.open(path + ".a", process)),
            maybe_cached(fs, fs.open(path + ".b", process)),
        ]
        self._hdr = DiskQueue(maybe_cached(fs, fs.open(path + ".hdr", process)))
        # (file_id, offset) -> (parsed page, approx bytes)
        self._cache: OrderedDict[tuple[int, int], tuple[list, int]] = OrderedDict()
        # leaf directory: parallel sorted lists (first_key, offset, count)
        self._dir_keys: list[bytes] = []
        self._dir_offs: list[int] = []
        self._dir_cnts: list[int] = []
        self._dir_bytes: list[int] = []
        # memtable: uncommitted point writes (None = delete) + clear ranges
        self._mem: dict[bytes, bytes | None] = {}
        self._clears: list[tuple[bytes, bytes]] = []
        self.meta: dict[str, int] = {}
        self._file_id = 0
        self._appended = 0
        self._live_bytes = 1
        # page-cache accounting (AsyncFileCached's hit/miss counters —
        # surfaced through the storage status rows)
        self.cache_hits = 0
        self.cache_misses = 0

    # ---- mutation -----------------------------------------------------------
    def set(self, key: bytes, value: bytes) -> None:
        self._mem[key] = bytes(value)

    def clear_range(self, begin: bytes, end: bytes) -> None:
        if begin >= end:
            return
        for k in [k for k in self._mem if begin <= k < end]:
            del self._mem[k]
        self._clears.append((begin, end))

    # ---- reads (committed tree + memtable overlay) --------------------------
    def _mem_covered(self, key: bytes) -> bool:
        return any(b <= key < e for b, e in self._clears)

    def get(self, key: bytes) -> bytes | None:
        if key in self._mem:
            return self._mem[key]
        if self._mem_covered(key):
            return None
        i = bisect.bisect_right(self._dir_keys, key) - 1
        if i < 0:
            return None
        keys, vals = self._read_leaf(self._dir_offs[i])
        j = bisect.bisect_left(keys, key)
        if j < len(keys) and keys[j] == key:
            return vals[j]
        return None

    def _tree_range(self, begin: bytes, end: bytes):
        """Committed rows in [begin, end), leaf by leaf."""
        i = max(bisect.bisect_right(self._dir_keys, begin) - 1, 0)
        while i < len(self._dir_keys):
            if self._dir_keys[i] >= end:
                break
            keys, vals = self._read_leaf(self._dir_offs[i])
            lo = bisect.bisect_left(keys, begin)
            hi = bisect.bisect_left(keys, end)
            for j in range(lo, hi):
                yield keys[j], vals[j]
            i += 1

    def range_read(self, begin: bytes, end: bytes, limit: int) -> list[tuple[bytes, bytes]]:
        out: list[tuple[bytes, bytes]] = []
        mem = sorted(
            (k, v) for k, v in self._mem.items() if begin <= k < end
        )
        mi = 0
        for k, v in self._tree_range(begin, end):
            while mi < len(mem) and mem[mi][0] < k:
                if mem[mi][1] is not None:
                    out.append(mem[mi])
                mi += 1
            if mi < len(mem) and mem[mi][0] == k:
                if mem[mi][1] is not None:
                    out.append(mem[mi])
                mi += 1
            elif not any(b <= k < e for b, e in self._clears):
                out.append((k, v))
            if len(out) >= limit:
                return out[:limit]
        while mi < len(mem):
            if mem[mi][1] is not None:
                out.append(mem[mi])
            mi += 1
        return out[:limit]

    def key_count(self) -> int:
        return sum(self._dir_cnts) + sum(
            1 for v in self._mem.values() if v is not None
        )

    def _walk_dir(self, begin: bytes, end: bytes):
        """Yield (leaf_index, fully_inside, lo, hi) for every directory leaf
        overlapping [begin, end); lo/hi are entry bounds for edge leaves
        (None for fully-covered ones) — the one walk behind every
        directory-served metric."""
        dk = self._dir_keys
        if not dk or begin >= end:
            return
        i = max(bisect.bisect_right(dk, begin) - 1, 0)
        while i < len(dk):
            if dk[i] >= end:
                break
            fully = dk[i] >= begin and (i + 1 < len(dk) and dk[i + 1] <= end)
            if fully:
                yield i, True, None, None
            else:
                keys, _vals = self._read_leaf(self._dir_offs[i])
                yield (
                    i, False,
                    bisect.bisect_left(keys, begin),
                    bisect.bisect_left(keys, end),
                )
            i += 1

    def _committed_count(self, begin: bytes, end: bytes) -> int:
        """Committed keys in [begin, end): O(log n) via the directory's
        per-leaf counts, decoding only the two edge leaves."""
        total = 0
        for i, fully, lo, hi in self._walk_dir(begin, end):
            total += self._dir_cnts[i] if fully else hi - lo
        return total

    def bytes_range(self, begin: bytes, end: bytes) -> int:
        """Committed bytes in [begin, end): full leaves served from the
        directory's byte sums, edge leaves decoded (memtable/clears excluded
        — a sampling-grade answer, like the reference's StorageMetrics)."""
        total = 0
        for i, fully, lo, hi in self._walk_dir(begin, end):
            if fully:
                total += self._dir_bytes[i]
            else:
                keys, vals = self._read_leaf(self._dir_offs[i])
                total += sum(len(keys[j]) + len(vals[j]) for j in range(lo, hi))
        return total

    def count_range(self, begin: bytes, end: bytes) -> int:
        """Exact count via directory counts + memtable adjustment — never a
        full materialization (data distribution polls this every tick)."""
        c = self._committed_count(begin, end)
        # disjoint-ify the pending clears, subtract their committed overlap
        merged: list[tuple[bytes, bytes]] = []
        for b, e in sorted(self._clears):
            b2, e2 = max(b, begin), min(e, end)
            if b2 >= e2:
                continue
            if merged and b2 <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e2))
            else:
                merged.append((b2, e2))
        for b, e in merged:
            c -= self._committed_count(b, e)
        for k, v in self._mem.items():
            if not (begin <= k < end):
                continue
            visible = self._tree_get_visible(k)
            if v is None:
                c -= 1 if visible else 0
            else:
                c += 0 if visible else 1
        return c

    def _tree_get_visible(self, key: bytes) -> bool:
        """Committed key present AND not hidden by a pending clear."""
        if any(b <= key < e for b, e in self._clears):
            return False
        i = bisect.bisect_right(self._dir_keys, key) - 1
        if i < 0:
            return False
        keys, _vals = self._read_leaf(self._dir_offs[i])
        j = bisect.bisect_left(keys, key)
        return j < len(keys) and keys[j] == key

    def middle_key(self, begin: bytes, end: bytes) -> bytes | None:
        """Median COMMITTED key of the range — a split-point sample for data
        distribution (the uncommitted memtable is noise at sampling scale),
        found by walking directory counts to the median leaf."""
        total = self._committed_count(begin, end)
        if total < 2:
            return None
        target = total // 2
        for i, fully, lo, hi in self._walk_dir(begin, end):
            if fully:
                n = self._dir_cnts[i]
                if target < n:
                    keys, _vals = self._read_leaf(self._dir_offs[i])
                    return keys[target]
            else:
                n = hi - lo
                if target < n:
                    keys, _vals = self._read_leaf(self._dir_offs[i])
                    return keys[lo + target]
            target -= n
        return None

    def page_cache_stats(self) -> dict:
        """The KernelStats-style page-cache counter block the status doc's
        per-role `storage[*].page_cache` renders: file-level hit/miss/
        read-ahead counters summed over this store's cached files, plus
        the parsed-page cache's own hit/miss and live byte gauge."""
        from .pagecache import file_stats_block

        return file_stats_block(
            (*self._files, self._hdr.file),
            parsed_hits=self.cache_hits,
            parsed_misses=self.cache_misses,
            parsed_bytes=self._cache_bytes,
        )

    def disk_usage(self) -> tuple[int, int | None]:
        """(bytes used, capacity|None) — the fullest of this store's disks
        (data files + header), the free-space input ratekeeper reads.  The
        capacitated disk closest to full wins; with no capacity anywhere,
        total usage with None."""
        paths = [f.path for f in self._files] + [self._hdr.file.path]
        worst: tuple[int, int | None] | None = None
        total = 0
        for p in paths:
            used, cap = self._fs.usage_for(p)
            total += used
            if cap is not None and (
                worst is None or used * (worst[1] or 1) > worst[0] * cap
            ):
                worst = (used, cap)
        return worst if worst is not None else (total, None)

    # ---- commit -------------------------------------------------------------
    async def commit(self, meta: dict[str, int] | None = None) -> None:
        if meta:
            self.meta.update(meta)
        if self._mem or self._clears:
            self._fold_memtable()
        if self._appended > max(4 * self._live_bytes, 1 << 16):
            await self._compact()
            return  # compaction synced its own header
        root = self._write_branches()
        await self._files[self._file_id].sync()
        self._write_header(root)
        await self._hdr.sync()

    def _write_header(self, root: int) -> None:
        w = (
            BinaryWriter()
            .u8(self._file_id)
            .i64(root)
            .i64(self._live_bytes)
            .u32(len(self.meta))
        )
        for k, v in sorted(self.meta.items()):
            w.str_(k).i64(v)
        self._hdr.rewrite([w.data()])

    def _write_branches(self) -> int:
        """Serialize the leaf directory as branch pages, return the root
        offset (-1 = empty tree).  Branch levels are 1/fanout of the leaves,
        so rebuilding them per commit is cheap and keeps recovery O(dir)."""
        entries = list(zip(self._dir_keys, self._dir_offs, self._dir_cnts,
                           self._dir_bytes))
        if not entries:
            return -1
        while True:
            pages = []
            for i in range(0, len(entries), _FANOUT):
                chunk = entries[i : i + _FANOUT]
                off = self._append_page(
                    _BRANCH,
                    [k for k, _o, _c, _b in chunk],
                    [(o, c, b) for _k, o, c, b in chunk],
                )
                pages.append((
                    chunk[0][0], off,
                    sum(c for _k, _o, c, _b in chunk),
                    sum(b for _k, _o, _c, b in chunk),
                ))
            if len(pages) == 1:
                return pages[0][1]
            entries = pages

    # ---- recovery -----------------------------------------------------------
    @classmethod
    def recover(cls, fs: SimFilesystem, path: str, process,
                cache_bytes: int = 4 << 20) -> "BTreeKeyValueStore":
        store = cls(fs, path, process, cache_bytes)
        records = store._hdr.recover()
        if not records:
            return store
        r = BinaryReader(records[-1])
        store._file_id = r.u8()
        root = r.i64()
        store._live_bytes = r.i64()
        store.meta = {r.str_(): r.i64() for _ in range(r.u32())}
        if root >= 0:
            store._load_dir(root)
        store._appended = store._files[store._file_id].size()
        return store

    def _load_dir(self, off: int) -> None:
        """Rebuild the in-memory leaf directory by walking the branch pages
        (recovery: O(directory), no leaf reads except a lone root leaf)."""
        kind, keys, vals = self._read_page(off)
        if kind == _LEAF:
            if keys:
                self._dir_keys, self._dir_offs, self._dir_cnts = (
                    [keys[0]], [off], [len(keys)]
                )
                self._dir_bytes = [
                    sum(len(k) + len(v) for k, v in zip(keys, vals))
                ]
            return
        for k, (child, cnt, nbytes) in zip(keys, vals):
            ckind, _ckeys, _cvals = self._read_page(child)
            if ckind == _BRANCH:
                self._load_dir(child)
            else:
                self._dir_keys.append(k)
                self._dir_offs.append(child)
                self._dir_cnts.append(cnt)
                self._dir_bytes.append(nbytes)

    # ---- page IO ------------------------------------------------------------
    def _append_page(self, kind: int, keys: list, vals: list) -> int:
        w = BinaryWriter().u8(kind).u32(len(keys))
        for i, k in enumerate(keys):
            w.bytes_(k)
            if kind == _LEAF:
                w.bytes_(vals[i])
            else:
                w.i64(vals[i][0]).i64(vals[i][1]).i64(vals[i][2])
        body = w.data()
        page = (
            BinaryWriter().u32(len(body)).u32(zlib.crc32(body) & 0xFFFFFFFF).data()
            + body
        )
        f = self._files[self._file_id]
        off = f.size()
        f.append(page)
        self._appended += len(page)
        self._cache_put((self._file_id, off), (kind, list(keys), list(vals)))
        return off

    def _read_page(self, off: int):
        key = (self._file_id, off)
        hit = self._cache.get(key)
        if hit is not None:
            self.cache_hits += 1
            self._cache.move_to_end(key)
            return hit[0]
        self.cache_misses += 1
        f = self._files[self._file_id]
        # checksum mismatches are retried once: the sim's corrupt-on-read
        # fault (disk.corrupt_read) is a transient media error; only a
        # second failure means the page is really gone
        for attempt in (0, 1):
            # ONE bounded read covers header + body for any page up to
            # _READ_CHUNK (the common case — was two preads: 8-byte
            # header, then body); only an oversized page reads its tail
            chunk = f.pread(off, _READ_CHUNK)
            r = BinaryReader(chunk[:8])
            ln, crc = r.u32(), r.u32()
            if 8 + ln <= len(chunk):
                body = chunk[8: 8 + ln]
            else:
                body = chunk[8:] + f.pread(off + len(chunk),
                                           8 + ln - len(chunk))
            if len(body) == ln and (zlib.crc32(body) & 0xFFFFFFFF) == crc:
                break
            if attempt == 1:
                raise IOError(f"btree page corrupt at {self._path}[{off}]")
            from ..runtime.coverage import testcov

            testcov("disk.btree_corrupt_read_retried")
        r = BinaryReader(body)
        kind, n = r.u8(), r.u32()
        keys, vals = [], []
        for _ in range(n):
            keys.append(r.bytes_())
            vals.append(
                r.bytes_() if kind == _LEAF else (r.i64(), r.i64(), r.i64())
            )
        page = (kind, keys, vals)
        self._cache_put(key, page)
        return page

    def _read_leaf(self, off: int):
        kind, keys, vals = self._read_page(off)
        assert kind == _LEAF
        return keys, vals

    @staticmethod
    def _page_bytes(page) -> int:
        """Approximate heap bytes of one parsed page (payload + per-entry
        object overhead) — the unit the byte-bounded cache budget evicts
        by, so one huge leaf costs what it weighs."""
        kind, keys, vals = page
        n = _PAGE_OVERHEAD + len(keys) * _ENTRY_OVERHEAD
        for k in keys:
            n += len(k)
        if kind == _LEAF:
            for v in vals:
                n += len(v)
        else:
            n += len(vals) * 24
        return n

    def _cache_put(self, key, page) -> None:
        old = self._cache.pop(key, None)
        if old is not None:
            self._cache_bytes -= old[1]
        nbytes = self._page_bytes(page)
        self._cache[key] = (page, nbytes)
        self._cache_bytes += nbytes
        # byte-bounded LRU: evict oldest until under budget; the newest
        # entry always survives (a single over-budget page still caches —
        # evicting it would thrash every touch)
        while self._cache_bytes > self._cache_budget and len(self._cache) > 1:
            _k, (_pg, nb) = self._cache.popitem(last=False)
            self._cache_bytes -= nb

    # ---- memtable fold (COW leaf rewrite) -----------------------------------
    def _fold_memtable(self) -> None:
        """Fold the memtable into COW-rewritten leaves.  ATOMIC against
        the disk fault plane: an append refused mid-fold (ENOSPC /
        injected IOError — DiskSwizzle's bread and butter) restores the
        memtable AND the leaf directory to their pre-fold state before
        re-raising, so the durability loop's retry re-folds everything.
        Without the rollback a refused append lost the already-consumed
        memtable and left the directory half-rewritten — acked-data loss
        the memory engine's WAL-push-first discipline rules out but this
        engine didn't (found by the PageCacheChaos spec, pinned by
        tests/test_pagecache.py).  Orphaned pages appended before the
        failure are harmless: append-only file, nothing references them."""
        saved = (
            self._dir_keys[:], self._dir_offs[:], self._dir_cnts[:],
            self._dir_bytes[:], self._live_bytes,
        )
        items = sorted(self._mem.items())
        clears = sorted(self._clears)
        self._mem = {}
        self._clears = []
        try:
            self._fold_memtable_inner(items, clears)
        except IOError:
            (self._dir_keys, self._dir_offs, self._dir_cnts,
             self._dir_bytes, self._live_bytes) = saved
            self._mem = dict(items)
            self._clears = list(clears)
            from ..runtime.coverage import testcov

            testcov("btree.fold_rolled_back")
            raise

    def _fold_memtable_inner(self, items, clears) -> None:
        if not self._dir_keys:
            rows = [(k, v) for k, v in items if v is not None]
            self._replace_leaves(0, 0, rows)
            self._live_bytes += sum(len(k) + len(v) for k, v in rows)
            return

        def covered(k: bytes) -> bool:
            return any(b <= k < e for b, e in clears)

        def leaf_touched(lo: bytes, hi: bytes) -> bool:
            i = bisect.bisect_left(items, (lo,)) if items else 0
            if i < len(items) and items[i][0] < hi:
                return True
            return any(b < hi and e > lo for b, e in clears)

        n = len(self._dir_keys)
        i = 0
        while i < n:
            lo = self._dir_keys[i] if i > 0 else b""
            hi = self._dir_keys[i + 1] if i + 1 < n else _TOP
            if not leaf_touched(lo, hi):
                i += 1
                continue
            # extend the touched region over consecutive touched leaves so
            # splits/merges rebalance across them in one pass
            j = i
            while j + 1 < n:
                nlo = self._dir_keys[j + 1]
                nhi = self._dir_keys[j + 2] if j + 2 < n else _TOP
                if leaf_touched(nlo, nhi):
                    j += 1
                else:
                    break
            hi = self._dir_keys[j + 1] if j + 1 < n else _TOP
            merged: dict[bytes, bytes | None] = {}
            for idx in range(i, j + 1):
                keys, vals = self._read_leaf(self._dir_offs[idx])
                merged.update(zip(keys, vals))
            before = sum(len(k) + len(v) for k, v in merged.items())
            for k in [k for k in merged if covered(k)]:
                del merged[k]
            ii = bisect.bisect_left(items, (lo,)) if items else 0
            while ii < len(items) and items[ii][0] < hi:
                k, v = items[ii]
                if v is None:
                    merged.pop(k, None)
                else:
                    merged[k] = v
                ii += 1
            rows = sorted(merged.items())
            after = sum(len(k) + len(v) for k, v in rows)
            self._live_bytes = max(self._live_bytes + after - before, 1)
            added = self._replace_leaves(i, j + 1, rows)
            n = len(self._dir_keys)
            i = i + added

    def _replace_leaves(self, lo_idx: int, hi_idx: int, rows) -> int:
        """Replace directory entries [lo_idx, hi_idx) with fresh leaves for
        `rows`; returns how many entries were inserted."""
        new_k, new_o, new_c, new_b = [], [], [], []
        for s in range(0, len(rows), _FANOUT):
            chunk = rows[s : s + _FANOUT]
            off = self._append_page(
                _LEAF, [k for k, _ in chunk], [v for _, v in chunk]
            )
            new_k.append(chunk[0][0])
            new_o.append(off)
            new_c.append(len(chunk))
            new_b.append(sum(len(k) + len(v) for k, v in chunk))
        self._dir_keys[lo_idx:hi_idx] = new_k
        self._dir_offs[lo_idx:hi_idx] = new_o
        self._dir_cnts[lo_idx:hi_idx] = new_c
        self._dir_bytes[lo_idx:hi_idx] = new_b
        return len(new_k)

    # ---- compaction ---------------------------------------------------------
    async def _compact(self) -> None:
        """Bulk-write the live tree into the other data file, then swap the
        header.  Crash-safe: the old file is untouched until the header
        names the new one; a crash mid-compaction recovers the old root.
        Fault-atomic like the fold: an append refused mid-rewrite (disk
        fault plane) restores the in-memory directory, un-journals the
        truncate, and re-raises — the durability retry compacts again.
        A failure at/after the sync keeps the NEW in-memory tree: its
        pages are all buffered in the new file, so the retried sync +
        header swap lands them (the durable root stays old throughout)."""
        rows = list(self._tree_range(b"", _TOP))
        other = 1 - self._file_id
        f = self._files[other]
        saved = (
            self._dir_keys[:], self._dir_offs[:], self._dir_cnts[:],
            self._dir_bytes[:], self._live_bytes, self._file_id,
            self._appended,
        )
        f.truncate()
        self._file_id = other
        self._appended = 0
        self._cache.clear()
        self._cache_bytes = 0
        self._dir_keys, self._dir_offs, self._dir_cnts = [], [], []
        self._dir_bytes = []
        try:
            self._replace_leaves(0, 0, rows)
            self._live_bytes = max(sum(len(k) + len(v) for k, v in rows), 1)
            root = self._write_branches()
        except IOError:
            (self._dir_keys, self._dir_offs, self._dir_cnts,
             self._dir_bytes, self._live_bytes, self._file_id,
             self._appended) = saved
            f.cancel_truncate()
            # parsed pages cached during the aborted rewrite are keyed by
            # offsets the restored file no longer matches — drop them all
            self._cache.clear()
            self._cache_bytes = 0
            from ..runtime.coverage import testcov

            testcov("btree.compact_rolled_back")
            raise
        await f.sync()
        self._write_header(root)
        await self._hdr.sync()
