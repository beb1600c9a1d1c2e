"""Storage server — MVCC reads over a pluggable KV store
(fdbserver/storageserver.actor.cpp; VersionedMap fdbclient/VersionedMap.h).

A storage server *pulls* its tag's mutations from the TLog (update :2371 via
peek cursors), applies them to an in-memory versioned overlay, serves reads
at any version inside the MVCC window (getValueQ :723, getKeyValues :1228),
and continuously makes data durable in its IKeyValueStore, popping the TLog
up to the durable version.  Commit latency never includes storage apply —
the same asynchrony as the reference.

The versioned overlay keeps, per key, the recent version chain; reads pick
the newest entry ≤ read version.  Older versions fall out as durability
advances (VersionedMap forgetVersionsBefore).

Copy of the reference package's role, on the port's runtime and rpc: the
same TLog stream and reads give the same replies at the same virtual
times.
"""

from __future__ import annotations

import bisect
from typing import Iterable

from .sequencer import NotifiedVersion
from .storage_metrics import StorageServerMetrics
from .types import (
    FutureVersion,
    GetKeyReply,
    GetKeyRequest,
    GetKeyValuesReply,
    GetKeyValuesRequest,
    GetValueReply,
    GetValueRequest,
    KeySelector,
    Mutation,
    MutationType,
    TLogPeekRequest,
    TLogPopRequest,
    TransactionTooOld,
    Version,
    WatchValueRequest,
    apply_atomic,
)
from ..rpc.network import SimProcess
from ..rpc.stream import RequestStream, RequestStreamRef
from ..runtime.buggify import maybe_delay
from ..runtime.coverage import testcov
from ..runtime.core import BrokenPromise, EventLoop, TaskPriority, TimedOut
from ..runtime.metrics import LatencyTracker
from ..runtime.trace import CounterCollection, g_trace_batch, spawn_role_metrics
from ..runtime.knobs import CoreKnobs


class MemoryKeyValueStore:
    """The `memory` storage engine analog (KeyValueStoreMemory.actor.cpp:57):
    ordered in-memory map; durable by fiat (a DiskQueue-backed version slots
    in via the same interface)."""

    def __init__(self) -> None:
        self._keys: list[bytes] = []
        self._data: dict[bytes, bytes] = {}

    def get(self, key: bytes) -> bytes | None:
        return self._data.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        if key not in self._data:
            bisect.insort(self._keys, key)
        self._data[key] = value

    def clear_range(self, begin: bytes, end: bytes) -> None:
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        for k in self._keys[lo:hi]:
            del self._data[k]
        del self._keys[lo:hi]

    def range_read(self, begin: bytes, end: bytes, limit: int) -> list[tuple[bytes, bytes]]:
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        return [(k, self._data[k]) for k in self._keys[lo : min(hi, lo + limit)]]

    def key_count(self) -> int:
        return len(self._keys)

    def count_range(self, begin: bytes, end: bytes) -> int:
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        return hi - lo

    def bytes_range(self, begin: bytes, end: bytes) -> int:
        """Stored bytes in [begin, end) — the StorageMetrics size half (the
        reference splits shards on BYTES, not key counts).  O(range) scan:
        this engine is the simulation-scale store; the ssd engine answers
        the same query from its directory's running sums in O(log n)."""
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        return sum(
            len(k) + len(self._data[k]) for k in self._keys[lo:hi]
        )

    def middle_key(self, begin: bytes, end: bytes) -> bytes | None:
        """Median key of [begin, end) — the data-distribution split-point
        sample (the reference samples byte-weighted splits via
        StorageMetrics; key-median is our stand-in)."""
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        if hi - lo < 2:
            return None
        return self._keys[(lo + hi) // 2]


_CLEARED = object()  # tombstone marker in version chains

# end-of-keyspace sentinel for half-open ranges whose end is None (sorts
# above the `\xff/...` system keyspace)
TOP_KEY = b"\xff\xff\xff\xff\xff\xff"


class VersionedOverlay:
    """Per-key version chains + range-clear history over a durable base.

    Read algorithm for (key, v): newest overlay entry with version <= v wins
    (value or tombstone); else if a clear-range at version <= v covers the
    key and is newer than durability, the base value is hidden; else base.
    Simplification vs the reference's PTree: clears keep an explicit range
    list inside the window (bounded by the window's mutation count).
    """

    def __init__(self) -> None:
        self._chains: dict[bytes, list[tuple[Version, object]]] = {}
        self._chain_keys: list[bytes] = []  # sorted index over _chains
        self._clears: list[tuple[Version, bytes, bytes]] = []  # (v, begin, end)
        # begin-sorted clear view + prefix max-end, for O(log n + overlap)
        # point stabs instead of a full-list scan per base-miss read
        self._stab_dirty = False
        self._stab: list[tuple[bytes, bytes, Version]] = []
        self._stab_begins: list[bytes] = []
        self._stab_maxend: list[bytes] = []
        self.oldest = 0  # oldest readable version retained

    def _chain_for(self, key: bytes) -> list:
        chain = self._chains.get(key)
        if chain is None:
            chain = self._chains[key] = []
            bisect.insort(self._chain_keys, key)
        return chain

    def _rebuild_stab(self) -> None:
        self._stab = sorted((b, e, v) for v, b, e in self._clears)
        self._stab_begins = [b for b, _e, _v in self._stab]
        self._stab_maxend = []
        m = b""
        for _b, e, _v in self._stab:
            m = max(m, e)
            self._stab_maxend.append(m)
        self._stab_dirty = False

    def apply(self, version: Version, m: Mutation, base_get) -> None:
        if m.type == MutationType.SET_VALUE:
            self._chain_for(m.key).append((version, m.value))
        elif m.type == MutationType.CLEAR_RANGE:
            self._clears.append((version, m.key, m.value))
            self._stab_dirty = True
            # touch only the chains inside the range (sorted index bisect),
            # not every chain in the overlay
            lo = bisect.bisect_left(self._chain_keys, m.key)
            hi = bisect.bisect_left(self._chain_keys, m.value)
            for k in self._chain_keys[lo:hi]:
                self._chains[k].append((version, _CLEARED))
        else:  # atomic op: fold with the current visible value
            old = self.get(m.key, version, base_get)
            new = apply_atomic(m.type, old, m.value)
            self._chain_for(m.key).append((version, new))

    def _cleared_after_base(self, key: bytes, version: Version) -> bool:
        if not self._clears:
            return False
        if self._stab_dirty:
            self._rebuild_stab()
        # candidates have begin <= key; prune the walk once no remaining
        # prefix can reach past `key`
        i = bisect.bisect_right(self._stab_begins, key) - 1
        while i >= 0 and self._stab_maxend[i] > key:
            b, e, v = self._stab[i]
            if e > key and v <= version:
                return True
            i -= 1
        return False

    def get(self, key: bytes, version: Version, base_get) -> bytes | None:
        chain = self._chains.get(key)
        if chain:
            for v, val in reversed(chain):
                if v <= version:
                    return None if val is _CLEARED else val
        if self._cleared_after_base(key, version):
            return None
        return base_get(key)

    def overlay_keys_in(self, begin: bytes, end: bytes) -> Iterable[bytes]:
        lo = bisect.bisect_left(self._chain_keys, begin)
        hi = bisect.bisect_left(self._chain_keys, end)
        return self._chain_keys[lo:hi]

    def forget_before(self, version: Version, base_set, base_clear) -> None:
        """Flush entries <= version into the base and drop old history.

        Replay order matters: range-clears go into the base FIRST, then
        per-key newest values.  A set at a version later than a covering
        clear must survive the flush; per-key ordering within the window is
        already encoded by the chain (apply() interleaves _CLEARED
        tombstones in version/mutation order), so the last flushable chain
        entry is the correct final state — no extra clear-wins check.
        """
        for cv, b, e in self._clears:
            if cv <= version:
                base_clear(b, e)
        self._clears = [c for c in self._clears if c[0] > version]
        self._stab_dirty = True
        self._flush_chains(version, base_set, base_clear)
        self.oldest = max(self.oldest, version)

    def _flush_chains(self, version: Version, base_set, base_clear) -> None:
        for key, chain in list(self._chains.items()):
            flushable = [(v, val) for v, val in chain if v <= version]
            if flushable:
                v, val = flushable[-1]
                if val is _CLEARED:
                    base_clear(key, key + b"\x00")
                else:
                    base_set(key, val)
                remaining = [(v2, val2) for v2, val2 in chain if v2 > version]
                if remaining:
                    self._chains[key] = remaining
                else:
                    del self._chains[key]
        self._chain_keys = sorted(self._chains)

    def purge_range(self, begin: bytes, end: bytes) -> None:
        """Drop every chain in [begin, end) (data distribution: a shard
        moved away; clear-history entries inside the range are left — they
        hide nothing once the base is cleared too)."""
        lo = bisect.bisect_left(self._chain_keys, begin)
        hi = bisect.bisect_left(self._chain_keys, end)
        for k in self._chain_keys[lo:hi]:
            del self._chains[k]
        del self._chain_keys[lo:hi]

    def rollback_to(self, version: Version) -> None:
        """Discard every entry/clear with version > version (recovery: a
        storage server may have applied mutations a failed TLog replica
        served but that fall above the recovery version — phantom,
        UNKNOWN-result transactions that must not survive; the reference
        rolls storage back past the recovery version)."""
        for key, chain in list(self._chains.items()):
            kept = [(v, val) for v, val in chain if v <= version]
            if kept:
                self._chains[key] = kept
            else:
                del self._chains[key]
        self._chain_keys = sorted(self._chains)
        self._clears = [c for c in self._clears if c[0] <= version]
        self._stab_dirty = True


class _FetchState:
    """An in-progress fetchKeys (storageserver.actor.cpp fetchKeys: the dest
    of a shard move buffers its tag-stream mutations for the moving range
    while it reads a snapshot from the source team, then replays the buffer
    on top)."""

    def __init__(self, begin: bytes, end: bytes | None, boundary: Version) -> None:
        self.begin = begin
        self.end = end
        self.boundary = boundary  # first version the dest tag covers the range
        self.buffer: list[tuple[Version, Mutation]] = []
        self.epoch = 0  # bumped by rollback: in-flight snapshot is stale

    @property
    def end_key(self) -> bytes:
        return TOP_KEY if self.end is None else self.end

    def covers(self, key: bytes) -> bool:
        return self.begin <= key < self.end_key


class StorageServer:
    WLT_GETVALUE = "wlt:ss_getvalue"
    WLT_GETKEYVALUES = "wlt:ss_getkeyvalues"
    WLT_GETKEY = "wlt:ss_getkey"
    WLT_WATCH = "wlt:ss_watch"

    def __init__(
        self,
        process: SimProcess,
        loop: EventLoop,
        knobs: CoreKnobs,
        tlog_peek_ref: RequestStreamRef,
        tlog_pop_ref: RequestStreamRef,
        tag: str,
        store: MemoryKeyValueStore | None = None,
        start_version: Version = 0,
    ) -> None:
        self.loop = loop
        self.knobs = knobs
        self.tlog = tlog_peek_ref
        self.tlog_pop = tlog_pop_ref
        self.tag = tag
        self.process = process
        self.store = store or MemoryKeyValueStore()
        self.overlay = VersionedOverlay()
        self.version = NotifiedVersion(start_version)   # newest applied
        self.durable_version = start_version
        self._fetched = start_version
        # durability watermark: highest version known committed cluster-wide
        # (proxy -> TLog -> peek reply).  Versions above it may be rolled
        # back by a recovery, so they must never reach the durable base.
        self.known_committed = start_version
        # bumped by set_tlog_source: a peek reply awaited across a rollback
        # must be discarded, not applied (it may carry phantom versions)
        self._pull_epoch = 0
        # data distribution state: ranges being fetched (mutations buffered)
        # and per-range read floors (a moved-in range is only readable at or
        # above its snapshot version)
        self._fetching: list[_FetchState] = []
        # per-range read floors (a moved-in range is readable only at or
        # above its snapshot version) as a coalescing range map — the
        # KeyRangeMap structure the reference keeps such metadata in
        from ..utils.rangemap import KeyRangeMap

        self._range_floor = KeyRangeMap(default=0)
        # read-path latency bands (receipt→reply, simulated seconds): point
        # gets and range reads share one tracker — the storage half of the
        # reference's readLatencyBands
        self.read_latency = LatencyTracker()
        # the load-metric plane (StorageMetrics.actor.h analog): byte
        # sample on the write path, bandwidth samples on the serve path —
        # what DD split decisions and ratekeeper attribution poll
        self.load_metrics = StorageServerMetrics(knobs)
        self.counters = CounterCollection("StorageServer")
        self.c_reads = self.counters.counter("reads")
        self.c_selector_reads = self.counters.counter("selector_reads")
        self.c_mutations = self.counters.counter("mutations_applied")
        self.c_io_errors = self.counters.counter("io_errors")
        # bytes applied above the durable version (the reference's
        # bytesInput - bytesDurable storage queue): ratekeeper's
        # storage_queue spring input.  Kept as a per-version ledger so the
        # durability advance and rollbacks subtract exactly what they
        # retire.
        self.queue_bytes = 0
        self._qbytes: list[tuple[Version, int]] = []
        self._metrics_emitter = None
        self.getvalue_stream = RequestStream(process, self.WLT_GETVALUE, unique=True)
        self.getkv_stream = RequestStream(process, self.WLT_GETKEYVALUES, unique=True)
        self.getkey_stream = RequestStream(process, self.WLT_GETKEY, unique=True)
        self.watch_stream = RequestStream(process, self.WLT_WATCH, unique=True)
        self._watches: dict[bytes, list] = {}  # key -> [(expected, req)]
        self._dur_task = loop.spawn(
            self._durability(), TaskPriority.STORAGE_SERVER, f"ss-dur-{tag}"
        )
        self._tasks = [
            loop.spawn(self._pull(), TaskPriority.STORAGE_SERVER, f"ss-pull-{tag}"),
            loop.spawn(self._serve_getvalue(), TaskPriority.STORAGE_SERVER, f"ss-gv-{tag}"),
            loop.spawn(self._serve_getkv(), TaskPriority.STORAGE_SERVER, f"ss-gkv-{tag}"),
            loop.spawn(self._serve_getkey(), TaskPriority.STORAGE_SERVER, f"ss-gk-{tag}"),
            loop.spawn(self._serve_watch(), TaskPriority.STORAGE_SERVER, f"ss-w-{tag}"),
            self._dur_task,
        ]

    def freeze_writes(self) -> None:
        """Retiring-replica mode (the exclusion drain retires a LIVE
        server): keep pulling and serving reads — the replacement fetches
        its snapshot from here at any version — but never touch the store
        file or the shared tag queue again.  The replacement recovers this
        replica's store file and becomes the tag's only popper; its pops
        trail its own durable version, so nothing this (ahead) replica
        still needs is trimmed."""
        if self.tlog_pop is not None:
            self._saved_pop = self.tlog_pop
            self.tlog_pop = None
        if self._dur_task is not None:
            self._dur_task.cancel()
            self._dur_task = None

    def unfreeze_writes(self) -> None:
        """Undo freeze_writes (a failed exclusion drain rolls back; the
        replacement's flushed WAL entries are valid same-tag data, so
        resuming appends keeps the log consistent)."""
        if self.tlog_pop is None and getattr(self, "_saved_pop", None) is not None:
            self.tlog_pop = self._saved_pop
            self._saved_pop = None
        if self._dur_task is None:
            self._dur_task = self.loop.spawn(
                self._durability(), TaskPriority.STORAGE_SERVER,
                f"ss-dur-{self.tag}",
            )
            self._tasks.append(self._dur_task)

    # -- write path: pull from TLog -----------------------------------------
    async def _pull(self) -> None:
        while True:
            if self.tlog is None:  # no log system yet (pre-first-recovery)
                await self.loop.delay(0.05, TaskPriority.STORAGE_SERVER)
                continue
            await maybe_delay(self.loop, "storage.delay_pull")
            epoch = self._pull_epoch
            try:
                reply = await self.tlog.get_reply(
                    TLogPeekRequest(self.tag, self._fetched + 1), timeout=1.0
                )
            except (TimedOut, BrokenPromise):
                # TLog down or unreachable (kill/clog/partition): back off
                # and retry — the pull loop must survive transient faults
                await self.loop.delay(0.1, TaskPriority.STORAGE_SERVER)
                continue
            if epoch != self._pull_epoch:
                continue  # rolled back while awaiting: stale reply, drop it
            self.known_committed = max(self.known_committed, reply.known_committed)
            for version, muts in reply.entries:
                if version <= self.version.get():
                    continue
                live = self._route_fetching(version, muts) if self._fetching else muts
                nb = 0
                now = self.loop.now()
                for m in live:
                    self.overlay.apply(version, m, self.store.get)
                    nb += len(m.key) + len(m.value or b"")
                    if m.type == MutationType.CLEAR_RANGE:
                        self.load_metrics.on_clear_range(m.key, m.value, now)
                    else:
                        # atomics charge the operand length: the folded
                        # value is close enough for a sampled estimate
                        self.load_metrics.on_set(
                            m.key, len(m.value or b""), now
                        )
                if nb:
                    self._qbytes.append((version, nb))
                    self.queue_bytes += nb
                self.c_mutations.add(len(live))
                self.version.set(version)
                self._fetched = version
                if self._watches and live:
                    self._fire_watches(live)
            if reply.end_version - 1 > self.version.get():
                # tlog knows newer versions with no data for our tag
                self.version.set(reply.end_version - 1)
                self._fetched = reply.end_version - 1
            if not reply.entries:
                await self.loop.delay(0.005, TaskPriority.STORAGE_SERVER)

    def _route_fetching(self, version: Version, muts) -> list[Mutation]:
        """Split a tag-stream batch between live apply and fetch buffers.

        Point mutations inside a fetching range are buffered whole; a
        clear-range has its fetching overlap buffered (clipped) AND is still
        applied live in full — clearing keys this server doesn't hold is a
        no-op, and the same-version duplicate on replay is idempotent."""
        live: list[Mutation] = []
        for m in muts:
            if m.type == MutationType.CLEAR_RANGE:
                for fs in self._fetching:
                    b = max(m.key, fs.begin)
                    e = min(m.value, fs.end_key)
                    if b < e:
                        fs.buffer.append(
                            (version, Mutation(MutationType.CLEAR_RANGE, b, e))
                        )
                live.append(m)
            else:
                fs = next((f for f in self._fetching if f.covers(m.key)), None)
                if fs is not None:
                    fs.buffer.append((version, m))
                else:
                    live.append(m)
        return live

    # -- fetchKeys (data distribution dest side) -----------------------------
    def start_fetch(self, begin: bytes, end: bytes | None, boundary: Version,
                    sources: list[RequestStreamRef]):
        """Begin owning [begin, end): buffer its tag-stream mutations and
        fetch a snapshot from the source team's read endpoints
        (storageserver.actor.cpp fetchKeys).  Returns a Future resolving to
        the snapshot version once the range is live here."""
        fs = _FetchState(begin, end, boundary)
        self._fetching.append(fs)
        task = self.loop.spawn(
            self._fetch_keys(fs, sources), TaskPriority.STORAGE_SERVER,
            f"ss-fetch-{self.tag}",
        )
        self._tasks.append(task)
        return task

    async def _fetch_keys(self, fs: _FetchState, sources: list[RequestStreamRef]) -> Version:
        try:
            return await self._fetch_keys_inner(fs, sources)
        except BaseException:
            # failed/cancelled fetch must not leave a stale buffering state
            # behind (it would swallow this range's mutations forever), nor
            # parked watches that no one will ever evaluate
            if fs in self._fetching:
                self._fetching.remove(fs)
            for k in [k for k in self._watches if fs.begin <= k < fs.end_key]:
                for _expected, req in self._watches.pop(k):
                    req.reply_error(FutureVersion("shard fetch abandoned"))
            raise

    async def _fetch_keys_inner(self, fs: _FetchState, sources: list[RequestStreamRef]) -> Version:
        si = 0
        attempts = 0
        while True:
            attempts += 1
            if attempts > 60:
                # bounded: every source gone for many rounds — surface the
                # failure so data distribution can roll the move back
                raise TimedOut(f"fetchKeys [{fs.begin!r},{fs.end!r}) found no source")
            epoch = fs.epoch
            # snapshot at a version this server has already seen committed:
            # >= boundary so nothing between boundary and snapshot is missed
            # (those mutations are IN the snapshot; buffered copies <= V are
            # skipped at replay)
            snap_v = max(self.version.get(), fs.boundary)
            rows: list[tuple[bytes, bytes]] = []
            b = fs.begin
            ok = True
            while True:
                ref = sources[si % len(sources)]
                try:
                    reply = await ref.get_reply(
                        GetKeyValuesRequest(b, fs.end_key, snap_v, 5000), timeout=2.0
                    )
                except (TimedOut, BrokenPromise, TransactionTooOld, FutureVersion):
                    si += 1  # rotate replica / refresh the snapshot version
                    ok = False
                    break
                rows.extend(reply.data)
                if not reply.more:
                    break
                from ..keys import key_after

                b = key_after(rows[-1][0])
            if not ok or fs.epoch != epoch:
                await self.loop.delay(0.05, TaskPriority.STORAGE_SERVER)
                continue
            self._finalize_fetch(fs, snap_v, rows)
            return snap_v

    def _finalize_fetch(self, fs: _FetchState, snap_v: Version,
                        rows: list[tuple[bytes, bytes]]) -> None:
        """Synchronous (no awaits → no interleaved pulls): ground the range,
        lay the snapshot down at snap_v, replay buffered mutations above it,
        then open the range for reads at floor snap_v."""
        self.overlay.apply(
            snap_v, Mutation(MutationType.CLEAR_RANGE, fs.begin, fs.end_key),
            self.store.get,
        )
        for k, val in rows:
            self.overlay.apply(snap_v, Mutation(MutationType.SET_VALUE, k, val),
                               self.store.get)
        # the moved-in range enters the byte sample too: the snapshot rows
        # are presence (not traffic), buffer replays are recent writes
        now = self.loop.now()
        self.load_metrics.byte_sample.clear_range(fs.begin, fs.end_key)
        self.load_metrics.on_fetch_rows(rows)
        for version, m in fs.buffer:
            if version > snap_v:
                self.overlay.apply(version, m, self.store.get)
                if m.type == MutationType.CLEAR_RANGE:
                    self.load_metrics.on_clear_range(m.key, m.value, now)
                else:
                    self.load_metrics.on_set(m.key, len(m.value or b""), now)
        self._fetching.remove(fs)
        self._range_floor.merge(fs.begin, fs.end_key, snap_v, max)
        # watches parked while the range was in flight (plus any registered
        # before a move-in) are evaluated against the now-real data; a
        # synthetic range "touch" reuses the normal fire logic
        if self._watches:
            self._fire_watches(
                [Mutation(MutationType.CLEAR_RANGE, fs.begin, fs.end_key)]
            )

    def shard_metrics(self, begin: bytes, end: bytes) -> tuple[int, int]:
        """Approximate (keys, bytes) in [begin, end) over the LIVE view —
        base store plus the un-flushed MVCC-window overlay (StorageMetrics
        measures what is there, not what has been flushed).  Overlay keys
        are deduplicated against the base and tombstones subtract, so a
        rewrite-heavy window does not inflate the metric."""
        n = self.store.count_range(begin, end)
        bts = self.store.bytes_range(begin, end)
        # un-flushed range-clears hide base data: subtract their (disjoint)
        # committed coverage, or a just-cleared shard still looks split-hot
        merged: list[tuple[bytes, bytes]] = []
        for _v, cb, ce in sorted(self.overlay._clears, key=lambda c: c[1]):
            b2, e2 = max(cb, begin), min(ce, end)
            if b2 >= e2:
                continue
            if merged and b2 <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e2))
            else:
                merged.append((b2, e2))
        for cb, ce in merged:
            n -= self.store.count_range(cb, ce)
            bts -= self.store.bytes_range(cb, ce)
        def in_merged(k: bytes) -> bool:
            j = bisect.bisect_right(merged, (k, b"\xff" * 40)) - 1
            return j >= 0 and merged[j][0] <= k < merged[j][1]

        for k in self.overlay.overlay_keys_in(begin, end):
            chain = self.overlay._chains.get(k)
            newest = chain[-1][1] if chain else None
            base_val = self.store.get(k)
            if newest is _CLEARED:
                # point tombstone; keys under a merged clear were already
                # subtracted wholesale above
                if base_val is not None and not in_merged(k):
                    n -= 1
                    bts -= len(k) + len(base_val)
            elif base_val is None or in_merged(k):
                # new in the window, or re-set on top of a pending clear
                n += 1
                bts += len(k) + (
                    len(newest) if isinstance(newest, (bytes, bytearray)) else 0
                )
        return max(n, 0), max(bts, 0)

    def metrics_range(self, begin: bytes, end: bytes) -> dict:
        """The waitMetrics query surface (StorageMetrics.actor.h): sampled
        bytes + bytes_read_per_ksec / bytes_written_per_ksec estimates for
        [begin, end), O(sampled keys), never a data scan — what
        DataDistribution polls every tracker tick."""
        return self.load_metrics.metrics(begin, end, self.loop.now())

    def sampled_split_point(self, begin: bytes, end: bytes) -> bytes | None:
        """splitMetrics analog: the sampled byte-weighted median of
        [begin, end).  A range too sparse to sample (simulation-scale
        shards) falls back to the exact key median — a split decision must
        not fail just because every entry is below the sampling unit."""
        k = self.load_metrics.split_point(begin, end)
        return k if k is not None else self.split_point(begin, end)

    def busiest_range(self) -> tuple[bytes | None, float]:
        """(hot key, combined read+write bytes/sec) from the bandwidth
        samples — ratekeeper's limiting-shard attribution input."""
        return self.load_metrics.busiest_range(self.loop.now())

    def split_point(self, begin: bytes, end: bytes) -> bytes | None:
        """Median live key of [begin, end) — data distribution's split-key
        sample.  The committed median (O(log n) via the store) serves; only
        a near-empty base falls back to the window overlay, which is small
        by construction."""
        k = self.store.middle_key(begin, end)
        if k is not None:
            return k
        keys = sorted(
            set(k for k, _v in self.store.range_read(begin, end, 1000))
            | set(self.overlay.overlay_keys_in(begin, end))
        )
        if len(keys) < 2:
            return None
        return keys[len(keys) // 2]

    def drop_range(self, begin: bytes, end: bytes | None) -> None:
        """Discard [begin, end) (the source side after a completed move)."""
        end_k = TOP_KEY if end is None else end
        self.store.clear_range(begin, end_k)
        self.overlay.purge_range(begin, end_k)
        self.load_metrics.drop_range(begin, end_k)
        self._range_floor.assign(begin, end_k, 0)  # no longer served here

    def _floor_violation(self, begin: bytes, end: bytes, version: Version) -> bool:
        """True if any overlapping moved-in range has floor > version (its
        pre-snapshot history lives only on the old team)."""
        return any(
            v > version for _b, _e, v in self._range_floor.ranges(begin, end)
        )

    async def _durability(self) -> None:
        while True:
            await self.loop.delay(self.knobs.STORAGE_DURABILITY_LAG, TaskPriority.STORAGE_SERVER)
            target = self.version.get()
            window = self.knobs.mvcc_window_versions
            # never make durable past the cluster-wide committed watermark:
            # versions above it can be rolled back by recovery, and the base
            # store cannot un-flush (knownCommittedVersion bound)
            flush_to = min(target - window, self.known_committed)
            if flush_to > self.durable_version:
                try:
                    self.overlay.forget_before(
                        flush_to, self.store.set, self.store.clear_range
                    )
                    commit = getattr(self.store, "commit", None)
                    if commit is not None:
                        # disk engine: fsync the flushed batch (+ the durable
                        # version marker) BEFORE popping the TLog — the TLog is
                        # the only other copy of this data
                        await commit({"durable_version": flush_to})
                except IOError:
                    # the disk refused (ENOSPC / injected fault) or the
                    # process was io_timeout-killed mid-sync: nothing
                    # durable is claimed — the durable version holds, the
                    # TLog keeps its copy, and the queue grows until
                    # ratekeeper's free-space / queue-byte inputs squeeze
                    # admission.  The engines keep memory and WAL atomic
                    # per mutation (log-push-first), so a retry next tick
                    # resumes exactly where the fault struck.
                    self.c_io_errors.add(1)
                    testcov("storage.durability_io_error")
                    await self.loop.delay(0.25, TaskPriority.STORAGE_SERVER)
                    continue
                self.durable_version = flush_to  # flowlint: ok check-then-act-across-await (single-writer: the one _durability task owns durable_version; freeze/unfreeze never runs two)
                i = 0
                while i < len(self._qbytes) and self._qbytes[i][0] <= flush_to:
                    self.queue_bytes -= self._qbytes[i][1]
                    i += 1
                if i:
                    del self._qbytes[:i]
                if self.tlog_pop is not None:
                    self.tlog_pop.send(TLogPopRequest(self.tag, flush_to))

    # -- read path ----------------------------------------------------------
    async def _wait_version(self, version: Version) -> None:
        if version > self.version.get():
            # bounded wait: reads slightly ahead of applied data (future_version)
            from ..runtime.combinators import timeout_error

            try:
                await timeout_error(self.loop, self.version.when_at_least(version), 1.0)
            except TimedOut:
                raise FutureVersion(f"version {version} not yet at storage")
        if version < self.overlay.oldest:
            raise TransactionTooOld(f"version {version} < oldest {self.overlay.oldest}")

    async def _serve_getvalue(self) -> None:
        while True:
            req = await self.getvalue_stream.next()
            self.loop.spawn(self._getvalue_one(req), TaskPriority.STORAGE_SERVER)

    async def _getvalue_one(self, req) -> None:
        r: GetValueRequest = req.payload
        t0 = self.loop.now()
        g_trace_batch.add("StorageServer.getValue.Received", r.debug_id)
        await maybe_delay(self.loop, "storage.delay_read")
        try:
            await self._wait_version(r.version)
            if any(fs.covers(r.key) for fs in self._fetching):
                raise FutureVersion("key is still being fetched (shard move)")
            if self._floor_violation(r.key, r.key + b"\x00", r.version):
                raise TransactionTooOld(
                    f"version {r.version} below moved-shard floor"
                )
        except (TransactionTooOld, FutureVersion) as e:
            req.reply_error(e)
            return
        val = self.overlay.get(r.key, r.version, self.store.get)
        req.reply(GetValueReply(val))
        self.c_reads.add(1)
        self.load_metrics.on_read(
            r.key, len(r.key) + len(val or b""), self.loop.now()
        )
        self.read_latency.observe(self.loop.now() - t0)
        g_trace_batch.add("StorageServer.getValue.Replied", r.debug_id)

    # -- watches (storageserver watch futures) -------------------------------
    async def _serve_watch(self) -> None:
        while True:
            req = await self.watch_stream.next()
            r: WatchValueRequest = req.payload
            if any(fs.covers(r.key) for fs in self._fetching):
                # the key's data hasn't arrived yet (shard move): park the
                # watch unevaluated; _finalize_fetch re-evaluates it
                self._watches.setdefault(r.key, []).append((r.value, req))
                continue
            current = self.overlay.get(r.key, self.version.get(), self.store.get)
            if current != r.value:
                req.reply(self.version.get())  # already changed: fire now
            else:
                self._watches.setdefault(r.key, []).append((r.value, req))

    def _fire_watches(self, muts) -> None:
        touched: set[bytes] = set()
        for m in muts:
            if m.type == MutationType.CLEAR_RANGE:
                touched.update(
                    k for k in self._watches if m.key <= k < m.value
                )
            elif m.key in self._watches:
                touched.add(m.key)
        now_v = self.version.get()
        for k in touched:
            waiters = self._watches.pop(k, [])
            still = []
            for expected, req in waiters:
                current = self.overlay.get(k, now_v, self.store.get)
                if current != expected:
                    req.reply(now_v)
                else:  # e.g. set to the same value: keep waiting
                    still.append((expected, req))
            if still:
                self._watches[k] = still

    async def _serve_getkv(self) -> None:
        while True:
            req = await self.getkv_stream.next()
            self.loop.spawn(self._getkv_one(req), TaskPriority.STORAGE_SERVER)

    async def _getkv_one(self, req) -> None:
        r: GetKeyValuesRequest = req.payload
        t0 = self.loop.now()
        try:
            await self._wait_version(r.version)
            if any(
                fs.begin < r.end and r.begin < fs.end_key for fs in self._fetching
            ):
                raise FutureVersion("range is still being fetched (shard move)")
            if self._floor_violation(r.begin, r.end, r.version):
                raise TransactionTooOld(
                    f"version {r.version} below moved-shard floor"
                )
        except (TransactionTooOld, FutureVersion) as e:
            req.reply_error(e)
            return
        base = {k: v for k, v in self.store.range_read(r.begin, r.end, r.limit + 1000)}
        keys = set(base) | set(self.overlay.overlay_keys_in(r.begin, r.end))
        out = []
        for k in sorted(keys):
            val = self.overlay.get(k, r.version, self.store.get)
            if val is not None:
                out.append((k, val))
            if len(out) > r.limit:
                break
        more = len(out) > r.limit
        req.reply(GetKeyValuesReply(out[: r.limit], more))
        self.c_reads.add(1)
        now = self.loop.now()
        for k, v in out[: r.limit]:
            self.load_metrics.on_read(k, len(k) + len(v), now)
        self.read_latency.observe(self.loop.now() - t0)

    # -- key selectors (storageserver.actor.cpp findKey / getKeyQ) -----------
    def _live_keys(self, version: Version, begin: bytes, end: bytes,
                   limit: int, reverse: bool = False) -> list[bytes]:
        """Up to `limit` keys LIVE at `version` in [begin, end), walking
        forward (ascending) or backward (descending, for negative-offset
        selectors).  Same base+overlay merge as _getkv_one.  The forward
        walk scans base chunks and RE-FETCHES past a truncated chunk — a
        window where more than a chunk's worth of base keys are dead at
        this version (a large uncompacted clear) must not resolve against
        a partial candidate set.  The backward walk materializes the
        clip's candidate keys (no reverse cursor on the engines — the
        clip is one shard, simulation-scale)."""
        from ..keys import key_after

        if begin >= end:
            return []
        if reverse:
            base = self.store.range_read(begin, end, 1 << 30)
            keys = set(k for k, _v in base)
            keys.update(self.overlay.overlay_keys_in(begin, end))
            out: list[bytes] = []
            for k in sorted(keys, reverse=True):
                if self.overlay.get(k, version, self.store.get) is not None:
                    out.append(k)
                    if len(out) >= limit:
                        break
            return out
        out = []
        cursor = begin
        chunk = limit + 1000
        while cursor < end and len(out) < limit:
            base = self.store.range_read(cursor, end, chunk)
            truncated = len(base) >= chunk
            # knowledge is complete over [cursor, scan_end) only: overlay
            # keys past a truncated base chunk wait for the next pass
            scan_end = key_after(base[-1][0]) if truncated else end
            keys = set(k for k, _v in base)
            keys.update(self.overlay.overlay_keys_in(cursor, scan_end))
            for k in sorted(keys):
                if self.overlay.get(k, version, self.store.get) is not None:
                    out.append(k)
                    if len(out) >= limit:
                        break
            cursor = scan_end
        return out

    def find_key(self, sel: KeySelector, version: Version,
                 range_begin: bytes, range_end: bytes) -> KeySelector:
        """One shard's findKey step (storageserver.actor.cpp findKey): walk
        `sel.offset` live keys from the anchor WITHIN [range_begin,
        range_end).  Resolved result is (key, True, 0); a walk reaching the
        shard edge returns a selector anchored at the boundary carrying the
        REMAINING offset, which the client re-issues against the adjacent
        shard — offsets step across shard boundaries without any server
        knowing the whole keyspace."""
        forward = sel.offset > 0
        # a key EQUAL to the anchor is skipped when the anchor side already
        # counted it: orEqual==forward (the reference's skipEqualKey)
        skip_equal = sel.or_equal == forward
        distance = sel.offset if forward else 1 - sel.offset
        need = distance + (1 if skip_equal else 0)
        if forward:
            rows = self._live_keys(
                version, max(sel.key, range_begin), range_end, need
            )
        else:
            from ..keys import key_after

            rows = self._live_keys(
                version, range_begin, min(key_after(sel.key), range_end),
                need, reverse=True,
            )
        index = distance - 1
        if skip_equal and rows and rows[0] == sel.key:
            index += 1
        if index < len(rows):
            return KeySelector(rows[index], True, 0)  # resolved
        remaining = index - len(rows) + 1  # >= 1: keys still to step over
        if forward:
            # continue right: (range_end, False, remaining) — base position
            # "last key < range_end" was the last key this shard counted
            return KeySelector(range_end, False, remaining)
        return KeySelector(range_begin, False, 1 - remaining)

    async def _serve_getkey(self) -> None:
        while True:
            req = await self.getkey_stream.next()
            self.loop.spawn(self._getkey_one(req), TaskPriority.STORAGE_SERVER)

    async def _getkey_one(self, req) -> None:
        r: GetKeyRequest = req.payload
        t0 = self.loop.now()
        g_trace_batch.add("StorageServer.getKey.Received", r.debug_id)
        await maybe_delay(self.loop, "storage.delay_getkey")
        # the walk may touch any key in the routed clip: guard the WHOLE
        # clip against in-flight shard moves and moved-in floors, like a
        # range read over it would be
        try:
            await self._wait_version(r.version)
            if any(
                fs.begin < r.range_end and r.range_begin < fs.end_key
                for fs in self._fetching
            ):
                raise FutureVersion("range is still being fetched (shard move)")
            if self._floor_violation(r.range_begin, r.range_end, r.version):
                raise TransactionTooOld(
                    f"version {r.version} below moved-shard floor"
                )
        except (TransactionTooOld, FutureVersion) as e:
            req.reply_error(e)
            return
        req.reply(GetKeyReply(
            self.find_key(r.sel, r.version, r.range_begin, r.range_end)
        ))
        self.c_reads.add(1)
        self.load_metrics.on_read(r.sel.key, len(r.sel.key), self.loop.now())
        self.c_selector_reads.add(1)
        self.read_latency.observe(self.loop.now() - t0)
        g_trace_batch.add("StorageServer.getKey.Replied", r.debug_id)

    def set_tlog_source(
        self,
        peek_ref: RequestStreamRef,
        pop_ref: RequestStreamRef,
        recovery_version: Version | None = None,
    ) -> None:
        """Re-point at a new TLog generation (recovery: storage servers
        rejoin the new log system by tag — SURVEY §5).  The pull loop reads
        these refs each iteration, so the switch takes effect immediately.

        When a recovery version is given, roll back any applied state above
        it: a dead TLog replica may have served versions that were never
        acked on every replica, and those are UNKNOWN-result — they must
        evaporate with the old generation."""
        self.tlog = peek_ref
        self.tlog_pop = pop_ref
        self._pull_epoch += 1  # in-flight peek replies are now stale
        if recovery_version is not None:
            # everything <= recovery_version is committed cluster-wide
            self.known_committed = max(self.known_committed, recovery_version)
        if recovery_version is not None:
            # fetch state above the recovery version is phantom: buffered
            # mutations evaporate with it, and a snapshot taken at a rolled-
            # back version must be refetched
            for fs in self._fetching:
                fs.buffer = [e for e in fs.buffer if e[0] <= recovery_version]
                fs.epoch += 1
        if recovery_version is not None and self.version.get() > recovery_version:
            # unreachable unless the knownCommittedVersion bound was violated
            assert self.durable_version <= recovery_version, (
                "storage made phantom versions durable: "
                f"{self.durable_version} > {recovery_version}"
            )
            self.overlay.rollback_to(recovery_version)
            self.version.rollback(recovery_version)
            self._fetched = recovery_version
            # rolled-back versions leave the queue ledger too
            while self._qbytes and self._qbytes[-1][0] > recovery_version:
                self.queue_bytes -= self._qbytes.pop()[1]

    def start_metrics(self, trace, interval: float):
        """Periodic StorageMetrics emission (the reference's StorageMetrics
        event): versions, key volume, and read/apply rates."""
        if self._metrics_emitter is not None:
            self._metrics_emitter.cancel()

        def fields() -> dict:
            now = self.loop.now()
            r = self.counters.rates(now)
            lm = self.load_metrics
            out = {
                "Tag": self.tag,
                "Version": self.version.get(),
                "DurableVersion": self.durable_version,
                "KnownCommitted": self.known_committed,
                "Keys": self.store.key_count(),
                "QueueBytes": self.queue_bytes,
                "ReadsPerSec": r.get("reads", 0.0),
                "MutationsPerSec": r.get("mutations_applied", 0.0),
                "ReadP99Ms": self.read_latency.snapshot()["p99"] * 1e3,
                # load-metric plane gauges (byte/bandwidth samples)
                "SampledBytes": lm.byte_sample.total,
                "SampledKeys": len(lm.byte_sample),
                "BytesReadPerKSec":
                    lm.read_bw.rate_range(b"", TOP_KEY, now) * 1e3,
                "BytesWrittenPerKSec":
                    lm.write_bw.rate_range(b"", TOP_KEY, now) * 1e3,
            }
            pcs = getattr(self.store, "page_cache_stats", None)
            if pcs is not None:
                # durable engines: cumulative page-cache counters
                # (storage/pagecache.py) in the periodic event stream
                s = pcs()
                out["PageCacheHits"] = s["hits"]
                out["PageCacheMisses"] = s["misses"]
                out["PageCacheReadaheadHits"] = s["readahead_hits"]
                out["PageCacheParsedHits"] = s["parsed_hits"]
            return out

        self._metrics_emitter = spawn_role_metrics(
            self.loop, self.process, trace, "StorageMetrics", fields,
            interval, TaskPriority.STORAGE_SERVER, instance=self.tag,
        )
        return self._metrics_emitter

    def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        if self._metrics_emitter is not None:
            self._metrics_emitter.cancel()
        self.getvalue_stream.close()
        self.getkv_stream.close()
        self.getkey_stream.close()
        self.watch_stream.close()
