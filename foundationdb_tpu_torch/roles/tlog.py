"""Transaction log — the durability point (fdbserver/TLogServer.actor.cpp).

Receives ordered mutation batches tagged per storage server (tLogCommit
:1169), holds version-indexed per-tag queues (LogData :284), serves
tLogPeekMessages (:932) to storage servers and trims with tLogPop (:880).

Two durability modes:
  * memory (disk_queue=None): commits ack after a simulated sync delay —
    data dies with the process.  For tests/benches.
  * durable (disk_queue set): every commit is framed into the DiskQueue and
    fsynced BEFORE publication and ack (tLogCommit's fsync at :1169); the
    full tag state is re-framed as a RESET record at generation start and
    on compaction, so a whole-cluster power loss recovers everything acked
    from the synced log prefix (storage/diskqueue.py recover()).

Version ordering is enforced with NotifiedVersion exactly like the
resolver: a batch whose prev_version hasn't been logged yet waits its turn.

Copy of the reference package's role, on the port's runtime and rpc: the
same pushes and peeks give the same replies at the same virtual times.
"""

from __future__ import annotations

import bisect

from .sequencer import NotifiedVersion
from .types import (
    TLogCommitRequest,
    TLogConfirmReply,
    TLogLockReply,
    TLogLockRequest,
    TLogPeekReply,
    TLogPeekRequest,
    TLogPopRequest,
    Version,
    _dec_tag_map,
    _dec_tagged_entries,
    _enc_tag_map,
    _enc_tagged_entries,
)
from ..rpc.network import SimProcess
from ..rpc.stream import RequestStream
from ..runtime.buggify import buggify, maybe_delay
from ..runtime.core import EventLoop, TaskPriority
from ..runtime.coverage import testcov
from ..runtime.trace import (
    SEV_WARN,
    CounterCollection,
    g_trace_batch,
    spawn_role_metrics,
)
from ..runtime.serialize import (
    BinaryReader,
    BinaryWriter,
    decode_version_mutations,
    encode_version_mutations,
    read_mutation,
)

# durable-log record types.  _R_RESET is the LEGACY (pre-wire-overhaul)
# per-mutation BinaryWriter framing, still decoded so a disk queue written
# by an older build recovers cleanly; new RESETs write _R_RESET2.
_R_RESET, _R_COMMIT, _R_POP, _R_RESET2 = 0, 1, 2, 3


def _encode_reset(start_version: Version, known_committed: Version,
                  tags: dict[str, list]) -> bytes:
    """Generation-start snapshot record (_R_RESET2).  The per-tag entry
    framing is the SAME struct-of-arrays codec the wire's TLogLockReply /
    TLogPeekReply use (roles/types.py `_enc_tag_map`): one length array +
    one joined blob per mutation list, so re-framing a large handed-over
    state at recovery costs list appends, not a BinaryWriter call per
    mutation — and the disk and wire formats for tag state cannot drift."""
    w = BinaryWriter().u8(_R_RESET2).i64(start_version).i64(known_committed)
    parts: list[bytes] = [w.data()]
    _enc_tag_map(tags, parts, _enc_tagged_entries)
    return b"".join(parts)


def _decode_reset2(r: BinaryReader):
    start, kc = r.i64(), r.i64()
    buf = r.rest()
    tags, _pos = _dec_tag_map(buf, 0, _dec_tagged_entries)
    return start, kc, tags


def _decode_reset_legacy(r: BinaryReader):
    """The pre-overhaul _R_RESET layout (BinaryWriter per-mutation framing):
    kept so logs written by an older build still recover."""
    start, kc = r.i64(), r.i64()
    tags: dict[str, list] = {}
    for _ in range(r.u32()):
        tag = r.str_()
        entries = []
        for _ in range(r.u32()):
            v = r.i64()
            entries.append((v, [read_mutation(r) for _ in range(r.u32())]))
        tags[tag] = entries
    return start, kc, tags


class TLog:
    WLT_COMMIT = "wlt:tlog_commit"
    WLT_PEEK = "wlt:tlog_peek"
    WLT_POP = "wlt:tlog_pop"
    WLT_LOCK = "wlt:tlog_lock"
    WLT_CONFIRM = "wlt:tlog_confirm"

    def __init__(self, process: SimProcess, loop: EventLoop,
                 start_version: Version = 0, sync_delay: float = 0.0005,
                 initial_tags: dict | None = None,
                 known_committed: Version = 0,
                 disk_queue=None,
                 spill_bytes: int = 1 << 22,
                 hard_limit_bytes: int = 0,
                 trace=None) -> None:
        self.loop = loop
        self.process = process
        self.sync_delay = sync_delay
        # queue hard limit (TLOG_HARD_LIMIT_BYTES; 0 = unbounded): past it
        # commits are REFUSED with a traced SEV_WARN — never silently
        # acked, never allowed to grow the queue without bound.  The
        # refusal is loud by contract: ratekeeper's e-brake exists to stop
        # admission before this line, so crossing it is an operator event.
        self.hard_limit_bytes = hard_limit_bytes
        self.trace = trace
        self.commits_refused = 0
        self.version = NotifiedVersion(start_version)
        # this epoch's floor: versions at or below it predate this TLog and
        # were NEVER stored here — the duplicate-ack path must refuse them
        # (a deposed proxy's stale push must time out, not get a phantom
        # ack from a successor role that happens to share its process)
        self._epoch_start = start_version
        # highest version known committed cluster-wide (acked by EVERY TLog
        # replica) — storage durability must never pass it
        self.known_committed = known_committed
        self.locked = False
        # per-tag: sorted list of (version, [Mutation]); popped prefix removed
        self._tags: dict[str, list[tuple[Version, list]]] = dict(initial_tags or {})
        self.dq = disk_queue  # storage.diskqueue.DiskQueue or None (memory)
        # -- spill (TLogServer spilled-data path, TLogServer.actor.cpp
        # LogData::persistentData): when in-memory bytes exceed spill_bytes,
        # a lagging tag's OLDEST entries drop their payloads and keep only
        # (version, diskqueue offset, nbytes) — peeks re-read them from the
        # durable log on demand, so a slow storage server bounds TLog RAM,
        # not cluster data volume.  offset -1 = unspillable (the entry's
        # payload lives only inside a RESET blob: seeds, recovery, rewrite).
        self.spill_bytes = spill_bytes

        def _nbytes(muts) -> int:
            return sum(len(m.key) + len(m.value or b"") for m in muts)

        # seeds carry real byte counts so the pop-side accounting (which
        # subtracts the aligned _mem_offs entries) stays exact
        self._mem_offs: dict[str, list[tuple[Version, int, int]]] = {
            tag: [(v, -1, _nbytes(m)) for v, m in entries]
            for tag, entries in self._tags.items()
        }
        self._spilled: dict[str, list[tuple[Version, int, int]]] = {}
        # commits between push and sync-return: the pop-side compaction
        # must never truncate while one is in flight — the truncate drops
        # the buffered record, yet that commit's sync() would still return
        # success and ACK data the disk no longer holds (a rewrite-vs-
        # group-commit race found while building the disk fault plane)
        self._commits_syncing = 0
        seed_bytes = sum(
            n for offs in self._mem_offs.values() for _v, _o, n in offs
        )
        self._live_bytes = seed_bytes
        self._mem_bytes = seed_bytes
        self.spill_events = 0
        if self.dq is not None:
            # frame the starting state; durable after initial_durable()/first
            # commit sync.  Callers must not delete the data's previous home
            # until then (controller awaits initial_durable before
            # WRITING_CSTATE).  A transient injected disk error on this ONE
            # push must not fail the whole recruitment — retry; a disk that
            # persistently refuses does fail it (the controller recruits
            # elsewhere / retries the recovery).
            reset = _encode_reset(start_version, known_committed, self._tags)
            for attempt in range(3):
                try:
                    self.dq.push(reset)
                    break
                except IOError:
                    if attempt == 2:
                        raise
        self._poppable: dict[str, Version] = {}
        self.counters = CounterCollection("TLog")
        self.c_commits = self.counters.counter("commits")
        self.c_bytes = self.counters.counter("commit_bytes")
        self._metrics_emitter = None
        self.commit_stream = RequestStream(process, self.WLT_COMMIT, unique=True)
        self.peek_stream = RequestStream(process, self.WLT_PEEK, unique=True)
        self.pop_stream = RequestStream(process, self.WLT_POP, unique=True)
        self.lock_stream = RequestStream(process, self.WLT_LOCK, unique=True)
        self.confirm_stream = RequestStream(process, self.WLT_CONFIRM, unique=True)
        self._tasks = [
            loop.spawn(self._serve_commit(), TaskPriority.TLOG_COMMIT, "tlog-commit"),
            loop.spawn(self._serve_peek(), TaskPriority.TLOG_COMMIT, "tlog-peek"),
            loop.spawn(self._serve_pop(), TaskPriority.TLOG_COMMIT, "tlog-pop"),
            loop.spawn(self._serve_lock(), TaskPriority.TLOG_COMMIT, "tlog-lock"),
            loop.spawn(self._serve_confirm(), TaskPriority.TLOG_COMMIT, "tlog-confirm"),
        ]

    # -- commit ------------------------------------------------------------
    async def _serve_commit(self) -> None:
        while True:
            req = await self.commit_stream.next()
            self.loop.spawn(self._commit_one(req), TaskPriority.TLOG_COMMIT)

    async def _commit_one(self, req) -> None:
        r: TLogCommitRequest = req.payload
        if buggify("tlog.drop_push"):
            return  # lost push: the proxy's idempotent retry re-sends it
        # wire-propagated trace context: the reference's tLogCommit stations
        spans = req.spans or ()
        for d in spans:
            g_trace_batch.add("TLog.tLogCommit.BeforeWaitForVersion", d)
        await maybe_delay(self.loop, "tlog.delay_commit")
        if self.locked:
            return  # locked by recovery: never ack, the old generation ends
        await self.version.when_at_least(r.prev_version)
        if self.locked:
            return
        if self.version.get() >= r.version:
            if r.version <= self._epoch_start:
                return  # predates this epoch: not ours, never ack
            # duplicate push (proxy retry): already logged, ack again
            req.reply(r.version)
            return
        if self.hard_limit_bytes and self._live_bytes >= self.hard_limit_bytes:
            # queue hard limit: refuse LOUDLY, never ack.  The proxy's push
            # times out and escalates through the ordinary commit-path
            # machinery (retry → UNKNOWN → recovery); what must never
            # happen is an ack for data the queue cannot responsibly hold.
            self.commits_refused += 1
            testcov("tlog.hard_limit_refused")
            if self.trace is not None:
                self.trace.trace(
                    "TLogCommitRefused", severity=SEV_WARN,
                    track_latest=f"tlog-hard-limit-{self.process.name}",
                    Process=self.process.name, Version=r.version,
                    BytesQueued=self._live_bytes,
                    HardLimit=self.hard_limit_bytes,
                )
            return
        # Sync BEFORE publishing: peek/lock must never serve data that was
        # not acked durable, or storage applies versions above the eventual
        # recovery version (phantom mutations of UNKNOWN-result txns).
        rec_off = -1
        if self.dq is not None:
            w = BinaryWriter().u8(_R_COMMIT).i64(r.known_committed)
            try:
                self._commits_syncing += 1
                try:
                    rec_off = self.dq.push(
                        w.data()
                        + encode_version_mutations(r.version, r.mutations_by_tag)
                    )
                    await self.dq.sync()  # the fsync (group-commits buffered peers)
                finally:
                    self._commits_syncing -= 1
            except IOError as e:
                # the disk refused (ENOSPC / injected error) or the process
                # was io_timeout-killed mid-sync: the data is NOT durable,
                # so never ack — refuse loudly and let the proxy's retry /
                # recovery machinery handle it.  A silent ack here is the
                # acked-data-loss hole the negative durability tests pin.
                self.commits_refused += 1
                testcov("tlog.disk_error_refused")
                if self.trace is not None and self.process.alive:
                    self.trace.trace(
                        "TLogDiskError", severity=SEV_WARN,
                        track_latest=f"tlog-disk-error-{self.process.name}",
                        Process=self.process.name, Version=r.version,
                        Error=repr(e),
                    )
                return
        elif self.sync_delay:
            await self.loop.delay(self.sync_delay, TaskPriority.TLOG_COMMIT)
        if self.locked:
            return  # locked mid-sync: unacked data is lost with the epoch
        if self.version.get() >= r.version:
            if r.version <= self._epoch_start:
                return  # predates this epoch: not ours, never ack
            req.reply(r.version)  # raced with a duplicate during the sync
            return
        commit_bytes = 0
        for tag, muts in r.mutations_by_tag.items():
            self._tags.setdefault(tag, []).append((r.version, muts))
            nb = sum(len(m.key) + len(m.value or b"") for m in muts)
            self._mem_offs.setdefault(tag, []).append((r.version, rec_off, nb))
            self._live_bytes += nb
            self._mem_bytes += nb
            commit_bytes += nb
        self.c_commits.add(1)
        self.c_bytes.add(commit_bytes)
        self.version.set(r.version)
        self.known_committed = max(self.known_committed, r.known_committed)
        if self.dq is not None and self._mem_bytes > self.spill_bytes:
            self._spill()
        for d in spans:
            g_trace_batch.add("TLog.tLogCommit.AfterTLogCommit", d)
        req.reply(r.version)

    def _spill(self) -> None:
        """Evict the heaviest tag's oldest spillable payloads until memory
        is back under the limit (or nothing spillable remains)."""
        while self._mem_bytes > self.spill_bytes:
            best, best_bytes = None, 0
            for tag, offs in self._mem_offs.items():
                b = sum(n for _v, o, n in offs if o >= 0)
                if b > best_bytes:
                    best, best_bytes = tag, b
            if best is None or best_bytes == 0:
                return
            q, offs = self._tags[best], self._mem_offs[best]
            # spill the older half of the spillable suffix
            first = next(i for i, (_v, o, _n) in enumerate(offs) if o >= 0)
            take = max((len(offs) - first + 1) // 2, 1)
            spill = offs[first : first + take]
            self._spilled.setdefault(best, []).extend(spill)
            del q[first : first + take]
            del offs[first : first + take]
            self._mem_bytes -= sum(n for _v, _o, n in spill)
            self.spill_events += 1
            testcov("tlog.spilled")

    def _read_spilled(self, tag: str, entries) -> list[tuple[Version, list]]:
        out = []
        for v, off, _n in entries:
            payload = self.dq.read_at(off)
            # record layout: u8 type + i64 known_committed + version/mutations
            assert payload[0] == _R_COMMIT
            version, by_tag = decode_version_mutations(payload[9:])
            assert version == v
            out.append((v, by_tag.get(tag, [])))
        return out

    # -- peek --------------------------------------------------------------
    async def _serve_peek(self) -> None:
        while True:
            req = await self.peek_stream.next()
            r: TLogPeekRequest = req.payload
            q = self._tags.get(r.tag, [])
            i = bisect.bisect_left(q, r.begin_version, key=lambda e: e[0])
            # rare short reads exercise the storage re-peek path
            lim = 1 if buggify("tlog.peek_truncate") else 1000
            sp = self._spilled.get(r.tag, [])
            if not sp:
                entries = q[i : i + lim]
                truncated = i + lim < len(q)
            else:
                # merge in-memory and spilled entries by version (seeds may
                # predate the spilled range, so neither list dominates)
                si = bisect.bisect_left(sp, r.begin_version, key=lambda e: e[0])
                mem_take: list = []
                sp_take: list = []
                order: list = []
                qi = i
                while len(order) < lim and (si < len(sp) or qi < len(q)):
                    if si < len(sp) and (qi >= len(q) or sp[si][0] < q[qi][0]):
                        order.append((True, len(sp_take)))
                        sp_take.append(sp[si])
                        si += 1
                    else:
                        order.append((False, len(mem_take)))
                        mem_take.append(q[qi])
                        qi += 1
                decoded = self._read_spilled(r.tag, sp_take)
                entries = [
                    decoded[idx] if is_sp else mem_take[idx]
                    for is_sp, idx in order
                ]
                truncated = si < len(sp) or qi < len(q)
            # on truncation, end_version must not skip unfetched entries
            end = entries[-1][0] + 1 if truncated else self.version.get() + 1
            req.reply(
                TLogPeekReply(
                    entries=entries,
                    end_version=end,
                    known_committed=self.known_committed,
                )
            )

    # -- pop ---------------------------------------------------------------
    async def _serve_pop(self) -> None:
        while True:
            req = await self.pop_stream.next()
            if buggify("tlog.drop_pop"):
                continue  # pops are advisory; storage re-pops as it advances
            r: TLogPopRequest = req.payload
            self._poppable[r.tag] = max(self._poppable.get(r.tag, 0), r.upto_version)
            q = self._tags.get(r.tag, [])
            i = bisect.bisect_right(q, r.upto_version, key=lambda e: e[0])
            if i:
                offs = self._mem_offs.get(r.tag, [])
                freed = sum(n for _v, _o, n in offs[:i])
                self._live_bytes -= freed
                self._mem_bytes -= freed
                self._tags[r.tag] = q[i:]
                self._mem_offs[r.tag] = offs[i:]
            sp = self._spilled.get(r.tag)
            if sp:
                j = bisect.bisect_right(sp, r.upto_version, key=lambda e: e[0])
                if j:
                    self._live_bytes -= sum(n for _v, _o, n in sp[:j])
                    self._spilled[r.tag] = sp[j:]
            if self.dq is not None:
                try:
                    # lazily durable: a lost POP record only means re-serving
                    # already-durable data after a crash (storage dedups by
                    # version), so no sync here
                    self.dq.push(
                        BinaryWriter().u8(_R_POP).str_(r.tag).i64(r.upto_version).data()
                    )
                    if (
                        self.dq.bytes_pushed > 4 * max(self._live_bytes, 1) + (1 << 20)
                        and not any(self._spilled.values())
                        and self._commits_syncing == 0
                    ):
                        # a rewrite invalidates every recorded record offset, so
                        # it only runs with nothing spilled, and the surviving
                        # in-memory entries become unspillable (their payloads
                        # now live only inside the fresh RESET blob)
                        self.dq.rewrite(
                            [
                                _encode_reset(
                                    self.version.get(), self.known_committed, self._tags
                                )
                            ]
                        )
                        self._mem_offs = {
                            tag: [(v, -1, n) for v, _o, n in offs]
                            for tag, offs in self._mem_offs.items()
                        }
                except IOError:
                    # the disk refused the pop record / the compaction
                    # (fault plane): pops are advisory and the rewrite
                    # un-journaled itself — a reboot merely re-serves
                    # already-popped durable data, which storage dedups.
                    # What must NOT happen is the serve loop dying: a TLog
                    # that silently stops serving pops never trims again.
                    testcov("tlog.pop_io_error")
            req.reply(None)

    # -- lock (recovery) ----------------------------------------------------
    async def _serve_lock(self) -> None:
        while True:
            req = await self.lock_stream.next()
            assert isinstance(req.payload, TLogLockRequest)
            self.locked = True
            tags = {tag: list(q) for tag, q in self._tags.items()}
            # recovery must see spilled entries too: re-read and merge them
            # in version order (a transient memory spike, once, at lock)
            for tag, sp in self._spilled.items():
                if sp:
                    merged = self._read_spilled(tag, sp) + tags.get(tag, [])
                    merged.sort(key=lambda e: e[0])
                    tags[tag] = merged
            req.reply(
                TLogLockReply(end_version=self.version.get(), tags=tags)
            )

    # -- confirm (GRV liveness) ---------------------------------------------
    async def _serve_confirm(self) -> None:
        """Epoch-liveness probe for proxy GRVs (confirmEpochLive): replies
        the lock state; locked means this generation has ended."""
        while True:
            req = await self.confirm_stream.next()
            req.reply(TLogConfirmReply(locked=self.locked))

    async def initial_durable(self) -> None:
        """Await durability of the construction-time RESET record.  A new
        generation's seeds (the surviving data of the previous epoch) must
        hit this TLog's disk before the old epoch's files/processes may be
        discarded (controller awaits this before WRITING_CSTATE).  Retries
        transient injected disk errors — failing recovery over one 5%-coin
        fault would make every chaos seed a boot lottery."""
        if self.dq is not None:
            for attempt in range(3):
                try:
                    await self.dq.sync()
                    return
                except IOError:
                    if attempt == 2 or not self.process.alive:
                        raise
                    await self.loop.delay(0.02, TaskPriority.TLOG_COMMIT)

    @staticmethod
    def recover_state(dq) -> tuple[Version, Version, dict[str, list]]:
        """Replay a durable TLog log -> (end_version, known_committed, tags).

        Applies RESET/COMMIT/POP records in order over the synced prefix;
        duplicate COMMITs for a version (proxy-retry races) apply once."""
        end, kc = 0, 0
        tags: dict[str, list] = {}
        for rec in dq.recover():
            r = BinaryReader(rec)
            t = r.u8()
            if t == _R_RESET2:
                end, kc, tags = _decode_reset2(r)
            elif t == _R_RESET:
                end, kc, tags = _decode_reset_legacy(r)
            elif t == _R_COMMIT:
                rec_kc = r.i64()
                version, by_tag = decode_version_mutations(r.rest())
                if version <= end:
                    continue  # duplicate push framed twice
                for tag, muts in by_tag.items():
                    tags.setdefault(tag, []).append((version, muts))
                end = version
                kc = max(kc, rec_kc)
            elif t == _R_POP:
                tag, upto = r.str_(), r.i64()
                q = tags.get(tag, [])
                i = bisect.bisect_right(q, upto, key=lambda e: e[0])
                if i:
                    tags[tag] = q[i:]
        return end, kc, tags

    @property
    def bytes_queued(self) -> int:
        return sum(
            len(m.key) + len(m.value)
            for q in self._tags.values()
            for _v, muts in q
            for m in muts
        ) + sum(n for sp in self._spilled.values() for _v, _o, n in sp)

    def start_metrics(self, trace, interval: float):
        """Periodic TLogMetrics emission (rate-converted counters + queue
        depth — the reference's TLogMetrics event)."""
        if self._metrics_emitter is not None:
            self._metrics_emitter.cancel()

        def fields() -> dict:
            r = self.counters.rates(self.loop.now())
            return {
                "Version": self.version.get(),
                "KnownCommitted": self.known_committed,
                "BytesQueued": self._live_bytes,
                "SpillEvents": self.spill_events,
                "Locked": self.locked,
                "CommitsPerSec": r.get("commits", 0.0),
                "BytesPerSec": r.get("commit_bytes", 0.0),
            }

        self._metrics_emitter = spawn_role_metrics(
            self.loop, self.process, trace, "TLogMetrics", fields, interval,
            TaskPriority.TLOG_COMMIT,
        )
        return self._metrics_emitter

    def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        if self._metrics_emitter is not None:
            self._metrics_emitter.cancel()
        for s in (self.commit_stream, self.peek_stream, self.pop_stream,
                  self.confirm_stream):
            s.close()
