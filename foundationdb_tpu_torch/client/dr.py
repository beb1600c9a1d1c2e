"""Cluster-to-cluster DR — the DatabaseBackupAgent analog
(fdbclient/DatabaseBackupAgent.actor.cpp; the `fdbdr` tool surface).

A DR relationship streams the PRIMARY cluster's full mutation log into a
live SECONDARY cluster with versioned, transactional apply:

  * the primary tags every commit with a dedicated DR tag (the same
    full-stream consumer machinery backup workers and log routers use —
    the consumer survives primary recoveries by rejoining its tag),
  * an initial chunked snapshot copies the existing keyspace (each chunk
    at its own read version; the log is clipped per chunk exactly like
    restore, client/backup.py),
  * the DRWorker applies log frames to the secondary in lock-aware
    batched transactions, recording `\\xff/dr/applied_version` IN the
    same transaction — resume after any crash is exact,
  * the secondary stays LOCKED while DR runs (reference semantics: the
    destination accepts only the DR stream), so a stray application
    write cannot fork it,
  * `failover()` locks the primary, drains the stream to the primary's
    final commit, detaches, and unlocks the secondary — which now serves
    the exact keyspace.

Both clusters must share one EventLoop (RecoverableCluster(loop=...)):
the worker awaits interleave primary peeks with secondary commits.

Copy of the reference package's module, on the port's own modules, with
one fix: the DRWorker applies no version above the TLogs' known_committed
watermark (the reference's applies a rolled-back phantom of a primary
recovery to the secondary)."""

from __future__ import annotations

import bisect

from ..keys import key_after
from ..roles.types import Mutation, MutationType, TLogPeekRequest, TLogPopRequest
from ..runtime.core import BrokenPromise, TaskPriority, TimedOut
from ..runtime.coverage import testcov
from . import management as mgmt

DR_TAG = "dr-0"
APPLIED_KEY = b"\xff/dr/applied_version"
DR_LOCK_UID = b"dr-destination-lock"


class DRWorker:
    """Pulls the DR tag from the primary's TLogs and applies each version
    frame to the secondary transactionally (the destination-side applier,
    DatabaseBackupAgent's mutation-log apply tasks)."""

    def __init__(self, process, loop, dest_db, start_version: int) -> None:
        self.process = process
        self.loop = loop
        self.db = dest_db
        self.tag = DR_TAG
        self.tlog = None
        self.tlog_pops: list = []
        # paused until the initial snapshot lands AND the clip is set: an
        # apply racing ahead of a chunk write would be clobbered by the
        # chunk's older data (the TLog retains the tag while paused — no
        # pops — so nothing is lost, only deferred)
        self._paused = True
        self._fetched = start_version
        from ..roles.sequencer import NotifiedVersion

        self.applied = NotifiedVersion(start_version)
        # chunk-version step function (set after the snapshot): log
        # mutations apply only where version > the covering chunk's version
        self._bounds: list[bytes] = []
        self._cvers: list[int] = []
        self._task = loop.spawn(self._pull(), TaskPriority.STORAGE_SERVER, "dr-pull")

    def set_tlog_source(self, peek_ref, pop_refs: list) -> None:
        """Controller hook: rewired at every primary recovery (the DR tag
        rejoins the new generation like any stream consumer)."""
        self.tlog = peek_ref
        self.tlog_pops = pop_refs

    def set_snapshot_clip(self, bounds: list[bytes], cvers: list[int]) -> None:
        """Install the chunk-version step function and START applying —
        only ever called after the last chunk write is committed on the
        secondary, so no apply can race a chunk."""
        self._bounds = bounds
        self._cvers = cvers
        self._paused = False

    def _chunk_version_at(self, key: bytes) -> int:
        i = bisect.bisect_right(self._bounds, key) - 1
        return self._cvers[i] if i >= 0 else 0

    def _clip(self, version: int, muts: list[Mutation]) -> list[Mutation]:
        out: list[Mutation] = []
        for m in muts:
            if m.type == MutationType.CLEAR_RANGE:
                ce = min(m.value, b"\xff")
                if m.key >= ce:
                    continue
                pts = [m.key] + [b for b in self._bounds if m.key < b < ce] + [ce]
                for lo, hi in zip(pts, pts[1:]):
                    if version > self._chunk_version_at(lo):
                        out.append(Mutation(MutationType.CLEAR_RANGE, lo, hi))
            elif m.key >= b"\xff":
                continue  # the primary's system keyspace is not replicated
            elif version > self._chunk_version_at(m.key):
                out.append(m)
        return out

    async def _apply(self, version: int, muts: list[Mutation]) -> None:
        """One transactional apply: mutations + the applied-version fence.
        Reading APPLIED_KEY inside the txn makes crash-resume exact — a
        frame observed already-applied is skipped, never double-applied."""

        async def fn(tr) -> None:
            tr.set_option(b"lock_aware")
            cur = await tr.get(APPLIED_KEY)
            if cur is not None and int(cur.decode()) >= version:
                return  # duplicate after a retry: already applied
            for m in muts:
                if m.type == MutationType.SET_VALUE:
                    tr.set(m.key, m.value)
                elif m.type == MutationType.CLEAR_RANGE:
                    tr.clear_range(m.key, m.value)
                else:
                    tr.atomic_op(m.type, m.key, m.value)
            tr.set(APPLIED_KEY, b"%d" % version)

        await self.db.run(fn)
        self.applied.set(version)

    async def _pull(self) -> None:
        while True:
            if self.tlog is None or self._paused:
                await self.loop.delay(0.05, TaskPriority.STORAGE_SERVER)
                continue
            try:
                reply = await self.tlog.get_reply(
                    TLogPeekRequest(self.tag, self._fetched + 1), timeout=1.0
                )
            except (TimedOut, BrokenPromise):
                await self.loop.delay(0.1, TaskPriority.STORAGE_SERVER)
                continue
            # never apply past known_committed: a version some TLog holds
            # but not every replica acked can be rolled back by a primary
            # recovery (an unknown-result phantom), and applying it would
            # fork the secondary.  Entries above the watermark stay on the
            # TLog and are re-peeked once it advances (the backup worker's
            # guard, roles/backup.py; the reference's DRWorker lacks it)
            for version, muts in reply.entries:
                if version > reply.known_committed:
                    break
                if version <= self.applied.get():
                    continue
                live = self._clip(version, muts)
                if live:
                    await self._apply(version, live)
                elif version > self.applied.get():
                    # nothing to apply at this version: exact by vacuity
                    # (the durable fence only advances on real applies, so
                    # a restart re-reads these frames harmlessly)
                    self.applied.set(version)
                self._fetched = version
            tail = min(reply.end_version - 1, reply.known_committed)
            if tail > self._fetched:
                # versions with no DR-tag data still advance the cursor
                self._fetched = tail
                if self._fetched > self.applied.get():
                    self.applied.set(self._fetched)
            for pop in self.tlog_pops:
                pop.send(TLogPopRequest(self.tag, self.applied.get()))
            if not reply.entries:
                await self.loop.delay(0.01, TaskPriority.STORAGE_SERVER)

    def stop(self) -> None:
        self._task.cancel()


class DRAgent:
    """Drives a DR relationship between two live clusters sharing one
    EventLoop (the fdbdr start/status/switch verbs)."""

    def __init__(self, primary, secondary) -> None:
        assert primary.loop is secondary.loop, (
            "DR needs both clusters on one EventLoop "
            "(RecoverableCluster(loop=...))"
        )
        self.primary = primary
        self.secondary = secondary
        self.loop = primary.loop
        self.worker: DRWorker | None = None
        self.start_version: int | None = None

    async def start(self, chunk_rows: int = 500) -> int:
        """Lock the secondary, register the DR tag on the primary, copy the
        initial snapshot, begin continuous apply.  Returns the stream's
        boundary version."""
        sec_db = self.secondary.database()
        await mgmt.lock_database(sec_db, DR_LOCK_UID)
        # arm the live proxies now (the conf poll converges later anyway)
        gen = self.secondary.controller.generation
        if gen is not None:
            self.secondary.controller._locked = DR_LOCK_UID
            for p in gen.proxies:
                p.locked = DR_LOCK_UID
        proc = self.primary.net.create_process("dr-worker")
        w = DRWorker(proc, self.loop, sec_db, start_version=0)
        cc = self.primary.controller
        while True:
            vm = await cc.enable_stream_consumer(DR_TAG, w)
            if vm is not None:
                break
            await self.loop.delay(0.1, TaskPriority.COORDINATION)
        self.worker = w
        self.start_version = vm

        # initial snapshot: chunked copy primary -> secondary (each chunk
        # at its own read version; the stream covers everything above).
        # Any failure here must UNWIND the registration: a permanently
        # paused worker retains the DR tag on the primary's TLogs forever
        # (no pops while paused — the retention that makes the pause safe
        # becomes a leak if the stream never starts).
        try:
            pri_db = self.primary.database()
            cursor = b""
            bounds: list[bytes] = []
            cvers: list[int] = []
            while True:
                tr = pri_db.create_transaction()
                rows = await tr.get_range(cursor, b"\xff", limit=chunk_rows,
                                          snapshot=True)
                v = await tr.get_read_version()
                end = key_after(rows[-1][0]) if len(rows) == chunk_rows else b"\xff"
                bounds.append(cursor)
                cvers.append(v)

                async def fn(tr2, rows=rows, cursor=cursor, end=end) -> None:
                    tr2.set_option(b"lock_aware")
                    tr2.clear_range(cursor, end)
                    for k, val in rows:
                        tr2.set(k, val)

                await sec_db.run(fn)
                if len(rows) < chunk_rows:
                    break
                cursor = end
        except BaseException:
            await self.stop(unlock_secondary=True)
            raise
        w.set_snapshot_clip(bounds, cvers)
        testcov("dr.started")
        return vm

    @property
    def lag_versions(self) -> int:
        gen = self.primary.controller.generation
        if gen is None or self.worker is None:
            return 0
        committed = max(p.committed_version.get() for p in gen.proxies)
        return max(committed - self.worker.applied.get(), 0)

    async def wait_applied_to(self, version: int, timeout: float = 120.0) -> None:
        from ..runtime.combinators import timeout_error

        await timeout_error(
            self.loop, self.worker.applied.when_at_least(version), timeout
        )

    async def failover(self, timeout: float = 120.0) -> int:
        """Switch: lock the primary, drain the stream to the primary's
        final commit, detach, unlock the secondary (fdbdr switch).
        Returns the version the secondary is exact at."""
        pri_db = self.primary.database()
        await mgmt.lock_database(pri_db, b"dr-failover")
        # arm the primary's proxies immediately (the conf poll would too,
        # one interval later) — no new user commits once drained.  Mid-
        # recovery (generation None) wait for the new generation: the
        # recovery-end lock application reads self._locked anyway.
        self.primary.controller._locked = b"dr-failover"
        deadline = self.loop.now() + timeout
        while True:
            # the plane being drained IS this lock-armed generation; a
            # recovery racing the drain re-arms the lock at birth (recovery
            # reads controller._locked, set above), so no user commit can
            # slip above `final` on either generation
            # flowlint: ok stale-read-across-await (the drained plane is the lock-armed gen; a racing recovery re-arms the lock from _locked at birth)
            gen = self.primary.controller.generation
            if gen is not None and not self.primary.controller._recovering:
                break
            if self.loop.now() >= deadline:
                from ..runtime.core import TimedOut

                raise TimedOut("primary never re-formed a generation")
            await self.loop.delay(0.1, TaskPriority.COORDINATION)
        for p in gen.proxies:
            p.locked = b"dr-failover"
        # version-consistency with the lock: the lock gate is checked at
        # batch ENTRY, so a batch already past it can still commit at a
        # version above whatever read version we sample now — and a commit
        # above `final` would survive on the primary only (dropped from the
        # secondary after wait_applied_to + stop).  Drain the commit plane
        # first (the rebalance barrier discipline: pause + wait for
        # in-flight batches), THEN read `final`; with the plane empty and
        # the lock armed, no commit above `final` can ever exist.
        for p in gen.proxies:
            p.pause_commits()
        try:
            drain_deadline = min(deadline, self.loop.now() + 10.0)
            while any(p.inflight_batches for p in gen.proxies):
                if self.loop.now() >= drain_deadline:
                    from ..runtime.core import TimedOut

                    raise TimedOut("primary commit plane never drained")
                await self.loop.delay(0.005, TaskPriority.COORDINATION)
            tr = pri_db.create_transaction()
            final = await tr.get_read_version()
        finally:
            # disarm the barrier refcount (the lock flag alone keeps
            # refusing user commits); leaving it held would wedge a later
            # unlock-and-resume of this primary
            for p in gen.proxies:
                p.resume_commits()
        testcov("dr.failover_drained")
        await self.wait_applied_to(final, timeout)
        await self.stop(unlock_secondary=True)
        testcov("dr.failover")
        self.primary.trace.trace("DRFailover", FinalVersion=final)
        return final

    async def stop(self, unlock_secondary: bool = False) -> None:
        try:
            await self.primary.controller.disable_stream_consumer(DR_TAG)
        finally:
            if self.worker is not None:
                self.worker.stop()
                self.worker = None
            if unlock_secondary:
                sec_db = self.secondary.database()
                await mgmt.unlock_database(sec_db, DR_LOCK_UID)
                # disarm the live proxies immediately (the conf poll would
                # converge one interval later) — failover turnover is NOW
                gen = self.secondary.controller.generation
                if gen is not None:
                    self.secondary.controller._locked = None
                    for p in gen.proxies:
                        p.locked = None
