"""Commit proxy — the 5-phase pipelined commit path + GRV service
(fdbserver/MasterProxyServer.actor.cpp: commitBatcher :323, commitBatch
:389, transactionStarter :1052).

Pipeline (phases numbered as the reference numbers them):
  1. batch assembly (dynamic interval) → GetCommitVersion from the sequencer
  2. conflict ranges split per resolver partition → resolve RPCs (barrier)
  3. min-combine verdicts across resolvers (:558-569)
  4. committed mutations tagged per storage shard → TLog pushes (barrier)
  5. committed_version advances in version order → client replies

Batches overlap: batch N+1 runs phases 1-3 while batch N is logging — the
only cross-batch ordering is the (prev_version → version) chain enforced by
resolvers/TLogs and the in-order committed_version.set here.

Copy of the reference package's role, on the port's runtime and rpc: it
sends the port's request types and draws in the reference's order.
"""

from __future__ import annotations

import bisect
import dataclasses

from ..conflict.api import TxInfo, Verdict
from .sequencer import NotifiedVersion
from .types import (
    PRIORITY_BATCH,
    PRIORITY_DEFAULT,
    PRIORITY_IMMEDIATE,
    CommitReply,
    CommitResult,
    CommitTransactionRequest,
    GetCommitVersionReply,
    GetCommitVersionRequest,
    GetRawCommittedVersionReply,
    GetRawCommittedVersionRequest,
    GetReadVersionReply,
    GetReadVersionRequest,
    Mutation,
    MutationType,
    ResolveTransactionBatchRequest,
    TLogCommitRequest,
    TLogConfirmRequest,
    Version,
)
from ..rpc.network import SimProcess
from ..rpc.stream import RequestStream, RequestStreamRef
from ..runtime.combinators import wait_all, wait_any
from ..runtime.core import BrokenPromise, EventLoop, FutureStream, TaskPriority, TimedOut
from ..runtime.knobs import CoreKnobs
from ..runtime.buggify import buggify, maybe_delay
from ..runtime.metrics import LatencyTracker
from ..runtime.trace import CounterCollection, g_trace_batch, spawn_role_metrics
from ..runtime.coverage import testcov


class KeyPartitionMap:
    """Contiguous key partitions → members (resolver index or storage tag).
    The static stand-in for the reference's keyResolvers / keyServers
    KeyRangeMaps (coalesced range maps on the proxy).

    Routing is bisect-based: `split_ranges` finds the touched partition
    SPAN of each range with two binary searches and clips only at the span
    edges — the commit path's phase-2/phase-4 workhorse.  The old
    per-partition `clip_to_member` probe is kept as the referee oracle
    (tests/test_rangemap.py asserts the two agree on randomized maps)."""

    def __init__(self, split_keys: list[bytes], members: list) -> None:
        if len(members) != len(split_keys) + 1:
            raise ValueError("need len(splits)+1 members")
        self.splits = list(split_keys)
        self.members = list(members)

    def position_for_key(self, key: bytes) -> int:
        """Partition INDEX holding `key` (== member index for resolver
        maps; for storage maps the member at this index is a team)."""
        return bisect.bisect_right(self.splits, key)

    def member_for_key(self, key: bytes):
        return self.members[bisect.bisect_right(self.splits, key)]

    def span_for_range(self, begin: bytes, end: bytes) -> tuple[int, int]:
        """(lo, hi) inclusive partition-index span intersecting
        [begin, end); (0, -1) for an empty range."""
        if begin >= end:
            return 0, -1
        return (
            bisect.bisect_right(self.splits, begin),
            bisect.bisect_left(self.splits, end),
        )

    def members_for_range(self, begin: bytes, end: bytes) -> list:
        lo, hi = self.span_for_range(begin, end)
        return self.members[lo : hi + 1]

    def clip_to_member(self, idx: int, begin: bytes, end: bytes) -> tuple[bytes, bytes] | None:
        lo = self.splits[idx - 1] if idx > 0 else b""
        hi = self.splits[idx] if idx < len(self.splits) else None
        b = max(begin, lo)
        e = end if hi is None else min(end, hi)
        return (b, e) if b < e else None

    def split_ranges(
        self, ranges
    ) -> "dict[int, list[tuple[bytes, bytes]]]":
        """Partition index -> clipped pieces of `ranges`, touched
        partitions only.  One bisect span per range instead of one clip
        probe per (range, partition): the O(ranges × partitions) loop the
        commit path used to run collapses to O(ranges · log splits +
        touched).  Piece order per partition follows input range order,
        and pieces are byte-identical to `clip_to_member`'s output:
          * lo = bisect_right(splits, begin) ⇒ splits[lo-1] <= begin <
            splits[lo], so the first piece keeps `begin` uncut
          * hi = bisect_left(splits, end) ⇒ splits[hi-1] < end <=
            splits[hi], so the last piece keeps `end` uncut (and a range
            beginning ON a split key routes right, like member_for_key)
          * interior partitions take their full [splits[r-1], splits[r])
        """
        splits = self.splits
        out: dict[int, list[tuple[bytes, bytes]]] = {}
        br = bisect.bisect_right
        bl = bisect.bisect_left
        for b, e in ranges:
            if b >= e:
                continue
            lo = br(splits, b)
            hi = bl(splits, e)
            if lo == hi:  # one partition holds the whole range
                piece = out.get(lo)
                if piece is None:
                    out[lo] = [(b, e)]
                else:
                    piece.append((b, e))
                continue
            out.setdefault(lo, []).append((b, splits[lo]))
            for r in range(lo + 1, hi):
                out.setdefault(r, []).append((splits[r - 1], splits[r]))
            out.setdefault(hi, []).append((splits[hi - 1], e))
        return out


@dataclasses.dataclass
class _PendingCommit:
    request: CommitTransactionRequest
    reply_cb: object  # ReceivedRequest
    arrive: float = 0.0  # loop.now() at receipt — feeds the latency bands


class CommitProxy:
    WLT_COMMIT = "wlt:proxy_commit"
    WLT_GRV = "wlt:proxy_grv"
    WLT_RAW = "wlt:proxy_rawversion"

    def __init__(
        self,
        process: SimProcess,
        loop: EventLoop,
        knobs: CoreKnobs,
        sequencer_ref: RequestStreamRef,
        resolver_refs: list[RequestStreamRef],
        resolver_splits: list[bytes],
        tlog_refs: list[RequestStreamRef],
        storage_tags: KeyPartitionMap,
        tag_to_tlogs: dict[str, list[int]] | None = None,
        start_version: Version = 0,
        tlog_confirm_refs: list[RequestStreamRef] | None = None,
    ) -> None:
        self.loop = loop
        self.knobs = knobs
        self.sequencer = sequencer_ref
        self.resolvers = resolver_refs
        # keyResolvers: version-indexed history of resolver partition maps
        # (MasterProxyServer.actor.cpp:287-299) — a batch at version V splits
        # its conflict ranges with the map effective at V, so a rebalance
        # mid-stream never mis-routes an in-flight batch
        self._rmaps: list[tuple[Version, KeyPartitionMap]] = [
            (0, KeyPartitionMap(resolver_splits, list(range(len(resolver_refs)))))
        ]
        self.tlogs = tlog_refs
        self.tags = storage_tags
        # which TLog replicas store each tag (TagPartitionedLogSystem's
        # tag->log-team mapping); default: every tag on tlog 0.  Each
        # storage_tags member is a TEAM (list of per-server tags).
        self.tag_to_tlogs = tag_to_tlogs or {
            t: [0] for team in storage_tags.members for t in team
        }
        # per-SEGMENT committed write bytes (StorageMetrics' bandwidth half:
        # data distribution reads these to find write-hot shards); reset
        # whenever the keyServers map is swapped, since indexes re-segment
        self.seg_write_bytes = [0] * len(storage_tags.members)
        # tags receiving the FULL mutation stream (backup workers, log
        # routers): every committed mutation is also tagged with each
        self.full_stream_tags: list[str] = []
        self.committed_version = NotifiedVersion(start_version)
        self.ratekeeper = None  # set by the cluster; None = unlimited
        # database lock UID (`\xff/conf/lock`): non-lock-aware user commits
        # are refused while set (ManagementAPI lock, error 1038)
        self.locked: bytes | None = None
        self.name = process.name
        self.on_commit_failure = None  # controller hook: escalate to recovery
        self._req_num = 0
        self._failed = False
        self._stopping = False
        self._grv_tokens = 10.0
        self._grv_batch_tokens = 0.0
        self._grv_refill_at = loop.now()
        # multi-proxy plane: raw-version refs of the OTHER proxies (wired by
        # the controller after all proxies exist) and confirm refs to this
        # generation's TLogs.  With peers, GRV = max over all proxies'
        # committed versions, confirmed live against the TLogs
        # (getLiveCommittedVersion, MasterProxyServer.actor.cpp:1002).
        self.peers: list[RequestStreamRef] = []
        self.tlog_confirms = tlog_confirm_refs or []
        self.commit_stream = RequestStream(process, self.WLT_COMMIT, unique=True)
        self.grv_stream = RequestStream(process, self.WLT_GRV, unique=True)
        self.raw_version_stream = RequestStream(process, self.WLT_RAW, unique=True)
        self.counters = CounterCollection("Proxy")
        self.c_committed = self.counters.counter("txns_committed")
        self.c_conflicted = self.counters.counter("txns_conflicted")
        self.c_batches = self.counters.counter("commit_batches")
        self.c_throttled = self.counters.counter("mvcc_window_throttles")
        # SLO latency surface (flow/Stats.h LatencyBands + per-stage
        # histograms): "commit" is end-to-end receipt→reply (the band set
        # operators alert on), "grv" the read-version service, the stage
        # trackers the commitBatch phases — where the time goes when the
        # commit band degrades.  All in SIMULATED seconds.
        self.latency = {
            "commit": LatencyTracker(),
            "grv": LatencyTracker(),
            "batch_wait": LatencyTracker(),
            "version_assign": LatencyTracker(),
            "resolution": LatencyTracker(),
            "tlog_push": LatencyTracker(),
        }
        self._pending: list[_PendingCommit] = []
        self._metrics_emitter = None
        self._batch_tasks: list = []  # in-flight commit batches (stop() kills)
        self._batch_interval = knobs.COMMIT_BATCH_INTERVAL_MIN
        self._paused = 0        # drain barrier refcount (rebalance + DD)
        self._inflight = 0      # commit batches between spawn andcompletion
        self._tasks = [
            loop.spawn(self._accept_commits(), TaskPriority.PROXY_COMMIT, "proxy-accept"),
            loop.spawn(self._batcher(), TaskPriority.PROXY_COMMIT, "proxy-batcher"),
            loop.spawn(self._grv_server(), TaskPriority.GET_LIVE_VERSION, "proxy-grv"),
            loop.spawn(self._raw_version_server(), TaskPriority.GET_LIVE_VERSION,
                       "proxy-raw"),
        ]

    def rmap_at(self, version: Version) -> KeyPartitionMap:
        """The resolver map effective at `version` (keyResolvers lookup)."""
        for from_v, m in reversed(self._rmaps):
            if version >= from_v:
                return m
        return self._rmaps[0][1]

    def install_resolver_splits(
        self, splits: list[bytes], from_version: Version
    ) -> None:
        """New partition map effective at `from_version` (installed by the
        controller during a drained rebalance)."""
        self._rmaps.append(
            (from_version, KeyPartitionMap(list(splits), list(range(len(self.resolvers)))))
        )
        if len(self._rmaps) > 8:
            self._rmaps = self._rmaps[-8:]

    def pause_commits(self) -> None:
        """Hold new commit batches (requests keep queueing in _pending);
        in-flight batches drain — the rebalance version-boundary barrier.
        Counted: resolver rebalancing and data distribution may both drain
        the plane at once."""
        self._paused += 1

    def resume_commits(self) -> None:
        self._paused = max(0, self._paused - 1)

    def install_storage_map(
        self, pmap: KeyPartitionMap, tag_to_tlogs: dict[str, list[int]]
    ) -> None:
        """Swap the keyServers map (data distribution move/split boundary).
        Only called by the controller inside a drained pause — with no batch
        in flight the swap needs no version-indexed history, unlike the
        resolver map (reference: MoveKeys commits the keyServers change
        through the pipeline itself, MoveKeys.actor.cpp:875)."""
        self.tags = pmap
        self.tag_to_tlogs = dict(tag_to_tlogs)
        self.seg_write_bytes = [0] * len(pmap.members)

    @property
    def inflight_batches(self) -> int:
        return self._inflight

    # -- phase 1: batching --------------------------------------------------
    async def _accept_commits(self) -> None:
        while True:
            req = await self.commit_stream.next()
            self._pending.append(
                _PendingCommit(req.payload, req, arrive=self.loop.now())
            )

    async def _batcher(self) -> None:
        """Fire a commit batch every interval (dynamic batching: the
        reference adapts the interval to commit latency, :989-993; we adapt
        to batch fullness).  Empty batches still run periodically so the
        version chain and resolver GC advance on an idle cluster."""
        idle = 0.0
        while True:
            await self.loop.delay(self._batch_interval, TaskPriority.PROXY_COMMIT)
            if self._paused:
                continue
            # adapt the interval to how full this tick's batch is, sampled
            # BEFORE the swap: a fuller pipeline fires batches faster
            full = len(self._pending) / max(self.knobs.COMMIT_BATCH_MAX_COUNT, 1)
            lo, hi = self.knobs.COMMIT_BATCH_INTERVAL_MIN, self.knobs.COMMIT_BATCH_INTERVAL_MAX
            self._batch_interval = min(hi, max(lo, hi * (1.0 - min(full * 50, 1.0))))
            if (
                self._pending
                or idle >= self.knobs.COMMIT_BATCH_INTERVAL_MAX
                or buggify("proxy.early_batch")
            ):
                batch, self._pending = self._pending, []
                idle = 0.0
                # cap batch size (the reference's COMMIT_BATCH_MAX_COUNT):
                # oversized ticks split into sequential pipelined batches
                cap = max(self.knobs.COMMIT_BATCH_MAX_COUNT, 1)
                for i in range(0, max(len(batch), 1), cap):
                    t = self.loop.spawn(
                        self._commit_batch(batch[i : i + cap]),
                        TaskPriority.PROXY_COMMIT,
                    )
                    self._batch_tasks.append(t)
                self._batch_tasks = [t for t in self._batch_tasks if not t.done()]
            else:
                idle += self._batch_interval

    # -- phases 2-5 ----------------------------------------------------------
    async def _retry_reply(self, ref: RequestStreamRef, payload, deadline: float,
                           spans: tuple | None = None):
        """get_reply with bounded retries: every commit-path RPC is
        idempotent under retry (sequencer dedups request_num, resolvers
        abort-all on duplicate versions, TLogs re-ack), so a dropped packet
        costs a retry instead of a permanently wedged version chain.
        `spans` rides the RpcMessage envelope so downstream roles land
        their pipeline stations under the batch's sampled debug IDs."""
        attempt = 0
        while True:
            try:
                return await ref.get_reply(payload, timeout=1.0, spans=spans)
            except (TimedOut, BrokenPromise):
                attempt += 1
                if self._failed or self.loop.now() >= deadline:
                    raise
                await self.loop.delay(
                    min(0.05 * attempt, 0.5), TaskPriority.PROXY_COMMIT
                )

    async def _commit_batch(self, batch: list[_PendingCommit]) -> None:
        self._inflight += 1
        try:
            await self._commit_batch_inner(batch)
        # flowlint: ok swallowed-cancel (deliberate: stop() cancels in-flight
        # batches and the cancelled batch MUST answer UNKNOWN — a deposed
        # proxy's clients run the fence dance, not a hang; see stop())
        except Exception as e:  # noqa: BLE001 — containment: ANY commit-path
            # failure (not just TimedOut) must answer the clients and, since
            # an assigned version may now be a hole in the prev->version
            # chain, escalate to recovery rather than wedge the pipeline.
            # The txns may or may not land once recovery replays surviving
            # logs — reply UNKNOWN, the client's commit_unknown_result path
            # (NativeAPI.actor.cpp:2482-2502).
            for pc in batch:
                pc.reply_cb.reply(CommitReply(CommitResult.UNKNOWN))
            if not self._failed and not self._stopping:
                self._failed = True
                self.counters.counter("commit_path_failures").add(1)
                if self.on_commit_failure is not None:
                    self.on_commit_failure(self, e)
        finally:
            self._inflight -= 1

    async def _commit_batch_inner(self, batch: list[_PendingCommit]) -> None:
        self.c_batches.add(1)
        if self.locked is not None and batch:
            # database lock (ManagementAPI lock/unlock; reference checks the
            # lock key in commitBatch, error 1038): only lock-aware txns and
            # system (`\xff`) writes — the unlock txn itself — pass
            allowed: list[_PendingCommit] = []
            for pc in batch:
                t = pc.request
                if t.lock_aware or (
                    t.mutations
                    and all(m.key.startswith(b"\xff") for m in t.mutations)
                ):
                    allowed.append(pc)
                else:
                    testcov("proxy.database_locked")
                    pc.reply_cb.reply(CommitReply(CommitResult.DATABASE_LOCKED))
            batch = allowed
        t_start = self.loop.now()
        if batch:
            bw = self.latency["batch_wait"]
            for pc in batch:
                bw.observe(t_start - pc.arrive)
        deadline = t_start + self.knobs.COMMIT_PATH_GIVEUP
        self._req_num += 1
        # sampled debug IDs only (usually none): the station loops below
        # must cost nothing on the un-sampled hot path
        dbg = [pc.request.debug_id for pc in batch
               if pc.request.debug_id is not None]
        spans = tuple(dbg) if dbg else None
        for d in dbg:
            g_trace_batch.add("CommitProxyServer.commitBatch.Before", d)
        gv: GetCommitVersionReply = await self._retry_reply(
            self.sequencer,
            GetCommitVersionRequest(
                self.name, self._req_num, self.committed_version.get()
            ),
            deadline,
            spans=spans,
        )
        prev_v, version = gv.prev_version, gv.version
        if batch:
            self.latency["version_assign"].observe(self.loop.now() - t_start)
        for d in dbg:
            g_trace_batch.add("CommitProxyServer.commitBatch.GotCommitVersion", d)

        # phase 2 precondition: versionstamp offsets are client-controlled
        # and must be validated BEFORE resolution — a malformed offset
        # detected after phase 3 would flip the verdict while the resolvers
        # had already merged the txn's write ranges as committed, leaving
        # phantom conflict state that spuriously aborts later readers.
        # Failing pre-resolve keeps the conflict set clean: the txn reaches
        # the resolvers with EMPTY conflict ranges (nothing inserted) and
        # its verdict is forced to CONFLICT after the min-combine.
        from .types import versionstamp_offset_ok

        bad_stamp = [
            not all(versionstamp_offset_ok(m) for m in pc.request.mutations)
            for pc in batch
        ]
        for i, bad in enumerate(bad_stamp):
            if bad:
                testcov("proxy.bad_versionstamp_prereresolve")

        # phase 2: per-resolver range split (ResolutionRequestBuilder :242)
        # using the partition map effective at THIS batch's version.
        # Bisect routing: each conflict range finds its touched resolver
        # SPAN with two binary searches (KeyPartitionMap.split_ranges)
        # instead of every resolver clip-probing every range — the old
        # O(txns × resolvers × ranges) pure-Python loop on the hottest
        # path in the system.  Untouched resolvers still receive a
        # (shared) empty TxInfo so reply verdicts stay index-aligned for
        # the phase-3 min-combine.
        t_res = self.loop.now()
        rmap = self.rmap_at(version)
        n_res = len(self.resolvers)
        per_res: list[list[TxInfo]] = [[] for _ in range(n_res)]
        for i, pc in enumerate(batch):
            t = pc.request
            snap = t.read_snapshot
            if bad_stamp[i]:
                empty = TxInfo(snap, [], [])
                for r in range(n_res):
                    per_res[r].append(empty)
                continue
            rr_by = rmap.split_ranges(t.read_conflict_ranges)
            wr_by = rmap.split_ranges(t.write_conflict_ranges)
            empty = None
            for r in range(n_res):
                rr = rr_by.get(r)
                wr = wr_by.get(r)
                if rr is None and wr is None:
                    if empty is None:
                        empty = TxInfo(snap, [], [])
                    per_res[r].append(empty)
                else:
                    per_res[r].append(TxInfo(snap, rr or [], wr or []))
        replies = await wait_all(
            [
                self.loop.spawn(
                    self._retry_reply(
                        self.resolvers[r],
                        ResolveTransactionBatchRequest(prev_v, version, per_res[r]),
                        deadline,
                        spans=spans,
                    ),
                    TaskPriority.PROXY_COMMIT,
                )
                for r in range(n_res)
            ]
        )

        # phase 3: min-combine (:558-569)
        verdicts = [
            Verdict(min(int(rep.committed[i]) for rep in replies))
            for i in range(len(batch))
        ]
        for i, bad in enumerate(bad_stamp):
            if bad:  # pre-resolve failure: nothing was inserted for it
                verdicts[i] = Verdict.CONFLICT
        if batch:
            self.latency["resolution"].observe(self.loop.now() - t_res)
        for d in dbg:
            g_trace_batch.add("CommitProxyServer.commitBatch.AfterResolution", d)

        # phase 4 precondition — the versions-in-flight commit throttle
        # (:850-870): the semi-committed span (this batch's version minus the
        # newest fully-committed version) is capped at MAX_VERSIONS_IN_FLIGHT
        # (the reference's bound — NOT the 5s MVCC read window: a window-sized
        # bound deadlocks a recovering pipeline, because committed can only
        # advance through the very batches the throttle parks).  The
        # sequencer's assignment clamp keeps the gap below this in steady
        # state; this is the last line of defense.
        window = self.knobs.MAX_VERSIONS_IN_FLIGHT
        if self.committed_version.get() < version - window:
            self.c_throttled.add(1)
            testcov("proxy.mvcc_window_throttle")
        while self.committed_version.get() < version - window:
            await wait_any(
                [
                    self.committed_version.when_at_least(version - window),
                    self.loop.delay(0.05, TaskPriority.PROXY_COMMIT),
                ]
            )
            if self.committed_version.get() < version - window:
                await self._refresh_committed_from_peers()
                if self._failed or self.loop.now() >= deadline:
                    raise TimedOut("MVCC-window throttle never cleared")

        # phase 4: tag committed mutations, push to TLogs
        await maybe_delay(self.loop, "proxy.delay_tlog_push")
        by_tag: dict[str, list[Mutation]] = {}
        txn_order = 0
        for ti, (pc, v) in enumerate(zip(batch, verdicts)):
            if v != Verdict.COMMITTED:
                continue
            muts = pc.request.mutations
            if any(
                m.type in (MutationType.SET_VERSIONSTAMPED_KEY,
                           MutationType.SET_VERSIONSTAMPED_VALUE)
                for m in muts
            ):
                # stamp substitution BEFORE key routing: the final key (not
                # the placeholder) decides the shard.  Offsets were already
                # validated pre-resolve (phase 2 precondition), so this
                # except is defense-in-depth only — it still fails ONLY
                # this transaction, never the batch, which would cascade
                # into a recovery loop.  (Phase 5 sends NOT_COMMITTED.)
                from .types import resolve_versionstamp

                try:
                    muts = [resolve_versionstamp(m, version, txn_order) for m in muts]
                except ValueError:
                    testcov("proxy.bad_versionstamp")
                    verdicts[ti] = Verdict.CONFLICT
                    continue
            txn_order += 1
            tmap = self.tags
            tmembers = tmap.members
            seg_bytes = self.seg_write_bytes
            for m in muts:
                nb = len(m.key) + len(m.value or b"")
                if m.type == MutationType.CLEAR_RANGE:
                    # one bisect span instead of members_for_range + a
                    # second bisect for the byte accounting (phase-2's
                    # routing treatment applied to tag routing)
                    lo, hi = tmap.span_for_range(m.key, m.value)
                    teams = tmembers[lo : hi + 1]
                    for s in range(lo, hi + 1):
                        seg_bytes[s] += nb
                else:
                    s = tmap.position_for_key(m.key)
                    teams = [tmembers[s]]
                    seg_bytes[s] += nb
                # a member is a storage TEAM: every replica has its own tag
                # and receives every mutation of its shard (the reference
                # tags each mutation with the whole team's server tags)
                for team in teams:
                    for tag in team:
                        by_tag.setdefault(tag, []).append(m)
                for ft in self.full_stream_tags:
                    # full-stream subscribers (backup workers, log routers)
                    # get every mutation via their own tag — the reference's
                    # backup/txsTag and log-router tag fan-outs
                    by_tag.setdefault(ft, []).append(m)
        # every TLog sees every version (its prev->version chain must advance
        # even on empty batches) but only stores its own tags' mutations
        per_tlog: list[dict[str, list[Mutation]]] = [dict() for _ in self.tlogs]
        for tag, muts in by_tag.items():
            for idx in self.tag_to_tlogs[tag]:
                per_tlog[idx][tag] = muts
        t_push = self.loop.now()
        await wait_all(
            [
                self.loop.spawn(
                    self._retry_reply(
                        t,
                        TLogCommitRequest(
                            prev_v,
                            version,
                            per_tlog[i],
                            known_committed=self.committed_version.get(),
                        ),
                        deadline,
                        spans=spans,
                    ),
                    TaskPriority.PROXY_COMMIT,
                )
                for i, t in enumerate(self.tlogs)
            ]
        )

        # phase 5: publish + reply.  No local wait on prev_v: the global
        # prev->version chain is enforced AT the TLogs (each waits for its
        # version to reach prev before appending, syncs before acking), so
        # all-TLogs-acked(version) already implies every version <= this one
        # — including other proxies' — is durable everywhere.  A later
        # version may legitimately be reported committed first (reference
        # TEST at :943).
        if self.committed_version.get() < version:
            self.committed_version.set(version)
        if batch:
            self.latency["tlog_push"].observe(self.loop.now() - t_push)
        for d in dbg:
            g_trace_batch.add("CommitProxyServer.commitBatch.AfterLogPush", d)
        t_reply = self.loop.now()
        commit_lat = self.latency["commit"]
        for pc, v in zip(batch, verdicts):
            commit_lat.observe(t_reply - pc.arrive)
            if v == Verdict.COMMITTED:
                self.c_committed.add(1)
                # the database lock is admission control at batch ENTRY (the
                # reference checks it once in commitBatch): a batch already
                # past the gate when the lock lands commits — the lock
                # linearizes AFTER in-flight batches, and dr.py's failover
                # drains the plane before sampling `final` for exactly this
                # reason
                # flowlint: ok epoch-guard-missing (lock is checked at batch entry by design, like the reference commitBatch; in-flight batches serialize before the lock)
                pc.reply_cb.reply(CommitReply(CommitResult.COMMITTED, version))
            elif v == Verdict.TOO_OLD:
                pc.reply_cb.reply(CommitReply(CommitResult.TRANSACTION_TOO_OLD))
            else:
                self.c_conflicted.add(1)
                pc.reply_cb.reply(CommitReply(CommitResult.NOT_COMMITTED))

    # -- GRV ------------------------------------------------------------------
    def _refill_grv_tokens(self, share: int = 1) -> None:
        now = self.loop.now()
        dt = now - self._grv_refill_at
        rate = self.ratekeeper.tps_budget if self.ratekeeper else float("inf")
        rate /= max(share, 1)  # each proxy spends its slice of the budget
        self._grv_tokens = min(
            self._grv_tokens + dt * rate,
            max(rate * 0.1, 100.0),
        )
        # batch-priority bucket: fed by the ratekeeper's separate (harsher)
        # batch budget; it can run dry entirely while default still flows
        brate = (
            self.ratekeeper.batch_tps_budget if self.ratekeeper else float("inf")
        ) / max(share, 1)
        # no burst floor: a zero batch budget must serve ZERO batch traffic
        # (the cap also clamps stale tokens down when the budget collapses)
        self._grv_batch_tokens = min(
            self._grv_batch_tokens + dt * brate, brate * 0.1 + 0.999
        )
        self._grv_refill_at = now

    async def _raw_version_server(self) -> None:
        """Peer service: this proxy's committed version, no liveness check
        (GetRawCommittedVersionRequest)."""
        while True:
            req = await self.raw_version_stream.next()
            assert isinstance(req.payload, GetRawCommittedVersionRequest)
            req.reply(GetRawCommittedVersionReply(self.committed_version.get()))

    async def _refresh_committed_from_peers(self) -> bool:
        """Pull peers' committed versions and advance ours to the max (the
        periphery of getLiveCommittedVersion; also un-stalls the MVCC
        throttle when another proxy has committed past us).

        Returns True only if EVERY peer answered.  A GRV must not be served
        from a partial refresh: an unreachable peer may hold a newer
        committed version than ours, and answering without it would hand a
        client a read version older than its own acknowledged write (the
        reference broadcasts GetRawCommittedVersion to ALL proxies and
        waits, MasterProxyServer.actor.cpp:1002)."""
        if not self.peers:
            return True
        replies = await wait_all(
            [
                self.loop.spawn(
                    self._try_raw(p), TaskPriority.GET_LIVE_VERSION
                )
                for p in self.peers
            ]
        )
        best = max(
            (r.version for r in replies if r is not None),
            default=0,
        )
        if best > self.committed_version.get():
            self.committed_version.set(best)
        return all(r is not None for r in replies)

    async def _try_raw(self, peer: RequestStreamRef):
        try:
            return await peer.get_reply(
                GetRawCommittedVersionRequest(), timeout=0.5
            )
        except (TimedOut, BrokenPromise):
            return None

    async def _confirm_epoch_live(self) -> bool:
        """All this generation's TLogs answer unlocked (confirmEpochLive).
        A locked or unreachable TLog means this proxy may be deposed — it
        must NOT serve a read version (the reply could be stale: a newer
        generation may have committed past it)."""
        if not self.tlog_confirms:
            return True  # statically-wired cluster without the control plane

        async def confirm(ref: RequestStreamRef):
            return await ref.get_reply(TLogConfirmRequest(), timeout=0.5)

        try:
            replies = await wait_all(
                [
                    self.loop.spawn(confirm(ref), TaskPriority.GET_LIVE_VERSION)
                    for ref in self.tlog_confirms
                ]
            )
        except (TimedOut, BrokenPromise):
            return False
        return not any(r.locked for r in replies)

    async def _grv_server(self) -> None:
        """Batched read-version service (transactionStarter :1052 +
        getLiveCommittedVersion :1002): drain the queued GRV requests, spend
        ratekeeper budget, confirm the epoch is live with the TLogs, take
        the max committed version across all proxies, reply to the whole
        batch.  Causally safe because committed versions only advance after
        all-TLog durability, and the liveness confirmation means no newer
        generation can have committed anything this proxy hasn't seen."""
        pend_default: list = []  # (expiry, arrive, req) — parked by throttle
        pend_batch: list = []
        while True:
            # drain arrivals; while throttled requests wait, poll instead of
            # blocking so a starved class never wedges the other classes
            if not pend_default and not pend_batch:
                pend = [await self.grv_stream.next()]
            else:
                pend = []
                if not len(self.grv_stream.requests):
                    await self.loop.delay(0.005, TaskPriority.GET_LIVE_VERSION)
            while len(self.grv_stream.requests):
                pend.append(await self.grv_stream.next())
            now = self.loop.now()
            reqs = []  # (arrive, req) — arrival feeds the GRV latency bands
            for r in pend:
                pri = getattr(r.payload, "priority", PRIORITY_DEFAULT)
                if pri >= PRIORITY_IMMEDIATE:
                    reqs.append((now, r))  # IMMEDIATE: bypasses admission
                elif pri == PRIORITY_BATCH:
                    pend_batch.append((now + 6.0, now, r))
                else:
                    pend_default.append((now + 6.0, now, r))
            # a parked request whose client has long since timed out and
            # re-routed is garbage — drop it instead of growing forever
            pend_default = [e for e in pend_default if e[0] > now]
            pend_batch = [e for e in pend_batch if e[0] > now]
            if self.ratekeeper is not None:
                share = 1 + len(self.peers)  # budget split across proxies
                self._refill_grv_tokens(share)
                n = min(len(pend_default), int(self._grv_tokens))
                if n:
                    self._grv_tokens -= n
                    reqs.extend((a, r) for _e, a, r in pend_default[:n])
                    del pend_default[:n]
                # batch admissions count against BOTH budgets: the batch
                # bucket is the class's (harsher) cap, the default bucket is
                # the cluster-wide ceiling — total admitted rate can never
                # exceed the ratekeeper's tps_budget
                nb = min(
                    len(pend_batch),
                    int(min(self._grv_batch_tokens, self._grv_tokens)),
                )
                if nb:
                    self._grv_batch_tokens -= nb
                    self._grv_tokens -= nb
                    reqs.extend((a, r) for _e, a, r in pend_batch[:nb])
                    del pend_batch[:nb]
                if (pend_default or pend_batch) and not reqs:
                    testcov("proxy.grv_throttled")
            else:
                reqs.extend((a, r) for _e, a, r in pend_default)
                reqs.extend((a, r) for _e, a, r in pend_batch)
                pend_default, pend_batch = [], []
            if not reqs:
                continue
            while True:
                live, refreshed = await wait_all(
                    [
                        self.loop.spawn(
                            self._confirm_epoch_live(), TaskPriority.GET_LIVE_VERSION
                        ),
                        self.loop.spawn(
                            self._refresh_committed_from_peers(),
                            TaskPriority.GET_LIVE_VERSION,
                        ),
                    ]
                )
                if live and refreshed:
                    break
                testcov("proxy.grv_parked")
                # Park, don't drop: the TLogs may be transiently unreachable
                # (recovery in flight).  If this proxy is genuinely deposed its
                # tasks are cancelled by stop() and the waiting clients time
                # out and re-route; answering here with a stale version would
                # break causality (ref MasterProxyServer.actor.cpp:1002).
                await self.loop.delay(0.05, TaskPriority.GET_LIVE_VERSION)
            await maybe_delay(self.loop, "proxy.delay_grv")
            version = self.committed_version.get()
            t_reply = self.loop.now()
            grv_lat = self.latency["grv"]
            for arrive, r in reqs:
                g_trace_batch.add(
                    "GrvProxyServer.transactionStarter.AskLiveCommittedVersion",
                    getattr(r.payload, "debug_id", None),
                )
                grv_lat.observe(t_reply - arrive)
                r.reply(GetReadVersionReply(version))

    def start_metrics(self, trace, interval: float):
        """Periodic ProxyMetrics emission (the reference's ProxyMetrics
        event): rate-converted commit counters + the live SLO tail."""
        if self._metrics_emitter is not None:
            self._metrics_emitter.cancel()

        def fields() -> dict:
            r = self.counters.rates(self.loop.now())
            return {
                "TxnsCommittedPerSec": r.get("txns_committed", 0.0),
                "TxnsConflictedPerSec": r.get("txns_conflicted", 0.0),
                "CommitBatchesPerSec": r.get("commit_batches", 0.0),
                "ThrottlesPerSec": r.get("mvcc_window_throttles", 0.0),
                "CommittedVersion": self.committed_version.get(),
                "BatchInterval": self._batch_interval,
                "CommitP99Ms": self.latency["commit"].snapshot()["p99"] * 1e3,
                "GrvP99Ms": self.latency["grv"].snapshot()["p99"] * 1e3,
            }

        self._metrics_emitter = spawn_role_metrics(
            self.loop, self.commit_stream._process, trace, "ProxyMetrics",
            fields, interval, TaskPriority.PROXY_COMMIT,
        )
        return self._metrics_emitter

    def stop(self) -> None:
        self._stopping = True  # cancellation is teardown, not a failure
        if self._metrics_emitter is not None:
            self._metrics_emitter.cancel()
        for t in self._tasks:
            t.cancel()
        # a deposed proxy's in-flight batches must NOT complete later: the
        # cancelled batch answers UNKNOWN, and the client's fence dance
        # decides the truth (the phantom-ack hole a zombie batch opens)
        for t in self._batch_tasks:
            t.cancel()
        self._batch_tasks = []
        self.commit_stream.close()
        self.grv_stream.close()
        self.raw_version_stream.close()
