"""Resolver role — OCC conflict detection hosting a ConflictSet backend
(fdbserver/Resolver.actor.cpp:71 resolveBatch, :262 resolverCore).

The role is a thin, totally-ordered shell around the conflict backend:
batches carry (prev_version → version) chain links; a batch waits until the
chain reaches its prev_version (NotifiedVersion, Resolver.actor.cpp:104-115),
then runs the backend's batched check and replies verdicts.  MVCC GC runs
per batch with the knob-derived window (SkipList removeBefore :1199-1206).

The backend is pluggable (conflict/plugin.py seam): oracle (tests), native
C++ skip list (CPU), the device set on the card (hand-written CUDA), or
the sharded device set.  Resolver state evaporates on generation change —
recovery builds a fresh Resolver (SURVEY §5), which the master accounts for
by seeding post-recovery resolvers with oldest = recovery version.

Split-phase (pipelined) resolve — opt-in via the `pipeline=` constructor
argument, OFF by default so deterministic
simulation and tier-1 runs keep the synchronous path: a batch DISPATCHES
through ConflictSet.resolve_deferred, advances the version chain
immediately (so the next version-chained batch can pack and dispatch while
the device still runs this one), and its verdicts are drained/replied when
the successor dispatches — or by a bounded flush delay when the stream goes
idle.  Verdict delivery (reply-cache insertion and replies) stays strictly
version-ordered because at most ONE batch is parked pending at a time, and
a duplicate delivery (proxy retry) of a version whose verdicts are still
deferred flushes the pending batch before answering from the cache.  TOO_OLD
floor semantics are unchanged: MVCC GC runs at dispatch time in the same
resolve→remove_before order as the synchronous path, so batch N+1 packs
against exactly the floor the synchronous resolver would have used.

Copy of the reference package's role: over the same conflict-set
semantics and on the same seeded loop it replies the same verdicts at the
same virtual times.  The reference's `pipeline=None` reads an environment
switch; here `pipeline` is a plain keyword, False by default.
"""

from __future__ import annotations

import dataclasses

from ..conflict.api import ConflictSet, ResolveHandle, Verdict
from .sequencer import NotifiedVersion
from .types import (
    ResolutionMetricsReply,
    ResolutionMetricsRequest,
    ResolutionSplitReply,
    ResolutionSplitRequest,
    ResolveTransactionBatchReply,
    ResolveTransactionBatchRequest,
    Version,
)
from ..rpc.network import SimProcess
from ..rpc.stream import RequestStream
from ..runtime.buggify import maybe_delay
from ..runtime.core import EventLoop, TaskPriority
from ..runtime.knobs import CoreKnobs
from ..runtime.metrics import LatencyTracker
from ..runtime.trace import CounterCollection, g_trace_batch, spawn_role_metrics


# idle-stream flush bound for the split-phase path: if no successor batch
# dispatches within this many (simulated) seconds, the parked batch drains
# and replies itself — pipelining never delays a reply past one flush tick
_PIPELINE_FLUSH_S = 0.0005


@dataclasses.dataclass
class _PendingBatch:
    """A dispatched-but-unreplied batch in the split-phase pipeline."""

    req: object
    r: "ResolveTransactionBatchRequest"
    handle: ResolveHandle
    t0: float
    moved_in: list  # moved-range guards as of dispatch (the sync path's view)
    spans: tuple    # sampled debug IDs that rode the request envelope


class Resolver:
    WLT = "wlt:resolver"
    WLT_METRICS = "wlt:resolver_metrics"

    def __init__(
        self,
        process: SimProcess,
        loop: EventLoop,
        knobs: CoreKnobs,
        conflict_set: ConflictSet,
        start_version: Version = 0,
        pipeline: bool = False,
    ) -> None:
        self.loop = loop
        self.knobs = knobs
        self.cs = conflict_set
        if hasattr(conflict_set, "bind_clock"):
            # a supervised device backend (conflict/supervisor.py) paces its
            # retry backoff and re-probe schedule off OUR clock: virtual
            # time under simulation (deterministic chaos), wall time when
            # this role runs on the real network
            conflict_set.bind_clock(loop.now)
        if hasattr(conflict_set, "enable_wall_watchdog"):
            from ..rpc.transport import RealProcess

            if isinstance(process, RealProcess):
                # real network: a hung device call must be bounded by the
                # wall-clock watchdog (under sim, threads are forbidden and
                # hangs are injected virtually instead)
                conflict_set.enable_wall_watchdog()
        self.version = NotifiedVersion(start_version)
        self.stream = RequestStream(process, self.WLT, unique=True)
        self.counters = CounterCollection("Resolver")
        self.c_batches = self.counters.counter("batches")
        self.c_txns = self.counters.counter("txns")
        self.c_conflicts = self.counters.counter("conflicts")
        # _resolve_one receipt→reply in simulated seconds: includes the
        # version-chain wait, so a stalled chain shows up HERE while the
        # backend's own wall time lives in cs.kernel_stats()
        self.latency = LatencyTracker()
        # recent batch outcomes so a proxy retry of an already-resolved
        # version re-receives its real verdicts (the reference caches recent
        # replies; abort-all would turn every retried batch into aborts)
        self._reply_cache: dict[Version, list[int]] = {}
        # key-load sampling for resolutionBalancing (Resolver.actor.cpp:276):
        # a windowed conflict-range counter + a bounded reservoir of range
        # begin keys; the controller turns the median sample into a split
        self._load_ranges = 0
        self._samples: list[bytes] = []
        self._sample_i = 0
        # ranges moved INTO this resolver mid-generation: before from_version
        # their history lives on the donor, so any read below it must
        # conservatively conflict (same family as recovery state-evaporation)
        self._moved_in: list[tuple[bytes, bytes | None, Version]] = []
        # split-phase pipeline (module docstring): at most one batch parked
        # pending between its dispatch and its successor's dispatch
        self._pipeline = bool(pipeline)
        self._pending: _PendingBatch | None = None
        self._metrics_emitter = None
        self.metrics_stream = RequestStream(process, self.WLT_METRICS, unique=True)
        self._task = loop.spawn(self._serve(), TaskPriority.RESOLVER, "resolver")
        self._metrics_task = loop.spawn(
            self._serve_metrics(), TaskPriority.RESOLVER, "resolver-metrics"
        )

    async def _serve(self) -> None:
        while True:
            req = await self.stream.next()
            # each batch resolves in its own task so later batches can queue
            # behind the version chain without blocking the stream
            self.loop.spawn(self._resolve_one(req), TaskPriority.RESOLVER)

    async def _resolve_one(self, req) -> None:
        r: ResolveTransactionBatchRequest = req.payload
        t0 = self.loop.now()
        # wire-propagated trace context (rpc/stream.py RpcMessage.spans):
        # sampled debug IDs land THIS role's stations in the local process's
        # TraceBatch — the reference's Resolver.resolveBatch stations
        spans = req.spans or ()
        for d in spans:
            g_trace_batch.add("Resolver.resolveBatch.Before", d)
        await maybe_delay(self.loop, "resolver.delay_resolve")
        await self.version.when_at_least(r.prev_version)
        for d in spans:
            g_trace_batch.add("Resolver.resolveBatch.AfterOrderer", d)
        if self.version.get() >= r.version:
            # duplicate delivery (proxy retry after timeout): the retried
            # version's verdicts may still be deferred in the pipeline —
            # flush the parked batch so the cache is authoritative, then
            # re-reply the cached verdicts; if evicted, conservatively
            # abort-all so the client retries (safe: committed=false never
            # loses data).  Only the PENDING version needs the flush: every
            # earlier version was finished (cache filled) before this one
            # parked, so retries of old versions answer from cache without
            # collapsing the pack/execute overlap.
            if self._pending is not None and self._pending.r.version == r.version:
                self._flush_pending()
            cached = self._reply_cache.get(r.version)
            req.reply(
                ResolveTransactionBatchReply(
                    committed=cached
                    if cached is not None
                    else [int(Verdict.CONFLICT)] * len(r.transactions)
                )
            )
            return
        self._sample_load(r.transactions)
        if self._pipeline:
            await self._resolve_pipelined(req, r, t0, spans)
            return
        verdicts = self.cs.resolve_batch(r.version, r.transactions)
        if self._moved_in:
            verdicts = self._apply_moved_in_guard(
                self._moved_in, r.transactions, verdicts
            )
        self.c_batches.add(1)
        self.c_txns.add(len(r.transactions))
        self.c_conflicts.add(sum(1 for v in verdicts if v == Verdict.CONFLICT))
        self._advance_window(r.version)
        committed = [int(v) for v in verdicts]
        self._reply_cache[r.version] = committed
        self.version.set(r.version)
        self.latency.observe(self.loop.now() - t0)
        for d in spans:
            g_trace_batch.add("Resolver.resolveBatch.After", d)
        req.reply(ResolveTransactionBatchReply(committed=committed))

    # -- split-phase pipeline (module docstring) ------------------------------
    async def _resolve_pipelined(self, req, r, t0: float, spans=()) -> None:
        """Dispatch this batch, advance the chain, reply the PREVIOUS batch.

        State transitions happen in exactly the synchronous order —
        resolve(N) then remove_before(N's cutoff) — because dispatch and GC
        both run here before the next batch's chain wait releases; only the
        verdict FETCH is deferred, which is what lets batch N+1's host phase
        (packing) overlap batch N's device execution."""
        handle = self.cs.resolve_deferred(r.version, r.transactions)
        pend = _PendingBatch(req, r, handle, t0, list(self._moved_in), tuple(spans))
        self._advance_window(r.version)  # same dispatch-order GC as sync
        prev, self._pending = self._pending, pend
        self.version.set(r.version)  # successor may now pack + dispatch
        if prev is not None:
            self._finish(prev)
        # bounded reply delay: if no successor dispatches (and thereby
        # finishes us) within the flush tick, drain ourselves
        await self.loop.delay(_PIPELINE_FLUSH_S, TaskPriority.RESOLVER)
        if self._pending is pend:
            self._pending = None
            self._finish(pend)

    def _finish(self, pend: _PendingBatch) -> None:
        """Drain a dispatched batch's verdicts and reply — the deferred half
        of the synchronous path, in the same order (guard, counters, cache,
        reply); called strictly in version order (single pending slot)."""
        verdicts = pend.handle.wait()
        if pend.moved_in:
            verdicts = self._apply_moved_in_guard(
                pend.moved_in, pend.r.transactions, verdicts
            )
        self.c_batches.add(1)
        self.c_txns.add(len(pend.r.transactions))
        self.c_conflicts.add(sum(1 for v in verdicts if v == Verdict.CONFLICT))
        committed = [int(v) for v in verdicts]
        self._reply_cache[pend.r.version] = committed
        self.latency.observe(self.loop.now() - pend.t0)
        for d in pend.spans:
            g_trace_batch.add("Resolver.resolveBatch.After", d)
        pend.req.reply(ResolveTransactionBatchReply(committed=committed))

    def _flush_pending(self) -> None:
        if self._pending is not None:
            pend, self._pending = self._pending, None
            self._finish(pend)

    def _advance_window(self, version: Version) -> None:
        """MVCC GC: versions older than the write-transaction window can no
        longer be checked against; raise the TooOld floor."""
        window = self.knobs.mvcc_window_versions
        if version <= window:
            return
        cutoff = version - window
        self.cs.remove_before(cutoff)
        # moved-in guards expire once the TooOld floor passes them
        self._moved_in = [m for m in self._moved_in if m[2] > cutoff]
        # insertion order is version order: evict from the front only,
        # O(evicted) not O(cache size) per batch
        stale = []
        for v in self._reply_cache:
            if v >= cutoff:
                break
            stale.append(v)
        for v in stale:
            del self._reply_cache[v]

    def start_metrics(self, trace, interval: float):
        """Periodic ResolverMetrics emission: rate-converted role counters
        plus the conflict backend's KernelStats PHASE DELTAS over the
        interval (wall ms spent packing/resolving/merging since the last
        emission — the time-series ROADMAP item 1 tunes against) and the
        DeviceSupervisor state when the backend is supervised."""
        if self._metrics_emitter is not None:
            self._metrics_emitter.cancel()
        prev: dict = {}

        def fields() -> dict:
            r = self.counters.rates(self.loop.now())
            ks = self.cs.kernel_stats()
            f = {
                "BatchesPerSec": r.get("batches", 0.0),
                "TxnsPerSec": r.get("txns", 0.0),
                "ConflictsPerSec": r.get("conflicts", 0.0),
                "Version": self.version.get(),
                "OldestVersion": self.cs.oldest_version,
                "LatencyP99Ms": self.latency.snapshot()["p99"] * 1e3,
                "KernelBackend": ks["backend"],
                "KernelBatchesDelta": ks["batches"] - prev.get("batches", 0),
                "KernelPackMsDelta": ks["pack_ms"] - prev.get("pack_ms", 0.0),
                "KernelResolveMsDelta":
                    ks["resolve_ms"] - prev.get("resolve_ms", 0.0),
                "KernelMergeMsDelta":
                    ks["merge_ms"] - prev.get("merge_ms", 0.0),
            }
            sup = ks.get("supervisor")
            if sup is not None:
                f["DeviceState"] = sup["state"]
                f["DeviceServing"] = sup["serving"]
                f["DeviceTrips"] = sup["trips"]
            prev.clear()
            prev.update(ks)
            return f

        self._metrics_emitter = spawn_role_metrics(
            self.loop, self.stream._process, trace, "ResolverMetrics", fields,
            interval, TaskPriority.RESOLVER,
        )
        return self._metrics_emitter

    def stop(self) -> None:
        self._flush_pending()  # reply any parked batch before tearing down
        self._task.cancel()
        self._metrics_task.cancel()
        if self._metrics_emitter is not None:
            self._metrics_emitter.cancel()
        self.stream.close()
        self.metrics_stream.close()
        self.cs.close()

    # -- resolutionBalancing support ----------------------------------------
    def _sample_load(self, txns) -> None:
        for tx in txns:
            rr = tx.read_ranges
            wr = tx.write_ranges
            if not rr and not wr:
                # bisect routing sends this resolver an empty TxInfo for
                # every txn it doesn't touch (index alignment) — skip them
                # without building throwaway lists
                continue
            self._load_ranges += len(rr) + len(wr)
            for ranges in (rr, wr):
                for b, _e in ranges:
                    self._sample_i += 1
                    if self._sample_i % 8 == 0:
                        self._samples.append(b)
        if len(self._samples) > 256:
            self._samples = self._samples[::2]  # deterministic decimation

    def _apply_moved_in_guard(self, moved_in, txns, verdicts) -> list:
        out = list(verdicts)
        for i, tx in enumerate(txns):
            if out[i] != Verdict.COMMITTED:
                continue
            for mb, me, mv in moved_in:
                if tx.read_snapshot < mv and any(
                    (me is None or b < me) and mb < e
                    for b, e in tx.read_ranges
                ):
                    out[i] = Verdict.CONFLICT
                    break
        return out

    def install_moved_range(
        self, begin: bytes, end: bytes | None, from_version: Version
    ) -> None:
        """A key range just moved into this resolver's partition effective
        at `from_version` (end=None: to the top of key space).  Installed by
        the controller during a drained rebalance, so no batch straddles it."""
        self._moved_in.append((begin, end, from_version))

    async def _serve_metrics(self) -> None:
        while True:
            req = await self.metrics_stream.next()
            if isinstance(req.payload, ResolutionMetricsRequest):
                req.reply(ResolutionMetricsReply(self._load_ranges))
                self._load_ranges = 0
            else:
                assert isinstance(req.payload, ResolutionSplitRequest)
                s = sorted(self._samples)
                key = s[len(s) // 2] if len(s) >= 8 else None
                # reset the reservoir: after the move the old samples skew
                # toward the donated range and would wedge future splits
                self._samples = []
                self._sample_i = 0
                req.reply(ResolutionSplitReply(key))
