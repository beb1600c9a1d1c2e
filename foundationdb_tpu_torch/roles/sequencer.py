"""Sequencer — the master's commit-version authority
(fdbserver/masterserver.actor.cpp:831 getVersion).

Assigns strictly increasing commit versions, advancing with the virtual
clock at VERSIONS_PER_SECOND (so a version *is* a timestamp, the property
the MVCC window math relies on), and hands each proxy batch the
(prev_version, version) pair that chains the global batch order — resolvers
and TLogs process batches strictly in that chain order.

Copy of the reference package's module, on the port's runtime and rpc.
"""

from __future__ import annotations

from ..roles.types import GetCommitVersionReply, GetCommitVersionRequest, Version
from ..rpc.network import SimProcess
from ..rpc.stream import RequestStream
from ..runtime.buggify import maybe_delay
from ..runtime.core import EventLoop, Future, Promise, TaskPriority
from ..runtime.knobs import CoreKnobs
from ..runtime.trace import CounterCollection, g_trace_batch, spawn_role_metrics


class NotifiedVersion:
    """Monotone version with wait-until (the Orderer/NotifiedVersion pattern,
    fdbserver/Resolver.actor.cpp:56): consumers await when_at_least(v) and
    are resumed in version order when set() advances."""

    def __init__(self, start: Version = 0) -> None:
        self._value = start
        self._waiters: list[tuple[Version, Promise]] = []

    def get(self) -> Version:
        return self._value

    def set(self, v: Version) -> None:
        if v < self._value:
            raise ValueError(f"NotifiedVersion moving backwards: {v} < {self._value}")
        self._value = v
        ready = [w for w in self._waiters if w[0] <= v]
        self._waiters = [w for w in self._waiters if w[0] > v]
        for want, p in sorted(ready, key=lambda w: w[0]):
            p.send(v)

    def rollback(self, v: Version) -> None:
        """Move the value DOWN (recovery-only: storage discards versions
        above the recovery version).  Waiters above v keep waiting — the new
        generation's versions jump past anything previously observed, so
        they resume once real commits arrive."""
        if v < self._value:
            self._value = v

    def when_at_least(self, v: Version) -> Future:
        if self._value >= v:
            p = Promise()
            p.send(self._value)
            return p.future
        p = Promise()
        self._waiters.append((v, p))
        return p.future


class Sequencer:
    """Version-assignment service; one per cluster generation."""

    WLT = "wlt:sequencer"

    def __init__(self, process: SimProcess, loop: EventLoop, knobs: CoreKnobs,
                 start_version: Version = 0) -> None:
        self.loop = loop
        self.knobs = knobs
        self._last_assigned: Version = start_version
        self._prev: Version = start_version
        self._max_committed: Version = start_version
        self._epoch_start = loop.now()
        self._version_at_epoch = start_version
        self.stream = RequestStream(process, self.WLT, unique=True)
        # per-proxy reply cache keyed by request_num: a retried request_num
        # re-receives its own (prev, version) pair instead of burning a fresh
        # version (the reference's per-proxy requestNum dedup in getVersion).
        # Batches pipeline, so MANY request_nums can be in flight at once —
        # a single-entry cache would hand an old retry a newer batch's
        # versions (two batches sharing one commit version = lost writes).
        self._replies: dict[str, dict[int, GetCommitVersionReply]] = {}
        # highest request_num EVICTED from each proxy's cache after version
        # assignment: only those may be silently ignored (we can no longer
        # prove the retry wasn't already assigned a version).  A merely
        # lower-numbered fresh request is a legitimate out-of-order arrival
        # (pipelined batches retry independently) and gets a fresh version.
        self._evicted_upto: dict[str, int] = {}
        self._cache_cap = 4096
        self.process = process
        self.counters = CounterCollection("Sequencer")
        self.c_requests = self.counters.counter("version_requests")
        self.c_versions = self.counters.counter("versions_assigned")
        self._metrics_emitter = None
        self._task = loop.spawn(self._serve(), TaskPriority.GET_LIVE_VERSION, "sequencer")

    def _next_version(self) -> Version:
        # advance with the clock: version ≈ epoch_version + elapsed * rate
        # (masterserver getVersion ties versions to wall time x 1e6) — but
        # never more than MAX_VERSIONS_IN_FLIGHT past the newest committed
        # version the proxies have reported (the reference's backpressure:
        # a stalled commit pipeline must slow the version clock, or every
        # later batch throttles and the cluster spirals into recovery)
        target = self._version_at_epoch + int(
            (self.loop.now() - self._epoch_start) * self.knobs.VERSIONS_PER_SECOND
        )
        ceiling = self._max_committed + self.knobs.MAX_VERSIONS_IN_FLIGHT
        return max(self._last_assigned + 1, min(target, ceiling))

    async def _serve(self) -> None:
        while True:
            req = await self.stream.next()
            await maybe_delay(self.loop, "sequencer.delay_reply")
            r = req.payload
            assert isinstance(r, GetCommitVersionRequest)
            if r.committed_version > self._max_committed:
                self._max_committed = r.committed_version
            cache = self._replies.setdefault(r.requesting_proxy, {})
            cached = cache.get(r.request_num)
            if cached is not None:
                req.reply(cached)  # duplicate (proxy retry): same versions
                continue
            if r.request_num <= self._evicted_upto.get(r.requesting_proxy, -1):
                # retry of an EVICTED request: it may already hold a version;
                # assigning a fresh one would duplicate the batch.  Stay
                # silent — the proxy gives up and escalates to recovery.
                continue
            v = self._next_version()
            reply = GetCommitVersionReply(prev_version=self._last_assigned, version=v)
            self.c_requests.add(1)
            self.c_versions.add(v - self._last_assigned)
            for d in req.spans or ():
                # wire-propagated trace context: the version-assignment hop
                g_trace_batch.add("MasterServer.getCommitVersion", d)
            self._last_assigned = v
            cache[r.request_num] = reply
            while len(cache) > self._cache_cap:
                # evict the NUMERICALLY lowest request_num, not insertion
                # order: the watermark below must stay an exact boundary —
                # insertion-order eviction of an out-of-order high num
                # would drag the watermark up and silently drop fresh
                # lower-numbered requests that were never assigned
                evicted = min(cache)
                del cache[evicted]
                prev = self._evicted_upto.get(r.requesting_proxy, -1)
                self._evicted_upto[r.requesting_proxy] = max(prev, evicted)
            req.reply(reply)

    def start_metrics(self, trace, interval: float):
        """Periodic SequencerMetrics emission (version-assignment rates)."""
        if self._metrics_emitter is not None:
            self._metrics_emitter.cancel()

        def fields() -> dict:
            r = self.counters.rates(self.loop.now())
            return {
                "LastAssigned": self._last_assigned,
                "MaxCommitted": self._max_committed,
                "RequestsPerSec": r.get("version_requests", 0.0),
                "VersionsAssignedPerSec": r.get("versions_assigned", 0.0),
            }

        self._metrics_emitter = spawn_role_metrics(
            self.loop, self.process, trace, "SequencerMetrics", fields,
            interval, TaskPriority.GET_LIVE_VERSION,
        )
        return self._metrics_emitter

    def stop(self) -> None:
        self._task.cancel()
        if self._metrics_emitter is not None:
            self._metrics_emitter.cancel()
        self.stream.close()
