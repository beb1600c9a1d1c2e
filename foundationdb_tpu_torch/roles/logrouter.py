"""Log router — the stream carrier of multi-region replication
(fdbserver/LogRouter.actor.cpp + the remote-region tLogs of
TagPartitionedLogSystem: log routers pull the primary's mutation stream
once across the DC boundary and re-serve it to the remote region's
consumers).

This router collapses the reference's router + remote-tLog pair into one
role: it pulls the FULL stream via its own tag (a full-stream consumer,
exactly like a backup worker), re-tags every mutation for the REMOTE
region's storage tags using the remote key map, and serves the standard
TLog peek/pop interface — so remote storage servers are ordinary
StorageServer instances that "rejoin" the router the way primary storage
rejoins primary TLogs.

Retention discipline: the router pops the PRIMARY's router tag only up to
the minimum of its remote consumers' pops, so a router crash never loses
un-replicated data — the primary retains it and a replacement router
re-pulls (the reference's router buffering contract).

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

import bisect

from .proxy import KeyPartitionMap
from .sequencer import NotifiedVersion
from .types import (
    TLogPeekReply,
    TLogPeekRequest,
    TLogPopRequest,
    Version,
)
from ..rpc.network import SimProcess
from ..rpc.stream import RequestStream
from ..runtime.core import BrokenPromise, EventLoop, TaskPriority, TimedOut
from ..runtime.trace import CounterCollection, spawn_role_metrics

ROUTER_TAG = "router-0"


class LogRouter:
    WLT_PEEK = "wlt:router_peek"
    WLT_POP = "wlt:router_pop"

    def __init__(self, process: SimProcess, loop: EventLoop,
                 remote_map: KeyPartitionMap, start_version: Version = 0,
                 replacement: bool = False) -> None:
        self.process = process
        self.loop = loop
        self.remote_map = remote_map  # key partition -> remote TEAM of tags
        self.tag = ROUTER_TAG
        # a replacement router (restart_log_router / a region reboot)
        # resumes the tag from the primary TLogs' RETAINED backlog — its
        # first successful re-pull is the observable the KillRegion
        # campaigns require coverage of
        self._replacement = replacement
        self._repull_marked = False
        self.tlog = None
        self.tlog_pops: list = []
        self._fetched = start_version
        self.version = NotifiedVersion(start_version)
        self.known_committed = start_version
        self._tags: dict[str, list] = {
            t: [] for team in remote_map.members for t in team
        }
        self._remote_pops: dict[str, Version] = {t: start_version for t in self._tags}
        self.counters = CounterCollection("LogRouter")
        self.c_entries = self.counters.counter("entries_relayed")
        self._metrics_emitter = None
        self.peek_stream = RequestStream(process, self.WLT_PEEK, unique=True)
        self.pop_stream = RequestStream(process, self.WLT_POP, unique=True)
        self._tasks = [
            loop.spawn(self._pull(), TaskPriority.STORAGE_SERVER, "router-pull"),
            loop.spawn(self._serve_peek(), TaskPriority.STORAGE_SERVER, "router-peek"),
            loop.spawn(self._serve_pop(), TaskPriority.STORAGE_SERVER, "router-pop"),
        ]

    # consumer interface for ClusterController._wire_stream_consumer
    def set_tlog_source(self, peek_ref, pop_refs: list) -> None:
        self.tlog = peek_ref
        self.tlog_pops = pop_refs

    async def _pull(self) -> None:
        from .types import MutationType

        while True:
            if self.tlog is None:
                await self.loop.delay(0.05, TaskPriority.STORAGE_SERVER)
                continue
            try:
                reply = await self.tlog.get_reply(
                    TLogPeekRequest(self.tag, self._fetched + 1), timeout=1.0
                )
            except (TimedOut, BrokenPromise):
                await self.loop.delay(0.1, TaskPriority.STORAGE_SERVER)
                continue
            self.known_committed = max(self.known_committed, reply.known_committed)
            if self._replacement and reply.entries and not self._repull_marked:
                from ..runtime.coverage import testcov

                self._repull_marked = True
                testcov("region.router_repull")
            for version, muts in reply.entries:
                if version <= self._fetched:
                    continue
                by_tag: dict[str, list] = {}
                for m in muts:
                    if m.type == MutationType.CLEAR_RANGE:
                        teams = self.remote_map.members_for_range(m.key, m.value)
                    else:
                        teams = [self.remote_map.member_for_key(m.key)]
                    for team in teams:
                        for t in team:
                            by_tag.setdefault(t, []).append(m)
                for t, tmuts in by_tag.items():
                    self._tags[t].append((version, tmuts))
                self.c_entries.add(1)
                self._fetched = version
                self.version.set(version)
            tail = reply.end_version - 1
            if tail > self._fetched:
                self._fetched = tail
                self.version.set(tail)
            # retain on the primary until every remote consumer is past it
            floor = min(self._remote_pops.values(), default=self._fetched)
            for pop in self.tlog_pops:
                pop.send(TLogPopRequest(self.tag, min(floor, self._fetched)))
            if not reply.entries:
                await self.loop.delay(0.01, TaskPriority.STORAGE_SERVER)

    async def _serve_peek(self) -> None:
        while True:
            req = await self.peek_stream.next()
            r: TLogPeekRequest = req.payload
            q = self._tags.get(r.tag, [])
            i = bisect.bisect_left(q, r.begin_version, key=lambda e: e[0])
            entries = q[i : i + 1000]
            truncated = i + 1000 < len(q)
            end = entries[-1][0] + 1 if truncated else self.version.get() + 1
            req.reply(
                TLogPeekReply(
                    entries=entries,
                    end_version=end,
                    known_committed=self.known_committed,
                )
            )

    async def _serve_pop(self) -> None:
        while True:
            req = await self.pop_stream.next()
            r: TLogPopRequest = req.payload
            cur = self._remote_pops.get(r.tag, 0)
            self._remote_pops[r.tag] = max(cur, r.upto_version)
            q = self._tags.get(r.tag, [])
            i = bisect.bisect_right(q, r.upto_version, key=lambda e: e[0])
            if i:
                self._tags[r.tag] = q[i:]
            req.reply(None)

    def start_metrics(self, trace, interval: float):
        """Periodic LogRouterMetrics emission (relay progress + retained
        backlog — the router buffering contract's observable)."""
        if self._metrics_emitter is not None:
            self._metrics_emitter.cancel()

        def fields() -> dict:
            r = self.counters.rates(self.loop.now())
            return {
                "Version": self.version.get(),
                "KnownCommitted": self.known_committed,
                "EntriesPerSec": r.get("entries_relayed", 0.0),
                "QueueDepth": sum(len(q) for q in self._tags.values()),
            }

        self._metrics_emitter = spawn_role_metrics(
            self.loop, self.process, trace, "LogRouterMetrics", fields,
            interval, TaskPriority.STORAGE_SERVER,
        )
        return self._metrics_emitter

    def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        if self._metrics_emitter is not None:
            self._metrics_emitter.cancel()
        self.peek_stream.close()
        self.pop_stream.close()
