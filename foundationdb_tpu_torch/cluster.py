"""Cluster assembly: wire the write pipeline + storage into one simulated
cluster (the SimulatedCluster analog, fdbserver/SimulatedCluster.actor.cpp).

`SimCluster` builds the minimum end-to-end system of SURVEY §7 step 5:
sequencer + N resolvers (pluggable conflict backend) + M TLogs + storage
servers per key shard + a commit proxy, all as simulated processes on one
deterministic EventLoop.  `database()` hands back a client handle.

The control plane (coordinators, recruitment, recovery) layers on top in
control/; this module is also what benchmarks and workloads drive.

Copy of the reference package's module with one difference by design: with
`conflict_backend=None` each resolver hosts the port's
`DeviceConflictSet(device=device)`, so the conflict check runs on the CUDA
card unless the caller passes `device="cpu"`; without a card the default
raises, as `DeviceConflictSet` does.  (The reference's default is its
`OracleConflictSet`; the verdicts are the same either way.)
"""

from __future__ import annotations

from typing import Callable

from .client.transaction import ClusterView, Database
from .conflict.api import ConflictSet
from .conflict.device import DeviceConflictSet, resolve_device
from .roles.proxy import CommitProxy, KeyPartitionMap
from .roles.resolver import Resolver
from .roles.sequencer import Sequencer
from .roles.storage import MemoryKeyValueStore, StorageServer
from .roles.tlog import TLog
from .rpc.network import SimNetwork
from .rpc.stream import RequestStreamRef
from .runtime.core import DeterministicRandom, EventLoop
from .runtime.knobs import CoreKnobs
from .runtime.trace import TraceCollector


class SimCluster:
    def __init__(
        self,
        seed: int = 0,
        n_resolvers: int = 1,
        n_storage_shards: int = 1,
        n_tlogs: int = 1,
        conflict_backend: Callable[[], ConflictSet] | None = None,
        knobs: CoreKnobs | None = None,
        resolver_splits: list[bytes] | None = None,
        storage_splits: list[bytes] | None = None,
        device="cuda",
    ) -> None:
        make_cs = conflict_backend
        if make_cs is None:
            dev = resolve_device(device)  # raises without a card, before any role

            def make_cs():
                return DeviceConflictSet(device=dev)

        self.loop = EventLoop()
        self.rng = DeterministicRandom(seed)
        self.knobs = knobs or CoreKnobs()
        self.trace = TraceCollector(
            clock=self.loop.now, min_severity=self.knobs.TRACE_SEVERITY,
            # sim trace files stamp VIRTUAL wall time: a seed's rolled
            # trace output is byte-stable across reruns (flowlint wall-clock)
            wall_clock=self.loop.now,
        )
        from .runtime.trace import g_trace_batch, spawn_wire_metrics

        g_trace_batch.attach_clock(self.loop.now, self.trace)
        # Net2 slow-task watch: a run-loop callback stalling past the knob
        # (host wall) traces a SEV_WARN SlowTask into this collector
        self.loop.slow_task_trace = self.trace
        self.loop.slow_task_trace_threshold = self.knobs.SLOW_TASK_THRESHOLD
        self.net = SimNetwork(self.loop, self.rng, self.trace)
        self._wire_metrics_task = spawn_wire_metrics(
            self.loop, self.trace, self.net.wire,
            self.knobs.METRICS_INTERVAL, "sim",
        )

        # default splits: evenly spread single-byte prefixes
        def default_splits(n: int) -> list[bytes]:
            return [bytes([256 * i // n]) for i in range(1, n)]

        self.resolver_splits = (
            resolver_splits if resolver_splits is not None else default_splits(n_resolvers)
        )
        self.storage_splits = (
            storage_splits if storage_splits is not None else default_splits(n_storage_shards)
        )

        # -- processes & roles ------------------------------------------------
        self.seq_proc = self.net.create_process("sequencer")
        self.sequencer = Sequencer(self.seq_proc, self.loop, self.knobs)

        self.tlogs: list[TLog] = []
        for i in range(n_tlogs):
            p = self.net.create_process(f"tlog-{i}")
            self.tlogs.append(TLog(
                p, self.loop,
                hard_limit_bytes=self.knobs.TLOG_HARD_LIMIT_BYTES,
                trace=self.trace,
            ))

        self.resolvers: list[Resolver] = []
        for i in range(n_resolvers):
            p = self.net.create_process(f"resolver-{i}")
            self.resolvers.append(Resolver(p, self.loop, self.knobs, make_cs()))

        # storage shards: tag "ss-i" owned by storage server i, pulling from
        # tlog i % n_tlogs
        self.storage: list[StorageServer] = []
        for i in range(n_storage_shards):
            p = self.net.create_process(f"storage-{i}")
            tlog = self.tlogs[i % n_tlogs]
            ss = StorageServer(
                p,
                self.loop,
                self.knobs,
                tlog_peek_ref=self._ref(p, tlog.peek_stream.endpoint),
                tlog_pop_ref=self._ref(p, tlog.pop_stream.endpoint),
                tag=f"ss-{i}",
                store=MemoryKeyValueStore(),
            )
            self.storage.append(ss)

        self.proxy_proc = self.net.create_process("proxy")
        storage_tag_map = KeyPartitionMap(
            self.storage_splits, [[f"ss-{i}"] for i in range(n_storage_shards)]
        )
        self.proxy = CommitProxy(
            self.proxy_proc,
            self.loop,
            self.knobs,
            sequencer_ref=self._ref(self.proxy_proc, self.sequencer.stream.endpoint),
            resolver_refs=[
                self._ref(self.proxy_proc, r.stream.endpoint) for r in self.resolvers
            ],
            resolver_splits=self.resolver_splits,
            tlog_refs=[
                self._ref(self.proxy_proc, t.commit_stream.endpoint) for t in self.tlogs
            ],
            storage_tags=storage_tag_map,
            tag_to_tlogs={f"ss-{i}": [i % n_tlogs] for i in range(n_storage_shards)},
        )

        self.client_proc = self.net.create_process("client")
        self.client_dbs: list[Database] = []
        self._client_metric_tasks: list = []

        # the periodic *Metrics plane (runtime/trace.py spawn_role_metrics):
        # the statically-wired cluster starts every role's emitter itself —
        # the controller does this per generation in the full topology
        iv = self.knobs.METRICS_INTERVAL
        self.sequencer.start_metrics(self.trace, iv)
        self.proxy.start_metrics(self.trace, iv)
        for r in self.resolvers:
            r.start_metrics(self.trace, iv)
        for t in self.tlogs:
            t.start_metrics(self.trace, iv)
        for ss in self.storage:
            ss.start_metrics(self.trace, iv)

    def _ref(self, process, endpoint) -> RequestStreamRef:
        return RequestStreamRef(self.net, process, endpoint)

    def storage_teams(self):
        """Storage servers grouped per shard (single-replica teams)."""
        return [[ss] for ss in self.storage]

    def database(self, process=None) -> Database:
        proc = process or self.client_proc
        storage_members = [
            [
                {
                    "getvalue": self._ref(proc, ss.getvalue_stream.endpoint),
                    "getkeyvalues": self._ref(proc, ss.getkv_stream.endpoint),
                    "getkey": self._ref(proc, ss.getkey_stream.endpoint),
                    "watch": self._ref(proc, ss.watch_stream.endpoint),
                }
            ]
            for ss in self.storage
        ]
        view = ClusterView(
            grv_refs=[self._ref(proc, self.proxy.grv_stream.endpoint)],
            commit_refs=[self._ref(proc, self.proxy.commit_stream.endpoint)],
            storage_map=KeyPartitionMap(self.storage_splits, storage_members),
        )
        db = Database(self.loop, view, self.rng)
        # status + the periodic ClientMetrics plane see every handle
        self.client_dbs.append(db)
        self._client_metric_tasks.append(
            db.start_metrics(self.trace, self.knobs.METRICS_INTERVAL, proc)
        )
        return db

    def run_until(self, fut, deadline: float | None = None):
        return self.loop.run_until(fut, deadline)

    def stop(self) -> None:
        self._wire_metrics_task.cancel()
        for t in self._client_metric_tasks:
            t.cancel()
        self.loop.slow_task_trace = None
        self.proxy.stop()
        for r in self.resolvers:
            r.stop()
        for t in self.tlogs:
            t.stop()
        for s in self.storage:
            s.stop()
        self.sequencer.stop()
