"""RecoverableCluster: the full topology — coordinators + controller-managed
write pipeline + persistent storage servers — under one deterministic loop.

This is SimCluster's fault-tolerant sibling (the difference mirrors the
reference: SimCluster wires one static generation; here the
ClusterController owns generations and survives pipeline kills).

Copy of the reference package's module with one difference by design: with
`conflict_backend=None` every resolver of every generation (the first
boot's, each recovery's at the recovery version, and the ones a worker
recruits) hosts the port's `DeviceConflictSet(oldest, device=device)`, so
the conflict check runs on the CUDA card unless the caller passes
`device="cpu"`.  The device is resolved once, before any role: without a
card `RecoverableCluster()` raises, and there is no fallback to an oracle.
(The reference's default is its `OracleConflictSet`; the verdicts are the
same either way, so same-seed runs of the two packages compare.)
"""

from __future__ import annotations

from typing import Callable

from ..client.transaction import Database
from ..conflict.device import DeviceConflictSet, resolve_device
from ..roles.storage import MemoryKeyValueStore, StorageServer
from ..rpc.network import SimNetwork
from ..rpc.stream import RequestStreamRef
from ..runtime.core import (
    ActorCancelled,
    DeterministicRandom,
    EventLoop,
    TaskPriority,
    TimedOut,
)
from ..runtime.knobs import CoreKnobs
from ..runtime.trace import TraceCollector
from .controller import ClusterController
from .coordination import CoordinatedState, Coordinator


class RecoverableCluster:
    CLUSTER_FILE = "fdb.cluster"

    def __init__(
        self,
        seed: int = 0,
        n_resolvers: int = 1,
        n_storage_shards: int = 1,
        storage_replication: int = 2,  # team size: replicas per shard
        n_tlogs: int = 2,
        n_proxies: int = 2,   # multi-proxy by default, like the reference
        n_coordinators: int = 3,
        conflict_backend: Callable[..., object] | None = None,
        knobs: CoreKnobs | None = None,
        durable: bool = True,   # disk-backed TLogs/storage/coordinators
                                # (the DEFAULT, as in the reference: every
                                # simulation runs the durability model;
                                # durable=False is for conflict benches only)
        fs=None,                # SimFilesystem to reuse (cluster restart)
        restart: bool = False,  # bootstrap from fs contents
        chaos: bool = False,    # BUGGIFY fault injection + randomized knobs
                                # (the reference enables both in every sim
                                # run — flow/flow.h:65, Knobs.cpp:33-34).
                                # Module-global: the newest cluster's setting
                                # wins if two clusters are alive at once.
        storage_engine: str = "memory",  # "memory" (KeyValueStoreMemory
                                # analog: RAM + WAL) | "ssd" (append-only
                                # COW B+tree, disk-bounded memory — the
                                # configure(ssd) engine choice)
        n_machines: int = 0,    # >0: machine/DC topology (sim2 machine
                                # model) — roles spread over machines,
                                # replicas placed across machines AND DCs,
                                # correlated kills via net.kill_machine/_dc
        n_dcs: int = 2,         # DC labels when n_machines > 0
        n_workers: int = 0,     # >0: pipeline roles are RECRUITED onto a
                                # registered worker pool via RPC (the
                                # worker.actor.cpp bootstrap) and a
                                # fdbmonitor analog restarts dead workers;
                                # 0 = roles constructed directly
        trace_sink=None,        # file-like: trace events stream to it as
                                # JSONL (the reference's rolling trace files)
        trace_wall_clock=None,  # WallTime source for trace-file lines.
                                # None = the loop's virtual clock, so a
                                # seed's rolled traces are byte-stable
                                # across reruns (per-seed soak capture);
                                # a REAL deployment (tools/server.py)
                                # passes the host wall — cross-process
                                # trace joins need one shared clock
        debug_sample_rate: float = 0.0,  # fraction of every database()'s
                                # transactions given a pipeline-timeline
                                # debug ID (g_traceBatch sampling) — the
                                # per-seed artifact hook soak campaigns
                                # use so failing seeds carry joinable
                                # transaction timelines in their traces
        remote_region: bool = False,  # a second region: a log router pulls
                                # the full stream once and re-serves it to
                                # remote read replicas of every shard
                                # (LogRouter.actor.cpp + remote tLogs).
                                # Equivalent to usable_regions=2.
        usable_regions: int = 1,  # region-configuration bootstrap
                                # (control/region.py): 2 builds the remote
                                # plane AND makes the router tag part of
                                # the recovery durability contract; the
                                # committed `\xff/conf/` region rows (and
                                # a restart's recovered keyServers map)
                                # override this at runtime
        redundancy: str | None = None,  # declarative mode ("single"/"double"/
                                # "triple"/"three_datacenter"): sets the
                                # replication factor AND the placement policy
                                # teams are validated against (PolicyAcross,
                                # fdbrpc/ReplicationPolicy.h:121).  None =
                                # storage_replication with an across-machine
                                # policy when a machine topology exists.
        loop: EventLoop | None = None,  # reuse an external loop (the multi-
                                # OS-process server shares one loop between
                                # the sim world and its RealNetwork)
        external_cstate=None,   # CoordinatedState over REMOTE coordinator
                                # processes (tools/coordserver.py) instead
                                # of in-process Coordinator objects
        wall_driver=None,       # drives bootstrap futures against the wall
                                # clock WITH socket IO (rpc/transport.py
                                # NetDriver) — required with external_cstate,
                                # whose RPCs need the sockets pumped
        knob_overrides: dict | None = None,  # name -> value applied via
                                # set_knob AFTER knob construction (so it
                                # composes with chaos randomization) — the
                                # spec files' `knob.NAME=value` lines land
                                # here, the reference's --knob_ path
        device="cuda",          # the default backend's device (see above)
    ) -> None:
        make_cs = conflict_backend
        if make_cs is None:
            dev = resolve_device(device)  # raises without a card, before any role

            def make_cs(oldest=0):
                return DeviceConflictSet(oldest, device=dev)

        self.loop = loop or EventLoop()
        self.rng = DeterministicRandom(seed)
        from ..runtime import buggify as _buggify

        from ..runtime.knobs import ClientKnobs

        if chaos:
            _buggify.enable(self.rng)
            self.knobs = knobs or CoreKnobs(randomize=self.rng)
            self.client_knobs = ClientKnobs(randomize=self.rng)
        else:
            _buggify.disable()
            self.knobs = knobs or CoreKnobs()
            self.client_knobs = ClientKnobs()
        for _kname, _kval in (knob_overrides or {}).items():
            self.knobs.set_knob(_kname, str(_kval))
        self.trace = TraceCollector(
            clock=self.loop.now, sink=trace_sink,
            min_severity=self.knobs.TRACE_SEVERITY,
            wall_clock=trace_wall_clock or self.loop.now,
        )
        self.debug_sample_rate = debug_sample_rate
        self.client_dbs: list = []
        self._client_metric_tasks: list = []
        from ..runtime.trace import g_trace_batch, spawn_wire_metrics

        # the collector bind mirrors every pipeline station into the trace
        # stream (and thus the trace FILES a production server rolls) as
        # TransactionDebug events — the cross-process join key surface
        g_trace_batch.attach_clock(self.loop.now, self.trace)
        # Net2 slow-task watch: a run-loop callback stalling past the knob
        # (host wall) traces a SEV_WARN SlowTask into this collector
        self.loop.slow_task_trace = self.trace
        self.loop.slow_task_trace_threshold = self.knobs.SLOW_TASK_THRESHOLD
        self.net = SimNetwork(self.loop, self.rng, self.trace)
        self.fs = None
        if durable or fs is not None or restart:
            from ..storage.files import SimFilesystem

            if fs is not None:
                fs.reattach(self.loop, self.rng)
                self.fs = fs
            else:
                self.fs = SimFilesystem(self.loop, self.rng)
            # arm the io_timeout fail-fast + give the disks a trace handle
            # (IoTimeoutKilled events; worker-recruited TLogs also reach
            # the collector through fs.trace)
            self.fs.io_timeout_s = self.knobs.IO_TIMEOUT_S
            self.fs.trace = self.trace
            # the shared file-level page cache (storage/pagecache.py):
            # a FRESH pool per boot — cached pages belong to a process
            # lifetime, never to the disks (a restart image or power-kill
            # always comes back cold); PAGE_CACHE_BYTES=0 disables
            if self.knobs.PAGE_CACHE_BYTES > 0:
                from ..storage.pagecache import PageCachePool

                self.fs.page_pool = PageCachePool(
                    page_size=self.knobs.PAGE_CACHE_4K,
                    capacity_bytes=self.knobs.PAGE_CACHE_BYTES,
                    readahead_pages=self.knobs.READAHEAD_PAGES,
                )
            else:
                self.fs.page_pool = None

        def splits(n: int) -> list[bytes]:
            return [bytes([256 * i // n]) for i in range(1, n)]

        # machine/DC ring: machine m{i} lives in dc{i * n_dcs // n_machines}
        # (the first half of the machines in dc0, second in dc1, ...), so
        # the replica offset below places a team's copies in DIFFERENT DCs
        self.machines: list[tuple[str, str]] = [
            (f"m{i}", f"dc{i * n_dcs // n_machines}") for i in range(n_machines)
        ]

        def mach_spread(i: int, n: int) -> dict:
            """i-th of n same-kind roles, spread evenly over the ring (the
            coordinator quorum must straddle DCs like TLogs do) — the same
            policy ClusterController._new_proc(spread=...) applies to the
            pipeline roles it recruits."""
            if not self.machines:
                return {}
            m, d = self.machines[ClusterController.spread_slot(i, n, len(self.machines))]
            return {"machine": m, "dc": d}

        # declarative redundancy: the mode names both the factor and the
        # policy object every team must satisfy
        from ..rpc.policy import PolicyAcross, PolicyOne, policy_for_redundancy

        if redundancy is not None:
            self.replication_policy = policy_for_redundancy(redundancy)
            storage_replication = self.replication_policy.replicas()
        elif self.machines:
            self.replication_policy = (
                PolicyAcross(storage_replication, "machine")
                if storage_replication > 1 else PolicyOne()
            )
        else:
            self.replication_policy = PolicyOne()

        by_dc: dict[str, list[str]] = {}
        for m, d in self.machines:
            by_dc.setdefault(d, []).append(m)
        dc_names = sorted(by_dc)
        if self.machines and storage_replication > n_machines:
            raise ValueError(
                f"cannot place {storage_replication} replicas on "
                f"{n_machines} machines distinctly"
            )
        dc_of = dict(self.machines)

        def mach_replica(shard: int, r: int, used: set) -> dict:
            """Replica r of a shard goes to DC (r mod n_dcs), cycling
            machines within it; if the DC ring is exhausted (replication >
            machines-per-DC), fall back to the first machine not yet used
            by this shard — distinct machines for any config, distinct DCs
            whenever replication <= n_dcs."""
            if not self.machines:
                return {}
            d = dc_names[r % len(dc_names)]
            ring = by_dc[d]
            m = ring[(shard + r // len(dc_names)) % len(ring)]
            if m in used:
                m = next(
                    mm for mm, _dd in self.machines if mm not in used
                )
            used.add(m)
            return {"machine": m, "dc": dc_of[m]}

        self._initial_storage_splits = splits(n_storage_shards)
        resolver_splits = splits(n_resolvers)

        # cluster-file analog (fdbclient/MonitorLeader.actor.cpp fdb.cluster):
        # the durable pointer to the CURRENT coordinator quorum.  A restart
        # must find the quorum wherever a coordinators-change moved it, or
        # recovery would read empty registers and silently boot fresh.
        self._mach_spread = mach_spread
        self._wall_driver = wall_driver
        self._coord_quorum_gen = 0
        if external_cstate is not None:
            n_coordinators = 0  # the quorum lives in other OS processes
        coord_paths = [f"coord{i}.reg" for i in range(n_coordinators)]
        if restart and self.fs is not None and self.fs.exists(self.CLUSTER_FILE):
            import json as _json

            from ..storage.diskqueue import DiskQueue

            try:
                records = DiskQueue(self.fs.open(self.CLUSTER_FILE, None)).recover()
                doc = _json.loads(records[-1])
                coord_paths = list(doc["paths"])
                self._coord_quorum_gen = int(doc.get("gen", 0))
            except Exception:  # noqa: BLE001 — torn write: default quorum
                pass
        self.coordinators = [
            Coordinator(
                self.net.create_process(
                    f"coord-q{self._coord_quorum_gen}-{i}"
                    if self._coord_quorum_gen else f"coord-{i}",
                    **mach_spread(i, len(coord_paths)),
                ),
                self.loop, fs=self.fs, path=coord_paths[i],
            )
            for i in range(len(coord_paths))
        ]

        # storage servers persist across generations; each shard is served
        # by a TEAM of `storage_replication` servers, each with its own tag
        # (the reference's per-server Tag + keyServers teams)
        if storage_engine not in ("memory", "ssd"):
            raise ValueError(f"unknown storage_engine {storage_engine!r}")
        self.storage_engine = storage_engine

        def make_store(fname: str, p):
            if self.fs is None:
                return MemoryKeyValueStore()
            if storage_engine == "ssd":
                from ..storage.btree import BTreeKeyValueStore

                cls_ = BTreeKeyValueStore
            else:
                from ..storage.kvstore import DurableMemoryKeyValueStore

                cls_ = DurableMemoryKeyValueStore
            if restart:
                # a reboot must find the engine the disks were actually
                # written with: after an ONLINE engine swap (`configure
                # engine=`) the saved image holds the OTHER engine's
                # files, and recovering the configured engine against
                # their absence would silently boot EMPTY stores — then
                # resume the swap by re-fetching from equally-empty
                # teammates (review finding: acked-data loss).  Refuse
                # loudly; the operator boots with the engine the disks
                # name.
                mine = fname + ".hdr" if storage_engine == "ssd" else fname
                other = fname if storage_engine == "ssd" else fname + ".hdr"
                if not self.fs.exists(mine) and self.fs.exists(other):
                    raise ValueError(
                        f"storage engine mismatch on restart: {fname} "
                        f"holds "
                        f"{'memory' if storage_engine == 'ssd' else 'ssd'}"
                        f"-engine files but the boot names "
                        f"{storage_engine!r} (an online engine swap "
                        f"preceded the save — boot with the disks' engine)"
                    )
                return cls_.recover(self.fs, fname, p, **self._store_kwargs())
            return cls_(self.fs, fname, p, **self._store_kwargs())

        self.storage: list[StorageServer] = []
        for i in range(n_storage_shards):
            used_machines: set = set()
            for r in range(storage_replication):
                p = self.net.create_process(
                    f"storage-{i}r{r}", **mach_replica(i, r, used_machines)
                )
                store = make_store(f"ss{i}r{r}.kv", p)
                start_version = (
                    store.meta.get("durable_version", 0)
                    if self.fs is not None
                    else 0
                )
                # initial refs are dummies; the controller rewires on first recovery
                ss = StorageServer(
                    p, self.loop, self.knobs,
                    tlog_peek_ref=None, tlog_pop_ref=None,
                    tag=f"ss-{i}-r{r}", store=store,
                    start_version=start_version,
                )
                ss.start_metrics(self.trace, self.knobs.METRICS_INTERVAL)
                self.storage.append(ss)
        if self.machines:
            # the policy object VALIDATES what the placement formula built —
            # the team builder must refuse same-failure-domain teams
            # (ReplicationPolicy::validate over the team's LocalityData)
            from ..rpc.policy import Locality

            for i in range(n_storage_shards):
                team = self.storage[
                    i * storage_replication : (i + 1) * storage_replication
                ]
                locs = [Locality.of(ss.process) for ss in team]
                if not self.replication_policy.validate(locs):
                    raise ValueError(
                        f"shard {i} team violates replication policy "
                        f"{self.replication_policy!r}: {locs}"
                    )

        if external_cstate is not None:
            cstate = external_cstate
        else:
            cc_proc = self.net.create_process("cc-election")
            cstate = CoordinatedState(
                self.loop,
                [RequestStreamRef(self.net, cc_proc, c.read_stream.endpoint) for c in self.coordinators],
                [RequestStreamRef(self.net, cc_proc, c.write_stream.endpoint) for c in self.coordinators],
                owner="cc",
            )
        self.controller = ClusterController(
            self.loop, self.net, self.knobs, self.rng, self.trace,
            storage=self.storage,
            storage_splits=self._initial_storage_splits,
            conflict_backend=make_cs,
            resolver_splits=resolver_splits,
            n_tlogs=n_tlogs,
            n_proxies=n_proxies,
            cstate=cstate,
            fs=self.fs,
            restart=restart,
            machines=self.machines,
            expect_workers=n_workers > 0,
        )

        if external_cstate is None:
            # quorum moves only apply to in-process coordinators; a remote
            # quorum (tools/coordserver.py) is operated out-of-band
            self.controller.on_coordinators_change = self._change_coordinators
            self.controller._coordinator_count = len(self.coordinators)
        self.controller.replication_policy = self.replication_policy

        self.log_router = None
        self.remote_storage: list[StorageServer] = []
        self._n_storage_shards = n_storage_shards
        self._region_task = None          # a tracked mid-flight promotion
        self._region_promoted = False
        # birth/reboot remote planes carry a structurally complete stream
        # (the router consumer predates generation 1); an ONLINE enable
        # flips this False until its history fetch lands
        self._remote_history_complete = True
        self.controller.on_region_change = self._on_region_change
        if remote_region or usable_regions >= 2:
            # BEFORE the boot recovery: a promoted reboot must resolve
            # remote tags in the recovered keyServers map, and the router
            # consumer must be registered before the first TLog seed filter
            self._prepare_remote_region(restart)

        # worker pool + fdbmonitor analog (fdbmonitor/fdbmonitor.cpp: the
        # supervisor that restarts dead fdbserver processes; here a dead
        # worker gets a fresh process that re-registers with the CC)
        from ..roles.worker import Worker

        self.workers: list[Worker] = []
        self._worker_classes: list[str] = []
        if n_workers > 0:
            reg_ep = self.controller._register_stream.endpoint
            classes = (
                ["transaction"] * n_tlogs
                + ["stateless"] * (n_proxies + len(resolver_splits) + 2)
            )
            for i in range(n_workers):
                pclass = classes[i] if i < len(classes) else "stateless"
                self._worker_classes.append(pclass)
                self.workers.append(self._spawn_worker(i, pclass, reg_ep))
            self._monitor_task = self.loop.spawn(
                self._fdbmonitor(reg_ep), 0, "fdbmonitor"
            )
        boot = self.loop.spawn(self.controller.start())
        if self._wall_driver is not None:
            # remote-cstate RPCs need their sockets pumped during bootstrap
            self._wall_driver.run_until(boot, wall_timeout=60.0)
        else:
            self.loop.run_until(boot, 30.0)
        from .ratekeeper import Ratekeeper

        self.ratekeeper = Ratekeeper(
            self.loop, self.knobs, self.storage,
            tlogs_fn=lambda: (
                self.controller.generation.tlogs if self.controller.generation else []
            ),
            trace=self.trace,
        )
        self.controller.ratekeeper = self.ratekeeper
        # generation 1 was recruited before the ratekeeper existed
        for p in self.controller.generation.proxies:
            p.ratekeeper = self.ratekeeper

        from .distribution import DataDistributor

        def _heal_store(tag: str, proc):
            """A replacement server takes over the dead one's store FILE as
            well as its tag: the restart path recovers per-tag `ss{i}r{r}.kv`
            names, so the healed data must live there, and the dead file's
            durable prefix is a head start the snapshot fetch grounds over.
            A FRESH create (no recoverable file of the current engine —
            notably mid-engine-swap) deletes the OTHER engine's leftover
            files first: appending a new store's records into a stale
            other-format file would corrupt both lineages."""
            if self.fs is not None:
                if self.storage_engine == "ssd":
                    from ..storage.btree import BTreeKeyValueStore as cls_
                else:
                    from ..storage.kvstore import DurableMemoryKeyValueStore as cls_

                shard, rep = ClusterController._parse_tag(tag)
                if tag.startswith("remote-"):
                    path = f"remote{shard}.kv"  # promoted-region lineage
                else:
                    path = f"ss{shard}r{rep}.kv"
                if self.fs.exists(path if self.storage_engine != "ssd" else path + ".hdr"):
                    return cls_.recover(self.fs, path, proc,
                                        **self._store_kwargs())
                for stale in (path, path + ".a", path + ".b", path + ".hdr"):
                    self.fs.delete(stale)
                return cls_(self.fs, path, proc, **self._store_kwargs())
            return MemoryKeyValueStore()

        self.dd = DataDistributor(
            self.loop, self.net, self.knobs, self.controller,
            store_factory=_heal_store,
        )
        # `configure redundancy=` flips replication online through data
        # distribution (add/remove one replica per conf poll until converged)
        self.controller.on_redundancy_change = self.dd.converge_redundancy
        # `configure engine=` migrates storage replica-by-replica through
        # the dd heal path; applied is recorded only on full convergence
        # so a failed half-migration keeps reading as drift and resumes
        self._engine_applied = self.storage_engine
        self.controller.on_engine_change = self.swap_storage_engine
        self.controller.applied_engine = lambda: self._engine_applied
        # spawned LAST: an __init__ that raises above (team policy refusals,
        # bad config) must not leak a never-started emitter task — nothing
        # would ever cancel it
        self._wire_metrics_task = spawn_wire_metrics(
            self.loop, self.trace, self.net.wire,
            self.knobs.METRICS_INTERVAL, "sim",
        )

    async def _change_coordinators(self, n: int) -> bool:
        """Coordinator-set change (ManagementAPI changeQuorum via
        `\\xff/conf/coordinators`; the reference's MovableCoordinatedState,
        fdbserver/CoordinatedState.actor.cpp:461): read the current cstate,
        write it into a FRESH register quorum, durably repoint the cluster
        file, swap the controller's refs, retire the old set.  The old
        quorum's registers stay on disk until the cluster file names the
        new one — a crash mid-change recovers whichever quorum the file
        points at, both of which hold the state."""
        cc = self.controller
        if len(self.coordinators) == n:
            return True
        state, _gen = await cc.cstate.read()
        self._coord_quorum_gen += 1
        # flowlint: ok stale-read-across-await (g is THIS change's quorum number by construction; the conf watch runs one change at a time)
        g = self._coord_quorum_gen
        paths = [f"coord{i}-q{g}.reg" for i in range(n)]
        new_coords = [
            Coordinator(
                self.net.create_process(
                    f"coord-q{g}-{i}", **self._mach_spread(i, n)
                ),
                self.loop, fs=self.fs, path=paths[i],
            )
            for i in range(n)
        ]
        proc = cc._cc_proc()
        new_cstate = CoordinatedState(
            self.loop,
            [RequestStreamRef(self.net, proc, c.read_stream.endpoint) for c in new_coords],
            [RequestStreamRef(self.net, proc, c.write_stream.endpoint) for c in new_coords],
            owner="cc",
        )
        if state is not None and not await new_cstate.write(state):
            for c in new_coords:
                c.stop()
            return False
        if self.fs is not None:
            import json as _json

            from ..storage.diskqueue import DiskQueue

            dq = DiskQueue(self.fs.open(self.CLUSTER_FILE, proc))
            dq.rewrite([_json.dumps({"gen": g, "paths": paths}).encode()])
            await dq.sync()
        old = self.coordinators
        self.coordinators = new_coords
        cc.cstate = new_cstate
        for c in old:
            c.stop()
        return True

    def _spawn_worker(self, idx: int, pclass: str, reg_ep):
        from ..roles.worker import Worker
        from ..rpc.stream import RequestStreamRef as _Ref

        extra = {}
        if self.machines:
            m, d = self.machines[idx % len(self.machines)]
            extra = {"machine": m, "dc": d}
        proc = self.net.create_process(
            f"worker-{idx}-{self.rng.random_unique_id()[:4]}", **extra
        )
        return Worker(
            proc, self.loop, self.knobs,
            register_ref=_Ref(self.net, proc, reg_ep),
            process_class=pclass, fs=self.fs,
        )

    async def _fdbmonitor(self, reg_ep) -> None:
        """Restart dead workers with fresh processes (fdbmonitor's restart
        loop); the replacement re-registers and becomes recruitable."""
        while True:
            await self.loop.delay(1.0)
            for i, w in enumerate(self.workers):
                if not w.process.alive:
                    w.stop()
                    self.workers[i] = self._spawn_worker(
                        i, self._worker_classes[i], reg_ep
                    )

    def _prepare_remote_region(self, restart: bool,
                               register_router: bool = True) -> None:
        """Build the second region BEFORE the boot recovery (the
        region-configuration bootstrap, control/region.py):

          * remote replicas first, so a restart whose recovered keyServers
            map names remote tags — the cluster had already failed over
            when it was power-killed — resolves them instead of silently
            falling back to the tag-convention map (which would boot the
            WRONG serving set against the promoted disks),
          * on a promoted reboot the replicas join the controller's
            serving set and no router is built (the relay ended with the
            failover); otherwise the router is registered as a full-stream
            consumer so generation 1 (and a restart's disk recovery)
            carries its tag from the start,
          * the controller's in-memory region config reflects the built
            topology until the recovered `\\xff/conf/` rows override it.
        """
        from ..rpc.stream import RequestStreamRef as _Ref
        from .region import RegionConfiguration

        cc = self.controller
        n = self._n_storage_shards
        self.remote_storage = []
        for i in range(n):
            p = self.net.create_process(f"remote-storage-{i}")
            # recover-if-exists: right for every entry path (fresh cluster,
            # reboot, and an online enable over previously saved disks)
            store = self._make_store_recover(f"remote{i}.kv", p)
            ss = StorageServer(
                p, self.loop, self.knobs,
                tlog_peek_ref=None, tlog_pop_ref=None,
                tag=f"remote-{i}-r0", store=store,
                start_version=(
                    store.meta.get("durable_version", 0)
                    if self.fs is not None else 0
                ),
            )
            ss.start_metrics(self.trace, self.knobs.METRICS_INTERVAL)
            self.remote_storage.append(ss)
        promoted = False
        if restart and self.fs is not None and self.fs.exists(cc.KEYSERVERS_PATH):
            from .region import teams_promoted

            for ss in self.remote_storage:
                cc._tag_to_ss.setdefault(ss.tag, ss)
            cc._recover_key_servers()
            promoted = teams_promoted(cc.storage_teams_tags)
        self._region_promoted = promoted
        primary = "primary"
        if promoted:
            from ..runtime.coverage import testcov

            testcov("region.promoted_reboot")
            primary = "remote"
            # the promoted replicas ARE the serving set: recovery's
            # required tags and the boot _rewire must cover them
            for ss in self.remote_storage:
                cc._tag_to_ss[ss.tag] = ss
                if ss not in cc.storage:
                    cc.storage.append(ss)
        else:
            # register_router=False: the ONLINE enable path must instead
            # go through enable_stream_consumer's drain barrier (which
            # tags the live proxies and wires the TLog source)
            self._build_log_router(register=register_router)
            for ss in self.remote_storage:
                ss.set_tlog_source(
                    _Ref(self.net, ss.process, self.log_router.peek_stream.endpoint),
                    _Ref(self.net, ss.process, self.log_router.pop_stream.endpoint),
                )
        # the conf watch can read `\xff/conf/` through the remote replica
        # of its shard when the whole primary region is dead (`\xff` sorts
        # into the last shard)
        cc.conf_fallback_servers = self.remote_storage[-1:]
        cc.region_config = RegionConfiguration(
            usable_regions=2, primary=primary
        )

    def _build_log_router(self, replacement: bool = False,
                          register: bool = True) -> None:
        from ..roles.logrouter import ROUTER_TAG, LogRouter
        from ..roles.proxy import KeyPartitionMap

        splits = self._initial_storage_splits
        remote_tags = [[s.tag] for s in self.remote_storage] or [
            [f"remote-{i}-r0"] for i in range(len(splits) + 1)
        ]
        suffix = (
            f"-{self.rng.random_unique_id()[:4]}" if replacement else "-0"
        )
        rproc = self.net.create_process(f"log-router{suffix}")
        self.log_router = LogRouter(
            rproc, self.loop, KeyPartitionMap(list(splits), remote_tags),
            replacement=replacement,
        )
        self.log_router.start_metrics(self.trace, self.knobs.METRICS_INTERVAL)
        if register:
            self.controller.stream_consumers[ROUTER_TAG] = self.log_router

    def restart_log_router(self) -> None:
        """Replace a dead log router with a fresh one on a new process —
        the worker-restart path for the router role (a SimProcess reboot
        comes back with EMPTY endpoints, so the role object must be
        rebuilt and rewired, exactly like fdbmonitor restarting a worker).
        The new router resumes the ROUTER tag from the TLogs' retained
        backlog (nothing was popped while the old one was dark) and the
        remote replicas re-point at its streams."""
        from ..roles.logrouter import ROUTER_TAG
        from ..rpc.stream import RequestStreamRef as _Ref

        if self.log_router is not None:
            self.log_router.stop()
        self._build_log_router(replacement=True)
        cc = self.controller
        gen = cc.generation
        if gen is not None:
            cc._wire_stream_consumer(gen, ROUTER_TAG)
        for ss in self.remote_storage:
            ss.set_tlog_source(
                _Ref(self.net, ss.process, self.log_router.peek_stream.endpoint),
                _Ref(self.net, ss.process, self.log_router.pop_stream.endpoint),
            )

    def restart_remote_region(self) -> None:
        """Reboot a power-killed remote region from its disks (the
        KillRegion remote-kill recovery path): every dead remote replica is
        rebuilt from its store file's durable prefix — the power kill
        already dropped the un-fsynced tail — and a replacement router
        resumes the ROUTER tag from the primary TLogs' retained backlog
        (the router pops only at the remote-durable floor, so nothing a
        dead replica had not made durable was ever released).  Zero
        committed-data loss is structural: durable prefix + retained relay
        covers every acked commit."""
        from ..runtime.coverage import testcov

        assert not self._region_promoted, (
            "a promoted region's replicas heal through data distribution"
        )
        for i, old in enumerate(self.remote_storage):
            if old.process.alive:
                continue
            old.stop()
            p = self.net.create_process(
                f"remote-storage-{i}-{self.rng.random_unique_id()[:4]}"
            )
            store = self._make_store_recover(f"remote{i}.kv", p)
            ss = StorageServer(
                p, self.loop, self.knobs,
                tlog_peek_ref=None, tlog_pop_ref=None,
                tag=old.tag, store=store,
                start_version=(
                    store.meta.get("durable_version", 0)
                    if self.fs is not None else 0
                ),
            )
            ss.start_metrics(self.trace, self.knobs.METRICS_INTERVAL)
            self.remote_storage[i] = ss
        self.controller.conf_fallback_servers = self.remote_storage[-1:]
        # the router last: its remote map and the replicas' stream refs
        # must see the REBUILT set
        self.restart_log_router()
        testcov("region.remote_rebuilt")
        self.trace.trace(
            "RemoteRegionRestarted",
            Tags=[s.tag for s in self.remote_storage],
        )

    def _store_kwargs(self) -> dict:
        """Engine-specific store constructor kwargs: the ssd engine's
        parsed-page cache budget rides the BTREE_CACHE_BYTES knob (the
        saturation harness shrinks it to push reads down to the file
        layer)."""
        if self.storage_engine == "ssd":
            return {"cache_bytes": self.knobs.BTREE_CACHE_BYTES}
        return {}

    def _make_store_recover(self, fname: str, proc):
        """A store over `fname`, recovering the durable contents if the
        file exists (the region-reboot twin of __init__'s make_store)."""
        if self.fs is None:
            return MemoryKeyValueStore()
        if self.storage_engine == "ssd":
            from ..storage.btree import BTreeKeyValueStore as cls_

            probe = fname + ".hdr"
        else:
            from ..storage.kvstore import DurableMemoryKeyValueStore as cls_

            probe = fname
        if self.fs.exists(probe):
            return cls_.recover(self.fs, fname, proc, **self._store_kwargs())
        return cls_(self.fs, fname, proc, **self._store_kwargs())

    async def _enable_remote_region_online(self) -> None:
        """usable_regions 1→2 on a LIVE cluster: build the relay plane,
        wire it through enable_stream_consumer — the drain barrier that
        tags every future commit with the router tag, sets the router's
        TLog source, and hands back the boundary version — then
        snapshot-fetch everything BELOW the boundary into the new
        replicas from the primary teams (fetchKeys buffers tagged
        mutations that race the copy, exactly like a dd heal).  Only once
        the copies land is the region a failover candidate
        (`_remote_history_complete`)."""
        from ..roles.logrouter import ROUTER_TAG
        from ..runtime.combinators import wait_all
        from ..rpc.stream import RequestStreamRef as _Ref

        cc = self.controller
        if not self.remote_storage:
            self._remote_history_complete = False
            applied = cc.region_config
            self._prepare_remote_region(restart=False, register_router=False)
            # _prepare's config assignment is for the BIRTH path; here the
            # APPLIED config is recorded by the region step only once the
            # whole enable (fetch included) succeeds — otherwise a failed
            # enable would read as no-drift and never be retried
            cc.region_config = applied
            while True:
                vm = await cc.enable_stream_consumer(
                    ROUTER_TAG, self.log_router
                )
                if vm is not None:
                    break
                await self.loop.delay(0.1, TaskPriority.COORDINATION)
        else:
            # resuming a half-enabled region (the history fetch failed —
            # e.g. a source died mid-copy): the relay is already live, so
            # refetch below the CURRENT frontier; stream mutations racing
            # the copy are buffered by fetchKeys as usual
            vm = 0

        def min_end(a, b):
            if a is None:
                return b
            if b is None:
                return a
            return min(a, b)

        ib = [b""] + list(self._initial_storage_splits) + [None]
        bounds = [b""] + list(cc.storage_splits) + [None]
        futs = []
        for i, ss in enumerate(self.remote_storage):
            for j, team in enumerate(cc._storage_teams()):
                lo = max(ib[i], bounds[j])
                hi = min_end(ib[i + 1], bounds[j + 1])
                if hi is not None and lo >= hi:
                    continue
                refs = [
                    _Ref(self.net, ss.process, src.getkv_stream.endpoint)
                    for src in team
                ]
                futs.append(ss.start_fetch(lo, hi, vm, refs))
        # failures bubble to the region step: region_config keeps its
        # applied value, so the next conf poll re-detects the drift and
        # resumes HERE; the failover gate refuses until the copy lands
        await wait_all(futs)
        self._remote_history_complete = True
        self.trace.trace(
            "RemoteRegionEnabled", Boundary=vm,
            Replicas=[s.tag for s in self.remote_storage],
        )

    async def _on_region_change(self, new, old) -> bool:
        """The controller's region-configuration hook (one change, driven
        by the conf watch's background region step): build the second
        region online, run the configure-driven failover, or tear the
        relay plane down.  Returns False when the change cannot apply yet
        (the next conf poll retries)."""
        from ..runtime.coverage import testcov

        if new.usable_regions >= 2 and (
            not self.remote_storage or not self._remote_history_complete
        ):
            await self._enable_remote_region_online()
            testcov("region.enabled_online")
        if new.primary == "remote" and not self._region_promoted:
            if not self.remote_storage or not self._remote_history_complete:
                # nothing to fail over to (yet): no remote plane, or an
                # online enable whose history copy has not landed —
                # promoting would serve a region missing committed data
                return False
            testcov("region.failover_configured")
            if not await self.promote_remote_region():
                return False
        if (
            new.usable_regions < 2
            and new.primary == "primary"
            and not self._region_promoted
            and self.log_router is not None
        ):
            # drop the relay plane: the remote region leaves the
            # durability story (configure usable_regions=1)
            from ..roles.logrouter import ROUTER_TAG

            await self.controller.disable_stream_consumer(ROUTER_TAG)
            self.log_router.stop()
            self.log_router = None
            for ss in self.remote_storage:
                ss.stop()
            self.remote_storage = []
            self.controller.conf_fallback_servers = []
            testcov("region.disabled_online")
        return True

    async def promote_remote_region(self) -> bool:
        """Region failover, tracked: the body runs as a task `stop()` can
        cancel — a mid-flight promotion's convergence wait must die with
        the cluster, never keep rewiring a stopped topology.  The
        cancellation propagates to the caller as ActorCancelled."""
        t = self.loop.spawn(
            self._promote_remote_region(), TaskPriority.COORDINATION,
            "region-promote",
        )
        self._region_task = t
        try:
            return await t
        except ActorCancelled:
            raise  # a cancelled promotion is teardown — never report False
        finally:
            self._region_task = None

    async def _promote_remote_region(self) -> bool:
        """Region failover's write half: adopt the remote replicas as the
        PRIMARY storage set.  The keyServers map swaps to the remote tags
        at a drained boundary, the remote servers re-point their pulls from
        the log router to the primary TLogs (they rejoin by tag, like any
        storage server), and clients' views refresh — writes and reads now
        flow through the former read replicas.  The reference's fearless
        failover does this via region configuration + DD; the drained map
        swap is this runtime's equivalent serialization point."""
        cc = self.controller
        for ss in self.remote_storage:
            # ping responder FIRST: the moment a replica joins cc.storage
            # the dd heal loop starts pinging it, and an unregistered pong
            # endpoint reads as a dead server — dd would "heal" the very
            # replica being promoted, stopping the only holder of the
            # not-yet-durable window (found by KillRegionRestart seed 7711)
            self.dd._watch(ss)
            cc._tag_to_ss[ss.tag] = ss
            if ss not in cc.storage:
                cc.storage.append(ss)
        splits = list(self._initial_storage_splits)
        teams = [[f"remote-{i}-r0"] for i in range(len(splits) + 1)]
        vm = await cc.install_storage_assignment(splits, teams)
        if vm is None:
            return False
        await cc.persist_key_servers(splits, teams)
        # versions <= vm exist only in the router's relay; the router keeps
        # relaying until every promoted server is PAST the boundary, and
        # only then do they rejoin the primary TLogs (whose remote-tag
        # entries start at vm) — no version gap at the handoff.
        # Each poll re-resolves the replica from the LIVE region set: the
        # set can be rebuilt mid-wait (restart_remote_region replaces a
        # power-killed replica's object in place), and a wait pinned to the
        # pre-rebuild object would watch a dead server's frozen version
        # forever (flowcheck mutate-while-iterating audit; regression-pinned
        # by test_promotion_survives_remote_region_rebuild_mid_wait).
        for tag in [ss.tag for ss in self.remote_storage]:
            while True:
                ss = next(
                    (s for s in self.remote_storage if s.tag == tag), None
                )
                if ss is None or ss.version.get() >= vm:
                    break
                await self.loop.delay(0.05)
        gen = cc.generation
        from ..roles.logrouter import ROUTER_TAG
        from ..rpc.stream import RequestStreamRef as _Ref

        for ss in list(self.remote_storage):
            # re-register through the controller map: a replica rebuilt
            # during the convergence wait must displace its dead
            # predecessor in cc.storage, or the heal loop and the router
            # retirement keep watching the corpse
            prev = cc._tag_to_ss.get(ss.tag)
            if prev is not None and prev is not ss and prev in cc.storage:
                cc.storage[cc.storage.index(prev)] = ss
            elif ss not in cc.storage:
                cc.storage.append(ss)
            cc._tag_to_ss[ss.tag] = ss
            self.dd._watch(ss)
            tlog = gen.tlogs[cc._tag_tlogs(ss.tag)[0]]
            ss.set_tlog_source(
                _Ref(self.net, ss.process, tlog.peek_stream.endpoint),
                _Ref(self.net, ss.process, tlog.pop_stream.endpoint),
            )
        # the router tag may only be RELEASED once every promoted replica
        # has made the pre-boundary stream durable: until then the retained
        # backlog is the only TLog copy a reboot could re-serve them (the
        # MVCC window holds their disks back from vm for seconds) — a
        # background retirement watches the durability floor; meanwhile the
        # tag stays registered, so recoveries keep re-seeding it and a
        # power kill lands on the promoted-reboot remap path instead of on
        # lost data (found by KillRegionRestart seed 7711: acked commits
        # died with an eagerly-popped router tag)
        self._router_retire_task = self.loop.spawn(
            self._retire_router(vm), TaskPriority.COORDINATION,
            "region-router-retire",
        )
        for view in cc.views:
            if getattr(view, "pinned_smap", None) is None:
                cc._fill_view(view)
        self._region_promoted = True
        self.trace.trace("RegionPromoted", Tags=[s.tag for s in self.remote_storage])
        return True

    async def _retire_router(self, vm) -> None:
        """Drop the router plane once the promoted replicas' DURABLE
        versions pass the promotion boundary (read through the controller
        map: data distribution may heal a promoted replica mid-wait)."""
        from ..roles.logrouter import ROUTER_TAG
        from ..runtime.coverage import testcov

        cc = self.controller
        tags = [ss.tag for ss in self.remote_storage]
        while True:
            servers = [cc._tag_to_ss.get(t) for t in tags]
            if all(s is not None and s.durable_version >= vm for s in servers):
                break
            await self.loop.delay(0.25, TaskPriority.COORDINATION)
        await cc.disable_stream_consumer(ROUTER_TAG)
        if self.log_router is not None:
            self.log_router.stop()
            self.log_router = None
        testcov("region.router_retired")
        self.trace.trace("RegionRouterRetired", Boundary=vm)

    async def swap_storage_engine(self, engine: str) -> None:
        """Online storage-engine migration (the reference's `configure
        ssd`/`memory`: the database re-replicates onto the new engine
        while serving traffic).  One replica at a time: kill the replica's
        process and let data distribution heal it — the replacement store
        is built with the NEW engine (`storage_engine` flips first, the
        heal factory reads it) and fetchKeys re-replicates the data from
        live teammates.  Sequential by construction, so a team always
        keeps a live source; resumable — already-converged replicas are
        skipped, and the controller records the APPLIED engine only when
        every replica matches."""
        from ..runtime.combinators import timeout_error
        from ..runtime.coverage import testcov

        if engine not in ("memory", "ssd"):
            raise ValueError(f"unknown storage engine {engine!r}")
        if self.fs is None:
            raise ValueError("engine swap needs a durable cluster")
        if engine == "ssd":
            from ..storage.btree import BTreeKeyValueStore as target_cls
        else:
            from ..storage.kvstore import DurableMemoryKeyValueStore as target_cls
        cc = self.controller
        if any(len(team) < 2 for team in cc.storage_teams_tags):
            raise ValueError(
                "engine swap needs replication >= 2: the migrating "
                "replica's data is re-fetched from live teammates"
            )
        self.storage_engine = engine
        for tag in [t for team in cc.storage_teams_tags for t in team]:
            old = cc._tag_to_ss.get(tag)
            if old is None or type(old.store) is target_cls:
                continue  # already on the target engine (resume path)
            old.process.kill()
            testcov("configure.engine_replica_killed")

            async def healed(tag=tag, old=old) -> None:
                while True:
                    cur = cc._tag_to_ss.get(tag)
                    if (
                        cur is not None and cur is not old
                        and cur.process.alive
                        and type(cur.store) is target_cls
                    ):
                        return
                    await self.loop.delay(0.1, TaskPriority.COORDINATION)

            # bounded: a wedged heal must surface as a failed swap the
            # next conf poll resumes, not hang the engine step forever
            t = self.loop.spawn(
                healed(), TaskPriority.COORDINATION, f"engine-heal-{tag}"
            )
            try:
                await timeout_error(self.loop, t, 60.0)
            except TimedOut:
                t.cancel()
                raise
        self._engine_applied = engine
        testcov("configure.engine_converged")
        self.trace.trace(
            "StorageEngineSwapped", Engine=engine,
            Replicas=len(cc.storage),
        )

    def remote_database(self) -> Database:
        """A client view whose READS route to the remote region's replicas
        (GRV/commits still go to the primary pipeline — the remote region
        is a read replica set, not a write quorum)."""
        from ..roles.proxy import KeyPartitionMap

        proc = self.net.create_process(
            f"remote-client-{self.rng.random_unique_id()[:6]}"
        )
        view = self.controller.make_view(proc)
        from ..rpc.stream import RequestStreamRef as _Ref

        view.pinned_smap = KeyPartitionMap(
            list(self._initial_storage_splits),
            [
                [{
                    "getvalue": _Ref(self.net, proc, ss.getvalue_stream.endpoint),
                    "getkeyvalues": _Ref(self.net, proc, ss.getkv_stream.endpoint),
                    "getkey": _Ref(self.net, proc, ss.getkey_stream.endpoint),
                    "watch": _Ref(self.net, proc, ss.watch_stream.endpoint),
                }]
                for ss in self.remote_storage
            ],
        )
        view.smap = view.pinned_smap
        db = Database(self.loop, view, self.rng,
                      client_knobs=self.client_knobs)
        self.client_dbs.append(db)
        self._client_metric_tasks.append(
            db.start_metrics(self.trace, self.knobs.METRICS_INTERVAL, proc)
        )
        return db

    @property
    def storage_splits(self) -> list[bytes]:
        """The LIVE shard boundaries (data distribution mutates them)."""
        return self.controller.storage_splits

    def storage_teams(self):
        """Storage servers grouped per shard (replicas in replica order)."""
        return self.controller._storage_teams()

    def database(self) -> Database:
        proc = self.net.create_process(f"client-{self.rng.random_unique_id()[:6]}")
        view = self.controller.make_view(proc)

        def _status_json() -> bytes:
            import json

            from .status import cluster_status

            return json.dumps(cluster_status(self), default=str).encode()

        def _timeline_json() -> bytes:
            import json

            from ..tools.timeline import timeline_dump

            return json.dumps(timeline_dump(), default=str).encode()

        # special key space handlers (SpecialKeySpace.actor.cpp): the
        # status-client path reads \xff\xff/status/json like any key; the
        # timeline key scrapes every sampled transaction's station journey
        view.special_keys = {
            b"\xff\xff/status/json": _status_json,
            b"\xff\xff/timeline/json": _timeline_json,
        }

        # range modules — the readable SystemData vocabulary
        # (fdbclient/SystemData.cpp keyServersPrefix / excludedServersPrefix
        # / serverListKeys re-designed as \xff\xff modules: the authoritative
        # state lives in the controller, these views read it like keys)
        def _keyservers_rows():
            cc = self.controller
            bounds = [b""] + list(cc.storage_splits)
            return [
                (b"\xff\xff/keyservers/" + bounds[i],
                 b",".join(t.encode() for t in team))
                for i, team in enumerate(cc.storage_teams_tags)
            ]

        def _excluded_rows():
            return [
                (b"\xff\xff/excluded/" + t.encode(), b"1")
                for t in sorted(self.controller.excluded_targets)
            ]

        def _serverlist_rows():
            cc = self.controller
            return [
                (b"\xff\xff/server_list/" + tag.encode(),
                 f"{ss.process.name}@{ss.process.address.ip}:"
                 f"{ss.process.address.port}".encode())
                for tag, ss in sorted(cc._tag_to_ss.items())
            ]

        def _metrics_rows():
            # the load-metric plane as a readable range (\xff\xff/metrics/):
            # one row per shard at its begin key, value = the sampled
            # waitMetrics estimate (bytes + bandwidth + serving team) —
            # clients read shard load like any other key range
            import json

            dd = getattr(self, "dd", None)
            if dd is None:
                return []
            try:
                load = dd.shard_load()
            except KeyError:
                return []  # keyServers map churning mid-read
            return [
                (b"\xff\xff/metrics/" + m["begin"],
                 json.dumps({
                     "end": repr(m["end"]) if m["end"] is not None else None,
                     "bytes": m["bytes"],
                     "bytes_read_per_ksec":
                         round(m["bytes_read_per_ksec"], 1),
                     "bytes_written_per_ksec":
                         round(m["bytes_written_per_ksec"], 1),
                     "team": list(m["team"]),
                 }).encode())
                for m in load
            ]

        view.special_ranges = [
            (b"\xff\xff/keyservers/", _keyservers_rows),
            (b"\xff\xff/excluded/", _excluded_rows),
            (b"\xff\xff/server_list/", _serverlist_rows),
            (b"\xff\xff/metrics/", _metrics_rows),
        ]
        db = Database(self.loop, view, self.rng,
                      client_knobs=self.client_knobs)
        db.debug_sample_rate = self.debug_sample_rate
        # status + the periodic ClientMetrics plane see every handle
        self.client_dbs.append(db)
        self._client_metric_tasks.append(
            db.start_metrics(self.trace, self.knobs.METRICS_INTERVAL, proc)
        )
        return db

    def run_until(self, fut, deadline: float | None = None):
        return self.loop.run_until(fut, deadline)

    def power_off(self):
        """Simulate whole-cluster power loss: every process dies at once,
        all un-fsynced file buffers are dropped.  Returns the filesystem —
        the only thing that survives — for a restarted cluster:

            fs = cluster.power_off()
            cluster2 = RecoverableCluster(seed=..., fs=fs, restart=True)
        """
        assert self.fs is not None, "power_off needs a durable cluster"
        self.stop()
        for proc in list(self.net.processes.values()):
            proc.kill()
        return self.fs

    def clean_shutdown(self):
        """The orderly opposite of power_off: every buffered write is
        flushed durable (fs.flush_buffers) BEFORE the processes die, as an
        operator-driven halt would.  Exists for the negative
        crash-durability tests: a restarting pair whose kill were secretly
        this clean path would wrongly preserve un-fsynced data, which is
        exactly what those tests assert cannot happen."""
        assert self.fs is not None, "clean_shutdown needs a durable cluster"
        self.fs.flush_buffers()
        return self.power_off()

    def ready(self) -> bool:
        """Is the cluster serving commits?  The readiness signal the
        process supervisor observes (tools/server.py --ready-file writes
        only once this is true): a booting or mid-recovery cluster is not
        ready, a wedged one never becomes ready — which is how a rolling
        bounce distinguishes "still recovering" from "needs attention"."""
        from .controller import RecoveryState

        return not getattr(self, "_stopped", False) and (
            self.controller.recovery_state
            in (RecoveryState.ACCEPTING_COMMITS, RecoveryState.FULLY_RECOVERED)
        )

    def stop(self) -> None:
        # idempotent: a power-killed cluster (SaveAndKill) is stop()ped
        # again by run_spec's teardown; the second call must be a no-op
        if getattr(self, "_stopped", False):
            return
        self._stopped = True
        if getattr(self, "_region_task", None) is not None:
            # a mid-flight promote_remote_region() dies with the cluster:
            # its convergence wait must not keep running against stopped
            # roles (the ActorCancelled propagates to whoever awaited it)
            self._region_task.cancel()
        if getattr(self, "_router_retire_task", None) is not None:
            self._router_retire_task.cancel()
        self._wire_metrics_task.cancel()
        for t in self._client_metric_tasks:
            t.cancel()
        self.loop.slow_task_trace = None
        if getattr(self, "_monitor_task", None) is not None:
            self._monitor_task.cancel()
        for w in self.workers:
            w.stop()
        if self.log_router is not None:
            self.log_router.stop()
        for s in self.remote_storage:
            s.stop()
        self.dd.stop()
        self.ratekeeper.stop()
        self.controller.stop()
        for c in self.coordinators:
            c.stop()
        for s in self.storage:
            s.stop()
