"""Cluster controller + master recovery — generation management
(fdbserver/ClusterController.actor.cpp; masterserver.actor.cpp:1177-1338
RecoveryState machine; SURVEY §3.3).

The controller (elected via control/election.py in the full topology, or
constructed directly) owns the write pipeline's lifecycle:

  * builds generation N's roles (sequencer, proxies, resolvers, TLogs) on
    worker processes,
  * heartbeats every pipeline process; a missed FAILURE_TIMEOUT triggers
    recovery (the reference's waitFailure + masterserver restart),
  * recovery walks the reference's states: READING_CSTATE (coordinators) →
    LOCKING_CSTATE (lock surviving old TLogs, establishing the recovery
    version = min over their end versions — any version acked by *all*
    replicas is below it) → RECRUITING (fresh roles on live workers; new
    TLogs seeded with the locked generation's unpopped tag data; resolvers
    start empty with oldest = recovery version, the state-evaporates
    simplification the reference's design grants, SURVEY §5) →
    WRITING_CSTATE (new generation into the coordinators; a stale master
    loses here and halts) → ACCEPTING_COMMITS,
  * updates every client's ClusterView and every storage server's TLog
    source, so readers/writers follow the new generation.

Storage servers live *outside* generations (they rejoin by tag), exactly as
in the reference.

Copy of the reference package's module, on the port's roles and rpc: each
recovery builds its resolvers' sets through the cluster's factory at the
recovery version, so on the port's default backend every generation's
conflict check runs on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from ..client.transaction import ClusterView, Database
from ..conflict.api import ConflictSet
from ..roles.proxy import CommitProxy, KeyPartitionMap
from ..roles.resolver import Resolver
from ..roles.sequencer import Sequencer
from ..roles.storage import StorageServer
from ..roles.tlog import TLog
from ..roles.types import (
    ResolutionMetricsRequest,
    ResolutionSplitRequest,
    TLogPopRequest,
    Version,
)
from ..rpc.network import Endpoint, SimNetwork, SimProcess
from ..rpc.stream import RequestStream, RequestStreamRef
from ..runtime.combinators import wait_all, wait_any
from ..runtime.core import (
    ActorCancelled,
    BrokenPromise,
    DeterministicRandom,
    EventLoop,
    TaskPriority,
    TimedOut,
)
from ..runtime.knobs import CoreKnobs
from ..runtime.trace import TraceCollector
from ..runtime.coverage import testcov
from .logsystem import LogSystem, region_required_tags, remap_router_entries


def parse_conf_rows(rows) -> dict:
    """Decode a `\\xff/conf/` range read into the configuration the
    controller acts on — THE parser, shared by the live conf watcher and
    the recovery-time re-read of the recovered system keyspace (a torn or
    malformed row is skipped in both, never fatal)."""
    from ..client.management import (
        CONF_PREFIX,
        COORDINATORS_KEY,
        EXCLUDED_PREFIX,
        LOCK_KEY,
        MAINTENANCE_PREFIX,
    )

    from .region import REGION_PREFIX, USABLE_REGIONS_KEY, region_rows_present

    conf: dict[str, int] = {}
    excluded: set[str] = set()
    locked: bytes | None = None
    coord_n: int | None = None
    maint: dict[str, float] = {}
    redundancy: str | None = None
    engine: str | None = None
    throttle: float | None = None
    rows = list(rows)
    for k, v in rows:
        if k == USABLE_REGIONS_KEY or k.startswith(REGION_PREFIX):
            continue  # decoded as a whole by parse_region_rows below
        if k.startswith(EXCLUDED_PREFIX):
            excluded.add(k[len(EXCLUDED_PREFIX):].decode())
            continue
        if k == LOCK_KEY:
            locked = v
            continue
        if k == COORDINATORS_KEY:
            try:
                coord_n = int(v)
            except ValueError:
                pass
            continue
        if k.startswith(MAINTENANCE_PREFIX):
            try:
                maint[k[len(MAINTENANCE_PREFIX):].decode()] = float(v)
            except (ValueError, UnicodeDecodeError):
                pass
            continue
        if k == CONF_PREFIX + b"redundancy":
            try:
                redundancy = v.decode()
            except UnicodeDecodeError:
                pass
            continue
        if k == CONF_PREFIX + b"engine":
            try:
                engine = v.decode()
            except UnicodeDecodeError:
                pass
            continue
        if k == CONF_PREFIX + b"throttle_tps":
            try:
                throttle = float(v)
            except ValueError:
                pass
            continue
        try:
            conf[k[len(CONF_PREFIX):].decode()] = int(v)
        except (ValueError, UnicodeDecodeError):
            continue  # a malformed conf row must not kill the caller
    return {
        "conf": conf, "excluded": excluded, "locked": locked,
        "coord_n": coord_n, "maint": maint, "redundancy": redundancy,
        "engine": engine, "throttle": throttle,
        # presence only: the conf WATCH decodes the region rows itself with
        # the APPLIED config as the torn-row fallback base — a decoded-
        # without-base config here would carry the default-decay semantics
        # the base= parameter exists to avoid
        "region_rows": rows if region_rows_present(rows) else None,
    }


class RecoveryState:
    """Reference fdbserver/RecoveryState.h:30 names."""

    READING_CSTATE = "reading_cstate"
    LOCKING_CSTATE = "locking_cstate"
    RECRUITING = "recruiting"
    WRITING_CSTATE = "writing_cstate"
    ACCEPTING_COMMITS = "accepting_commits"
    FULLY_RECOVERED = "fully_recovered"


@dataclasses.dataclass
class GenerationRoles:
    epoch: int
    sequencer: Sequencer
    proxies: list[CommitProxy]
    resolvers: list[Resolver]
    tlogs: list[TLog]
    processes: list[SimProcess]
    # this epoch's durability plane as an object (LogSystem.h ILogSystem):
    # recovery locks it, stream consumers wire through it
    log_system: "LogSystem | None" = None
    ping_tasks: list = dataclasses.field(default_factory=list)
    # worker mode: the registry entries hosting this generation's roles
    # (roles are destroyed via DestroyGenerationRequest, not process kills —
    # workers outlive generations, exactly like the reference's fdbserver
    # processes)
    workers: list = dataclasses.field(default_factory=list)
    # actual TLog file paths (worker mode names them per recruit attempt so
    # a timed-out-then-retried recruit can never double-open one file);
    # recorded in the cstate so restart recovery reads the right files
    tlog_paths: list = dataclasses.field(default_factory=list)

    @property
    def proxy(self) -> CommitProxy:
        """First proxy (single-proxy-era call sites and chaos tests)."""
        return self.proxies[0]


class ClusterController:
    """Owns generations of the write pipeline over a pool of workers."""

    KEYSERVERS_PATH = "keyservers.meta"

    def __init__(
        self,
        loop: EventLoop,
        net: SimNetwork,
        knobs: CoreKnobs,
        rng: DeterministicRandom,
        trace: TraceCollector,
        storage: list[StorageServer],
        storage_splits: list[bytes],
        conflict_backend: Callable[..., ConflictSet],
        resolver_splits: list[bytes],
        n_tlogs: int = 2,
        n_proxies: int = 1,
        cstate=None,  # CoordinatedState or None (tests without coordinators)
        fs=None,      # SimFilesystem: TLogs become disk-backed
        restart: bool = False,  # bootstrap generation 1 from on-disk TLogs
        machines: list[tuple[str, str]] | None = None,  # (name, dc) ring for
                                # role placement (sim2 machine model)
        expect_workers: bool = False,  # recruit roles onto REGISTERED
                                # workers via RPC (worker.actor.cpp
                                # bootstrap); False = construct directly
                                # (unit tests / static clusters)
    ) -> None:
        self.loop = loop
        self.net = net
        self.knobs = knobs
        self.rng = rng.split()
        self.trace = trace
        self.storage = storage
        self.storage_splits = storage_splits
        # mutable keyServers state (the reference's keyServers system map):
        # shard i = [bounds[i], bounds[i+1]) served by the team of server
        # tags in storage_teams_tags[i].  Initialized from the tag naming
        # convention; data distribution mutates it via
        # install_storage_assignment.
        self._tag_to_ss = {ss.tag: ss for ss in storage}
        self.storage_teams_tags = self._initial_teams_from_tags()
        self.resolver_splits = resolver_splits
        self.make_cs = conflict_backend
        self.n_tlogs = n_tlogs
        self.n_proxies = n_proxies
        self.cstate = cstate
        self.fs = fs
        self.restart = restart
        self.machines = machines or []
        self.expect_workers = expect_workers
        # worker registry (ClusterController.actor.cpp registerWorker):
        # name -> {recruit_ep, pclass, machine, last_seen}; entries expire
        self._worker_registry: dict[str, dict] = {}
        self._register_task = None
        if expect_workers:
            from ..roles.worker import CONFLICT_FACTORIES, WLT_REGISTER

            self._register_stream = RequestStream(self._cc_proc(), WLT_REGISTER)
            self._register_task = loop.spawn(
                self._serve_register(), TaskPriority.COORDINATION, "cc-register"
            )
            # recruit RPCs carry only plain data: the conflict-backend
            # factory is registered under a token (roles/worker.py)
            self._cs_token = f"cs-{id(self)}"
            CONFLICT_FACTORIES[self._cs_token] = conflict_backend
        if restart and fs is not None and fs.exists(self.KEYSERVERS_PATH):
            # data distribution moved shards in a previous life: the on-disk
            # keyServers map, not the tag naming convention, says where the
            # durable data actually lives
            self._recover_key_servers()
        self.epoch = 0
        self.recoveries = 0
        self.resolver_moves = 0
        # ManagementAPI state, fed by the `\xff/conf/` watch: exclusion
        # targets (machine names / process names / addresses —
        # excludedServersPrefix), the database lock UID, and the pending
        # coordinator-change hook (installed by the cluster assembly, which
        # owns coordinator construction)
        self.excluded_targets: set[str] = set()
        self._locked: bytes | None = None
        self.on_coordinators_change = None  # async (n) -> bool
        self._coordinator_count: int | None = None
        self.maintenance_zones: dict[str, float] = {}  # zone -> deadline
        self.replication_policy = None      # installed by the cluster assembly
        self.on_redundancy_change = None    # async (policy) -> bool (one step)
        # region configuration (control/region.py): the in-memory mirror of
        # the committed `\xff/conf/` region rows; the cluster assembly
        # installs the change hook (it owns router/remote-replica topology)
        from .region import RegionConfiguration

        self.region_config = RegionConfiguration()
        self.on_region_change = None        # async (new, old) -> bool
        # storage-engine swap (configure engine=): the cluster assembly
        # installs the hook (it owns store construction) and the APPLIED
        # getter — recorded only on full convergence, so a half-migrated
        # swap keeps reading as drift and is resumed by the next poll
        self.on_engine_change = None        # async (engine) -> None
        self.applied_engine = None          # () -> str, assembly-installed
        # live storage replicas OUTSIDE the keyServers teams that also hold
        # the `\xff/conf/` shard (the remote region's replicas): the conf
        # watch reads through them when every primary replica of the shard
        # is dead — a region kill must not blind the watch to the very
        # failover configuration that recovers from it
        self.conf_fallback_servers: list = []
        # cluster-wide liveness map (fdbrpc/FailureMonitor.h:65): fed by the
        # heartbeats below + data distribution's storage pings, consulted by
        # client load-balancing through every view
        from ..rpc.failmon import FailureMonitor

        self.failure_monitor = FailureMonitor(loop.now)
        self.ratekeeper = None  # set by the cluster after construction
        self.generation: GenerationRoles | None = None
        # full-stream consumers: tag -> worker (backup, log routers)
        self.stream_consumers: dict[str, object] = {}
        self.views: list[ClusterView] = []
        self.recovery_state = RecoveryState.READING_CSTATE
        self._recovering = False
        self._monitor_task = None
        self._proc_seq = 0

    def _set_state(self, state: str) -> None:
        self.recovery_state = state
        self.trace.trace(
            "MasterRecoveryState", track_latest="master",
            State=state, Epoch=self.epoch,
        )

    # -- process pool -------------------------------------------------------
    @staticmethod
    def spread_slot(i: int, n: int, ring_len: int) -> int:
        """Even-spread ring slot for the i-th of n same-kind roles — the one
        placement formula shared by pipeline recruitment and the cluster's
        coordinator placement."""
        return (i * ring_len) // max(n, 1) % ring_len

    @staticmethod
    def excluded_match(targets: set, *, machine=None, name=None, address=None) -> bool:
        """THE exclusion-target matcher (machine name / process name /
        address) — single source of truth for is_excluded, worker
        recruitment, and management.exclusion_safe."""
        return bool(targets) and (
            machine in targets
            or name in targets
            or (address is not None and str(address) in targets)
        )

    def is_excluded(self, proc) -> bool:
        """Does an exclusion target (ManagementAPI exclude) match this
        process's locality?"""
        return self.excluded_match(
            self.excluded_targets,
            machine=getattr(proc, "machine", None),
            name=proc.name,
            address=proc.address,
        )

    def _placement_ring(self) -> list[tuple[str, str]]:
        """The machine ring minus excluded machines (falling back to the
        full ring if exclusion would empty it — a misconfigured exclude-all
        must not make recruitment impossible)."""
        if not self.excluded_targets:
            return self.machines
        ring = [m for m in self.machines if m[0] not in self.excluded_targets]
        return ring or self.machines

    def _new_proc(self, role: str, spread: tuple[int, int] | None = None) -> SimProcess:
        """spread=(i, n): place the i-th of n same-kind roles evenly across
        the machine ring — TLog/proxy replicas must straddle DCs, or one
        DC's loss takes every copy (the reference's recruitment policies,
        ReplicationPolicy Across(dcid))."""
        self._proc_seq += 1
        extra = {}
        ring = self._placement_ring()
        if ring:
            if spread is not None:
                i, n = spread
                idx = self.spread_slot(i, n, len(ring))
            else:
                idx = self._proc_seq % len(ring)
            m, d = ring[idx]
            extra = {"machine": m, "dc": d}
        return self.net.create_process(
            f"{role}-e{self.epoch}-{self._proc_seq}", **extra
        )

    # -- bootstrap ----------------------------------------------------------
    async def start(self) -> None:
        await self._recover(first=True)
        self._monitor_task = self.loop.spawn(
            self._monitor(), TaskPriority.COORDINATION, "cc-monitor"
        )
        self._balance_task = self.loop.spawn(
            self._balance_resolvers(), TaskPriority.COORDINATION, "cc-balance"
        )
        self._conf_task = self.loop.spawn(
            self._watch_configuration(), TaskPriority.COORDINATION, "cc-conf"
        )

    # -- recovery state machine --------------------------------------------
    async def _recover(self, first: bool = False) -> None:
        if self._recovering:
            return
        self._recovering = True
        try:
            self._set_state(RecoveryState.READING_CSTATE)
            # deliberate pre-recovery snapshot: `old` IS the generation
            # being deposed, and _recovering serializes recoveries — the
            # one writer of self.generation is this function
            # flowlint: ok stale-read-across-await (deliberate old-generation snapshot; _recovering serializes the only writer)
            old = self.generation
            prev_state = None
            if self.cstate is not None:
                prev_state, _gen = await self.cstate.read()
            if prev_state is not None:
                self.epoch = max(self.epoch, prev_state["epoch"])
            self.epoch += 1
            if not first:
                self.recoveries += 1

            # LOCKING_CSTATE: stop the old generation's TLogs, learn the
            # recovery version and surviving tag data
            self._set_state(RecoveryState.LOCKING_CSTATE)
            if old is None and self.restart and prev_state is not None:
                # whole-cluster restart: the previous epoch's TLogs exist
                # only as files; replay their synced logs in place of lock
                # replies (SimulatedCluster restartSimulatedSystem analog)
                recovery_version, tag_data = self._recover_tlogs_from_disk(
                    prev_state["epoch"],
                    prev_state.get("n_tlogs", self.n_tlogs),
                    prev_state.get("tlog_paths"),
                )
            else:
                recovery_version, tag_data = await self._lock_old_tlogs(old)

            if first:
                # Re-learn the database lock / exclusions / maintenance from
                # the recovered system keyspace (`\xff/conf/` in durable
                # storage, plus the committed-but-unflushed suffix surviving
                # in the TLog seeds) BEFORE recruiting (exclusions steer
                # placement) and before ACCEPTING_COMMITS: a restarted
                # locked cluster must not accept a single non-lock-aware
                # commit in the window before the first conf-poll tick
                # (ADVICE round 5).  Mid-life recoveries keep the in-memory
                # state, which the conf watch holds current.
                self._recover_conf_from_storage(tag_data)

            # RECRUITING: fresh pipeline on fresh processes (or, in worker
            # mode, recruited onto surviving workers)
            self._set_state(RecoveryState.RECRUITING)
            if old is not None:
                if old.workers:
                    # workers outlive generations: destroy the hosted roles
                    # remotely, never the worker processes.  An unreachable
                    # worker's roles are fenced by protocol anyway (locked
                    # TLogs refuse commits, confirmEpochLive parks GRVs).
                    for w in old.workers:
                        from ..roles.worker import DestroyGenerationRequest

                        RequestStreamRef(
                            self.net, self._cc_proc(), w["recruit_ep"]
                        ).send(DestroyGenerationRequest(old.epoch))
                else:
                    for p in old.processes:
                        p.kill()  # old roles may not serve a split-brain
                for p in old.processes:
                    # retired addresses leave the liveness map, or it grows
                    # with every recovery and stale failed entries linger
                    # (a surviving worker process is re-added by the next
                    # heartbeat that pings it)
                    self.failure_monitor.forget(p.address)
                for t in old.ping_tasks:
                    t.cancel()
                # cancel the deposed roles' tasks too: a killed process stops
                # receiving, but its Python tasks would otherwise spin (the
                # GRV park loop retries forever against locked/dead TLogs)
                for role in (
                    [old.sequencer] + old.proxies + old.resolvers + old.tlogs
                ):
                    role.stop()
            gen = await self._recruit(recovery_version, tag_data)
            # durable-seed barrier: the new TLogs' RESET records (carrying
            # every surviving committed byte) must be on disk before the
            # cstate names this epoch — else a power loss between the write
            # and the first commit sync would lose the seeds with nothing to
            # fall back to (the old epoch's files are superseded)
            for t in gen.tlogs:
                await t.initial_durable()

            # WRITING_CSTATE: publish via coordinators (stale CC halts here)
            self._set_state(RecoveryState.WRITING_CSTATE)
            if self.cstate is not None:
                ok = await self.cstate.write(
                    {"epoch": self.epoch, "recovery_version": recovery_version,
                     "n_tlogs": self.n_tlogs, "tlog_paths": gen.tlog_paths}
                )
                if not ok:
                    testcov("recovery.lost_cstate_race")
                    self._teardown_generation(gen)
                    raise RuntimeError("lost cstate race: a newer master exists")
            if self.fs is not None:
                # previous epochs' TLog files are superseded by this epoch's
                # durable RESETs + the cstate record naming this epoch;
                # enumerate ALL tlog files (old epochs may have had more
                # slots than the current config)
                current = set(gen.tlog_paths)
                for path in self.fs.list("tlog"):
                    if path not in current:
                        self.fs.delete(path)

            self.generation = gen
            self._start_generation_metrics(gen)
            for p in gen.proxies:
                p.locked = self._locked  # the lock survives recoveries
            self._set_state(RecoveryState.ACCEPTING_COMMITS)
            self._rewire(gen, recovery_version if not first else None)
            self._set_state(RecoveryState.FULLY_RECOVERED)
        finally:
            self._recovering = False

    def _read_conf_rows_from_storage(
        self, fallback: bool = False
    ) -> list[tuple[bytes, bytes]]:
        """Direct host-side read of the `\\xff/conf/` range from the storage
        team that owns it (the txnStateStore-recovery analog: the reference
        master reloads configuration from the recovered txn state store
        before accepting commits).  Best-effort: an unreachable team means
        the conf watch corrects state one poll later, as before.  With
        `fallback`, remote-region replicas of the conf shard are consulted
        after the team — the read path a whole-region kill leaves alive."""
        from ..client.management import CONF_PREFIX

        begin, end = CONF_PREFIX, CONF_PREFIX + b"\xff"
        try:
            team = list(self._storage_teams()[-1])  # `\xff`: the last shard
        except Exception:  # noqa: BLE001 — malformed team map: skip
            team = []
            if not fallback:
                return []
        candidates = list(team)
        n_primary = len(candidates)
        if fallback:
            candidates += [
                s for s in self.conf_fallback_servers if s not in candidates
            ]
        for idx, ss in enumerate(candidates):
            if not ss.process.alive:
                continue
            try:
                base = {k: v for k, v in ss.store.range_read(begin, end, 10_000)}
                keys = set(base) | set(ss.overlay.overlay_keys_in(begin, end))
                rows = []
                for k in sorted(keys):
                    v = ss.overlay.get(k, ss.version.get(), ss.store.get)
                    if v is not None:
                        rows.append((k, v))
                if idx >= n_primary:
                    # served by a REMOTE replica with the whole primary
                    # team dead/unreadable — the region-kill read path the
                    # coverage site exists to pin (a live-primary blip
                    # served above must not satisfy it)
                    testcov("region.conf_read_fallback")
                return rows
            except Exception:  # noqa: BLE001 — mid-reboot store: next replica
                continue
        return []

    def _recover_conf_from_storage(self, tlog_seeds: list[dict] | None = None) -> None:
        rows = dict(self._read_conf_rows_from_storage())
        # the durable store lags commits by the MVCC window: fold the
        # committed-but-unflushed conf mutations surviving in the recovered
        # TLog seeds on top, in version order — together they ARE the
        # recovered system keyspace
        if tlog_seeds:
            from ..client.management import CONF_PREFIX
            from ..roles.types import MutationType

            team_tags = set(self.storage_teams_tags[-1])
            by_version: dict[Version, list] = {}
            for slot in tlog_seeds:
                for tag, entries in slot.items():
                    if tag in team_tags:
                        for v, muts in entries:
                            by_version[v] = muts  # replica copies are identical
            hi = CONF_PREFIX + b"\xff"
            for v in sorted(by_version):
                for m in by_version[v]:
                    if m.type == MutationType.CLEAR_RANGE:
                        if m.key < hi and m.value > CONF_PREFIX:
                            for k in [
                                k for k in rows if m.key <= k < m.value
                            ]:
                                del rows[k]
                    elif (
                        m.type == MutationType.SET_VALUE
                        and m.key.startswith(CONF_PREFIX)
                    ):
                        rows[m.key] = m.value
        rows = sorted(rows.items())
        if not rows:
            return
        parsed = parse_conf_rows(rows)
        self._locked = parsed["locked"]
        if parsed["excluded"]:
            self.excluded_targets = set(parsed["excluded"])
        now = self.loop.now()
        self.maintenance_zones = {
            z: d for z, d in parsed["maint"].items() if d > now
        }
        if self.ratekeeper is not None:
            self.ratekeeper.manual_tps_cap = parsed["throttle"]
        # region rows are deliberately NOT adopted here: region_config
        # mirrors the APPLIED topology (set by the cluster assembly from
        # what it actually built/recovered), and the conf watch drives the
        # region hook on any desired-vs-applied drift — a reboot that
        # interrupted a configured failover re-runs it instead of
        # remembering it as done
        self.trace.trace(
            "ConfigurationRecovered", Epoch=self.epoch,
            Locked=self._locked is not None,
            Excluded=sorted(self.excluded_targets),
        )

    def _keep_tag(self, tag: str) -> bool:
        """Seed filter for the next epoch: a stream-consumer tag (backup
        worker / log router / DR) is re-seeded only while its consumer is
        registered — residue of a finished consumer is dropped, not carried
        forever."""
        if tag.startswith(("backup-", "router-", "dr-")):
            return tag in self.stream_consumers
        return True

    async def _lock_old_tlogs(self, old: GenerationRoles | None):
        """Epoch end via the LogSystem abstraction: lock the old set (disk
        fallback for observably-dead members), compute the recovery
        version, and build the next epoch's seeds."""
        if old is None:
            return 0, [dict() for _ in range(self.n_tlogs)]
        ls = old.log_system or LogSystem(old.epoch, old.tlogs, old.tlog_paths)
        # required_tags unconditionally: a MEMORY-engine cluster has no disk
        # fallback, so losing every replica slot of a storage tag is exactly
        # as unrecoverable as on disk — recovery must refuse loudly instead
        # of silently dropping the tag's unpopped data (ADVICE round 5).
        # Under usable_regions=2 the router tag joins the set: its retained
        # backlog is the remote region's not-yet-durable data.
        recovery_version, replies = await ls.lock(
            self.net, self._cc_proc(), self.fs,
            required_tags=region_required_tags(
                [s.tag for s in self.storage], self.region_config,
                self.stream_consumers,
            ),
        )
        seeds = LogSystem.merge_replies(
            replies, recovery_version, self.n_tlogs, self._keep_tag
        )
        return recovery_version, seeds

    def _tlog_path(self, slot: int, epoch: int) -> str:
        return f"tlog{slot}-e{epoch}.dq"

    def _recover_tlogs_from_disk(self, prev_epoch: int, prev_n_tlogs: int,
                                 prev_paths: list[str] | None = None):
        """Whole-cluster restart through LogSystem.from_disk: the PREVIOUS
        epoch's slot count (recorded in the cstate write) governs which
        files are replayed — restarting with fewer TLog slots must still
        replay every old slot's file."""
        recovery_version, replies, _ls = LogSystem.from_disk(
            self.fs, prev_epoch, prev_n_tlogs, prev_paths,
            required_tags=region_required_tags(
                [s.tag for s in self.storage], self.region_config,
                self.stream_consumers,
            ),
        )
        from ..roles.logrouter import ROUTER_TAG
        from .region import teams_promoted

        if (
            teams_promoted(self.storage_teams_tags)
            and ROUTER_TAG not in self.stream_consumers
        ):
            # a PROMOTED reboot with retained router data: the power kill
            # landed inside the post-failover durability window, so the
            # promoted replicas still owe their disks the stream the
            # router was retaining — fold it into their tags' seeds
            # instead of dropping the only durable copy
            remap_router_entries(
                replies,
                KeyPartitionMap(
                    list(self.storage_splits),
                    [list(t) for t in self.storage_teams_tags],
                ),
            )
        seeds = LogSystem.merge_replies(
            replies, recovery_version, self.n_tlogs, self._keep_tag
        )
        return recovery_version, seeds

    @staticmethod
    def _parse_tag(tag: str) -> tuple[int, int]:
        """Storage tag -> (shard, replica) — LogSystem.parse_tag delegate
        (kept as the controller-facing name its call sites use)."""
        return LogSystem.parse_tag(tag)

    def _tag_tlogs(self, tag: str, n_tlogs: int | None = None) -> list[int]:
        """TLog replica slots for a tag — LogSystem.tag_slots delegate.
        Pass `n_tlogs` to compute a PREVIOUS epoch's replica map."""
        return LogSystem.tag_slots(tag, self.n_tlogs if n_tlogs is None else n_tlogs)

    def _initial_teams_from_tags(self) -> list[list[str]]:
        """Bootstrap the keyServers map from the tag naming convention
        ("ss-<shard>-r<replica>"): shard i's team = its replicas' tags."""
        teams: list[list] = [[] for _ in range(len(self.storage_splits) + 1)]
        for ss in self.storage:
            shard, _ = self._parse_tag(ss.tag)
            teams[shard].append(ss.tag)
        for i, t in enumerate(teams):
            if not t:
                raise ValueError(f"shard {i} has no storage servers")
            t.sort(key=lambda tag: self._parse_tag(tag)[1])
        return teams

    def _storage_teams(self) -> list[list["StorageServer"]]:
        """Storage servers grouped by shard (keyServers team map lookup)."""
        return [
            [self._tag_to_ss[t] for t in team] for team in self.storage_teams_tags
        ]

    def replace_storage_server(self, old: "StorageServer", new: "StorageServer") -> None:
        """Swap a healed replacement in for a dead server (same tag).  The
        caller (data distribution) refreshes client views once the
        replacement's ranges are live."""
        assert old.tag == new.tag
        self._tag_to_ss[new.tag] = new
        self.storage[self.storage.index(old)] = new

    # -- full-stream consumers (backup workers + log routers) ----------------
    # A full-stream consumer owns a dedicated tag that every committed
    # mutation is ALSO tagged with; it survives generations by rejoining
    # its tag like storage does (the reference's txsTag/backup tags and the
    # log-router tags of multi-region replication share this shape).

    @property
    def backup_worker(self):
        from ..roles.backup import BACKUP_TAG

        return self.stream_consumers.get(BACKUP_TAG)

    async def enable_stream_consumer(self, tag: str, worker) -> Version | None:
        """Tag every future commit with `tag` and wire the consumer to this
        generation's TLogs.  Returns the boundary version: the stream is
        complete from it onward.  None = recovery raced or the commit plane
        would not drain (caller retries)."""
        if tag in self.stream_consumers:
            raise RuntimeError(f"stream tag {tag!r} already has a consumer")
        gen = self.generation
        if gen is None or self._recovering:
            return None
        for p in gen.proxies:
            p.pause_commits()
        try:
            try:
                await self._wait_commit_drain(gen)
            except TimedOut:
                return None
            if gen is not self.generation or self._recovering:
                return None
            for p in gen.proxies:
                p.tag_to_tlogs = {**p.tag_to_tlogs, tag: self._tag_tlogs(tag)}
                p.full_stream_tags = p.full_stream_tags + [tag]
            self.stream_consumers[tag] = worker
            self._wire_stream_consumer(gen, tag)
            return gen.sequencer._last_assigned
        finally:
            for p in gen.proxies:
                p.resume_commits()

    async def disable_stream_consumer(self, tag: str) -> None:
        # cleared FIRST: a recovery racing anything below recruits its new
        # generation without the tag
        self.stream_consumers.pop(tag, None)
        gen = self.generation
        if gen is None:
            return
        for p in gen.proxies:
            p.pause_commits()
        try:
            try:
                await self._wait_commit_drain(gen)
            except TimedOut:
                pass  # clearing the tag un-drained only strands a few
                      # residual entries — the pops below reclaim them
            gen = self.generation  # a recovery may have swapped it (the new
            if gen is None:        # generation is already tag-free)
                return
            for p in gen.proxies:
                p.full_stream_tags = [t for t in p.full_stream_tags if t != tag]
        finally:
            for p in (gen.proxies if gen else []):
                p.resume_commits()
        # reclaim the tag's TLog space: residual entries would otherwise be
        # retained (and re-seeded at every recovery) forever
        upto = gen.sequencer._last_assigned + (1 << 40)
        cc = self._cc_proc()
        for t in gen.tlogs:
            RequestStreamRef(self.net, cc, t.pop_stream.endpoint).send(
                TLogPopRequest(tag, upto)
            )

    def _wire_stream_consumer(self, gen: GenerationRoles, tag: str) -> None:
        w = self.stream_consumers[tag]
        ls = gen.log_system
        w.set_tlog_source(
            ls.peek_ref(self.net, w.process, tag),
            ls.pop_refs(self.net, w.process, tag),
        )

    # backward-compatible backup entry points (client/backup.py)
    async def enable_backup(self, worker) -> Version | None:
        from ..roles.backup import BACKUP_TAG

        return await self.enable_stream_consumer(BACKUP_TAG, worker)

    async def disable_backup(self) -> None:
        from ..roles.backup import BACKUP_TAG

        await self.disable_stream_consumer(BACKUP_TAG)

    # -- keyServers persistence (data distribution across restarts) ---------
    def _keyservers_dq(self):
        from ..storage.diskqueue import DiskQueue

        if not hasattr(self, "_ks_dq"):
            self._ks_dq = DiskQueue(
                self.fs.open(self.KEYSERVERS_PATH, self._cc_proc())
            )
        return self._ks_dq

    async def persist_key_servers(
        self, splits: list[bytes], teams: list[list[str]]
    ) -> None:
        """Durably record a keyServers assignment (the reference keeps it in
        the `\\xff/keyServers/` system keyspace, which is itself replicated
        storage; a flat fsynced file is our equivalent).  Data distribution
        persists only assignments whose data is already durable where the
        map points — never a mid-move dual state whose destination holds the
        range only in memory."""
        if self.fs is None:
            return
        from ..runtime.serialize import BinaryWriter

        w = BinaryWriter().u32(len(splits))
        for s in splits:
            w.bytes_(s)
        w.u32(len(teams))
        for t in teams:
            w.u32(len(t))
            for tag in t:
                w.str_(tag)
        dq = self._keyservers_dq()
        for attempt in range(3):
            try:
                dq.rewrite([w.data()])
                break
            except IOError:
                # transient disk fault (injection plane): the journaled
                # truncate un-wound itself, the previous assignment is
                # still recoverable — retry; a persistently refusing disk
                # surfaces to the caller (dd aborts the move)
                if attempt == 2:
                    raise
                await self.loop.delay(0.02, TaskPriority.COORDINATION)
        await dq.sync()

    def _recover_key_servers(self) -> None:
        from ..runtime.serialize import BinaryReader

        try:
            records = self._keyservers_dq().recover()
            if not records:
                return
            r = BinaryReader(records[-1])
            splits = [r.bytes_() for _ in range(r.u32())]
            teams = [
                [r.str_() for _ in range(r.u32())] for _ in range(r.u32())
            ]
        except Exception:  # noqa: BLE001 — torn write: fall back to the
            return         # tag-convention map (valid pre-first-move state)
        if len(teams) != len(splits) + 1:
            return
        if not all(t in self._tag_to_ss for team in teams for t in team):
            return  # names a server that no longer exists: stale file
        self.storage_splits = splits
        self.storage_teams_tags = teams

    async def install_storage_assignment(
        self, new_splits: list[bytes], new_teams: list[list[str]]
    ) -> Version | None:
        """Atomically swap the keyServers map on every proxy at a drained
        version boundary, then refresh every client view.  Returns the
        boundary version (mutations above it follow the new map), or None
        if a recovery raced the drain (caller retries).

        The reference gets this atomicity by committing keyServers changes
        through the pipeline (MoveKeys.actor.cpp startMoveKeys/
        finishMoveKeys txns); draining the commit plane is our equivalent
        serialization point."""
        gen = self.generation
        if gen is None or self._recovering:
            return None
        for p in gen.proxies:
            p.pause_commits()
        try:
            await self._wait_commit_drain(gen)
            if gen is not self.generation or self._recovering:
                return None
            pmap = KeyPartitionMap(list(new_splits), [list(t) for t in new_teams])
            t2t = {t: self._tag_tlogs(t) for team in new_teams for t in team}
            for p in gen.proxies:
                p.install_storage_map(pmap, t2t)
            self.storage_splits = list(new_splits)
            self.storage_teams_tags = [list(t) for t in new_teams]
            for view in self.views:
                self._fill_view(view)
            return gen.sequencer._last_assigned
        finally:
            for p in gen.proxies:
                p.resume_commits()

    def _cc_proc(self) -> SimProcess:
        if not hasattr(self, "_cc_process"):
            self._cc_process = self.net.create_process("cluster-controller")
        return self._cc_process

    # -- worker registry + recruitment (worker.actor.cpp bootstrap) ----------
    async def _serve_register(self) -> None:
        while True:
            req = await self._register_stream.next()
            r = req.payload
            self._worker_registry[r.name] = {
                "recruit_ep": r.recruit_endpoint,
                "pclass": r.process_class,
                "machine": r.machine,
                "name": r.name,
                "last_seen": self.loop.now(),
            }

    def _live_workers(self) -> list[dict]:
        now = self.loop.now()
        return [
            w for w in self._worker_registry.values()
            if now - w["last_seen"] < 2.0
        ]

    async def _recruit_on_worker(self, kind: str, params: dict, loads: dict,
                                 avoid_machines: set | None = None):
        """Pick the fittest live worker (preferred class, least loaded,
        off the machines already hosting this kind) and recruit the role
        there; dead workers are pruned and the next one tried.  Returns
        (role, worker_info)."""
        from ..roles.worker import PREFERRED_CLASS, RecruitRoleRequest

        pref = PREFERRED_CLASS.get(kind, "stateless")
        avoid = avoid_machines or set()
        deadline = self.loop.now() + 5.0
        while True:
            cands = self._live_workers()
            # excluded workers host nothing (ManagementAPI exclude) — unless
            # every live worker is excluded, when refusing to recruit would
            # wedge recovery entirely
            non_ex = [
                w for w in cands
                if not self.excluded_match(
                    self.excluded_targets,
                    machine=w["machine"], name=w["name"],
                    address=w["recruit_ep"].address,
                )
            ]
            if non_ex:
                cands = non_ex
            cands.sort(
                key=lambda w: (
                    w["machine"] is not None and w["machine"] in avoid,
                    w["pclass"] != pref,
                    loads.get(w["name"], 0),
                    w["name"],
                )
            )
            for w in cands:
                ref = RequestStreamRef(self.net, self._cc_proc(), w["recruit_ep"])
                try:
                    reply = await ref.get_reply(
                        RecruitRoleRequest(kind, self.epoch, params), timeout=1.0
                    )
                except (TimedOut, BrokenPromise):
                    self._worker_registry.pop(w["name"], None)
                    continue
                loads[w["name"]] = loads.get(w["name"], 0) + 1
                from ..roles.worker import SIM_ROLE_HANDLES

                return SIM_ROLE_HANDLES.pop(reply.handle), w
            if self.loop.now() >= deadline:
                raise RuntimeError(
                    f"no live worker available to host {kind!r}"
                )
            await self.loop.delay(0.1, TaskPriority.COORDINATION)

    async def _recruit(self, recovery_version: Version, tlog_seeds: list[dict]) -> GenerationRoles:
        if self.expect_workers:
            gen = await self._recruit_via_workers(recovery_version, tlog_seeds)
        else:
            gen = self._recruit_direct(recovery_version, tlog_seeds)
        gen.log_system = LogSystem(gen.epoch, gen.tlogs, gen.tlog_paths)
        return gen

    async def _recruit_via_workers(
        self, recovery_version: Version, tlog_seeds: list[dict]
    ) -> GenerationRoles:
        """RPC recruitment onto registered workers (the reference's CC
        sending InitializeXxxRequest to worker interfaces; fitness-ordered
        worker choice in _recruit_on_worker)."""
        from ..roles.worker import PruneGenerationRequest

        start_v = recovery_version + 1_000_000
        loads: dict[str, int] = {}
        used: list = []
        nonces: list[str] = []
        kind_machines: dict[str, set] = {}

        # sweep leftovers of any ABORTED recovery epoch before recruiting
        # (a mid-recruit failure leaves live roles on workers; their epoch
        # is neither the live generation's nor this one's)
        keep_epoch = self.generation.epoch if self.generation else -1
        for w in self._live_workers():
            RequestStreamRef(self.net, self._cc_proc(), w["recruit_ep"]).send(
                PruneGenerationRequest(
                    epoch=-1, keep_nonces=[], below_epoch=self.epoch,
                    keep_epoch=keep_epoch,
                )
            )

        async def recruit(kind: str, params: dict):
            nonce = self.rng.random_unique_id()[:8]
            params = {**params, "nonce": nonce}
            role, w = await self._recruit_on_worker(
                kind, params, loads, kind_machines.setdefault(kind, set())
            )
            nonces.append(nonce)
            if w["machine"] is not None:
                kind_machines[kind].add(w["machine"])
            if all(u["name"] != w["name"] for u in used):
                used.append(w)
            return role

        sequencer = await recruit("sequencer", {"start_version": start_v})
        tlogs: list[TLog] = []
        tlog_paths: list[str] = []
        for i in range(self.n_tlogs):
            # per-attempt file name: a recruit whose reply timed out may
            # have built a TLog that opened its path — the retry must not
            # share a file with that orphan
            path = None
            if self.fs is not None:
                path = f"tlog{i}-e{self.epoch}-{self.rng.random_unique_id()[:6]}.dq"
            t = await recruit("tlog", {
                "start_version": start_v,
                "seeds": tlog_seeds[i],
                "known_committed": recovery_version,
                "path": path,
            })
            tlogs.append(t)
            if path is not None:
                tlog_paths.append(path)
        resolvers: list[Resolver] = []
        for _i in range(len(self.resolver_splits) + 1):
            resolvers.append(await recruit("resolver", {
                "conflict_backend": self._cs_token,
                "oldest": recovery_version,
                "start_version": start_v,
            }))
        teams = self._storage_teams()
        tag_teams = [[ss.tag for ss in team] for team in teams]
        all_tags = [t for team in tag_teams for t in team]
        proxies: list[CommitProxy] = []
        for _i in range(self.n_proxies):
            proxies.append(await recruit("proxy", {
                "sequencer": sequencer.stream.endpoint,
                "resolvers": [r.stream.endpoint for r in resolvers],
                "resolver_splits": self.resolver_splits,
                "tlog_commits": [t.commit_stream.endpoint for t in tlogs],
                "tlog_confirms": [t.confirm_stream.endpoint for t in tlogs],
                "storage_splits": self.storage_splits,
                "storage_teams": self.storage_teams_tags,
                "tag_to_tlogs": {t: self._tag_tlogs(t) for t in all_tags},
                "start_version": start_v,
            }))
        for p in proxies:
            p.ratekeeper = self.ratekeeper
            p.on_commit_failure = self._on_proxy_failure
        for tag in self.stream_consumers:
            for p in proxies:
                p.tag_to_tlogs = {**p.tag_to_tlogs, tag: self._tag_tlogs(tag)}
                p.full_stream_tags = p.full_stream_tags + [tag]
        for p in proxies:
            p.peers = [
                RequestStreamRef(
                    self.net, p.commit_stream._process,
                    q.raw_version_stream.endpoint,
                )
                for q in proxies
                if q is not p
            ]
        # same-epoch orphans (a recruit retried after its reply timed out
        # in flight) are stopped now that the full set is known
        for w in self._live_workers():
            RequestStreamRef(self.net, self._cc_proc(), w["recruit_ep"]).send(
                PruneGenerationRequest(
                    epoch=self.epoch, keep_nonces=list(nonces),
                    below_epoch=self.epoch, keep_epoch=keep_epoch,
                )
            )
        addrs = (
            [sequencer.stream.endpoint.address]
            + [t.commit_stream.endpoint.address for t in tlogs]
            + [r.stream.endpoint.address for r in resolvers]
            + [p.commit_stream.endpoint.address for p in proxies]
        )
        procs = [self.net.processes[a] for a in dict.fromkeys(addrs)]
        return GenerationRoles(
            self.epoch, sequencer, proxies, resolvers, tlogs, procs,
            ping_tasks=[], workers=used, tlog_paths=tlog_paths,
        )

    def _recruit_direct(self, recovery_version: Version, tlog_seeds: list[dict]) -> GenerationRoles:
        procs: list[SimProcess] = []
        ping_tasks: list = []

        def add_ping(p: SimProcess) -> None:
            rs = RequestStream(p, "wlt:ping")

            async def pong() -> None:
                while True:
                    req = await rs.next()
                    req.reply("pong")

            ping_tasks.append(self.loop.spawn(pong(), TaskPriority.COORDINATION))

        seq_proc = self._new_proc("sequencer")
        procs.append(seq_proc)
        add_ping(seq_proc)
        # jump versions past anything the old generation might have handed
        # out but never logged (reference: recovery version gap)
        sequencer = Sequencer(
            seq_proc, self.loop, self.knobs,
            start_version=recovery_version + 1_000_000,
        )

        tlogs: list[TLog] = []
        tlog_paths: list[str] = []
        for i in range(self.n_tlogs):
            p = self._new_proc(f"tlog{i}", spread=(i, self.n_tlogs))
            procs.append(p)
            add_ping(p)
            dq = None
            if self.fs is not None:
                from ..storage.diskqueue import DiskQueue

                path = self._tlog_path(i, self.epoch)
                tlog_paths.append(path)
                dq = DiskQueue(self.fs.open(path, p))
            tlogs.append(
                TLog(p, self.loop, start_version=recovery_version + 1_000_000,
                     initial_tags=tlog_seeds[i],
                     known_committed=recovery_version,
                     disk_queue=dq,
                     spill_bytes=self.knobs.TLOG_SPILL_BYTES,
                     hard_limit_bytes=self.knobs.TLOG_HARD_LIMIT_BYTES,
                     trace=self.trace)
            )

        resolvers: list[Resolver] = []
        for i in range(len(self.resolver_splits) + 1):
            p = self._new_proc(f"resolver{i}")
            procs.append(p)
            add_ping(p)
            cs = self.make_cs(recovery_version)
            if hasattr(cs, "bind_failmon"):
                # supervised device backend: its degraded/healthy/probing
                # transitions land in the cluster-wide failure monitor
                cs.bind_failmon(self.failure_monitor, f"resolver{i}.device")
            resolvers.append(
                Resolver(
                    p, self.loop, self.knobs, cs,
                    start_version=recovery_version + 1_000_000,
                )
            )

        teams = self._storage_teams()
        tag_teams = [[ss.tag for ss in team] for team in teams]
        all_tags = [t for team in tag_teams for t in team]
        proxies: list[CommitProxy] = []
        for i in range(self.n_proxies):
            proxy_proc = self._new_proc(f"proxy{i}", spread=(i, self.n_proxies))
            procs.append(proxy_proc)
            add_ping(proxy_proc)
            proxy = CommitProxy(
                proxy_proc, self.loop, self.knobs,
                sequencer_ref=RequestStreamRef(self.net, proxy_proc, sequencer.stream.endpoint),
                resolver_refs=[
                    RequestStreamRef(self.net, proxy_proc, r.stream.endpoint)
                    for r in resolvers
                ],
                resolver_splits=self.resolver_splits,
                tlog_refs=[
                    RequestStreamRef(self.net, proxy_proc, t.commit_stream.endpoint)
                    for t in tlogs
                ],
                storage_tags=KeyPartitionMap(self.storage_splits, tag_teams),
                tag_to_tlogs={t: self._tag_tlogs(t) for t in all_tags},
                start_version=recovery_version + 1_000_000,
                tlog_confirm_refs=[
                    RequestStreamRef(self.net, proxy_proc, t.confirm_stream.endpoint)
                    for t in tlogs
                ],
            )
            proxy.ratekeeper = self.ratekeeper
            proxy.on_commit_failure = self._on_proxy_failure
            proxies.append(proxy)
        # active full-stream consumers survive generations: the new proxies
        # keep tagging the stream (consumers rejoin by tag in _rewire)
        for tag in self.stream_consumers:
            for p in proxies:
                p.tag_to_tlogs = {**p.tag_to_tlogs, tag: self._tag_tlogs(tag)}
                p.full_stream_tags = p.full_stream_tags + [tag]
        # mutual raw-version refs: each proxy's GRV takes the max over all
        # proxies' committed versions (getLiveCommittedVersion :1002)
        for p in proxies:
            p.peers = [
                RequestStreamRef(
                    self.net, p.commit_stream._process,
                    q.raw_version_stream.endpoint,
                )
                for q in proxies
                if q is not p
            ]
        return GenerationRoles(
            self.epoch, sequencer, proxies, resolvers, tlogs, procs,
            ping_tasks=ping_tasks, tlog_paths=tlog_paths,
        )

    def _rewire(self, gen: GenerationRoles, recovery_version: Version | None = None) -> None:
        """Point storage servers and every registered client view at the new
        generation (the MonitorLeader push), rolling storage back past the
        recovery version (phantom versions of UNKNOWN txns must evaporate)."""
        ls = gen.log_system
        for ss in self.storage:
            ss.set_tlog_source(
                ls.peek_ref(self.net, ss.process, ss.tag),
                ls.pop_ref(self.net, ss.process, ss.tag),
                recovery_version=recovery_version,
            )
        for tag in self.stream_consumers:
            self._wire_stream_consumer(gen, tag)
        for view in self.views:
            self._fill_view(view)

    def _fill_view(self, view: ClusterView) -> None:
        gen = self.generation
        client_proc = view._client_proc
        view.grvs = [

            RequestStreamRef(self.net, client_proc, p.grv_stream.endpoint)
            for p in gen.proxies
        ]
        view.commits = [
            RequestStreamRef(self.net, client_proc, p.commit_stream.endpoint)
            for p in gen.proxies
        ]
        if getattr(view, "pinned_smap", None) is not None:
            # a remote-region view reads its OWN replicas; only the write
            # path (grvs/commits) follows primary recoveries
            view.smap = view.pinned_smap
        else:
            view.smap = KeyPartitionMap(
                self.storage_splits,
                [
                    [
                        {
                            "getvalue": RequestStreamRef(self.net, client_proc, ss.getvalue_stream.endpoint),
                            "getkeyvalues": RequestStreamRef(self.net, client_proc, ss.getkv_stream.endpoint),
                            "getkey": RequestStreamRef(self.net, client_proc, ss.getkey_stream.endpoint),
                            "watch": RequestStreamRef(self.net, client_proc, ss.watch_stream.endpoint),
                        }
                        for ss in team
                    ]
                    for team in self._storage_teams()
                ],
            )
        view.epoch = self.epoch
        view.failure_monitor = self.failure_monitor

    def make_view(self, client_proc: SimProcess) -> ClusterView:
        view = ClusterView(None, None, None)
        view._client_proc = client_proc
        self._fill_view(view)
        self.views.append(view)
        return view

    # -- resolutionBalancing (masterserver.actor.cpp:964) --------------------
    async def _balance_resolvers(self) -> None:
        """Periodically move a resolver partition boundary toward the load:
        sample per-resolver conflict-range counts, ask the busiest resolver
        for a load-median split key, then install the new map everywhere at
        a version boundary.  The boundary is made race-free by DRAINING the
        commit plane (pause batchers, wait in-flight batches out) — the
        serialization the reference gets from committing the keyResolvers
        system-keyspace transaction through the pipeline itself."""
        while True:
            await self.loop.delay(
                self.knobs.RESOLUTION_BALANCE_INTERVAL, TaskPriority.COORDINATION
            )
            gen = self.generation
            if gen is None or self._recovering or len(gen.resolvers) < 2:
                continue
            try:
                await self._try_rebalance(gen)
            except (TimedOut, BrokenPromise):
                continue  # transient (mid-kill); next tick retries

    async def _try_rebalance(self, gen: GenerationRoles) -> None:
        cc = self._cc_proc()
        loads: list[int] = []
        for r in gen.resolvers:
            ref = RequestStreamRef(self.net, cc, r.metrics_stream.endpoint)
            rep = await ref.get_reply(ResolutionMetricsRequest(), timeout=1.0)
            loads.append(rep.load)
        total = sum(loads)
        if total < self.knobs.RESOLUTION_BALANCE_MIN_LOAD:
            return
        hi = max(range(len(loads)), key=lambda i: loads[i])
        others = (total - loads[hi]) / max(len(loads) - 1, 1)
        if loads[hi] < self.knobs.RESOLUTION_BALANCE_RATIO * max(others, 1.0):
            return
        neighbors = [i for i in (hi - 1, hi + 1) if 0 <= i < len(loads)]
        lo = min(neighbors, key=lambda i: loads[i])
        if loads[hi] <= loads[lo]:
            return
        ref = RequestStreamRef(self.net, cc, gen.resolvers[hi].metrics_stream.endpoint)
        srep = await ref.get_reply(ResolutionSplitRequest(), timeout=1.0)
        key = srep.key
        bounds: list[bytes | None] = [b""] + list(self.resolver_splits) + [None]
        plo, phi = bounds[hi], bounds[hi + 1]
        if key is None or key <= plo or (phi is not None and key >= phi):
            return  # no useful split inside the hot partition
        new_splits = list(self.resolver_splits)
        if lo == hi - 1:
            # left neighbor gains the partition's cold head [plo, key)
            new_splits[hi - 1] = key
            moved: tuple[bytes, bytes | None] = (plo, key)
        else:
            # right neighbor gains the tail [key, phi)
            new_splits[hi] = key
            moved = (key, phi)

        if gen is not self.generation or self._recovering:
            return
        for p in gen.proxies:
            p.pause_commits()
        try:
            await self._wait_commit_drain(gen)
            if gen is not self.generation or self._recovering:
                # a recovery raced us (possibly mid-_recover, before the
                # generation swap): its recruit used the old splits, so
                # committing this move would desync controller.resolver_splits
                # from the live proxy maps — bail; the next tick re-balances
                return
            vm = gen.sequencer._last_assigned + 1
            gen.resolvers[lo].install_moved_range(moved[0], moved[1], vm)
            for p in gen.proxies:
                p.install_resolver_splits(new_splits, vm)
            self.resolver_splits = new_splits
            self.resolver_moves += 1
            testcov("resolver.rebalance_move")
            self.trace.trace(
                "ResolverRebalance", From=hi, To=lo, Epoch=self.epoch,
                SplitKey=repr(key), EffectiveVersion=vm,
            )
        finally:
            for p in gen.proxies:
                p.resume_commits()

    async def _wait_commit_drain(self, gen: GenerationRoles) -> None:
        deadline = self.loop.now() + 5.0
        while any(p.inflight_batches for p in gen.proxies):
            if self.loop.now() >= deadline:
                raise TimedOut("commit plane never drained for rebalance")
            await self.loop.delay(0.005, TaskPriority.COORDINATION)

    def _start_generation_metrics(self, gen: GenerationRoles) -> None:
        """Every pipeline role of the newly installed generation emits its
        periodic `*Metrics` trace event (flow/Stats.h traceCounters cadence)
        into the cluster collector.  The emitters die with the role — via
        role.stop() or, for a deposed directly-constructed role, via the
        process-alive guard in spawn_role_metrics — so a stale generation
        never narrates over its successor."""
        iv = self.knobs.METRICS_INTERVAL
        gen.sequencer.start_metrics(self.trace, iv)
        for p in gen.proxies:
            p.start_metrics(self.trace, iv)
        for r in gen.resolvers:
            r.start_metrics(self.trace, iv)
        for t in gen.tlogs:
            t.start_metrics(self.trace, iv)

    def _teardown_generation(self, gen: GenerationRoles) -> None:
        """Dispose a generation that must not serve (lost cstate race,
        controller stop): worker-hosted roles are destroyed remotely —
        workers outlive generations — while directly-constructed ones lose
        their processes."""
        if gen.workers:
            from ..roles.worker import DestroyGenerationRequest

            for w in gen.workers:
                RequestStreamRef(
                    self.net, self._cc_proc(), w["recruit_ep"]
                ).send(DestroyGenerationRequest(gen.epoch))
            for role in [gen.sequencer] + gen.proxies + gen.resolvers + gen.tlogs:
                role.stop()
        else:
            for p in gen.processes:
                p.kill()

    def _on_proxy_failure(self, proxy, exc) -> None:
        """A proxy exhausted its commit-path retry budget (e.g. a partition
        between proxy and resolver that heartbeats can't see): its assigned
        versions may be chain holes, so the generation must end."""
        gen = self.generation
        if gen is None or proxy not in gen.proxies or self._recovering:
            return
        self.trace.trace(
            "ProxyCommitPathFailure", Error=repr(exc), Epoch=self.epoch
        )

        async def kick() -> None:
            try:
                await self._recover()
            except ActorCancelled:
                raise  # a deposed controller's kick must die, not log
            except Exception as e:  # noqa: BLE001 — monitor retries later
                self.trace.trace("MasterRecoveryError", Error=repr(e), Epoch=self.epoch)

        self.loop.spawn(kick(), TaskPriority.COORDINATION, "cc-proxy-failure")

    # -- dynamic configuration (ManagementAPI / \xff/conf) -------------------
    async def _watch_configuration(self) -> None:
        """Poll the system keyspace's `\xff/conf/` range (written by
        client/management.py configure()) and run a reconfiguration
        recovery when the desired write-pipeline role counts change — the
        reference's master reacts to txnStateStore config-key changes the
        same way (ManagementAPI.actor.cpp changeConfig; masterserver
        restarts on configuration version bump)."""
        from ..client.management import CONF_PREFIX

        view = None
        while True:
            await self.loop.delay(
                self.knobs.CONF_POLL_INTERVAL, TaskPriority.COORDINATION
            )
            if self.generation is None or self._recovering:
                continue
            if view is None:
                view = self.make_view(self._cc_proc())
            db = Database(self.loop, view, self.rng)
            tr = db.create_transaction()
            try:
                rows = await tr.get_range(CONF_PREFIX, CONF_PREFIX + b"\xff")
            except ActorCancelled:
                raise  # stop() cancelled the watch: exit, don't zombie-poll
            except Exception:  # noqa: BLE001 — recovery window; retry next
                # tick — unless a remote-region replica of the conf shard
                # can still serve: a whole-region kill takes out every
                # primary replica of `\xff/conf/`, and the watch must still
                # be able to READ the failover configuration committed to
                # recover from exactly that kill (commits only need the
                # pipeline, which is alive)
                rows = self._read_conf_rows_from_storage(fallback=True)
                if not rows:
                    continue
            parsed = parse_conf_rows(rows)
            conf = parsed["conf"]
            excluded = parsed["excluded"]
            locked = parsed["locked"]
            coord_n = parsed["coord_n"]
            maint = parsed["maint"]
            redundancy = parsed["redundancy"]
            throttle = parsed["throttle"]
            # compare DESIRED against the ACTUAL generation — never against
            # fields mutated by a previous (possibly failed) attempt, or a
            # committed reconfiguration could be dropped forever
            gen = self.generation
            if gen is None or self._recovering:
                continue

            # lock: applied to the live proxies directly (cheap, idempotent)
            self._locked = locked
            for p in gen.proxies:
                p.locked = locked

            # maintenance zones (fdbcli `maintenance`): healing suppression,
            # consulted by data distribution; expired deadlines drop out
            self.maintenance_zones = {
                z: d for z, d in maint.items() if d > self.loop.now()
            }

            # operator throttle (fdbcli `throttle`): a hard TPS ceiling on
            # the ratekeeper's admission budget
            if self.ratekeeper is not None:
                self.ratekeeper.manual_tps_cap = throttle

            # coordinator-set change (changeQuorum): delegated to the
            # assembly-installed hook, which owns Coordinator construction
            if (
                coord_n is not None
                and coord_n != self._coordinator_count
                and self.on_coordinators_change is not None
            ):
                try:
                    if await self.on_coordinators_change(coord_n):
                        # flowlint: ok check-then-act-across-await (single-writer: only this watch — one task — writes _coordinator_count)
                        self._coordinator_count = coord_n
                        testcov("management.coordinators_changed")
                        self.trace.trace(
                            "CoordinatorsChanged", Count=coord_n, Epoch=self.epoch
                        )
                except ActorCancelled:
                    raise  # cancelled mid-change: the watch is being torn down
                except Exception as e:  # noqa: BLE001 — next poll retries
                    self.trace.trace("CoordinatorsChangeError", Error=repr(e))
                # the hook awaited: a racing recovery may have swapped the
                # generation while we were suspended, and every decision
                # below (exclusion role check, desired-vs-actual counts)
                # must compare against the LIVE pipeline — re-resolve
                # (flowcheck stale-read audit)
                gen = self.generation
                if gen is None or self._recovering:
                    continue

            # exclusion: targets hosting pipeline roles force a recovery
            # (recruitment avoids excluded machines/workers); storage drains
            # via data distribution's exclusion loop.  The role check runs
            # EVERY poll, not only on change — a failed recovery must be
            # retried next tick.  Processed BEFORE the redundancy step so a
            # slow replica grow can never delay an exclusion taking effect.
            if excluded != self.excluded_targets:
                self.excluded_targets = excluded
                self.trace.trace(
                    "ExclusionChanged", Targets=sorted(excluded), Epoch=self.epoch
                )
            if excluded and any(self.is_excluded(p) for p in gen.processes):
                testcov("management.exclusion_recovery")
                try:
                    await self._recover()
                except ActorCancelled:
                    raise  # a deposed watcher must not keep recovering
                except Exception:  # noqa: BLE001 — next poll retries
                    pass
                continue

            # redundancy flip (configure redundancy=double/triple/...): data
            # distribution converges one replica per step until every team
            # matches.  A step can take tens of seconds (snapshot fetch +
            # durability wait), so it runs as a BACKGROUND task — the watch
            # must stay responsive for lock/exclusion/coordinator changes
            if redundancy is not None and self.on_redundancy_change is not None:
                try:
                    from ..rpc.policy import policy_for_redundancy

                    policy = policy_for_redundancy(redundancy)
                except ValueError:
                    self.trace.trace("RedundancyModeUnknown", Mode=redundancy)
                else:
                    target = policy.replicas()
                    if any(len(t) != target for t in self.storage_teams_tags):
                        self.replication_policy = policy
                        self._redundancy_pending = True
                        t = getattr(self, "_redundancy_step_task", None)
                        if t is None or t.done():
                            self._redundancy_step_task = self.loop.spawn(
                                self._redundancy_step(policy),
                                TaskPriority.COORDINATION, "cc-redundancy",
                            )
                    elif getattr(self, "_redundancy_pending", False):
                        t = getattr(self, "_redundancy_step_task", None)
                        if t is None or t.done():
                            # converged — declared only with no step in
                            # flight: an installed-but-not-yet-durable grow
                            # can still roll back (the durability wait may
                            # time out), so mid-step team sizes don't count
                            self._redundancy_pending = False
                            testcov("management.redundancy_converged")
                            self.trace.trace(
                                "RedundancyChanged", Mode=redundancy,
                                Epoch=self.epoch,
                            )
            # region configuration (configure_regions): enabling a second
            # region or flipping the primary runs through the assembly's
            # hook as a BACKGROUND step, like redundancy — a failover's
            # convergence wait (remote replicas catching the promotion
            # boundary) can take seconds and must not starve the watch.
            # Parsed against the APPLIED config as the base: a torn
            # region row must hold the current value, never decay to the
            # defaults (a decayed usable_regions=1 would read as a
            # legitimate request to dismantle the remote durability plane)
            from .region import parse_region_rows

            regions = (
                parse_region_rows(parsed["region_rows"],
                                  base=self.region_config)
                if parsed["region_rows"] is not None else None
            )
            if (
                regions is not None
                and regions != self.region_config
                and self.on_region_change is not None
            ):
                t = getattr(self, "_region_change_task", None)
                if t is None or t.done():
                    self._region_change_task = self.loop.spawn(
                        self._region_step(regions),
                        TaskPriority.COORDINATION, "cc-region",
                    )

            # storage-engine swap (configure engine=ssd/memory): a
            # replica-at-a-time migration through the dd heal path, run as
            # a BACKGROUND step like redundancy/region — it kills and
            # re-replicates servers, which takes many polls.  Drift is
            # desired-vs-APPLIED: the hook records the applied engine only
            # once every replica converged, so a failed half-migration is
            # re-entered (and resumed where it stopped) next poll.
            engine = parsed["engine"]
            if (
                engine is not None
                and self.on_engine_change is not None
                and self.applied_engine is not None
                and engine != self.applied_engine()
                and engine != getattr(self, "_engine_rejected", None)
            ):
                t = getattr(self, "_engine_step_task", None)
                if t is None or t.done():
                    self._engine_step_task = self.loop.spawn(
                        self._engine_step(engine),
                        TaskPriority.COORDINATION, "cc-engine",
                    )

            want_tlogs = conf.get("n_tlogs", len(gen.tlogs))
            want_proxies = conf.get("n_proxies", len(gen.proxies))
            want_res = conf.get("n_resolvers", len(gen.resolvers))
            if (
                want_tlogs == len(gen.tlogs)
                and want_proxies == len(gen.proxies)
                and want_res == len(gen.resolvers)
            ):
                continue
            self.n_tlogs = want_tlogs
            self.n_proxies = want_proxies
            if want_res != len(self.resolver_splits) + 1:
                # even re-split; the online rebalancer refines it afterwards
                self.resolver_splits = [
                    bytes([256 * i // want_res]) for i in range(1, want_res)
                ]
            self.trace.trace(
                "ConfigurationChanged", Epoch=self.epoch,
                NTlogs=want_tlogs, NProxies=want_proxies, NResolvers=want_res,
            )
            try:
                await self._recover()
            except ActorCancelled:
                raise  # teardown, not a failed reconfiguration
            except Exception:  # noqa: BLE001 — next poll re-detects the
                continue       # actual-vs-desired mismatch and retries

    async def _region_step(self, regions) -> None:
        """One region-configuration change, off the conf watch's critical
        path (the failover half of KillRegion.actor.cpp: the configure
        commit is the trigger, this applies it)."""
        old = self.region_config
        try:
            if await self.on_region_change(regions, old):
                self.region_config = regions
                testcov("region.config_applied")
                self.trace.trace(
                    "RegionConfigurationChanged",
                    UsableRegions=regions.usable_regions,
                    Satellite=regions.satellite, Primary=regions.primary,
                    Epoch=self.epoch,
                )
        except ActorCancelled:
            raise  # stop() cancelling a mid-flight failover is teardown,
                   # not a failed change — the promotion must die HERE
        except Exception as e:  # noqa: BLE001 — next poll re-detects the
            # configured-vs-applied mismatch and respawns the step
            self.trace.trace("RegionConfigurationError", Error=repr(e))

    async def _redundancy_step(self, policy) -> None:
        """One replica-change step, off the conf watch's critical path."""
        try:
            await self.on_redundancy_change(policy)
        except ActorCancelled:
            raise  # stop() cancelling a step is not an error
        except Exception as e:  # noqa: BLE001 — next poll respawns
            self.trace.trace("RedundancyChangeError", Error=repr(e))

    async def _engine_step(self, engine: str) -> None:
        """One storage-engine migration, off the conf watch's critical
        path (the `configure ssd` re-replication: kill one replica per
        heal, data distribution rebuilds it on the new engine)."""
        try:
            await self.on_engine_change(engine)
            testcov("management.engine_swapped")
            self.trace.trace(
                "StorageEngineChanged", Engine=engine, Epoch=self.epoch
            )
        except ActorCancelled:
            raise  # teardown, not a failed swap
        except ValueError as e:
            # PERMANENT refusal (replication too low, no durable fs): the
            # desired config is infeasible on this cluster, and re-entering
            # it every poll would trace-spam forever.  Record the rejected
            # value — the watch skips it until the operator configures
            # something else (review finding).
            self._engine_rejected = engine
            self.trace.trace(
                "StorageEngineChangeRejected", Engine=engine, Error=repr(e)
            )
        except Exception as e:  # noqa: BLE001 — next poll re-detects the
            # desired-vs-applied drift and resumes the migration
            self.trace.trace("StorageEngineChangeError", Error=repr(e))

    # -- failure monitoring -------------------------------------------------
    async def _monitor(self) -> None:
        """Heartbeat every pipeline process (the CC's failure monitor; the
        reference aggregates heartbeats + per-role waitFailure endpoints).
        A ping unanswered within FAILURE_TIMEOUT — kill, reboot, or
        partition — triggers a new generation."""
        cc = self._cc_proc()
        while True:
            await self.loop.delay(self.knobs.HEARTBEAT_INTERVAL, TaskPriority.COORDINATION)
            gen = self.generation
            if gen is None or self._recovering:
                continue
            dead: list[str] = []
            # snapshot: the ping awaits suspend, and the registry list must
            # not be iterated live across scheduling points (flowcheck)
            for p in list(gen.processes):
                ref = RequestStreamRef(self.net, cc, Endpoint(p.address, "wlt:ping"))
                try:
                    await ref.get_reply("ping", timeout=self.knobs.FAILURE_TIMEOUT)
                    self.failure_monitor.set_status(p.address, False)
                except (TimedOut, BrokenPromise):
                    self.failure_monitor.set_status(p.address, True)
                    dead.append(p.name)
            if dead and self.generation is gen:
                self.trace.trace(
                    "MasterRecoveryTriggered", Dead=dead, Epoch=self.epoch,
                )
                testcov("recovery.triggered")
                try:
                    await self._recover()
                except ActorCancelled:
                    raise  # a superseded monitor must die with its epoch
                except Exception as e:  # noqa: BLE001 — transient quorum
                    # loss etc. must not kill the monitor: log and retry on
                    # the next heartbeat tick
                    self.trace.trace(
                        "MasterRecoveryError", Error=repr(e), Epoch=self.epoch,
                    )

    def stop(self) -> None:
        if getattr(self, "_region_change_task", None) is not None:
            # a mid-flight region failover dies with its controller — the
            # promotion's convergence wait must never outlive stop()
            self._region_change_task.cancel()
        if getattr(self, "_redundancy_step_task", None) is not None:
            self._redundancy_step_task.cancel()
        if getattr(self, "_engine_step_task", None) is not None:
            # a mid-migration engine swap dies with its controller; the
            # desired-vs-applied drift survives in `\xff/conf/` for the
            # next life to resume
            self._engine_step_task.cancel()
        if getattr(self, "_register_task", None) is not None:
            self._register_task.cancel()
        if getattr(self, "_balance_task", None) is not None:
            self._balance_task.cancel()
        if getattr(self, "_conf_task", None) is not None:
            self._conf_task.cancel()
        if self._monitor_task is not None:
            self._monitor_task.cancel()
        if self.generation is not None:
            self._teardown_generation(self.generation)
