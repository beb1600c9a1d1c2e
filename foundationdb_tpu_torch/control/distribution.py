"""Data distribution — shard movement, splitting, and team healing
(fdbserver/DataDistribution.actor.cpp:562 dataDistributionTracker/QueueData;
MoveKeys.actor.cpp:875 startMoveKeys/finishMoveKeys;
storageserver.actor.cpp fetchKeys).

The distributor owns the keyServers map's evolution:

  * **move_range** — the MoveKeys dance, re-designed around this runtime's
    drained-version-boundary primitive instead of the reference's
    system-keyspace transactions:
      1. install a DUAL map at a drained boundary vm: the range's mutations
         are tagged to both the source and destination teams from vm on,
      2. each destination server runs fetchKeys (buffer its tag stream for
         the range, snapshot-read the source team, replay the buffer),
      3. once every destination is live, install the FINAL map (destination
         only) at a second drained boundary and refresh client views,
      4. after a safety delay (in-flight reads at old versions), the source
         team drops the range.
  * **splitting** — a shard whose key count exceeds DD_SHARD_SPLIT_KEYS is
    split at its median key and the hot half moved to the smallest team
    (dataDistributionTracker shardSplitter).
  * **healing** — a storage server that stops answering pings is replaced:
    a fresh server takes over the dead one's TAG (so the proxies' maps and
    the TLogs' tag streams are untouched) and fetchKeys-es every range the
    tag serves from its surviving teammates (teamTracker + the storage
    recruitment half of DataDistribution).

Copy of the reference package's module, on the port's own modules.
"""

from __future__ import annotations

import bisect

from ..roles.storage import TOP_KEY, MemoryKeyValueStore, StorageServer
from ..rpc.network import Endpoint
from ..rpc.stream import RequestStream, RequestStreamRef
from ..runtime.combinators import wait_all
from ..runtime.core import BrokenPromise, EventLoop, TaskPriority, TimedOut
from ..runtime.knobs import CoreKnobs
from ..runtime.coverage import testcov

WLT_SS_PING = "wlt:ss_ping"


class DataDistributor:
    def __init__(
        self,
        loop: EventLoop,
        net,
        knobs: CoreKnobs,
        controller,
        store_factory=None,  # (tag, process) -> IKeyValueStore for healing
    ) -> None:
        self.loop = loop
        self.net = net
        self.knobs = knobs
        self.cc = controller
        self.store_factory = store_factory or (
            lambda tag, proc: MemoryKeyValueStore()
        )
        self.moves = 0
        self.heals = 0
        self.shard_splits = 0
        self.shard_merges = 0
        self.hot_relocations = 0
        self.exclusion_drains = 0
        # ops freeze switch (fdbcli `datadistribution off` analog): stops
        # load-driven movement (splits/merges/hot relocations) — healing
        # and exclusion drains keep running, they are correctness moves
        self.frozen = False
        # boundaries THIS distributor created by splitting: the only merge
        # candidates — bootstrap shard boundaries are the cluster's
        # configured topology and are never collapsed (conservative vs the
        # reference, which merges any undersized pair; our tests and team
        # conventions assume the configured shards exist)
        self._split_boundaries: set[bytes] = set()
        self._moving = False
        self._seg_prev: tuple = (None, 0.0)  # write-rate differencing state
        self._metrics_tick = 0
        self._sizes: list | None = None  # cached shard size metrics
        self._counts: list | None = None
        self._heal_seq = 0
        self._pong_tasks: dict[str, object] = {}
        for ss in controller.storage:
            self._watch(ss)
        self._tasks = [
            loop.spawn(self._heal_loop(), TaskPriority.COORDINATION, "dd-heal"),
            loop.spawn(self._split_loop(), TaskPriority.COORDINATION, "dd-split"),
            loop.spawn(self._hot_shard_loop(), TaskPriority.COORDINATION, "dd-hot"),
            loop.spawn(self._exclusion_loop(), TaskPriority.COORDINATION, "dd-exclude"),
        ]

    # -- failure detection ---------------------------------------------------
    def _watch(self, ss: StorageServer) -> None:
        """Register a ping responder on the server's process (the storage
        half of the CC's failure monitor; a killed process stops answering)."""
        rs = RequestStream(ss.process, WLT_SS_PING)

        async def pong() -> None:
            while True:
                req = await rs.next()
                req.reply("pong")

        old = self._pong_tasks.pop(ss.tag, None)
        if old is not None:
            old.cancel()
        self._pong_tasks[ss.tag] = self.loop.spawn(
            pong(), TaskPriority.COORDINATION, f"dd-pong-{ss.tag}"
        )

    async def _heal_loop(self) -> None:
        cc = self.cc
        while True:
            await self.loop.delay(self.knobs.DD_PING_INTERVAL, TaskPriority.COORDINATION)
            if cc.generation is None or cc._recovering:
                continue
            ping_proc = cc._cc_proc()
            for ss in list(cc.storage):
                ref = RequestStreamRef(
                    self.net, ping_proc, Endpoint(ss.process.address, WLT_SS_PING)
                )
                try:
                    await ref.get_reply("ping", timeout=self.knobs.FAILURE_TIMEOUT)
                    cc.failure_monitor.set_status(ss.process.address, False)
                except (TimedOut, BrokenPromise):
                    cc.failure_monitor.set_status(ss.process.address, True)
                    if self._in_maintenance(ss):
                        # fdbcli `maintenance`: the zone's processes are being
                        # deliberately bounced — healing would churn data
                        testcov("dd.maintenance_skip")
                        continue
                    if cc._tag_to_ss.get(ss.tag) is ss:  # not already healed
                        try:
                            await self._heal(ss)
                        except (TimedOut, BrokenPromise, IOError):
                            # mid-recovery, or the disk fault plane refused
                            # a store/keyservers write; next tick retries —
                            # the heal loop itself must never die
                            continue

    def _in_maintenance(self, ss: StorageServer) -> bool:
        zones = getattr(self.cc, "maintenance_zones", {})
        if not zones:
            return False
        now = self.loop.now()
        return any(
            d > now and z in (
                getattr(ss.process, "machine", None),
                getattr(ss.process, "dc", None),
            )
            for z, d in zones.items()
        )

    async def _heal(self, dead: StorageServer) -> None:
        cc = self.cc
        tag = dead.tag
        bounds = [b""] + list(cc.storage_splits) + [None]
        ranges: list[tuple[bytes, bytes | None, list[str]]] = []
        for i, team in enumerate(cc.storage_teams_tags):
            if tag in team:
                # sources must be ALIVE, not merely named: with the whole
                # team dead (a region kill), healing would ground (clear)
                # the dead replica's recovered disk against a source that
                # can never answer — gutting the last durable copy of the
                # shard before any replacement holds it.  The disks must
                # stay untouched so a reboot-from-disk (or a region
                # failover to the remote replicas) still has every byte.
                srcs = [
                    t for t in team
                    if t != tag and cc._tag_to_ss[t].process.alive
                ]
                if not srcs:
                    testcov("dd.heal_no_live_source")
                    cc.trace.trace(
                        "DDHealImpossible", Tag=tag, Shard=i,
                        Reason="no live source replica",
                    )
                    return
                ranges.append((bounds[i], bounds[i + 1], srcs))
        if not ranges:
            # a server whose tag sits in NO team (a promotion or move is
            # mid-install) must not be "healed": the replacement would have
            # nothing to fetch, steal the store file, and stamp an empty
            # store with an advancing durable_version — a lying disk the
            # next reboot trusts
            testcov("dd.heal_no_range")
            cc.trace.trace(
                "DDHealImpossible", Tag=tag, Reason="tag serves no range",
            )
            return
        self._heal_seq += 1
        dead.stop()  # before reopening its store file: no straggler writes
        extra = {}
        if cc.machines:
            # replica-spread policy: avoid the dead machine AND every
            # surviving teammate's machine (preferring their DCs excluded
            # too), or the team collapses onto one failure domain
            survivor_m = {
                cc._tag_to_ss[t].process.machine
                for _b, _e, ts in ranges for t in ts
            }
            survivor_d = {
                cc._tag_to_ss[t].process.dc
                for _b, _e, ts in ranges for t in ts
            }
            forbidden = (
                survivor_m
                | {getattr(dead.process, "machine", None)}
                | cc.excluded_targets  # never heal ONTO an excluded machine
            )
            ring = [
                m for m in cc.machines
                if m[0] not in forbidden and m[1] not in survivor_d
            ] or [m for m in cc.machines if m[0] not in forbidden] or cc.machines
            m, d = ring[self._heal_seq % len(ring)]
            extra = {"machine": m, "dc": d}
        proc = self.net.create_process(
            f"storage-heal{self._heal_seq}-{tag}", **extra
        )
        store = self.store_factory(tag, proc)
        gen = cc.generation
        tlog = gen.tlogs[cc._tag_tlogs(tag)[0]]
        # start at the survivors' KNOWN-COMMITTED floor, never their applied
        # version: applied may include single-replica phantoms a recovery
        # later rolls back, and the replacement's durable_version initializes
        # to this start — a phantom start would trip the rewire's
        # durability-bound assert.  Anything between start and the fetch
        # snapshot is covered by the snapshot; the tag stream fills the rest.
        start_v = min(
            (cc._tag_to_ss[t].known_committed for _b, _e, ts in ranges for t in ts),
            default=0,
        )
        new_ss = StorageServer(
            proc, self.loop, self.knobs,
            tlog_peek_ref=RequestStreamRef(self.net, proc, tlog.peek_stream.endpoint),
            tlog_pop_ref=RequestStreamRef(self.net, proc, tlog.pop_stream.endpoint),
            tag=tag, store=store, start_version=start_v,
        )
        new_ss.start_metrics(cc.trace, self.knobs.METRICS_INTERVAL)
        cc.replace_storage_server(dead, new_ss)
        self._watch(new_ss)
        futs = []
        for b, e, src_tags in ranges:
            refs = [
                RequestStreamRef(
                    self.net, proc, cc._tag_to_ss[t].getkv_stream.endpoint
                )
                for t in src_tags
            ]
            futs.append(new_ss.start_fetch(b, e, start_v, refs))
        try:
            await wait_all(futs)
        except (TimedOut, BrokenPromise):
            # sources unreachable for the whole bounded fetch: kill the
            # half-empty replacement so the next ping cycle re-heals from
            # scratch (reads meanwhile fail over to survivors)
            for f in futs:
                f.cancel()
            new_ss.process.kill()
            new_ss.stop()
            testcov("dd.heal_retry")
            cc.trace.trace("DDHealRetry", Tag=tag)
            return
        for view in cc.views:
            cc._fill_view(view)
        cc.failure_monitor.forget(dead.process.address)
        self.heals += 1
        testcov("dd.healed")
        cc.trace.trace(
            "DDHealed", Tag=tag, Ranges=len(ranges), StartVersion=start_v,
        )

    # -- exclusion drain (ManagementAPI exclude -> zero-loss retirement) -----
    async def _exclusion_loop(self) -> None:
        """Retire storage replicas on excluded targets: each gets a live
        replacement on a non-excluded machine, data moved with zero loss
        (the reference's DataDistribution reacting to excludedServersPrefix:
        teams containing excluded servers are 'unhealthy' and rebuilt —
        DataDistribution.actor.cpp teamTracker + excludedServers watch)."""
        cc = self.cc
        while True:
            await self.loop.delay(self.knobs.DD_PING_INTERVAL, TaskPriority.COORDINATION)
            if cc.generation is None or cc._recovering or not cc.excluded_targets:
                continue
            for ss in list(cc.storage):
                if (
                    cc._tag_to_ss.get(ss.tag) is ss
                    and ss.process.alive
                    and cc.is_excluded(ss.process)
                    and not self._moving
                ):
                    # the drain and MoveKeys both mutate team state: mutual
                    # exclusion via the same _moving flag move_range takes
                    self._moving = True
                    try:
                        await self._drain(ss)
                    except (TimedOut, BrokenPromise):
                        continue  # mid-recovery; next tick retries
                    finally:
                        self._moving = False

    async def _drain(self, victim: StorageServer) -> bool:
        """Move a LIVE replica's responsibilities to a fresh server with
        zero data loss.  Unlike _heal, the victim is alive throughout: it
        keeps pulling and serving reads — it IS the snapshot source — but
        its store file and tag-queue pops are frozen so the replacement
        (which recovers that same file) is the only writer/popper."""
        cc = self.cc
        tag = victim.tag
        bounds = [b""] + list(cc.storage_splits) + [None]
        ranges: list[tuple[bytes, bytes | None, list[str]]] = []
        for i, team in enumerate(cc.storage_teams_tags):
            if tag in team:
                # victim first: authoritative for its own tag, always live
                ranges.append(
                    (bounds[i], bounds[i + 1], [tag] + [t for t in team if t != tag])
                )
        if not ranges:
            return True  # serves nothing: already drained
        self._heal_seq += 1
        src_servers = {
            t: cc._tag_to_ss[t] for _b, _e, ts in ranges for t in ts
        }
        victim.freeze_writes()  # before the replacement reopens its file
        extra = {}
        if cc.machines:
            mates_m = {
                s.process.machine for s in src_servers.values() if s is not victim
            }
            mates_d = {
                s.process.dc for s in src_servers.values() if s is not victim
            }
            forbidden = (
                mates_m
                | {getattr(victim.process, "machine", None)}
                | cc.excluded_targets
            )
            ring = [
                m for m in cc.machines
                if m[0] not in forbidden and m[1] not in mates_d
            ] or [m for m in cc.machines if m[0] not in forbidden] \
              or cc._placement_ring()
            m, d = ring[self._heal_seq % len(ring)]
            extra = {"machine": m, "dc": d}
        proc = self.net.create_process(f"storage-drain{self._heal_seq}-{tag}", **extra)
        store = self.store_factory(tag, proc)
        gen = cc.generation
        tlog = gen.tlogs[cc._tag_tlogs(tag)[0]]
        start_v = min(s.known_committed for s in src_servers.values())
        new_ss = StorageServer(
            proc, self.loop, self.knobs,
            tlog_peek_ref=RequestStreamRef(self.net, proc, tlog.peek_stream.endpoint),
            tlog_pop_ref=RequestStreamRef(self.net, proc, tlog.pop_stream.endpoint),
            tag=tag, store=store, start_version=start_v,
        )
        new_ss.start_metrics(cc.trace, self.knobs.METRICS_INTERVAL)
        cc.replace_storage_server(victim, new_ss)
        self._watch(new_ss)
        futs = []
        for b, e, src_tags in ranges:
            refs = [
                RequestStreamRef(
                    self.net, proc, src_servers[t].getkv_stream.endpoint
                )
                for t in src_tags
            ]
            futs.append(new_ss.start_fetch(b, e, start_v, refs))
        try:
            await wait_all(futs)
        except (TimedOut, BrokenPromise):
            # drain could not complete (e.g. recovery churn): roll back to
            # the live victim — its frozen state is intact, and any WAL
            # entries the replacement flushed are valid same-tag data
            for f in futs:
                f.cancel()
            new_ss.process.kill()
            new_ss.stop()
            cc.replace_storage_server(new_ss, victim)
            self._watch(victim)
            victim.unfreeze_writes()
            # a recovery may have swapped generations mid-drain; _rewire only
            # re-points servers in cc.storage (the replacement, at the time),
            # so the reinstated victim must be re-pointed at the CURRENT
            # generation or it would pull from a dead TLog forever
            gen2 = cc.generation
            if gen2 is not None:
                tlog2 = gen2.tlogs[cc._tag_tlogs(tag)[0]]
                victim.set_tlog_source(
                    RequestStreamRef(
                        self.net, victim.process, tlog2.peek_stream.endpoint
                    ),
                    RequestStreamRef(
                        self.net, victim.process, tlog2.pop_stream.endpoint
                    ),
                )
            testcov("dd.drain_retry")
            cc.trace.trace("DDExcludeDrainRetry", Tag=tag)
            return False
        for view in cc.views:
            cc._fill_view(view)
        victim.stop()  # fully retired; its process is now removable
        cc.failure_monitor.forget(victim.process.address)
        self.exclusion_drains += 1
        testcov("dd.excluded_drained")
        cc.trace.trace(
            "DDExcludedDrained", Tag=tag, From=victim.process.name,
            To=proc.name, StartVersion=start_v,
        )
        return True

    # -- redundancy convergence (configure redundancy=..., online) -----------
    async def converge_redundancy(self, policy) -> bool:
        """One replica-change step toward the policy's replication factor;
        True once every team matches.  The conf poll re-invokes each tick,
        so a double->triple flip adds one replica per tick per shard until
        converged — the online half of the reference's DatabaseConfiguration
        redundancy change (DD team rebuild under the new policy)."""
        cc = self.cc
        target = policy.replicas()
        if cc.generation is None or cc._recovering or self._moving:
            return False
        for i, team in enumerate(cc.storage_teams_tags):
            if len(team) == target:
                continue
            self._moving = True
            try:
                if len(team) < target:
                    await self._add_replica(i, policy)
                else:
                    await self._remove_replica(i)
            finally:
                self._moving = False
            return False  # one step per tick; next poll continues
        return True

    async def _add_replica(self, shard: int, policy) -> bool:
        """Grow one team: a fresh server takes a new tag, the proxies tag
        mutations for it from a drained boundary, and it fetches history
        from its teammates (startMoveKeys semantics for a team grow)."""
        cc = self.cc
        teams = [list(t) for t in cc.storage_teams_tags]
        splits = list(cc.storage_splits)
        bounds: list = [b""] + splits + [None]
        team = teams[shard]
        b, e = bounds[shard], bounds[shard + 1]
        existing = {cc._parse_tag(t)[1] for t in team}
        r = next(k for k in range(64) if k not in existing)
        tag = f"ss-{shard}-r{r}"
        members = [cc._tag_to_ss[t] for t in team]
        self._heal_seq += 1
        extra = {}
        if cc.machines:
            # policy-driven placement: the candidate must keep the grown
            # team valid (ReplicationPolicy::validate, not just "different
            # machine")
            from ..rpc.policy import Locality

            mlocs = [Locality.of(s.process) for s in members]
            used = {l.machine for l in mlocs}
            ring = cc._placement_ring()
            pick = None
            for idx in range(len(ring)):
                m, d = ring[(self._heal_seq + idx) % len(ring)]
                if m in used:
                    continue
                if policy.validate(mlocs + [Locality(f"cand-{m}", m, d)]):
                    pick = (m, d)
                    break
            if pick is None:
                pick = next((md for md in ring if md[0] not in used), None)
            if pick is None:
                cc.trace.trace("DDAddReplicaImpossible", Shard=shard, Tag=tag)
                return False
            extra = {"machine": pick[0], "dc": pick[1]}
        proc = self.net.create_process(
            f"storage-{shard}r{r}-g{self._heal_seq}", **extra
        )
        store = self.store_factory(tag, proc)
        gen = cc.generation
        tlog = gen.tlogs[cc._tag_tlogs(tag)[0]]
        start_v = min(s.known_committed for s in members)
        new_ss = StorageServer(
            proc, self.loop, self.knobs,
            tlog_peek_ref=RequestStreamRef(self.net, proc, tlog.peek_stream.endpoint),
            tlog_pop_ref=RequestStreamRef(self.net, proc, tlog.pop_stream.endpoint),
            tag=tag, store=store, start_version=start_v,
        )
        new_ss.start_metrics(cc.trace, self.knobs.METRICS_INTERVAL)
        cc._tag_to_ss[tag] = new_ss
        cc.storage.append(new_ss)
        new_teams = [list(t) for t in teams]
        new_teams[shard] = team + [tag]
        vm = await cc.install_storage_assignment(splits, new_teams)
        if vm is None:
            cc._tag_to_ss.pop(tag, None)
            cc.storage.remove(new_ss)
            new_ss.process.kill()
            new_ss.stop()
            return False
        self._watch(new_ss)
        refs = [
            RequestStreamRef(self.net, proc, s.getkv_stream.endpoint)
            for s in members
        ]
        fut = new_ss.start_fetch(b, e, vm, refs)
        try:
            await fut
            # durable before the persisted map names the new replica (the
            # move_range discipline: never persist a map pointing at data
            # that exists only in memory)
            vdone = new_ss.version.get()
            for _ in range(600):
                if new_ss.durable_version >= min(vdone, vm):
                    break
                await self.loop.delay(0.25, TaskPriority.COORDINATION)
            else:
                raise TimedOut("new replica durability never caught up")
        except (TimedOut, BrokenPromise):
            fut.cancel()
            while True:
                v2 = await cc.install_storage_assignment(splits, teams)
                if v2 is not None:
                    break
                await self.loop.delay(0.1, TaskPriority.COORDINATION)
            cc._tag_to_ss.pop(tag, None)
            cc.storage.remove(new_ss)
            old_pong = self._pong_tasks.pop(tag, None)
            if old_pong is not None:
                old_pong.cancel()
            new_ss.process.kill()
            new_ss.stop()
            testcov("dd.add_replica_retry")
            return False
        await cc.persist_key_servers(splits, new_teams)
        testcov("dd.replica_added")
        cc.trace.trace(
            "DDReplicaAdded", Shard=shard, Tag=tag, Machine=extra.get("machine"),
            Boundary=vm,
        )
        return True

    async def _remove_replica(self, shard: int) -> bool:
        """Shrink one team: drop the highest-numbered replica at a drained
        boundary, reclaim its TLog tag, retire the server."""
        from ..roles.types import TLogPopRequest

        cc = self.cc
        teams = [list(t) for t in cc.storage_teams_tags]
        splits = list(cc.storage_splits)
        team = teams[shard]
        if len(team) <= 1:
            return False
        drop = max(team, key=lambda t: cc._parse_tag(t)[1])
        new_teams = [list(t) for t in teams]
        new_teams[shard] = [t for t in team if t != drop]
        vm = await cc.install_storage_assignment(splits, new_teams)
        if vm is None:
            return False
        await cc.persist_key_servers(splits, new_teams)
        ss = cc._tag_to_ss.pop(drop, None)
        if ss in cc.storage:
            cc.storage.remove(ss)
        pong = self._pong_tasks.pop(drop, None)
        if pong is not None:
            pong.cancel()
        # reclaim the tag's TLog space (otherwise re-seeded every recovery)
        gen = cc.generation
        ccp = cc._cc_proc()
        if gen is not None:
            for idx in cc._tag_tlogs(drop):
                RequestStreamRef(
                    self.net, ccp, gen.tlogs[idx].pop_stream.endpoint
                ).send(TLogPopRequest(drop, vm + (1 << 40)))

        async def late_stop() -> None:
            # in-flight reads at pre-boundary versions drain first
            await self.loop.delay(1.5, TaskPriority.COORDINATION)
            if ss is not None:
                ss.stop()
                cc.failure_monitor.forget(ss.process.address)

        self._tasks.append(
            self.loop.spawn(late_stop(), TaskPriority.COORDINATION, "dd-retire")
        )
        testcov("dd.replica_removed")
        cc.trace.trace("DDReplicaRemoved", Shard=shard, Tag=drop, Boundary=vm)
        return True

    # -- shard splitting -----------------------------------------------------
    def _write_rates(self, gen, n_segs: int) -> list[float]:
        """Per-segment committed write bandwidth (bytes/s) from the proxies'
        StorageMetrics counters, differenced against the last poll."""
        totals = [0] * n_segs
        for p in gen.proxies:
            segw = p.seg_write_bytes
            if len(segw) != n_segs:
                continue  # map swap mid-poll; next tick realigns
            for i, v in enumerate(segw):
                totals[i] += v
        now = self.loop.now()
        prev, prev_t = self._seg_prev
        self._seg_prev = (totals, now)
        if prev is None or len(prev) != n_segs or now <= prev_t:
            return [0.0] * n_segs
        dt = now - prev_t
        return [max(t - pv, 0) / dt for t, pv in zip(totals, prev)]

    def shard_load(self) -> list[dict]:
        """Per-shard load from the storage servers' SAMPLED metric plane
        (the DataDistributionTracker poll: one waitMetrics-style query per
        shard, O(sampled keys), never a scan).  Each row: shard bounds,
        serving team, sampled bytes, and read/write bytes-per-ksec."""
        cc = self.cc
        bounds = [b""] + list(cc.storage_splits) + [None]
        out = []
        for i, team in enumerate(cc.storage_teams_tags):
            b, e = bounds[i], bounds[i + 1]
            hi = e if e is not None else TOP_KEY
            m = cc._tag_to_ss[team[0]].metrics_range(b, hi)
            # reads load-balance ACROSS replicas, each charging only the
            # server that served it: the team's read bandwidth is the SUM
            # over replicas (polling one server can hide a shard's entire
            # read load behind replica routing).  Writes apply on every
            # replica — the same logical traffic — so those dedupe with
            # max, which also rides over a just-healed replica's cold
            # sample.  Bytes likewise: every replica holds the same data.
            for t in team[1:]:
                m2 = cc._tag_to_ss[t].metrics_range(b, hi)
                m["bytes_read_per_ksec"] += m2["bytes_read_per_ksec"]
                m["bytes_written_per_ksec"] = max(
                    m["bytes_written_per_ksec"], m2["bytes_written_per_ksec"]
                )
                m["bytes"] = max(m["bytes"], m2["bytes"])
                m["sampled_keys"] = max(m["sampled_keys"], m2["sampled_keys"])
            m["begin"], m["end"] = b, e
            m["team"] = list(team)
            out.append(m)
        return out

    async def _split_loop(self) -> None:
        cc = self.cc
        while True:
            await self.loop.delay(self.knobs.DD_SPLIT_INTERVAL, TaskPriority.COORDINATION)
            gen = cc.generation
            if gen is None or cc._recovering or self._moving or self.frozen:
                continue
            teams = cc.storage_teams_tags
            if len(teams) < 2:
                continue
            bounds = [b""] + list(cc.storage_splits) + [None]
            # byte sizes come from the byte SAMPLE every tick (O(sampled
            # keys)); the key-count trigger still needs resident counts, so
            # those refresh only every few ticks (the reference samples, it
            # never rescans)
            load = self.shard_load()
            sizes = [m["bytes"] for m in load]
            self._metrics_tick += 1
            if self._counts is None or len(self._counts) != len(teams) \
                    or self._metrics_tick % 4 == 0:
                counts = []
                for i, team in enumerate(teams):
                    b, e = bounds[i], bounds[i + 1]
                    ss = cc._tag_to_ss[team[0]]
                    n, _bts = ss.shard_metrics(b, e if e is not None else TOP_KEY)
                    counts.append(n)
                self._counts = counts
            self._sizes = sizes
            counts = self._counts
            # committed write bandwidth: the proxies' exact differenced
            # counters OR the storage-side write sample, whichever sees
            # more — the sample survives proxy restarts, the counters
            # catch traffic too young for the decayed sample
            prates = self._write_rates(gen, len(teams))
            wrates = [
                max(p, m["bytes_written_per_ksec"] / 1e3)
                for p, m in zip(prates, load)
            ]

            # split candidates in priority order: write-HOT, then byte size,
            # then key count (the halves of the reference's shardSplitter
            # decision); a candidate without a usable split key falls
            # through instead of starving the others
            candidates = []
            hot_w = max(range(len(teams)), key=lambda i: wrates[i])
            if wrates[hot_w] > self.knobs.DD_SHARD_SPLIT_WRITE_BYTES_PER_SEC:
                candidates.append((hot_w, "write_hot"))
            hot_b = max(range(len(teams)), key=lambda i: sizes[i])
            if sizes[hot_b] > self.knobs.DD_SHARD_SPLIT_BYTES:
                candidates.append((hot_b, "bytes"))
            hot_c = max(range(len(teams)), key=lambda i: counts[i])
            if counts[hot_c] > self.knobs.DD_SHARD_SPLIT_KEYS:
                candidates.append((hot_c, "keys"))

            hot = key = reason = None
            for idx, why in candidates:
                ss = cc._tag_to_ss[teams[idx][0]]
                b, e = bounds[idx], bounds[idx + 1]
                # splitMetrics-style: the sampled byte-weighted median (a
                # too-sparse sample falls back to the exact key median)
                k = ss.sampled_split_point(b, e if e is not None else TOP_KEY)
                if k is not None:
                    hot, key, reason = idx, k, why
                    break
            if hot is None:
                # no split needed: consider a MERGE of adjacent tiny shards
                # (shardMerger, DataDistributionTracker): combined size
                # under the merge thresholds — a fraction of the split
                # point, so merge and split cannot oscillate.  Only
                # split-created boundaries are candidates.
                for i in range(len(teams) - 1):
                    if (
                        bounds[i + 1] in self._split_boundaries
                        and sizes[i] + sizes[i + 1] < self.knobs.DD_SHARD_MERGE_BYTES
                        and counts[i] + counts[i + 1] < self.knobs.DD_SHARD_MERGE_KEYS
                        # bandwidth hysteresis: a write-hot tiny pair must
                        # NOT merge, or it would re-split on the write_hot
                        # trigger forever (the reference's shardMerger
                        # consults bandwidth the same way)
                        and wrates[i] + wrates[i + 1]
                        < self.knobs.DD_SHARD_SPLIT_WRITE_BYTES_PER_SEC / 2
                    ):
                        try:
                            await self._merge_shards(i)
                        except IOError:
                            break  # disk fault plane; next tick recomputes
                        self._sizes = None  # boundary count changed
                        break
                continue
            if reason == "write_hot":
                testcov("dd.split_write_hot")
            cold = min(
                (i for i in range(len(sizes)) if set(teams[i]) != set(teams[hot])),
                key=lambda i: sizes[i],
                default=None,
            )
            if cold is None:
                continue
            e = bounds[hot + 1]
            try:
                moved = await self.move_range(key, e, list(teams[cold]))
            except IOError:
                # the keyservers/store disk refused mid-move (fault plane):
                # the split loop must survive and retry next tick
                continue
            if moved:
                self.shard_splits += 1
                self._split_boundaries.add(key)
                testcov("dd.shard_split")
                cc.trace.trace(
                    "DDShardSplit", SplitKey=repr(key), From=hot, To=cold,
                    HotKeys=sizes[hot],
                )

    # -- hot-shard relocation (read-hot analog) ------------------------------
    async def _hot_shard_loop(self) -> None:
        """Priority relocation queue for HOT shards (the reference's
        readHotShard detection feeding the relocation queue at
        PRIORITY_REBALANCE): a shard whose sampled read+write bandwidth
        exceeds DD_HOT_SHARD_BYTES_PER_KSEC moves — whole, via the normal
        two-phase MoveKeys — to the least-loaded team, hottest first, one
        relocation per tick.  Relocation only fires when it strictly
        improves the loaded team's total (anti-thrash), and the bandwidth
        sample restarts cold on the destination, which is natural
        hysteresis against ping-ponging the same shard."""
        cc = self.cc
        while True:
            await self.loop.delay(
                self.knobs.DD_HOT_RELOCATION_INTERVAL, TaskPriority.COORDINATION
            )
            if cc.generation is None or cc._recovering or self._moving \
                    or self.frozen:
                continue
            teams = cc.storage_teams_tags
            if len(teams) < 2:
                continue
            try:
                load = self.shard_load()
            except KeyError:
                continue  # map churn mid-poll; next tick realigns
            combined = [
                m["bytes_read_per_ksec"] + m["bytes_written_per_ksec"]
                for m in load
            ]
            hot_queue = sorted(
                (
                    i for i in range(len(load))
                    if combined[i] > self.knobs.DD_HOT_SHARD_BYTES_PER_KSEC
                ),
                key=lambda i: -combined[i],
            )
            if not hot_queue:
                continue
            team_load: dict[frozenset, float] = {}
            for i, m in enumerate(load):
                ts = frozenset(m["team"])
                team_load[ts] = team_load.get(ts, 0.0) + combined[i]
            for i in hot_queue:
                testcov("dd.hot_shard_detected")
                cc.trace.trace(
                    "DDHotShard", Begin=repr(load[i]["begin"]),
                    End=repr(load[i]["end"]),
                    BytesPerKSec=int(combined[i]), Team=load[i]["team"],
                )
                hot_ts = frozenset(load[i]["team"])
                others = [ts for ts in team_load if ts != hot_ts]
                if not others:
                    break  # one distinct team: nowhere to relocate
                cold_ts = min(others, key=lambda ts: team_load[ts])
                if team_load[cold_ts] + combined[i] >= team_load[hot_ts]:
                    continue  # would not improve the hot team's total
                dest = next(
                    list(m["team"]) for m in load
                    if frozenset(m["team"]) == cold_ts
                )
                b, e = load[i]["begin"], load[i]["end"]
                try:
                    moved = await self.move_range(b, e, dest)
                except IOError:
                    break  # disk fault plane; next tick retries
                if moved:
                    self.hot_relocations += 1
                    testcov("dd.hot_shard_relocate")
                    cc.trace.trace(
                        "DDHotShardMove", Begin=repr(b), End=repr(e),
                        BytesPerKSec=int(combined[i]), Dest=dest,
                    )
                break  # one relocation per tick, hottest first

    async def _merge_shards(self, i: int) -> bool:
        """Collapse adjacent shards i and i+1 into one (the reference's
        shardMerger): move the right shard onto the left's team with the
        normal MoveKeys machinery, then drop the boundary at a drained
        barrier.  Holds the _moving mutex END TO END — the collapse must
        not interleave with a heal/exclusion installer.  Returns False
        (no harm done) if a concurrent operation invalidated the plan."""
        if self._moving:
            return False
        self._moving = True
        try:
            return await self._merge_shards_inner(i)
        finally:
            self._moving = False

    async def _merge_shards_inner(self, i: int) -> bool:
        cc = self.cc
        bounds: list = [b""] + list(cc.storage_splits) + [None]
        teams = [list(t) for t in cc.storage_teams_tags]
        boundary = bounds[i + 1]
        dest = list(teams[i])
        if set(teams[i + 1]) != set(dest):
            moved = await self._move_range(boundary, bounds[i + 2], dest)
            if not moved:
                return False
        # re-read the live map: the move (or a racing operation) may have
        # reshaped it — collapse only if the boundary still exists and both
        # sides now share a team
        splits = list(cc.storage_splits)
        teams = [list(t) for t in cc.storage_teams_tags]
        if boundary not in splits:
            return False
        j = splits.index(boundary)
        if set(teams[j]) != set(teams[j + 1]):
            return False
        new_splits = splits[:j] + splits[j + 1:]
        new_teams = teams[:j + 1] + teams[j + 2:]
        vm = await cc.install_storage_assignment(new_splits, new_teams)
        if vm is None:
            return False
        await cc.persist_key_servers(new_splits, new_teams)
        self._split_boundaries.discard(boundary)
        self.shard_merges += 1
        testcov("dd.shard_merge")
        cc.trace.trace(
            "DDShardMerge", Boundary=repr(boundary), Shard=j, Boundary_v=vm
        )
        return True

    def _tag_serves_overlap(self, tag: str, begin: bytes, end: bytes | None) -> bool:
        """Does the CURRENT keyServers map route any of [begin, end) to tag?"""
        cc = self.cc
        bounds = [b""] + list(cc.storage_splits) + [None]
        for j, team in enumerate(cc.storage_teams_tags):
            if tag not in team:
                continue
            b, e = bounds[j], bounds[j + 1]
            if (end is None or b < end) and (e is None or begin < e):
                return True
        return False

    # -- MoveKeys ------------------------------------------------------------
    async def move_range(
        self, begin: bytes, end: bytes | None, dest_team: list[str]
    ) -> bool:
        """Move [begin, end) to dest_team.  The range must lie inside a
        single current shard.  Returns False (no state changed) if the move
        could not start; retries internally across recoveries once the dual
        map is installed, because from that point the map must converge."""
        if self._moving:
            return False
        self._moving = True
        try:
            return await self._move_range(begin, end, dest_team)
        finally:
            self._moving = False

    async def _move_range(
        self, begin: bytes, end: bytes | None, dest_team: list[str]
    ) -> bool:
        cc = self.cc
        splits = list(cc.storage_splits)
        teams = [list(t) for t in cc.storage_teams_tags]
        bounds: list = [b""] + splits + [None]
        i = bisect.bisect_right(splits, begin)
        lo, hi = bounds[i], bounds[i + 1]
        within = (hi is None) if end is None else (hi is None or end <= hi)
        if not (lo <= begin and within and (end is None or begin < end)):
            return False
        src_team = teams[i]
        if set(src_team) == set(dest_team):
            return False
        dual = src_team + [t for t in dest_team if t not in src_team]

        # boundary keys begin/end partition shard i; the moving segment
        # gets the dual team, flanking remnants keep the source team
        seg_splits, seg_teams = [], []
        if begin > lo:
            seg_splits.append(begin)
            seg_teams.append(list(src_team))
        seg_teams.append(dual)
        if end is not None and (hi is None or end < hi):
            seg_splits.append(end)
            seg_teams.append(list(src_team))
        new_splits = splits[:i] + seg_splits + splits[i:]
        new_teams = teams[:i] + seg_teams + teams[i + 1:]

        seg_idx = i + (1 if begin > lo else 0)
        vm = await cc.install_storage_assignment(new_splits, new_teams)
        if vm is None:
            return False  # recovery raced the dual install; nothing changed
        # persist the SOURCE-ONLY shape of the new boundaries: a restart
        # mid-move must forget the move (the destination's copy is not
        # durable yet) but keep shard boundaries consistent
        src_only = [list(t) for t in new_teams]
        src_only[seg_idx] = list(src_team)
        await cc.persist_key_servers(new_splits, src_only)

        src_servers = [cc._tag_to_ss[t] for t in src_team]
        dest_new = [cc._tag_to_ss[t] for t in dest_team if t not in src_team]
        futs = []
        for d in dest_new:
            refs = [
                RequestStreamRef(self.net, d.process, s.getkv_stream.endpoint)
                for s in src_servers
            ]
            futs.append(d.start_fetch(begin, end, vm, refs))
        try:
            await wait_all(futs)
            # the fetched data lives only in the destinations' overlays;
            # the flip may only be persisted once it is durable there, or a
            # power loss after the flip would strand the range on files the
            # map no longer points at
            vdone = max((d.version.get() for d in dest_new), default=vm)
            for _ in range(600):
                if all(d.durable_version >= vdone for d in dest_new):
                    break
                await self.loop.delay(0.25, TaskPriority.COORDINATION)
            else:
                raise TimedOut("destination durability never caught up")
        except (TimedOut, BrokenPromise):
            # a destination could not fetch (e.g. the whole source team
            # died): cancel the stragglers (their buffering state must not
            # shadow a later retry's), roll the map back to source-only —
            # the extra boundaries stay, which is harmless — and report
            # failure
            for f in futs:
                f.cancel()
            while True:
                v2 = await cc.install_storage_assignment(new_splits, src_only)
                if v2 is not None:
                    await cc.persist_key_servers(new_splits, src_only)
                    return False
                await self.loop.delay(0.1, TaskPriority.COORDINATION)

        # flip to the final map; a racing recovery re-recruits with the dual
        # map (harmless — both teams keep getting the data), so just retry
        final_teams = [list(t) for t in new_teams]
        final_teams[seg_idx] = list(dest_team)
        while True:
            v2 = await cc.install_storage_assignment(new_splits, final_teams)
            if v2 is not None:
                break
            await self.loop.delay(0.1, TaskPriority.COORDINATION)
        await cc.persist_key_servers(new_splits, final_teams)
        self.moves += 1
        testcov("dd.move_complete")
        cc.trace.trace(
            "DDMoveComplete", Begin=repr(begin), End=repr(end),
            Dest=dest_team, Boundary=vm,
        )

        async def drop_source() -> None:
            # in-flight reads hold versions below the flip; give them the
            # read-timeout window before discarding the source copy
            await self.loop.delay(1.5, TaskPriority.COORDINATION)
            for s in src_servers:
                # re-check against the CURRENT map: a later move may have
                # assigned (part of) the range back to this server
                if (
                    not self._tag_serves_overlap(s.tag, begin, end)
                    and cc._tag_to_ss.get(s.tag) is s
                ):
                    s.drop_range(begin, end)

        self._tasks.append(
            self.loop.spawn(drop_source(), TaskPriority.COORDINATION, "dd-drop")
        )
        return True

    def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._pong_tasks.values():
            t.cancel()
