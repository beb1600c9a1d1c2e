"""KillRegion workload — power-kill a whole region mid-burst and prove
zero committed-data loss (fdbserver/workloads/KillRegion.actor.cpp: the
reference configures usableRegions, kills a region's datacenter, forces
the failover through `configure`, and checks every acknowledged commit).

The workload is its own committed-model oracle: every burst commits its
keys TOGETHER with a watermark key (`kr/acked`) in one transaction, so
any state the cluster can ever serve is consistent — watermark W implies
keys 0..W-1 present with their deterministic values.  `self.acked` (the
highest burst this process saw acknowledged) must equal the watermark at
check time: an acked commit that vanished would leave W below it.

Two region kills in one run:

  1. the REMOTE region (log router + every remote replica) dies mid-burst
     and is rebooted from its disks (`restart_remote_region`): the
     replacement router re-pulls the retained TLog backlog
     (`region.router_repull`) and the replicas converge exactly,
  2. the PRIMARY storage region dies mid-burst, and failover is driven
     the first-class way — `configure_regions(primary="remote")` — which
     the controller's conf watch reads through the surviving remote
     replica (`region.conf_read_fallback`) and applies as a promotion.
     Commits (blind writes) keep flowing through the outage: the commit
     plane never needed the dead storage, which is exactly the
     region-redundancy claim.

Composable with PR-10 restart pairs: a `-1` spec adds SaveAndKill (kill
the whole sim AFTER the failover, reboot from disk in part 2 with
`action=verify` — the promoted keyServers map and every acked commit
must ride the reboot).

Buggify: `region.kill_point` jitters each kill instant (forced by a
seeded coin under chaos so campaigns explore both timings).

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

from .base import Workload
from ..runtime.buggify import buggify
from ..runtime.core import TaskPriority
from ..runtime.coverage import testcov

_ACKED_KEY = b"kr/acked"
_KEY_FMT = b"kr/k%06d"


class KillRegionWorkload(Workload):
    description = "KillRegion"

    def __init__(self, keys: int = 48, burst: int = 8,
                 start_delay: float = 0.3, kill_jitter: float = 0.5,
                 cycle_remote: bool = True, action: str = "full") -> None:
        if action not in ("full", "verify"):
            raise ValueError(f"action must be full|verify, got {action!r}")
        self.keys = keys
        self.burst = burst
        self.start_delay = start_delay
        self.kill_jitter = kill_jitter
        self.cycle_remote = cycle_remote
        self.action = action
        self.acked = 0          # highest burst end acknowledged to us
        self.part1_acked = 0    # what part 1 had acked at the power kill
        self.kills: list[str] = []

    def restart_state(self) -> dict:
        return {"keys": self.keys}

    def load_restart_manifest(self, manifest: dict) -> None:
        """Anchor the verify half to part 1's RECORDED progress: every
        commit part 1 acknowledged must be covered by the rebooted
        watermark — on a seed where chaos crawled the commit plane and
        part 1 acked nothing before the kill, the check is vacuous but
        honest, never a guess."""
        m = manifest.get("part1_metrics", {}).get(self.description, {})
        self.part1_acked = int(m.get("acked") or 0)

    @staticmethod
    def _value(i: int) -> bytes:
        return b"v%d" % (i * 7919 + 13)

    async def setup(self, cluster, rng) -> None:
        from ..runtime import buggify as _buggify

        if self.action == "full" and _buggify.is_enabled():
            # deterministic per-seed arming: half a campaign's seeds jitter
            # the kill instants, the other half keep the clean timing
            if rng.coinflip(0.5):
                _buggify.force("region.kill_point", times=2)

    async def _commit_through(self, db, hi: int) -> None:
        lo = self.acked

        async def fn(tr, lo=lo, hi=hi):
            for i in range(lo, hi):
                tr.set(_KEY_FMT % i, self._value(i))
            tr.set(_ACKED_KEY, b"%d" % hi)

        await db.run(fn)  # retrying; on return the commit is ACKNOWLEDGED
        self.acked = hi

    async def _kill_region(self, cluster, rng, region: str) -> None:
        """Power-kill every process in one region at once (the correlated
        loss KillRegion.actor.cpp injects)."""
        if buggify("region.kill_point"):
            # a region does not consult the test plan for a good moment
            await cluster.loop.delay(rng.random() * self.kill_jitter)
        if region == "remote":
            victims = [s.process for s in cluster.remote_storage]
            if cluster.log_router is not None:
                victims.append(cluster.log_router.process)
        else:
            victims = [
                s.process for s in cluster.storage
                if s.tag.startswith("ss-")
            ]
        for p in victims:
            if p.alive:
                p.kill()
        self.kills.append(region)
        testcov("region.kill")
        cluster.trace.trace(
            "RegionKilled", Region=region, Procs=len(victims),
        )

    async def _wait_remote_converged(self, cluster, db) -> None:
        v = [0]

        async def fn(tr):
            v[0] = await tr.get_read_version()

        await db.run(fn)
        for _ in range(4000):
            if all(s.version.get() >= v[0] for s in cluster.remote_storage):
                return
            await cluster.loop.delay(0.05, TaskPriority.DEFAULT_DELAY)
        raise AssertionError("remote region never converged after reboot")

    async def start(self, cluster, rng) -> None:
        if self.action == "verify":
            return  # part 2 of a restarting pair: the data rode the reboot
        assert cluster.remote_storage, (
            "KillRegion needs a two-region cluster (usableRegions=2)"
        )
        from ..client.management import configure_regions

        db = cluster.database()
        await cluster.loop.delay(self.start_delay)
        third = max(1, self.keys // 3)

        # phase 1: burst, then lose and reboot the REMOTE region
        await self._commit_through(db, third)
        if self.cycle_remote:
            await self._kill_region(cluster, rng, "remote")
            await self._commit_through(db, 2 * third)  # mid-outage traffic
            cluster.restart_remote_region()
            await self._wait_remote_converged(cluster, db)
        else:
            await self._commit_through(db, 2 * third)

        # phase 2: lose the PRIMARY storage region mid-burst; failover is
        # configure-driven (the KillRegion.actor.cpp contract)
        await self._kill_region(cluster, rng, "primary")
        await configure_regions(db, usable_regions=2, primary="remote")
        # blind writes keep committing through the outage: the commit
        # plane (proxies/resolvers/TLogs) never needed the dead storage
        await self._commit_through(db, self.keys)
        for _ in range(6000):
            if cluster._region_promoted:
                break
            await cluster.loop.delay(0.05, TaskPriority.DEFAULT_DELAY)
        assert cluster._region_promoted, (
            "configure-driven region failover never completed"
        )
        testcov("region.failover_complete")

    async def check(self, cluster, rng) -> bool:
        db = cluster.database()

        async def fn(tr):
            w = await tr.get(_ACKED_KEY)
            rows = await tr.get_range(b"kr/k", b"kr/l", limit=1 << 20)
            return w, rows

        w, rows = await db.run(fn)
        if w is None:
            # no watermark at all: only legal when nothing was ever acked
            # (a chaos-crawled part 1 killed before its first ack)
            return not rows and self.acked == 0 and self.part1_acked == 0
        watermark = int(w)
        if self.acked and watermark != self.acked:
            # an ACKNOWLEDGED commit did not survive the region loss (or a
            # phantom survived past the kill) — the exact contract violated
            return False
        if watermark < self.part1_acked:
            # part 1 acked further than the rebooted watermark reaches:
            # an acknowledged commit died in the reboot
            return False
        got = dict(rows)
        for i in range(watermark):
            if got.get(_KEY_FMT % i) != self._value(i):
                return False
        return len(got) == watermark

    def metrics(self) -> dict:
        return {"acked": self.acked, "kills": list(self.kills)}
