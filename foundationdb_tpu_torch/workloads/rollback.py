"""Rollback workload — force a recovery that discards in-flight commits,
then prove no ACKNOWLEDGED commit was lost
(fdbserver/workloads/Rollback.actor.cpp: clog the proxy→TLog links while
commits are in flight, then kill the TLog so recovery rolls the
un-acknowledged suffix back; the reference's point is that rollback may
discard anything still in flight but never anything a client was told
committed).

Writer clients stream unique keys and record each commit the moment the
cluster ACKNOWLEDGES it; concurrently, each round the chaos half clogs
the commit plane mid-burst and kills a TLog process, forcing a generation
recovery while commits are stalled inside the pipeline.  `check` then
reads every acknowledged key back: all must be present with their exact
values (the durability contract), commits that ended CommitUnknownResult
are allowed either outcome, and at least one forced recovery must have
actually happened (a Rollback run that never rolled back tested
nothing).

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

from .base import Workload
from ..client.transaction import RETRYABLE_ERRORS
from ..roles.types import CommitUnknownResult
from ..runtime.combinators import wait_all
from ..runtime.coverage import testcov


class RollbackWorkload(Workload):
    description = "Rollback"

    def __init__(self, rounds: int = 2, clients: int = 2,
                 writes_per_client: int = 12, start_delay: float = 0.4,
                 interval: float = 1.2, clog_seconds: float = 0.5):
        self.rounds = rounds
        self.clients = clients
        self.writes_per_client = writes_per_client
        self.start_delay = start_delay
        self.interval = interval
        self.clog_seconds = clog_seconds
        self.acked: dict[bytes, bytes] = {}
        self.unknown: list[bytes] = []
        self.forced_recoveries = 0
        self._recoveries_before = 0

    async def start(self, cluster, rng) -> None:
        self._recoveries_before = cluster.controller.recoveries

        async def writer(ci: int, crng) -> None:
            db = cluster.database()
            for seq in range(self.writes_per_client):
                key = b"rollback/%d/%04d" % (ci, seq)
                val = b"v%d" % crng.random_int(0, 1 << 30)
                tr = db.create_transaction()
                while True:
                    try:
                        tr.set(key, val)
                        await tr.commit()
                        # the ack is the contract: from here this write
                        # must survive anything short of data loss
                        self.acked[key] = val
                        break
                    except CommitUnknownResult:
                        # either outcome is legal for an UNKNOWN commit;
                        # record it as such and move on — the bookkeeping
                        # must stay honest about what was acknowledged
                        self.unknown.append(key)
                        break
                    except RETRYABLE_ERRORS as e:
                        await tr.on_error(e)

        async def chaos(crng) -> None:
            from ..control.controller import RecoveryState

            await cluster.loop.delay(self.start_delay)
            for _ in range(self.rounds):
                # wait out any in-flight recovery first: the controller
                # COALESCES kills landing mid-recovery (_recover returns
                # on its re-entry guard), so a kill only forces a distinct
                # rollback when it lands on a fully-recovered generation
                settle = cluster.loop.now() + 60.0
                while (cluster.controller.recovery_state
                       != RecoveryState.FULLY_RECOVERED
                       and cluster.loop.now() < settle):
                    await cluster.loop.delay(0.2)
                gen = cluster.controller.generation
                tlogs = [t for t in gen.tlogs if t.process.alive]
                if not tlogs:
                    await cluster.loop.delay(self.interval)
                    continue
                victim = crng.random_choice(tlogs)
                # clog the victim against the whole commit plane first so
                # in-flight commits stall INSIDE the pipeline when it dies
                # (the reference's clogging-then-kill signature move)
                for proc in gen.processes:
                    if proc is not victim.process and proc.alive:
                        cluster.net.clog_pair(
                            victim.process.address, proc.address,
                            self.clog_seconds,
                        )
                await cluster.loop.delay(self.clog_seconds / 2)
                cluster.trace.trace("RollbackKill",
                                    Process=victim.process.name)
                victim.process.kill()
                self.forced_recoveries += 1
                testcov("rollback.forced_recovery")
                await cluster.loop.delay(self.interval)

        await wait_all(
            [cluster.loop.spawn(writer(i, rng.split()))
             for i in range(self.clients)]
            + [cluster.loop.spawn(chaos(rng.split()))]
        )

    async def check(self, cluster, rng) -> bool:
        if self.forced_recoveries == 0:
            return False
        # at least one COMPLETED recovery must separate the writes from
        # this read-back (a Rollback that never rolled back tested
        # nothing); not one-per-kill — co-composed chaos (attrition,
        # swizzle) can legitimately coalesce kills into one recovery
        if cluster.controller.recoveries <= self._recoveries_before:
            return False
        db = cluster.database()

        async def read_all(tr):
            out = {}
            # snapshot: tr.get suspends, and a retried read_all must walk a
            # stable key list even if a straggler writer raced in (flowcheck)
            for key in list(self.acked):
                out[key] = await tr.get(key)
            return out

        got = await db.run(read_all)
        lost = {k for k, v in self.acked.items() if got.get(k) != v}
        if lost:
            cluster.trace.trace("RollbackLostAckedCommit",
                                Keys=[k.decode() for k in sorted(lost)])
            return False
        return True

    def metrics(self) -> dict:
        return {
            "acked": len(self.acked),
            "unknown": len(self.unknown),
            "forced_recoveries": self.forced_recoveries,
        }
