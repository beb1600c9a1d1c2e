"""ConsistencyCheck — replica-equality verification after quiescence
(fdbserver/workloads/ConsistencyCheck.actor.cpp checkDataConsistency +
the QuietDatabase wait it runs under).

For every shard team: wait until each live replica has applied a fresh read
version (the quiet-database analog — nothing in flight below it), then read
the replica's ENTIRE holdings at that version and assert byte equality
across the team.  A dead replica is skipped (data distribution healing is
the component that would re-replicate it); a team with NO live replica
fails the check.

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

from .base import Workload
from ..roles.types import (
    FutureVersion,
    GetKeyValuesRequest,
    TransactionTooOld,
)
from ..rpc.stream import RequestStreamRef
from ..runtime.combinators import timeout_error
from ..runtime.core import BrokenPromise, TimedOut

_END = b"\xff\xff\xff\xff\xff\xff\xff\xff"  # past any user key in the sim


class ConsistencyCheckWorkload(Workload):
    description = "ConsistencyCheck"

    def __init__(self, quiesce_timeout: float = 30.0, attempts: int = 6):
        self.quiesce_timeout = quiesce_timeout
        self.attempts = attempts
        self.shards_checked = 0
        self.replicas_compared = 0
        self.rows_checked = 0

    async def start(self, cluster, rng) -> None:
        pass  # pure check-phase workload

    async def _check_shard(self, cluster, db, proc, begin, end, team) -> bool:
        """One shard's replica comparison at a FRESH read version (so a
        chaos seed's shrunken MVCC window can't age the version out while
        earlier shards were being compared)."""
        async def grv(tr):
            return await tr.get_read_version()

        v = await db.run(grv)
        live = [ss for ss in team if ss.process.alive]
        if not live:
            return False  # an entire team lost: data IS gone
        datasets = []
        for ss in live:
            # quiet-database wait: the replica must catch up to v
            try:
                await timeout_error(
                    cluster.loop, ss.version.when_at_least(v),
                    self.quiesce_timeout,
                )
            except TimedOut:
                return False
            ref = RequestStreamRef(cluster.net, proc, ss.getkv_stream.endpoint)
            rep = await ref.get_reply(
                GetKeyValuesRequest(begin, end, v, 1_000_000), timeout=10.0
            )
            datasets.append(rep.data)
        if any(d != datasets[0] for d in datasets[1:]):
            return False
        # count only the attempt that verified (retries must not inflate
        # the campaign-triage metrics)
        self.replicas_compared += len(datasets)
        self.rows_checked += len(datasets[0])
        self.shards_checked += 1
        return True

    async def check(self, cluster, rng) -> bool:
        db = cluster.database()
        proc = cluster.net.create_process(
            f"cons-check-{rng.random_unique_id()[:6]}"
        )
        teams = cluster.storage_teams()
        # clip each comparison to the shard's range: after a data-
        # distribution move a server may serve several segments, so full-
        # holdings reads would differ between teammates with different
        # OTHER assignments
        bounds = [b""] + list(cluster.storage_splits) + [_END]
        for shard, team in enumerate(teams):
            begin, end = bounds[shard], bounds[shard + 1]
            ok = False
            for attempt in range(self.attempts):
                # TRANSIENT failures retry with a fresh version (the
                # reference's ConsistencyCheck loops the same way): a
                # reply lost to chaos clogging, a replica still serving
                # FutureVersion mid-recovery, the version aging out of a
                # shrunken MVCC window, a whole team mid-reboot, or a
                # lagging quiesce wait — the environment being noisy.
                # Only a REPEATABLE failure (False on the last attempt
                # too) is an inconsistency verdict: real divergence is
                # durable, so retrying can't mask it.
                try:
                    ok = await self._check_shard(
                        cluster, db, proc, begin, end, team
                    )
                    if ok:
                        break
                except (TimedOut, BrokenPromise, TransactionTooOld,
                        FutureVersion):
                    if attempt == self.attempts - 1:
                        raise
                if attempt < self.attempts - 1:
                    await cluster.loop.delay(0.5)
            if not ok:
                return False
        return True

    def metrics(self) -> dict:
        return {
            "shards_checked": self.shards_checked,
            "replicas_compared": self.replicas_compared,
            "rows_checked": self.rows_checked,
        }
