"""Leader election over the coordinators (fdbserver/LeaderElection.h:31
tryBecomeLeader, LeaderElection.actor.cpp).

Candidates write themselves into the coordinators' leader register with the
quorum discipline and renew a lease; a candidate that reads a different
live leader backs off and watches.  Losing the lease (failure to renew
within the timeout) means any candidate may take over — the trigger for a
new cluster-controller generation.

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

import dataclasses
from typing import Any

from .coordination import CoordinatedState
from ..runtime.core import DeterministicRandom, EventLoop, TaskPriority


@dataclasses.dataclass
class LeaderRecord:
    leader_id: str
    endpoint_info: Any      # how to reach the leader (e.g. CC endpoints)
    lease_expires: float    # virtual time


class LeaderElector:
    """One candidate's election loop; `on_leader` fires when we win,
    `on_deposed` when we observe a newer leader or lose the lease."""

    def __init__(
        self,
        loop: EventLoop,
        cstate: CoordinatedState,
        rng: DeterministicRandom,
        candidate_id: str,
        endpoint_info: Any,
        lease: float = 2.0,
    ) -> None:
        self.loop = loop
        self.cstate = cstate
        self.rng = rng.split()
        self.id = candidate_id
        self.endpoint_info = endpoint_info
        self.lease = lease
        self.is_leader = False
        self.current_leader: LeaderRecord | None = None
        self._task = None

    def start(self, on_leader, on_deposed) -> None:
        self._task = self.loop.spawn(
            self._run(on_leader, on_deposed), TaskPriority.COORDINATION,
            f"elect-{self.id}",
        )

    async def _run(self, on_leader, on_deposed) -> None:
        while True:
            value, _gen = await self.cstate.read()
            rec: LeaderRecord | None = value
            now = self.loop.now()
            if rec is not None and rec.lease_expires > now and rec.leader_id != self.id:
                # live foreign leader: follow, poll again near lease expiry
                self.current_leader = rec
                if self.is_leader:
                    self.is_leader = False
                    on_deposed()
                await self.loop.delay(
                    max(rec.lease_expires - now, 0.05) + self.rng.random() * 0.1
                )
                continue
            # stale or ours: try to claim/renew
            claim = LeaderRecord(self.id, self.endpoint_info, now + self.lease)
            if await self.cstate.write(claim):
                self.current_leader = claim
                if not self.is_leader:
                    self.is_leader = True
                    on_leader()
                await self.loop.delay(self.lease / 2)  # renew at half-life
            else:
                if self.is_leader:
                    self.is_leader = False
                    on_deposed()
                await self.loop.delay(0.05 + self.rng.random() * 0.2)

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
