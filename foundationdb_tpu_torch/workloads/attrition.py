"""Attrition workload — kill pipeline processes while other workloads run
(fdbserver/workloads/MachineAttrition.actor.cpp; composed with Cycle etc. in
specs like tests/fast/CycleTest.txt).

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

from .base import Workload


class AttritionWorkload(Workload):
    """Kills `kills` random write-pipeline processes, spaced by `interval`
    of virtual time.  Requires a RecoverableCluster (controller present)."""

    description = "Attrition"

    def __init__(self, kills: int = 2, interval: float = 3.0, start_delay: float = 1.0):
        self.kills = kills
        self.interval = interval
        self.start_delay = start_delay
        self.killed: list[str] = []

    async def start(self, cluster, rng) -> None:
        await cluster.loop.delay(self.start_delay)
        for _ in range(self.kills):
            gen = cluster.controller.generation
            victims = [p for p in gen.processes if p.alive]
            if victims:
                victim = rng.random_choice(victims)
                self.killed.append(victim.name)
                cluster.trace.trace("AttritionKill", Process=victim.name)
                victim.kill()
            await cluster.loop.delay(self.interval)

    async def check(self, cluster, rng) -> bool:
        # every kill must have produced a completed recovery
        return cluster.controller.recoveries >= len(self.killed) > 0

    def metrics(self) -> dict:
        return {"killed": self.killed}
