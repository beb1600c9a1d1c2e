"""Swizzle workload — clog a random subset of the cluster's network links,
then unclog them in reverse order (the reference's swizzling clogging,
fdbrpc/sim2.actor.cpp + RandomClogging/Rollback workload family: the
reverse-order unclog is the signature move that surfaces ordering bugs).

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

from .base import Workload


class SwizzleWorkload(Workload):
    description = "Swizzle"

    def __init__(self, rounds: int = 2, victims: int = 3,
                 clog_seconds: float = 0.8, interval: float = 1.5,
                 start_delay: float = 0.5):
        self.rounds = rounds
        self.victims = victims
        self.clog_seconds = clog_seconds
        self.interval = interval
        self.start_delay = start_delay
        self.swizzles = 0

    async def start(self, cluster, rng) -> None:
        net = cluster.net
        await cluster.loop.delay(self.start_delay)
        for _ in range(self.rounds):
            alive = [p.address for p in net.processes.values() if p.alive]
            if len(alive) < 2:
                continue
            chosen = []
            for _ in range(min(self.victims, len(alive))):
                a = rng.random_choice(alive)
                if a not in chosen:
                    chosen.append(a)
            # clog each victim against every other process, staggered; the
            # REVERSE-order unclog emerges from the staggered expiries
            for i, addr in enumerate(chosen):
                stagger = self.clog_seconds * (len(chosen) - i) / len(chosen)
                for other in alive:
                    if other != addr:
                        net.clog_pair(addr, other, stagger)
            self.swizzles += 1
            await cluster.loop.delay(self.interval)

    async def check(self, cluster, rng) -> bool:
        return self.swizzles > 0

    def metrics(self) -> dict:
        return {"swizzles": self.swizzles}
