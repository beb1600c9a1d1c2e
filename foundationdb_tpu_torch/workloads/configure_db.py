"""ConfigureDatabase workload — random online reconfiguration under load
(fdbserver/workloads/ConfigureDatabase.actor.cpp: flip role counts,
redundancy modes, and the STORAGE ENGINE mid-traffic; every flip must
preserve every invariant).

Each step commits a random `configure` change (n_tlogs / n_proxies /
n_resolvers / redundancy double<->triple / engine memory<->ssd) and
waits for the cluster to converge before the next.  An engine flip is
the heaviest: the conf watch migrates one replica at a time through the
dd heal path (kill → re-replicate on the new engine), so convergence
means every replica's store is the new class.  Runs composed with an
invariant workload (Cycle, Increment) whose checks prove no flip lost
or forked data.

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

from .base import Workload
from ..client.management import configure


class ConfigureDatabaseWorkload(Workload):
    description = "ConfigureDatabase"

    def __init__(self, flips: int = 3, interval: float = 1.5,
                 include_redundancy: bool = True,
                 include_engine: bool = False,
                 engine_only: bool = False):
        self.flips = flips
        self.interval = interval
        self.include_redundancy = include_redundancy
        # engine flips need a durable cluster with replication >= 2 (the
        # migrating replica re-fetches from live teammates), so specs opt
        # in explicitly; engine_only pins EVERY flip to a swap — the
        # deterministic-migration spec shape (EngineSwap.txt)
        self.include_engine = include_engine or engine_only
        self.engine_only = engine_only
        self.applied = 0
        self.converged = 0
        self.engine_flips = 0

    def _choices(self) -> int:
        n = 3
        if self.include_redundancy:
            n += 1
        if self.include_engine:
            n += 1
        return n

    async def start(self, cluster, rng) -> None:
        db = cluster.database()
        cc = cluster.controller
        for _ in range(self.flips):
            await cluster.loop.delay(self.interval)
            # random_int is half-open [lo, hi)
            choice = (
                self._choices() - 1 if self.engine_only
                else rng.random_int(0, self._choices())
            )
            if choice == 0:
                want = {"n_tlogs": rng.random_int(2, 4)}
            elif choice == 1:
                want = {"n_proxies": rng.random_int(1, 3)}
            elif choice == 2:
                want = {"n_resolvers": rng.random_int(1, 3)}
            elif choice == 3 and self.include_redundancy:
                want = {"redundancy": rng.random_choice(["double", "triple"])}
            else:
                want = {
                    "engine": "ssd"
                    if cluster.storage_engine == "memory" else "memory"
                }
                self.engine_flips += 1
            await configure(db, **want)
            self.applied += 1

            def done() -> bool:
                gen = cc.generation
                if gen is None or cc._recovering:
                    return False
                if "n_tlogs" in want and len(gen.tlogs) != want["n_tlogs"]:
                    return False
                if "n_proxies" in want and len(gen.proxies) != want["n_proxies"]:
                    return False
                if "n_resolvers" in want and len(gen.resolvers) != want["n_resolvers"]:
                    return False
                if "redundancy" in want:
                    target = 2 if want["redundancy"] == "double" else 3
                    if any(len(t) != target for t in cc.storage_teams_tags):
                        return False
                if "engine" in want and cluster._engine_applied != want["engine"]:
                    # applied only once EVERY replica migrated — the swap's
                    # own convergence marker
                    return False
                return True

            for _ in range(600):
                if done():
                    self.converged += 1
                    break
                await cluster.loop.delay(0.1)

    async def check(self, cluster, rng) -> bool:
        # every requested flip converged (partial convergence = a wedged
        # reconfiguration path)
        return self.converged == self.applied

    def metrics(self) -> dict:
        return {"applied": self.applied, "converged": self.converged,
                "engine_flips": self.engine_flips}
