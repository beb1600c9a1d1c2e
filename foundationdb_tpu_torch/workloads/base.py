"""Workload API — the TestWorkload pattern
(fdbserver/workloads/workloads.h:55-74: description/setup/start/check,
composed concurrently by the tester and checked after a quiet period).

A workload runs against a SimCluster's database; `run_workloads` composes
several concurrently (the reference composes e.g. Cycle + RandomClogging +
Attrition in one spec), waits for all `start` phases, then runs every
`check` — the post-condition gate.

Copy of the reference package's module, over the port's SimCluster.
"""

from __future__ import annotations

from ..cluster import SimCluster
from ..runtime.combinators import wait_all
from ..runtime.core import DeterministicRandom


class Workload:
    description = "workload"
    # part 2 of a restarting pair runs invariant workloads with
    # `runSetup=false` (the reference's restarting-spec convention): the
    # data under test is what RODE THE REBOOT, and a re-run setup would
    # overwrite it with a pristine copy that proves nothing
    run_setup = True

    async def setup(self, cluster: SimCluster, rng: DeterministicRandom) -> None:
        pass

    async def start(self, cluster: SimCluster, rng: DeterministicRandom) -> None:
        raise NotImplementedError

    async def check(self, cluster: SimCluster, rng: DeterministicRandom) -> bool:
        return True

    def metrics(self) -> dict:
        return {}

    def restart_state(self) -> dict:
        """Invariant-shaping config a restart manifest records (the Cycle
        ring size, the Bank total): part 2 refuses to boot when its
        same-named workload declares different values — it would check
        the wrong invariant against the saved disks."""
        return {}

    def load_restart_manifest(self, manifest: dict) -> None:
        """Part-2 hook: run_spec hands each workload the restart manifest
        (including `part1_metrics`, what part 1's workloads had actually
        achieved at the kill) before the run.  A verify-mode workload can
        anchor its checks to part 1's recorded progress — e.g. KillRegion
        requires the rebooted watermark to cover every commit part 1 had
        ACKNOWLEDGED, instead of guessing how far part 1 got before the
        buggify-jittered power kill landed."""


def run_workloads(
    cluster: SimCluster, workloads: list[Workload], deadline: float = 300.0
) -> dict:
    """Run setup → concurrent starts → checks; returns merged metrics.
    Raises AssertionError if any check fails."""
    rng = cluster.rng.split()

    async def driver():
        for w in workloads:
            if not w.run_setup:
                from ..runtime.coverage import testcov

                testcov("restart.setup_skipped")
                continue
            await w.setup(cluster, rng.split())
        await wait_all(
            [cluster.loop.spawn(w.start(cluster, rng.split())) for w in workloads]
        )
        results = {}
        for w in workloads:
            ok = await w.check(cluster, rng.split())
            assert ok, f"workload check failed: {w.description}"
            results[w.description] = w.metrics()
        return results

    return cluster.run_until(cluster.loop.spawn(driver()), deadline)
