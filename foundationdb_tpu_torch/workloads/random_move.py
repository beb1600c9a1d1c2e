"""RandomMoveKeys — adversarial MoveKeys churn under load
(fdbserver/workloads/RandomMoveKeys.actor.cpp: the reference moves
random ranges to random teams while other workloads run, proving the
MoveKeys dance and data distribution survive concurrent interference).

Two modes:

* ``mode=random`` — the reference's shape: every interval, move one
  randomly chosen shard onto a randomly chosen OTHER serving team.
* ``mode=pileup`` — the anti-balancer: watch the sampled shard-load
  plane (dd.shard_load, the same waitMetrics-style poll DD itself uses)
  and move the busiest shard that is NOT on the hottest shard's team
  onto that team.  This manufactures exactly the imbalance the
  hot-shard relocation loop exists to undo — two busy shards on one
  team, a cooler team elsewhere — so a chaos spec composing this with
  skewed load deterministically drives dd.hot_shard_detected /
  dd.hot_shard_relocate instead of hoping churn lines up.

Moves go through the DataDistributor's own move_range (the two-phase
MoveKeys path), so they serialize against splits/heals on the _moving
mutex; a refused move (mover busy, mid-recovery) just retries next
interval.

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

from .base import Workload
from ..runtime.coverage import testcov


class RandomMoveKeysWorkload(Workload):
    description = "RandomMoveKeys"

    def __init__(
        self,
        mode: str = "random",
        moves: int = 2,
        interval: float = 1.0,
        duration: float = 10.0,
        start_delay: float = 0.0,
        min_bytes_per_ksec: float = 1000.0,
    ):
        if mode not in ("random", "pileup"):
            raise ValueError(f"mode must be random|pileup, got {mode!r}")
        self.mode = mode
        self.moves = moves
        self.interval = interval
        self.duration = duration
        self.start_delay = start_delay
        # pileup only piles shards that actually carry sampled traffic —
        # moving idle shards would not create a relocatable imbalance
        self.min_bytes_per_ksec = min_bytes_per_ksec
        self.moved = 0
        self.refused = 0

    def _plan(self, load: list[dict], rng):
        """-> (begin, end, dest_team) or None when no move applies."""
        if self.mode == "random":
            i = rng.random_int(0, len(load))
            src = set(load[i]["team"])
            others = [m["team"] for m in load if set(m["team"]) != src]
            if not others:
                return None
            dest = others[rng.random_int(0, len(others))]
            return load[i]["begin"], load[i]["end"], list(dest)
        combined = [
            m["bytes_read_per_ksec"] + m["bytes_written_per_ksec"]
            for m in load
        ]
        order = sorted(range(len(load)), key=lambda i: -combined[i])
        hot = order[0]
        hot_team = set(load[hot]["team"])
        victim = next(
            (
                j for j in order[1:]
                if set(load[j]["team"]) != hot_team
                and combined[j] >= self.min_bytes_per_ksec
            ),
            None,
        )
        if victim is None or combined[hot] < self.min_bytes_per_ksec:
            return None
        return (
            load[victim]["begin"], load[victim]["end"],
            list(load[hot]["team"]),
        )

    async def start(self, cluster, rng) -> None:
        dd = cluster.dd
        loop = cluster.loop
        if self.start_delay > 0:
            await loop.delay(self.start_delay)
        t_end = loop.now() + self.duration
        while loop.now() < t_end and self.moved < self.moves:
            await loop.delay(self.interval)
            cc = cluster.controller
            if cc.generation is None or cc._recovering:
                continue
            try:
                load = dd.shard_load()
            except KeyError:
                continue  # keyServers map churn mid-poll; retry
            if len(load) < 2:
                continue
            plan = self._plan(load, rng)
            if plan is None:
                continue
            b, e, dest = plan
            try:
                ok = await dd.move_range(b, e, dest)
            except IOError:
                continue  # disk fault plane refused; retry next interval
            if ok:
                self.moved += 1
                testcov("workload.random_move")
            else:
                self.refused += 1

    async def check(self, cluster, rng) -> bool:
        # the workload is interference, not an invariant: refusals are
        # legitimate (mover busy, recovery), so nothing to assert beyond
        # having survived
        return True

    def metrics(self) -> dict:
        return {"moves": self.moved, "refused": self.refused}
