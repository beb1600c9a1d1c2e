"""LowSpace workload — fill a storage disk until ratekeeper's free-space
limiting engages, then drain and prove admission recovers (the
storage_server_min_free_space story end to end: the cluster sheds load
BEFORE the disk melts down, and un-sheds when the operator adds space).

The victim is the first storage replica's store disk: its capacity is
clamped so ~35% is free, then a write burst fills it.  The workload
requires the ratekeeper `limit_reason` to pass through `free_space` (or
the e-brake, if the burst outruns the spring) while writing, and to
return to `unlimited` after the drain (capacity lifted + data cleared).
Composed with an invariant workload (Cycle), it also proves shedding
load never corrupts it.

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

from .base import Workload


class LowSpaceWorkload(Workload):
    description = "LowSpace"

    def __init__(self, rows: int = 600, value_bytes: int = 96,
                 start_delay: float = 0.5, free_at_start: float = 0.35):
        self.rows = rows
        self.value_bytes = value_bytes
        self.start_delay = start_delay
        self.free_at_start = free_at_start
        self.reasons_seen: list[str] = []
        self.engaged = False
        self.drained = False

    @staticmethod
    def _store_paths(store) -> list[str]:
        dq = getattr(store, "_dq", None)
        if dq is not None:  # durable memory engine: one WAL file
            return [dq.file.path]
        files = getattr(store, "_files", None)
        if files is not None:  # ssd engine: data files + header
            return [f.path for f in files] + [store._hdr.file.path]
        return []

    def _note(self, reason: str) -> None:
        if not self.reasons_seen or self.reasons_seen[-1] != reason:
            self.reasons_seen.append(reason)

    async def _await_reason(self, cluster, rk, want: tuple[str, ...],
                            ticks: int = 120) -> bool:
        for _ in range(ticks):
            await cluster.loop.delay(0.25)
            self._note(rk.limit_reason)
            if rk.limit_reason in want:
                return True
        return False

    async def start(self, cluster, rng) -> None:
        fs = getattr(cluster, "fs", None)
        rk = getattr(cluster, "ratekeeper", None)
        assert fs is not None and rk is not None, (
            "LowSpace needs a durable RecoverableCluster (disks + ratekeeper)"
        )
        await cluster.loop.delay(self.start_delay)
        ss = cluster.storage[0]
        paths = self._store_paths(ss.store)
        assert paths, "LowSpace: the victim store has no disk files"
        victim = paths[0]
        db = cluster.database()
        value = bytes(self.value_bytes)
        # fill first: the MVCC window holds the WAL flush back a few
        # virtual seconds, so write the burst, then wait for the disk to
        # actually absorb it (usage stops growing)
        for i in range(self.rows):
            async def body(tr, i=i):
                tr.set(b"low/%06d" % i, value)

            await db.run(body)
        last, stable = -1, 0
        for _ in range(200):
            await cluster.loop.delay(0.25)
            used, _cap = fs.usage_for(victim)
            stable = stable + 1 if used == last and used > 0 else 0
            last = used
            if stable >= 8:
                break
        # squeeze band first: capacity chosen so ~15% is free — inside
        # (MIN_FREE_SPACE_FRACTION, FREE_SPACE_TARGET_FRACTION), so the
        # spring compresses without slamming
        fs.set_capacity(victim, max(int(last / 0.85), last + 64))
        self.engaged = await self._await_reason(
            cluster, rk, ("free_space",)
        )
        # then the cliff: ~3% free is under the minimum — the e-brake
        # must slam admission to the floor
        fs.set_capacity(victim, max(int(last / 0.97), last + 8))
        braked = await self._await_reason(cluster, rk, ("e_brake",))
        self.engaged = self.engaged and braked
        # drain: the operator adds space and clears the bulk data; the
        # limit must release
        fs.set_capacity(victim, None)

        async def clear(tr):
            tr.clear_range(b"low/", b"low0")

        await db.run(clear)
        self.drained = await self._await_reason(cluster, rk, ("unlimited",))

    async def check(self, cluster, rng) -> bool:
        # every transition is REQUIRED: free_space that never engaged (or
        # an e-brake that never slammed) tested nothing, limiting that
        # never released is a wedged cluster
        return self.engaged and self.drained

    def metrics(self) -> dict:
        return {
            "reasons_seen": self.reasons_seen,
            "engaged": self.engaged,
            "drained": self.drained,
        }
