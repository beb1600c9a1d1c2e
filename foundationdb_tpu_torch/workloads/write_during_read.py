"""WriteDuringRead-style RYW fuzz — random interleavings of reads, writes,
and clears inside read-your-writes transactions, mirrored against a local
model (fdbserver/workloads/WriteDuringRead.actor.cpp: the workload that
polices the RYW machinery's every edge).

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

from .base import Workload


class WriteDuringReadWorkload(Workload):
    description = "WriteDuringRead"

    def __init__(self, txns: int = 20, ops_per_txn: int = 12, keys: int = 12):
        self.txns = txns
        self.ops = ops_per_txn
        self.keys = keys
        self.committed = 0
        self._model: dict[bytes, bytes] = {}  # committed state mirror

    def _key(self, rng) -> bytes:
        return b"wdr/%02d" % rng.random_int(0, self.keys)

    async def start(self, cluster, rng) -> None:
        db = cluster.database()
        for _ in range(self.txns):
            tr = db.create_ryw_transaction()
            local = dict(self._model)  # what RYW reads must show
            try:
                for _ in range(self.ops):
                    roll = rng.random()
                    k = self._key(rng)
                    if roll < 0.4:
                        v = b"v%d" % rng.random_int(0, 1000)
                        tr.set(k, v)
                        local[k] = v
                    elif roll < 0.55:
                        k2 = self._key(rng)
                        lo, hi = min(k, k2), max(k, k2 + b"\x00")
                        tr.clear_range(lo, hi)
                        for kk in [kk for kk in local if lo <= kk < hi]:
                            del local[kk]
                    elif roll < 0.85:
                        got = await tr.get(k)
                        assert got == local.get(k), (
                            f"RYW get({k!r}) = {got!r}, model {local.get(k)!r}"
                        )
                    else:
                        lo, hi = b"wdr/", b"wdr0"
                        got = await tr.get_range(lo, hi)
                        want = sorted(
                            (kk, vv) for kk, vv in local.items() if lo <= kk < hi
                        )
                        assert got == want, f"RYW range {got} != {want}"
                await tr.commit()
                self._model = local
                self.committed += 1
            except Exception as e:  # noqa: BLE001 — retryable → resync
                from ..client.transaction import RETRYABLE_ERRORS

                if isinstance(e, RETRYABLE_ERRORS):
                    # an unknown-result commit may have APPLIED: re-read the
                    # authoritative state instead of assuming the model
                    async def snap(tr):
                        return await tr.get_range(b"wdr/", b"wdr0", limit=10000)

                    self._model = dict(await db.run(snap))
                    continue
                raise

    async def check(self, cluster, rng) -> bool:
        db = cluster.database()

        async def fn(tr):
            return await tr.get_range(b"wdr/", b"wdr0", limit=10000)

        rows = await db.run(fn)
        return rows == sorted(self._model.items())

    def metrics(self) -> dict:
        return {"committed": self.committed}
