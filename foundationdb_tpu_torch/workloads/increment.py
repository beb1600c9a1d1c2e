"""Increment workload — atomic-op ledger accounting
(fdbserver/workloads/AtomicOps.actor.cpp: every transaction ADDs to a
random counter AND to a tally ledger IN THE SAME TRANSACTION, and the two
sides must agree exactly at the end.  An unknown-result retry may re-apply
a transaction — the reference accepts that and checks ATOMICITY instead:
a half-applied transaction, a lost mutation, or a replica divergence all
break counters == ledger, while a double-applied transaction moves both
sides together).

Copy of the reference package's workload.
"""

from __future__ import annotations

from .base import Workload
from ..roles.types import MutationType


class IncrementWorkload(Workload):
    description = "Increment"

    def __init__(self, counters: int = 4, clients: int = 3,
                 adds_per_client: int = 10, delta: int = 3):
        self.counters = counters
        self.clients = clients
        self.adds = adds_per_client
        self.delta = delta
        self.committed = 0

    def _key(self, i: int) -> bytes:
        return b"incr/%02d" % i

    async def start(self, cluster, rng) -> None:
        db = cluster.database()

        async def client(crng):
            for _ in range(self.adds):
                idx = crng.random_int(0, self.counters)

                async def fn(tr, idx=idx):
                    d = self.delta.to_bytes(8, "little")
                    tr.atomic_op(MutationType.ADD, self._key(idx), d)
                    tr.atomic_op(MutationType.ADD, b"incr/ledger", d)

                await db.run(fn)
                self.committed += 1

        from ..runtime.combinators import wait_all

        await wait_all(
            [cluster.loop.spawn(client(rng.split())) for _ in range(self.clients)]
        )

    async def check(self, cluster, rng) -> bool:
        db = cluster.database()

        async def fn(tr):
            return await tr.get_range(b"incr/", b"incr0", limit=1000)

        rows = await db.run(fn)
        counters = sum(
            int.from_bytes(v[:8], "little")
            for k, v in rows if k != b"incr/ledger"
        )
        ledger = next(
            (int.from_bytes(v[:8], "little") for k, v in rows
             if k == b"incr/ledger"), 0,
        )
        # every transaction moved both sides together, and nothing less
        # than the acked op count can be present
        return counters == ledger and ledger >= self.committed * self.delta

    def metrics(self) -> dict:
        return {"committed": self.committed}
