"""Bank-transfer workload — money-conservation invariant under contention
(the Inventory/Serializability family of reference workloads).

Copy of the reference package's workload.
"""

from __future__ import annotations

from .base import Workload
from ..roles.types import NotCommitted, TransactionTooOld
from ..runtime.combinators import wait_all


def _acct(i: int) -> bytes:
    return b"bank/%03d" % i


class BankWorkload(Workload):
    description = "Bank"

    def __init__(self, accounts: int = 10, clients: int = 4,
                 transfers_per_client: int = 20, initial: int = 100):
        self.accounts = accounts
        self.clients = clients
        self.transfers = transfers_per_client
        self.initial = initial
        self.committed = 0

    async def setup(self, cluster, rng) -> None:
        db = cluster.database()

        async def fill(tr):
            for i in range(self.accounts):
                tr.set(_acct(i), str(self.initial).encode())

        await db.run(fill)

    async def start(self, cluster, rng) -> None:
        db = cluster.database()

        async def client(crng):
            for _ in range(self.transfers):
                src = crng.random_int(0, self.accounts)
                dst = crng.random_int(0, self.accounts)
                amt = crng.random_int(1, 20)

                async def xfer(tr, src=src, dst=dst, amt=amt):
                    a = int(await tr.get(_acct(src)))
                    b = int(await tr.get(_acct(dst)))
                    if a < amt or src == dst:
                        return
                    tr.set(_acct(src), str(a - amt).encode())
                    tr.set(_acct(dst), str(b + amt).encode())

                await db.run(xfer)
                self.committed += 1

        await wait_all(
            [cluster.loop.spawn(client(rng.split())) for _ in range(self.clients)]
        )

    async def check(self, cluster, rng) -> bool:
        db = cluster.database()
        rows = await db.run(lambda tr: tr.get_range(b"bank/", b"bank0"))
        total = sum(int(v) for _k, v in rows)
        return len(rows) == self.accounts and total == self.accounts * self.initial

    def metrics(self) -> dict:
        return {"committed": self.committed}

    def restart_state(self) -> dict:
        # money conservation is relative to these: a part 2 declaring a
        # different account count or initial balance would assert the
        # wrong total against the saved disks
        return {"accounts": self.accounts, "initial": self.initial,
                "expected_total": self.accounts * self.initial}
