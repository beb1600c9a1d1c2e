"""Cycle workload — the canonical serializability invariant
(fdbserver/workloads/Cycle.actor.cpp).

N keys form a ring: key i stores the index of its successor.  Each
transaction picks a random node A, reads A -> B -> C, and swaps so A points
to C and B points past it — a 3-node rotation that keeps the graph a single
N-cycle *only if transactions are serializable*.  Lost updates, stale
reads, or phantom commits break the ring, which `check` detects by walking
it.

Copy of the reference package's workload.
"""

from __future__ import annotations

from .base import Workload
from ..client.transaction import RETRYABLE_ERRORS
from ..runtime.combinators import wait_all


def _key(i: int) -> bytes:
    return b"cycle/%04d" % i


class CycleWorkload(Workload):
    description = "Cycle"

    def __init__(self, nodes: int = 20, clients: int = 4, txns_per_client: int = 25):
        self.nodes = nodes
        self.clients = clients
        self.txns_per_client = txns_per_client
        self.committed = 0
        self.retries = 0

    async def setup(self, cluster, rng) -> None:
        db = cluster.database()

        async def fill(tr):
            for i in range(self.nodes):
                tr.set(_key(i), b"%d" % ((i + 1) % self.nodes))

        await db.run(fill)

    async def start(self, cluster, rng) -> None:
        db = cluster.database()

        async def client(crng):
            # a rotation retried after CommitUnknownResult is safe: on_error
            # fences the in-flight original, and the retry re-reads state —
            # either outcome of the original yields a valid rotation
            for _ in range(self.txns_per_client):
                tr = db.create_transaction()
                while True:
                    try:
                        a = crng.random_int(0, self.nodes)
                        b = int(await tr.get(_key(a)))
                        c = int(await tr.get(_key(b)))
                        d = int(await tr.get(_key(c)))
                        tr.set(_key(a), b"%d" % c)
                        tr.set(_key(b), b"%d" % d)
                        tr.set(_key(c), b"%d" % b)
                        await tr.commit()
                        self.committed += 1
                        break
                    except RETRYABLE_ERRORS as e:
                        self.retries += 1
                        await tr.on_error(e)

        await wait_all(
            [cluster.loop.spawn(client(rng.split())) for _ in range(self.clients)]
        )

    async def check(self, cluster, rng) -> bool:
        db = cluster.database()

        async def walk(tr):
            seen = set()
            cur = 0
            for _ in range(self.nodes):
                if cur in seen:
                    return False
                seen.add(cur)
                nxt = await tr.get(_key(cur))
                if nxt is None:
                    return False
                cur = int(nxt)
            return cur == 0 and len(seen) == self.nodes

        return await db.run(walk)

    def metrics(self) -> dict:
        return {"committed": self.committed, "retries": self.retries}

    def restart_state(self) -> dict:
        # the ring size IS the invariant: part 2 walking a different-sized
        # ring against part 1's disks would be checking nothing
        return {"nodes": self.nodes}
