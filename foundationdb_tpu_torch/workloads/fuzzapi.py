"""FuzzApiCorrectness — randomized API-call sequences asserting the client
surface never crashes and only throws registered errors
(fdbserver/workloads/FuzzApiCorrectness.actor.cpp + fdbrpc/actorFuzz.py:
generate adversarial call sequences, accept only sanctioned outcomes).

Hammers the transaction API with random ops over adversarial keys (empty,
near-`\\xff`, long, embedded NULs), inverted/empty ranges, zero/huge
limits, atomic ops with odd operand widths, option churn, mid-stream
reset/on_error, snapshot reads — and requires every outcome to be either
success or an error from the sanctioned set.  A final invariant write
proves the database still works afterwards.

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

from .base import Workload
from ..client.transaction import RETRYABLE_ERRORS
from ..roles.types import DatabaseLocked, MutationType
from ..runtime.combinators import wait_all

_SANCTIONED = RETRYABLE_ERRORS + (ValueError, KeyError, DatabaseLocked)

_ATOMICS = [
    MutationType.ADD, MutationType.BIT_AND, MutationType.BIT_OR,
    MutationType.BIT_XOR, MutationType.APPEND_IF_FITS,
    MutationType.MAX_, MutationType.MIN_,
    MutationType.BYTE_MIN, MutationType.BYTE_MAX,
]

_OPTIONS = [b"priority_batch", b"causal_write_risky", b"lock_aware",
            b"priority_system_immediate", b"bogus_option"]


def _fuzz_key(rng) -> bytes:
    kind = rng.random_int(0, 5)
    if kind == 0:
        return b""
    if kind == 1:
        return b"\xfe" + rng.random_bytes(rng.random_int(0, 3))
    if kind == 2:
        return b"fz/" + rng.random_bytes(rng.random_int(0, 40))
    if kind == 3:
        return b"fz/\x00\x00" + bytes([rng.random_int(0, 255)])
    if kind == 4:
        return b"fz/" + b"k" * rng.random_int(0, 200)
    k = rng.random_bytes(rng.random_int(1, 8))
    # stay out of the system keyspace: a fuzz clear_range must never wipe
    # `\xff/conf` (the reference fuzzes a restricted keyspace too)
    return (b"\xfe" + k[1:]) if k >= b"\xff" else k


class FuzzApiWorkload(Workload):
    description = "FuzzApi"

    def __init__(self, clients: int = 3, ops_per_client: int = 120):
        self.clients = clients
        self.ops_per_client = ops_per_client
        self.ops_run = 0
        self.sanctioned_errors = 0

    async def start(self, cluster, rng) -> None:
        db = cluster.database()

        async def client(crng) -> None:
            tr = db.create_transaction()
            for _ in range(self.ops_per_client):
                op = crng.random_int(0, 9)
                self.ops_run += 1
                try:
                    if op == 0:
                        await tr.get(_fuzz_key(crng))
                    elif op == 1:
                        await tr.get(_fuzz_key(crng), snapshot=True)
                    elif op == 2:
                        b, e = _fuzz_key(crng), _fuzz_key(crng)
                        await tr.get_range(
                            b, e, limit=crng.random_choice([0, 1, 7, 100000])
                        )
                    elif op == 3:
                        tr.set(_fuzz_key(crng), crng.random_bytes(crng.random_int(0, 300)))
                    elif op == 4:
                        tr.clear_range(_fuzz_key(crng), _fuzz_key(crng))
                    elif op == 5:
                        tr.atomic_op(
                            crng.random_choice(_ATOMICS), _fuzz_key(crng),
                            crng.random_bytes(crng.random_int(0, 12)),
                        )
                    elif op == 6:
                        tr.set_option(crng.random_choice(_OPTIONS))
                    elif op == 7:
                        tr.reset()
                    elif op == 8:
                        await tr.commit()
                        tr = db.create_transaction()
                    else:
                        await tr.get_read_version()
                except _SANCTIONED as e:  # noqa: PERF203 — the point
                    self.sanctioned_errors += 1
                    if isinstance(e, RETRYABLE_ERRORS):
                        try:
                            await tr.on_error(e)
                        except _SANCTIONED:
                            tr = db.create_transaction()
                    else:
                        tr = db.create_transaction()
            # anything OTHER than a sanctioned error propagates = failure

        await wait_all(
            [cluster.loop.spawn(client(rng.split())) for _ in range(self.clients)]
        )

    async def check(self, cluster, rng) -> bool:
        # the database still works after the fuzz
        db = cluster.database()

        async def fn(tr):
            tr.set(b"fz/alive", b"1")

        await db.run(fn)
        tr = db.create_transaction()
        return await tr.get(b"fz/alive") == b"1"

    def metrics(self) -> dict:
        return {"ops": self.ops_run, "sanctioned_errors": self.sanctioned_errors}
