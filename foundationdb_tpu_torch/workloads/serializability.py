"""Serializability workload — random transactions whose effects are
re-derivable only under a serial order (fdbserver/workloads/
Serializability.actor.cpp: random op sequences asserted equivalent to a
serial execution).

Each transaction performs a random mix over a small key domain:

    set    k := f(txn-id)              (state-independent write)
    add    k += delta                  (atomic; commutes, order-checked)
    clear  k                           (delete)
    copy   dst := read(src) + suffix   (STATE-DEPENDENT: a stale read here
                                       is a serializability violation the
                                       replay detects)

and journals its op list under a VERSIONSTAMPED key — so the journal's key
order IS the commit order (8-byte big-endian version + in-batch index).
`check` replays the journal serially against a model and compares the
model's final domain with the database's: any lost update, stale read
feeding a write, phantom commit (journal entry for an aborted txn), or
missing commit (committed txn absent from the journal) diverges.

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

import json

from .base import Workload
from ..client.transaction import RETRYABLE_ERRORS
from ..roles.types import MutationType, apply_atomic
from ..runtime.combinators import wait_all

DOMAIN = 12
LOG_PREFIX = b"ser/log/"
DATA_PREFIX = b"ser/d/"


def _dk(i: int) -> bytes:
    return DATA_PREFIX + b"%02d" % i


def _stamped_log_key() -> bytes:
    """Placeholder key: prefix + 10-byte stamp slot + little-endian offset
    of the slot (the API >= 520 versionstamped-key format)."""
    return (
        LOG_PREFIX + b"\x00" * 10 + len(LOG_PREFIX).to_bytes(4, "little")
    )


class SerializabilityWorkload(Workload):
    description = "Serializability"

    def __init__(self, clients: int = 3, txns_per_client: int = 12,
                 ops_per_txn: int = 4):
        self.clients = clients
        self.txns_per_client = txns_per_client
        self.ops_per_txn = ops_per_txn
        self.committed = 0
        self.unknown = 0

    def _gen_ops(self, rng, txn_id: str) -> list:
        ops = []
        for j in range(self.ops_per_txn):
            kind = rng.random_int(0, 3)
            k = rng.random_int(0, DOMAIN - 1)
            if kind == 0:
                ops.append(["set", k, f"{txn_id}.{j}"])
            elif kind == 1:
                ops.append(["add", k, rng.random_int(1, 9)])
            elif kind == 2:
                ops.append(["clear", k])
            else:
                ops.append(["copy", k, rng.random_int(0, DOMAIN - 1), f"+{txn_id}"])
        return ops

    async def start(self, cluster, rng) -> None:
        db = cluster.database()

        async def client(crng, cid: int):
            for t in range(self.txns_per_client):
                txn_id = f"c{cid}t{t}"
                ops = self._gen_ops(crng, txn_id)
                tr = db.create_transaction()
                while True:
                    try:
                        for op in ops:
                            if op[0] == "set":
                                tr.set(_dk(op[1]), op[2].encode())
                            elif op[0] == "add":
                                tr.atomic_op(
                                    MutationType.ADD, _dk(op[1]),
                                    int(op[2]).to_bytes(8, "little"),
                                )
                            elif op[0] == "clear":
                                tr.clear(_dk(op[1]))
                            else:  # copy: state-dependent
                                src = await tr.get(_dk(op[1]))
                                tr.set(
                                    _dk(op[2]),
                                    (src or b"<nil>") + op[3].encode(),
                                )
                        tr.atomic_op(
                            MutationType.SET_VERSIONSTAMPED_KEY,
                            _stamped_log_key(),
                            json.dumps(ops).encode(),
                        )
                        await tr.commit()
                        self.committed += 1
                        break
                    except RETRYABLE_ERRORS as e:
                        from ..client.transaction import CommitUnknownResult

                        if isinstance(e, CommitUnknownResult):
                            # the journal entry decides whether it landed;
                            # regenerate the txn id so a double-landing
                            # would be visible as two entries
                            self.unknown += 1
                            await tr.on_error(e)
                            break
                        await tr.on_error(e)

        await wait_all(
            [
                cluster.loop.spawn(client(rng.split(), c))
                for c in range(self.clients)
            ]
        )

    async def check(self, cluster, rng) -> bool:
        db = cluster.database()
        tr = db.create_transaction()
        journal = await tr.get_range(LOG_PREFIX, LOG_PREFIX + b"\xff",
                                     limit=100000)
        actual_rows = await tr.get_range(DATA_PREFIX, DATA_PREFIX + b"\xff",
                                         limit=100000)
        # serial replay in commit order (journal key order)
        model: dict[int, bytes] = {}
        for _k, v in journal:
            for op in json.loads(v):
                if op[0] == "set":
                    model[op[1]] = op[2].encode()
                elif op[0] == "add":
                    model[op[1]] = apply_atomic(
                        MutationType.ADD, model.get(op[1]),
                        int(op[2]).to_bytes(8, "little"),
                    )
                elif op[0] == "clear":
                    model.pop(op[1], None)
                else:
                    src = model.get(op[1])
                    model[op[2]] = (src or b"<nil>") + op[3].encode()
        expect = {_dk(i): v for i, v in model.items()}
        actual = dict(actual_rows)
        if expect != actual:
            only_e = {k for k in expect if actual.get(k) != expect[k]}
            only_a = {k for k in actual if expect.get(k) != actual[k]}
            print(f"[Serializability] divergence: expect!={only_e}, "
                  f"actual!={only_a}")
            return False
        # every definite commit journaled exactly once (no phantom/missing)
        if len(journal) < self.committed:
            print(f"[Serializability] journal {len(journal)} < committed "
                  f"{self.committed}")
            return False
        if len(journal) > self.committed + self.unknown:
            print(f"[Serializability] journal {len(journal)} > committed+unknown")
            return False
        return True

    def metrics(self) -> dict:
        return {"committed": self.committed, "unknown": self.unknown}
