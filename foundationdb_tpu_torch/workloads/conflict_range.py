"""ConflictRange workload — the OCC abort-parity oracle
(fdbserver/workloads/ConflictRange.actor.cpp; specs
tests/rare/ConflictRangeCheck.txt).

Directly randomizes pairs of transactions with controlled interleaving and
asserts the cluster's OCC verdicts against first-principles expectations:

  tr_B takes its read version, reads range R; tr_A then commits a write W;
  tr_B then writes and commits.  Expected: B aborts iff W ∩ R ≠ ∅.

Because the sim is deterministic and we sequence A's commit strictly
between B's read and B's commit, the expectation is exact — any false
abort or false commit is a resolver bug.  This is the workload-level twin
of the kernel parity tests (tests/test_device.py).

Copy of the reference package's workload.
"""

from __future__ import annotations

from .base import Workload
from ..roles.types import NotCommitted


class ConflictRangeWorkload(Workload):
    description = "ConflictRange"

    def __init__(self, rounds: int = 40, keyspace: int = 30):
        self.rounds = rounds
        self.keyspace = keyspace
        self.false_aborts = 0
        self.false_commits = 0
        self.checked = 0

    def _rand_range(self, rng) -> tuple[bytes, bytes]:
        a = rng.random_int(0, self.keyspace)
        b = rng.random_int(0, self.keyspace)
        lo, hi = min(a, b), max(a, b) + 1
        return (b"cr/%03d" % lo, b"cr/%03d" % hi)

    async def start(self, cluster, rng) -> None:
        db = cluster.database()
        for _ in range(self.rounds):
            read_range = self._rand_range(rng)
            write_range = self._rand_range(rng)
            overlap = read_range[0] < write_range[1] and write_range[0] < read_range[1]

            tr_b = db.create_transaction()
            await tr_b.get_range(*read_range, snapshot=False)

            tr_a = db.create_transaction()
            tr_a.clear_range(*write_range)  # write conflict over the range
            await tr_a.commit()

            tr_b.set(b"cr/out", b"x")
            aborted = False
            try:
                await tr_b.commit()
            except NotCommitted:
                aborted = True
            self.checked += 1
            if aborted and not overlap:
                self.false_aborts += 1
            if not aborted and overlap:
                self.false_commits += 1

    async def check(self, cluster, rng) -> bool:
        # false commits are serializability violations — never acceptable.
        # false aborts are permitted by OCC in principle, but with this
        # controlled interleaving (no other writers) they indicate a bug too.
        return self.false_commits == 0 and self.false_aborts == 0

    def metrics(self) -> dict:
        return {
            "checked": self.checked,
            "false_aborts": self.false_aborts,
            "false_commits": self.false_commits,
        }
