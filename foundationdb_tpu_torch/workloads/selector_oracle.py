"""Selector + SnapshotCache oracle workload — the chaos referee for the
client API layer (ROADMAP item #2 acceptance).

Every round commits a known batch of mutations (tracking a committed
MODEL dict, with CommitUnknownResult resolved through a per-round marker
key), then opens a read-your-writes transaction, applies more UNCOMMITTED
writes to it, and fires a barrage of randomized reads through the merged
(SnapshotCache, WriteMap) view:

    get_key(KeySelector)      vs naive bisect resolution over the model
    get_range(sel, sel)       vs the model slice between naive resolutions
    get_range(bytes, bytes)   vs the model slice
    get(key) read TWICE       vs the model (and cache-served must agree)

The naive oracle is the reference definition of a selector — base index
"last key < / <= anchor", plus offset, clamped to b"" / b"\\xff" — so any
divergence in the storage findKey walk, the shard-boundary continuation,
the RYW merge iterator, or a stale SnapshotCache entry shows up as a
byte-level mismatch.  Runs composed with attrition + swizzle clogging
under buggify, so resolution is exercised across failed storage replicas,
clogged links, and recoveries; retryable errors restart the round's read
phase via on_error (which drops cache + writes, like a real retry loop).

Keys are spread across single-byte prefixes so the default storage splits
put shard boundaries INSIDE the key population: negative- and positive-
offset walks must hop shards to resolve.

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

import bisect

from .base import Workload
from ..client.ryw import ReadYourWritesTransaction
from ..client.transaction import CommitUnknownResult, RETRYABLE_ERRORS
from ..roles.types import CLIENT_KEYSPACE_END, KeySelector


def naive_resolve(keys: list[bytes], sel: KeySelector) -> bytes:
    """Reference selector resolution over a SORTED key list: base position
    is the last key < anchor (or <= with or_equal), move `offset` keys
    right; off either end clamps to the keyspace boundary."""
    base = (
        bisect.bisect_right(keys, sel.key)
        if sel.or_equal
        else bisect.bisect_left(keys, sel.key)
    ) - 1
    i = base + sel.offset
    if i < 0:
        return b""
    if i >= len(keys):
        return CLIENT_KEYSPACE_END
    return keys[i]


class SelectorOracleWorkload(Workload):
    description = "SelectorOracle"

    def __init__(self, rounds: int = 3, checks_per_round: int = 10,
                 keyspace: int = 18):
        self.rounds = rounds
        self.checks_per_round = checks_per_round
        self.keyspace = keyspace
        self.checks = 0
        self.selector_checks = 0
        self.retries = 0
        self.failures: list = []  # recorded, asserted in check()

    def _key(self, i: int) -> bytes:
        # spread first bytes across [0x10, 0xEF]: the default shard splits
        # (evenly spaced single-byte prefixes) land inside the population
        return bytes([0x10 + (0xE0 * i) // self.keyspace]) + b"sel%03d" % i

    def _anchor(self, rng) -> bytes:
        # anchors on, between, below, and above the population
        kind = rng.random_int(0, 3)
        if kind == 0:
            return self._key(rng.random_int(0, self.keyspace - 1))
        if kind == 1:
            return self._key(rng.random_int(0, self.keyspace - 1)) + b"\x00"
        if kind == 2:
            return b"\x01below"
        return b"\xfe\xffabove"

    def _rand_sel(self, rng) -> KeySelector:
        return KeySelector(
            self._anchor(rng), rng.random_int(0, 1) == 1,
            rng.random_int(-5, 6),
        )

    async def _commit_round(self, db, rng, model: dict, r: int) -> None:
        """Commit a randomized batch against `model`, resolving
        CommitUnknownResult through the round's marker key."""
        marker = b"\x0fselmark/%03d" % r
        pend = dict(model)
        ops: list = []
        for _ in range(4):
            i = rng.random_int(0, self.keyspace - 1)
            if rng.random_int(0, 3) == 0:
                j = rng.random_int(0, self.keyspace - 1)
                b, e = sorted((self._key(i), self._key(j) + b"\xff"))
                ops.append(("clear", b, e))
                for k in list(pend):
                    if b <= k < e:
                        del pend[k]
            else:
                v = b"r%03d.%d" % (r, i)
                ops.append(("set", self._key(i), v))
                pend[self._key(i)] = v
        ops.append(("set", marker, b"1"))
        pend[marker] = b"1"

        tr = db.create_transaction()
        while True:
            try:
                for op in ops:
                    if op[0] == "set":
                        tr.set(op[1], op[2])
                    else:
                        tr.clear_range(op[1], op[2])
                await tr.commit()
                model.clear()
                model.update(pend)
                return
            except RETRYABLE_ERRORS as e:
                self.retries += 1
                if isinstance(e, CommitUnknownResult):
                    # the marker key decides whether the batch landed
                    await tr.on_error(e)
                    landed = await self._marker_landed(db, marker)
                    if landed:
                        model.clear()
                        model.update(pend)
                        return
                else:
                    await tr.on_error(e)

    async def _marker_landed(self, db, marker: bytes) -> bool:
        tr = db.create_transaction()
        while True:
            try:
                return await tr.get(marker) is not None
            except RETRYABLE_ERRORS as e:
                self.retries += 1
                await tr.on_error(e)

    def _model_range(self, merged: dict, b: bytes, e: bytes,
                     limit: int) -> list:
        return sorted(
            ((k, v) for k, v in merged.items() if b <= k < e)
        )[:limit]

    async def _read_phase(self, db, rng, model: dict) -> None:
        """One RYW transaction: uncommitted local writes + the randomized
        read barrage, every answer cross-checked against the merged model.
        Retryable read errors restart the phase (on_error drops the write
        map and the snapshot cache, so local writes are re-applied)."""
        while True:
            ryw = ReadYourWritesTransaction(db)
            merged = dict(model)
            try:
                for _ in range(3):
                    i = rng.random_int(0, self.keyspace - 1)
                    if rng.random_int(0, 2) == 0:
                        b, e = self._key(i), self._key(i) + b"\xff\xff"
                        ryw.clear_range(b, e)
                        for k in list(merged):
                            if b <= k < e:
                                del merged[k]
                    else:
                        v = b"local.%d" % i
                        ryw.set(self._key(i), v)
                        merged[self._key(i)] = v
                keys = sorted(merged)
                for _ in range(self.checks_per_round):
                    kind = rng.random_int(0, 3)
                    if kind == 0:  # selector resolution
                        sel = self._rand_sel(rng)
                        got = await ryw.get_key(sel)
                        want = naive_resolve(keys, sel)
                        self.selector_checks += 1
                        if got != want:
                            self.failures.append(
                                ("get_key", sel, got, want)
                            )
                    elif kind == 1:  # selector-endpoint range
                        bs, es = self._rand_sel(rng), self._rand_sel(rng)
                        limit = rng.random_int(1, 12)
                        got = await ryw.get_range(bs, es, limit=limit)
                        b, e = naive_resolve(keys, bs), naive_resolve(keys, es)
                        want = (
                            [] if b >= e
                            else self._model_range(merged, b, e, limit)
                        )
                        if got != want:
                            self.failures.append(
                                ("get_range_sel", bs, es, got, want)
                            )
                    elif kind == 2:  # plain range over the merged view
                        b, e = sorted(
                            (self._anchor(rng), self._anchor(rng))
                        )
                        got = await ryw.get_range(b, e, limit=20)
                        want = self._model_range(merged, b, e, 20)
                        if got != want:
                            self.failures.append(("get_range", b, e, got, want))
                    else:  # point read, twice (second must be cache-served
                        # and still agree)
                        k = self._key(rng.random_int(0, self.keyspace - 1))
                        first = await ryw.get(k)
                        second = await ryw.get(k)
                        want = merged.get(k)
                        if first != want or second != want:
                            self.failures.append(("get", k, first, second, want))
                    self.checks += 1
                return
            except RETRYABLE_ERRORS as e:
                self.retries += 1
                await ryw.on_error(e)

    async def start(self, cluster, rng) -> None:
        db = cluster.database()
        model: dict[bytes, bytes] = {}
        for r in range(self.rounds):
            await self._commit_round(db, rng, model, r)
            await self._read_phase(db, rng, model)

    async def check(self, cluster, rng) -> bool:
        if self.failures:
            for f in self.failures[:5]:
                print(f"[SelectorOracle] divergence: {f}")
            return False
        return self.checks > 0 and self.selector_checks > 0

    def metrics(self) -> dict:
        return {
            "checks": self.checks,
            "selector_checks": self.selector_checks,
            "retries": self.retries,
            "divergences": len(self.failures),
        }
