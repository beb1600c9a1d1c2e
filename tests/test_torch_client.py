"""The port's client (client/transaction.py, client/ryw.py,
client/snapshot_cache.py) against the reference's, each on its own
package's SimCluster with its OracleConflictSet, on the same seeds: the
scenarios of tests/test_ryw.py and tests/test_selectors.py (the ones that
need no control/ module) plus GRV, atomic ops, versionstamps, watches,
on_error retry and NotCommitted on a conflict.  What each read, commit and
error returns, the virtual time it returns at, the end virtual time, the
snapshot cache's counters, the storage servers' read counters and the
ClientMetrics events must be identical; the errors are each package's own
classes, compared by name and error code."""

from types import SimpleNamespace

import pytest

from foundationdb_tpu import cluster as jcluster
from foundationdb_tpu.client import ryw as jryw
from foundationdb_tpu.client import transaction as jtransaction
from foundationdb_tpu.conflict import oracle as joracle
from foundationdb_tpu.roles import errors as jerrors
from foundationdb_tpu.roles import types as jtypes
from foundationdb_tpu.runtime import knobs as jknobs
from foundationdb_tpu_torch import cluster
from foundationdb_tpu_torch.client import ryw, transaction
from foundationdb_tpu_torch.conflict import oracle
from foundationdb_tpu_torch.roles import errors, types
from foundationdb_tpu_torch.runtime import knobs

PORT = SimpleNamespace(cluster=cluster, ryw=ryw, transaction=transaction, oracle=oracle,
                       types=types, knobs=knobs, errors=errors)
REF = SimpleNamespace(cluster=jcluster, ryw=jryw, transaction=jtransaction,
                      oracle=joracle, types=jtypes, knobs=jknobs, errors=jerrors)


class Probe:
    """Records what each awaited client call returns (or raises, by class
    name and error code) and the virtual time it does."""

    def __init__(self, m, c) -> None:
        self.m, self.c, self.seen = m, c, []

    async def __call__(self, aw):
        try:
            out = await aw
        except Exception as e:  # recorded: compared across packages
            out = ("raised", type(e).__name__, self.m.errors.error_code(e))
        self.seen.append((out, self.c.loop.now()))
        return out


def seed_keys(tr, n=20):
    for i in range(n):
        tr.set(b"k%02d" % i, b"v%02d" % i)


def run(m, seed, scenario, db_knobs=None, **kw):
    k = m.knobs.CoreKnobs()
    k.METRICS_INTERVAL = 0.5  # the *Metrics planes emit within a scenario
    c = m.cluster.SimCluster(seed=seed, conflict_backend=m.oracle.OracleConflictSet,
                             knobs=k, **kw)
    db = c.database()
    if db_knobs is not None:
        db.knobs = db_knobs(m)
    p = Probe(m, c)
    assert c.run_until(c.loop.spawn(scenario(m, c, db, p)), 120.0) is None
    out = dict(seen=p.seen, end=c.loop.now(), cache=db.cache_stats.snapshot(),
               reads=[(ss.c_reads.value, ss.c_selector_reads.value) for ss in c.storage],
               client_metrics=c.trace.find("ClientMetrics"))
    c.stop()
    return out


def both(seed, scenario, **kw):
    got, want = run(PORT, seed, scenario, **kw), run(REF, seed, scenario, **kw)
    for key in want:
        assert got[key] == want[key], key
    return got


async def ryw_own_writes(m, c, db, p):
    tr = m.ryw.ReadYourWritesTransaction(db)
    tr.set(b"a", b"1")
    await p(tr.get(b"a"))
    tr.clear(b"a")
    await p(tr.get(b"a"))
    tr.set(b"a", b"2")
    await p(tr.commit())
    await p(m.ryw.ReadYourWritesTransaction(db).get(b"a"))


async def ryw_range_merge(m, c, db, p):
    tr = m.ryw.ReadYourWritesTransaction(db)
    for i in range(5):
        tr.set(b"k%d" % i, b"old")
    await p(tr.commit())
    tr = m.ryw.ReadYourWritesTransaction(db)
    tr.set(b"k2", b"new")
    tr.clear(b"k3")
    tr.set(b"k9", b"added")
    await p(tr.get_range(b"k", b"l"))


async def ryw_atomic_fold(m, c, db, p):
    T = m.types.MutationType
    tr = m.ryw.ReadYourWritesTransaction(db)
    tr.set(b"n", (10).to_bytes(4, "little"))
    tr.atomic_op(T.ADD, b"n", (5).to_bytes(4, "little"))
    tr.atomic_op(T.BIT_OR, b"o", b"\x0f")
    tr.atomic_op(T.MAX_, b"x", b"\x07\x00")
    await p(tr.get(b"n"))
    await p(tr.commit())
    tr2 = m.ryw.ReadYourWritesTransaction(db)
    tr2.atomic_op(T.ADD, b"n", (1).to_bytes(4, "little"))
    tr2.atomic_op(T.BYTE_MIN, b"x", b"\x03")
    await p(tr2.commit())
    tr3 = m.ryw.ReadYourWritesTransaction(db)
    for k in (b"n", b"o", b"x"):
        await p(tr3.get(k))


async def limited_range_refill(m, c, db, p):
    tr0 = db.create_transaction()
    seed_keys(tr0)
    await p(tr0.commit())
    tr = m.ryw.ReadYourWritesTransaction(db)
    tr.clear_range(b"k00", b"k15")
    await p(tr.get_range(b"k00", b"k99", limit=10))
    tr.set(b"k25", b"new")
    await p(tr.get_range(b"k00", b"k99", limit=10))


async def selectors(m, c, db, p):
    KS = m.types.KeySelector
    tr0 = db.create_transaction()
    seed_keys(tr0)
    await p(tr0.commit())
    tr = db.create_transaction()
    await p(tr.get_read_version())
    for sel in (KS.first_greater_or_equal(b"k05"), KS.first_greater_or_equal(b"k05\x00"),
                KS.first_greater_than(b"k05"), KS.last_less_or_equal(b"k05"),
                KS.last_less_or_equal(b"k05\x00"), KS.last_less_than(b"k05"),
                KS.last_less_than(b"k00"), KS.first_greater_or_equal(b"k05") + 3,
                KS.first_greater_than(b"k05") - 2, KS.first_greater_or_equal(b"k02") + 14,
                KS.last_less_than(b"k17") - 13, KS.last_less_than(b"k13"),
                KS.last_less_than(b"\x00"), KS.first_greater_or_equal(b"k00") - 100,
                KS.first_greater_or_equal(b"k00") + 100, KS.last_less_or_equal(b"\xfe"),
                KS.first_greater_or_equal(b"\xff")):
        await p(tr.get_key(sel))
    await p(tr.get_range(KS.first_greater_or_equal(b"k03"), KS.first_greater_than(b"k06")))
    await p(tr.get_range(KS.first_greater_than(b"k06"), KS.first_greater_or_equal(b"k03")))


async def ryw_selectors_and_cache(m, c, db, p):
    KS = m.types.KeySelector
    tr0 = db.create_transaction()
    seed_keys(tr0)
    await p(tr0.commit())
    tr = m.ryw.ReadYourWritesTransaction(db)
    tr.clear(b"k05")
    await p(tr.get_key(KS.last_less_or_equal(b"k05")))
    await p(tr.get_key(KS.first_greater_or_equal(b"k05")))
    tr.set(b"k045", b"x")
    await p(tr.get_key(KS.first_greater_than(b"k04")))
    await p(tr.get_key(KS.last_less_than(b"k05")))
    await p(tr.get_range(KS.first_greater_or_equal(b"k04"), KS.first_greater_or_equal(b"k07")))
    # read twice: one storage fetch; a covered range re-serves from cache
    for _ in range(3):
        await p(tr.get(b"k07"))
    await p(tr.get_range(b"k10", b"k15"))
    await p(tr.get(b"k12"))
    await p(tr.get(b"k12\x00"))
    await p(tr.get_range(b"k11", b"k14"))
    tr.reset()
    await p(tr.get(b"k01"))
    await p(tr.on_error(m.types.NotCommitted("forced")))
    await p(tr.get(b"k01"))
    await c.loop.delay(0.6)  # one ClientMetrics interval


def small_cache(m):
    k = m.knobs.ClientKnobs()
    k.RYW_CACHE_BYTES = 256
    return k


async def cache_eviction(m, c, db, p):
    tr0 = db.create_transaction()
    seed_keys(tr0, 30)
    await p(tr0.commit())
    tr = m.ryw.ReadYourWritesTransaction(db)
    for _ in range(2):
        for i in range(30):
            await p(tr.get(b"k%02d" % i))


async def conflicts_retries_and_stamps(m, c, db, p):
    """A selector read conflict-protects its span; a read-write conflict
    raises NotCommitted and on_error retries it; versionstamped keys and
    values land with the commit version; a watch fires on a change; a
    malformed versionstamp is refused at the API; db.run retries."""
    KS, T = m.types.KeySelector, m.types.MutationType
    tr0 = db.create_transaction()
    seed_keys(tr0, 6)
    await p(tr0.commit())
    tr = db.create_transaction()
    await p(tr.get_key(KS.first_greater_than(b"k02")))
    tr2 = db.create_transaction()
    tr2.set(b"k02\x01", b"zap")
    await p(tr2.commit())
    tr.set(b"out", b"x")
    await p(tr.commit())  # NotCommitted
    a, b = db.create_transaction(), db.create_transaction()
    await p(a.get(b"k01"))
    await p(b.get(b"k01"))
    a.set(b"k01", b"a")
    b.set(b"k01", b"b")
    await p(a.commit())
    try:
        await b.commit()
    except m.transaction.RETRYABLE_ERRORS as e:
        p.seen.append((("retryable", type(e).__name__, m.errors.error_code(e)),
                       c.loop.now()))
        await p(b.on_error(e))
    await p(b.get(b"k01"))
    b.set(b"k01", b"b2")
    await p(b.commit())
    watch = await db.watch(b"k03")
    tr = db.create_transaction()
    tr.atomic_op(T.SET_VERSIONSTAMPED_KEY, b"vs/" + b"\x00" * 10 + (3).to_bytes(4, "little"),
                 b"key-stamped")
    tr.atomic_op(T.SET_VERSIONSTAMPED_VALUE, b"vsv", b"p" + b"\x00" * 10 + (1).to_bytes(4, "little"))
    tr.set(b"k03", b"changed")
    await p(tr.commit())
    await p(watch)
    tr = db.create_transaction()
    await p(tr.get_range(b"vs/", b"vs0"))
    await p(tr.get(b"vsv"))
    try:
        tr.atomic_op(T.SET_VERSIONSTAMPED_VALUE, b"bad", b"short" + (9).to_bytes(4, "little"))
    except ValueError as e:
        p.seen.append((("refused", str(e)), c.loop.now()))

    async def body(t):
        n = await t.get(b"counter")
        t.set(b"counter", b"%d" % (int(n or b"0") + 1))
        return n

    results = [c.loop.spawn(p(db.run(body))) for _ in range(4)]
    for r in results:
        await r
    await p(db.create_transaction().get(b"counter"))


@pytest.mark.parametrize("scenario,seed,kw", [
    (ryw_own_writes, 11, {}),
    (ryw_range_merge, 12, {}),
    (ryw_atomic_fold, 13, {}),
    (limited_range_refill, 55, {}),
    (selectors, 802, dict(n_storage_shards=3, storage_splits=[b"k05", b"k13"])),
    (ryw_selectors_and_cache, 806, dict(n_storage_shards=2)),
    (cache_eviction, 807, dict(db_knobs=small_cache)),
    (conflicts_retries_and_stamps, 811, dict(n_storage_shards=2)),
], ids=lambda x: getattr(x, "__name__", None) if callable(x) else None)
def test_client_matches_the_reference(scenario, seed, kw):
    got = both(seed, scenario, **kw)
    assert got["seen"]


def test_client_outcomes():
    """What the parity runs saw is what the reference's own tests assert
    (so the scenarios exercise the paths they name)."""
    got = run(PORT, 806, ryw_selectors_and_cache, n_storage_shards=2)
    vals = [v for v, _t in got["seen"]]
    assert vals[1:5] == [b"k04", b"k06", b"k045", b"k045"]
    assert got["cache"]["cache_hits"] >= 4 and got["client_metrics"]
    got = run(PORT, 807, cache_eviction, db_knobs=small_cache)
    assert got["cache"]["cache_evictions"] > 0 and got["cache"]["bytes"] <= 256
    got = run(PORT, 811, conflicts_retries_and_stamps, n_storage_shards=2)
    vals = [v for v, _t in got["seen"]]
    not_committed = ("raised", "NotCommitted", 1020)
    assert vals[3] == not_committed
    assert ("retryable", "NotCommitted", 1020) in vals
    assert vals[-1] == b"4"
    assert any(isinstance(v, tuple) and v[0] == "refused" for v in vals)
    stamped = next(v for v in vals if isinstance(v, list) and v and v[0][0].startswith(b"vs/"))
    assert len(stamped[0][0]) == 13 and stamped[0][1] == b"key-stamped"
