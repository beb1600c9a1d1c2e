"""The port's cluster-to-cluster DR (foundationdb_tpu_torch/client/dr.py)
against the reference's, on the same seeds: the scenarios of
tests/test_dr.py, and a primary kill with commits in flight.  Two clusters
share one EventLoop, each on its default backend (the port's with
`device="cpu"`).  Results, the coverage census, the verdict stream of both
clusters' conflict sets and every file of both SimFilesystems must be
identical (`run_both`, tests/test_torch_layers.py).

The port's DRWorker applies no version above the TLogs' known_committed
watermark; the reference's applies whatever a TLog returns, so a commit in
flight at a primary kill that the recovery rolls back (an unknown-result
phantom) still reaches the secondary, which then differs from its
primary.  The comparison runs the reference with the port's `_pull` code
bound to the reference module's own names (`port_pull`): the same
algorithm on the reference's types, the package itself unchanged.  The
unbound reference is run once on the phantom seed to show the fault."""

import types

import pytest

from tests.test_torch_backup import run
from tests.test_torch_layers import PORT, REF, cluster, err_name, finish, run_both
from tests.test_torch_recoverable import fs_image
from tests.torch_threads import one_torch_thread  # noqa: F401

PHANTOM_SEED = 5  # a kill here leaves in-flight commits the recovery drops


@pytest.fixture
def port_pull(monkeypatch):
    """The reference's DRWorker running the port's `_pull` (its globals the
    reference dr module's)."""
    code = PORT.dr.DRWorker._pull
    monkeypatch.setattr(REF.dr.DRWorker, "_pull", types.FunctionType(
        code.__code__, vars(REF.dr), code.__name__, code.__defaults__, code.__closure__))


async def dump_user(db) -> dict:
    tr = db.create_transaction()
    return dict(await tr.get_range(b"", b"\xff", limit=100000))


def dr_failover(m) -> dict:
    """A primary pipeline kill mid-stream; the secondary serves the exact
    keyspace after failover."""
    primary = cluster(m, 530, n_storage_shards=2)
    secondary = cluster(m, 531, loop=primary.loop)
    pri_db = primary.database()
    out = {}

    async def main():
        tr = pri_db.create_transaction()
        for i in range(40):
            tr.set(b"snap%02d" % i, b"s%d" % i)
        await tr.commit()
        agent = m.dr.DRAgent(primary, secondary)
        out["start"] = await agent.start()
        sec_db = secondary.database()
        for _ in range(100):
            await primary.loop.delay(0.1)
            gen = secondary.controller.generation
            if gen is not None and all(p.locked for p in gen.proxies):
                break
        tr = sec_db.create_transaction()
        tr.set(b"rogue", b"x")
        try:
            await tr.commit()
        except m.types.DatabaseLocked as e:
            out["rogue"] = err_name(e)
        for i in range(20):
            async def fn(tr, i=i):
                tr.set(b"live%02d" % i, b"v%d" % i)
                tr.atomic_op(m.types.MutationType.ADD, b"counter",
                             (1).to_bytes(8, "little", signed=True))
                if i == 7:
                    tr.clear_range(b"snap00", b"snap05")

            await pri_db.run(fn)
            if i == 9:
                primary.controller.generation.tlogs[0].commit_stream._process.kill()
        for _ in range(300):
            await primary.loop.delay(0.1)
            if primary.controller.generation is not None and not primary.controller._recovering:
                break
        out["lag_before"] = agent.lag_versions
        out["final"] = await agent.failover(timeout=240.0)
        out["primary"] = await dump_user(pri_db)
        out["secondary"] = await dump_user(secondary.database())

        async def w(tr):
            tr.set(b"post-failover", b"1")

        await sec_db.run(w)
        out["post"] = await sec_db.create_transaction().get(b"post-failover")
        tr = pri_db.create_transaction()
        tr.set(b"stale", b"x")
        try:
            await tr.commit()
        except m.types.DatabaseLocked as e:
            out["stale"] = err_name(e)

    run(primary, main())
    out.update(recoveries=primary.controller.recoveries,
               secondary_files=fs_image(secondary.fs))
    secondary.stop()
    return finish(primary, out)


def dr_lag_and_stop(m) -> dict:
    primary = cluster(m, 532)
    secondary = cluster(m, 533, loop=primary.loop)
    pri_db = primary.database()
    out = {}

    async def main():
        agent = m.dr.DRAgent(primary, secondary)
        await agent.start()
        for i in range(10):
            async def fn(tr, i=i):
                tr.set(b"k%d" % i, b"v")

            await pri_db.run(fn)
        v = await pri_db.create_transaction().get_read_version()
        await agent.wait_applied_to(v, timeout=120.0)
        out["lag"] = agent.lag_versions
        await agent.stop(unlock_secondary=True)
        sec_db = secondary.database()

        async def w(tr):
            tr.set(b"own", b"1")

        await sec_db.run(w)
        out["secondary"] = await dump_user(sec_db)

    run(primary, main(), 600)
    out["secondary_files"] = fs_image(secondary.fs)
    secondary.stop()
    return finish(primary, out)


def test_dr_failover_is_exact(monkeypatch, port_pull):
    got = run_both(monkeypatch, dr_failover)
    sec = dict(got["secondary"])
    assert got["rogue"] == got["stale"] == "DatabaseLocked" and got["recoveries"] >= 1
    assert sec == got["primary"] and got["final"] > 0 and got["post"] == b"1"
    assert sec[b"counter"] == (20).to_bytes(8, "little", signed=True)
    assert not any(b"snap00" <= k < b"snap05" for k in sec)


def test_dr_lag_and_stop(monkeypatch, port_pull):
    got = run_both(monkeypatch, dr_lag_and_stop)
    assert got["lag"] <= 1_000_000 and got["secondary"][b"own"] == b"1"
    assert all(got["secondary"][b"k%d" % i] == b"v" for i in range(10))


def dr_phantom(m) -> dict:
    """phase 17 (b)'s shape at a small size: DR started once ReadWrite's
    setup has filled the primary, then its traffic and a pipeline kill on
    the primary with commits in flight, then failover."""
    primary = cluster(m, PHANTOM_SEED, redundancy="double", storage_engine="ssd",
                      n_coordinators=3, n_tlogs=2, n_proxies=2)
    secondary = cluster(m, PHANTOM_SEED + 1, loop=primary.loop, redundancy="double",
                        storage_engine="ssd", n_coordinators=3, n_tlogs=2, n_proxies=2)
    agent = m.dr.DRAgent(primary, secondary)

    class StartDR(m.base.Workload):
        description = "DR"

        async def setup(self, cluster, rng):
            await agent.start(chunk_rows=100)

        async def start(self, cluster, rng):
            pass

    rw = m.readwrite.ReadWriteWorkload(keys=128, clients=8, duration=5.3, reads_per_tx=2,
                                       writes_per_tx=1)
    metrics = m.base.run_workloads(primary, [rw, StartDR(), m.attrition.AttritionWorkload(
        kills=1, start_delay=0.05, interval=5.0)], deadline=600.0)
    final = run(primary, agent.failover(timeout=240.0))
    out = dict(metrics=metrics, final=final, recoveries=primary.controller.recoveries,
               primary=run(primary, dump_user(primary.database())),
               secondary=run(primary, dump_user(secondary.database())),
               secondary_files=fs_image(secondary.fs))
    secondary.stop()
    return finish(primary, out)


def test_dr_is_exact_across_a_rolled_back_commit(monkeypatch, port_pull):
    got = run_both(monkeypatch, dr_phantom)
    assert got["recoveries"] == 1 and len(got["primary"]) == 128
    assert got["secondary"] == got["primary"]


def test_the_reference_dr_applies_a_rolled_back_commit():
    """The fault the port's DRWorker fixes: the reference's secondary ends
    with values its primary rolled back (ROADMAP C)."""
    got = dr_phantom(REF)
    wrong = [k for k in got["primary"] if got["secondary"].get(k) != got["primary"][k]]
    assert wrong and set(got["secondary"]) == set(got["primary"])
