"""The port's supervised set inside the reference's simulation: the
device-fault campaign of tests/test_chaos_sweep.py
(test_chaos_device_faults_mid_pipeline) with the port's DeviceSupervisor
over the port's DeviceConflictSet(device="cpu") as the RecoverableCluster's
conflict backend, refereed batch by batch against the reference's oracle,
once per device fault site; the same seeds with the oracle backend commit
the same counts; and the reference SimCluster's status rolls up the port's
device health.

The port's supervisor injects faults through its own buggify module and
counts through its own coverage, which a reference simulation never arms.
So, here only, its module-level `buggify` and `testcov` names are routed to
the reference's functions: the chaos run's forced sites then fire inside
the port's supervisor, and the reference's census sees them."""

import pytest

from foundationdb_tpu.conflict.oracle import OracleConflictSet as JOracleConflictSet
from foundationdb_tpu.control.recoverable import RecoverableCluster
from foundationdb_tpu.control.status import cluster_status, validate_status
from foundationdb_tpu.runtime import buggify as jbuggify
from foundationdb_tpu.runtime import coverage as jcoverage
from foundationdb_tpu.tools import soak
from foundationdb_tpu.workloads.base import run_workloads
from foundationdb_tpu.workloads.cycle import CycleWorkload
from foundationdb_tpu_torch.conflict import device as tdev
from foundationdb_tpu_torch.conflict import supervisor as tsup
from foundationdb_tpu_torch.conflict.native import NativeConflictSet
from tests.test_chaos_sweep import DEVICE_SITES, _RefereedConflictSet
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _buggify_off():
    yield
    jbuggify.disable()


@pytest.fixture
def routed(monkeypatch):
    """The port supervisor's fault sites and coverage, routed to the
    reference's modules for the length of one test."""
    monkeypatch.setattr(tsup, "buggify", jbuggify.buggify)
    monkeypatch.setattr(tsup, "testcov", jcoverage.testcov)


def _cycle(c):
    cyc = CycleWorkload(nodes=8, clients=2, txns_per_client=6)
    return run_workloads(c, [cyc], deadline=600.0)["Cycle"]["committed"]


@pytest.mark.parametrize("i, site", list(enumerate(DEVICE_SITES)))
def test_device_faults_mid_pipeline_with_the_ports_set(monkeypatch, routed, i, site):
    """Each device.* site tripped mid-run in the split-phase pipeline (so
    faults land inside an open deferred window): no verdict differs from
    the oracle referee, Cycle commits exactly 12, every resolver ends
    healthy or degraded, the status validates with the device roll-up, the
    site fired (the reference's census), and the seed commits as many with
    the oracle backend."""
    monkeypatch.setenv("FDBTPU_PIPELINE", "1")
    seed = 1500 + i
    cov_base = jcoverage.snapshot()
    mismatches: list = []

    def make_cs(oldest=0):
        return _RefereedConflictSet(
            tsup.DeviceSupervisor(
                lambda o=0: tdev.DeviceConflictSet(
                    o, capacity=1 << 10, run_capacity=64, device="cpu"),
                oldest_version=oldest,
            ),
            JOracleConflictSet(oldest),
            mismatches,
        )

    c = RecoverableCluster(seed=seed, n_storage_shards=2, chaos=True,
                           conflict_backend=make_cs)

    async def tripper():
        # device.lost fires enough consecutive times to TRIP the breaker
        # (DEVICE_RETRY_LIMIT): the full degrade -> serve-degraded path
        await c.loop.delay(0.4)
        jbuggify.force(site, 3 if site == "device.lost" else 2)

    c.loop.spawn(tripper())
    committed = _cycle(c)
    assert committed == 12, site
    if not jcoverage.hits(f"buggify.{site}"):
        # the workload outran the trip point: drive a few more commits so
        # the armed fault meets live traffic
        db = c.database()

        async def drive():
            for j in range(4):
                tr = db.create_transaction()
                tr.set(b"post%d" % j, b"x")
                await tr.commit()

        c.run_until(c.loop.spawn(drive()), 120.0)
    assert mismatches == [], f"{site}: verdicts diverged from the oracle"
    census = soak.seed_census(cov_base)
    assert soak.check_required(
        soak.merge_census({site: census}), [f"buggify.{site}", "device.cpu_rebuild"]
    ) == [], census
    if site == "device.lost":
        assert jcoverage.hits("device.degraded") >= 1
    for r in c.controller.generation.resolvers:
        assert isinstance(r.cs.inner, tsup.DeviceSupervisor)
        assert r.cs.health()["state"] in ("healthy", "degraded"), site
    doc = cluster_status(c)
    validate_status(doc)
    assert "device" in doc["kernel"], site
    c.stop()
    jbuggify.disable()

    oracle_run = RecoverableCluster(
        seed=seed, n_storage_shards=2, chaos=True,
        conflict_backend=lambda oldest=0: JOracleConflictSet(oldest))
    assert _cycle(oracle_run) == committed
    oracle_run.stop()


def test_sim_cluster_status_rolls_up_the_ports_device(routed):
    """The reference SimCluster over the port's supervised best-known set
    (native skip list as the CPU fallback): kernel.device rolls up healthy,
    the status validates, and force_degrade() shows serving_cpu == 1."""
    from foundationdb_tpu.cluster import SimCluster

    c = SimCluster(
        seed=93,
        n_resolvers=2,
        conflict_backend=lambda: tsup.DeviceSupervisor(
            lambda o=0: tdev.DeviceConflictSet(
                o, capacity=1 << 10, lsm=True, search_impl="bucket", device="cpu"),
            fallback_factory=NativeConflictSet,
        ),
    )
    db = c.database()

    async def commit_some():
        for j in range(3):
            tr = db.create_transaction()
            tr.set(b"k%d" % j, b"v")
            await tr.commit()

    c.run_until(c.loop.spawn(commit_some()), 60.0)
    doc = cluster_status(c)
    validate_status(doc)
    dev = doc["kernel"]["device"]
    assert dev["states"]["healthy"] == len(c.resolvers) == 2
    assert dev["trips"] == 0 and dev["serving_cpu"] == 0
    c.resolvers[0].cs.force_degrade()
    assert c.resolvers[0].cs.kernel_stats()["backend"] == "native"
    doc = cluster_status(c)
    validate_status(doc)
    assert doc["kernel"]["device"]["states"]["degraded"] == 1
    assert doc["kernel"]["device"]["serving_cpu"] == 1
    assert any(
        m["name"] == "device_backend_degraded" for m in doc["cluster"]["messages"]
    )
    c.run_until(c.loop.spawn(commit_some()), 60.0)  # still commits, degraded
    c.stop()
