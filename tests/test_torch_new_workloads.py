"""The port's last twelve workloads (foundationdb_tpu_torch/workloads/:
configure_db, device_fault, disk_swizzle, fuzzapi, kill_region, low_space,
random_move, rollback, selector_oracle, serializability, swizzle,
write_during_read) against the reference's, on the scenarios of the
reference's tests/test_new_workloads.py, test_chaos_sweep.py,
test_disk_faults.py (its LowSpace and DiskSwizzle specs), test_regions.py,
test_restart_pairs.py (Rollback) and test_topology.py, same seeds.

Each scenario runs through `run_both` (tests/test_torch_layers.py, given
this module's namespaces, which add the new modules): the
port's RecoverableCluster on its default backend, the DeviceConflictSet on
"cpu", against the reference's on its oracle.  So every workload here
drives the port's device set, FuzzApi with its keys of up to 203 bytes
too.  The workload metrics, recoveries, the end virtual time, every file
of the SimFilesystem, the verdict stream and the coverage census (less the
set's own `kernel.*` sites) must be identical.  DeviceFault needs a
supervised set: both packages run the spec's `backend=supervised`, the
port's on "cpu"."""

import importlib
from types import SimpleNamespace

import pytest

from tests import test_torch_layers as layers
from tests.test_torch_layers import MODULES, finish, run_both
from tests.torch_threads import one_torch_thread  # noqa: F401

NEW = dict(
    configure_db="workloads.configure_db", device_fault="workloads.device_fault",
    disk_swizzle="workloads.disk_swizzle", fuzzapi="workloads.fuzzapi",
    kill_region="workloads.kill_region", low_space="workloads.low_space",
    random_move="workloads.random_move", rollback="workloads.rollback",
    selector_oracle="workloads.selector_oracle",
    serializability="workloads.serializability", swizzle="workloads.swizzle",
    write_during_read="workloads.write_during_read", spec="workloads.spec")


def namespace(package: str, **extra) -> SimpleNamespace:
    return SimpleNamespace(**{k: importlib.import_module(f"{package}.{v}")
                              for k, v in {**MODULES, **NEW}.items()}, **extra)


PORT = namespace("foundationdb_tpu_torch", set_name="DeviceConflictSet",
                 cluster_kw=dict(device="cpu"))
REF = namespace("foundationdb_tpu", set_name="OracleConflictSet", cluster_kw={})


def supervised(m):
    """The spec corpus's supervised set: the port's on the CPU."""
    if m is PORT:
        return m.spec._backend_factory("supervised", "cpu")
    return m.spec._BACKENDS["supervised"]


# name -> (cluster keywords, workloads(m), what the reference test asserts)
SCENARIOS = {
    # test_new_workloads.py
    "serializability_plain": (
        dict(seed=541, n_storage_shards=2),
        lambda m: [m.serializability.SerializabilityWorkload(clients=3, txns_per_client=12)],
        lambda r: r["Serializability"]["committed"] >= 30),
    "serializability_under_chaos": (
        dict(seed=542, n_storage_shards=2, chaos=True),
        lambda m: [m.serializability.SerializabilityWorkload(clients=2, txns_per_client=8),
                   m.attrition.AttritionWorkload(kills=1, interval=2.0, start_delay=0.8)],
        lambda r: r["Serializability"]["committed"] >= 10),
    "fuzz_api_correctness": (
        dict(seed=543),
        lambda m: [m.fuzzapi.FuzzApiWorkload(clients=3, ops_per_client=150)],
        lambda r: r["FuzzApi"]["ops"] == 450),
    "fuzz_api_under_chaos": (
        dict(seed=544, chaos=True),
        lambda m: [m.fuzzapi.FuzzApiWorkload(clients=2, ops_per_client=80),
                   m.attrition.AttritionWorkload(kills=1, interval=1.5, start_delay=0.6)],
        lambda r: r["FuzzApi"]["ops"] == 160),
    "configure_database_swizzle_with_cycle": (
        dict(seed=547, n_machines=6, n_dcs=2, n_storage_shards=2, redundancy="double"),
        lambda m: [m.cycle.CycleWorkload(nodes=8, clients=2, txns_per_client=10),
                   m.configure_db.ConfigureDatabaseWorkload(flips=3, interval=1.0)],
        lambda r: r["ConfigureDatabase"]["converged"] == 3),
    # test_chaos_sweep.py (its first sweep seed)
    "chaos_sweep_selector_oracle": (
        dict(seed=1041, n_storage_shards=2, chaos=True),
        lambda m: [m.selector_oracle.SelectorOracleWorkload(rounds=3, checks_per_round=10),
                   m.attrition.AttritionWorkload(kills=1, interval=2.0, start_delay=1.3),
                   m.swizzle.SwizzleWorkload(rounds=2, victims=2, start_delay=0.6)],
        lambda r: r["SelectorOracle"]["divergences"] == 0
        and r["SelectorOracle"]["checks"] == 30),
    # test_topology.py
    "cycle_survives_swizzle": (
        dict(seed=704, n_storage_shards=2, storage_replication=2),
        lambda m: [m.cycle.CycleWorkload(nodes=8, clients=2, txns_per_client=6),
                   m.swizzle.SwizzleWorkload(rounds=2, victims=3, clog_seconds=0.6)],
        lambda r: r["Cycle"]["committed"] == 12 and r["Swizzle"]["swizzles"] >= 1),
    "write_during_read_ryw_fuzz": (
        dict(seed=707, n_storage_shards=2, storage_replication=2),
        lambda m: [m.write_during_read.WriteDuringReadWorkload(txns=15, ops_per_txn=10)],
        lambda r: r["WriteDuringRead"]["committed"] >= 10),
    # test_regions.py
    "kill_region_workload_standalone": (
        dict(seed=7408, n_storage_shards=2, storage_replication=2, usable_regions=2),
        lambda m: [m.kill_region.KillRegionWorkload(keys=30, burst=6)],
        lambda r: r["KillRegion"]["acked"] == 30
        and r["KillRegion"]["kills"] == ["remote", "primary"]),
    # test_restart_pairs.py TestRollback
    "rollback_forces_recovery": (
        dict(seed=41, n_storage_shards=2),
        lambda m: [m.rollback.RollbackWorkload(rounds=2, clients=2, writes_per_client=8)],
        lambda r: r["Rollback"]["forced_recoveries"] >= 1
        and r["Rollback"]["acked"] + r["Rollback"]["unknown"] == 16),
    # test_disk_faults.py's LowSpace and DiskSwizzle specs
    "low_space_under_cycle": (
        dict(seed=433, n_storage_shards=2, storage_replication=2),
        lambda m: [m.cycle.CycleWorkload(nodes=6, clients=2, txns_per_client=6),
                   m.low_space.LowSpaceWorkload(rows=600, value_bytes=96, start_delay=0.5)],
        lambda r: r["Cycle"]["committed"] == 12),
    "disk_swizzle_under_cycle": (
        dict(seed=211, n_storage_shards=2, storage_replication=2, chaos=True),
        lambda m: [m.cycle.CycleWorkload(nodes=8, clients=2, txns_per_client=6),
                   m.disk_swizzle.DiskSwizzleWorkload(rounds=2, interval=1.0,
                                                      stall_seconds=0.4, errors=1,
                                                      start_delay=0.5),
                   m.attrition.AttritionWorkload(kills=1, interval=2.5, start_delay=1.8)],
        lambda r: r["Cycle"]["committed"] == 12),
    # RandomMoveKeys (HotShardSplit's stanza, in its default random mode)
    "random_move_keys_under_cycle": (
        dict(seed=131, n_storage_shards=2, storage_replication=2),
        lambda m: [m.cycle.CycleWorkload(nodes=8, clients=2, txns_per_client=6),
                   m.random_move.RandomMoveKeysWorkload(moves=2, interval=0.5,
                                                        duration=3.0)],
        lambda r: r["Cycle"]["committed"] == 12),
    # DeviceFaultSwizzle's stanzas on the supervised set
    "device_fault_under_cycle": (
        dict(seed=91, n_storage_shards=2, chaos=True),
        lambda m: [m.cycle.CycleWorkload(nodes=8, clients=2, txns_per_client=6),
                   m.device_fault.DeviceFaultWorkload(times=2, start_delay=0.4,
                                                      writes_per_site=6)],
        lambda r: r["DeviceFault"]["forced_sites"] == 4),
}


def scenario(m, name: str) -> dict:
    kw, workloads, _ok = SCENARIOS[name]
    if name.startswith("device_fault"):
        kw = dict(kw, conflict_backend=supervised(m))
    else:
        kw = dict(kw, **m.cluster_kw)
    c = m.recoverable.RecoverableCluster(**kw)
    metrics = m.base.run_workloads(c, workloads(m), deadline=900.0)
    return finish(c, dict(metrics=metrics, recoveries=c.controller.recoveries))


def check(monkeypatch, name: str) -> None:
    """`name` on both packages through run_both; the reference test's own
    assertion holds on the result."""
    # run_both runs its module's two namespaces: widen them to the new ones
    monkeypatch.setattr(layers, "PORT", PORT)
    monkeypatch.setattr(layers, "REF", REF)
    got = run_both(monkeypatch, scenario, name=name)
    assert SCENARIOS[name][2](got["metrics"]), got["metrics"]


# the scenarios that run in other files, to keep each file near a minute
ELSEWHERE = {
    "low_space_under_cycle": "test_torch_new_workloads_disk.py",
    "disk_swizzle_under_cycle": "test_torch_new_workloads_disk.py",
    "fuzz_api_correctness": "test_torch_new_workloads_fuzz.py",
    "fuzz_api_under_chaos": "test_torch_new_workloads_fuzz.py",
}


@pytest.mark.parametrize("name", sorted(set(SCENARIOS) - set(ELSEWHERE)))
def test_workload_scenario_matches_the_reference(monkeypatch, name):
    check(monkeypatch, name)
