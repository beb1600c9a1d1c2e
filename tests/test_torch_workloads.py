"""The port's SimCluster and workloads (foundationdb_tpu_torch/cluster.py,
workloads/) against the reference's, on the same seeds: the scenarios of
tests/test_workloads.py (Cycle on one resolver; Cycle + Bank on 3
resolvers, 2 shards and 2 TLogs; ConflictRange on 2 resolvers; Cycle +
ConflictRange with each package's DeviceConflictSet on 2 resolvers),
Increment, and a small ReadWrite.  Each scenario is one function over a
namespace of modules, run once per package; the workload metrics, the end
virtual time, every storage server's key/values and the verdict stream
(every batch of every resolver, in the order the resolvers saw them) must
be identical.  Also: the port's SimCluster() raises without a card, and its
default backend on device="cpu" commits what the reference's oracle
commits."""

from types import SimpleNamespace

import pytest
import torch

from foundationdb_tpu import cluster as jcluster
from foundationdb_tpu.conflict import device as jdevice
from foundationdb_tpu.conflict import oracle as joracle
from foundationdb_tpu.workloads import bank as jbank
from foundationdb_tpu.workloads import base as jbase
from foundationdb_tpu.workloads import conflict_range as jconflict_range
from foundationdb_tpu.workloads import cycle as jcycle
from foundationdb_tpu.workloads import increment as jincrement
from foundationdb_tpu.workloads import readwrite as jreadwrite
from foundationdb_tpu_torch import cluster
from foundationdb_tpu_torch.conflict import device, oracle
from foundationdb_tpu_torch.workloads import (
    bank, base, conflict_range, cycle, increment, readwrite)
from tests.torch_threads import one_torch_thread  # noqa: F401

PORT = SimpleNamespace(
    cluster=cluster, base=base, cycle=cycle, bank=bank, increment=increment,
    conflict_range=conflict_range, readwrite=readwrite,
    oracle=lambda: oracle.OracleConflictSet(),
    device=lambda: device.DeviceConflictSet(capacity=1 << 12, device="cpu"))
REF = SimpleNamespace(
    cluster=jcluster, base=jbase, cycle=jcycle, bank=jbank, increment=jincrement,
    conflict_range=jconflict_range, readwrite=jreadwrite,
    oracle=lambda: joracle.OracleConflictSet(),
    device=lambda: jdevice.DeviceConflictSet(capacity=1 << 12))


class Recording:
    """A resolver's conflict set that appends (resolver, version,
    verdicts) to a shared log at every batch; everything else is the
    inner set's."""

    def __init__(self, inner, index: int, log: list) -> None:
        self.inner, self.index, self.log = inner, index, log

    def resolve_batch(self, version, txns):
        out = self.inner.resolve_batch(version, txns)
        self.log.append((self.index, version, [int(v) for v in out]))
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def storage_dump(ss) -> tuple:
    """A storage server's tag, versions and every key/value live at its
    newest version (the base store merged with the MVCC overlay)."""
    v = ss.version.get()
    live = ss._live_keys(v, b"", b"\xff\xff", 1 << 30)
    return (ss.tag, v, ss.durable_version,
            [(k, ss.overlay.get(k, v, ss.store.get)) for k in live])


def run(m, seed, make_workloads, backend="oracle", **cluster_kw):
    """One seeded cluster run of `make_workloads(m)`: (metrics, end virtual
    time, storage dumps, verdict stream)."""
    log, made = [], []

    def make_cs():
        made.append(None)
        return Recording(getattr(m, backend)(), len(made) - 1, log)

    c = m.cluster.SimCluster(seed=seed, conflict_backend=make_cs, **cluster_kw)
    metrics = m.base.run_workloads(c, make_workloads(m))
    end = c.loop.now()
    dump = [storage_dump(ss) for ss in c.storage]
    c.stop()
    return metrics, end, dump, log


def both(seed, make_workloads, **kw):
    got, want = run(PORT, seed, make_workloads, **kw), run(REF, seed, make_workloads, **kw)
    assert got[0] == want[0], "workload metrics differ"
    assert got[1] == want[1], "end virtual time differs"
    assert got[2] == want[2], "storage contents differ"
    assert got[3] == want[3], "verdict streams differ"
    assert got[3], "no resolver batch"
    return got


def test_cycle_single_resolver():
    metrics, _t, dump, _v = both(21, lambda m: [
        m.cycle.CycleWorkload(nodes=12, clients=3, txns_per_client=10)])
    assert metrics["Cycle"]["committed"] == 30
    assert len(dump[0][3]) == 12


def test_cycle_and_bank_composed_multi_resolver():
    metrics, _t, dump, verdicts = both(
        22, lambda m: [m.cycle.CycleWorkload(nodes=10, clients=2, txns_per_client=8),
                       m.bank.BankWorkload(accounts=8, clients=2, transfers_per_client=8)],
        n_resolvers=3, n_storage_shards=2, n_tlogs=2)
    assert metrics["Cycle"]["committed"] == metrics["Bank"]["committed"] == 16
    assert {r for r, _v, _c in verdicts} == {0, 1, 2} and len(dump) == 2


def test_conflict_range_parity():
    metrics, *_ = both(23, lambda m: [m.conflict_range.ConflictRangeWorkload(rounds=30)],
                       n_resolvers=2)
    assert metrics["ConflictRange"]["checked"] == 30


def test_cycle_and_conflict_range_on_the_device_sets():
    """The north-star wiring: each resolver hosts its package's
    DeviceConflictSet (the port's on "cpu", the reference's on JAX-CPU)."""
    metrics, _t, _d, verdicts = both(
        24, lambda m: [m.cycle.CycleWorkload(nodes=8, clients=2, txns_per_client=5),
                       m.conflict_range.ConflictRangeWorkload(rounds=10)],
        backend="device", n_resolvers=2)
    assert metrics["Cycle"]["committed"] == 10
    assert metrics["ConflictRange"]["checked"] == 10
    assert any(2 in c for _r, _v, c in verdicts), "no conflict in the stream"


def test_increment():
    metrics, _t, dump, _v = both(26, lambda m: [
        m.increment.IncrementWorkload(counters=4, clients=3, adds_per_client=8)],
        n_storage_shards=2)
    assert metrics["Increment"]["committed"] == 24


def test_small_readwrite():
    metrics, *_ = both(27, lambda m: [m.readwrite.ReadWriteWorkload(
        keys=1024, clients=64, duration=0.3, reads_per_tx=2, writes_per_tx=1)])
    assert metrics["ReadWrite"]["committed"] > 64


def test_port_cluster_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cluster.SimCluster()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cluster.SimCluster(seed=3, n_resolvers=2, device="cuda")


def test_port_default_backend_on_cpu_commits_what_the_oracle_commits():
    """The port's default backend (its DeviceConflictSet on the device
    asked for) runs with device="cpu", and the run equals the reference's
    default cluster (its OracleConflictSet) on the same seed."""
    def once(c, m):
        metrics = m.base.run_workloads(
            c, [m.cycle.CycleWorkload(nodes=10, clients=3, txns_per_client=6)])
        out = (metrics, c.loop.now(), [storage_dump(ss) for ss in c.storage])
        c.stop()
        return out

    c = cluster.SimCluster(seed=25, n_resolvers=2, device="cpu")
    assert all(type(r.cs) is device.DeviceConflictSet and r.cs.device.type == "cpu"
               for r in c.resolvers)
    assert once(c, PORT) == once(jcluster.SimCluster(seed=25, n_resolvers=2), REF)
