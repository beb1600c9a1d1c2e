"""The port's durable, recoverable cluster (foundationdb_tpu_torch/control/
recoverable.py and the controller, coordination, storage, worker and status
modules under it) against the reference's, on the same seeds.  The port
runs on its default backend (each resolver of each generation hosts the
port's DeviceConflictSet on "cpu"), the reference on its own default (its
OracleConflictSet): the verdicts are the same either way.

Each scenario is one function over a namespace of modules, run once per
package: Cycle plus Attrition, Bank with a TLog kill, the memory and ssd
engines, worker-recruited roles, power_off() and a restart from the same
SimFilesystem, and redundancy="double".  The workload metrics, recoveries
and epochs, the end virtual time, every storage server's contents, the
verdict stream (each conflict set's creation version and every batch it
resolved, in order), every file of the SimFilesystem byte for byte and the
status document must be identical.  In the status document the backend
names are mapped ("cpu" against "oracle"), the kernel block is compared on
what both sets count alike (transactions and aborts), and the fields
measured on the host clock (`*_ms`) are left out.

Also: RecoverableCluster() raises without a card; every lazy import in the
slice's modules names a module of the port; and a recovery leaves the old
generation's conflict set to the garbage collector."""

import ast
import gc
import importlib
import weakref
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from foundationdb_tpu.control import recoverable as jrecoverable
from foundationdb_tpu.control import status as jstatus
from foundationdb_tpu.runtime import buggify as jbuggify
from foundationdb_tpu.workloads import attrition as jattrition
from foundationdb_tpu.workloads import bank as jbank
from foundationdb_tpu.workloads import base as jbase
from foundationdb_tpu.workloads import cycle as jcycle
from foundationdb_tpu_torch.conflict import device
from foundationdb_tpu_torch.control import recoverable, status
from foundationdb_tpu_torch.runtime import buggify
from foundationdb_tpu_torch.workloads import attrition, bank, base, cycle
from tests.test_torch_workloads import storage_dump
from tests.torch_threads import one_torch_thread  # noqa: F401

PORT = SimpleNamespace(recoverable=recoverable, status=status, base=base, cycle=cycle,
                       bank=bank, attrition=attrition, set_name="DeviceConflictSet",
                       backend="cpu", cluster_kw=dict(device="cpu"))
REF = SimpleNamespace(recoverable=jrecoverable, status=jstatus, base=jbase, cycle=jcycle,
                      bank=jbank, attrition=jattrition, set_name="OracleConflictSet",
                      backend="oracle", cluster_kw={})
REPO = Path(__file__).resolve().parent.parent
SLICE = ["rpc/failmon", "rpc/policy", "storage/files", "storage/pagecache",
         "storage/diskqueue", "storage/kvstore", "storage/btree", "roles/logrouter",
         "roles/backup", "roles/worker", "client/management", "control/coordination",
         "control/region", "control/logsystem", "control/ratekeeper",
         "control/distribution", "control/controller", "control/recoverable",
         "control/status", "tools/trace_tool", "tools/timeline", "workloads/attrition"]


@pytest.fixture(autouse=True)
def _buggify_off():
    yield
    jbuggify.disable()
    buggify.disable()


def fs_image(fs) -> dict:
    """Every file: its durable bytes, buffered tail and journaled truncate."""
    return {path: (bytes(st.synced), [bytes(c) for c in st.unsynced], st.pending_truncate)
            for path, st in sorted(fs._files.items())}


def drop_host_clock(doc, backend: str):
    """The status document less its host-clock fields, with the backend
    name mapped and the kernel block cut to what every set counts alike."""
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if k.endswith("_ms") or "_ms_" in k or k == "fold_ms":
                continue
            if k == "kernel":
                v = {key: v[key] for key in ("txns", "aborted", "abort_rate")}
            out[k] = drop_host_clock(v, backend)
        if out.get("backend") == backend:
            out["backend"] = "<set>"
        return out
    if isinstance(doc, list):
        return [drop_host_clock(v, backend) for v in doc]
    return doc


def first_difference(a, b, path=""):
    """The path to the first place two nested documents differ, and what
    each side holds there."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b or a[k] != b[k]:
                return first_difference(a.get(k), b.get(k), f"{path}/{k}")
    elif isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return first_difference(x, y, f"{path}[{i}]")
    return f"{path}: {a!r:.300} != {b!r:.300}"


def recording(monkeypatch, m, log: list) -> None:
    """Each conflict set the cluster's default factory builds logs its
    creation version and every batch it resolves."""
    base_cls = getattr(m.recoverable, m.set_name)

    class Recorded(base_cls):
        def __init__(self, oldest=0, **kw):
            super().__init__(oldest, **kw)
            self._index = sum(e[0] == "new" for e in log)
            log.append(("new", self._index, oldest))

        def resolve_batch(self, version, txns):
            out = super().resolve_batch(version, txns)
            log.append(("batch", self._index, version, [int(v) for v in out]))
            return out

    monkeypatch.setattr(m.recoverable, m.set_name, Recorded)


def outcome(m, c, metrics, log) -> dict:
    doc = m.status.cluster_status(c)
    m.status.validate_status(doc)
    assert doc["kernel"]["backend"] == m.backend
    return dict(metrics=metrics, end=c.loop.now(), recoveries=c.controller.recoveries,
                epoch=c.controller.epoch, storage=[storage_dump(ss) for ss in c.storage],
                verdicts=list(log), files=fs_image(c.fs) if c.fs is not None else None,
                status=drop_host_clock(doc, m.backend))


def both(monkeypatch, scenario, **kw):
    """`scenario(m, log)` once per package, each with its default set
    recorded into `log`; every part of the outcome must be equal.  The
    garbage collector is off during each run: a collected transaction
    releases its snapshot cache's bytes, a live gauge in the status
    document and the ClientMetrics events, so with the collector on that
    gauge depends on when it happened to run."""
    out = []
    for m in (PORT, REF):
        log = []
        gc.collect()
        gc.disable()
        try:
            with monkeypatch.context() as mp:
                recording(mp, m, log)
                out.append(scenario(m, log, **kw))
        finally:
            gc.enable()
        jbuggify.disable()
        buggify.disable()
    got, want = out
    for key in want:
        assert got[key] == want[key], f"{key} differs at {first_difference(got[key], want[key])}"
    assert any(e[0] == "batch" and e[3] for e in got["verdicts"]), "no resolver batch"
    return got


def workload_run(m, log, seed, make, **cluster_kw):
    c = m.recoverable.RecoverableCluster(seed=seed, **cluster_kw, **m.cluster_kw)
    metrics = m.base.run_workloads(c, make(m, c), deadline=600.0)
    out = outcome(m, c, metrics, log)
    c.stop()
    return out


def cycle_attrition(m, c, kills=2):
    return [m.cycle.CycleWorkload(nodes=8, clients=2, txns_per_client=10),
            m.attrition.AttritionWorkload(kills=kills)]


@pytest.mark.parametrize("engine, kw", [
    ("memory", {}),
    ("ssd", dict(redundancy="double")),
    ("memory", dict(n_workers=4)),
], ids=["memory", "ssd-double", "workers"])
def test_cycle_with_attrition(monkeypatch, engine, kw):
    """Cycle with two pipeline kills: both recoveries recruit new resolvers
    at the recovery version, and the two packages stay identical."""
    got = both(monkeypatch, workload_run, seed=7, make=cycle_attrition,
               storage_engine=engine, **kw)
    assert got["metrics"]["Cycle"]["committed"] == 20
    assert got["recoveries"] >= 2
    oldest = [e[2] for e in got["verdicts"] if e[0] == "new"]
    assert len(oldest) >= 3 and oldest[0] == 0 and all(v > 0 for v in oldest[1:])
    suffix = ".hdr" if engine == "ssd" else ".kv"
    assert any(p.endswith(suffix) for p in got["files"])


def bank_tlog_kill(m, c):
    async def kill_tlog():
        await c.loop.delay(0.5)
        c.controller.generation.tlogs[0].process.kill()

    class TLogKill(m.base.Workload):
        description = "TLogKill"

        async def start(self, cluster, rng):
            await kill_tlog()

    return [m.bank.BankWorkload(accounts=8, clients=3, transfers_per_client=8),
            TLogKill()]


def test_bank_with_a_tlog_kill(monkeypatch):
    got = both(monkeypatch, workload_run, seed=31, make=bank_tlog_kill, n_storage_shards=2)
    assert got["metrics"]["Bank"]["committed"] == 24
    assert got["recoveries"] >= 1


def power_off_restart(m, log, engine):
    """Cycle with one kill, power off mid-life, restart from the same
    SimFilesystem (a new conflict set at the restart's recovery version),
    then read everything back and commit once more."""
    kw = dict(storage_engine=engine, redundancy="double", **m.cluster_kw)
    c = m.recoverable.RecoverableCluster(seed=43, **kw)
    metrics = m.base.run_workloads(c, cycle_attrition(m, c, kills=1), deadline=600.0)
    before = outcome(m, c, metrics, log)
    fs = c.power_off()
    c2 = m.recoverable.RecoverableCluster(seed=44, fs=fs, restart=True, **kw)
    db = c2.database()

    async def check():
        tr = db.create_transaction()
        rows = await tr.get_range(b"cycle/", b"cycle0", limit=1000)
        tr2 = db.create_transaction()
        tr2.set(b"alive", b"1")
        await tr2.commit()
        return rows

    rows = c2.run_until(c2.loop.spawn(check()), 120)
    after = outcome(m, c2, {"rows": rows}, log)
    c2.stop()
    return dict(before=before, after=after, verdicts=list(log))


@pytest.mark.parametrize("engine", ["memory", "ssd"])
def test_power_off_and_restart(monkeypatch, engine):
    got = both(monkeypatch, power_off_restart, engine=engine)
    assert len(got["after"]["metrics"]["rows"]) == 8
    assert got["after"]["epoch"] > got["before"]["epoch"]
    news = [e for e in got["verdicts"] if e[0] == "new"]
    assert news[-1][2] > 0  # the restart's set starts at its recovery version


def test_port_recoverable_cluster_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recoverable.RecoverableCluster()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recoverable.RecoverableCluster(seed=3, storage_engine="ssd", device="cuda")


def test_default_backend_is_the_device_set_in_every_generation():
    """No oracle anywhere: the first generation's resolvers and a recovered
    generation's host the port's DeviceConflictSet on the device asked
    for, and the deposed generation's set is left to the collector."""
    c = recoverable.RecoverableCluster(seed=5, n_resolvers=2, device="cpu")

    def sets():
        return [r.cs for r in c.controller.generation.resolvers]

    first = sets()
    assert all(type(cs) is device.DeviceConflictSet and cs.device.type == "cpu"
               for cs in first)
    refs = [weakref.ref(cs) for cs in first]
    del first
    base.run_workloads(c, [attrition.AttritionWorkload(kills=1, start_delay=0.2),
                           cycle.CycleWorkload(nodes=6, clients=2, txns_per_client=4)],
                       deadline=600.0)
    assert c.controller.recoveries >= 1
    now = sets()
    assert all(type(cs) is device.DeviceConflictSet and cs._oldest > 0 for cs in now)
    gc.collect()
    assert all(r() is None for r in refs), "an old generation's set is still held"
    c.stop()


def _lazy_targets():
    """Every `from ... import name` inside a function of the slice's
    modules: (module, line, target module, name)."""
    out = []
    for rel in SLICE:
        path = REPO / "foundationdb_tpu_torch" / f"{rel}.py"
        pkg = "foundationdb_tpu_torch." + rel.replace("/", ".").rsplit(".", 1)[0]
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.ImportFrom):
                    base_ = pkg.split(".")[: len(pkg.split(".")) - node.level + 1]
                    target = ".".join(base_ + [node.module]) if node.level else node.module
                    out += [(rel, node.lineno, target, a.name) for a in node.names]
    return out


def test_every_lazy_import_of_the_slice_resolves_in_the_port():
    targets = _lazy_targets()
    assert len(targets) > 100
    for rel, line, target, name in targets:
        assert target.startswith("foundationdb_tpu_torch."), (rel, line, target)
        mod = importlib.import_module(target)
        assert hasattr(mod, name), f"{rel}:{line} imports {name} from {target}"
