"""The port's backup and restore (foundationdb_tpu_torch/client/backup.py
over roles/backup.py), restart images (storage/image.py) and the
ConsistencyCheck workload against the reference's, on the same seeds: the
scenarios of tests/test_backup.py (a file container under load, a
point-in-time restore, a pipeline recovery mid-backup, chaos with a kill),
restart images saved by both packages and the images `load_image` must
refuse, and replica equality after a kill.  tests/test_torch_dr.py and
tests/test_torch_blobstore.py hold the DR and blob-store scenarios and use
the helpers here.

Each scenario is one function over a namespace of modules, run once per
package by `run_both` (tests/test_torch_layers.py): the port's clusters on
their default backend with `device="cpu"`, the reference's on its default.
The results (restored keyspaces, reads, error classes), the coverage
census, the verdict stream of every conflict set of every cluster, and
every file of every SimFilesystem byte for byte must be identical."""

import ast
import importlib
import importlib.util
import os
from pathlib import Path

import pytest

from tests.test_torch_layers import PORT, REF, cluster, err_name, finish, run_both
from tests.test_torch_recoverable import fs_image
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
SLICE = ["client/tuple_layer", "client/directory_layer", "client/taskbucket",
         "client/multiversion", "client/backup", "client/dr", "storage/blobstore",
         "storage/image", "control/election", "workloads/consistency",
         "workloads/blob_backup", "workloads/save_and_kill"]


def run(c, coro, deadline=900.0):
    return c.run_until(c.loop.spawn(coro), deadline)


def full_read(c, db):
    async def fn(tr):
        return await tr.get_range(b"", b"\xff", limit=1 << 20)

    return run(c, db.run(fn))


def read_version(db):
    async def fn(tr):
        return await tr.get_read_version()

    return db.run(fn)


# ---- helpers the blob-store scenarios share ---------------------------------

def sim_client(m, c, nonce="cT"):
    store = m.blobstore.BlobObjectStore(m.blobstore.SimFSBacking(c.fs))
    client = m.blobstore.BlobStoreClient(
        m.blobstore.SimBlobTransport(store, c.loop, c.rng), knobs=c.knobs, trace=c.trace,
        sleep=lambda s: c.loop.delay(s), nonce=nonce)
    return store, client


async def attempt(coro, out: list):
    """Await `coro`; record its result, or the class of what it raised."""
    try:
        out.append(await coro)
    except Exception as e:  # the scenario records the error class
        out.append(err_name(e))


def plain_backup(chunks, log) -> tuple:
    """A container's read(), its mutations as (type, key, value): each
    package has its own Mutation class."""
    return chunks, [(v, [(int(mu.type), mu.key, mu.value) for mu in muts]) for v, muts in log]


def image_tree(root: str) -> dict:
    """Every file under an image directory, by relative path, byte for byte."""
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


# ---- file containers: backup and restore ------------------------------------

def restore_into(m, seed: int, cont, **kw):
    """A fresh cluster, the backup restored into it, and its keyspace."""
    dst = cluster(m, seed, **kw)
    db2 = dst.database()
    target = run(dst, m.backup.restore(db2, cont))
    return dst, target, full_read(dst, db2)


def backup_roundtrip(m) -> dict:
    src = cluster(m, 501, n_storage_shards=2, storage_replication=2)
    db = src.database()
    agent = m.backup.BackupAgent(src)
    cont = m.backup.BackupContainer(src.fs, "bk1")

    async def main():
        for i in range(40):
            tr = db.create_transaction()
            tr.set(b"pre%03d" % i, b"p%d" % i)
            await tr.commit()
        start = await agent.start(cont)
        snap_v = await agent.snapshot(cont, chunk_rows=16)
        for i in range(20):
            tr = db.create_transaction()
            tr.set(b"pre%03d" % i, b"OVER%d" % i)
            tr.set(b"post%03d" % i, b"q%d" % i)
            await tr.commit()
        tr = db.create_transaction()
        tr.clear_range(b"pre030", b"pre035")
        tr.atomic_op(m.types.MutationType.ADD, b"ctr", (7).to_bytes(8, "little"))
        await tr.commit()
        tr = db.create_transaction()
        tr.atomic_op(m.types.MutationType.ADD, b"ctr", (5).to_bytes(8, "little"))
        await tr.commit()
        await agent.wait_backed_up_to(await read_version(db))
        await agent.stop()
        return start, snap_v

    versions = run(src, main())
    want = full_read(src, db)
    chunks, log = m.backup.read_backup(cont)
    src_files = fs_image(src.fs)
    src.stop()
    dst, target, got = restore_into(m, 502, cont, n_storage_shards=2, storage_replication=2)
    return finish(dst, dict(versions=versions, want=want, got=got, target=target,
                            referee=m.backup.apply_backup(chunks, log), src_files=src_files,
                            chunks=[(b, e, v, len(r)) for b, e, v, r in chunks], log=len(log)))


def point_in_time(m) -> dict:
    src = cluster(m, 503, n_storage_shards=1, storage_replication=2)
    db = src.database()
    agent = m.backup.BackupAgent(src)
    cont = m.backup.backup_container("file://bk2", fs=src.fs)

    async def main():
        for i in range(10):
            tr = db.create_transaction()
            tr.set(b"k%02d" % i, b"v1")
            await tr.commit()
        await agent.start(cont)
        await agent.snapshot(cont, chunk_rows=4)
        tr = db.create_transaction()
        tr.set(b"marker", b"mid")
        await tr.commit()
        v_mid = await read_version(db)
        for i in range(10):
            tr = db.create_transaction()
            tr.set(b"k%02d" % i, b"v2")
            await tr.commit()
        await agent.wait_backed_up_to(await read_version(db))
        await agent.stop()
        return v_mid

    v_mid = run(src, main())
    src_files = fs_image(src.fs)
    src.stop()
    dst = cluster(m, 504, n_storage_shards=1, storage_replication=2)
    db2 = dst.database()
    target = run(dst, m.backup.restore(db2, cont, target_version=v_mid))
    low = []
    try:
        m.backup.apply_backup(*m.backup.read_backup(cont), target_version=1)
    except ValueError as e:
        low.append(err_name(e))
    return finish(dst, dict(v_mid=v_mid, target=target, got=full_read(dst, db2),
                            src_files=src_files, low=low))


def survives_pipeline_recovery(m) -> dict:
    """A TLog killed mid-backup: the worker rejoins the new generation by
    its tag and the log stays complete."""
    src = cluster(m, 505, n_storage_shards=1, storage_replication=2)
    db = src.database()
    agent = m.backup.BackupAgent(src)
    cont = m.backup.BackupContainer(src.fs, "bk3")

    async def main():
        await agent.start(cont)
        await agent.snapshot(cont, chunk_rows=8)
        for i in range(15):
            tr = db.create_transaction()
            tr.set(b"a%02d" % i, b"x%d" % i)
            await tr.commit()
        epoch = src.controller.epoch
        src.controller.generation.tlogs[0].process.kill()
        for _ in range(400):
            if src.controller.epoch > epoch and src.controller.generation:
                break
            await src.loop.delay(0.1)
        for i in range(15, 30):
            tr = db.create_transaction()
            tr.set(b"a%02d" % i, b"x%d" % i)
            await tr.commit()
        await agent.wait_backed_up_to(await read_version(db), timeout=120.0)
        await agent.stop()
        return epoch, src.controller.epoch

    epochs = run(src, main())
    want = full_read(src, db)
    src_files = fs_image(src.fs)
    src.stop()
    dst, target, got = restore_into(m, 506, cont, n_storage_shards=1, storage_replication=2)
    return finish(dst, dict(epochs=epochs, want=want, got=got, target=target,
                            src_files=src_files))


def exact_under_chaos(m) -> dict:
    """Chaos (the package's buggify armed) and a kill while a backup runs:
    the restore matches the source byte for byte."""
    src = cluster(m, 3205, n_storage_shards=2, storage_replication=2, chaos=True)
    agent = m.backup.BackupAgent(src)
    cont = m.backup.BackupContainer(src.fs, "bk-chaos")
    run(src, agent.start(cont), 300)
    run(src, agent.snapshot(cont, chunk_rows=16), 600)
    metrics = m.base.run_workloads(src, [
        m.cycle.CycleWorkload(nodes=6, clients=2, txns_per_client=4),
        m.increment.IncrementWorkload(counters=3, clients=2, adds_per_client=4),
        m.attrition.AttritionWorkload(kills=1, interval=2.0, start_delay=0.8)], deadline=900.0)
    db = src.database()

    async def settle():
        await agent.wait_backed_up_to(await read_version(db), timeout=120.0)
        await agent.stop()

    run(src, settle())
    want = full_read(src, db)
    recoveries = src.controller.recoveries
    src_files = fs_image(src.fs)
    src.stop()
    m.buggify.disable()
    dst, target, got = restore_into(m, 8205, cont, n_storage_shards=2, storage_replication=2)
    return finish(dst, dict(metrics=metrics, want=want, got=got, target=target,
                            recoveries=recoveries, src_files=src_files))


@pytest.mark.parametrize("scenario", [backup_roundtrip, point_in_time,
                                      survives_pipeline_recovery, exact_under_chaos],
                         ids=["roundtrip", "point-in-time", "pipeline-recovery", "chaos"])
def test_backup_and_restore(monkeypatch, scenario):
    got = run_both(monkeypatch, scenario)
    assert any(e[0] == "batch" and e[3] for e in got["verdicts"]), "no resolver batch"
    if "want" in got:
        assert got["got"] == got["want"] and got["got"]
    if scenario is backup_roundtrip:
        assert (b"ctr", (12).to_bytes(8, "little")) in got["got"]
        assert not any(b"pre030" <= k < b"pre035" for k, _v in got["got"])
        assert dict(got["got"]) == got["referee"]
    elif scenario is point_in_time:
        rows = dict(got["got"])
        assert rows[b"marker"] == b"mid" and all(rows[b"k%02d" % i] == b"v1" for i in range(10))
        assert got["target"] == got["v_mid"] and got["low"] == ["ValueError"]
    elif scenario is survives_pipeline_recovery:
        assert got["epochs"][1] > got["epochs"][0] and len(got["got"]) == 30
    else:
        assert got["recoveries"] >= 1


def image_refusals(m, tmp: Path) -> dict:
    """save_image over a reused directory, then the images load_image must
    refuse: a torn manifest, a corrupt payload, a missing payload, none."""
    loop = m.core.EventLoop()
    fs = m.files.SimFilesystem(loop, m.core.DeterministicRandom(5))
    f = fs.open("disk/a%2Fb.dq", None)
    f.append(b"synced bytes")
    loop.run_until(loop.spawn(f.sync()), 10)
    f.append(b"lost at the kill")
    m.image.save_image(fs, str(tmp / "img"), {"first": True})
    m.image.save_image(fs, str(tmp / "img"), {"seed": 5, "obj": object})  # replaces it
    out = [image_tree(str(tmp / "img"))]
    files, manifest = m.image.load_image(str(tmp / "img"))
    out.append((files, manifest))
    restored = m.image.restore_filesystem(files)
    out.append({p: restored.open(p, None).read_all() for p in restored.list()})

    def refusal(mutate):
        d = tmp / f"bad{len(out)}"
        m.image.save_image(fs, str(d), {"seed": 5})
        mutate(d)
        try:
            m.image.load_image(str(d))
        except m.image.RestartImageError as e:
            return err_name(e), str(e).replace(str(d), "<dir>")

    out.append(refusal(lambda d: (d / "manifest.json").write_bytes(b'{"format": 1, "fi')))
    out.append(refusal(lambda d: next(d.glob("files/*")).write_bytes(b"synced bytez")))
    out.append(refusal(lambda d: next(d.glob("files/*")).unlink()))
    out.append(refusal(lambda d: (d / "manifest.json").unlink()))
    return dict(out=out)


def test_restart_images_are_byte_identical(monkeypatch, tmp_path):
    got = run_both(monkeypatch, lambda m: image_refusals(
        m, tmp_path / ("port" if m is PORT else "ref")))
    tree, (files, manifest), restored, *refused = got["out"]
    assert files == restored == {"disk/a%2Fb.dq": b"synced bytes"}
    assert manifest["seed"] == 5 and "first" not in manifest and sorted(tree)[0].startswith("files")
    assert all(r[0] == "RestartImageError" for r in refused) and len(refused) == 4


# ---- the workloads ----------------------------------------------------------

def consistency_scenario(m) -> dict:
    c = cluster(m, 77, redundancy="double", storage_engine="ssd")
    metrics = m.base.run_workloads(c, [
        m.cycle.CycleWorkload(nodes=8, clients=2, txns_per_client=8),
        m.attrition.AttritionWorkload(kills=1),
        m.consistency.ConsistencyCheckWorkload()], deadline=600.0)
    return finish(c, dict(metrics=metrics, recoveries=c.controller.recoveries))


def test_consistency_check_after_a_kill(monkeypatch):
    got = run_both(monkeypatch, consistency_scenario)
    cc = got["metrics"]["ConsistencyCheck"]
    assert cc["shards_checked"] == 1 and cc["replicas_compared"] == 2 and cc["rows_checked"] >= 8


def test_backup_container_urls_without_the_environment():
    """The port's URL factory: the same schemes as the reference's, and no
    URL raises ValueError (the reference would read FDBTPU_BLOB_URL)."""
    for m in (PORT, REF):
        loop = m.core.EventLoop()
        fs = m.files.SimFilesystem(loop, m.core.DeterministicRandom(1))
        b, bs = m.backup, m.blobstore
        client = bs.BlobStoreClient(
            bs.SimBlobTransport(bs.BlobObjectStore(bs.HostBacking()), loop,
                                m.core.DeterministicRandom(2)), sleep=lambda s: loop.delay(s))
        assert type(b.backup_container("file://bk1", fs=fs)) is b.BackupContainer
        assert b.backup_container("bk2", fs=fs).prefix == "bk2"
        assert type(b.backup_container("blob://bk3", blob_client=client)) is b.BlobBackupContainer
        http = b.backup_container("http://127.0.0.1:1234/bk4")
        assert type(http) is b.BlobBackupContainer and http.name == "bk4"
        with pytest.raises(ValueError, match="blob_client"):
            b.backup_container("blob://bk5")
        with pytest.raises(ValueError, match="fs="):
            b.backup_container("file://bk6")
    with pytest.raises(ValueError, match="no backup container URL"):
        PORT.backup.backup_container(None, fs=fs)
    with pytest.raises(ValueError, match="no backup container URL"):
        PORT.backup.backup_container(fs=fs)


# ---- the slice's lazy imports -----------------------------------------------

def test_every_lazy_import_of_the_slice_resolves_in_the_port():
    n = 0
    for rel in SLICE:
        path = REPO / "foundationdb_tpu_torch" / f"{rel}.py"
        pkg = "foundationdb_tpu_torch." + rel.replace("/", ".").rsplit(".", 1)[0]
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                parts = pkg.split(".")[: len(pkg.split(".")) - node.level + 1]
                target = ".".join(parts + ([node.module] if node.module else []))
                mod = importlib.import_module(target)
                for a in node.names:
                    assert hasattr(mod, a.name) or importlib.util.find_spec(
                        f"{target}.{a.name}"), f"{rel}:{node.lineno} imports {a.name}"
                    n += 1
    assert n > 40
