"""The port's blob store (foundationdb_tpu_torch/storage/blobstore.py), the
blob backup container (client/backup.py) and the BlobBackup and
SaveAndKill workloads against the reference's, on the same seeds: the
scenarios of tests/test_blobstore.py (the object model, the torn upload,
the corrupt read, the refused corrupt object, the torn meta, the killed
uploader, the queue's duplicates, a point-in-time restore with the
uploader killed, the container across a restart image), a restarting pair
(BlobBackup and Cycle under chaos, SaveAndKill's image, BlobBackup's
verify after the reboot), and the real-socket server in both directions:
the port's client against the reference's server and the reverse, on
loopback under a time limit of their own, with objects byte-identical.

The simulated scenarios run through `run_both` (tests/test_torch_layers.py):
results, the coverage census, the verdict stream and every SimFilesystem
file byte for byte (the store's objects live there) must be identical."""

import asyncio
from pathlib import Path

import pytest

from tests.test_torch_backup import (attempt, image_tree, plain_backup, read_version, run,
                                     sim_client)
from tests.test_torch_layers import PORT, REF, cluster, finish, run_both
from tests.test_torch_recoverable import fs_image
from tests.torch_threads import one_torch_thread  # noqa: F401

HTTP_LIMIT_S = 30.0  # each loopback session's own time limit


def blob_roundtrip(m, c, store, client, out):
    async def main():
        await client.write_object("a/x", b"hello")
        await client.write_object("a/y", b"world" * 10000)  # multipart
        await client.write_object("b/z", b"!")
        for coro in (client.read_object("a/x"), client.list_objects("a/"),
                     client.head_object("a/y")):
            await attempt(coro, out)
        await client.delete_object("a/x")
        await attempt(client.list_objects("a/"), out)
        await attempt(client.read_object("a/x"), out)

    return main()


def blob_torn_part(m, c, store, client, out):
    m.buggify.force("blob.upload_torn")
    data = bytes(range(256)) * 400  # several parts

    async def main():
        await client.write_object("t/obj", data)
        out.append(await client.read_object("t/obj") == data)

    return main()


def blob_torn_exhausted(m, c, store, client, out):
    async def main():
        await client.write_object("p/good", b"G" * 99999)
        nparts = -(-99999 // c.knobs.BLOB_PART_BYTES)
        m.buggify.force("blob.upload_torn", times=(c.knobs.BLOB_RETRY_LIMIT + 1) * nparts)
        await attempt(client.write_object("p/bad", b"B" * 99999), out)
        await attempt(client.list_objects("p/"), out)
        out.append(await client.read_object("p/good") == b"G" * 99999)

    return main()


def blob_read_corrupt(m, c, store, client, out):
    async def main():
        await client.write_object("r/obj", b"payload" * 50)
        m.buggify.force("blob.read_corrupt")
        await attempt(client.read_object("r/obj"), out)

    return main()


def blob_connect_fail(m, c, store, client, out):
    async def main():
        m.buggify.force("blob.connect_fail", times=2)
        await client.write_object("c/obj", b"x")
        m.buggify.force("blob.connect_fail", times=(c.knobs.BLOB_RETRY_LIMIT + 1) * 2)
        await attempt(client.read_object("c/obj"), out)
        out.append(len(c.trace.find("BlobRequestRetried")))

    return main()


def blob_corrupt_payload(m, c, store, client, out):
    async def main():
        await client.write_object("x/obj", b"precious data")
        await store.backing.write("o/x/obj", b"precious dat!")  # behind the store's back
        await attempt(client.read_object("x/obj"), out)

    return main()


def blob_torn_meta(m, c, store, client, out):
    async def main():
        await client.write_object("tm/good", b"ok")
        await client.write_object("tm/torn", b"doomed")
        await store.backing.write("m/tm/torn", b'{"size": 6, "crc')
        for coro in (client.list_objects("tm/"), client.read_object("tm/torn"),
                     client.read_object("tm/good")):
            await attempt(coro, out)

    return main()


def blob_killed_uploader(m, c, store, client, out):
    data = b"D" * 200000

    async def killed():
        await client.write_object("k/obj", data)

    async def main():
        t = c.loop.spawn(killed())
        await c.loop.delay(0.001)  # a few parts staged, no complete
        t.cancel()
        await attempt(t, out)
        await attempt(client.list_objects("k/"), out)
        await attempt(client.read_object("k/obj"), out)
        _s2, client2 = sim_client(m, c, nonce="cR")
        await client2.write_object("k/obj", data)
        out.append(await client2.read_object("k/obj") == data)

    return main()


def blob_queue_dedup(m, c, store, client, out):
    async def main():
        q = m.blobstore.BlobQueue(client, "q/log", "w1")
        q.push(b"rec1")
        q.push(b"rec2")
        await q.sync()
        q.push(b"rec3")
        await q.sync()
        q2 = m.blobstore.BlobQueue(client, "q/log", "w2")
        q2.push(b"rec3")
        await q2.sync()
        out.append(await m.blobstore.BlobQueue(client, "q/log", "r").recover())

    return main()


BLOB_CASES = {  # name: (seed, chaos, scenario, the port's `out`)
    "roundtrip": (7301, False, blob_roundtrip, None),
    "torn-part": (7302, True, blob_torn_part, [True]),
    "torn-exhausted": (7303, True, blob_torn_exhausted, ["BlobError", ["p/good"], True]),
    "read-corrupt": (7304, True, blob_read_corrupt, [b"payload" * 50]),
    "connect-fail": (7305, True, blob_connect_fail, None),
    "corrupt-payload": (7306, False, blob_corrupt_payload, ["BlobError"]),
    "torn-meta": (7313, False, blob_torn_meta, [["tm/good"], "BlobNotFound", b"ok"]),
    "killed-uploader": (7307, False, blob_killed_uploader,
                        ["ActorCancelled", [], "BlobNotFound", True]),
    "queue-dedup": (7308, False, blob_queue_dedup, None),
}


def blob_scenario(m, case: str) -> dict:
    seed, chaos, make, _want = BLOB_CASES[case]
    c = cluster(m, seed, chaos=chaos)
    store, client = sim_client(m, c)
    out = []
    run(c, make(m, c, store, client, out), 300)
    return finish(c, dict(out=out, retries=client.retries))


@pytest.mark.parametrize("case", list(BLOB_CASES))
def test_blob_store(monkeypatch, case):
    got = run_both(monkeypatch, blob_scenario, case=case)
    want = BLOB_CASES[case][3]
    out, census = got["out"], got["census"]
    if want is not None:
        assert out == want
    if case == "roundtrip":
        assert out[:2] == [b"hello", ["a/x", "a/y"]] and out[2]["size"] == 50000
        assert out[3:] == [["a/y"], "BlobNotFound"]
    elif case == "torn-part":
        assert got["retries"] >= 1 and census.get("blob.torn_refused", 0) >= 1
        assert census.get("blob.retry_recovered", 0) >= 1
    elif case == "read-corrupt":
        assert census.get("blob.read_corrupt_detected", 0) >= 1
    elif case == "connect-fail":
        assert out[0] == "BlobError" and out[1] >= 2
    elif case == "torn-meta":
        assert census.get("blob.torn_meta_ignored", 0) >= 1
    elif case == "queue-dedup":
        assert sorted(out[0]) == [b"rec1", b"rec2", b"rec3", b"rec3"]


# ---- the real-socket server, across the packages ----------------------------

async def http_session(m, port: int) -> list:
    """The reference test's session from package `m`'s client."""
    bs = m.blobstore
    client = bs.BlobStoreClient(bs.HttpBlobTransport("127.0.0.1", port))
    out = []
    data = b"H" * 150000  # several parts
    await client.write_object("h/obj", data)
    await client.write_object("h/small", b"s")
    out.append(await client.read_object("h/obj") == data)
    for coro in (client.list_objects("h/"), client.head_object("h/obj"),
                 client.read_object("h/nope")):
        await attempt(coro, out)
    t = bs.HttpBlobTransport("127.0.0.1", port)
    await t.request("put_part", upload="u9", part=0, data=b"torn", crc32=bs.blob_crc(b"whole"))
    await attempt(t.request("complete", name="h/torn", upload="u9",
                            crc32=bs.blob_crc(b"whole"), parts=1), out)
    await client.delete_object("h/small")
    await attempt(client.list_objects("h/"), out)
    return out


def http_pair(client_m, server_m):
    """A session of `client_m`'s client against `server_m`'s server on
    loopback; returns what the client saw and every file of the server's
    backing."""
    async def main():
        server = server_m.blobstore.BlobStoreServer()
        port = await server.start()
        try:
            out = await asyncio.wait_for(http_session(client_m, port), HTTP_LIMIT_S)
        finally:
            await server.stop()
        return out, dict(server.store.backing._files)

    return asyncio.run(main())


@pytest.mark.parametrize("client, server", [(PORT, REF), (REF, PORT)],
                         ids=["port-client-ref-server", "ref-client-port-server"])
def test_http_blob_store_across_packages(client, server):
    got = http_pair(client, server)
    want = http_pair(REF, REF)
    assert got == want
    out, files = got
    assert out[:2] == [True, ["h/obj", "h/small"]] and out[3:] == [
        "BlobNotFound", "BlobChecksumError", ["h/obj"]]
    assert sorted(files) == ["m/h/obj", "o/h/obj"] and files["o/h/obj"] == b"H" * 150000


# ---- blob backup end to end, and restart images -----------------------------

def blob_pit_restore(m) -> dict:
    """Back up into a blob container, kill the uploader at a jittered
    offset, then restore point-in-time into a second cluster on the same
    loop."""
    src = cluster(m, 7310, n_storage_shards=2, storage_replication=2)
    db = src.database()
    _store, client = sim_client(m, src)
    cont = m.backup.backup_container("blob://bk", blob_client=client,
                                     uid=lambda: src.rng.random_unique_id()[:8])
    agent = m.backup.BackupAgent(src)
    model = {}

    async def commit(i, v):
        async def fn(tr):
            tr.set(b"d%04d" % i, v)

        await db.run(fn)
        model[b"d%04d" % i] = v

    async def main():
        await agent.start(cont)
        for i in range(12):
            await commit(i, b"a%d" % i)
        snap_v = await agent.snapshot(cont, chunk_rows=5)
        pit_model = dict(model)
        pit_v = await db.create_transaction().get_read_version()
        await src.loop.delay(0.01 + src.rng.random() * 0.2)
        agent.kill_worker()
        await agent.restart_worker(cont)
        for i in range(12, 24):
            await commit(i, b"b%d" % i)
        await agent.wait_backed_up_to(await db.create_transaction().get_read_version())
        await agent.stop()
        return snap_v, pit_v, pit_model

    snap_v, pit_v, pit_model = run(src, main())
    chunks, log = run(src, cont.read())
    full = {k: v for k, v in m.backup.apply_backup(chunks, log).items() if k.startswith(b"d")}
    pit = {k: v for k, v in m.backup.apply_backup(chunks, log, pit_v).items()
           if k.startswith(b"d")}
    dst = cluster(m, 7311, loop=src.loop)
    dst_db = dst.database()
    run(src, m.backup.restore(dst_db, cont, target_version=pit_v))

    async def fn(tr):
        return await tr.get_range(b"d", b"e", limit=10000)

    restored = dict(run(src, dst_db.run(fn)))
    out = dict(snap_v=snap_v, pit_v=pit_v, model=model, pit_model=pit_model, full=full, pit=pit,
               restored=restored, retries=client.retries, dst_files=fs_image(dst.fs))
    dst.stop()
    return finish(src, out)


def blob_restart_image(m, tmp: Path) -> dict:
    """The blob store on the simulated disks rides a power-off, a restart
    image on the host's disk and a restart: the rebooted container reads
    the same chunks and log."""
    c = cluster(m, 7312)
    db = c.database()
    _store, client = sim_client(m, c)
    cont = m.backup.backup_container("blob://bk", blob_client=client,
                                     uid=lambda: c.rng.random_unique_id()[:8])
    agent = m.backup.BackupAgent(c)

    async def main():
        await agent.start(cont)
        for i in range(8):
            async def fn(tr, i=i):
                tr.set(b"s%02d" % i, b"v%d" % i)

            await db.run(fn)
        snap_v = await agent.snapshot(cont, chunk_rows=4)
        await agent.wait_backed_up_to(max(snap_v, await read_version(db)))
        await agent.stop()
        return await cont.read()

    before = plain_backup(*run(c, main()))
    fs = c.power_off()
    saved = m.image.save_image(fs, str(tmp / "image"), {"seed": 7312, "note": "blob"})
    files, manifest = m.image.load_image(saved)
    c2 = cluster(m, 7312, fs=m.image.restore_filesystem(files), restart=True)
    _store2, client2 = sim_client(m, c2)
    cont2 = m.backup.backup_container("blob://bk", blob_client=client2,
                                      uid=lambda: c2.rng.random_unique_id()[:8])
    chunks, log = run(c2, cont2.read(), 300)
    state = m.backup.apply_backup(chunks, log)
    return finish(c2, dict(before=before, after=plain_backup(chunks, log), manifest=manifest, image=image_tree(saved),
                           state={k: v for k, v in state.items() if k.startswith(b"s")}))


def test_blob_backup_point_in_time_restore_with_uploader_kill(monkeypatch):
    got = run_both(monkeypatch, blob_pit_restore)
    assert got["full"] == got["model"] and len(got["model"]) == 24
    assert got["pit"] == got["pit_model"] == got["restored"] and got["pit_v"] >= got["snap_v"]


def test_blob_container_survives_a_restart_image(monkeypatch, tmp_path):
    got = run_both(monkeypatch, lambda m: blob_restart_image(
        m, tmp_path / ("port" if m is PORT else "ref")))
    assert got["after"] == got["before"] and got["after"][0]
    assert got["state"] == {b"s%02d" % i: b"v%d" % i for i in range(8)}
    assert "manifest.json" in got["image"] and got["manifest"]["format"] == 1


def restarting_pair(m, tmp: Path, seed: int) -> dict:
    """Part 1: BlobBackup (blob faults armed by seeded coins under chaos,
    the uploader killed) beside a Cycle, then SaveAndKill powers the
    simulation off and saves its image.  Part 2: the image restored, the
    container re-read by BlobBackup's verify action against what the
    rebooted cluster serves."""
    c = cluster(m, seed, redundancy="double", storage_engine="ssd", chaos=True)
    cyc = m.cycle.CycleWorkload(nodes=6, clients=2, txns_per_client=6)
    bb = m.blob_backup.BlobBackupWorkload(keys=16, burst=4)
    sk = m.save_and_kill.SaveAndKillWorkload(restart_after=3.0)
    sk.bind(str(tmp / "image"), {"seed": seed, "spec": "BlobBackupRestart"}, [cyc, bb, sk])
    try:
        m.base.run_workloads(c, [cyc, bb, sk], deadline=600.0)
    except m.save_and_kill.RestartKill as e:
        image_dir = e.image_dir
    part1 = dict(bb=bb.metrics(), cycle=cyc.metrics(), killed_at=sk.killed_at,
                 states=m.save_and_kill.invariant_states([cyc, bb, sk]))
    m.buggify.disable()
    files, manifest = m.image.load_image(image_dir)
    c2 = cluster(m, seed + 1, redundancy="double", storage_engine="ssd",
                 fs=m.image.restore_filesystem(files), restart=True)
    verify = m.blob_backup.BlobBackupWorkload(keys=16, action="verify")
    verify.load_restart_manifest(manifest)
    metrics = m.base.run_workloads(c2, [verify], deadline=600.0)
    return finish(c2, dict(part1=part1, manifest=manifest, image=image_tree(image_dir),
                           part1_verified=verify.part1_verified, metrics=metrics))


@pytest.mark.parametrize("seed", [3301, 3302])
def test_blob_backup_restarting_pair(monkeypatch, tmp_path, seed):
    got = run_both(monkeypatch, lambda m: restarting_pair(
        m, tmp_path / ("port" if m is PORT else "ref"), seed))
    assert got["part1"]["bb"]["uploader_killed"] and got["part1_verified"]
    assert got["part1"]["bb"]["verified"] and got["manifest"]["workloads"]["Cycle"]
    assert got["census"].get("restart.image_saved") == 1
    assert got["census"].get("backup.blob_reverified_after_reboot") == 1
