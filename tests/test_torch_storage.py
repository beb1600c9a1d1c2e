"""The port's storage plane (foundationdb_tpu_torch/storage/: files,
pagecache, diskqueue, kvstore, btree) against the reference's, on the same
seeds: the scenarios of tests/test_durability.py, test_btree.py,
test_pagecache.py and test_tlog_spill.py.  Each scenario is one function
over a namespace of modules, run once per package; what it returns (reads,
recovered records, counters, the coverage census it adds) and every file of
its SimFilesystem byte for byte (durable bytes, buffered tail, journaled
truncate, and the per-disk gauges) must be identical."""

import gc
import random
import struct
from types import SimpleNamespace

import pytest

from foundationdb_tpu.control import recoverable as jrecoverable
from foundationdb_tpu.roles import types as jtypes
from foundationdb_tpu.rpc import network as jnetwork
from foundationdb_tpu.runtime import buggify as jbuggify
from foundationdb_tpu.runtime import core as jcore
from foundationdb_tpu.runtime import coverage as jcoverage
from foundationdb_tpu.runtime import knobs as jknobs
from foundationdb_tpu.storage import btree as jbtree
from foundationdb_tpu.storage import diskqueue as jdiskqueue
from foundationdb_tpu.storage import files as jfiles
from foundationdb_tpu.storage import kvstore as jkvstore
from foundationdb_tpu.storage import pagecache as jpagecache
from foundationdb_tpu_torch.control import recoverable
from foundationdb_tpu_torch.roles import types
from foundationdb_tpu_torch.rpc import network
from foundationdb_tpu_torch.runtime import buggify, core, coverage, knobs
from foundationdb_tpu_torch.storage import btree, diskqueue, files, kvstore, pagecache
from tests.torch_threads import one_torch_thread  # noqa: F401

PORT = SimpleNamespace(core=core, network=network, files=files, diskqueue=diskqueue,
                       kvstore=kvstore, btree=btree, pagecache=pagecache,
                       coverage=coverage, buggify=buggify, knobs=knobs,
                       recoverable=recoverable, types=types,
                       cluster_kw=dict(device="cpu"))  # the default backend, on the CPU
REF = SimpleNamespace(core=jcore, network=jnetwork, files=jfiles, diskqueue=jdiskqueue,
                      kvstore=jkvstore, btree=jbtree, pagecache=jpagecache,
                      coverage=jcoverage, buggify=jbuggify, knobs=jknobs,
                      recoverable=jrecoverable, types=jtypes, cluster_kw={})


@pytest.fixture(autouse=True)
def _buggify_off():
    yield
    jbuggify.disable()
    buggify.disable()


def fs_image(fs) -> dict:
    """Every file of a SimFilesystem: its durable bytes, its buffered
    (un-fsynced) tail, its journaled truncate, and its disk's gauges."""
    usage = fs.disk_usage()
    return {path: (bytes(st.synced), [bytes(c) for c in st.unsynced],
                   st.pending_truncate, usage.get(path))
            for path, st in sorted(fs._files.items())}


def env(m, seed=1, pool=None):
    loop = m.core.EventLoop()
    fs = m.files.SimFilesystem(loop, m.core.DeterministicRandom(seed))
    if pool is not None:
        fs.page_pool = m.pagecache.PageCachePool(*pool)
    return loop, fs


def drain(loop, coro, deadline=60.0):
    return loop.run_until(loop.spawn(coro), deadline=deadline)


def both(scenario, *args):
    """`scenario(m, *args)` on each package with each one's coverage census
    diffed around it: (result, census added, files) must be equal.  The
    garbage of earlier runs is collected first, and the collector is off
    during each run: a dropped process's death promise breaks when it is
    collected, and its kill hook then drops the unsynced tails of that
    run's files (and counts in the census)."""
    out = []
    for m in (PORT, REF):
        gc.collect()
        gc.disable()
        try:
            before = dict(m.coverage.snapshot())
            result, fs = scenario(m, *args)
            after = m.coverage.snapshot()
            out.append((result, {k: n - before.get(k, 0) for k, n in after.items()
                                 if n != before.get(k, 0)}, fs_image(fs)))
        finally:
            gc.enable()
    got, want = out
    assert got[0] == want[0], "results differ"
    assert got[1] == want[1], "coverage census differs"
    assert got[2] == want[2], "files differ"
    return got


# ---- SimFile: the kill-time loss of un-synced data -------------------------

def sim_file_kill(m, sync_tail: bool):
    loop = m.core.EventLoop()
    rng = m.core.DeterministicRandom(3)
    net = m.network.SimNetwork(loop, rng)
    fs = m.files.SimFilesystem(loop, rng)
    proc = net.create_process("p")
    f = fs.open("x", proc)
    f.append(b"synced")

    async def go():
        await f.sync()
        f.append(b"tail")
        if sync_tail:
            await f.sync()

    drain(loop, go())
    before = (f.size(), f.synced_size(), loop.now())
    proc.kill()
    return (before, fs.open("x", None).read_all(), loop.now()), fs


@pytest.mark.parametrize("sync_tail, want", [(False, b"synced"), (True, b"syncedtail")])
def test_sim_file_kill_drops_only_unsynced(sync_tail, want):
    (_before, got, _t), _census, image = both(sim_file_kill, sync_tail)
    assert got == want and image["x"][0] == want


# ---- DiskQueue: framing, torn tail, bad CRC --------------------------------

def disk_queue(m, case: str):
    loop, fs = env(m)
    dq = m.diskqueue.DiskQueue(fs.open("q", None))
    offs = [dq.push(b"one"), dq.push(b"two")]
    drain(loop, dq.sync())
    f = fs.open("q", None)
    if case == "unsynced":
        dq.push(b"unsynced")
    elif case == "torn":
        f.append(b"\x01\xb7\xfdQ\x99\x00\x00\x00")  # valid magic, absurd length
        drain(loop, f.sync())
    elif case == "bad_crc":
        f.append(struct.pack("<III", 0x51FDB701, 3, 0xDEAD) + b"xyz")
        drain(loop, f.sync())
    q2 = m.diskqueue.DiskQueue(fs.open("q", None))
    out = (offs, [dq.read_at(o) for o in offs], q2.recover(),
           q2.recover(include_unsynced=True), loop.now())
    return out, fs


@pytest.mark.parametrize("case", ["unsynced", "torn", "bad_crc"])
def test_disk_queue_recovers_the_synced_records(case):
    (_offs, reads, synced, _all, _t), _census, _image = both(disk_queue, case)
    assert reads == [b"one", b"two"] and synced == [b"one", b"two"]


# ---- the memory engine: RAM plus a WAL -------------------------------------

def memory_engine(m, case: str):
    loop, fs = env(m)
    kv = m.kvstore.DurableMemoryKeyValueStore(fs, "kv", None)
    if case == "commit":
        kv.set(b"a", b"1")
        kv.set(b"b", b"2")
        drain(loop, kv.commit({"durable_version": 7}))
        kv.set(b"c", b"3")  # never committed
    else:
        for i in range(50):
            kv.set(b"k%03d" % i, b"v%d" % i)
        kv.clear_range(b"k010", b"k020")
        drain(loop, kv.commit())
        kv._write_snapshot()
        drain(loop, kv.commit({"durable_version": 9}))
    kv2 = m.kvstore.DurableMemoryKeyValueStore.recover(fs, "kv", None)
    rows = kv2.range_read(b"", b"\xff", 1 << 30)
    return (rows, kv2.key_count(), dict(kv2.meta), loop.now()), fs


@pytest.mark.parametrize("case, keys", [("commit", 2), ("snapshot", 40)])
def test_memory_engine_commit_and_recover(case, keys):
    (rows, count, _meta, _t), _census, _image = both(memory_engine, case)
    assert count == keys == len(rows)


# ---- the ssd engine: the copy-on-write B+tree ------------------------------

def _crash(store):
    """Every unsynced buffer of the store's files dropped: a power loss."""
    for f in store._files:
        f._drop_unsynced()
    store._hdr.file._drop_unsynced()


def btree_fuzz(m, steps: int):
    """Sets, clears, point and range reads, commits and crash-recoveries
    at random, each read held against a model."""
    loop, fs = env(m, seed=3)
    cls = m.btree.BTreeKeyValueStore
    store = cls(fs, "t", None, cache_bytes=2048)
    rng = random.Random(11)
    model, committed, trail = {}, {}, []

    def key():
        return bytes(rng.choice(b"abcdefgh") for _ in range(rng.randint(1, 5)))

    async def run():
        nonlocal store, model, committed
        for step in range(steps):
            op = rng.random()
            if op < 0.5:
                k, v = key(), bytes(rng.choice(b"xyz") for _ in range(rng.randint(0, 6)))
                store.set(k, v)
                model[k] = v
            elif op < 0.62:
                a, b = sorted((key(), key()))
                store.clear_range(a, b)
                for k in [k for k in model if a <= k < b]:
                    del model[k]
            elif op < 0.72:
                k = key()
                got = store.get(k)
                assert got == model.get(k)
                trail.append(got)
            elif op < 0.82:
                a, b = sorted((key(), key()))
                got = store.range_read(a, b, 1 << 30)
                assert got == sorted((k, v) for k, v in model.items() if a <= k < b)
                trail.append((len(got), store.count_range(a, b), store.middle_key(a, b)))
            elif op < 0.95:
                await store.commit({"durable_version": step})
                committed = dict(model)
            else:
                _crash(store)
                store = cls.recover(fs, "t", None, cache_bytes=2048)
                model = dict(committed)
                trail.append(("recovered", step, store.meta.get("durable_version", 0)))

    loop.run_until(loop.spawn(run()), 1e12)
    final = store.range_read(b"", b"\xff" * 8, 1 << 30)
    assert final == sorted(model.items())
    return (trail, final, store._file_id, store._cache_bytes, loop.now()), fs


def test_btree_model_fuzz_with_crashes():
    (trail, final, *_rest), _census, _image = both(btree_fuzz, 1500)
    assert final and any(t[0] == "recovered" for t in trail if isinstance(t, tuple))


def btree_crash_window(m, case: str):
    """The commit protocol's crash windows: data synced but header not, and
    a compaction cut before its header swap; then growth under overwrites."""
    loop, fs = env(m, seed=3)
    cls = m.btree.BTreeKeyValueStore
    store = cls(fs, "t", None)
    out = []

    async def run():
        nonlocal store
        if case == "header":
            store.set(b"a", b"1")
            store.set(b"b", b"2")
            await store.commit({"durable_version": 1})
            store.set(b"a", b"NEW")
            store.set(b"c", b"3")
            store._fold_memtable()
            root = store._write_branches()
            await store._files[store._file_id].sync()
            store._write_header(root)  # rewritten, never synced
        elif case == "compaction":
            for i in range(300):
                store.set(b"k%04d" % i, b"v%d" % i)
            await store.commit({"durable_version": 1})
            rows = list(store._tree_range(b"", b"\xff" * 8))
            other = 1 - store._file_id
            store._files[other].truncate()
            store._file_id = other
            store._cache.clear()
            store._dir_keys, store._dir_offs, store._dir_cnts = [], [], []
            store._replace_leaves(0, 0, rows)  # appended, never synced
        else:  # growth: repeated overwrites compact the file
            for round_ in range(40):
                for i in range(200):
                    store.set(b"k%03d" % i, b"r%d" % round_)
                before = store._file_id
                await store.commit({"durable_version": round_})
                out.append(store._file_id != before)
            return
        _crash(store)
        store = cls.recover(fs, "t", None)

    loop.run_until(loop.spawn(run()), 1e12)
    rows = store.range_read(b"", b"\xff" * 8, 1 << 30)
    return (out, rows, store._file_id, dict(store.meta),
            [f.size() for f in store._files], loop.now()), fs


@pytest.mark.parametrize("case", ["header", "compaction", "growth"])
def test_btree_crash_windows_and_compaction(case):
    (compacted, rows, _fid, meta, sizes, _t), _census, _image = both(btree_crash_window, case)
    if case == "header":
        assert rows == [(b"a", b"1"), (b"b", b"2")] and meta["durable_version"] == 1
    elif case == "compaction":
        assert rows == [(b"k%04d" % i, b"v%d" % i) for i in range(300)]
    else:
        assert any(compacted) and sum(sizes) < 40 * 200 * 16
        assert rows == [(b"k%03d" % i, b"r39") for i in range(200)]


# ---- the page cache: hits, misses, read-ahead, coherence -------------------

def page_cache(m, case: str):
    loop, fs = env(m, seed=3, pool=(64, 4 * 64 if case == "evict" else 1 << 20, 8))
    net = m.network.SimNetwork(loop, m.core.DeterministicRandom(1), None)
    proc = net.create_process("p")
    f = m.pagecache.CachedFile(fs.open("f", proc), fs.page_pool)
    reads = []

    async def run():
        if case == "offsets":
            f.append(bytes(range(256)) * 7)
            for off, ln in [(0, 10), (60, 10), (63, 2), (64, 64), (100, 700),
                            (0, 1792), (1700, 500), (1791, 1), (1792, 5), (0, 1024)]:
                reads.append(f.pread(off, ln))
        elif case in ("readahead", "evict"):
            f.append(bytes(range(64)) * 32)
            for p in list(range(16)) + [3, 30, 31, 0]:
                reads.append(f.pread(p * 64, 64))
        elif case == "truncate":
            f.append(b"x" * 256)
            await f.sync()
            reads.append(f.pread(0, 64))
            f.truncate()
            reads.append(f.pread(0, 64))
            f.cancel_truncate()
            reads.append(f.pread(0, 64))
            f.truncate()
            f.append(b"y" * 256)
            reads.append(f.pread(0, 64))
        else:  # kill: a cached page of buffered bytes dies with the process
            f.append(b"d" * 128)
            await f.sync()
            f.append(b"u" * 128)
            reads.append(f.pread(128, 64))
            proc.kill()

    drain(loop, run())
    if case == "kill":
        reads += [f.pread(128, 64), f.pread(0, 128)]
    return (reads, f.stats(), fs.page_pool.stats(), loop.now()), fs


@pytest.mark.parametrize("case", ["offsets", "readahead", "evict", "truncate", "kill"])
def test_page_cache_hits_misses_and_readahead(case):
    (reads, stats, pool, _t), census, image = both(page_cache, case)
    assert stats["hits"] + stats["misses"] > 0
    if case == "readahead":
        assert stats["readahead_pages"] > 0 and stats["readahead_hits"] > 0
        assert census.get("cache.readahead") and image["f"][3]["reads"] < 16
    if case == "evict":
        assert pool["evictions"] > 0 and census.get("cache.evict")
    if case == "kill":
        assert reads == [b"u" * 64, b"", b"d" * 128]


def cold_scan(m, cache_on: bool):
    """A cold range scan through the ssd engine, twice, after a reboot of
    the store: the preads it costs with the page cache on or off."""
    loop, fs = env(m, seed=5, pool=(4096, 1 << 20, 8) if cache_on else None)
    store = m.btree.BTreeKeyValueStore(fs, "pc", None, cache_bytes=1 << 14)

    async def build():
        for i in range(2000):
            store.set(b"k%06d" % i, b"v" * 64)
        await store.commit({})

    loop.run_until(loop.spawn(build()), 1e12)
    if fs.page_pool is not None:
        fs.page_pool.clear()
    s2 = m.btree.BTreeKeyValueStore.recover(fs, "pc", None, cache_bytes=1 << 14)
    out = []
    for _ in range(2):
        r0 = sum(fs.disk(p).reads for p in ("pc.a", "pc.b", "pc.hdr"))
        rows = s2.range_read(b"", b"\xff" * 8, 1 << 30)
        out.append((len(rows), sum(fs.disk(p).reads for p in ("pc.a", "pc.b", "pc.hdr")) - r0))
    return (out, s2.stats() if hasattr(s2, "stats") else None), fs


@pytest.mark.parametrize("cache_on", [True, False])
def test_cold_scan_preads(cache_on):
    (out, _stats), _census, _image = both(cold_scan, cache_on)
    assert [n for n, _r in out] == [2000, 2000]


# ---- a TLog over the DiskQueue: spill, then a recovery ---------------------

def tlog_spill(m):
    """A storage replica killed so its tag stops popping; writes until the
    TLogs spill to their disk queues; a sequencer kill forces a recovery
    that locks the TLogs while spilled: the new generation serves every
    row, and a power-off restart from the files serves them again."""
    k = m.knobs.CoreKnobs()
    k.TLOG_SPILL_BYTES = 1500
    c = m.recoverable.RecoverableCluster(seed=402, n_storage_shards=1, storage_replication=2,
                                         knobs=k, **m.cluster_kw)
    db = c.database()
    seen = {}

    async def main():
        next(s for s in c.storage if s.tag == "ss-0-r1").process.kill()
        for base in range(0, 200, 50):
            tr = db.create_transaction()
            for i in range(base, base + 50):
                tr.set(b"rl%04d" % i, b"y" * 40)
            await tr.commit()
        seen["spills"] = [t.spill_events for t in c.controller.generation.tlogs]
        epoch = c.controller.epoch
        c.controller.generation.sequencer.stream._process.kill()
        while not (c.controller.epoch > epoch and c.controller.generation):
            await c.loop.delay(0.1)
        seen["epoch"] = (epoch, c.controller.epoch)
        while c.dd.heals < 1:
            await c.loop.delay(0.1)
        await c.loop.delay(2.0)

        async def fn(tr):
            return await tr.get_range(b"rl", b"rm", limit=100000)

        return await db.run(fn)

    rows = c.run_until(c.loop.spawn(main()), 900)
    out = (rows, seen, c.loop.now(), c.controller.recoveries)
    fs = c.power_off()
    c2 = m.recoverable.RecoverableCluster(seed=403, n_storage_shards=1, storage_replication=2,
                                          knobs=k, fs=fs, restart=True, **m.cluster_kw)
    db2 = c2.database()

    async def read():
        async def fn(tr):
            return await tr.get_range(b"rl", b"rm", limit=100000)

        return await db2.run(fn)

    again = c2.run_until(c2.loop.spawn(read()), 900)
    c2.stop()
    return (out, again, c2.loop.now()), fs


def test_tlog_spill_survives_recovery_and_restart():
    ((rows, seen, _t, _r), again, _t2), _census, image = both(tlog_spill)
    assert len(rows) == 200 and again == rows
    assert any(seen["spills"]) and seen["epoch"][1] > seen["epoch"][0]
    assert any(p.startswith("tlog") for p in image)
