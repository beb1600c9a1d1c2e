"""The port's client layers (foundationdb_tpu_torch/client/: tuple_layer,
directory_layer, taskbucket, multiversion) and its leader election
(control/election.py) against the reference's, on the same seeds: the
scenarios of tests/test_directory.py, test_taskbucket.py,
test_multiversion.py and test_control.py's election test.

Each scenario is one function over a namespace of modules, run once per
package: the port's RecoverableCluster on its default backend with
`device="cpu"`, the reference's on its default.  What it returns (reads,
encodings, executed tasks, the elected leader sequence with its virtual
times), the coverage census it adds, the verdict stream (each conflict
set's creation version and every batch it resolved) and every file of the
cluster's SimFilesystem byte for byte must be identical.  The garbage
collector is off during each run, after a collection (a dropped process's
death promise and a collected transaction's cache bytes otherwise move
with its timing).  `run_both` and the namespaces serve
tests/test_torch_backup.py too."""

import gc
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from foundationdb_tpu.runtime import buggify as jbuggify
from foundationdb_tpu_torch.runtime import buggify
from tests.test_torch_recoverable import first_difference, fs_image, recording
from tests.torch_threads import one_torch_thread  # noqa: F401

MODULES = dict(
    core="runtime.core", coverage="runtime.coverage", buggify="runtime.buggify",
    combinators="runtime.combinators", network="rpc.network", stream="rpc.stream",
    types="roles.types", files="storage.files", recoverable="control.recoverable",
    coordination="control.coordination", election="control.election",
    mgmt="client.management", tuple_layer="client.tuple_layer",
    directory_layer="client.directory_layer", taskbucket="client.taskbucket",
    multiversion="client.multiversion", backup="client.backup", dr="client.dr",
    blobstore="storage.blobstore", image="storage.image", base="workloads.base",
    cycle="workloads.cycle", increment="workloads.increment", readwrite="workloads.readwrite",
    attrition="workloads.attrition", consistency="workloads.consistency",
    blob_backup="workloads.blob_backup", save_and_kill="workloads.save_and_kill")


def namespace(package: str, **extra) -> SimpleNamespace:
    return SimpleNamespace(**{k: importlib.import_module(f"{package}.{v}")
                              for k, v in MODULES.items()}, **extra)


PORT = namespace("foundationdb_tpu_torch", set_name="DeviceConflictSet",
                 cluster_kw=dict(device="cpu"))  # the default backend, on the CPU
REF = namespace("foundationdb_tpu", set_name="OracleConflictSet", cluster_kw={})


@pytest.fixture(autouse=True)
def _buggify_off():
    yield
    jbuggify.disable()
    buggify.disable()


def run_both(monkeypatch, scenario, **kw) -> dict:
    """`scenario(m, **kw)` once per package, each with its default set
    recorded into a verdict stream and its coverage census diffed around
    the run; the scenario's dict, the census and the stream must be
    equal.  The census leaves out the conflict set's own sites
    (`kernel.*`: the port's default is the device set, whose compactions
    count there, the reference's the oracle, which has none).  Returns the
    port's."""
    out = []
    for m in (PORT, REF):
        log = []
        gc.collect()
        gc.disable()
        try:
            before = dict(m.coverage.snapshot())
            with monkeypatch.context() as mp:
                recording(mp, m, log)
                result = scenario(m, **kw)
            after = m.coverage.snapshot()
        finally:
            gc.enable()
            jbuggify.disable()
            buggify.disable()
        result.update(verdicts=log, census={k: n - before.get(k, 0) for k, n in after.items()
                                            if n != before.get(k, 0) and
                                            not k.startswith("kernel.")})
        out.append(result)
    got, want = out
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], f"{key} differs at {first_difference(got[key], want[key])}"
    return got


def cluster(m, seed: int, **kw):
    return m.recoverable.RecoverableCluster(seed=seed, **kw, **m.cluster_kw)


def finish(c, result: dict) -> dict:
    """The scenario's result with the cluster's end virtual time and files."""
    result.update(end=c.loop.now(), files=fs_image(c.fs) if c.fs is not None else None)
    c.stop()
    return result


def err_name(e: BaseException) -> str:
    return type(e).__name__


# ---- tuple layer ------------------------------------------------------------

def random_tuples(seed: int, n: int) -> list:
    """Seeded tuples over every type the layer encodes: None, bytes (with
    0x00 and 0xff), str (non-ASCII too), ints of 0-8 bytes either sign,
    bools and nested tuples (with None inside)."""
    rng = np.random.default_rng(seed)
    alphabet = ["a", "z", "\x00", "é", "字", "\U0001f600"]

    def atom(depth: int):
        kind = int(rng.integers(0, 6 if depth < 2 else 5))
        if kind == 0:
            return None
        if kind == 1:
            return bytes(rng.choice([0, 1, 0x61, 0xfe, 0xff], size=int(rng.integers(0, 6))).tolist())
        if kind == 2:
            return "".join(rng.choice(alphabet, size=int(rng.integers(0, 5))).tolist())
        if kind == 3:
            size = int(rng.integers(0, 9))
            v = int(rng.integers(0, 1 << 62)) >> (62 - 7 * size) if size else 0
            return -v if rng.random() < 0.5 else v
        if kind == 4:
            return bool(rng.random() < 0.5)
        return tuple(atom(depth + 1) for _ in range(int(rng.integers(0, 4))))

    return [tuple(atom(0) for _ in range(int(rng.integers(0, 5)))) for _ in range(n)]


def tuple_scenario(m) -> dict:
    tl = m.tuple_layer
    tuples = random_tuples(11, 400) + [
        (), (None,), (b"ab", "cd", 0, 7, -7, (1, b"x"), None), (2**40, -(2**40)),
        (True, False), (2**64 - 1,), (-(2**64 - 1),), ((None, (None,)),)]
    packed = [tl.pack(t) for t in tuples]
    ints = [-(2**63), -300, -256, -255, -2, 0, 1, 255, 256, 70000, 2**63]
    sub = tl.Subspace(("app", 7), b"\x15")
    errors = []
    for bad in ((2**64,), (-(2**64),), (1.5,)):
        try:
            tl.pack(bad)
        except (ValueError, TypeError) as e:
            errors.append((err_name(e), str(e)))
    try:
        sub.unpack(b"elsewhere")
    except ValueError as e:
        errors.append((err_name(e), str(e)))
    return dict(
        packed=packed, unpacked=[tl.unpack(p) for p in packed],
        order=sorted(range(len(ints)), key=lambda i: tl.pack((ints[i],))),
        range_of=[tl.range_of(t) for t in tuples[:50]],
        subspace=(sub.key, sub.pack((1, "x")), sub.unpack(sub.pack((1, "x"))),
                  sub.range(("r",)), sub[b"k"].key, sub.subspace((2,)).pack((3,)),
                  sub.contains(sub.pack((9,))), sub.contains(b"\x00")),
        errors=errors)


def test_tuple_encodings_are_byte_identical(monkeypatch):
    got = run_both(monkeypatch, tuple_scenario)
    assert got["unpacked"][:400] == [_unbool(t) for t in random_tuples(11, 400)]
    assert got["order"] == list(range(11))  # tuple order is byte order
    assert len(got["errors"]) == 4


def _unbool(v):
    if isinstance(v, tuple):
        return tuple(_unbool(x) for x in v)
    return int(v) if isinstance(v, bool) else v


# ---- directory layer --------------------------------------------------------

def run_tr(c, fn):
    db = c.database()

    async def main():
        return await db.run(fn)

    return c.run_until(c.loop.spawn(main()), 120)


def directory_lifecycle(m) -> dict:
    c = cluster(m, 121)
    dl = m.directory_layer.DirectoryLayer()

    async def setup(tr):
        users = await dl.create_or_open(tr, ("app", "users"))
        events = await dl.create_or_open(tr, ("app", "events"))
        tr.set(users.pack((1, "name")), b"alice")
        tr.set(users.pack((2, "name")), b"bob")
        tr.set(events.pack((1,)), b"login")
        return users.key, events.key

    ukey, ekey = run_tr(c, setup)

    async def reopen(tr):
        users = await dl.open(tr, ("app", "users"))
        rows = await tr.get_range(*users.range())
        return (users.key, [users.unpack(k) for k, _ in rows], sorted(await dl.list(tr, ("app",))),
                await dl.list(tr, ()), await users.list(tr))

    reopened = run_tr(c, reopen)

    async def remove(tr):
        await dl.remove(tr, ("app", "users"))
        return (await dl.exists(tr, ("app", "users")), await dl.exists(tr, ("app", "events")),
                await tr.get_range(ukey, ukey + b"\xff"))

    removed = run_tr(c, remove)

    async def dup(tr):
        await dl.create(tr, ("dup",))
        try:
            await dl.create(tr, ("dup",))
        except KeyError as e:
            return err_name(e)

    async def missing(tr):
        try:
            await dl.open(tr, ("nowhere",))
        except KeyError as e:
            return err_name(e)

    return finish(c, dict(keys=(ukey, ekey), reopened=reopened, removed=removed,
                          dup=run_tr(c, dup), missing=run_tr(c, missing)))


def directory_move(m) -> dict:
    c = cluster(m, 122)
    dl = m.directory_layer.DirectoryLayer()

    async def setup(tr):
        d = await dl.create_or_open(tr, ("a", "b"))
        sub = await dl.create_or_open(tr, ("a", "b", "c"))
        tr.set(d.pack(("k",)), b"v")
        tr.set(sub.pack(("k2",)), b"v2")
        return d.key, sub.key

    keys = run_tr(c, setup)

    async def move(tr):
        return (await dl.move(tr, ("a", "b"), ("x",))).key

    moved = run_tr(c, move)

    async def check(tr):
        x = await dl.open(tr, ("x",))
        xc = await dl.open(tr, ("x", "c"))
        return (await dl.exists(tr, ("a", "b")), await tr.get(x.pack(("k",))),
                await tr.get(xc.pack(("k2",))))

    return finish(c, dict(keys=keys, moved=moved, check=run_tr(c, check)))


def directory_race(m) -> dict:
    """Four racing creates of one path: one allocation wins, the losers
    retry and open it."""
    c = cluster(m, 123)
    db = c.database()
    dl = m.directory_layer.DirectoryLayer()
    keys = []

    async def one():
        async def fn(tr):
            return (await dl.create_or_open(tr, ("contended",))).key

        keys.append(await db.run(fn))

    async def main():
        await m.combinators.wait_all([c.loop.spawn(one()) for _ in range(4)])

    c.run_until(c.loop.spawn(main()), 120)
    return finish(c, dict(keys=keys))


@pytest.mark.parametrize("scenario", [directory_lifecycle, directory_move, directory_race],
                         ids=["lifecycle", "move", "race"])
def test_directory_layer(monkeypatch, scenario):
    got = run_both(monkeypatch, scenario)
    assert any(e[0] == "batch" and e[3] for e in got["verdicts"]), "no resolver batch"
    if scenario is directory_lifecycle:
        assert got["keys"][0].startswith(b"\xfd") and got["keys"][0] != got["keys"][1]
        assert got["reopened"][1:4] == ([(1, "name"), (2, "name")], ["events", "users"], ["app"])
        assert got["removed"] == (False, True, []) and got["dup"] == got["missing"] == "KeyError"
    elif scenario is directory_move:
        assert got["moved"] == got["keys"][0] and got["check"] == (False, b"v", b"v2")
    else:
        assert len(got["keys"]) == 4 and len(set(got["keys"])) == 1


def test_directory_layer_refuses_a_plain_transaction():
    msgs = []
    for m in (PORT, REF):
        c = cluster(m, 125)
        tr = c.database().create_transaction()  # not read-your-writes
        with pytest.raises(TypeError, match="read-your-writes") as e:
            c.run_until(c.loop.spawn(
                m.directory_layer.DirectoryLayer().create_or_open(tr, ("x",))), 60)
        msgs.append(str(e.value))
        c.stop()
    assert msgs[0] == msgs[1]


# ---- task bucket ------------------------------------------------------------

def poll_empty(c, db, bucket, rounds: int = 600):
    async def poll():
        for _ in range(rounds):
            empty = [False]

            async def chk(tr, empty=empty):
                empty[0] = await bucket.is_empty(tr)

            await db.run(chk)
            if empty[0]:
                return True
            await c.loop.delay(0.1)
        return False

    return poll()


def taskbucket_competing(m) -> dict:
    c = cluster(m, 1001, n_storage_shards=1, storage_replication=2)
    db = c.database()
    bucket = m.taskbucket.TaskBucket()
    done = []

    async def handler(db_, task):
        done.append(task.params[b"payload"])

    async def main():
        async def add_all(tr):
            for i in range(12):
                bucket.add(tr, b"t%03d" % i, {b"__type__": b"work", b"payload": b"p%d" % i})

        await db.run(add_all)
        w1 = m.taskbucket.TaskBucketExecutor(db, bucket, {b"work": handler})
        w2 = m.taskbucket.TaskBucketExecutor(db, bucket, {b"work": handler})
        empty = await poll_empty(c, db, bucket)
        w1.stop()
        w2.stop()
        return empty, list(w1.executed), list(w2.executed)

    empty, e1, e2 = c.run_until(c.loop.spawn(main()), 900)
    return finish(c, dict(empty=empty, executed=(e1, e2), done=done))


def taskbucket_lease_expiry(m) -> dict:
    c = cluster(m, 1002, n_storage_shards=1, storage_replication=2)
    db = c.database()
    bucket = m.taskbucket.TaskBucket(lease_versions=500_000)
    done = []

    async def handler(db_, task):
        done.append((task.id, c.loop.now()))

    async def main():
        async def add(tr):
            bucket.add(tr, b"solo", {b"__type__": b"work"})

        await db.run(add)
        claimed = [None]

        async def grab(tr):
            claimed[0] = await bucket.claim_one(tr)

        await db.run(grab)  # the dying worker: claims and never finishes
        w = m.taskbucket.TaskBucketExecutor(db, bucket, {b"work": handler})
        for _ in range(600):
            if done:
                break
            await c.loop.delay(0.1)
        w.stop()
        return claimed[0].id, claimed[0].lease_end

    claimed = c.run_until(c.loop.spawn(main()), 900)
    return finish(c, dict(claimed=claimed, done=done))


def taskbucket_extend(m) -> dict:
    c = cluster(m, 1003, n_storage_shards=1, storage_replication=2)
    db = c.database()
    bucket = m.taskbucket.TaskBucket(lease_versions=400_000)

    async def main():
        async def add(tr):
            bucket.add(tr, b"long", {b"__type__": b"slow"})

        await db.run(add)
        claimed = [None]

        async def grab(tr):
            claimed[0] = await bucket.claim_one(tr)

        await db.run(grab)
        t = claimed[0]
        stolen = []
        for _ in range(4):
            await c.loop.delay(0.3)

            async def ext(tr):
                bucket.extend(tr, t, await tr.get_read_version() + 400_000)

            await db.run(ext)
            peek = [None]

            async def steal(tr):
                peek[0] = await bucket.claim_one(tr)

            await db.run(steal)
            stolen.append(peek[0])

        async def fin(tr):
            bucket.finish(tr, t)

        await db.run(fin)
        return stolen, await poll_empty(c, db, bucket, rounds=1), t.lease_end

    stolen, empty, lease_end = c.run_until(c.loop.spawn(main()), 900)
    return finish(c, dict(stolen=stolen, empty=empty, lease_end=lease_end))


@pytest.mark.parametrize("scenario", [taskbucket_competing, taskbucket_lease_expiry,
                                      taskbucket_extend],
                         ids=["competing", "lease-expiry", "extend"])
def test_taskbucket(monkeypatch, scenario):
    got = run_both(monkeypatch, scenario)
    if scenario is taskbucket_competing:
        e1, e2 = got["executed"]
        assert got["empty"] and set(got["done"]) == {b"p%d" % i for i in range(12)}
        assert len(e1) + len(e2) >= 12 and e1 and e2
    elif scenario is taskbucket_lease_expiry:
        assert got["claimed"][0] == b"solo" and [t for t, _ in got["done"]] == [b"solo"]
    else:
        assert got["stolen"] == [None] * 4 and got["empty"]


# ---- multi-version client ---------------------------------------------------

def multiversion_scenario(m) -> dict:
    mv_mod = m.multiversion

    class FakeClient:
        def __init__(self, version: int, cluster: dict) -> None:
            self.version, self.cluster, self.closed = version, cluster, False

        def op(self):
            if self.cluster["proto"] != self.version:
                raise mv_mod.ProtocolMismatch()
            return f"served-by-v{self.version}"

        def close(self):
            self.closed = True

    state = {"proto": 1}
    made, probes = [], []

    def factory(v):
        def make():
            made.append(FakeClient(v, state))
            return made[-1]

        return make

    def probe():
        probes.append(state["proto"])
        return state["proto"]

    mv = mv_mod.MultiVersionDatabase({1: factory(1), 2: factory(2)}, probe=probe)
    out = [mv.run(lambda db: db.op()), mv.active_version]
    state["proto"] = 2  # the cluster upgrades under the active client
    out += [mv.run(lambda db: db.op()), mv.active_version, [c.closed for c in made]]
    out.append(mv.probe_version())
    mv.close()
    out.append((mv.active_version, [c.closed for c in made]))
    unknown = mv_mod.MultiVersionDatabase({1: factory(1)}, probe=lambda: 9)
    try:
        unknown.run(lambda db: db.op())
    except mv_mod.NoMatchingClient as e:
        out.append((err_name(e), str(e), e.version))
    return dict(out=out, probes=probes)


def test_multiversion_selection_and_upgrade(monkeypatch):
    got = run_both(monkeypatch, multiversion_scenario)
    out = got["out"]
    assert out[:4] == ["served-by-v1", 1, "served-by-v2", 2] and out[4] == [True, False]
    assert out[-1][0] == "NoMatchingClient" and out[-1][2] == 9


# ---- leader election --------------------------------------------------------

def election_scenario(m, seed: int) -> dict:
    """Two candidates over three coordinators: one leader; its election
    loop stops, the lease runs out, and the other takes over.  Returns the
    leader/deposed events with their virtual times."""
    loop = m.core.EventLoop()
    net = m.network.SimNetwork(loop, m.core.DeterministicRandom(seed))
    coords = [m.coordination.Coordinator(net.create_process(f"coord-{i}"), loop)
              for i in range(3)]

    def cstate(owner):
        proc = net.create_process(f"client-{owner}")
        return m.coordination.CoordinatedState(
            loop, [m.stream.RequestStreamRef(net, proc, c.read_stream.endpoint) for c in coords],
            [m.stream.RequestStreamRef(net, proc, c.write_stream.endpoint) for c in coords],
            owner)

    rng = m.core.DeterministicRandom(seed)
    events = []
    electors = {}
    for name in ("A", "B"):
        electors[name] = e = m.election.LeaderElector(loop, cstate(name), rng, name,
                                                      f"ep-{name}", lease=1.0)
        e.start(lambda name=name: events.append((name, "leader", loop.now())),
                lambda name=name: events.append((name, "deposed", loop.now())))

    async def main():
        await loop.delay(3.0)
        first = [e for e in events if e[1] == "leader"]
        electors[first[0][0]].stop()  # the winner's loop dies: its lease runs out
        await loop.delay(4.0)
        leader = electors["B" if first[0][0] == "A" else "A"].current_leader
        return (leader.leader_id, leader.endpoint_info, leader.lease_expires)

    current = loop.run_until(loop.spawn(main()), 60)
    for e in electors.values():
        e.stop()
    return dict(events=events, current=current, end=loop.now(),
                leaders=[n for n, e in electors.items() if e.is_leader])


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_leader_election_sequence(monkeypatch, seed):
    got = run_both(monkeypatch, election_scenario, seed=seed)
    leaders = [e[0] for e in got["events"] if e[1] == "leader"]
    assert len(leaders) == 2 and leaders[0] != leaders[1], got["events"]
    assert got["current"][0] == leaders[1] and got["current"][1] == f"ep-{leaders[1]}"
