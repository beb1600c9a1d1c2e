"""The port's commit-path roles (roles/proxy.py, roles/tlog.py,
roles/storage.py, with roles/sequencer.py and roles/resolver.py) wired by
hand as cluster.py wires them, against the reference's, on the same seed:
every commit reply (conflicts, an atomic add, a clear, versionstamped keys
and values, a malformed versionstamp), every GRV, TLog peek and storage
read reply (getvalue, getkeyvalues, getkey, a watch) and the virtual time
each arrives; the roles' counters and their *Metrics trace events (less
the host wall-ms fields, which differ by design); the TLog's durable log
(its reset and commit records, byte for byte), its spill (a tag nobody
pops, peeked back from the log) and its hard limit (pushes refused,
traced).  Each package's OracleConflictSet resolves."""

import dataclasses
import enum
from types import SimpleNamespace

import pytest

from foundationdb_tpu.conflict import oracle as joracle
from foundationdb_tpu.roles import proxy as jproxy
from foundationdb_tpu.roles import resolver as jresolver
from foundationdb_tpu.roles import sequencer as jsequencer
from foundationdb_tpu.roles import storage as jstorage
from foundationdb_tpu.roles import tlog as jtlog
from foundationdb_tpu.roles import types as jtypes
from foundationdb_tpu.rpc import network as jnetwork
from foundationdb_tpu.rpc import stream as jstream
from foundationdb_tpu.runtime import buggify as jbuggify
from foundationdb_tpu.runtime import combinators as jcombinators
from foundationdb_tpu.runtime import core as jcore
from foundationdb_tpu.runtime import knobs as jknobs
from foundationdb_tpu.runtime import serialize as jserialize
from foundationdb_tpu.runtime import trace as jtrace
from foundationdb_tpu_torch.conflict import oracle
from foundationdb_tpu_torch.roles import proxy, resolver, sequencer, storage, tlog, types
from foundationdb_tpu_torch.rpc import network, stream
from foundationdb_tpu_torch.runtime import buggify, combinators, core, knobs, trace

PORT = SimpleNamespace(
    core=core, network=network, stream=stream, types=types, knobs=knobs, trace=trace,
    combinators=combinators, resolver=resolver, sequencer=sequencer, tlog=tlog,
    storage=storage, proxy=proxy, oracle=oracle, buggify=buggify)
REF = SimpleNamespace(
    core=jcore, network=jnetwork, stream=jstream, types=jtypes, knobs=jknobs,
    trace=jtrace, combinators=jcombinators, resolver=jresolver, sequencer=jsequencer,
    tlog=jtlog, storage=jstorage, proxy=jproxy, oracle=joracle, buggify=jbuggify)

# host wall time inside the *Metrics events: differs run to run by design
WALL_FIELDS = ("KernelPackMsDelta", "KernelResolveMsDelta", "KernelMergeMsDelta")


@pytest.fixture(autouse=True)
def _buggify_off():
    for m in (PORT, REF):
        m.buggify.disable()
    yield


class MemQueue:
    """An in-memory disk queue with the interface the TLog uses (push,
    read_at, sync, rewrite, recover): records kept whole, offsets are
    byte positions of a length-prefixed log."""

    def __init__(self) -> None:
        self.log = bytearray()
        self.bytes_pushed = 0

    def push(self, payload: bytes) -> int:
        off = len(self.log)
        self.log += len(payload).to_bytes(4, "little") + payload
        self.bytes_pushed += len(payload)
        return off

    def read_at(self, off: int) -> bytes:
        n = int.from_bytes(self.log[off:off + 4], "little")
        return bytes(self.log[off + 4:off + 4 + n])

    async def sync(self) -> None:
        return None

    def rewrite(self, records) -> None:
        self.log = bytearray()
        self.bytes_pushed = 0
        for r in records:
            self.push(r)

    def recover(self) -> list:
        out, pos = [], 0
        while pos < len(self.log):
            out.append(self.read_at(pos))
            pos += 4 + len(out[-1])
        return out


def norm(x):
    """A value of either package as plain data: dataclasses and exceptions
    by class name, enums by name and value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            norm(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, x.value)
    if isinstance(x, BaseException):
        return ("raised", type(x).__name__, str(x))
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, dict):
        return {k: norm(v) for k, v in sorted(x.items())}
    return x


def vs_value(prefix: bytes, tail: bytes = b"") -> bytes:
    """A versionstamped operand: the 10-byte placeholder after `prefix`,
    its offset in the trailing 4 little-endian bytes."""
    return prefix + b"\x00" * 10 + tail + len(prefix).to_bytes(4, "little")


def commit_path_run(m, seed):
    """Sequencer, one resolver (the package's oracle), a TLog over a
    MemQueue with a small spill budget, one storage server pulling tag
    ss-0 and a commit proxy tagging keys >= b"y" to ss-1, which nobody
    pulls (so the TLog spills it); and a second TLog with a hard limit.
    Returns everything observable, as plain data."""
    T = m.types
    loop = m.core.EventLoop()
    rng = m.core.DeterministicRandom(seed)
    k = m.knobs.CoreKnobs()
    col = m.trace.TraceCollector(clock=loop.now, wall_clock=loop.now)
    m.trace.g_trace_batch.attach_clock(loop.now, col)
    net = m.network.SimNetwork(loop, rng, col)

    sent_types = set()
    send = net.send

    def typed_send(src, endpoint, payload):
        inner = getattr(payload, "payload", payload)
        sent_types.add((type(inner).__module__, type(inner).__name__))
        send(src, endpoint, payload)

    net.send = typed_send

    def ref(proc, endpoint):
        return m.stream.RequestStreamRef(net, proc, endpoint)

    seq = m.sequencer.Sequencer(net.create_process("sequencer"), loop, k)
    dq = MemQueue()
    log = m.tlog.TLog(net.create_process("tlog-0"), loop, disk_queue=dq,
                      spill_bytes=200, trace=col)
    res = m.resolver.Resolver(net.create_process("resolver-0"), loop, k,
                              m.oracle.OracleConflictSet())
    ssp = net.create_process("storage-0")
    ss = m.storage.StorageServer(
        ssp, loop, k, tlog_peek_ref=ref(ssp, log.peek_stream.endpoint),
        tlog_pop_ref=ref(ssp, log.pop_stream.endpoint), tag="ss-0",
        store=m.storage.MemoryKeyValueStore())
    pp = net.create_process("proxy")
    px = m.proxy.CommitProxy(
        pp, loop, k, sequencer_ref=ref(pp, seq.stream.endpoint),
        resolver_refs=[ref(pp, res.stream.endpoint)], resolver_splits=[],
        tlog_refs=[ref(pp, log.commit_stream.endpoint)],
        storage_tags=m.proxy.KeyPartitionMap([b"y"], [["ss-0"], ["ss-1"]]),
        tag_to_tlogs={"ss-0": [0], "ss-1": [0]})
    hard = m.tlog.TLog(net.create_process("tlog-hard"), loop, hard_limit_bytes=40,
                       trace=col)
    roles = (seq, px, res, log, ss)
    for r in roles:
        r.start_metrics(col, 0.05)
    cp = net.create_process("client")
    grv = ref(cp, px.grv_stream.endpoint)
    commit = ref(cp, px.commit_stream.endpoint)
    peek = ref(cp, log.peek_stream.endpoint)
    getvalue = ref(cp, ss.getvalue_stream.endpoint)
    getkv = ref(cp, ss.getkv_stream.endpoint)
    getkey = ref(cp, ss.getkey_stream.endpoint)
    watch = ref(cp, ss.watch_stream.endpoint)
    push_hard = ref(cp, hard.commit_stream.endpoint)
    seen = []

    async def call(r, req):
        try:
            out = await r.get_reply(req)
        except Exception as e:  # recorded: compared across packages
            out = e
        seen.append((norm(out), loop.now()))
        return out

    def setm(key, value):
        return T.Mutation(T.MutationType.SET_VALUE, key, value)

    async def main():
        v0 = (await call(grv, T.GetReadVersionRequest())).version
        first = [T.CommitTransactionRequest(v0, [], [(b"a%02d" % i, b"a%02d\x00" % i)],
                                            [setm(b"a%02d" % i, b"v%d" % i)])
                 for i in range(12)]
        first.append(T.CommitTransactionRequest(
            v0, [], [(b"n", b"n\x00")], [setm(b"n", (7).to_bytes(4, "little")),
                                          setm(b"zz%02d" % 1, b"x" * 60)]))
        await m.combinators.wait_all([loop.spawn(call(commit, r)) for r in first])
        v1 = (await call(grv, T.GetReadVersionRequest())).version
        # a read at v0 of a key written after it conflicts; the rest commit
        stamp_key = b"vs/" + b"\x00" * 10 + (3).to_bytes(4, "little")
        second = [
            T.CommitTransactionRequest(v0, [(b"a03", b"a03\x00")], [(b"b", b"b\x00")],
                                       [setm(b"b", b"late")]),
            T.CommitTransactionRequest(v1, [(b"a03", b"a03\x00")], [(b"b", b"b\x00")],
                                       [setm(b"b", b"ok")]),
            T.CommitTransactionRequest(v1, [], [(b"n", b"n\x00")], [T.Mutation(
                T.MutationType.ADD, b"n", (5).to_bytes(4, "little"))]),
            T.CommitTransactionRequest(v1, [], [(b"a05", b"a08")], [T.Mutation(
                T.MutationType.CLEAR_RANGE, b"a05", b"a08")]),
            T.CommitTransactionRequest(v1, [], [(b"vs/", b"vs0")], [
                T.Mutation(T.MutationType.SET_VERSIONSTAMPED_KEY, stamp_key, b"k"),
                T.Mutation(T.MutationType.SET_VERSIONSTAMPED_VALUE, b"vsval",
                           vs_value(b"pre", b"post"))]),
            T.CommitTransactionRequest(v1, [], [(b"bad", b"bad\x00")], [T.Mutation(
                T.MutationType.SET_VERSIONSTAMPED_VALUE, b"bad",
                b"short" + (9).to_bytes(4, "little"))]),
            T.CommitTransactionRequest(v1, [], [(b"zz", b"zz\x00")],
                                       [setm(b"zz%02d" % i, b"y" * 60) for i in range(2, 8)]),
        ]
        watcher = loop.spawn(call(watch, T.WatchValueRequest(b"b", None, v1)))
        await m.combinators.wait_all([loop.spawn(call(commit, r)) for r in second])
        await watcher
        await loop.delay(0.3)
        v2 = (await call(grv, T.GetReadVersionRequest())).version
        for key in (b"a01", b"a05", b"b", b"n", b"vsval", b"bad", b"nokey"):
            await call(getvalue, T.GetValueRequest(key, v2))
        await call(getvalue, T.GetValueRequest(b"a01", v0))  # before its write
        await call(getkv, T.GetKeyValuesRequest(b"a", b"y", v2))
        await call(getkv, T.GetKeyValuesRequest(b"a", b"y", v2, limit=3))
        await call(getkv, T.GetKeyValuesRequest(b"vs/", b"vs0", v2))
        for sel in (T.KeySelector.first_greater_or_equal(b"a05"),
                    T.KeySelector.last_less_than(b"a09"),
                    T.KeySelector.first_greater_than(b"a00") + 4,
                    T.KeySelector.last_less_or_equal(b"a") - 2):
            await call(getkey, T.GetKeyRequest(sel, v2, b"", b"y"))
        # tag ss-1 is never popped: its entries spilled and peek re-reads them
        await call(peek, T.TLogPeekRequest("ss-1", 0))
        await call(peek, T.TLogPeekRequest("ss-0", v1))
        # the hard-limited TLog acks its first push, then refuses
        prev = 0
        for v in (10, 20, 30):
            loop.spawn(call(push_hard, T.TLogCommitRequest(
                prev, v, {"t": [setm(b"h%d" % v, b"z" * 30)]})))
            prev = v
        await loop.delay(0.2)
        return True

    assert loop.run_until(loop.spawn(main()), deadline=60.0)
    counters = [r.counters.snapshot() for r in (px, res, log, ss)]
    events = sorted({e["Type"] for e in col.events})
    metrics = [{f: v for f, v in e.items() if f not in WALL_FIELDS}
               for e in col.events if e["Type"].endswith("Metrics")]
    out = dict(
        seen=seen, counters=counters, events=events, metrics=metrics,
        refused=col.find("TLogCommitRefused"), hard=(hard.commits_refused, hard.version.get()),
        spill=(log.spill_events, log.bytes_queued, norm(log._spilled)),
        dq=bytes(dq.log), recovered=norm(m.tlog.TLog.recover_state(dq)),
        storage=(ss.version.get(), ss.durable_version, norm(ss.store.range_read(
            b"", b"\xff", 1 << 20))), end=loop.now(),
        pickled=net.wire.snapshot()["pickle_fallbacks"])
    out["sent"] = sorted(sent_types)
    for r in (*roles, hard):
        r.stop()
    return out


def test_commit_path_replies_and_times_match_the_reference():
    got, want = commit_path_run(PORT, 5), commit_path_run(REF, 5)
    for key in want.keys() - {"sent"}:
        assert got[key] == want[key], key
    # every message on the port's network is one of the port's own types,
    # encoded by its own codecs (no pickle fallback)
    assert [n for _m, n in got["sent"]] == [n for _m, n in want["sent"]]
    assert got["pickled"] == 0 and all(
        mod.startswith("foundationdb_tpu_torch.") or mod == "builtins"
        for mod, _n in got["sent"]), got["sent"]
    assert {"CommitTransactionRequest", "GetReadVersionRequest", "TLogCommitRequest",
            "TLogPeekRequest", "GetValueRequest", "GetKeyValuesRequest",
            "GetKeyRequest", "WatchValueRequest", "ResolveTransactionBatchRequest",
            "GetCommitVersionRequest"} <= {n for _m, n in got["sent"]}
    results = [r[1][1] for r, _t in got["seen"]
               if isinstance(r, tuple) and r[0] == "CommitReply"]
    assert {"COMMITTED", "NOT_COMMITTED"} <= set(results), results
    assert got["spill"][0] > 0 and len(got["refused"]) == 1 and got["hard"] == (1, 20)
    assert {"ProxyMetrics", "TLogMetrics", "ResolverMetrics"} <= {
        e["Type"] for e in got["metrics"]}, got["events"]


def test_reset_codecs_match_the_reference():
    """The TLog's reset records (the current struct-of-arrays framing and
    the legacy per-mutation one) encode to the reference's bytes and
    decode back in both packages."""
    def tags(T):
        return {"ss-0": [(3, [T.Mutation(T.MutationType.SET_VALUE, b"k", b"v")]),
                         (5, [T.Mutation(T.MutationType.CLEAR_RANGE, b"a", b"c"),
                              T.Mutation(T.MutationType.ADD, b"n", b"\x01")])],
                "ss-1": [], "x": [(9, [])]}

    mine = tlog._encode_reset(7, 4, tags(types))
    assert mine == jtlog._encode_reset(7, 4, tags(jtypes))
    for mod, data in ((tlog, mine), (jtlog, mine)):
        r = mod.BinaryReader(data)
        assert r.u8() == mod._R_RESET2
        start, kc, back = mod._decode_reset2(r)
        assert (start, kc) == (7, 4) and norm(back) == norm(tags(jtypes))
    w = jtlog.BinaryWriter().u8(jtlog._R_RESET).i64(7).i64(4).u32(1).str_("ss-0").u32(1)
    w.i64(3).u32(1)
    jserialize.write_mutation(w, jtypes.Mutation(jtypes.MutationType.SET_VALUE, b"k", b"v"))
    legacy = w.data()
    for mod in (tlog, jtlog):
        r = mod.BinaryReader(legacy)
        assert r.u8() == mod._R_RESET
        assert norm(mod._decode_reset_legacy(r)) == [7, 4, {"ss-0": [
            [3, [("Mutation", ("MutationType", "SET_VALUE", 0), b"k", b"v")]]]}]
