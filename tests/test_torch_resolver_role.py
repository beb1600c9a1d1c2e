"""The port's resolver role (foundationdb_tpu_torch/roles/resolver.py, on the
port's event loop, SimNetwork and request streams) against the reference
Resolver, each hosting its own package's DeviceConflictSet (the port's on
"cpu", the reference's on JAX-CPU): on seeded version-chained streams sent
all in flight at once, sync and pipelined, the replies and the virtual
time each arrives are identical, and so are the role's counters, latency
snapshot, version and MVCC floor.  Also covered, each against the
reference: a retry of a batch whose verdicts are still deferred, the
abort-all answer to a retry whose cached reply was evicted, the moved-in
guard, the ResolutionMetrics/ResolutionSplit replies, the ResolverMetrics
events (without the wall-ms deltas and KernelBackend, which differ by
design), a role started from state carried over from the reference, and
the Sequencer's version chain."""

import random
from types import SimpleNamespace

import numpy as np
import pytest

from foundationdb_tpu.conflict import api as japi
from foundationdb_tpu.conflict import device as jdevice
from foundationdb_tpu.roles import resolver as jresolver
from foundationdb_tpu.roles import sequencer as jsequencer
from foundationdb_tpu.roles import types as jtypes
from foundationdb_tpu.rpc import network as jnetwork
from foundationdb_tpu.rpc import stream as jstream
from foundationdb_tpu.runtime import buggify as jbuggify
from foundationdb_tpu.runtime import combinators as jcombinators
from foundationdb_tpu.runtime import core as jcore
from foundationdb_tpu.runtime import knobs as jknobs
from foundationdb_tpu.runtime import trace as jtrace
from foundationdb_tpu_torch.conflict import api, device
from foundationdb_tpu_torch.roles import resolver, sequencer, types
from foundationdb_tpu_torch.rpc import network, stream
from foundationdb_tpu_torch.runtime import (
    buggify, combinators, core, knobs, trace)

SMALL = dict(capacity=1 << 6, run_slots=3, run_capacity=64)
WINDOW = 4  # versions: VERSIONS_PER_SECOND=1, MAX_WRITE_TRANSACTION_LIFE=4

PORT = SimpleNamespace(
    core=core, network=network, stream=stream, types=types, knobs=knobs,
    combinators=combinators, resolver=resolver, sequencer=sequencer, api=api,
    trace=trace, buggify=buggify,
    make_set=lambda **kw: device.DeviceConflictSet(**{**SMALL, **kw}, device="cpu"))
REF = SimpleNamespace(
    core=jcore, network=jnetwork, stream=jstream, types=jtypes, knobs=jknobs,
    combinators=jcombinators, resolver=jresolver, sequencer=jsequencer, api=japi,
    trace=jtrace, buggify=jbuggify,
    make_set=lambda **kw: jdevice.DeviceConflictSet(**{**SMALL, **kw}))


@pytest.fixture(autouse=True)
def _buggify_off():
    for m in (PORT, REF):
        m.buggify.disable()
    yield
    for m in (PORT, REF):
        m.buggify.disable()


def rand_batches(m, seed: int, n_batches: int):
    """(prev_version, version, [TxInfo]) chained batches over short keys
    from a 5-letter alphabet, snapshots up to 6 versions back: the
    reference's resolver-pipeline stream."""
    rng = random.Random(seed)

    def rkey():
        return bytes(rng.choice(b"abcde") for _ in range(rng.randrange(6)))

    def rrange():
        a, b = sorted((rkey(), rkey()))
        return a, b + b"\x00"

    out, version = [], 0
    for _ in range(n_batches):
        prev = version
        version += rng.randrange(1, 5)
        txns = [m.api.TxInfo(rng.randrange(max(version - 6, 0), version),
                             [rrange() for _ in range(rng.randrange(3))],
                             [rrange() for _ in range(rng.randrange(3))])
                for _ in range(rng.randrange(1, 6))]
        out.append((prev, version, txns))
    return out


def world(m, seed):
    loop = m.core.EventLoop()
    net = m.network.SimNetwork(loop, m.core.DeterministicRandom(seed))
    k = m.knobs.CoreKnobs()
    k.set_knob("VERSIONS_PER_SECOND", "1")
    k.set_knob("MAX_WRITE_TRANSACTION_LIFE", str(WINDOW))
    return loop, net, k


def role(m, loop, net, k, cs, pipeline, start_version=0):
    r = m.resolver.Resolver(net.create_process("resolver"), loop, k, cs,
                            start_version=start_version, pipeline=pipeline)
    ref = m.stream.RequestStreamRef(net, net.create_process("proxy"), r.stream.endpoint)
    return r, ref


def drive(m, loop, ref, batches):
    """Every batch in flight at once; returns (committed, virtual reply
    time) per batch, in batch order."""
    async def one(prev, version, txns):
        rep = await ref.get_reply(m.types.ResolveTransactionBatchRequest(prev, version, txns))
        return rep.committed, loop.now()

    async def main():
        return await m.combinators.wait_all([loop.spawn(one(*b)) for b in batches])

    return loop.run_until(loop.spawn(main()), deadline=1e6)


def role_run(m, seed, pipeline, n=24, **set_kw):
    loop, net, k = world(m, seed)
    cs = m.make_set(**set_kw)
    r, ref = role(m, loop, net, k, cs, pipeline)
    got = drive(m, loop, ref, rand_batches(m, seed, n))
    out = dict(replies=got, counters=r.counters.snapshot(),
               latency=r.latency.snapshot(), version=r.version.get(),
               oldest=cs.oldest_version, cache=sorted(r._reply_cache),
               load=r._load_ranges, samples=list(r._samples),
               sent=net.messages_sent, now=loop.now())
    r.stop()
    return out


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_role_replies_match_the_reference(seed, pipeline):
    got = role_run(PORT, seed, pipeline)
    want = role_run(REF, seed, pipeline)
    assert got == want
    codes = {c for committed, _t in got["replies"] for c in committed}
    assert codes == {0, 1, 2}  # conflicts, TOO_OLD past the window, commits
    assert got["oldest"] > 0


@pytest.mark.parametrize("seed", [11, 14])
def test_sync_and_pipelined_roles_agree(seed):
    sync = role_run(PORT, seed, False)
    pipe = role_run(PORT, seed, True)
    assert [c for c, _t in sync["replies"]] == [c for c, _t in pipe["replies"]]
    assert sync["counters"] == pipe["counters"] and sync["oldest"] == pipe["oldest"]


def test_best_known_layout_role_matches_the_reference():
    got = role_run(PORT, 21, True, n=16, lsm=True, search_impl="bucket")
    want = role_run(REF, 21, True, n=16, lsm=True, search_impl="bucket",
                    incremental=True)
    assert got == want


def _deferred_retry(m, monkeypatch):
    """A retry of a batch parked deferred must flush it and get the real
    verdicts (the reference's test_retry_of_deferred_batch_gets_real_verdicts
    shape, run on a bare loop and network)."""
    monkeypatch.setattr(m.resolver, "_PIPELINE_FLUSH_S", 0.05)
    loop, net, k = world(m, 5)
    r, ref = role(m, loop, net, k, m.make_set(), True)
    TxInfo, Req = m.api.TxInfo, m.types.ResolveTransactionBatchRequest
    txa = [TxInfo(0, [], [(b"a", b"b")])]
    txb = [TxInfo(17, [(b"a", b"a\x00")], []), TxInfo(17, [], [(b"q", b"r")])]
    flushed = []
    orig = m.resolver.Resolver._flush_pending

    def recording(self):
        flushed.append(self._pending is not None)
        return orig(self)

    monkeypatch.setattr(m.resolver.Resolver, "_flush_pending", recording)

    async def call(req):
        rep = await ref.get_reply(req)
        return rep.committed, loop.now()

    async def main():
        ra = await call(Req(0, 10, txa))
        tb = loop.spawn(call(Req(10, 20, txb)))
        tb2 = loop.spawn(call(Req(10, 20, txb)))
        return [ra] + await m.combinators.wait_all([tb, tb2])

    out = loop.run_until(loop.spawn(main()), deadline=60.0)
    r.stop()
    return out, any(flushed)


def test_retry_of_a_deferred_batch_matches_the_reference(monkeypatch):
    got = _deferred_retry(PORT, monkeypatch)
    want = _deferred_retry(REF, monkeypatch)
    assert got == want
    (a, _), (b, _), (b_retry, _) = got[0]
    assert b == b_retry and 2 in b and got[1]


def _evicted_retry(m, pipeline):
    """Past the MVCC window a batch's cached reply is evicted: its retry is
    answered with abort-all; a retry still inside the window gets the
    cached verdicts."""
    loop, net, k = world(m, 8)
    r, ref = role(m, loop, net, k, m.make_set(), pipeline)
    batches = rand_batches(m, 8, 20)
    first = drive(m, loop, ref, batches)
    old_prev, old_v, old_txns = batches[1]
    new_prev, new_v, new_txns = batches[-1]
    again = drive(m, loop, ref, [(old_prev, old_v, old_txns), (new_prev, new_v, new_txns)])
    r.stop()
    return first, again, old_v in r._reply_cache


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_evicted_cache_retry_aborts_all_as_the_reference(pipeline):
    got = _evicted_retry(PORT, pipeline)
    want = _evicted_retry(REF, pipeline)
    assert got == want
    first, again, cached = got
    assert not cached
    assert again[0][0] == [0] * len(first[1][0])
    assert again[1][0] == first[-1][0]


def _moved_in(m, pipeline):
    loop, net, k = world(m, 3)
    r, ref = role(m, loop, net, k, m.make_set(), pipeline)
    TxInfo = m.api.TxInfo
    r.install_moved_range(b"c", b"e", 5)
    r.install_moved_range(b"x", None, 7)
    batches = [
        (0, 4, [TxInfo(0, [], [(b"a", b"b")])]),
        (4, 6, [TxInfo(3, [(b"d", b"d\x00")], []),      # below 5 in [c, e): guarded
                TxInfo(5, [(b"d", b"d\x00")], []),      # at the floor: passes
                TxInfo(4, [(b"a", b"a\x00")], []),      # outside: passes
                TxInfo(4, [(b"z", b"z\x00")], [])]),    # in [x, end): guarded
        (6, 20, [TxInfo(7, [(b"z", b"z\x00")], [])]),   # at the floor; then 16 > 7: expired
    ]
    out = drive(m, loop, ref, batches)
    left = list(r._moved_in)
    r.stop()
    return out, left


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_moved_in_guard_matches_the_reference(pipeline):
    got = _moved_in(PORT, pipeline)
    assert got == _moved_in(REF, pipeline)
    (_a, (b, _tb), (c, _tc)), left = got
    assert b == [0, 2, 2, 0] and c == [2] and left == []


def _balancing(m, seed):
    loop, net, k = world(m, seed)
    r, ref = role(m, loop, net, k, m.make_set(), False)
    drive(m, loop, ref, rand_batches(m, seed, 30))
    mref = m.stream.RequestStreamRef(net, net.create_process("controller"),
                                     r.metrics_stream.endpoint)

    async def ask():
        load = await mref.get_reply(m.types.ResolutionMetricsRequest())
        load2 = await mref.get_reply(m.types.ResolutionMetricsRequest())
        split = await mref.get_reply(m.types.ResolutionSplitRequest())
        split2 = await mref.get_reply(m.types.ResolutionSplitRequest())
        return load.load, load2.load, split.key, split2.key, loop.now()

    out = loop.run_until(loop.spawn(ask()), deadline=1e6)
    r.stop()
    return out


@pytest.mark.parametrize("seed", [2, 9])
def test_resolution_metrics_and_split_replies_match_the_reference(seed):
    got = _balancing(PORT, seed)
    assert got == _balancing(REF, seed)
    load, load2, key, key2, _t = got
    assert load > 0 and load2 == 0 and key is not None and key2 is None


# the fields that differ by design: host wall-ms deltas, and the backend's
# name ("cpu"/"cuda" against "device", ROADMAP C.2)
WALL_FIELDS = ("KernelBackend", "KernelPackMsDelta", "KernelResolveMsDelta",
               "KernelMergeMsDelta")


def _metrics_events(m, seed, pipeline):
    loop, net, k = world(m, seed)
    r, ref = role(m, loop, net, k, m.make_set(), pipeline)
    col = m.trace.TraceCollector(clock=loop.now)
    r.start_metrics(col, 0.002)
    drive(m, loop, ref, rand_batches(m, seed, 20))
    loop.run_until(loop.delay(0.01))
    r.stop()
    events = col.find("ResolverMetrics")
    return [{k: v for k, v in e.items() if k not in WALL_FIELDS} for e in events], \
        {e["KernelBackend"] for e in events}


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_resolver_metrics_events_match_the_reference(pipeline):
    got, backends = _metrics_events(PORT, 4, pipeline)
    want, jbackends = _metrics_events(REF, 4, pipeline)
    assert got == want and len(got) >= 3
    assert sum(e["KernelBatchesDelta"] for e in got) == 20
    assert backends == {"cpu"} and jbackends == {"device"}


def _jax_state(d) -> dict:
    """The reference set's state in the port's export_state() layout (the
    default flat incremental layout)."""
    return dict(
        ks=np.asarray(d._ks), vs=np.asarray(d._vs), bidx=np.asarray(d._bidx),
        count=int(d._dev_count) if d._count is None else d._count,
        cap=d._cap, base=d._base, oldest=d._oldest, last_commit=d._last_commit,
        merge_impl=d._merge_impl, runs_b=np.asarray(d._runs_b),
        runs_e=np.asarray(d._runs_e), runs_ver=np.asarray(d._runs_ver),
        n_runs=d._n_runs, run_cap=d._run_cap, K=d._K, run_rows_ub=d._run_rows_ub)


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_role_started_from_reference_state_replies_as_the_reference(pipeline):
    """The reference's set runs the first half of a stream; its state loads
    into the port's set, and a port role and a reference role, each started
    at the last version over its set, reply the same to the second half."""
    seed = 31
    jbatches = rand_batches(REF, seed, 30)
    carried = REF.make_set()
    for _prev, version, txns in jbatches[:15]:
        carried.resolve_batch(version, txns)
        if version > WINDOW:
            carried.remove_before(version - WINDOW)
    start = jbatches[14][1]
    port_set = PORT.make_set()
    port_set.load_state(_jax_state(carried))
    out = []
    for m, cs in ((PORT, port_set), (REF, carried)):
        loop, net, k = world(m, seed)
        r, ref = role(m, loop, net, k, cs, pipeline, start_version=start)
        out.append(drive(m, loop, ref, rand_batches(m, seed, 30)[15:]))
        r.stop()
    assert out[0] == out[1]
    assert any(0 in c for c, _t in out[0])


def _sequencer_chain(m, seed):
    loop, net, k = world(m, seed)
    seq = m.sequencer.Sequencer(net.create_process("master"), loop, k, start_version=100)
    ref = m.stream.RequestStreamRef(net, net.create_process("proxy"), seq.stream.endpoint)
    Req = m.types.GetCommitVersionRequest

    async def main():
        out = []
        for i in range(6):
            await loop.delay(0.5 * i)
            rep = await ref.get_reply(Req("p1", i, committed_version=100 + i))
            out.append((rep.prev_version, rep.version, loop.now()))
        dup = await ref.get_reply(Req("p1", 3))  # a retry: the same versions
        out.append((dup.prev_version, dup.version))
        nv = m.sequencer.NotifiedVersion(5)
        waits = [nv.when_at_least(v) for v in (9, 6, 5)]
        nv.set(7)
        out.append([w.done() for w in waits])
        return out

    got = loop.run_until(loop.spawn(main()), deadline=1e6)
    seq.stop()
    return got, seq.counters.snapshot()


def test_sequencer_chain_matches_the_reference():
    got = _sequencer_chain(PORT, 6)
    assert got == _sequencer_chain(REF, 6)
    chain = got[0][:6]
    assert all(a[1] == b[0] for a, b in zip(chain, chain[1:]))
    assert got[0][6] == chain[3][:2] and got[0][7] == [False, True, True]
