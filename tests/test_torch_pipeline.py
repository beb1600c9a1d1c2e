"""The port's split-phase pipeline (foundationdb_tpu_torch/conflict/
pipeline.py) on the CPU: resolve_deferred gives the oracle's and the
synchronous path's verdicts and state with handles waited out of order,
with GC and a compaction inside the window, and through a forced deferred
failure that recovers from its snapshot; PackArena packs byte-identical to
the reference's arena packer and to the loop packer; PipelinedPacker keeps
order, applies backpressure, re-raises and closes; BatchStager feeds
resolve_arrays(sync=False); and the reference Resolver(pipeline=True)
holding the port's best-known set replies oracle-exact verdicts."""

import random
import threading

import numpy as np
import pytest
import torch

from foundationdb_tpu.cluster import SimCluster
from foundationdb_tpu.conflict import device as jdev
from foundationdb_tpu.conflict import pipeline as jpipe
from foundationdb_tpu.conflict.api import TxInfo
from foundationdb_tpu.conflict.oracle import OracleConflictSet
from foundationdb_tpu.roles.resolver import Resolver
from foundationdb_tpu.roles.types import ResolveTransactionBatchRequest
from foundationdb_tpu.rpc.stream import RequestStreamRef
from foundationdb_tpu.runtime.combinators import wait_all
from foundationdb_tpu_torch.conflict import device as tdev
from foundationdb_tpu_torch.conflict import pipeline as tpipe
from foundationdb_tpu_torch.runtime import coverage
from tests.test_torch_device import _rand_range, _stream, assert_state_equal

BEST = dict(lsm=True, search_impl="bucket", device="cpu")
SMALL = dict(capacity=1 << 11, run_slots=2, run_capacity=64)


def _deep_bucket_stream(floor_at=2):
    """(version, txns, gc floor or None): 1100 point writes under one
    16-bit prefix, benign batches (one GC) until a compaction folds them
    into main, then a probe whose bucketed search cannot converge."""
    keys = [b"ZZ%04d" % i for i in range(1100)]
    out = [(10, [TxInfo(0, [], [(k, k + b"\x00")]) for k in keys], None)]
    v = 10
    for i in range(4):
        v += 10
        out.append((v, [TxInfo(v - 5, [(b"b%02d" % i, b"b%02d\x00" % i)],
                               [(b"c%02d" % i, b"c%02d\x00" % i)])],
                    5 if i == floor_at else None))  # keeps ZZ (version 10)
    v += 10
    probes = [(b"ZZ%04d" % i, b"ZZ%04d" % (i + 1)) for i in range(7, 1100, 50)]
    out.append((v, [TxInfo(v - 5, probes, [(b"q", b"q\x00")]),
                    TxInfo(v - 5, [(b"ZZ0001", b"ZZ0999")], [])], None))
    return out


def _sync_reference(stream):
    """Oracle verdicts, and the port's synchronous best-known set after the
    same stream."""
    oracle = OracleConflictSet()
    sync = tdev.DeviceConflictSet(**BEST, **SMALL)
    wants = []
    for version, txns, floor in stream:
        wants.append(oracle.resolve_batch(version, txns))
        assert sync.resolve_batch(version, txns) == wants[-1]
        if floor is not None:
            oracle.remove_before(floor)
            sync.remove_before(floor)
    return wants, sync


@pytest.mark.parametrize("seed", [1, 2])
def test_deferred_out_of_order_waits_match_oracle_and_sync(seed):
    """Every handle is waited in a shuffled order after the whole stream
    was dispatched (with GC between dispatches and compactions inside the
    window): verdicts and final state equal the synchronous set's."""
    stream = list(_stream(seed, 14))
    wants, sync = _sync_reference(stream)
    port = tdev.DeviceConflictSet(**BEST, **SMALL)
    handles = []
    for version, txns, floor in stream:
        handles.append(port.resolve_deferred(version, txns))
        if floor is not None:
            port.remove_before(floor)
    order = list(range(len(handles)))
    random.Random(seed).shuffle(order)
    for i in order:
        assert handles[i].wait() == wants[i], i
    port._drain_all()
    assert port.stats.compactions >= 3
    assert_state_equal(sync.export_state(), port.export_state(), "final")


def test_deferred_one_behind_with_gc_and_compaction_in_window():
    """Handles waited one behind, as a pipelined resolver does, with
    remove_before and compactions inside the open windows: verdicts match
    batch by batch and no deferred check fails."""
    stream = list(_stream(9, 16))
    wants, sync = _sync_reference(stream)
    port = tdev.DeviceConflictSet(**BEST, **SMALL)
    recovers = coverage.hits("kernel.pipeline_recover")
    handles = []
    for i, (version, txns, floor) in enumerate(stream):
        handles.append(port.resolve_deferred(version, txns))
        if i:
            assert handles[i - 1].wait() == wants[i - 1], i - 1
        if floor is not None:
            port.remove_before(floor)
    assert handles[-1].wait() == wants[-1]
    assert coverage.hits("kernel.pipeline_recover") == recovers
    assert port.search_fallbacks == 0 and port.stats.compactions >= 4
    assert_state_equal(sync.export_state(), port.export_state(), "final")


def _window_stream(runs_at_window: int):
    """(before, window): batches resolved synchronously (1100 point writes
    under one 16-bit prefix, then writes of m1 and c02, and with
    `runs_at_window` 2 one more run, so the window's first dispatch
    compacts), and a deferred window that appends, GCs, compacts and then
    probes the deep bucket, whose search cannot converge.  Each in-place
    write a window could make to the snapshot's tensors changes a replayed
    verdict or the final state.  The window's first batch reads c02 (lost
    if the compaction resets the snapshot's runs in place), reads a key
    its own run writes (a CONFLICT if its append went into the snapshot's
    runs) and reads m1 at a snapshot between its version and that version
    less the GC (a COMMITTED if the GC clamped the snapshot's table, and
    then its write of m9 lands in the replayed state)."""
    zz = [b"ZZ%04d" % i for i in range(1100)]
    before = [
        (10, [TxInfo(0, [], [(k, k + b"\x00")]) for k in zz], None),
        (20, [TxInfo(15, [], [(b"m1", b"m1\x00")])], None),
        (30, [TxInfo(25, [], [(b"c02", b"c02\x00")])], None),
        (35, [TxInfo(30, [], [(b"m3", b"m3\x00")])], None),
    ][: 2 + runs_at_window]
    probes = [(b"ZZ%04d" % i, b"ZZ%04d" % (i + 1)) for i in range(7, 1100, 50)]
    window = [
        (40, [TxInfo(25, [(b"c02", b"c02\x00")], []),
              TxInfo(35, [(b"k00", b"k00\x00")], [(b"k00", b"k00\x00")]),
              TxInfo(17, [(b"m1", b"m1\x00")], [(b"m9", b"m9\x00")])], 5),
        (50, [TxInfo(45, [(b"x", b"y")], [(b"k01", b"k01\x00")])], None),
        (60, [TxInfo(55, probes, [(b"q", b"q\x00")])], None),
    ]
    return before, window


@pytest.mark.parametrize("runs_at_window", [1, 2])
def test_deferred_failure_recovers_from_an_unaliased_snapshot(runs_at_window):
    """A probe of a deep bucket fails its deferred convergence check after
    a run append, a GC and a compaction inside the open window: recovery
    restores the pre-window snapshot and replays through the sync path.
    Verdicts stay oracle-exact and the final state equals the synchronous
    set's, which fails if any update inside the window wrote a tensor the
    snapshot holds (see _window_stream)."""
    before, window = _window_stream(runs_at_window)
    wants, sync = _sync_reference(before + window)
    assert [int(v) for v in wants[len(before)]] == [0, 2, 0]
    assert sync.search_fallbacks == 1
    port = tdev.DeviceConflictSet(**BEST, **SMALL)
    for version, txns, _floor in before:
        port.resolve_batch(version, txns)
    assert port._n_runs == runs_at_window
    recovers = coverage.hits("kernel.pipeline_recover")
    handles = []
    for i, (version, txns, floor) in enumerate(window):
        handles.append(port.resolve_deferred(version, txns))
        if i:
            handles[i - 1].wait()
        if floor is not None:
            port.remove_before(floor)
    # one compaction before the window, runs_at_window inside it
    assert port.stats.compactions == 1 + runs_at_window
    for h, want in zip(handles, wants[len(before):]):
        assert h.wait() == want
    assert coverage.hits("kernel.pipeline_recover") == recovers + 1
    assert port.search_fallbacks == 1  # the replay took the full depth
    assert port.stats.compactions == 1 + 2 * runs_at_window  # and replayed
    assert_state_equal(sync.export_state(), port.export_state(), "final")


def test_each_handle_keeps_its_own_ok_flag():
    """The folded flag is rebound per dispatch: a handle dispatched before
    the failing batch keeps True, the failing one and later ones False."""
    stream = _deep_bucket_stream()
    port = tdev.DeviceConflictSet(**BEST, **SMALL)
    for version, txns, floor in stream[:-1]:
        port.resolve_batch(version, txns)
        if floor is not None:
            port.remove_before(floor)
    v = stream[-1][0]
    ok_before = port._dev_ok
    good = port.resolve_deferred(v, [TxInfo(v - 5, [(b"b", b"c")], [])])
    bad = port.resolve_deferred(v + 1, stream[-1][1])
    assert bool(good.ok_dev) and not bool(bad.ok_dev)
    assert bool(ok_before) and good.ok_dev is not bad.ok_dev
    bad.wait()
    assert not port._inflight and bool(port._dev_ok)


def test_resolve_arrays_pipelined_check_raises_on_failure():
    """Without resolve_deferred's recovery, a non-converging sync=False
    batch makes check_pipelined raise, and the sync path falls back."""
    stream = _deep_bucket_stream()
    port = tdev.DeviceConflictSet(**BEST, **SMALL)
    for version, txns, floor in stream[:-1]:
        port.resolve_batch(version, txns)
        if floor is not None:
            port.remove_before(floor)
    version, txns, _ = stream[-1]
    packed = tdev.pack_batch(txns, port.oldest_version, port._offset, 32)
    port.resolve_arrays(version, *packed[:8], sync=False)
    with pytest.raises(RuntimeError, match="replay through sync=True"):
        port.check_pipelined()


def _pack_stream(seed, n_batches):
    rng = random.Random(seed)
    for i in range(n_batches):
        n = rng.choice([3, 30, 9, 1, 17])
        txns = []
        for _ in range(n):
            reads = [_rand_range(rng) for _ in range(rng.randrange(4))]
            if rng.random() < 0.3:
                reads.append((b"b", b"a"))  # inverted: dropped
            txns.append(TxInfo(rng.randrange(0, 12), reads,
                               [_rand_range(rng) for _ in range(rng.randrange(3))]))
        yield txns


@pytest.mark.parametrize("seed", range(2))
def test_pack_arena_byte_identical(seed):
    """pack_batch(arena=...) through the port's PackArena equals the
    reference's arena packer and the port's loop packer, all nine
    outputs, while the arena's slots are reused by shrinking and growing
    batches (so their stale pad regions must be re-sentinelled)."""
    j_arena, t_arena = jpipe.PackArena(depth=2), tpipe.PackArena(depth=2)

    def offset(v):
        return max(v - 2, 0)

    def offset_array(vs):
        return np.maximum(np.asarray(vs, np.int64) - 2, 0)

    for txns in _pack_stream(seed, 12):
        want = [np.array(a) for a in jdev.pack_batch(txns, 5, offset, 16,
                                                     arena=j_arena)]
        got = tdev.pack_batch(txns, 5, offset, 16, arena=t_arena,
                              offset_array=offset_array)
        loop = tdev.pack_batch_loop(txns, 5, offset, 16)
        for w, g, lo in zip(want, got, loop):
            assert np.array_equal(w, np.asarray(g))
            assert np.array_equal(w, np.asarray(lo))
            assert w.dtype == np.asarray(g).dtype
    assert t_arena._rows.keys() == j_arena._rows.keys()
    with pytest.raises(ValueError):
        tpipe.PackArena(depth=1)


def test_pipelined_packer_order_backpressure_errors_close():
    gate = threading.Event()

    def pack(item):
        if item == "boom":
            raise KeyError("bad batch")
        if item == "slow":
            gate.wait(5)
        return item * 2

    packer = tpipe.PipelinedPacker(pack, depth=2)
    for i in range(2):
        packer.submit(i)
    assert [packer.get(), packer.get()] == [0, 2]
    # backpressure: with `depth` batches unconsumed a third submit blocks
    packer.submit("slow")
    packer.submit(5)
    blocked = threading.Thread(target=packer.submit, args=(6,), daemon=True)
    blocked.start()
    blocked.join(0.3)
    assert blocked.is_alive()
    gate.set()
    assert packer.get() == "slowslow"
    blocked.join(5)
    assert not blocked.is_alive()
    assert [packer.get(), packer.get()] == [10, 12]
    packer.submit("boom")
    with pytest.raises(KeyError, match="bad batch"):
        packer.get()
    packer.close()
    assert not packer._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        packer.get()


def test_packer_with_stager_feeds_pipelined_resolves():
    """As bench.py's resolver-e2e stream: a PipelinedPacker packs into its
    own arena and stages through BatchStager (CPU here), the consumer
    dispatches resolve_arrays(sync=False) on the taken tensors, and one
    check_pipelined() ends the stream.  Verdicts equal the sync set's."""
    stream = [(v, t) for v, t, _f in _stream(21, 12)]
    sync = tdev.DeviceConflictSet(**BEST, **SMALL)
    wants = [sync.resolve_batch(v, t) for v, t in stream]
    port = tdev.DeviceConflictSet(**BEST, **SMALL)
    arena = tpipe.PackArena(depth=4)
    stager = tdev.BatchStager("cpu")
    packer = tpipe.PipelinedPacker(
        lambda item: tdev.pack_batch(
            item[1], port.oldest_version, port._offset, port._max_key_bytes,
            arena=arena, stats=port.stats, offset_array=port._offset_array,
        ),
        depth=2, stage=stager, stats=port.stats,
    )
    got, submitted = [], 0
    try:
        for i, (version, txns) in enumerate(stream):
            while submitted < len(stream) and submitted <= i + 1:
                packer.submit(stream[submitted])
                submitted += 1
            staged = packer.get()
            with pytest.raises(TypeError):
                tuple(staged)  # only take() hands the tensors out
            verdict = port.resolve_arrays(version, *staged.take(), sync=False)
            got.append(verdict)
    finally:
        packer.close()
    port.check_pipelined()
    for (v, t), want, verdict in zip(stream, wants, got):
        assert [int(c) for c in verdict[: len(t)]] == [int(w) for w in want]
    assert port.stats.h2d_s > 0 and port.stats.pack_s == 0
    assert port.stats.encode_s > 0  # pack_batch recorded its split
    assert_state_equal(sync.export_state(), port.export_state(), "final")


def test_staged_batch_equals_stage_batch():
    txns = next(_pack_stream(3, 1))
    packed = tdev.pack_batch(txns, 0, lambda v: v, 32)
    want = tdev.stage_batch(torch.device("cpu"), *packed[:8])
    got = tdev.BatchStager("cpu")(packed).take()
    assert len(got) == len(want) == 8
    for w, g in zip(want, got):
        assert torch.equal(w, g) and w.dtype == g.dtype
    foreign = tuple(t.to("meta") for t in got)
    port = tdev.DeviceConflictSet(**BEST, **SMALL)
    with pytest.raises(ValueError, match="staged batch"):
        port.resolve_arrays(1, *foreign)


def _mk_resolver(c, cs):
    p = c.net.create_process(f"resolver-torch-{id(cs) & 0xFFFF}")
    r = Resolver(p, c.loop, c.knobs, cs, pipeline=True)
    client = c.net.create_process(f"client-torch-{id(cs) & 0xFFFF}")
    return r, RequestStreamRef(c.net, client, r.stream.endpoint)


def _drive(c, ref, batches, deadline=120.0):
    """Send every batch at once, so successors queue behind the version
    chain and the split-phase path overlaps; replies in batch order."""

    async def one(prev, v, txns):
        return await ref.get_reply(ResolveTransactionBatchRequest(prev, v, txns))

    async def main():
        tasks = [c.loop.spawn(one(p, v, t)) for p, v, t in batches]
        return [r.committed for r in await wait_all(tasks)]

    return c.run_until(c.loop.spawn(main()), deadline)


@pytest.mark.parametrize("stream", ["random", "deep_bucket"])
def test_reference_pipelined_resolver_with_port_best_known_set(stream):
    """The reference Resolver(pipeline=True) in a SimCluster, holding the
    port's best-known set: replies equal the oracle's, also through a
    deferred failure that recovers (the deep-bucket stream)."""
    if stream == "random":
        batches = [(v, t) for v, t, _f in _stream(31, 14)]
    else:
        batches = [(v, t) for v, t, _f in _deep_bucket_stream()]
    oracle = OracleConflictSet()
    wants = [[int(x) for x in oracle.resolve_batch(v, t)] for v, t in batches]
    c = SimCluster(seed=41)
    cs = tdev.DeviceConflictSet(**BEST, **SMALL)
    r, ref = _mk_resolver(c, cs)
    recovers = coverage.hits("kernel.pipeline_recover")
    chained = [(p, v, t) for (p, _), (v, t) in zip([(0, None)] + batches, batches)]
    assert _drive(c, ref, chained) == wants
    if stream == "deep_bucket":
        assert coverage.hits("kernel.pipeline_recover") == recovers + 1
    assert cs.stats.runs_appended >= len(batches)
    r.stop()
    c.stop()
