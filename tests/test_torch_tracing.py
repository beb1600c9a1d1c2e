"""The port's conflict-set spans and counters (foundationdb_tpu_torch/
conflict/api.py::span, KernelStats.host_reads / host_wait_s /
compact_bytes) on the CPU set: under torch.profiler each resolve is a
`cs.resolve` holding its stage, search, check and append, and each
compaction a `cs.compact` holding K4's step, one fold a run and the index
rebuild; with no profiler no record_function is entered; verdicts and
state are bit-identical with the profiler on and off; the reads by site
sum to `host_syncs` on the synchronous path, the pipelined path and a
recovery; `compact_bytes` is its formula; and a pipelined batch is noted
once, when it is answered (on the flat layout near capacity too, and on
the sharded set), so the role's pipelined path reports true
transactions, aborts and resolve times."""

import random
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from foundationdb_tpu_torch.conflict import api
from foundationdb_tpu_torch.conflict import device as tdev
from foundationdb_tpu_torch.conflict.api import TxInfo, Verdict
from foundationdb_tpu_torch.conflict.pipeline import READ_SITES
from foundationdb_tpu_torch.control import status
from foundationdb_tpu_torch.parallel import sharded as tsh
from tests.test_torch_device import _stream, assert_state_equal
from tests.test_torch_pipeline import _window_stream
from tests.test_torch_resolver_role import PORT, drive, rand_batches, role, world

BEST = dict(lsm=True, search_impl="bucket", device="cpu")
SMALL = dict(capacity=1 << 11, run_slots=2, run_capacity=64)


def _cs_events(prof) -> list:
    """The profiler's `cs.*` records as (name, start, end), by start."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith("cs.")]
    return sorted(out, key=lambda x: (x[1], -x[2]))


def _inside(events, outer: str) -> list[list[str]]:
    """For each outermost `outer` record, the names of the records inside
    it, in order."""
    out, end = [], None
    for name, a, b in events:
        if end is not None and a < end:
            if name != outer or b > end:
                out[-1].append(name)
            continue
        if name == outer:
            out.append([])
            end = b
        else:
            end = None
    return out


def _run(stream, cs, deferred: bool = False):
    """The stream through `cs`, synchronously or with resolve_deferred
    (each batch drained after the next dispatch); the verdicts."""
    got, handles = [], []
    for version, txns, floor in stream:
        if deferred:
            handles.append(cs.resolve_deferred(version, txns))
            if len(handles) > 1:
                handles[-2].wait()
        else:
            got.append(cs.resolve_batch(version, txns))
        if floor is not None:
            cs.remove_before(floor)
    return got + [h.wait() for h in handles]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _cs_events(prof)


def test_each_resolve_is_a_span_holding_its_steps():
    cs = tdev.DeviceConflictSet(**BEST, capacity=1 << 11, run_slots=8, run_capacity=64)
    stream = [(v, [TxInfo(v - 1, [(b"r%d" % v, b"r%d\x00" % v)], [(b"w%d" % v, b"w%d\x00" % v)])],
               v - 3 if v > 3 else None) for v in range(1, 6)]
    _, events = _profiled(lambda: _run(stream, cs))
    per = _inside(events, "cs.resolve")
    assert len(per) == len(stream)
    for names in per:
        steps = [n for n in names if not n.startswith("cs.read.")]
        assert steps == ["cs.stage", "cs.search", "cs.check", "cs.append"], names
        assert names[-1] == "cs.read.verdicts"
    # the GC is a span of its own, outside the resolves
    assert sum(n == "cs.gc" for n, _a, _b in events) == 2


def test_a_compaction_is_a_span_holding_step_folds_and_index():
    cs = tdev.DeviceConflictSet(**BEST, **SMALL)
    stream = list(_stream(3, 12))
    _, events = _profiled(lambda: _run(stream, cs))
    comps = _inside(events, "cs.compact")
    assert len(comps) == cs.stats.compactions >= 3
    for names in comps:
        assert names[0] == "cs.compact.step" and names[-1] == "cs.compact.index"
        folds = [n for n in names if n == "cs.compact.fold"]
        assert len(folds) == SMALL["run_slots"]
        assert names.count("cs.read.fold_count") >= len(folds)
    # each compaction runs inside the resolve that found the runs full
    resolves = _inside(events, "cs.resolve")
    assert sum("cs.compact" in names for names in resolves) == len(comps)


def test_no_profiler_enters_no_record_function(monkeypatch):
    entered = []

    def record(*args, **kw):
        entered.append(args)
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", record)
    assert api.span("cs.resolve", 7) is api.span("cs.gc") is api._NO_SPAN
    cs = tdev.DeviceConflictSet(**BEST, **SMALL)
    _run(list(_stream(4, 10)), cs)
    _run(list(_stream(5, 10)), tdev.DeviceConflictSet(**BEST, **SMALL), deferred=True)
    assert entered == [] and cs.stats.compactions >= 2


@pytest.mark.parametrize("deferred", [False, True], ids=["sync", "pipelined"])
def test_verdicts_and_state_equal_with_the_profiler_on_and_off(deferred):
    stream = list(_stream(6, 16))
    plain = tdev.DeviceConflictSet(**BEST, **SMALL)
    traced = tdev.DeviceConflictSet(**BEST, **SMALL)
    want = _run(stream, plain, deferred)
    got, events = _profiled(lambda: _run(stream, traced, deferred))
    assert events and got == want
    assert_state_equal(plain.export_state(), traced.export_state(), "final")
    assert traced.host_syncs == plain.host_syncs
    assert traced.stats.host_reads == plain.stats.host_reads
    assert traced.stats.compact_bytes == plain.stats.compact_bytes > 0


def _assert_reads_sum(cs) -> dict:
    reads = cs.stats.host_reads
    assert set(reads) == set(READ_SITES)
    assert sum(reads.values()) == cs.host_syncs > 0
    assert cs.stats.host_wait_s > 0
    return reads


def test_reads_by_site_sum_to_host_syncs_sync_and_pipelined():
    stream = list(_stream(7, 16))
    sync = tdev.DeviceConflictSet(**BEST, **SMALL)
    _run(stream, sync)
    reads = _assert_reads_sum(sync)
    assert reads["verdicts"] == len(stream)
    assert reads["fold_count"] >= SMALL["run_slots"] * sync.stats.compactions
    assert reads["batch_flag"] == reads["window_flag"] == 0
    pipe = tdev.DeviceConflictSet(**BEST, **SMALL)
    _run(stream, pipe, deferred=True)
    reads = _assert_reads_sum(pipe)
    # the window's flag, read once 8 drained batches are replayable,
    # answers the batch still in flight without its own flag
    assert reads["verdicts"] == len(stream) > reads["batch_flag"]
    assert reads["batch_flag"] >= len(stream) - reads["window_flag"]
    assert reads["window_flag"] >= 1 and reads["search"] == 0
    sync.fixpoint_iterations()
    assert sync.stats.host_reads["fixpoint"] == 1
    assert sum(sync.stats.host_reads.values()) == sync.host_syncs
    snap = sync.kernel_stats()
    assert snap["host_reads"] == sync.stats.host_reads
    assert snap["host_wait_ms"] == sync.stats.host_wait_s * 1e3


def test_reads_by_site_sum_to_host_syncs_through_a_recovery():
    before, window = _window_stream(1)
    cs = tdev.DeviceConflictSet(**BEST, **SMALL)
    _run(before, cs)
    handles = []
    for i, (version, txns, floor) in enumerate(window):
        handles.append(cs.resolve_deferred(version, txns))
        if i:
            handles[i - 1].wait()
        if floor is not None:
            cs.remove_before(floor)
    [h.wait() for h in handles]
    assert cs.search_fallbacks == 1  # the replay took the full depth
    reads = _assert_reads_sum(cs)
    assert reads["search"] >= len(window) and reads["batch_flag"] >= 1


def test_compact_bytes_is_main_before_and_after_at_4w_plus_4():
    cs = tdev.DeviceConflictSet(**BEST, **SMALL)
    want = 0
    for version, txns, floor in _stream(8, 20):
        count, compactions = cs._count, cs.stats.compactions
        cs.resolve_batch(version, txns)
        if cs.stats.compactions > compactions:
            want += (count + cs._count) * (4 * cs._W + 4)
        if floor is not None:
            cs.remove_before(floor)
    assert cs.stats.compactions >= 3
    assert cs.stats.compact_bytes == want
    assert cs.kernel_stats()["compact_bytes"] == want


def test_a_pipelined_batch_is_noted_once_with_its_time_to_answer():
    cs = tdev.DeviceConflictSet(**BEST, **SMALL)
    txns = [TxInfo(0, [(b"a", b"b")], [(b"a", b"a\x00")]),
            TxInfo(0, [(b"a", b"a\x00")], [(b"c", b"c\x00")]),
            TxInfo(5, [], [(b"d", b"d\x00")])]
    cs.remove_before(3)  # the first two snapshots are TOO_OLD
    h = cs.resolve_deferred(10, txns)
    assert (cs.stats.batches, cs.stats.txns) == (1, 0)
    time.sleep(0.05)
    assert h.wait() == [Verdict.TOO_OLD, Verdict.TOO_OLD, Verdict.COMMITTED]
    h2 = cs.resolve_deferred(20, [TxInfo(15, [(b"d", b"e")], []),
                                  TxInfo(15, [], [(b"d", b"d\x00")])])
    assert h2.wait() == [Verdict.COMMITTED] * 2
    snap = cs.kernel_stats()
    assert (snap["batches"], snap["txns"], snap["aborted"]) == (2, 3, 0)
    assert snap["resolve_ms_p99"] >= 50  # dispatch to answer, not the enqueue


def _flat_stream(seed: int, n: int):
    """n chained batches of 1-5 one-key reads and writes over three
    partitions' first bytes, snapshots up to 4 versions back."""
    rng = random.Random(seed)

    def key():
        return bytes([rng.randrange(1, 4)]) + bytes(
            rng.choice(b"abcd") for _ in range(rng.randrange(4)))

    out = []
    for v in range(1, n + 1):
        txns = []
        for _ in range(rng.randrange(1, 6)):
            r, w = key(), key()
            txns.append(TxInfo(rng.randrange(max(v - 4, 0), v),
                               [(r, r + b"\x00")], [(w, w + b"\x00")]))
        out.append((v, txns))
    return out


FLAT = {
    "device": lambda: tdev.DeviceConflictSet(
        capacity=16, lsm=False, incremental=False, device="cpu"),
    "sharded": lambda: tsh.ShardedDeviceConflictSet(
        [b"\x02"], capacity=16, incremental=False, devices=["cpu"]),
}


@pytest.mark.parametrize("kind", sorted(FLAT))
def test_a_pipelined_batch_near_a_flat_sets_capacity_is_noted_once(kind):
    """On the legacy flat layout a pipelined dispatch that may outgrow main
    resolves synchronously inside resolve_arrays; that resolve notes no
    answer, so the drain notes each batch once."""
    cs = FLAT[kind]()
    noted = []
    inner = cs._resolve_arrays

    def spy(*args, **kw):
        noted.append(kw.get("note", True))
        return inner(*args, **kw)

    cs._resolve_arrays = spy
    stream = _flat_stream(3, 30)
    handles, codes = [], []
    for version, txns in stream:
        handles.append(cs.resolve_deferred(version, txns))
        if len(handles) > 1:
            codes += handles[-2].wait()
    codes += handles[-1].wait()
    assert noted.count(False) >= 5  # the synchronous path was taken
    snap = cs.kernel_stats()
    assert snap["batches"] == len(stream)
    assert snap["txns"] == sum(c != Verdict.TOO_OLD for c in codes)
    assert snap["aborted"] == sum(c == Verdict.CONFLICT for c in codes) > 0
    assert sum(cs.stats.host_reads.values()) == cs.host_syncs


def _role_kernel(make_set, pipeline: bool):
    """status.kernel of the port's resolver role over `make_set()`, driven
    by 24 random batches, checked against the replies."""
    loop, net, k = world(PORT, 12)
    cs = make_set()
    r, ref = role(PORT, loop, net, k, cs, pipeline)
    batches = rand_batches(PORT, 12, 24)
    replies = drive(PORT, loop, ref, batches)
    r.stop()
    codes = [c for committed, _t in replies for c in committed]
    kernel = status._kernel_rollup([r])
    assert kernel["batches"] == len(batches)
    assert kernel["txns"] == sum(c != int(Verdict.TOO_OLD) for c in codes)
    assert kernel["aborted"] == sum(c == int(Verdict.CONFLICT) for c in codes)
    assert 0 < kernel["abort_rate"] < 1
    assert 0 < kernel["resolve_ms_p50"] <= kernel["resolve_ms_p99"]
    assert sum(kernel["host_reads"].values()) == cs.host_syncs
    return kernel


def test_the_roles_pipelined_path_on_the_sharded_set_reports_true_counts():
    """As below, with the role over the port's sharded set (two partitions):
    synchronous batches are counted and answered, and pipelined ones are
    counted at dispatch and answered once."""
    def make():
        return tsh.ShardedDeviceConflictSet([b"c"], devices=["cpu"], capacity=1 << 6,
                                            run_slots=3, run_capacity=64)

    out = {pipeline: _role_kernel(make, pipeline) for pipeline in (False, True)}
    assert all(out[True][k] == out[False][k] for k in ("batches", "txns", "aborted"))
    assert out[True]["host_reads"]["batch_flag"] > 0
    status.validate_status({"kernel": out[True]}, {"kernel": status.STATUS_SCHEMA["kernel"]})


def test_the_roles_pipelined_path_reports_true_txns_aborts_and_times():
    """The port's resolver role with pipeline=True over the port's CPU set:
    status.kernel's txns and abort_rate are those of the replies, every
    batch counted once, and the resolve times are dispatch to answer;
    the synchronous role reports the same counts."""
    out = {pipeline: _role_kernel(PORT.make_set, pipeline) for pipeline in (False, True)}
    assert all(out[True][k] == out[False][k] for k in ("batches", "txns", "aborted"))
    assert out[True]["host_reads"]["batch_flag"] > 0
    status.validate_status({"kernel": out[True]}, {"kernel": status.STATUS_SCHEMA["kernel"]})
