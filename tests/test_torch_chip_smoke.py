"""chip_smoke.py's work counts, on the CPU at small sizes: the replays that
count the bytes and operations each kernel's inputs need must compute the
kernel's own function (they are held against the plain torch versions
here, and against the kernels on the card), and must count only what the
data makes the kernel read."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from foundationdb_tpu_torch import keys
from foundationdb_tpu_torch.conflict import device as tdev
from foundationdb_tpu_torch.conflict import kernels
from foundationdb_tpu_torch.ops import rmq
from foundationdb_tpu_torch.ops.search import lower_bound
from tests.torch_threads import one_torch_thread  # noqa: F401

W = 5
SENT = 0xFFFFFFFF


def _rows(rng, n, hi=1 << 10):
    """n sorted distinct key rows (uint32 layout), sentinel-padded."""
    words = rng.integers(0, hi, size=(n, W - 1)).astype(np.uint32)
    live = np.unique(np.concatenate([words, np.full((n, 1), 16, np.uint32)], 1), axis=0)
    return np.concatenate([live, np.full((n - len(live), W), SENT, np.uint32)])


def _run(rng, run_cap, n_live):
    """A sorted disjoint run of n_live intervals, sentinel-padded."""
    live = _rows(rng, 2 * n_live)
    live = live[live[:, -1] != SENT]
    m = len(live) // 2
    b = np.full((run_cap, W), SENT, np.uint32)
    e = b.copy()
    b[:m], e[:m] = live[0:2 * m:2], live[1:2 * m:2]
    return b, e


def _probe_inputs(seed, K=4, run_cap=64, R=200):
    rng = np.random.default_rng(seed)
    runs = [_run(rng, run_cap, n) for n in (40, 30, 0, 25)[:K]]
    runs_b = keys.to_lanes(np.stack([r[0] for r in runs]))
    runs_e = keys.to_lanes(np.stack([r[1] for r in runs]))
    runs_ver = torch.tensor([0, 4, 7, 9][:K], dtype=torch.int32)
    q = _rows(rng, 2 * R)[rng.permutation(2 * R)]
    rb = keys.to_lanes(np.minimum(q[:R], q[R:]))
    re_ = keys.to_lanes(np.maximum(q[:R], q[R:]))
    snap = torch.from_numpy(rng.integers(0, 12, R).astype(np.int32))
    r_ok = torch.from_numpy(rng.random(R) < 0.85)
    hist = torch.from_numpy(rng.random(R) < 0.1) & r_ok
    return rb, re_, snap, r_ok, runs_b, runs_e, runs_ver, hist


@pytest.mark.parametrize("seed", range(3))
def test_trace_search_is_lower_bound(seed):
    rng = np.random.default_rng(seed)
    table = keys.to_lanes(_rows(rng, 300))
    qq = keys.to_lanes(_rows(rng, 120)[rng.permutation(120)])
    qid = torch.arange(120) + 7
    rank, t_el, q_el, steps, lanes = chip_smoke.trace_search(torch, table, qq, qid)
    assert torch.equal(rank.to(torch.int32), lower_bound(table, qq))
    # every step reads lane 0 of one table row and of its query
    assert steps >= 120 * 8 and lanes >= steps
    # one inclusive lane range a compare, in the table and in the queries
    assert len(t_el) == len(q_el) == steps
    assert int((t_el[:, 1] - t_el[:, 0] + 1).sum()) == lanes
    assert torch.equal(t_el[:, 1] - t_el[:, 0], q_el[:, 1] - q_el[:, 0])
    assert int(t_el.max()) < table.numel() and int(q_el.min()) >= 7 * W


@pytest.mark.parametrize("seed", range(3))
def test_probe_fused_work_replays_the_kernel(seed):
    args = _probe_inputs(seed)
    n_bytes, n_ops, out = chip_smoke.probe_fused_work(torch, *args)
    assert torch.equal(out, kernels.probe_fused_plain(*args))
    full = sum(a.numel() * a.element_size() for a in args) + args[0].shape[0]
    assert 0 < n_bytes < full and n_ops > 0


def test_probe_fused_work_skips_runs_no_read_probes():
    rb, re_, snap, r_ok, runs_b, runs_e, runs_ver, hist = _probe_inputs(5)
    base = chip_smoke.probe_fused_work(torch, rb, re_, snap, r_ok, runs_b, runs_e,
                                       runs_ver, hist)
    # a run no snapshot is below (as version 0 is) adds nothing
    extra_b = torch.cat([runs_b, runs_b[:1]])
    extra_e = torch.cat([runs_e, runs_e[:1]])
    extra_ver = torch.cat([runs_ver, torch.zeros(1, dtype=torch.int32)])
    more = chip_smoke.probe_fused_work(torch, rb, re_, snap, r_ok, extra_b, extra_e,
                                       extra_ver, hist)
    assert more[:2] == base[:2]
    # no live read: only the flags are read and the output written
    none = chip_smoke.probe_fused_work(torch, rb, re_, snap, torch.zeros_like(r_ok),
                                       runs_b, runs_e, runs_ver, torch.zeros_like(hist))
    R = rb.shape[0]
    assert none[0] == 2 * R + chip_smoke.SECTOR + chip_smoke.SECTOR * -(-R // chip_smoke.SECTOR)
    assert none[1] == 0


@pytest.mark.parametrize("seed", range(3))
def test_probe_work_without_history_replays_k5(seed):
    """K5's replay (no history input) computes run_conflicts and counts
    what K1's counts with no history bit set, less the R bytes of the
    history bits K5 does not read."""
    args = _probe_inputs(seed)
    rb, r_ok = args[0], args[3]
    n_bytes, n_ops, out = chip_smoke.probe_fused_work(torch, *args[:7])
    assert torch.equal(out, kernels.run_conflicts_plain(*args[:7]))
    k1 = chip_smoke.probe_fused_work(torch, *args[:7], torch.zeros_like(r_ok))
    assert (n_bytes, n_ops) == (k1[0] - rb.shape[0], k1[1])


def test_kernel_symbols_match_profiler_names():
    """Each kernel's symbol finds its own profiler record (the demangled
    name with its arguments) and no other kernel's."""
    records = {name: f"void (anonymous namespace)::{symbol}(int const*, int)"
               for name, _where, symbol in chip_smoke.KERNELS}
    for name, symbol in chip_smoke.SYMBOLS.items():
        for other, key in records.items():
            assert chip_smoke._is_kernel(key, symbol) == (name == other), (name, other)
    assert [k for k, _w, _s in chip_smoke.KERNELS] == list(kernels.launches)


def test_busy_counts_each_kernel_once():
    """An op's profiler record repeats its kernels' device time; the busy
    time sums the device-side records only."""
    from types import SimpleNamespace

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [SimpleNamespace(device_type=cpu, self_device_time_total=2000.0),
              SimpleNamespace(device_type=cuda, self_device_time_total=2000.0),
              SimpleNamespace(device_type=cuda, self_device_time_total=500.0)]
    assert chip_smoke.busy_ms(torch, events) == 2.5


@pytest.mark.parametrize("seed", range(3))
def test_intra_query_work_replays_the_kernel(seed):
    rng = np.random.default_rng(seed)
    n, R = 300, 200
    begs = torch.from_numpy(np.where(rng.random(n) < 0.4, rng.integers(0, 99, n),
                                     rmq.I32_MAX).astype(np.int32))
    tab = rmq.build_sparse_table(begs, torch.minimum, rmq.I32_MAX)
    stab = torch.from_numpy(rng.integers(0, 1 << 30, n).astype(np.int32))
    rb_r = torch.from_numpy(rng.integers(-1, n, R).astype(np.int32))
    re_r = torch.clamp(rb_r + torch.from_numpy(rng.integers(0, 80, R).astype(np.int32)),
                       max=n)
    n_bytes, n_ops, out = chip_smoke.intra_query_work(torch, rmq, tab, stab, rb_r, re_r)
    assert torch.equal(out, kernels.intra_query_plain(tab, stab, rb_r, re_r))
    # the rank streams and output, and at most the sectors of the tables
    sectors = chip_smoke.SECTOR * (-(-tab.numel() * 4 // 32) + -(-n * 4 // 32))
    assert 12 * R < n_bytes <= 12 * R + sectors and n_ops == 12 * R


@pytest.mark.parametrize("seed", range(3))
def test_compact_ranks_work_replays_the_kernel(seed):
    rng = np.random.default_rng(seed)
    ks = keys.to_lanes(_rows(rng, 512))
    rec = keys.to_lanes(np.concatenate([_rows(rng, 100), keys.from_lanes(ks[:20])]))
    n_bytes, n_ops, out = chip_smoke.compact_ranks_work(torch, keys, ks, rec)
    assert torch.equal(out, kernels.compact_ranks_plain(ks, rec))
    assert n_bytes < ks.numel() * 4 + rec.numel() * 4 + rec.shape[0] * 4 and n_ops > 0


def test_chain_inputs_and_intra_fixpoint_work():
    """Phase 3's chain batch settles one txn an iteration (every other txn
    conflicts), and K2's work counts each input once, the bits and the
    count written once, one operation a read, write and txn an
    iteration."""
    pool, succ = chip_smoke.key_pool(np.random.default_rng(0), 256)
    B = 64
    fx = chip_smoke.chain_inputs(torch, keys, tdev, torch.device("cpu"), pool, succ, B)
    intra, n_iters = kernels.intra_fixpoint(*fx)
    assert int(n_iters) == B and int(intra.sum()) == B // 2
    n_bytes, n_ops, replay = chip_smoke.intra_fixpoint_work(fx, int(n_iters))
    R = Wn = B  # one read and one write a txn
    assert n_bytes == 17 * R + 21 * Wn + 3 * B + 4 and replay is None
    assert n_ops == B * (R + Wn + B)


def test_run_to_step_work_is_the_copy():
    """K4's bytes are exactly its inputs and outputs, once each."""
    rng = np.random.default_rng(1)
    runs = [_run(rng, 16, n) for n in (5, 0, 8)]
    args = (keys.to_lanes(np.stack([r[0] for r in runs])),
            keys.to_lanes(np.stack([r[1] for r in runs])),
            torch.tensor([3, 0, 5], dtype=torch.int32))
    rows, vals = kernels.run_to_step_runs(*args)
    n_bytes, n_ops, _ = chip_smoke.run_to_step_work(*args[0].shape)
    assert n_bytes == sum(t.numel() * t.element_size() for t in (*args, rows, vals))
    assert n_ops == 0


def _k4_args(seed=2, K=3, rcap=16):
    rng = np.random.default_rng(seed)
    runs = [_run(rng, rcap, n) for n in (5, 0, 8, 11, 3)[:K]]
    return (np.stack([r[0] for r in runs]), np.stack([r[1] for r in runs]),
            torch.tensor([3, 0, 5, 9, 1][:K], dtype=torch.int32))


@pytest.fixture
def untimed(monkeypatch):
    """chip_smoke's timers on the CPU: each runs its function once and
    reports a fixed time (launch_ms 0.5, device_ms 0.25, call_ms 0.75)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "launch_ms",
                        lambda torch, fn, reps, flush=None: (fn(), 0.5)[1])
    monkeypatch.setattr(chip_smoke, "device_ms", lambda torch, fn, symbol, reps: 0.25)
    monkeypatch.setattr(chip_smoke, "call_ms", lambda torch, fn, reps: 0.75)


def test_kernel_check_records_library_ms_for_k4(untimed):
    """Phase 3's check times K4's torch.stack yardstick as `library_ms`
    after holding it against the kernel's rows; a kernel without one
    records None, and a yardstick that computes something else fails."""
    b, e, ver = _k4_args()
    args = (keys.to_lanes(b), keys.to_lanes(e), ver)
    results = {}
    flush = torch.empty(16, dtype=torch.int32)

    def check(key, library_fn):
        chip_smoke.kernel_check(
            torch, kernels, results, flush, "run_to_step",
            list(kernels.run_to_step_runs(*args)), list(kernels.run_to_step_runs_plain(*args)),
            chip_smoke.run_to_step_work(*args[0].shape),
            fn=lambda: kernels.run_to_step_runs(*args),
            plain_fn=lambda: kernels.run_to_step_runs_plain(*args), reps=3, cold=True,
            key=key, library_fn=library_fn)

    check("run_to_step", lambda: chip_smoke.run_to_step_library(torch, *args[:2]))
    check("no_library", None)
    assert results["run_to_step"]["library_ms"] == 0.5
    assert results["no_library"]["library_ms"] is None
    assert set(chip_smoke.WIDE_TIMED) <= set(results["run_to_step"])
    with pytest.raises(RuntimeError, match="yardstick"):
        check("wrong", lambda: torch.stack((args[0], args[1]), dim=1))


def test_sweep_lists_k4_under_every_plan_and_its_yardstick(untimed):
    """The sweep times K4 at each width under its plan ("planned") and
    beside torch.stack, each held against the plain version; a package
    from before the plan is timed as it is, "before"."""
    b, e, ver = _k4_args(K=4)
    base = dict(runs_b=b, runs_e=e, k1=(None,) * 6 + (ver,))
    flush = torch.empty(16, dtype=torch.int32)
    rows = chip_smoke.sweep_k4(torch, kernels, keys, base, 17, 12, flush)
    assert {r["kernel"] for r in rows} == {"run_to_step"}
    assert all(r["W"] == 17 and r["cold_ms"] == 0.5 for r in rows)
    assert [r["plan"] for r in rows] == ["planned", "library"]
    old = SimpleNamespace(run_to_step_runs=kernels.run_to_step_runs_plain,
                          run_to_step_runs_plain=kernels.run_to_step_runs_plain)
    before = chip_smoke.sweep_k4(torch, old, keys, base, 17, 12, flush)
    assert [r["plan"] for r in before] == ["before", "library"]


def _k5_base(seed=4, R=120):
    """Phase 3's base inputs (kernel_inputs' keys) at a small size: K1's
    arguments, the narrow rows they were made of, and main."""
    rng = np.random.default_rng(seed)
    runs = [_run(rng, 64, n) for n in (40, 30, 0, 25)]
    runs_b, runs_e = np.stack([r[0] for r in runs]), np.stack([r[1] for r in runs])
    q = _rows(rng, 2 * R)[rng.permutation(2 * R)]
    rb, re_ = np.minimum(q[:R], q[R:]), np.maximum(q[:R], q[R:])
    r_ok = torch.from_numpy(rng.random(R) < 0.85)
    k1 = (keys.to_lanes(rb), keys.to_lanes(re_),
          torch.from_numpy(rng.integers(0, 12, R).astype(np.int32)), r_ok,
          keys.to_lanes(runs_b), keys.to_lanes(runs_e),
          torch.tensor([0, 4, 7, 9], dtype=torch.int32),
          torch.from_numpy(rng.random(R) < 0.1) & r_ok)
    return dict(k1=k1, runs_b=runs_b, runs_e=runs_e, rb=rb, re=re_, main=_rows(rng, 256))


def test_sweep_lists_k5_under_every_plan(untimed):
    """The sweep times K5 at the stream's inputs and on `prefixed` at
    SWEEP_K5_W under every plan of probe_tree_plans ("planned" first), each
    held against the plain version and K1; a package from before the plans
    is timed as it is, "before"; a kernel that disagrees fails."""
    base = _k5_base()
    flush = torch.empty(16, dtype=torch.int32)
    rows = chip_smoke.sweep_k5(torch, kernels, keys, base, flush)
    widths = (W, *chip_smoke.SWEEP_K5_W)
    for w in widths:
        mine = [r for r in rows if r["W"] == w]
        names = ["planned"] + ["L{}_r{}_c{}".format(*p)
                               for p in kernels.probe_tree_plans(4, 64, w)[1:]]
        assert [r["plan"] for r in mine] == names
        assert {r["input"] for r in mine} == {"stream" if w == W else "prefixed"}
        assert all(r["kernel"] == "probe" and r["cold_ms"] == 0.5 for r in mine)
        assert (mine[0]["levels"], mine[0]["reads"], mine[0]["cluster"]) == tuple(
            kernels.plan_probe_tree(4, 64, w))
    old = SimpleNamespace(run_conflicts=kernels.run_conflicts_plain,
                          run_conflicts_plain=kernels.run_conflicts_plain,
                          probe_fused=kernels.probe_fused,
                          run_to_step_plain=kernels.run_to_step_plain)
    before = chip_smoke.sweep_k5(torch, old, keys, base, flush)
    assert [(r["W"], r["plan"]) for r in before] == [(w, "before") for w in widths]
    wrong = SimpleNamespace(**vars(old))
    wrong.run_conflicts = lambda *a, **k: ~kernels.run_conflicts_plain(*a)
    with pytest.raises(RuntimeError, match="sweep: probe"):
        chip_smoke.sweep_k5(torch, wrong, keys, base, flush)


def test_sweep_times_the_referee_at_both_sizes(untimed):
    """The sweep times the per-query referee at R = 16384 and 49152 against
    the same tables, each held against the plain version; a referee that
    disagrees fails."""
    from foundationdb_tpu_torch.conflict.api import TxInfo

    fdb = dict(kernels=kernels, device=tdev, TxInfo=TxInfo, rmq=rmq)
    pool, succ = chip_smoke.key_pool(np.random.default_rng(0), 1024)
    rows = chip_smoke.sweep_referee(torch, fdb, torch.device("cpu"), pool, succ)
    R = chip_smoke.TXNS * chip_smoke.READS_PER_TXN
    assert [(r["R"], r["kernel"], r["warm_ms"]) for r in rows] == [
        (t * R, "intra_query", 0.5) for t in chip_smoke.SWEEP_REFEREE_REPEATS]
    fdb["kernels"] = SimpleNamespace(
        intra_query=lambda *a: kernels.intra_query_plain(*a) + 1,
        intra_query_plain=kernels.intra_query_plain)
    with pytest.raises(RuntimeError, match="sweep: intra_query"):
        chip_smoke.sweep_referee(torch, fdb, torch.device("cpu"), pool, succ)


def test_quartile_splits_share_the_pool_evenly():
    """Phase 13's split keys: strictly increasing, a quarter of the key
    pool in each partition."""
    pool, _succ = chip_smoke.key_pool(np.random.default_rng(3), 4096)
    splits = chip_smoke.quartile_splits(pool)
    assert len(splits) == chip_smoke.SHARDS - 1 and splits == sorted(set(splits))
    keys_b = [k.tobytes() for k in pool]
    bounds = [b""] + splits + [None]
    shares = [sum(lo <= k and (hi is None or k < hi) for k in keys_b)
              for lo, hi in zip(bounds, bounds[1:])]
    assert shares == [1024] * 4


def test_multi_oracle_referee_matches_the_sharded_set():
    """Phase 13's multi-oracle (the port's oracle per partition on clipped
    ranges, merged with min) gives the port's sharded set's verdicts on a
    reduced phase-8 stream, GC included."""
    from foundationdb_tpu_torch.conflict import oracle
    from foundationdb_tpu_torch.conflict.api import TxInfo, Verdict
    from foundationdb_tpu_torch.parallel.sharded import ShardedDeviceConflictSet

    stream = chip_smoke.oracle_batches(TxInfo, np.random.default_rng(5), n_batches=6,
                                       txns=48)
    referee = chip_smoke.MultiOracle(oracle, Verdict, chip_smoke.ORACLE_SPLITS)
    cs = ShardedDeviceConflictSet(chip_smoke.ORACLE_SPLITS, capacity=1 << 6,
                                  run_slots=2, devices=["cpu"])
    for i, (version, txns) in enumerate(stream, start=1):
        assert cs.resolve_batch(version, txns) == referee.resolve_batch(TxInfo, version, txns)
        if i % 3 == 0:
            cs.remove_before(version - 3)
            referee.remove_before(version - 3)
    assert cs.compactions >= 1


def test_in_flight_drive_matches_the_sync_drive(monkeypatch):
    """Phase 13's mode (c) (resolve_arrays(sync=False), two batches in
    flight) against mode (b)'s synchronous drive on the CPU: the same
    verdicts and the same state after the snapshot batch and at the end."""
    from foundationdb_tpu_torch.conflict import pipeline
    from foundationdb_tpu_torch.conflict.api import TxInfo, Verdict
    from foundationdb_tpu_torch.parallel.sharded import ShardedDeviceConflictSet

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    fdb = dict(device=tdev, pipeline=pipeline, Verdict=Verdict)
    pool, succ = chip_smoke.key_pool(np.random.default_rng(7), 512)
    batches = chip_smoke.stream_batches(TxInfo, np.random.default_rng(8), pool, succ,
                                        12, txns=32)
    args = dict(chip_smoke.BEST_KNOWN, max_key_bytes=16, capacity=1 << 8,
                run_slots=4, run_capacity=64, devices=["cpu"])
    splits = chip_smoke.quartile_splits(pool)
    sync, inflight = (ShardedDeviceConflictSet(splits, **args) for _ in range(2))
    want, _w, want_snap = chip_smoke.drive_sync(torch, fdb, sync, batches, 4)
    got, walls, snap = chip_smoke.drive_in_flight(torch, fdb, inflight, batches, 4)
    assert got == want and len(walls) == len(batches)
    chip_smoke.same_export(want_snap, snap, "snapshot")
    chip_smoke.same_export(sync.export_state(), inflight.export_state(), "end")
    assert sync.compactions >= 2


def _role_fdb():
    from foundationdb_tpu_torch.roles import resolver, types
    from foundationdb_tpu_torch.rpc import network, stream
    from foundationdb_tpu_torch.runtime import combinators, core, knobs

    return dict(core=core, knobs=knobs, combinators=combinators, types=types,
                resolver=resolver, rpc=dict(network=network, stream=stream))


def _role_stream(seed, n=14, txns=24):
    from foundationdb_tpu_torch.conflict.api import TxInfo

    pool, succ = chip_smoke.key_pool(np.random.default_rng(seed), 256)
    return chip_smoke.stream_batches(TxInfo, np.random.default_rng(seed + 1), pool,
                                     succ, n, txns=txns)


def test_role_requests_chain_the_stream():
    """Phase 14's requests: one ResolveTransactionBatchRequest a batch,
    each chained to the one before (the first to `prev`), carrying the
    batch's own transactions."""
    from foundationdb_tpu_torch.roles import types

    batches = _role_stream(2, n=5, txns=3)
    reqs = chip_smoke.role_requests(types, batches)
    assert [(r.prev_version, r.version) for r in reqs] == [(0, 1), (1, 2), (2, 3), (3, 4),
                                                           (4, 5)]
    assert all(r.transactions is txns for r, (_v, txns) in zip(reqs, batches))
    more = chip_smoke.role_requests(types, [(9, []), (12, [])], prev=5)
    assert [(r.prev_version, r.version) for r in more] == [(5, 9), (9, 12)]
    k = chip_smoke.role_knobs(_role_fdb()["knobs"])
    assert k.mvcc_window_versions == chip_smoke.GC_LAG


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_role_order_referee_is_what_the_role_replies(pipeline):
    """Phase 14's referee (the bare set in the role's order: resolve_batch,
    then remove_before(version - window)) replies what the port's Resolver
    over the same layout replies on a SimNetwork with every batch in
    flight, TOO_OLD verdicts past the window included; and the role's
    host-clock service times are one a batch."""
    from foundationdb_tpu_torch.conflict.api import Verdict

    batches = _role_stream(4)
    args = dict(chip_smoke.BEST_KNOWN, max_key_bytes=16, capacity=1 << 8,
                run_slots=4, run_capacity=64, device="cpu")
    want = chip_smoke.role_order_verdicts(tdev.DeviceConflictSet(**args), batches,
                                          chip_smoke.GC_LAG)
    fdb = _role_fdb()
    cs = tdev.DeviceConflictSet(**args)
    role, net, clock, replies = chip_smoke.sim_role_run(
        fdb, cs, chip_smoke.role_requests(fdb["types"], batches), pipeline)
    role.stop()
    assert [c for c, _t in replies] == want
    assert any(int(Verdict.TOO_OLD) in c for c in want)
    versions = [v for v, _t in batches]
    service = clock.service_ms(versions)
    assert len(service) == len(versions) and min(service) >= 0
    assert all(a >= b for a, b in zip(clock.receipt_to_reply_ms(versions), service))
    assert net.wire.snapshot()["pickle_fallbacks"] == 0


def _cluster_fdb():
    from foundationdb_tpu_torch import cluster
    from foundationdb_tpu_torch.conflict import oracle
    from foundationdb_tpu_torch.roles import types
    from foundationdb_tpu_torch.workloads import base, readwrite

    return dict(keys=keys, device=tdev, kernels=kernels, oracle=oracle, types=types,
                cluster=cluster, readwrite=readwrite, workloads_base=base)


class InProcess:
    """chip_smoke.twin_pool's stand-in: the submitted call runs in this
    process (with the fixtures' patches) when its result is asked for."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args):
        return SimpleNamespace(result=lambda: fn(*args))


def count_launches(monkeypatch):
    """Counting wrappers standing in for the kernels' launch counts on the
    CPU (whose plain versions count none): one a call of K1-K4's wrapper,
    and K2's under the plan it would take on the card (launch_counts)."""
    for fn, name in (("probe_fused", "probe_fused"), ("intra_fixpoint", "intra_fixpoint"),
                     ("compact_ranks", "compact_ranks"), ("run_to_step_runs", "run_to_step")):
        def counted(*a, _real=getattr(kernels, fn), _name=name, **k):
            kernels.launches[_name] += 1
            if _name == "intra_fixpoint":
                plan = kernels.plan_name(kernels.plan_intra(a[0].shape[0], a[2].shape[0],
                                                            a[11]))
                kernels.intra_launches[plan] = kernels.intra_launches.get(plan, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(kernels, fn, counted)


@pytest.fixture
def small_cluster(monkeypatch):
    """Phase 15 at a small size on the CPU: the key pool, its quartiles,
    the clients and the sets cut down; "cuda" sets and the default backend
    placed on the CPU; and counting wrappers standing in for the kernels'
    launch counts (the plain path counts none)."""
    from foundationdb_tpu_torch import cluster

    class CpuSet(tdev.DeviceConflictSet):
        def __init__(self, *a, **kw):
            super().__init__(*a, **dict(kw, device="cpu"))

    monkeypatch.setattr(tdev, "DeviceConflictSet", CpuSet)
    monkeypatch.setattr(cluster, "DeviceConflictSet", CpuSet)
    monkeypatch.setattr(cluster, "resolve_device", lambda _d: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    count_launches(monkeypatch)
    n = 512
    splits = [b"rw/%06d" % (q * n // 4) for q in (1, 2, 3)]
    monkeypatch.setattr(chip_smoke, "RW_KEYS", n)
    monkeypatch.setattr(chip_smoke, "CLUSTER_SET",
                        dict(chip_smoke.CLUSTER_SET, run_capacity=64, run_slots=3))
    monkeypatch.setattr(chip_smoke, "CLUSTER_PARTS", (
        ("a", 24, 0.1, dict(n_resolvers=1), 1 << 11),
        ("b", 16, 0.1, dict(n_resolvers=4, n_storage_shards=4, n_tlogs=2,
                            resolver_splits=splits, storage_splits=splits), 1 << 10)))
    monkeypatch.setattr(chip_smoke, "CLUSTER_MIN_COMMITS", 100)
    monkeypatch.setattr(chip_smoke, "CLUSTER_DET_CLIENTS", 8)
    monkeypatch.setattr(chip_smoke, "CLUSTER_DET_SECONDS", 0.05)
    monkeypatch.setattr(chip_smoke, "CLUSTER_PROFILE", (1, 2))
    monkeypatch.setattr(chip_smoke, "twin_pool", InProcess)  # keeps these patches
    return _cluster_fdb()


def test_cluster_phase_names_its_paths(small_cluster, monkeypatch):
    """Phase 15 end to end at a small size: (a), (b) and (c) pass their
    referee, read-back, launch and cuda-against-cpu checks, and their
    launch counts come back as the `cluster_*` paths of launches_by_path."""
    seen = []
    monkeypatch.setattr(chip_smoke, "check_backend_device",
                        lambda rec, dev: seen.append((dev, type(rec["sets"][0].inner))))
    paths = chip_smoke.cluster_phase(torch, small_cluster, "cpu")
    assert sorted(paths) == ["cluster_a", "cluster_b", "cluster_c_cuda"]
    for name, launches in paths.items():
        assert launches["probe_fused"] > 0 and launches["intra_fixpoint"] > 0, name
        assert launches["probe"] == launches["intra_query"] == 0, name
    assert paths["cluster_a"]["run_to_step"] > 0
    assert [d for d, _t in seen] == ["cuda", "cpu"]
    assert all(issubclass(t, tdev.DeviceConflictSet) for _d, t in seen)


def test_cluster_referee_catches_a_wrong_verdict(small_cluster):
    """A set that answers one batch wrong fails the oracle referee."""
    class Lying:
        def __init__(self):
            self.inner = tdev.DeviceConflictSet(**dict(chip_smoke.CLUSTER_SET,
                                                       capacity=1 << 11))
            self.n = 0

        def resolve_batch(self, version, txns):
            out = self.inner.resolve_batch(version, txns)
            self.n += 1
            if self.n == 5 and out:
                out = [type(out[0])(2 - int(out[0]))] + out[1:]  # COMMITTED <-> CONFLICT
            return out

        def __getattr__(self, name):
            return getattr(self.inner, name)

    with pytest.raises(RuntimeError, match="resolver batches differ from the oracle"):
        chip_smoke.cluster_run(torch, small_cluster, "lie", 8, 0.05,
                               make_set=lambda _i: Lying())


def test_acknowledged_writes_are_the_expected_values():
    """The read-back's expectation: the newest acknowledged write of each
    key; two writes of one key at one version must agree."""
    from foundationdb_tpu_torch.roles import types

    def s(k, v):
        return types.Mutation(types.MutationType.SET_VALUE, k, v)

    acked = [(5, [s(b"a", b"x"), s(b"b", b"x")]), (3, [s(b"a", b"old")]),
             (9, [s(b"b", b"y")]), (9, [s(b"b", b"y")])]
    assert chip_smoke.expected_values(types, acked) == {b"a": b"x", b"b": b"y"}
    with pytest.raises(RuntimeError, match="disagree"):
        chip_smoke.expected_values(types, acked + [(9, [s(b"b", b"z")])])
    with pytest.raises(RuntimeError, match="not a set"):
        chip_smoke.expected_values(types, [(1, [types.Mutation(
            types.MutationType.ADD, b"n", b"\x01")])])


def test_a_lost_write_fails_the_read_back(small_cluster, monkeypatch):
    """A storage read that loses one acknowledged key fails phase 15."""
    real = chip_smoke.read_back

    def lossy(fdb, c, db):
        got = real(fdb, c, db)
        got.pop(next(iter(sorted(got))))
        return got

    monkeypatch.setattr(chip_smoke, "read_back", lossy)
    with pytest.raises(RuntimeError, match="acknowledged keys read back wrong"):
        chip_smoke.cluster_run(torch, small_cluster, "lossy", 8, 0.05,
                               make_set=lambda _i: tdev.DeviceConflictSet(
                                   **dict(chip_smoke.CLUSTER_SET, capacity=1 << 11)))


def test_no_handler_swallows_a_phase():
    """chip_smoke.py catches nothing: a failing phase ends the run (only
    try/finally clean-ups), and it imports nothing of the JAX package."""
    import ast
    from pathlib import Path

    tree = ast.parse(Path(chip_smoke.__file__).read_text())
    assert not [n.lineno for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    names = {a.name for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))
             for a in n.names} | {n.module for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m for m in names if m.split(".")[0] in ("jax", "jaxlib", "foundationdb_tpu")}
    assert "cluster" in names and "foundationdb_tpu_torch.workloads" in names


@pytest.fixture
def small_durable(small_cluster, monkeypatch):
    """Phase 16 at a small size on the CPU, over phase 15's fixture: the
    recoverable cluster's default backend placed on the CPU too, the card's
    memory counters stubbed, and the CPU sets naming themselves as the
    card's in the status roll-up (they stand in for them)."""
    from foundationdb_tpu_torch.control import recoverable, status
    from foundationdb_tpu_torch.workloads import attrition

    card_set = tdev.DeviceConflictSet

    class StandIn(card_set):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.stats.backend = "cuda"

    monkeypatch.setattr(tdev, "DeviceConflictSet", StandIn)
    monkeypatch.setattr(recoverable, "DeviceConflictSet", card_set)
    monkeypatch.setattr(recoverable, "resolve_device", lambda _d: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "card_bytes", lambda _torch: 0)
    monkeypatch.setattr(chip_smoke, "CLUSTER_SET",
                        dict(chip_smoke.CLUSTER_SET, capacity=1 << 11))
    monkeypatch.setattr(chip_smoke, "DURABLE_RUN", (16, 10.45, (2, 0.05, 5.25)))
    monkeypatch.setattr(chip_smoke, "DURABLE_DET", (8, 5.3, (1, 0.05, 5.0)))
    monkeypatch.setattr(chip_smoke, "DURABLE_PROFILE", (1, 2))
    return dict(small_cluster, recoverable=recoverable, status=status, attrition=attrition)


def test_durable_phase_names_its_paths(small_durable, monkeypatch):
    """Phase 16 end to end at a small size: the main run's two recoveries
    (each generation's set launches), the restart's read-back, probe
    commit and status, and the twin's cuda-against-cpu identity, with the
    launch counts returned as the `durable_*` paths."""
    seen = []
    monkeypatch.setattr(chip_smoke, "check_backend_device",
                        lambda rec, dev: seen.append((dev, rec["sets"][0].facts()["kind"])))
    paths = chip_smoke.durable_phase(torch, small_durable, "cpu")
    assert sorted(paths) == ["durable_a", "durable_c_cuda", "durable_restart"]
    for name, launches in paths.items():
        assert launches["probe_fused"] > 0 and launches["intra_fixpoint"] > 0, name
        assert launches["probe"] == launches["intra_query"] == 0, name
    assert [d for d, _k in seen] == ["cuda", "cpu"]
    assert {k for _d, k in seen} == {small_durable["recoverable"].DeviceConflictSet.__name__}


def _durable(fdb, part, make_set):
    clients, seconds, kills = chip_smoke.DURABLE_RUN
    return chip_smoke.durable_run(torch, fdb, part, clients, seconds, kills, restart=True,
                                  make_set=make_set)


def test_durable_referee_catches_a_wrong_verdict_in_a_recovered_generation(small_durable):
    """A set built at a recovery (a non-zero version) that answers one
    batch wrong fails the referee, which starts each generation's oracle at
    that generation's version."""
    class Lying:
        def __init__(self, oldest):
            self.inner = tdev.DeviceConflictSet(oldest, **chip_smoke.CLUSTER_SET)
            self.lie = oldest > 0

        def resolve_batch(self, version, txns):
            out = self.inner.resolve_batch(version, txns)
            if self.lie and len(out) > 2 and int(out[-1]) == 0:
                self.lie = False  # one workload transaction aborted for nothing
                out = out[:-1] + [type(out[-1])(2)]
            return out

        def __getattr__(self, name):
            return getattr(self.inner, name)

    with pytest.raises(RuntimeError, match="resolver batches differ from the oracle"):
        _durable(small_durable, "lie", Lying)


@pytest.mark.parametrize("loss", ["key", "value"])
def test_durable_read_back_catches_a_write_lost_across_the_restart(small_durable,
                                                                   monkeypatch, loss):
    """The restarted cluster's read-back missing a key, or serving one
    key's setup value where acknowledged writes overwrote it, fails the
    phase."""
    real = chip_smoke.read_back

    def lossy(fdb, c, db):
        got = real(fdb, c, db)
        if loss == "key":
            got.pop(next(iter(sorted(got))))
        else:
            key = next(k for k, v in sorted(got.items()) if v == b"y" * 16)
            got[key] = b"x" * 16
        return got

    monkeypatch.setattr(chip_smoke, "read_back", lossy)
    with pytest.raises(RuntimeError, match="acknowledged keys read back wrong"):
        _durable(small_durable, "lossy", lambda oldest: tdev.DeviceConflictSet(
            oldest, **chip_smoke.CLUSTER_SET))


def test_read_back_allows_only_unknown_results():
    """A key may hold the value of a commit of unknown result instead of
    its newest acknowledged value; any other difference fails."""
    from foundationdb_tpu_torch.roles import types

    want = {b"a": b"x", b"b": b"y"}
    unknown = [[types.Mutation(types.MutationType.SET_VALUE, b"a", b"y")]]
    keys_ = chip_smoke.RW_KEYS
    chip_smoke.RW_KEYS = 2
    try:
        chip_smoke.check_read_back({b"a": b"y", b"b": b"y"}, want, unknown, "t")
        with pytest.raises(RuntimeError, match="read back wrong"):
            chip_smoke.check_read_back({b"a": b"x", b"b": b"x"}, want, unknown, "t")
        with pytest.raises(RuntimeError, match="read back wrong"):
            chip_smoke.check_read_back({b"a": b"x"}, want, unknown, "t")
    finally:
        chip_smoke.RW_KEYS = keys_


def test_recovery_spans_pair_each_recovery():
    states = [(0.0, "reading_cstate"), (0.1, "fully_recovered"), (3.0, "reading_cstate"),
              (3.01, "recruiting"), (3.02, "fully_recovered")]
    assert chip_smoke.recovery_spans(states) == [(0.0, 0.1), (3.0, 3.02)]


@pytest.fixture
def small_backup(small_durable, monkeypatch):
    """Phase 17 at a small size on the CPU, over phase 16's fixture: the
    clients cut down and the snapshot's chunks made smaller, so the 512-key
    pool still spans several chunks."""
    from foundationdb_tpu_torch.client import backup, dr
    from foundationdb_tpu_torch.runtime import core
    from foundationdb_tpu_torch.storage import blobstore, image
    from foundationdb_tpu_torch.workloads import consistency

    monkeypatch.setattr(chip_smoke, "BACKUP_RUN", (16, 5.3, (1, 0.05, 5.0)))
    monkeypatch.setattr(chip_smoke, "BACKUP_DET", (8, 5.3, (1, 0.05, 5.0)))
    monkeypatch.setattr(chip_smoke, "BACKUP_CHUNK_ROWS", 100)
    return dict(small_durable, backup=backup, dr=dr, blobstore=blobstore, image=image,
                consistency=consistency, core=core)


def test_backup_phase_names_its_paths(small_backup, monkeypatch):
    """Phase 17 end to end at a small size: the backup survives its kill
    and restores exactly, the restart image reads back, DR fails over
    exactly, the twin is identical on both devices, and the six paths come
    back with launches in every one."""
    seen = []
    monkeypatch.setattr(chip_smoke, "check_backend_device",
                        lambda rec, dev: seen.append((dev, rec["sets"][0].facts()["kind"])))
    paths = chip_smoke.backup_phase(torch, small_backup, "cpu")
    assert sorted(paths) == ["backup_c_cuda", "backup_dst", "backup_restart", "backup_src",
                             "dr_primary", "dr_secondary"]
    for name, launches in paths.items():
        assert launches["probe_fused"] > 0 and launches["intra_fixpoint"] > 0, name
        assert launches["probe"] == launches["intra_query"] == 0, name
    assert paths["backup_src"]["run_to_step"] > 0 and paths["dr_secondary"]["run_to_step"] > 0
    assert [d for d, _k in seen] == ["cuda", "cpu"]


def _backup(fdb, part, make_set):
    clients, seconds, kills = chip_smoke.BACKUP_RUN
    return chip_smoke.backup_run(torch, fdb, part, clients, seconds, kills, make_set=make_set)


def test_backup_referee_catches_a_wrong_verdict(small_backup):
    """A set that aborts one transaction the oracle commits fails the
    referee, whichever cluster of the path it serves."""
    class Lying:
        def __init__(self, oldest):
            self.inner = tdev.DeviceConflictSet(oldest, **chip_smoke.CLUSTER_SET)
            self.batches = 0

        def resolve_batch(self, version, txns):
            out = self.inner.resolve_batch(version, txns)
            self.batches += bool(txns)
            if self.batches == 3 and out and int(out[-1]) == 2:
                out = out[:-1] + [type(out[-1])(0)]  # COMMITTED -> CONFLICT
            return out

        def __getattr__(self, name):
            return getattr(self.inner, name)

    with pytest.raises(RuntimeError, match="resolver batches differ from the oracle"):
        _backup(small_backup, "lie", Lying)


@pytest.mark.parametrize("loss", ["key", "value"])
def test_restore_check_catches_a_lost_or_wrong_key(small_backup, monkeypatch, loss):
    """The destination's read-back missing a key, or holding another value
    for one, fails the restore check (the source's read is the first, the
    destination's the second)."""
    real, calls = chip_smoke.read_user, []

    def lossy(fdb, c, db):
        got = real(fdb, c, db)
        calls.append(c)
        if len(calls) == 2:
            key = next(iter(sorted(got)))
            if loss == "key":
                got.pop(key)
            else:
                got[key] = b"z" * 16
        return got

    monkeypatch.setattr(chip_smoke, "read_user", lossy)
    with pytest.raises(RuntimeError, match="restored keyspace differs"):
        _backup(small_backup, "lossy", lambda oldest: tdev.DeviceConflictSet(
            oldest, **chip_smoke.CLUSTER_SET))


def test_dr_check_catches_a_key_the_secondary_lost(small_backup, monkeypatch):
    """The secondary's read-back missing one key fails the DR check."""
    real = chip_smoke.read_user

    def lossy(fdb, c, db):
        got = real(fdb, c, db)
        if c.is_secondary:
            got.pop(next(iter(sorted(got))))
        return got

    built = []
    make = small_backup["recoverable"].RecoverableCluster

    def cluster(*a, **kw):
        built.append(make(*a, **kw))
        built[-1].is_secondary = len(built) == 2  # dr_run builds the primary first
        return built[-1]

    monkeypatch.setattr(small_backup["recoverable"], "RecoverableCluster", cluster)
    monkeypatch.setattr(chip_smoke, "read_user", lossy)
    clients, seconds, kills = chip_smoke.BACKUP_RUN
    with pytest.raises(RuntimeError, match="secondary's keyspace differs"):
        chip_smoke.dr_run(torch, small_backup, clients, seconds, kills,
                          lambda oldest: tdev.DeviceConflictSet(oldest, **chip_smoke.CLUSTER_SET))


@pytest.fixture
def small_corpus(small_durable, monkeypatch):
    """Phase 18 at a small size on the CPU, over phase 16's fixture: the
    supervised specs as written (their sets placed on the CPU), and (b)'s
    clients, key pool and set cut down."""
    from foundationdb_tpu_torch.conflict import supervisor
    from foundationdb_tpu_torch.conflict.api import TxInfo
    from foundationdb_tpu_torch.runtime import buggify
    from foundationdb_tpu_torch.runtime.core import DeterministicRandom
    from foundationdb_tpu_torch.workloads import spec

    monkeypatch.setattr(tdev, "resolve_device", lambda _d=None: torch.device("cpu"))
    monkeypatch.setattr(chip_smoke, "LONG_SET",
                        dict(chip_smoke.CLUSTER_SET, max_key_bytes=32))
    monkeypatch.setattr(chip_smoke, "LONG_RUN", (16, 0.1))
    return dict(small_durable, spec=spec, supervisor=supervisor, buggify=buggify,
                DeterministicRandom=DeterministicRandom, TxInfo=TxInfo)


def test_corpus_phase_names_its_paths(small_corpus, monkeypatch):
    """Phase 18 end to end at a small size: the two supervised spec runs
    pass, equal their cpu twins and the oracle, and the long-key run widens
    its set, launches K1, K3 and K4 at that width and commits a short key
    after the longest; the three paths come back with launches."""
    seen = []
    monkeypatch.setattr(chip_smoke, "check_backend_device",
                        lambda rec, dev: seen.append((dev, {s.facts()["kind"]
                                                            for s in rec["sets"]})))
    paths = chip_smoke.corpus_phase(torch, small_corpus, "cpu")
    assert sorted(paths) == ["long_keys", "readback_drill", "spec_device_fault",
                             "spec_restart_pair"]
    for name, launches in paths.items():
        assert launches["probe_fused"] > 0 and launches["intra_fixpoint"] > 0, name
        assert launches["probe"] == launches["intra_query"] == 0, name
    assert paths["long_keys"]["run_to_step"] > 0 and paths["long_keys"]["compact_ranks"] > 0
    assert [d for d, _k in seen] == ["cuda", "cuda"]


def test_long_key_run_widens_and_its_referee_catches_a_wrong_verdict(small_corpus):
    """(b)'s record: the set widened past 32 bytes to the width of the
    longest endpoint, K1/K3/K4 launched at it; and a wrong verdict on a
    widened batch fails the oracle referee."""
    keys_mod = small_corpus["keys"]
    rec = chip_smoke.long_key_run(torch, small_corpus, *chip_smoke.LONG_RUN)
    widest = max(f["key_bytes"] for f in rec["facts"])
    assert widest > 32 and widest == keys_mod.grown_key_bytes(rec["longest"])
    W = keys_mod.num_words(widest)
    assert all(rec["widths"].get((n, W)) for n in ("probe_fused", "compact_ranks",
                                                  "run_to_step"))
    assert isinstance(rec["probe_version"], int) and rec["widened"]

    real, lied = tdev.DeviceConflictSet.resolve_batch, []

    def lying(self, version, txns):
        out = real(self, version, txns)
        if self.stats.widenings and not lied and out and int(out[-1]) == 2:
            lied.append(version)
            out = out[:-1] + [type(out[-1])(0)]  # COMMITTED -> CONFLICT, once
        return out

    tdev.DeviceConflictSet.resolve_batch = lying
    try:
        with pytest.raises(RuntimeError, match="resolver batches differ from the oracle"):
            chip_smoke.long_key_run(torch, small_corpus, *chip_smoke.LONG_RUN)
    finally:
        tdev.DeviceConflictSet.resolve_batch = real


def test_a_set_that_never_widens_fails_the_long_key_check(small_corpus, monkeypatch):
    """Built wide enough for every key, the set does not widen: (b) fails."""
    monkeypatch.setattr(chip_smoke, "LONG_SET", dict(chip_smoke.LONG_SET, max_key_bytes=256))
    with pytest.raises(RuntimeError, match="did not widen"):
        chip_smoke.long_key_phase(torch, small_corpus, "cpu")


@pytest.mark.parametrize("fires, breaker_open, ok", [
    ({"device.lost": 2}, {"device.lost": False}, True),
    ({"device.lost": 0}, {"device.lost": True}, True),
    ({"device.lost": 0}, {"device.lost": False}, False),
    ({}, {"device.readback_corrupt": False}, False),
])
def test_a_forced_class_must_fire_unless_every_breaker_was_open(fires, breaker_open, ok):
    """(a)'s check of the forced device.* classes: a class that never fired
    passes only if every supervisor's breaker was open when it was forced."""
    if ok:
        chip_smoke.check_forced_fired("spec", fires, breaker_open)
    else:
        with pytest.raises(RuntimeError, match="never fired"):
            chip_smoke.check_forced_fired("spec", fires, breaker_open)


def test_readback_drill_catches_a_supervisor_that_serves_corrupt_verdicts(
        small_corpus, monkeypatch):
    """The readback drill passes on the CPU, and fails when the supervisor
    no longer validates what it reads back (the corrupt verdicts are served)."""
    from foundationdb_tpu_torch.conflict import supervisor

    rec = chip_smoke.readback_drill(torch, small_corpus, "cpu")
    assert rec["served"] == ["device", "cpu", "device", "device", "device"]
    monkeypatch.setattr(supervisor, "validate_verdicts", lambda verdicts, n: None)
    with pytest.raises(RuntimeError, match="differs from the oracle"):
        chip_smoke.readback_drill(torch, small_corpus, "cpu")


@pytest.fixture
def small_served(small_corpus, monkeypatch, tmp_path):
    """Phase 19 at a small size on the CPU, over phase 18's fixture: every
    run on "cpu" (the server and the soak's workers are processes of their
    own, which the counting wrappers do not reach, so their launch checks
    are off), the repro's sets small, the gateway's long key 40 bytes
    (the server's default set at 16 KB keys takes seconds a batch on the
    CPU), the ladder cut down, and the campaign two seeds of a spec of
    seconds."""
    from foundationdb_tpu_torch.client import cluster_file, gateway_client
    from foundationdb_tpu_torch.rpc import network
    from foundationdb_tpu_torch.tools import gateway, saturate, soak

    class Tiny(tdev.DeviceConflictSet):
        def __init__(self, *a, **kw):
            super().__init__(*a, **dict(kw, capacity=1 << 8, run_slots=3, run_capacity=32))

    monkeypatch.setattr(tdev, "DeviceConflictSet", Tiny)
    # the server, the coordinators and the soak's workers inherit this: with
    # torch's default threads, a process on the CPU spins idle OpenMP threads
    # between its small ops, and beside the other test workers it starves
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(chip_smoke, "CARD", "cpu")
    monkeypatch.setattr(chip_smoke, "SERVED_KERNELS", ())
    monkeypatch.setattr(chip_smoke, "SOAK_KERNELS", ())
    monkeypatch.setattr(chip_smoke, "SERVED_KEYS", (40, 10))
    monkeypatch.setattr(chip_smoke, "SERVED_SEEDS", (11,))
    monkeypatch.setattr(chip_smoke, "SAT_CURVE",
                        dict(chip_smoke.SAT_CURVE, steps=[20.0, 40.0], keys=300))
    spec = tmp_path / "Mini.txt"  # a spec of seconds, its manifest beside it
    spec.write_text("testTitle=Mini\nchaos=true\n\ntestName=Cycle\nnodes=6\nclients=2\n"
                    "txnsPerClient=4\n\ntestName=Attrition\nkills=1\ninterval=2.0\n"
                    "startDelay=0.8\n")
    (tmp_path / "Mini.coverage").write_text("recovery.triggered\n")
    monkeypatch.setattr(chip_smoke, "SOAK_SPEC", str(spec))
    monkeypatch.setattr(chip_smoke, "SOAK_SEEDS", [3000, 3001])
    return dict(small_corpus, gateway=gateway, saturate=saturate, soak=soak,
                cluster_file=cluster_file, gateway_client=gateway_client,
                rpc=dict(network=network))


def test_served_phase_names_its_paths(small_served):
    """Phase 19 end to end at a small size: C.1's repro widens to 16 KB and
    equals the oracle's cluster, the served processes pass every check,
    the ladder and the campaign equal their cpu twins; five paths come
    back, the repro's with K1/K3/K4 launches (the counting wrappers)."""
    paths = chip_smoke.served_phase(torch, small_served, "cpu")
    assert sorted(paths) == ["long_keys_16k", "saturate", "served", "soak"]
    assert all(paths["long_keys_16k"][k] > 0 for k in chip_smoke.WIDE_KERNELS)
    assert not any(paths["served"].values()) and not any(paths["soak"].values())


def test_repro_part_fails_on_a_set_that_cannot_widen_to_16k(small_served, monkeypatch):
    """With a ceiling back at 512 bytes (a widening past it refused as the
    card refuses one it cannot hold), the 10,000-byte key stops the
    cluster's commits, and (a) fails."""
    from foundationdb_tpu_torch import keys

    grown = keys.grown_key_bytes

    def capped(need):
        if need > 512:
            raise keys.KeyTooLongError(f"key of {need} bytes past the 512-byte cap")
        return grown(need)

    monkeypatch.setattr(keys, "grown_key_bytes", capped)
    with pytest.raises(Exception) as err:
        chip_smoke.repro_part(torch, small_served, "cpu", "cpu")
    assert type(err.value).__name__ in ("CommitUnknownResult", "NotCommitted")


@pytest.mark.parametrize("W", [5, 17, 65])
def test_prefixed_lanes_encode_the_prefixed_keys(W):
    """Phase 3's wide inputs: each 16-byte key's row at W lanes is the
    encoding of the common prefix followed by the key, and sentinel rows
    stay sentinel."""
    rng = np.random.default_rng(W)
    keys_16 = [bytes(rng.integers(0, 256, 16, dtype=np.uint8)) for _ in range(40)]
    rows = np.stack([keys.encode_keys(keys_16, 16), np.full((40, 5), SENT, np.uint32)])
    got = chip_smoke.prefixed_lanes(torch, keys, rows, W, "cpu")
    prefix = chip_smoke.PREFIX_WORD.to_bytes(4, "big") * (W - 5)
    want = keys.encode_keys([prefix + k for k in keys_16], 4 * (W - 1))
    assert np.array_equal(keys.from_lanes(got[0]), want)
    assert bool((got[1] == keys.SENT_LANE).all())


@pytest.mark.parametrize("W", [9, 17, 129])
def test_widened_lanes_encode_keys_and_their_key_after(W):
    """Phase 3's `widened` input: each 16-byte key's row at W lanes is the
    encoding a widened set holds (keys.widen_lanes), its `after` row the
    encoding of key + b"\\0", the two differing only in the last lane;
    sentinel rows stay sentinel."""
    rng = np.random.default_rng(W)
    keys_16 = [bytes(rng.integers(0, 256, 16, dtype=np.uint8)) for _ in range(30)]
    rows = np.concatenate([keys.encode_keys(keys_16, 16), np.full((5, 5), SENT, np.uint32)])
    got = chip_smoke.widened_lanes(torch, keys, rows, W, "cpu")
    after = chip_smoke.widened_lanes(torch, keys, rows, W, "cpu", after=True)
    assert np.array_equal(keys.from_lanes(got[:30]), keys.encode_keys(keys_16, 4 * (W - 1)))
    assert np.array_equal(keys.from_lanes(after[:30]),
                          keys.encode_keys([k + b"\x00" for k in keys_16], 4 * (W - 1)))
    assert torch.equal(got[:30, :-1], after[:30, :-1])
    assert bool((got[30:] == keys.SENT_LANE).all()) and torch.equal(got[30:], after[30:])


def test_trace_search_reads_less_behind_a_shared_prefix():
    """The corrected yardstick: behind a common prefix filling the width a
    search reads each row's prefix only until both bounds share it, so it
    counts far fewer lanes than compares that all start at lane 0, with
    the same ranks."""
    rng = np.random.default_rng(4)
    W = 65
    table = chip_smoke.prefixed_lanes(torch, keys, _rows(rng, 400), W, "cpu")
    qq = chip_smoke.prefixed_lanes(torch, keys, _rows(rng, 100), W, "cpu")
    rank, t_el, _q_el, steps, lanes = chip_smoke.trace_search(torch, table, qq,
                                                              torch.arange(100))
    assert torch.equal(rank.to(torch.int32), lower_bound(table, qq))
    lo = torch.zeros(100, dtype=torch.long)
    hi = torch.full_like(lo, len(table))
    from_zero = 0
    while bool((lo < hi).any()):
        a = (lo < hi).nonzero()[:, 0]
        mid = (lo[a] + hi[a]) // 2
        share, less = chip_smoke._share(torch, table[mid], qq[a])
        from_zero += int((torch.clamp(share, max=W - 1) + 1).sum())
        lo[a] = torch.where(less, mid + 1, lo[a])
        hi[a] = torch.where(less, hi[a], mid)
    assert steps <= lanes and 2 * lanes < from_zero


@pytest.fixture
def small_root(monkeypatch):
    """Phase 21 at a small size on the CPU: the bench's transactions a batch
    and capacities cut (its 8 prefill batches kept, so bench_debug's set
    compacts at its first timed batch), the primitive table at small shapes,
    every run on "cpu", the twin in this process, and counting wrappers
    standing in for the kernels' launch counts."""
    from foundationdb_tpu_torch import bench, profile_kernel

    monkeypatch.setattr(chip_smoke, "CARD", "cpu")
    monkeypatch.setattr(chip_smoke, "twin_pool", InProcess)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    count_launches(monkeypatch)
    monkeypatch.setattr(bench, "TXNS_PER_BATCH", 48)
    monkeypatch.setattr(bench, "CAP", 1 << 12)
    monkeypatch.setattr(bench, "REC_CAP", 1 << 10)
    monkeypatch.setattr(profile_kernel, "TABLE_SHAPES",
                        profile_kernel.Shapes(cap=1 << 12, R=256, Wn=128, W=5, B=128))
    return chip_smoke.port_modules()


def test_root_scripts_phase_names_its_paths(small_root, capsys):
    """Phase 21 end to end at a small size: the phase profile conforms and
    its launch counts hold, the digests equal between two runs, the tables
    print every row, entry() and the dry run pass, bench_debug's sums equal
    the synchronous run's; five paths come back, K1-K4 launched across them."""
    paths = chip_smoke.root_scripts_phase(torch, small_root, "cpu")
    assert tuple(paths) == chip_smoke.ROOT_PATHS
    assert paths["graft_entry"]["intra_fixpoint"] == 1
    assert all(paths["graft_dryrun"][k] > 0 for k in chip_smoke.MAIN_PATH)
    out = capsys.readouterr().out
    assert "WHOLE resolve_core kernel" in out and "searchsorted 49K into CAP" in out
    assert out.count("[multichip] bench-class dryrun") == 2


def test_root_scripts_phase_catches_a_wrong_bench_debug_sum(small_root, monkeypatch):
    """A bench_debug whose verdict sum is off by one fails (e)."""
    bd = small_root["bench_debug"]
    real = bd.run

    def off_by_one(*a, **k):
        out = real(*a, **k)
        out[-1]["verdict_sum"] += 1
        return out

    monkeypatch.setattr(bd, "run", off_by_one)
    with pytest.raises(RuntimeError, match=r"root \(e\): verdict sums"):
        chip_smoke.root_scripts_phase(torch, small_root, "cpu")
