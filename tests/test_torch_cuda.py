"""The port's CUDA kernels on the card, each held against its plain torch
version on the same CUDA tensors (exact: all are integer functions),
and the port's sets on "cuda" (the flat layout, the best-known layout
synchronous and pipelined, the legacy layouts, phase timing and the
sharded set) against the same sets on "cpu".

Marked `gpu`: every test asks the `cuda` fixture, which skips when no CUDA
device is present (decided at run time, never at import or collection).
On a machine with the card (`--noconftest`: tests/conftest.py imports
jax, which the card's machine need not have):

    python -m pytest --noconftest tests/test_torch_cuda.py -m gpu
"""

import random

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch import keys
from foundationdb_tpu_torch.conflict import device as tdev
from foundationdb_tpu_torch.conflict import kernels
from foundationdb_tpu_torch.conflict import pipeline as tpipe
from foundationdb_tpu_torch.conflict.api import TxInfo
from foundationdb_tpu_torch.runtime import coverage
from foundationdb_tpu_torch.ops import rmq
from foundationdb_tpu_torch.parallel import sharded as tsh

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(rng, n, W=5):
    """Sorted unique random key rows (uint32 layout) with sentinel padding."""
    words = rng.integers(0, 1 << 12, size=(n, W - 1)).astype(np.uint32)
    rows = np.concatenate([words, np.full((n, 1), 16, np.uint32)], axis=1)
    rows = np.unique(rows, axis=0)
    pad = np.full((n - len(rows), W), 0xFFFFFFFF, np.uint32)
    return np.concatenate([rows, pad])


def _run(rng, run_cap, W=5):
    """A sorted disjoint run: begins = even rows of a sorted list, ends =
    odd rows, sentinel-padded."""
    live = _rows(rng, max(run_cap, 2), W)
    live = live[live[:, -1] != 0xFFFFFFFF]
    m = min(len(live) // 2, run_cap)
    b, e = live[: 2 * m : 2], live[1 : 2 * m : 2]
    out_b = np.full((run_cap, W), 0xFFFFFFFF, np.uint32)
    out_e = out_b.copy()
    out_b[: len(b)], out_e[: len(e)] = b, e
    return out_b, out_e


def _same(a, b):
    torch.cuda.synchronize()
    return torch.equal(a.cpu(), b.cpu())


# K1 inputs: (W, K, run_cap, R, case); R = 300 and 385 are not multiples
# of the 128-read tile, 5 is less than one
K1_CASES = [(W, K, cap, 300, "random") for W in (5, 9) for K in (1, 8)
            for cap in (1, 64, 16384)] + [
    (5, 8, 64, 385, "random"),
    (5, 3, 64, 5, "random"),
    (9, 8, 1000, 300, "random"),  # run_cap above the stride, not a multiple
    (5, 8, 64, 300, "no_r_ok"),
    (5, 8, 64, 300, "all_hist"),
    (5, 8, 256, 300, "sentinel_run"),
    (9, 8, 256, 300, "dead_run"),
    (5, 8, 256, 300, "touching"),
    (9, 2, 16384, 1000, "touching"),
]


def _probe_case(rng, dev, W, K, run_cap, R, case):
    """K1's arguments: K seeded runs, R reads (half of them on run keys),
    and what `case` changes: no r_ok, every history bit, run 0 all
    sentinel, run 0 at version 0, or reads whose end is a run's begin
    and reads whose begin is a run's end."""
    runs = [_run(rng, run_cap, W) for _ in range(K)]
    runs_b_np = np.stack([r[0] for r in runs])
    runs_e_np = np.stack([r[1] for r in runs])
    if case == "sentinel_run":
        runs_b_np[0] = runs_e_np[0] = 0xFFFFFFFF
    runs_ver_np = rng.integers(1, 25, K).astype(np.int32)
    if case == "dead_run":
        runs_ver_np[0] = 0
    q = _rows(rng, 2 * R, W)[rng.permutation(2 * R)]
    rb, re_ = np.minimum(q[:R], q[R:]), np.maximum(q[:R], q[R:])
    live_b = runs_b_np[runs_b_np[..., -1] != 0xFFFFFFFF]
    live_e = runs_e_np[runs_e_np[..., -1] != 0xFFFFFFFF]
    if len(live_b):
        pick = rng.integers(0, len(live_b), R)
        on_run = rng.random(R) < 0.5
        rb[on_run] = np.minimum(rb[on_run], live_b[pick[on_run]])
    if case == "touching" and len(live_b) > 1:
        n = R // 3
        j = rng.integers(0, len(live_b) - 1, n)
        rb[:n], re_[:n] = live_e[j], live_b[j + 1]      # begin == an end
        rb[n:2 * n], re_[n:2 * n] = live_b[j], live_b[j + 1]  # end == a begin
    snap = rng.integers(0, 25, R).astype(np.int32)
    r_ok = rng.random(R) < 0.9
    if case == "no_r_ok":
        r_ok[:] = False
    hist = (rng.random(R) < 0.1) & r_ok
    if case == "all_hist":
        hist[:] = True
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (keys.to_lanes(rb, dev), keys.to_lanes(re_, dev), t(snap), t(r_ok),
            keys.to_lanes(runs_b_np, dev), keys.to_lanes(runs_e_np, dev),
            t(runs_ver_np), t(hist))


@pytest.mark.parametrize("W,K,run_cap,R,case", K1_CASES)
def test_k1_probe_fused_matches_plain(cuda, W, K, run_cap, R, case):
    """K1 equals its plain version, and K5 ORed with the history bits."""
    rng = np.random.default_rng(K1_CASES.index((W, K, run_cap, R, case)))
    args = _probe_case(rng, cuda, W, K, run_cap, R, case)
    before = dict(kernels.launches)
    got = kernels.probe_fused(*args)
    assert kernels.launches["probe_fused"] == before["probe_fused"] + 1
    want = kernels.probe_fused_plain(*args)
    assert _same(got, want)
    assert _same(kernels.run_conflicts(*args[:7]) | args[7], got)
    assert kernels.launches["probe"] == before["probe"] + 1
    if case == "random" and R >= 300 and run_cap > 1:
        hist = args[7].cpu()
        assert (want.cpu() & ~hist).any()  # the runs made conflicts


def test_k5_run_conflicts_matches_plain_and_k1(cuda):
    rng = np.random.default_rng(6)
    args = _probe_case(rng, cuda, 5, 4, 256, 300, "random")[:7]
    r_ok = args[3]
    before = kernels.launches["probe"]
    got = kernels.run_conflicts(*args)
    assert kernels.launches["probe"] == before + 1
    assert _same(got, kernels.run_conflicts_plain(*args))
    assert _same(got, kernels.probe_fused(*args, torch.zeros_like(r_ok)))


def test_k2_intra_query_matches_plain(cuda):
    rng = np.random.default_rng(2)
    n, R = 1000, 700
    begs = torch.from_numpy(
        np.where(rng.random(n) < 0.4, rng.integers(0, 99, n), rmq.I32_MAX)
        .astype(np.int32)).to(cuda)
    tab = rmq.build_sparse_table(begs, torch.minimum, rmq.I32_MAX).contiguous()
    stab = torch.from_numpy(rng.integers(0, 1 << 30, n).astype(np.int32)).to(cuda)
    rb_r = torch.from_numpy(rng.integers(0, n, R).astype(np.int32)).to(cuda)
    re_r = torch.clamp(rb_r + torch.from_numpy(
        rng.integers(0, 300, R).astype(np.int32)).to(cuda), max=n - 1)
    assert _same(kernels.intra_query(tab, stab, rb_r, re_r),
                 kernels.intra_query_plain(tab, stab, rb_r, re_r))


def _k3_case(rng, dev, case):
    """(main ks, recent rows, the branch every live block must take)."""
    W = 9 if case == "w9" else 5
    cap = 50 if case == "small_cap" else 1 << 16
    main = _rows(rng, cap, W)
    if cap > 50:  # a partly full main, as after a compaction
        main[int(0.6 * cap):] = 0xFFFFFFFF
    if case in ("staged", "w9"):  # one run's step rows, in key order
        b, e = _run(rng, 8192, W)
        rec = kernels.run_to_step_plain(keys.to_lanes(b), keys.to_lanes(e),
                                        torch.tensor(3, dtype=torch.int32))[0]
        return keys.to_lanes(main, dev), rec.to(dev), "staged"
    if case == "global":  # unsorted, spread over all of main
        rec = _rows(rng, 4096, W)
        rec = rec[rec[:, -1] != 0xFFFFFFFF][rng.permutation(4000)]
        return keys.to_lanes(main, dev), keys.to_lanes(rec, dev), "global"
    if case == "all_sentinel":
        rec = np.full((1000, W), 0xFFFFFFFF, np.uint32)
        return keys.to_lanes(main, dev), keys.to_lanes(rec, dev), None
    # hits: queries equal to main rows (and the sentinel tail); small_cap:
    # main smaller than one block of queries
    rec = np.concatenate([_rows(rng, 300, W), main[rng.integers(0, len(main), 200)]])
    rec = rec[np.lexsort(rec.T[::-1])]
    return keys.to_lanes(main, dev), keys.to_lanes(rec, dev), None


def _k3_branches(ks, rec):
    """Per block of K3: the main rows between its least and greatest rank
    staged in shared memory, or searched in global memory."""
    plan = kernels.plan_ranks(ks.shape[1])
    ranks = kernels.compact_ranks_plain(ks.cpu(), rec.cpu()).long()
    spans = [int(b.max() - b.min()) for b in ranks.split(plan.queries)]
    return ("staged" if s <= plan.span_rows else "global" for s in spans if s)


K3_CASES = ["staged", "global", "all_sentinel", "hits", "w9", "small_cap"]


@pytest.mark.parametrize("case", K3_CASES)
def test_k3_compact_ranks_matches_plain(cuda, case):
    rng = np.random.default_rng(100 + K3_CASES.index(case))
    ks, rec, branch = _k3_case(rng, cuda, case)
    if branch is not None:  # the inputs drive the branch the case names
        taken = list(_k3_branches(ks, rec))
        assert taken.count(branch) >= len(taken) - 1 and taken.count(branch) > 0
    before = kernels.launches["compact_ranks"]
    got = kernels.compact_ranks(ks, rec)
    assert kernels.launches["compact_ranks"] == before + 1
    assert _same(got, kernels.compact_ranks_plain(ks, rec))


def _fixpoint_keys(xs):
    return keys.encode_keys([int(x).to_bytes(4, "big") for x in xs], 16)


def _fixpoint_case(rng, dev, case):
    """K2's arguments, as phase_intra hands them over: the ranks of seeded
    key rows (_intra_setup), r_idx and w_idx int64."""
    if case == "chain":  # txn t reads the key txn t - 1 writes
        B = R = Wn = 1024
        t = np.arange(B)
        rb = np.where(t > 0, 10 * (t - 1), 10 * B + 5)
        wb = 10 * t
        rb, re_, wb, we = rb, rb + 1, wb, wb + 1
        r_tx = w_tx = t.astype(np.int32)
        active, hist = np.ones(B, bool), np.zeros(B, bool)
    else:
        B, R, Wn, width = {"random": (256, 512, 256, 1 << 7),
                           "no_writes": (256, 512, 256, 1 << 7),
                           "ragged": (300, 1000, 333, 1 << 7),
                           "tiny": (2, 1, 1, 1),
                           "stream": (8192, 16384, 8192, 1),
                           "side_stream": (256, 512, 256, 1 << 7)}[case]
        span = 1 << (20 if case == "stream" else 12)
        rb, wb = rng.integers(0, span, R), rng.integers(0, span, Wn)
        re_ = rb + rng.integers(1, width + 1, R)
        we = wb + rng.integers(1, width + 1, Wn)
        r_tx = rng.integers(-1 if case != "stream" else 0, B, R).astype(np.int32)
        w_tx = rng.integers(-1 if case != "stream" else 0, B, Wn).astype(np.int32)
        if case == "no_writes":
            w_tx[:] = -1
        if case == "tiny":
            rb[:], re_[:], wb[:], we[:], r_tx[:], w_tx[:] = 5, 9, 3, 7, 1, 0
        active = rng.random(B) < (1.0 if case in ("stream", "tiny") else 0.9)
        hist = (rng.random(B) < (0.0 if case == "tiny" else 0.1)) & active
    rows = [keys.to_lanes(_fixpoint_keys(a), dev) for a in (rb, re_, wb, we)]
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    return (*tdev._intra_setup(*rows), t(r_tx >= 0), t(w_tx >= 0),
            t(np.clip(r_tx, 0, B - 1).astype(np.int64)),
            t(np.clip(w_tx, 0, B - 1).astype(np.int64)), t(w_tx), t(active),
            t(hist), B)


FIXPOINT_CASES = ["random", "chain", "no_writes", "ragged", "tiny", "stream",
                  "side_stream"]


@pytest.mark.parametrize("case", FIXPOINT_CASES)
def test_k2_intra_fixpoint_matches_plain_and_the_query_loop(cuda, case):
    """K2, the whole fixpoint in one cooperative launch, equals its plain
    version and the host loop around the per-query kernel it replaced:
    the same bits and the same iteration count, one launch; on a side
    stream as on the default one."""
    rng = np.random.default_rng(40 + FIXPOINT_CASES.index(case))
    fx = _fixpoint_case(rng, cuda, case)
    before = dict(kernels.launches)
    if case == "side_stream":
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            torch.cuda._sleep(20_000_000)  # the launch waits behind it
            got = kernels.intra_fixpoint(*fx)
        torch.cuda.current_stream().wait_stream(side)
    else:
        got = kernels.intra_fixpoint(*fx)
    assert kernels.launches["intra_fixpoint"] == before["intra_fixpoint"] + 1
    want = kernels.intra_fixpoint_plain(*fx)
    loop = kernels.intra_fixpoint_plain(*fx, query=kernels.intra_query)
    n = int(want[1])
    assert kernels.launches["intra_query"] == before["intra_query"] + n
    for bits, count in (want, loop):
        assert _same(got[0], bits) and int(got[1]) == int(count)
    assert got[1].device.type == "cuda" and got[1].dtype == torch.int32
    if case == "chain":
        assert n >= 1000 and int(got[0].sum()) == 512
    if case == "no_writes":
        assert n == 1 and not got[0].any()
    if case == "tiny":  # txn 1 reads what txn 0 writes
        assert n == 2 and got[0].tolist() == [False, True]


@pytest.mark.parametrize("W", [5, 9])
@pytest.mark.parametrize("K", [1, 3, 8])
def test_k4_run_to_step_runs_matches_plain(cuda, K, W):
    """K4 over all runs in one launch, a dead (version 0) and an empty
    (all-sentinel) run among them, equals its plain version."""
    rng = np.random.default_rng(10 * K + W)
    runs = [_run(rng, 512, W) for _ in range(K)]
    runs_b = np.stack([r[0] for r in runs])
    runs_e = np.stack([r[1] for r in runs])
    if K > 1:
        runs_b[1] = runs_e[1] = 0xFFFFFFFF
    ver = rng.integers(1, 30, K).astype(np.int32)
    ver[-1] = 0 if K > 2 else ver[-1]
    args = (keys.to_lanes(runs_b, cuda), keys.to_lanes(runs_e, cuda),
            torch.from_numpy(ver).to(cuda))
    before = kernels.launches["run_to_step"]
    rows, vals = kernels.run_to_step_runs(*args)
    assert kernels.launches["run_to_step"] == before + 1
    p_rows, p_vals = kernels.run_to_step_runs_plain(*args)
    assert _same(rows, p_rows) and _same(vals, p_vals)


def test_k4_run_to_step_matches_plain(cuda):
    rng = np.random.default_rng(4)
    b, e = _run(rng, 512)
    u_b, u_e = keys.to_lanes(b, cuda), keys.to_lanes(e, cuda)
    ver = torch.tensor([0, 17], dtype=torch.int32, device=cuda)
    for s in range(2):
        rows, vals = kernels.run_to_step(u_b, u_e, ver[s])
        p_rows, p_vals = kernels.run_to_step_plain(u_b, u_e, ver[s])
        assert _same(rows, p_rows) and _same(vals, p_vals)


def test_wrapper_rejects_bad_cuda_inputs(cuda):
    ks = torch.zeros((8, 5), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        kernels.compact_ranks(ks, ks.to(torch.int64))
    with pytest.raises(ValueError):
        kernels.compact_ranks(ks, ks.t())  # wrong shape
    with pytest.raises(ValueError):
        kernels.compact_ranks(ks, torch.zeros((5, 8), dtype=torch.int32,
                                              device=cuda).t())  # not contiguous
    fx = list(_fixpoint_case(np.random.default_rng(0), cuda, "random"))
    bad = {6: fx[6].to(torch.int32),           # r_idx must be int64
           0: fx[0][:-1],                       # rb_r shorter than r_ok
           9: fx[9].repeat(2)[::2],             # active not contiguous
           10: fx[10].cpu()}                    # hist on another device
    for i, arg in bad.items():
        with pytest.raises((TypeError, ValueError)):
            kernels.intra_fixpoint(*fx[:i], arg, *fx[i + 1:])
    runs = torch.zeros((3, 4, 5), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kernels.run_to_step_runs(runs, runs, torch.zeros(2, dtype=torch.int32,
                                                         device=cuda))


def test_set_on_cuda_matches_set_on_cpu(cuda):
    """One randomized stream through the port on "cuda" and on "cpu":
    identical verdicts and state, and every kernel launched."""
    rng = random.Random(5)

    def key():
        return bytes(rng.choice(b"abcdefgh") for _ in range(rng.randrange(7)))

    def rng_range():
        k = key()
        return (k, k + b"\x00") if rng.random() < 0.6 else (k, k + key() + b"\x00")

    small = dict(capacity=1 << 6, run_slots=3, run_capacity=64)
    on_gpu = tdev.DeviceConflictSet(**small, device="cuda")
    on_cpu = tdev.DeviceConflictSet(**small, device="cpu")
    kernels.reset_launches()
    version = 0
    for _ in range(16):
        version += rng.randrange(1, 5)
        txns = [TxInfo(rng.randrange(max(on_cpu.oldest_version, version - 12), version),
                       [rng_range() for _ in range(rng.randrange(4))],
                       [rng_range() for _ in range(rng.randrange(3))])
                for _ in range(rng.randrange(1, 40))]
        assert on_gpu.resolve_batch(version, txns) == on_cpu.resolve_batch(version, txns)
        if rng.random() < 0.3:
            on_gpu.remove_before(version - 6)
            on_cpu.remove_before(version - 6)
    a, b = on_gpu.export_state(), on_cpu.export_state()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    # K5 and the per-query intra kernel are off the set's path (referees)
    assert all(kernels.launches[k] > 0 for k in kernels.launches
               if k not in ("probe", "intra_query")), kernels.launches
    assert kernels.launches["intra_query"] == kernels.launches["probe"] == 0


def test_set_on_cuda_reads_no_fixpoint_flag(cuda):
    """The fixpoint's iterations add no host sync: a flat set on the card
    reads one value a synchronous batch (its verdicts) however long the
    fixpoint runs, and its iteration total (one more read) equals the
    same set's on the CPU."""
    chain = [TxInfo(0, [(b"k%04d" % (t - 1), b"k%04d\x00" % (t - 1))] if t else [],
                    [(b"k%04d" % t, b"k%04d\x00" % t)]) for t in range(300)]
    sets = [tdev.DeviceConflictSet(run_slots=8, device=d) for d in ("cuda", "cpu")]
    for s in sets:
        for version in range(1, 6):  # no compaction: 5 of 8 run slots
            s.resolve_batch(version, chain[: 60 * version])
    on_gpu, on_cpu = sets
    assert on_gpu.host_syncs == 5  # one a batch
    iters = on_gpu.fixpoint_iterations()
    assert iters == on_cpu.fixpoint_iterations() > 5 * 50
    assert on_gpu.host_syncs == 6


def _best_known_stream(seed, n_batches=14):
    rng = random.Random(seed)

    def key():
        return bytes(rng.choice(b"abcdefgh") for _ in range(rng.randrange(7)))

    def rng_range():
        k = key()
        return (k, k + b"\x00") if rng.random() < 0.6 else (k, k + key() + b"\x00")

    version, out = 0, []
    for i in range(n_batches):
        version += rng.randrange(1, 5)
        txns = [TxInfo(max(version - rng.randrange(1, 12), 0),
                       [rng_range() for _ in range(rng.randrange(4))],
                       [rng_range() for _ in range(rng.randrange(3))])
                for _ in range(rng.randrange(1, 40))]
        out.append((version, txns, version - 6 if i % 4 == 3 else None))
    return out


BEST_SMALL = dict(lsm=True, search_impl="bucket", capacity=1 << 11,
                  run_slots=3, run_capacity=64)


def test_best_known_pipelined_on_cuda_matches_cpu(cuda):
    """The best-known set on "cuda", through resolve_deferred (waited one
    behind, GC between) and through PipelinedPacker + BatchStager feeding
    resolve_arrays(sync=False): verdicts and final state equal the same
    set's on "cpu", and the pipelined stream launched K1-K4."""
    stream = _best_known_stream(8)
    on_cpu = tdev.DeviceConflictSet(**BEST_SMALL, device="cpu")
    wants = []
    for version, txns, floor in stream:
        wants.append(on_cpu.resolve_batch(version, txns))
        if floor is not None:
            on_cpu.remove_before(floor)
    kernels.reset_launches()
    deferred = tdev.DeviceConflictSet(**BEST_SMALL, device="cuda")
    handles = []
    for i, (version, txns, floor) in enumerate(stream):
        handles.append(deferred.resolve_deferred(version, txns))
        if i:
            assert handles[i - 1].wait() == wants[i - 1]
        if floor is not None:
            deferred.remove_before(floor)
    assert handles[-1].wait() == wants[-1]
    assert all(kernels.launches[k] > 0 for k in
               ("probe_fused", "intra_fixpoint", "compact_ranks", "run_to_step"))

    staged_set = tdev.DeviceConflictSet(**BEST_SMALL, device="cuda")
    floors = {}  # the MVCC floor each batch is packed against
    floor = 0
    for version, _txns, f in stream:
        floors[version] = floor
        floor = f if f is not None else floor
    stager = tdev.BatchStager("cuda")
    packer = tpipe.PipelinedPacker(
        lambda item: tdev.pack_batch(item[1], floors[item[0]],
                                     lambda v: max(v - floors[item[0]], 0), 32),
        depth=2, stage=stager)
    got, submitted = [], 0
    try:
        for i, (version, txns, f) in enumerate(stream):
            while submitted < len(stream) and submitted <= i + 1:
                packer.submit(stream[submitted][:2])
                submitted += 1
            assert staged_set._base == floors[version]
            got.append(staged_set.resolve_arrays(version, *packer.get().take(),
                                                 sync=False))
            if f is not None:
                staged_set.remove_before(f)
    finally:
        packer.close()
    staged_set.check_pipelined()
    for (version, txns, _f), want, verdict in zip(stream, wants, got):
        assert [int(c) for c in verdict[: len(txns)].cpu()] == [int(w) for w in want]
    for s in (deferred, staged_set):
        a, b = s.export_state(), on_cpu.export_state()
        for k in b:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_stager_orders_staging_after_its_copy(cuda):
    """Batches staged while the consumer's stream sits idle and the
    stager's stream is held back before each copy: every tensor a batch
    hands out, the active mask included, equals the CPU's staging of that
    batch, and the active mask changes from one batch to the next."""
    rng = np.random.default_rng(9)
    R, W, Wn, Bp = 4096, 5, 2048, 1024
    stager = tdev.BatchStager("cuda")
    masks = []
    for _ in range(6):
        packed = (rng.integers(0, 1 << 32, (R, W), dtype=np.uint32),
                  rng.integers(0, 1 << 32, (R, W), dtype=np.uint32),
                  rng.integers(-1, Bp, R).astype(np.int32),
                  rng.integers(0, 1 << 32, (Wn, W), dtype=np.uint32),
                  rng.integers(0, 1 << 32, (Wn, W), dtype=np.uint32),
                  rng.integers(-1, Bp, Wn).astype(np.int32),
                  rng.integers(0, 1 << 20, Bp).astype(np.int32),
                  rng.random(Bp) < 0.5)
        masks.append(packed[7])
        torch.cuda.current_stream().synchronize()  # the consumer sits idle
        with torch.cuda.stream(stager._stream):
            torch.cuda._sleep(50_000_000)  # the copy lands late
        got = stager(packed).take()
        want = tdev.stage_batch(torch.device("cpu"), *packed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    assert all(not np.array_equal(a, b) for a, b in zip(masks, masks[1:]))


def test_deferred_recovery_on_cuda(cuda):
    """A deep 16-bit-prefix bucket compacted into main, then probed through
    resolve_deferred: the deferred check fails on the card and the window
    recovers to the oracle's verdicts."""
    from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet

    zz = [b"ZZ%04d" % i for i in range(3000)]
    stream = [(10, [TxInfo(0, [], [(k, k + b"\x00")]) for k in zz])]
    for v in (20, 30, 40):
        stream.append((v, [TxInfo(v - 5, [(b"b%d" % v, b"c")], [(b"d%d" % v, b"e")])]))
    probes = [(b"ZZ%04d" % i, b"ZZ%04d" % (i + 1)) for i in range(7, 3000, 97)]
    stream.append((50, [TxInfo(45, probes, [(b"q", b"q\x00")])]))
    oracle = OracleConflictSet()
    s = tdev.DeviceConflictSet(lsm=True, search_impl="bucket", capacity=1 << 14,
                               run_slots=2, device="cuda")
    recovers = coverage.hits("kernel.pipeline_recover")
    handles = [s.resolve_deferred(v, t) for v, t in stream]
    for (v, t), h in zip(stream, handles):
        assert h.wait() == oracle.resolve_batch(v, t)
    assert coverage.hits("kernel.pipeline_recover") == recovers + 1
    assert s.search_fallbacks >= 1


def _mixed_stream(seed, n_batches, n_txns=40):
    """(version, txns, GC floor or None): variable-length keys, point and
    short ranges, snapshots a few versions back, GC now and then."""
    rng = random.Random(seed)

    def key():
        return bytes(rng.choice(b"abcdefgh") for _ in range(rng.randrange(7)))

    def rng_range():
        k = key()
        return (k, k + b"\x00") if rng.random() < 0.6 else (k, k + key() + b"\x00")

    version = oldest = 0
    for _ in range(n_batches):
        version += rng.randrange(1, 5)
        txns = [TxInfo(rng.randrange(max(oldest, version - 12), version),
                       [rng_range() for _ in range(rng.randrange(4))],
                       [rng_range() for _ in range(rng.randrange(3))])
                for _ in range(rng.randrange(1, n_txns))]
        floor = version - 6 if rng.random() < 0.3 else None
        oldest = max(oldest, floor or 0)
        yield version, txns, floor


def _same_state(a, b):
    sa, sb = a.export_state(), b.export_state()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert np.array_equal(np.asarray(sa[k]), np.asarray(sb[k])), k


def _twins(cls, stream, **args):
    """The stream through `cls` on "cuda" and on "cpu": identical verdicts
    every batch.  Returns (cuda set, cpu set, launches on the cuda run)."""
    on_gpu, on_cpu = cls(device="cuda", **args), cls(device="cpu", **args)
    kernels.reset_launches()
    for version, txns, floor in stream:
        assert on_gpu.resolve_batch(version, txns) == on_cpu.resolve_batch(version, txns)
        if floor is not None:
            on_gpu.remove_before(floor)
            on_cpu.remove_before(floor)
    torch.cuda.synchronize()
    return on_gpu, on_cpu, dict(kernels.launches)


@pytest.mark.parametrize("merge", ["scatter", "sort", "gather"])
@pytest.mark.parametrize("lsm", [False, True], ids=["flat", "lsm"])
def test_legacy_set_on_cuda_matches_cpu(cuda, lsm, merge):
    """The legacy layouts on the card equal the CPU over a few batches
    that regrow main (flat) or compact the recent level (LSM): K2 once a
    batch, K3 once a compaction on the scatter and gather folds."""
    args = dict(incremental=False, lsm=lsm, merge_impl=merge, capacity=16,
                recent_capacity=129, search_impl="bucket")
    on_gpu, on_cpu, launches = _twins(tdev.DeviceConflictSet, _mixed_stream(3, 10),
                                      **args)
    _same_state(on_gpu, on_cpu)
    assert on_gpu.node_count == on_cpu.node_count
    assert on_gpu.fixpoint_iterations() == on_cpu.fixpoint_iterations()
    assert launches["intra_fixpoint"] >= 10 and launches["probe_fused"] == 0
    if lsm:
        assert on_gpu.stats.compactions >= 1
        assert (launches["compact_ranks"] >= on_gpu.stats.compactions) == (merge != "sort")
    else:
        assert on_gpu.capacity > 16


@pytest.mark.parametrize("mode", ["inc", "inc_lsm", "legacy", "legacy_lsm"])
def test_sharded_set_on_cuda_matches_cpu(cuda, mode):
    """The 4-partition set on the card equals the CPU, state per partition
    included; K1 and K2 launch once a partition a batch on the incremental
    path, K4 once a partition a compaction and K3 once a folded run."""
    args = dict(incremental=mode.startswith("inc"), lsm=mode.endswith("lsm"),
                capacity=16, run_slots=2, run_capacity=16, recent_capacity=33)
    on_gpu, on_cpu = (tsh.ShardedDeviceConflictSet([b"b", b"d", b"f"], devices=[d], **args)
                      for d in ("cuda", "cpu"))
    kernels.reset_launches()
    batches = list(_mixed_stream(9, 5))
    for version, txns, floor in batches:
        assert on_gpu.resolve_batch(version, txns) == on_cpu.resolve_batch(version, txns)
        if floor is not None:
            on_gpu.remove_before(floor)
            on_cpu.remove_before(floor)
    torch.cuda.synchronize()
    _same_state(on_gpu, on_cpu)
    assert on_gpu.fixpoint_iterations() == on_cpu.fixpoint_iterations()
    n = len(batches)
    assert kernels.launches["intra_fixpoint"] >= 4 * n
    if args["incremental"]:
        assert on_gpu.compactions >= 1
        assert kernels.launches["probe_fused"] >= 4 * n
        assert kernels.launches["run_to_step"] == 4 * on_gpu.compactions
        assert kernels.launches["compact_ranks"] >= 4 * on_gpu.compactions


def test_phase_timing_on_cuda_matches_untimed(cuda):
    """phase_timing on the card: the same verdicts, state and iterations
    as the untimed set, with the three phase times filled."""
    args = dict(lsm=True, search_impl="bucket", capacity=1 << 8, run_slots=3,
                run_capacity=64)
    stream = list(_mixed_stream(4, 8))
    plain, _cpu, _l = _twins(tdev.DeviceConflictSet, stream, **args)
    timed, _cpu, _l = _twins(tdev.DeviceConflictSet, stream, phase_timing=True, **args)
    _same_state(plain, timed)
    assert plain.fixpoint_iterations() == timed.fixpoint_iterations()
    phase = timed.kernel_stats()["phase"]
    assert min(phase["sort_ms"], phase["scan_ms"], phase["merge_ms"]) > 0


def _role_stream(n=12, txns=200):
    """Seeded version-chained batches of 2 point reads and 1 point write
    over 2**10 16-byte keys (phase 14's stream, small)."""
    import chip_smoke

    pool, succ = chip_smoke.key_pool(np.random.default_rng(14), 1 << 10)
    return chip_smoke.stream_batches(TxInfo, np.random.default_rng(15), pool, succ, n,
                                     txns=txns)


def _role_fdb():
    from foundationdb_tpu_torch.roles import resolver, types
    from foundationdb_tpu_torch.rpc import network, stream, transport
    from foundationdb_tpu_torch.runtime import combinators, core, knobs

    return dict(core=core, knobs=knobs, combinators=combinators, types=types,
                resolver=resolver,
                rpc=dict(network=network, stream=stream, transport=transport))


ROLE_SET = dict(lsm=True, search_impl="bucket", max_key_bytes=16, capacity=1 << 12,
                run_slots=4, run_capacity=1024)


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_role_on_cuda_matches_the_role_on_cpu(cuda, pipeline):
    """The port's Resolver on a SimNetwork, every batch in flight, over the
    best-known set on "cuda" and on "cpu": the same replies at the same
    virtual times, the same final state, K1 and K2 once a batch."""
    import chip_smoke

    batches = _role_stream()
    fdb = _role_fdb()
    requests = chip_smoke.role_requests(fdb["types"], batches)
    out = {}
    for dev in ("cuda", "cpu"):
        cs = tdev.DeviceConflictSet(**ROLE_SET, device=dev)
        kernels.reset_launches()
        role, _net, _clock, replies = chip_smoke.sim_role_run(fdb, cs, requests, pipeline)
        torch.cuda.synchronize()
        out[dev] = (replies, dict(kernels.launches), cs)
        role.stop()
    assert out["cuda"][0] == out["cpu"][0]
    launches = out["cuda"][1]
    assert launches["probe_fused"] == launches["intra_fixpoint"] == len(batches)
    assert launches["run_to_step"] == out["cuda"][2].stats.compactions >= 2
    chip_smoke.same_state(out["cuda"][2], out["cpu"][2], "role")


def test_supervised_role_over_loopback_tcp_serves_from_the_card(cuda):
    """The port's Resolver on a RealNetwork hosting the DeviceSupervisor
    over the best-known set on "cuda" (the role arms the wall watchdog),
    a proxy RealNetwork sending one batch at a time through one
    WallDriver: the replies are the set's in the role's order on "cpu",
    the supervisor stays healthy with 0 trips, and the card serves every
    batch."""
    import chip_smoke
    from foundationdb_tpu_torch.conflict.supervisor import DeviceSupervisor

    batches = _role_stream(n=10)
    fdb = _role_fdb()
    want = chip_smoke.role_order_verdicts(
        tdev.DeviceConflictSet(**ROLE_SET, device="cpu"), batches, chip_smoke.GC_LAG)
    transport, core = fdb["rpc"]["transport"], fdb["core"]
    loop = core.EventLoop()
    server = transport.RealNetwork(loop, "resolver")
    client = transport.RealNetwork(loop, "proxy")
    role = None
    try:
        sup = DeviceSupervisor(lambda oldest=0: tdev.DeviceConflictSet(
            oldest, **ROLE_SET, device="cuda"))
        kernels.reset_launches()
        role = fdb["resolver"].Resolver(server.process, loop,
                                        chip_smoke.role_knobs(fdb["knobs"]), sup)
        assert sup._watchdog.wall
        ref = fdb["rpc"]["stream"].RequestStreamRef(client, client.process,
                                                    role.stream.endpoint)
        driver = transport.WallDriver(loop, [server.pump, client.pump])

        async def one(req):
            return (await ref.get_reply(req)).committed

        got = [driver.run_until(loop.spawn(one(r)), wall_timeout=120.0)
               for r in chip_smoke.role_requests(fdb["types"], batches)]
        assert got == want
        h = sup.health()
        assert h["state"] == "healthy" and h["serving"] == "device" and h["trips"] == 0
        assert kernels.launches["probe_fused"] == len(batches)
    finally:
        if role is not None:
            role.stop()
        server.close()
        client.close()
