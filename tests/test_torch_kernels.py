"""The plain torch versions of the port's kernels (K1-K5 of
foundationdb_tpu_torch/conflict/kernels.py, with K2's per-query referee and
K4's one-run case), and the device phases around them, held against the reference's Pallas kernels in interpret mode and its
XLA paths, on seeded numpy inputs with sentinel and TOO_OLD rows.  All
integer: equality is exact.  Shapes stay tiny (interpret mode is slow)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

pytest.importorskip(
    "jax.experimental.pallas", reason="installed jax lacks Pallas support"
)

from foundationdb_tpu import keys as jkeys  # noqa: E402
from foundationdb_tpu.conflict import device as jdev  # noqa: E402
from foundationdb_tpu.conflict import pallas_kernel as pk  # noqa: E402
from foundationdb_tpu.ops import rmq as jrmq  # noqa: E402
from foundationdb_tpu_torch.conflict import device as tdev  # noqa: E402
from foundationdb_tpu_torch.conflict import kernels  # noqa: E402
from foundationdb_tpu_torch.keys import from_lanes, to_lanes  # noqa: E402
from foundationdb_tpu_torch.ops.search import lower_bound  # noqa: E402

SENT = np.uint32(0xFFFFFFFF)


def _intervals(rng, n, span=1 << 16, width=1 << 8, mkb=16):
    """n random [b, e) point-ish intervals as uint32 lane rows."""
    b = rng.integers(0, span, n)
    e = b + rng.integers(1, width, n)
    enc = lambda xs: jkeys.encode_keys([int(x).to_bytes(4, "big") for x in xs], mkb)  # noqa: E731
    return enc(b), enc(e)


def _run(rng, n_live, run_cap, mkb=16):
    """One run: sorted disjoint intervals, sentinel-padded to run_cap."""
    wb, we = _intervals(rng, 2 * n_live, mkb=mkb)
    w_ins = rng.random(2 * n_live) < 0.7
    u_b, u_e = jdev._union_intervals(
        jnp.asarray(wb), jnp.asarray(we), jnp.asarray(w_ins), run_cap=run_cap
    )
    return np.asarray(u_b), np.asarray(u_e)


def _t(a):
    """numpy -> torch, uint32 key rows as flipped lanes."""
    a = np.asarray(a)
    return to_lanes(a) if a.dtype == np.uint32 else torch.from_numpy(a.copy())


def _probe_inputs(seed, K=3, run_cap=128, R=64):
    rng = np.random.default_rng(seed)
    runs = [_run(rng, int(rng.integers(0, run_cap // 2)), run_cap) for _ in range(K)]
    runs_b = np.stack([r[0] for r in runs])
    runs_e = np.stack([r[1] for r in runs])
    runs_ver = rng.integers(0, 20, K).astype(np.int32)
    runs_ver[0] = 0  # a dead run
    rb, re_ = _intervals(rng, R)
    rb[-4:] = SENT  # padding reads
    re_[-4:] = SENT
    snap = rng.integers(0, 20, R).astype(np.int32)
    r_ok = rng.random(R) < 0.85
    r_ok[-4:] = False
    hist = (rng.random(R) < 0.2) & r_ok
    return rb, re_, snap, r_ok, runs_b, runs_e, runs_ver, hist


@pytest.mark.parametrize("seed", range(3))
def test_k1_probe_fused_plain_matches_pallas_and_xla(seed):
    args = _probe_inputs(seed)
    want_int = np.asarray(pk.run_conflicts_fused(*map(jnp.asarray, args),
                                                 impl="interpret"))
    want_xla = np.asarray(pk.run_conflicts_fused(*map(jnp.asarray, args),
                                                 impl="xla"))
    assert np.array_equal(want_int, want_xla)
    before = dict(kernels.launches)
    got = kernels.probe_fused(*map(_t, args))
    assert got.dtype == torch.bool
    assert np.array_equal(want_int, got.numpy())
    assert np.array_equal(got.numpy(), kernels.probe_fused_plain(*map(_t, args)).numpy())
    assert kernels.launches == before  # the CPU path launches no kernel


@pytest.mark.parametrize("seed", range(3))
def test_k5_run_conflicts_plain_matches_pallas_and_xla(seed):
    """K5's plain version equals the reference's unfused probe in interpret
    mode and its XLA lowering, and K1 with no history bit set."""
    rb, re_, snap, r_ok, runs_b, runs_e, runs_ver, _hist = _probe_inputs(seed)
    args = (rb, re_, snap, r_ok, runs_b, runs_e, runs_ver)
    want_int = np.asarray(pk.run_conflicts(*map(jnp.asarray, args), impl="interpret"))
    want_xla = np.asarray(pk.run_conflicts(*map(jnp.asarray, args), impl="xla"))
    assert np.array_equal(want_int, want_xla)
    assert want_int.any() and not want_int.all()
    before = dict(kernels.launches)
    got = kernels.run_conflicts(*map(_t, args))
    assert got.dtype == torch.bool
    assert np.array_equal(want_int, got.numpy())
    no_hist = torch.zeros(rb.shape[0], dtype=torch.bool)
    assert torch.equal(got, kernels.probe_fused(*map(_t, args), no_hist))
    assert kernels.launches == before  # the CPU path launches no kernel


def _intra_inputs(seed, n=96, R=32):
    rng = np.random.default_rng(seed)
    begs = np.where(rng.random(n) < 0.4, rng.integers(0, 40, n), jrmq.I32_MAX)
    beg_tab = np.asarray(jrmq.build_sparse_table(
        jnp.asarray(begs.astype(np.int32)), jnp.minimum, jrmq.I32_MAX))
    stab = np.where(rng.random(n) < 0.3, rng.integers(0, 40, n),
                    jrmq.I32_MAX).astype(np.int32)
    rb_r = rng.integers(0, n, R).astype(np.int32)
    re_r = np.minimum(rb_r + rng.integers(0, 30, R), n - 1).astype(np.int32)
    return beg_tab, stab, rb_r, re_r


@pytest.mark.parametrize("seed", range(3))
def test_k2_intra_query_plain_matches_pallas_and_xla(seed):
    args = _intra_inputs(seed)
    beg_tab, stab, rb_r, re_r = map(jnp.asarray, args)
    want_int = np.asarray(pk.intra_query(beg_tab, stab, rb_r, re_r, impl="interpret"))
    case1 = jrmq.query_sparse_table(beg_tab, rb_r + 1, re_r, jnp.minimum, jrmq.I32_MAX)
    want_xla = np.asarray(jnp.minimum(case1, jnp.take(stab, rb_r)))
    assert np.array_equal(want_int, want_xla)
    got = kernels.intra_query(*map(_t, args))
    assert got.dtype == torch.int32
    assert np.array_equal(want_int, got.numpy())


@pytest.mark.parametrize("seed", range(3))
def test_k3_compact_ranks_plain_matches_pallas_and_xla(seed):
    rng = np.random.default_rng(seed)
    cap = 256
    main_b, _ = _intervals(rng, 150, span=1 << 12)
    main = np.concatenate([np.unique(main_b, axis=0)])
    ks = np.full((cap, main.shape[1]), SENT, np.uint32)
    ks[0] = jkeys.encode_keys([b""], 16)[0]
    ks[1 : 1 + len(main)] = main
    u_b, u_e = _run(rng, 40, 64)
    rec = np.array(jdev.run_to_step(jnp.asarray(u_b), jnp.asarray(u_e),
                                    jnp.int32(5))[0])
    rec[:10] = ks[rng.integers(1, 1 + len(main), 10)]  # exact hits in main
    rec = rec[np.lexsort(rec.T[::-1])]
    want_int = np.asarray(pk.compact_ranks(jnp.asarray(ks), jnp.asarray(rec),
                                           impl="interpret"))
    want_xla = np.asarray(jdev._compact_ub(jnp.asarray(ks), jnp.asarray(rec),
                                           cap=cap))
    assert np.array_equal(want_int, want_xla)  # sentinel rows included
    got = kernels.compact_ranks(_t(ks), _t(rec))
    assert got.dtype == torch.int32
    assert np.array_equal(want_int, got.numpy())


@pytest.mark.parametrize("ver", [0, 7])
def test_k4_run_to_step_plain_matches_pallas_and_xla(ver):
    rng = np.random.default_rng(ver)
    u_b, u_e = _run(rng, 30, 64)
    want_int = pk.run_to_step_pallas(jnp.asarray(u_b), jnp.asarray(u_e),
                                     jnp.int32(ver), impl="interpret")
    want_xla = jdev.run_to_step(jnp.asarray(u_b), jnp.asarray(u_e), jnp.int32(ver))
    rows, vals = kernels.run_to_step(_t(u_b), _t(u_e),
                                     torch.tensor(ver, dtype=torch.int32))
    for want in (want_int, want_xla):
        assert np.array_equal(np.asarray(want[0]), from_lanes(rows))
        assert np.array_equal(np.asarray(want[1]), vals.numpy())


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("mkb", [16, 32], ids=["W5", "W9"])
def test_k4_run_to_step_runs_plain_matches_xla_run_by_run(K, mkb):
    """K4 over all runs of a compaction equals the reference's run_to_step
    run by run, a dead run (version 0) and an empty (all-sentinel) run
    among them; the one-run wrapper is its K = 1 case."""
    rng = np.random.default_rng(K + mkb)
    runs = [_run(rng, n, 64, mkb=mkb) for n in (30, 0, 12, 25, 1, 31, 7, 20)[:K]]
    runs_b = np.stack([r[0] for r in runs])
    runs_e = np.stack([r[1] for r in runs])
    runs_ver = np.array([9, 3, 0, 5, 1, 12, 4, 8][:K], dtype=np.int32)
    rows, vals = kernels.run_to_step_runs(_t(runs_b), _t(runs_e), _t(runs_ver))
    assert rows.shape == (K, 128, runs_b.shape[2]) and vals.shape == (K, 128)
    for k in range(K):
        want = jdev.run_to_step(jnp.asarray(runs_b[k]), jnp.asarray(runs_e[k]),
                                jnp.int32(runs_ver[k]))
        assert np.array_equal(np.asarray(want[0]), from_lanes(rows[k]))
        assert np.array_equal(np.asarray(want[1]), vals[k].numpy())
        one = kernels.run_to_step(_t(runs_b[k]), _t(runs_e[k]),
                                  torch.tensor(runs_ver[k]))
        assert torch.equal(one[0], rows[k]) and torch.equal(one[1], vals[k])


def _keys(xs):
    return jkeys.encode_keys([int(x).to_bytes(4, "big") for x in xs], 16)


def _intra_host(rb, re_, wb, we, r_tx, w_tx, active, hist, B):
    """phase_intra's arguments from key rows and txn ids, as inc_check
    derives them (r_idx and w_idx int64, as inc_check gives them)."""
    return (rb, re_, wb, we, r_tx >= 0, w_tx >= 0,
            np.clip(r_tx, 0, B - 1).astype(np.int64),
            np.clip(w_tx, 0, B - 1).astype(np.int64), w_tx, active, hist)


def _intra_random(trial):
    rng = np.random.default_rng(3 + 100 * trial)
    B, R, Wn = 32, 64, 64

    def intervals(n):
        b = rng.integers(0, 1 << 20, n)
        return _keys(b), _keys(b + rng.integers(1, 1 << 10, n))

    rb, re_ = intervals(R)
    wb, we = intervals(Wn)
    r_tx = rng.integers(-1, B, R).astype(np.int32)
    w_tx = rng.integers(-1, B, Wn).astype(np.int32)
    return _intra_host(rb, re_, wb, we, r_tx, w_tx, rng.random(B) < 0.9,
                       rng.random(B) < 0.2, B), B


def _intra_chain(B, n_live):
    """txn t writes key 10t and reads key 10(t-1), the key txn t-1 writes
    (txn 0 reads a key nobody writes); txns n_live..B-1 are padding.  The
    fixpoint settles about one txn of the chain an iteration."""
    t = np.arange(n_live)
    r = np.where(t > 0, 10 * (t - 1), 10 * n_live + 5)
    tx = t.astype(np.int32)
    return _intra_host(_keys(r), _keys(r + 1), _keys(10 * t), _keys(10 * t + 1),
                       tx, tx, np.arange(B) < n_live, np.zeros(B, bool), B), B


def _phase_intra_all(host, B):
    """(bits, count) from the reference's dense referee, XLA path and
    interpret-mode Pallas path, and from the port's phase_intra,
    phase_intra_dense and kernels.intra_fixpoint."""
    jargs = tuple(map(jnp.asarray, host)) + (B,)
    targs = tuple(map(_t, host)) + (B,)
    ranks = tdev._intra_setup(*targs[:4])
    out = {
        "ref_dense": jdev.phase_intra_dense(*jargs),
        "ref_xla": jdev.phase_intra(*jargs),
        "ref_interpret": jdev.phase_intra(*jargs, impl="interpret"),
        "phase_intra": tdev.phase_intra(*targs),
        "phase_intra_dense": tdev.phase_intra_dense(*targs),
        "intra_fixpoint": kernels.intra_fixpoint(*ranks, *targs[4:]),
    }
    return {k: (np.asarray(bits), int(np.asarray(n).reshape(-1)[0]))
            for k, (bits, n) in out.items()}


def _assert_intra_agree(host, B):
    got = _phase_intra_all(host, B)
    bits, n = got["ref_dense"]
    for name, (b, k) in got.items():
        assert np.array_equal(bits, b), name
        assert k == n, (name, k, n)
    return bits, n


@pytest.mark.parametrize("trial", range(4))
def test_phase_intra_bits_and_iterations_match(trial):
    """The port's rank-space fixpoint (kernels.intra_fixpoint, plain on the
    CPU) equals the reference's dense referee, its XLA path and its
    interpret-mode Pallas path: the same bits AND the same iteration
    count; the count is a device tensor on the CPU too."""
    host, B = _intra_random(trial)
    targs = tuple(map(_t, host)) + (B,)
    _intra, n_iters = tdev.phase_intra(*targs)
    assert n_iters.dtype == torch.int32 and n_iters.shape == (1,)
    _assert_intra_agree(host, B)


@pytest.mark.parametrize("case", ["chain", "chain_padded", "no_writes", "inactive"])
def test_intra_fixpoint_edge_cases_match(case):
    """A chain batch (a trajectory as long as the batch), the chain inside
    a padded batch, no live write, and every txn inactive: the same bits
    and count from the port as from the reference."""
    if case.startswith("chain"):
        host, B = _intra_chain(32, 32 if case == "chain" else 23)
    else:
        host, B = _intra_random(7)
        rb, re_, wb, we, r_ok, w_ok, r_idx, w_idx, w_tx, active, hist = host
        if case == "no_writes":
            w_tx = np.full_like(w_tx, -1)
            w_ok = w_tx >= 0
        else:
            active = np.zeros_like(active)
        host = (rb, re_, wb, we, r_ok, w_ok, r_idx, w_idx, w_tx, active, hist)
    bits, n = _assert_intra_agree(host, B)
    if case.startswith("chain"):
        assert n > 16 and bits.any()  # a long trajectory, and conflicts
    else:
        assert n == 1 and not bits.any()


@pytest.mark.parametrize("seed", range(3))
def test_search_ranks_and_union_match(seed):
    """phase_search_sort, _local_ranks and _union_intervals equal the
    reference's, sentinel rows and duplicate keys included."""
    rng = np.random.default_rng(50 + seed)
    cap, R, Wn = 128, 32, 32
    main = np.unique(_intervals(rng, 60, span=1 << 10)[0], axis=0)
    ks = np.full((cap, main.shape[1]), SENT, np.uint32)
    ks[0] = jkeys.encode_keys([b""], 16)[0]
    ks[1 : 1 + len(main)] = main
    count = 1 + len(main)
    rb, re_ = _intervals(rng, R, span=1 << 10)
    rb[:5] = main[:5]  # reads beginning exactly on boundaries
    rb[-3:] = SENT
    re_[-3:] = SENT
    empty = jnp.zeros((0, ks.shape[1]), jnp.uint32)
    r_ok = jnp.asarray(np.arange(R) < R - 3)
    g_lo, g_hi, *_ = jdev.phase_search_sort(
        jnp.asarray(ks), jnp.int32(count), jnp.asarray(rb), jnp.asarray(re_),
        empty, empty, r_ok, jnp.zeros((0,), bool))
    t_lo, t_hi = tdev.phase_search_sort(_t(ks), count, _t(rb), _t(re_))
    assert np.array_equal(np.asarray(g_lo), t_lo.numpy())
    assert np.array_equal(np.asarray(g_hi), t_hi.numpy())

    rows = np.concatenate([rb, re_, rb[:7]])  # duplicates share a rank
    assert np.array_equal(np.asarray(jdev._local_ranks(jnp.asarray(rows))),
                          tdev._local_ranks(_t(rows)).numpy())

    wb, we = _intervals(rng, Wn, span=1 << 10, width=1 << 6)
    wb[-2:] = SENT
    we[-2:] = SENT
    w_ins = (rng.random(Wn) < 0.7) & (np.arange(Wn) < Wn - 2)
    for run_cap in (32, 64, 128):
        want = jdev._union_intervals(jnp.asarray(wb), jnp.asarray(we),
                                     jnp.asarray(w_ins), run_cap=run_cap)
        got = tdev._union_intervals(_t(wb), _t(we), _t(w_ins), run_cap=run_cap)
        assert np.array_equal(np.asarray(want[0]), from_lanes(got[0]))
        assert np.array_equal(np.asarray(want[1]), from_lanes(got[1]))


@pytest.mark.parametrize("seed", range(3))
def test_compact_fold_matches_scatter_fold(seed):
    """compact_fold (K3 plain inside) equals the reference's scatter fold
    through the jitted compact_lsm — including a fold that overflows cap (new_count >
    cap, rows dropped for the regrow).  The reference's interpret-mode
    lowering differs only in K3, which the K3 test pins to the XLA one."""
    rng = np.random.default_rng(70 + seed)
    for cap in (256, 32):
        ks = np.full((cap, 5), SENT, np.uint32)
        ks[0] = jkeys.encode_keys([b""], 16)[0]
        main = np.unique(_intervals(rng, 40, span=1 << 10)[0], axis=0)[: cap // 2]
        ks[1 : 1 + len(main)] = main
        vs = np.zeros(cap, np.int32)
        vs[: 1 + len(main)] = rng.integers(0, 9, 1 + len(main))
        u_b, u_e = _run(rng, 20, 64)
        rows, vals = jdev.run_to_step(jnp.asarray(u_b), jnp.asarray(u_e), jnp.int32(11))
        t_ks, t_vs, t_n = tdev.compact_fold(_t(ks), _t(vs), _t(np.asarray(rows)),
                                            _t(np.asarray(vals)), cap=cap)
        want = jdev._compact_kernel(jnp.asarray(ks), jnp.asarray(vs), rows,
                                    vals, cap=cap, merge_impl="scatter",
                                    lowering="xla")
        assert np.array_equal(np.asarray(want[0]), from_lanes(t_ks))
        assert np.array_equal(np.asarray(want[1]), t_vs.numpy())
        assert int(want[2]) == int(t_n)
        if cap == 32:
            assert int(t_n) > cap  # the overflow case really ran


def test_plan_probe_at_the_streams_shapes():
    """K1 at the stream's shapes: 128 reads x 8 runs a block, the
    summary every 512th begin (5 KB at W=5, 9 KB at W=9)."""
    assert kernels.plan_probe(8, 1 << 14, 5) == kernels.ProbePlan(
        group_log2=3, stride_log2=9, n_sum=32, threads=1024, smem=10240)
    assert kernels.plan_probe(8, 1 << 14, 9).smem == 8 * 32 * 36 + 2 * 128 * 36


@pytest.mark.parametrize("K,run_cap,W", [(1, 1, 5), (1, 64, 5), (2, 100, 5),
                                         (3, 127, 9), (8, 129, 5), (8, 1 << 16, 9),
                                         (8, 1 << 20, 5), (33, 1 << 14, 5),
                                         (64, 3000, 9), (0, 64, 5)])
def test_plan_probe_geometry(K, run_cap, W):
    """Any accepted shape: a read's lanes (K rounded up, <= 32) share one
    warp, the block fits, and the summary's windows cover the run."""
    p = kernels.plan_probe(K, run_cap, W)
    G, S = 1 << p.group_log2, 1 << p.stride_log2
    assert G >= min(K, 32) and G <= max(2 * K - 1, 1) and 32 % G == 0
    assert p.threads % 32 == 0 and p.threads <= kernels.PROBE_MAX_THREADS
    assert (p.threads // G) * G == p.threads
    assert kernels.PROBE_MIN_STRIDE <= S <= kernels.PROBE_MAX_STRIDE
    assert (p.n_sum - 1) * S < run_cap <= p.n_sum * S or run_cap == p.n_sum == 0
    summary = K * p.n_sum * W * 4
    assert summary <= kernels.PROBE_SUMMARY_BYTES
    assert p.smem == summary + 2 * (p.threads // G) * W * 4 <= kernels.SMEM_MAX
    if S > kernels.PROBE_MIN_STRIDE:  # the least stride that fits
        assert K * -(-run_cap // (S // 2)) * W * 4 > kernels.PROBE_SUMMARY_BYTES


@pytest.mark.parametrize("seed", range(3))
def test_plan_probe_windows_hold_the_rank(seed):
    """The window K1 searches after its summary count c, rows
    [(c-1)S + 1, min(cS, run_cap)), holds #begins < q whenever c > 0, and
    c == 0 means that count is 0: on runs shorter than, equal to and
    longer than one stride, sentinel tails included."""
    rng = np.random.default_rng(seed)
    for run_cap in (1, 100, 128, 300, 1024):
        b, _ = _run(rng, int(rng.integers(0, run_cap // 2 + 1)), run_cap)
        begins = _t(b)
        p = kernels.plan_probe(8, run_cap, begins.shape[1])
        S = 1 << p.stride_log2
        q, _ = _intervals(rng, 64)
        q[:8] = b[rng.integers(0, run_cap, 8)]  # queries equal to begins
        q = _t(q)
        rank = lower_bound(begins, q).long()
        c = lower_bound(begins[::S].contiguous(), q).long()
        assert torch.equal(c == 0, rank == 0)
        hit = c > 0
        lo = (c - 1) * S + 1
        hi = torch.clamp(c * S, max=run_cap)
        assert bool(((lo <= rank) & (rank <= hi))[hit].all())


@pytest.mark.parametrize("K,run_cap,W", [(8, 1 << 26, 9), (3000, 64, 5), (8, 64, 300)])
def test_plan_probe_raises_where_no_summary_fits(K, run_cap, W):
    """Where no summary fits 40 KB even at the widest stride, K1 plans
    none (n_sum = 0: each read end is ranked against the whole run);
    where the reads' rows outgrow the block, it stages fewer reads.  It
    raises only where one read's two rows exceed a block."""
    p = kernels.plan_probe(K, run_cap, W)
    summary = K * p.n_sum * W * 4
    assert summary <= kernels.PROBE_SUMMARY_BYTES
    assert p.n_sum == 0 or K * -(-run_cap >> p.stride_log2) * W * 4 == summary
    if K * -(-run_cap // kernels.PROBE_MAX_STRIDE) * W * 4 > kernels.PROBE_SUMMARY_BYTES:
        assert p.n_sum == 0
    reads = p.threads >> p.group_log2
    assert p.smem == summary + 2 * reads * W * 4 <= kernels.SMEM_MAX
    most = min(kernels.PROBE_READS, kernels.PROBE_MAX_THREADS >> p.group_log2)
    assert reads == most or summary + 4 * reads * W * 4 > kernels.SMEM_MAX
    big = kernels.SMEM_MAX // 8 + 1
    with pytest.raises(ValueError, match=f"K={K}, run_cap={run_cap}, W={big}"):
        kernels.plan_probe(K, run_cap, big)


@pytest.mark.parametrize("W", [2, 5, 9, 65, 300])
def test_plan_ranks(W):
    """K3: 128 queries a block; at W=5 the span a block stages holds the
    stream's ~3.6K main rows per 128 step rows, two blocks an SM."""
    p = kernels.plan_ranks(W)
    fixed = kernels.RANKS_THREADS * 4 * W + 16 + 4 * (-(-2 * W // 4) * 4) + 12
    assert p.smem == fixed + p.span_rows * 4 * W <= kernels.SMEM_MAX
    assert p.span_rows == 0 or p.smem <= kernels.RANKS_SMEM
    if W == 5:
        assert p.span_rows >= 4000 and 2 * p.smem <= 228 * 1024


def test_plan_ranks_raises_where_the_queries_do_not_fit():
    """At W = 500 the 128 query rows outgrow a block, so a block takes 64;
    where not even one query row fits, the plan raises."""
    p = kernels.plan_ranks(500)
    assert p.queries == 64 and p.span_rows == 0 and p.smem <= kernels.SMEM_MAX
    with pytest.raises(ValueError, match="W=20000"):
        kernels.plan_ranks(20000)


def test_wrappers_take_plain_only_on_cpu_and_reject_other_devices():
    """A CPU tensor takes the plain version (no launch counted); a tensor
    on any device other than cuda or cpu is refused."""
    args = _probe_inputs(0)
    kernels.reset_launches()
    kernels.probe_fused(*map(_t, args))
    assert all(v == 0 for v in kernels.launches.values())
    meta = torch.empty((4, 5), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.compact_ranks(meta, meta)


def test_counted_adds_a_sets_own_launches_once():
    """`kernels.counted` adds the launches made inside a set's method to
    that set's `stats.launches` (and leaves them in the process-wide
    count); a call nested in the same set's counts once, and another
    set's launches stay out of it."""
    from foundationdb_tpu_torch.conflict.api import KernelStats

    class FakeSet:
        def __init__(self):
            self.stats = KernelStats(launches=dict.fromkeys(kernels.launches, 0))

        @kernels.counted
        def resolve(self, n, inner=None, other=None):
            kernels.launches["probe_fused"] += n
            if inner:
                self.resolve(inner)
            if other is not None:
                other.resolve(5)
            kernels.launches["compact_ranks"] += 1

    saved = dict(kernels.launches)
    try:
        kernels.reset_launches()
        a, b = FakeSet(), FakeSet()
        a.resolve(2, inner=3, other=b)
        a.resolve(1)
        assert a.stats.launches == dict(dict.fromkeys(kernels.launches, 0),
                                        probe_fused=6, compact_ranks=3)
        assert b.stats.launches == dict(dict.fromkeys(kernels.launches, 0),
                                        probe_fused=5, compact_ranks=1)
        assert kernels.launches["probe_fused"] == 11
        assert kernels.launches["compact_ranks"] == 4
        assert a.stats.snapshot()["launches"] == a.stats.launches
    finally:
        kernels.launches.update(saved)
