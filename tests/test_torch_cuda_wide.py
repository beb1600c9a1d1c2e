"""K1, K3 and K4 at the wider keys a conflict set widens to, on the card:
each held against its plain torch version on the same CUDA tensors (exact),
at W = 17, 65 and 129 lanes (64-, 256- and 512-byte keys: K1's and K3's
staged plans), at small shapes and at the stream's (K = 8 runs of 16384
rows, main at 2**19 rows); at W = 513 and 4097 (2048- and 16384-byte keys:
their warp plans, from kernels.WARP_FROM_W) at small shapes, with one run,
and at the default set's (K = 8 runs of 4096 rows, main at 2**16 rows); at
W = 32769 (131072-byte keys: the warp plans with the read ends in global
memory) at small shapes, with one run, and with 8 runs of 256 rows over
4096 main rows; the stream's 16-byte keys as a widened set holds them, every
range [k, key_after(k)), at W = 129, 513 and 4097 under the warp plans and
at W = 129 under the staged ones; K4 on a one-run slice 4 bytes off a
16-byte boundary, and at 8 runs of 4096 rows at W = 32769 (past 2**31
step elements, where the card has the room) and on one run of 16384 rows
at W = 65537 (a run past 2**31 step elements, cut into chunks); the
port's default set fed keys of 20 to 204 bytes on "cuda" against the same
set on "cpu": identical verdicts and state after every batch, widening
32 -> 64 -> 256 on both; and a small set widened to 131072 bytes by a
100,000-byte key on "cuda" against "cpu".

Marked `gpu`: every test asks the `cuda` fixture, which skips when no CUDA
device is present.  On a machine with the card:

    python -m pytest --noconftest tests/test_torch_cuda_wide.py -m gpu
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch import keys
from foundationdb_tpu_torch.conflict import device as tdev
from foundationdb_tpu_torch.conflict import kernels
from foundationdb_tpu_torch.conflict.api import TxInfo

pytestmark = pytest.mark.gpu

WIDE_W = (17, 65, 129)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sorted_rows(rng, n: int, W: int, live: int) -> np.ndarray:
    """n rows of W lanes: `live` sorted distinct keys of 4 * (W - 1) bytes
    that share all but their last word (so compares run to the end), the
    rest sentinel."""
    tail = np.unique(rng.integers(0, 1 << 30, size=live).astype(np.uint32))
    rows = np.full((n, W), 0xFFFFFFFF, np.uint32)
    rows[: len(tail), : W - 2] = 0x61616161
    rows[: len(tail), W - 2] = tail
    rows[: len(tail), W - 1] = 4 * (W - 1)
    return rows


def _runs(rng, K: int, run_cap: int, W: int):
    """K sorted, disjoint runs: begins and ends alternate over one sorted
    key list, each run sentinel-padded."""
    b = np.full((K, run_cap, W), 0xFFFFFFFF, np.uint32)
    e = b.copy()
    for k in range(K):
        rows = _sorted_rows(rng, 2 * run_cap, W, int(rng.integers(0, 2 * run_cap)))
        live = rows[rows[:, -1] != 0xFFFFFFFF]
        m = len(live) // 2
        b[k, :m], e[k, :m] = live[0 : 2 * m : 2], live[1 : 2 * m : 2]
    return b, e


@pytest.mark.parametrize("W", WIDE_W)
@pytest.mark.parametrize("shape", ["small", "stream"])
def test_wide_kernels_equal_their_plain_versions(cuda, W, shape):
    rng = np.random.default_rng(W)
    K, run_cap, cap, R = (3, 64, 1 << 10, 200) if shape == "small" else (
        8, 1 << 14, 1 << 19, 1 << 14)
    lanes = lambda a: keys.to_lanes(a, cuda)  # noqa: E731
    runs_b_np, runs_e_np = _runs(rng, K, run_cap, W)
    runs_b, runs_e = lanes(runs_b_np), lanes(runs_e_np)
    runs_ver = torch.from_numpy(rng.integers(0, 12, K).astype(np.int32)).to(cuda)
    reads = _sorted_rows(rng, R, W, R - 8)
    rng.shuffle(reads)
    rb, re_ = lanes(reads), keys.with_last_lane_inc(lanes(reads))
    snap = torch.from_numpy(rng.integers(0, 12, R).astype(np.int32)).to(cuda)
    r_ok = torch.from_numpy(rng.random(R) < 0.9).to(cuda)
    hist = torch.from_numpy(rng.random(R) < 0.05).to(cuda)
    k1 = (rb, re_, snap, r_ok, runs_b, runs_e, runs_ver, hist)
    assert torch.equal(kernels.probe_fused(*k1), kernels.probe_fused_plain(*k1))
    ks = lanes(_sorted_rows(rng, cap, W, cap // 2))
    rec, _ = kernels.run_to_step_plain(runs_b[0], runs_e[0], runs_ver[:1])
    assert torch.equal(kernels.compact_ranks(ks, rec), kernels.compact_ranks_plain(ks, rec))
    got = kernels.run_to_step_runs(runs_b, runs_e, runs_ver)
    want = kernels.run_to_step_runs_plain(runs_b, runs_e, runs_ver)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("W", (513, 4097))
@pytest.mark.parametrize("shape", ["small", "one_run", "default"])
def test_widest_kernels_equal_their_plain_versions(cuda, W, shape):
    rng = np.random.default_rng(W + 1)
    K, run_cap, cap, R = {"small": (3, 64, 1 << 10, 200),
                          "one_run": (1, 64, 1 << 10, 100),
                          "default": (8, 1 << 12, 1 << 16, 2048)}[shape]
    lanes = lambda a: keys.to_lanes(a, cuda)  # noqa: E731
    runs_b_np, runs_e_np = _runs(rng, K, run_cap, W)
    runs_b, runs_e = lanes(runs_b_np), lanes(runs_e_np)
    runs_ver = torch.from_numpy(rng.integers(0, 12, K).astype(np.int32)).to(cuda)
    reads = _sorted_rows(rng, R, W, R - 8)
    rng.shuffle(reads)
    rb, re_ = lanes(reads), keys.with_last_lane_inc(lanes(reads))
    snap = torch.from_numpy(rng.integers(0, 12, R).astype(np.int32)).to(cuda)
    r_ok = torch.from_numpy(rng.random(R) < 0.9).to(cuda)
    hist = torch.from_numpy(rng.random(R) < 0.05).to(cuda)
    k1 = (rb, re_, snap, r_ok, runs_b, runs_e, runs_ver, hist)
    assert torch.equal(kernels.probe_fused(*k1), kernels.probe_fused_plain(*k1))
    ks = lanes(_sorted_rows(rng, cap, W, cap // 2))
    rec, _ = kernels.run_to_step_plain(runs_b[0], runs_e[0], runs_ver[:1])
    assert torch.equal(kernels.compact_ranks(ks, rec), kernels.compact_ranks_plain(ks, rec))
    got = kernels.run_to_step_runs(runs_b, runs_e, runs_ver)
    want = kernels.run_to_step_runs_plain(runs_b, runs_e, runs_ver)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _widened(rng, n: int, W: int):
    """n sorted distinct 16-byte keys at width W as a widened set holds
    them (keys.widen_lanes), and each one's key_after (its length lane +
    1): the two differ only in the last lane."""
    raw = np.unique(rng.integers(0, 256, size=(n, 16), dtype=np.uint8), axis=0)
    raw[: n // 8, :12] = raw[0, :12]  # keys sharing 12 of their 16 bytes
    raw = np.unique(raw, axis=0)
    k = keys.widen_lanes(keys.to_lanes(keys.encode_fixed(raw, 16)), W)
    after = k.clone()
    after[:, -1] += 1
    return k, after


def _sent(n: int, W: int) -> torch.Tensor:
    return torch.full((n, W), keys.SENT_LANE, dtype=torch.int32)


@pytest.mark.parametrize("W,plan", [(129, "warp"), (129, "staged"), (129, "ends_l2"),
                                    (513, "warp"), (513, "ends_l2"), (4097, "warp"),
                                    (4097, "ends_l2")])
def test_widened_keys_equal_their_plain_versions(cuda, W, plan):
    """The stream's 16-byte keys as a widened set holds them, every range
    [k, key_after(k)) (a key and its end differ only in the last lane),
    runs and main with sentinel tails, recent rows of a run's step
    function: K1 and K3 under the warp plan (K1's read ends staged; with
    "ends_l2", read from L2, and K3 one query a block), and at W = 129 the
    staged plan too, each equal to its plain version."""
    rng = np.random.default_rng(W + 2)
    K, run_cap, cap, R = 4, 96, 1 << 11, 300
    pool_k, pool_a = _widened(rng, 1200, W)
    pick = lambda n: torch.from_numpy(np.sort(rng.choice(len(pool_k), n, replace=False)))  # noqa: E731
    runs_b, runs_e = _sent(K * run_cap, W).reshape(K, run_cap, W), _sent(K * run_cap, W)
    runs_e = runs_e.reshape(K, run_cap, W)
    for k in range(K):
        idx = pick(int(rng.integers(0, run_cap)))
        runs_b[k, : len(idx)], runs_e[k, : len(idx)] = pool_k[idx], pool_a[idx]
    rb = pool_k[torch.from_numpy(rng.integers(0, len(pool_k), R))]
    hits = torch.from_numpy(rng.integers(0, K * run_cap, R // 3))
    rb[: R // 3] = runs_b.reshape(-1, W)[hits]  # reads of the runs' keys (some sentinel)
    re_ = keys.with_last_lane_inc(rb)
    idx = pick(700)
    main = torch.stack([pool_k[idx], pool_a[idx]], 1).reshape(-1, W)
    ks = torch.cat([main, _sent(cap - len(main), W)])
    runs_ver = torch.from_numpy(rng.integers(0, 12, K).astype(np.int32))
    k1 = tuple(t.to(cuda) for t in (
        rb, re_, torch.from_numpy(rng.integers(0, 12, R).astype(np.int32)),
        torch.from_numpy(rng.random(R) < 0.9), runs_b, runs_e, runs_ver,
        torch.from_numpy(rng.random(R) < 0.05)))
    ks = ks.to(cuda)
    rec, _ = kernels.run_to_step_plain(k1[4][0], k1[5][0], k1[6][:1])
    p1, p3 = {
        "warp": lambda: (kernels.plan_probe_warp(K, W), kernels.RANKS_WARP_PLAN),
        "ends_l2": lambda: (kernels.plan_probe_warp(K, W, 0),
                            kernels.RANKS_WARP_PLAN._replace(queries=1)),
        "staged": lambda: (kernels.plan_probe_staged(K, run_cap, W),
                           kernels.plan_ranks_staged(W)),
    }[plan]()
    got = kernels.probe_fused(*k1, plan=p1)
    assert torch.equal(got, kernels.probe_fused_plain(*k1))
    assert bool((got & ~k1[7]).any())  # some read meets a run
    assert torch.equal(kernels.compact_ranks(ks, rec, plan=p3),
                       kernels.compact_ranks_plain(ks, rec))


@pytest.mark.parametrize("W", (513, 4097))
def test_warp_k3_ranks_queries_in_any_order(cuda, W):
    """K3's warp plan on queries that share all but their last word with
    main (each block narrows) and with one another: in key order, in key
    order with a sentinel tail and equal runs of queries, and shuffled
    (queries outside their block's first and last search all of main):
    each equal to the plain version, the queries unchanged."""
    rng = np.random.default_rng(W + 3)
    ks = keys.to_lanes(_sorted_rows(rng, 1 << 11, W, 1 << 10), cuda)
    live = keys.to_lanes(_sorted_rows(rng, 300, W, 300), cuda)
    live = torch.cat([live, ks[:200]])
    live = live[torch.from_numpy(np.lexsort(keys.from_lanes(live).T[::-1]).copy()).to(cuda)]
    tail = torch.full((70, W), keys.SENT_LANE, dtype=torch.int32, device=cuda)
    sorted_rec = torch.cat([live, tail])
    dup = torch.cat([live[:50].repeat_interleave(3, 0), live[50:], tail])
    shuffled = sorted_rec[torch.from_numpy(rng.permutation(len(sorted_rec))).to(cuda)]
    for rec in (sorted_rec, dup, shuffled):
        before = rec.clone()
        got = kernels.compact_ranks(ks, rec)
        assert kernels.plan_ranks(W).warp == 1
        assert torch.equal(got, kernels.compact_ranks_plain(ks, rec))
        assert torch.equal(rec, before)


@pytest.mark.parametrize("shape", ["small", "one_run", "runs"])
def test_kernels_past_shared_memory_equal_their_plain_versions(cuda, shape):
    """W = 32769: K1's and K3's warp plans (a warp a (read, run) pair, a
    warp a query, the read ends past what a block stages: every compare in
    global memory); both equal their plain versions, K3's input unchanged
    by the launch."""
    W = 32769
    assert kernels.plan_probe(8, 256, W).warp == 1
    assert kernels.plan_probe(8, 256, W).smem == 0
    assert kernels.plan_ranks(W).warp == 1
    rng = np.random.default_rng(W)
    K, run_cap, cap, R = {"small": (3, 64, 1 << 10, 200),
                          "one_run": (1, 64, 1 << 10, 100),
                          "runs": (8, 256, 1 << 12, 512)}[shape]
    lanes = lambda a: keys.to_lanes(a, cuda)  # noqa: E731
    runs_b_np, runs_e_np = _runs(rng, K, run_cap, W)
    runs_b, runs_e = lanes(runs_b_np), lanes(runs_e_np)
    runs_ver = torch.from_numpy(rng.integers(0, 12, K).astype(np.int32)).to(cuda)
    reads = _sorted_rows(rng, R, W, R - 8)
    rng.shuffle(reads)
    hits = rng.integers(0, K * run_cap, R // 4)  # reads of the runs' own begins
    reads[: R // 4] = runs_b_np.reshape(-1, W)[hits]
    rb, re_ = lanes(reads), keys.with_last_lane_inc(lanes(reads))
    snap = torch.from_numpy(rng.integers(0, 12, R).astype(np.int32)).to(cuda)
    r_ok = torch.from_numpy(rng.random(R) < 0.9).to(cuda)
    hist = torch.from_numpy(rng.random(R) < 0.05).to(cuda)
    k1 = (rb, re_, snap, r_ok, runs_b, runs_e, runs_ver, hist)
    got = kernels.probe_fused(*k1)
    assert torch.equal(got, kernels.probe_fused_plain(*k1))
    assert bool((got & ~hist).any())  # some read meets a run
    ks = lanes(_sorted_rows(rng, cap, W, cap // 2))
    rec, _ = kernels.run_to_step_plain(runs_b[0], runs_e[0], runs_ver[:1])
    rec_before = rec.clone()
    assert torch.equal(kernels.compact_ranks(ks, rec), kernels.compact_ranks_plain(ks, rec))
    assert torch.equal(rec, rec_before)


@pytest.mark.parametrize("W", (5, 17, 513, 4097))
def test_k4_on_a_one_run_slice_off_16_byte_alignment(cuda, W):
    """K4's one-run case on run 1 of a stack of runs, a slice whose
    data_ptr() is 4 bytes off a 16-byte boundary (rcap W odd), equals its
    plain version bit for bit, with one launch counted."""
    rng = np.random.default_rng(W + 4)
    K, rcap = 3, 253  # run 1 starts 253 W * 4 = 4 (mod 16) bytes in
    runs_b_np, runs_e_np = _runs(rng, K, rcap, W)
    runs_b, runs_e = keys.to_lanes(runs_b_np, cuda), keys.to_lanes(runs_e_np, cuda)
    ver = torch.tensor([5, 9, 0], dtype=torch.int32, device=cuda)
    u_b, u_e = runs_b[1], runs_e[1]
    assert u_b.data_ptr() % 16 == 4 and u_e.data_ptr() % 16 == 4
    before = kernels.launches["run_to_step"]
    rows, vals = kernels.run_to_step(u_b, u_e, ver[1])
    assert kernels.launches["run_to_step"] == before + 1
    want = kernels.run_to_step_plain(u_b, u_e, ver[1])
    assert torch.equal(rows, want[0]) and torch.equal(vals, want[1])


def test_k4_past_2_31_step_elements(cuda):
    """K4 at 8 runs of 4096 rows at W = 32769 (131072-byte keys): 2**31 +
    65536 step elements, past a 32-bit index over the launch, each run's
    below it.  Rows built on the card from a seed, sentinel tails, a dead
    run and an all-sentinel run; each run's rows and values equal the
    plain version's bit for bit, with one launch counted.  Needs about 20
    GB of the card (8.6 GB of runs, 8.6 GB of rows, a run's plain rows);
    skips, with the room it found, where the card has less."""
    K, rcap, W = 8, 4096, 32769
    need = 2 * (2 * K * rcap * W * 4) + 3 * (2 * rcap * W * 4)
    free, _total = torch.cuda.mem_get_info(cuda)
    if free < need:
        pytest.skip(f"needs {need} free bytes of the card, found {free}")
    g = torch.Generator(device=cuda)
    g.manual_seed(32769)
    shape = (K, rcap, W)
    runs_b = torch.randint(-(1 << 31), (1 << 31) - 1, shape, generator=g,
                           dtype=torch.int32, device=cuda)
    runs_e = torch.randint(-(1 << 31), (1 << 31) - 1, shape, generator=g,
                           dtype=torch.int32, device=cuda)
    for k in range(K):
        runs_b[k, 3000 + 100 * k:] = keys.SENT_LANE
        runs_e[k, 3000 + 100 * k:] = keys.SENT_LANE
    runs_b[2] = runs_e[2] = keys.SENT_LANE
    ver = torch.tensor([3, 0, 7, 1, 9, 4, 2, 8], dtype=torch.int32, device=cuda)
    before = kernels.launches["run_to_step"]
    rows, vals = kernels.run_to_step_runs(runs_b, runs_e, ver)
    assert kernels.launches["run_to_step"] == before + 1
    assert rows.numel() == (1 << 31) + 65536
    for k in range(K):
        want = kernels.run_to_step_plain(runs_b[k], runs_e[k], ver[k])
        assert torch.equal(rows[k], want[0]) and torch.equal(vals[k], want[1]), k
        del want
    assert bool(vals[0].any()) and not vals[1].any() and not vals[2].any()


def test_k4_on_a_run_past_2_31_step_elements(cuda):
    """K4 on one run of 16384 rows at W = 65537 (262144-byte keys): the
    run's 2**31 + 32768 step elements do not fit a 32-bit index, so the
    launch cuts it into 2 row-aligned chunks (grid.z).  Rows built on the
    card from a seed with a sentinel tail; rows and values equal the plain
    version's bit for bit, with one launch counted.  Needs about 35 GB of
    the card (8.6 GB of runs, 8.6 GB of rows, as much for the plain rows,
    and the compare); skips, with the room it found, where the card has
    less."""
    rcap, W = 16384, 65537
    assert kernels.plan_run_to_step(rcap, W).chunks == 2
    need = 4 * (2 * rcap * W * 4)
    torch.cuda.empty_cache()
    free, _total = torch.cuda.mem_get_info(cuda)
    if free < need:
        pytest.skip(f"needs {need} free bytes of the card, found {free}")
    g = torch.Generator(device=cuda)
    g.manual_seed(65537)
    runs_b = torch.randint(-(1 << 31), (1 << 31) - 1, (1, rcap, W), generator=g,
                           dtype=torch.int32, device=cuda)
    runs_e = torch.randint(-(1 << 31), (1 << 31) - 1, (1, rcap, W), generator=g,
                           dtype=torch.int32, device=cuda)
    runs_b[0, 12000:] = runs_e[0, 12000:] = keys.SENT_LANE
    ver = torch.tensor([6], dtype=torch.int32, device=cuda)
    before = kernels.launches["run_to_step"]
    rows, vals = kernels.run_to_step_runs(runs_b, runs_e, ver)
    assert kernels.launches["run_to_step"] == before + 1
    assert rows[0].numel() == (1 << 31) + 32768
    want = kernels.run_to_step_plain(runs_b[0], runs_e[0], ver[0])
    assert torch.equal(rows[0], want[0]) and torch.equal(vals[0], want[1])
    assert int((vals[0] == 6).sum()) == 12000


def test_set_widened_past_shared_memory_on_the_card_as_on_the_cpu(cuda):
    """A 100,000-byte key widens a small default set to 131072 bytes (W =
    32769) on "cuda" and on "cpu": the same verdicts and state after every
    batch, compactions included."""
    small = dict(capacity=1 << 8, run_slots=3, run_capacity=32)
    sets = [tdev.DeviceConflictSet(**small, device=d) for d in (cuda, "cpu")]
    long_key = b"L" * 100_000
    version = 0
    for i in range(8):
        version += 2
        txns = [TxInfo(max(version - 3, 0), [(long_key[: 99_990 + i], long_key + b"\x00")],
                       [(long_key[: 99_995 + i], long_key[: 99_995 + i] + b"\x00")]),
                TxInfo(max(version - 1, 0), [(b"a%d" % i, b"b")], [(b"a%d" % i, b"a%d\x00" % i)])]
        got, want = (s.resolve_batch(version, txns) for s in sets)
        assert got == want, version
        a, b = (s.export_state() for s in sets)
        assert all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a), version
    assert [s.stats.key_bytes for s in sets] == [131072, 131072]
    assert sets[0].stats.compactions >= 2


def _long_stream(seed: int, lengths=(20, 31, 32, 33, 43, 204, None, None)):
    """(version, txns, gc floor or None): each batch's ranges have short
    endpoints or endpoints of the batch's length, mixed."""
    rng = np.random.default_rng(seed)

    def key(n):
        head = bytes(rng.choice(list(b"abcdefgh"), size=int(rng.integers(0, 4))))
        return head + b"~" * max(n - len(head), 0)

    def rng_range(L):
        if L is None or rng.random() < 0.5:
            k = key(int(rng.integers(0, 6)))
            return k, k + b"\x00"
        k = key(L - 1)
        return k, k + b"\x00"

    version = 0
    for i, L in enumerate(lengths):
        version += int(rng.integers(1, 6))
        txns = [TxInfo(int(rng.integers(max(version - 8, 0), version)),
                       [rng_range(L) for _ in range(int(rng.integers(0, 3)))],
                       [rng_range(L) for _ in range(int(rng.integers(1, 3)))])
                for _ in range(int(rng.integers(4, 12)))]
        yield version, txns, (max(0, version - 6) if i == 5 else None)


def test_default_set_widens_on_the_card_as_on_the_cpu(cuda):
    """A long-key stream through the default set and the best-known layout
    on "cuda" and on "cpu"."""
    small = dict(capacity=1 << 8, run_slots=3, run_capacity=32)
    for layout in ({}, dict(lsm=True, search_impl="bucket")):
        sets = [tdev.DeviceConflictSet(**layout, **small, device=d) for d in (cuda, "cpu")]
        for version, txns, floor in _long_stream(3):
            got, want = (s.resolve_batch(version, txns) for s in sets)
            assert got == want, version
            a, b = (s.export_state() for s in sets)
            assert a.keys() == b.keys()
            assert all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a), version
            if floor is not None:
                for s in sets:
                    s.remove_before(floor)
        assert [s.stats.key_bytes for s in sets] == [256, 256]
        assert sets[0].stats.widenings == sets[1].stats.widenings == 2
