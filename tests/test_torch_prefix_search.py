"""A model of K1's and K3's warp plans (csrc/conflict_kernels.cu:
warp_first_diff, warp_search, probe_fused_warp_kernel,
compact_ranks_warp_kernel), kept here and not in the package: a warp's
compare starts at the lanes both bounds of its interval share with the
key, rounded down to a 128-lane step, and K3's block, where its first
and last query share more than a step, ranks both and narrows each other
query that lies between them.  The model's ranks and
verdicts must equal compact_ranks_plain's and probe_fused_plain's on
seeded adversarial rows (a common prefix filling the width, k /
key_after(k) pairs, sentinel tails whose last lane + 1 wraps, duplicates,
a block out of key order), and the lanes its searches compare must never
exceed what a search that starts every compare at lane 0 compares (the
count chip_smoke.trace_search made before it skipped shared prefixes),
nor fall below what trace_search counts now (the least reading)."""

import numpy as np
import pytest
import torch

import chip_smoke
from foundationdb_tpu_torch import keys
from foundationdb_tpu_torch.conflict import kernels

STEP = 128          # lanes a warp compares a step
I32_MIN = -(1 << 31)
I32_MAX = (1 << 31) - 1


def _inc(row):
    """The row as the compare sees it with its last lane + 1 (uint32 wrap)."""
    row = row.copy()
    row[-1] = I32_MIN if row[-1] == I32_MAX else row[-1] + 1
    return row


class Model:
    """The warp plans on int64 numpy rows of int32 lane values, counting
    the lanes each compare reads from its (rounded) start to the first
    lane that differs."""

    def __init__(self):
        self.search_lanes = 0
        self.old_lanes = 0

    def first_diff(self, a, b, start):
        """(first lane that differs or W, a < b), from `start` rounded down
        to a step; lanes below `start` must agree."""
        W = len(a)
        w0 = start & ~(STEP - 1)
        assert np.array_equal(a[:start], b[:start])
        d = np.nonzero(a[w0:] != b[w0:])[0]
        f = w0 + int(d[0]) if len(d) else W
        self.lanes = min(f, W - 1) - w0 + 1
        return f, bool(len(d) and a[f] < b[f])

    def search(self, rows, lo, hi, q, l_lo=0, l_hi=0):
        """warp_search: (rank, l_lo, l_hi); counts its lanes, and those a
        search that starts every compare at lane 0 would count on the
        same path."""
        while lo < hi:
            mid = lo + (hi - lo) // 2
            f, less = self.first_diff(rows[mid], q, min(l_lo, l_hi))
            self.search_lanes += self.lanes
            self.old_lanes += min(f, len(q) - 1) + 1
            if less:
                lo, l_lo = mid + 1, f
            else:
                hi, l_hi = mid, f
        return lo, l_lo, l_hi

    def probe_fused(self, rb, re_, snap, r_ok, runs_b, runs_e, runs_ver, hist):
        """probe_fused_warp_kernel: per (read, run) pair a full search."""
        out = hist.copy()
        for i in np.nonzero(~hist & r_ok)[0]:
            for k in range(runs_b.shape[0]):
                if runs_ver[k] <= snap[i]:
                    continue
                rank, _, _ = self.search(runs_b[k], 0, runs_b.shape[1], re_[i])
                if rank and self.first_diff(rb[i], runs_e[k][rank - 1], 0)[1]:
                    out[i] = True
        return out

    def compact_ranks(self, ks, rec, queries):
        """compact_ranks_warp_kernel, block by block of `queries` rows."""
        cap, W = ks.shape
        out = np.zeros(len(rec), np.int64)
        for j0 in range(0, len(rec), queries):
            qs = [_inc(r) for r in rec[j0:j0 + queries]]
            first, last = qs[0], qs[-1]
            shared, _ = self.first_diff(first, last, 0)
            lo, lo_share, _ = self.search(ks, 0, cap, first)
            if shared < STEP:  # distinct keys: every query searches all of main
                for j, q in enumerate(qs):
                    out[j0 + j] = lo if j == 0 else self.search(ks, 0, cap, q)[0]
                continue
            hi, hi_share = lo, 0
            if shared < W:
                hi, _, hi_share = self.search(ks, 0, cap, last)
            for j, q in enumerate(qs):
                if j == 0 or j == len(qs) - 1:
                    out[j0 + j] = lo if j == 0 else hi
                    continue
                f1, after = self.first_diff(first, q, 0)
                f2, before = self.first_diff(q, last, min(f1, shared))
                if (f1 == W or after) and (f2 == W or before):
                    out[j0 + j] = self.search(ks, lo, hi, q, min(lo_share, f1),
                                              min(f2, hi_share))[0]
                else:
                    out[j0 + j] = self.search(ks, 0, cap, q)[0]
        return out


def _keys16(rng, n, pool=None):
    """n sorted distinct 16-byte keys (or n drawn from `pool`) as uint32
    rows of width 5."""
    if pool is None:
        raw = np.unique(rng.integers(0, 256, size=(n, 16), dtype=np.uint8), axis=0)
    else:
        raw = pool[np.sort(rng.choice(len(pool), n, replace=False))]
    return keys.encode_fixed(raw, 16)


def _wide(kind, rows, W):
    """The two inputs of chip_smoke's phase 3 at width W."""
    if kind == "prefixed":
        return chip_smoke.prefixed_lanes(torch, keys, rows, W, "cpu")
    return chip_smoke.widened_lanes(torch, keys, rows, W, "cpu")


def _after(kind, t):
    """key_after of each live row: the widened rows' length lane + 1; the
    prefixed ones as at W = 5, [k, k + 1)."""
    out = t.clone()
    live = out[:, -1] != keys.SENT_LANE
    out[live, -1] += 1
    return out


def _sentinel(n, W):
    return torch.full((n, W), keys.SENT_LANE, dtype=torch.int32)


def _inputs(kind, W, seed):
    """K1's and K3's arguments: runs of point intervals with sentinel
    tails, reads half on the runs' keys (some repeated), a main whose keys
    each sit beside their key_after, duplicated rows, and a sentinel tail;
    recent rows from a run's step function (sorted, sentinel tail)."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(600, 16), dtype=np.uint8)
    raw[:40, :12] = raw[0, :12]  # keys sharing 12 of their 16 bytes
    pool = np.unique(raw, axis=0)
    K, run_cap = 3, 48
    runs_b, runs_e = [], []
    for k in range(K):
        b = _wide(kind, _keys16(rng, 30, pool), W)
        pad = _sentinel(run_cap - len(b), W)
        runs_b.append(torch.cat([b, pad]))
        runs_e.append(torch.cat([_after(kind, b), pad]))
    runs_b, runs_e = torch.stack(runs_b), torch.stack(runs_e)
    run_keys = runs_b[:, :30].reshape(-1, W)
    R = 90
    rb = _wide(kind, _keys16(rng, R, pool), W)
    hit = torch.from_numpy(rng.random(R) < 0.5)
    rb[hit] = run_keys[torch.from_numpy(rng.integers(0, len(run_keys), int(hit.sum())))]
    re_ = _after(kind, rb)
    rb[-3:] = re_[-3:] = keys.SENT_LANE  # padding reads
    snap = torch.from_numpy(rng.integers(0, 6, R).astype(np.int32))
    r_ok = torch.from_numpy(rng.random(R) < 0.9)
    hist = torch.from_numpy(rng.random(R) < 0.1) & r_ok
    runs_ver = torch.tensor([0, 3, 5], dtype=torch.int32)
    main = _wide(kind, _keys16(rng, 150, pool), W)
    main = torch.stack([main, _after(kind, main)], 1).reshape(-1, W)
    main = main.repeat_interleave(torch.from_numpy(1 + 2 * (rng.random(len(main)) < 0.03)), 0)
    cap = 384
    ks = torch.cat([main, _sentinel(cap - len(main), W)])
    rec, _ = kernels.run_to_step_plain(runs_b[1], runs_e[1], runs_ver[1])
    rec = torch.cat([rec, main[100:110]])  # recent rows equal to main rows
    return (rb, re_, snap, r_ok, runs_b, runs_e, runs_ver, hist), ks, rec


def _np(t):
    return t.numpy().astype(np.int64)


def _old_count(ks, rec):
    """The lanes a binary search that starts every compare at lane 0
    reads, over all of main, for each recent row (its last lane + 1)."""
    m = Model()
    for q in _np(rec):
        m.search(_np(ks), 0, ks.shape[0], _inc(q))
    return m.old_lanes


@pytest.mark.parametrize("W", [129, 513])
@pytest.mark.parametrize("kind", ["prefixed", "widened"])
@pytest.mark.parametrize("seed", range(2))
def test_k1_model_equals_the_plain_version(kind, W, seed):
    args, _ks, _rec = _inputs(kind, W, seed)
    m = Model()
    got = m.probe_fused(*(_np(a) if a.dtype == torch.int32 else a.numpy() for a in args))
    want = kernels.probe_fused_plain(*args).numpy()
    assert np.array_equal(got, want)
    assert 0 < m.search_lanes <= m.old_lanes
    assert want.any() and not want.all()


@pytest.mark.parametrize("W", [129, 513])
@pytest.mark.parametrize("kind", ["prefixed", "widened"])
@pytest.mark.parametrize("queries", [1, 5, 32])
def test_k3_model_equals_the_plain_version(kind, W, queries):
    _args, ks, rec = _inputs(kind, W, queries)
    m = Model()
    got = m.compact_ranks(_np(ks), _np(rec), queries)
    assert np.array_equal(got, kernels.compact_ranks_plain(ks, rec).numpy())
    assert m.search_lanes <= _old_count(ks, rec)


@pytest.mark.parametrize("kind", ["prefixed", "widened"])
def test_k3_model_out_of_key_order_searches_all_of_main(kind):
    """In a block out of key order, a query outside its block's first and
    last searches all of main: still the plain version's ranks."""
    _args, ks, rec = _inputs(kind, 129, 7)
    rec = rec[torch.from_numpy(np.random.default_rng(7).permutation(len(rec)))]
    got = Model().compact_ranks(_np(ks), _np(rec), 32)
    assert np.array_equal(got, kernels.compact_ranks_plain(ks, rec).numpy())


def test_sentinel_queries_wrap_below_main_sentinels():
    """A sentinel recent row with its last lane + 1 wraps to INT32_MIN, so
    it ranks below main's sentinel rows and above every live one; an
    all-sentinel block searches once."""
    _args, ks, _rec = _inputs("widened", 129, 3)
    rec = _sentinel(40, 129)
    m = Model()
    got = m.compact_ranks(_np(ks), _np(rec), 32)
    live = int((ks[:, -1] != keys.SENT_LANE).sum())
    assert np.array_equal(got, np.full(40, live))
    assert np.array_equal(got, kernels.compact_ranks_plain(ks, rec).numpy())
    one = Model()
    one.search(_np(ks), 0, ks.shape[0], _inc(_np(rec)[0]))
    # 2 blocks, each one search: every other query equals its first
    assert m.search_lanes == 2 * one.search_lanes


@pytest.mark.parametrize("kind", ["prefixed", "widened"])
def test_model_reads_no_less_than_the_corrected_bound(kind):
    """On the same full searches, the model's lanes (its compares start
    at the shared lanes rounded down to a step) are at least
    trace_search's (the exact shared lanes) and at most the old count."""
    _args, ks, rec = _inputs(kind, 513, 11)
    q = keys.with_last_lane_inc(rec)
    rank, *_rest, lanes = chip_smoke.trace_search(torch, ks, q, torch.arange(len(q)))
    m = Model()
    got = [m.search(_np(ks), 0, ks.shape[0], row)[0] for row in _np(q)]
    assert np.array_equal(np.array(got), rank.numpy())
    assert lanes <= m.search_lanes <= m.old_lanes
    if kind == "prefixed":  # every key shares 4 * 508 bytes: skipping pays
        assert m.search_lanes < 0.6 * m.old_lanes
