"""compact_fold's values in closed form: each step function evaluated at
the other's rows from the cross ranks and their prefix count, with no
forward fill over the merged domain.  Held bit for bit (rows, values,
count) against the reference's scatter fold (XLA lowering) and the port's
sort referee, at the seams where a fill and the closed form could part:
recent rows before main's first row, past its live rows, none at all,
equal to main's boundaries, coalescing across a main/recent seam, and a
fold that overflows main.  The referees keep their scan: a profiler guard
says which folds run one."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax.numpy as jnp

from foundationdb_tpu import keys as jkeys
from foundationdb_tpu.conflict import device as jdev
from foundationdb_tpu_torch.conflict import device as tdev
from foundationdb_tpu_torch.keys import from_lanes, to_lanes

SENT = np.uint32(0xFFFFFFFF)
# W = max_key_bytes // 4 + 1; the key prefix fills the wide cases' lanes
WIDTHS = {5: (16, b""), 9: (32, b"pre/"), 65: (256, b"p" * 200)}


def _level(ids, vals, cap, W):
    """A step function of `cap` rows: the keys of the sorted unique
    integer ids (prefix + 4 big-endian bytes), their values, then
    sentinel rows with value 0."""
    mkb, prefix = WIDTHS[W]
    ids = np.asarray(ids, np.int64)
    assert len(ids) <= cap and np.all(np.diff(ids) > 0)
    ks = np.full((cap, W), SENT, np.uint32)
    vs = np.zeros(cap, np.int32)
    if len(ids):
        ks[: len(ids)] = jkeys.encode_keys(
            [prefix + int(i).to_bytes(4, "big") for i in ids], mkb)
        vs[: len(ids)] = vals
    return ks, vs


def _case(name, rng):
    """(main ids, main values, recent ids, recent values, cap, rec_cap)."""
    main = np.arange(100, 400, 3)
    mv = 1 + rng.permutation(len(main))  # coalesced: no equal neighbours
    if name == "before_main":  # every recent row ranks before main's first
        rec = np.arange(10, 60, 2)
        return main, mv, rec, rng.integers(0, 60, len(rec)), 160, 32
    if name == "past_main":  # after main's live rows, before its sentinels
        rec = np.arange(500, 560, 2)
        return main, mv, rec, 200 + np.arange(len(rec)), 160, 32
    if name == "empty_recent":  # only sentinels
        return main, mv, [], [], 160, 32
    if name == "equal_boundaries":  # recent rows on main's own keys
        rec = np.unique(np.concatenate([main[::4], main[1::7] + 1]))
        return main, mv, rec, rng.integers(0, 60, len(rec)), 160, 64
    if name == "coalesce_seam":
        # main steps 5, 7, 5, 7, ...; recent rows just past each main row
        # carry its value or less, so they coalesce away, and rows under a
        # 7 that raise a 5 merge with the next main row's 7
        mv = np.where(np.arange(len(main)) % 2, 7, 5)
        rec = np.concatenate([main[:40] + 1, main[40:60] + 2])
        rv = np.concatenate([rng.integers(0, 6, 40), np.full(20, 7)])
        order = np.argsort(rec)
        return main, mv, rec[order], rv[order], 160, 64
    if name == "overflow":  # new_count > cap: rows dropped for the regrow
        # values rise through both levels in turn, so no row coalesces
        rec = main + 1
        mv = 10 + 2 * np.arange(len(main))
        return main, mv, rec, mv + 1, 128, 128
    assert name == "interleaved"
    rec = np.unique(rng.integers(90, 420, 40))
    return main, mv, rec, rng.integers(0, 60, len(rec)), 160, 64


CASES = ["before_main", "past_main", "empty_recent", "equal_boundaries",
         "coalesce_seam", "overflow", "interleaved"]


@pytest.mark.parametrize("W", sorted(WIDTHS))
@pytest.mark.parametrize("name", CASES)
def test_fold_matches_the_reference_and_the_sort_referee(name, W):
    rng = np.random.default_rng(sum(map(ord, name)) + W)
    m_ids, m_vs, r_ids, r_vs, cap, rec_cap = _case(name, rng)
    ks, vs = _level(m_ids, m_vs, cap, W)
    rks, rvs = _level(r_ids, r_vs, rec_cap, W)
    args = (to_lanes(ks), torch.from_numpy(vs), to_lanes(rks), torch.from_numpy(rvs))

    got_ks, got_vs, got_n = tdev.compact_fold(*args, cap=cap)
    assert got_vs.dtype == torch.int32 and got_n.dtype == torch.int32
    want = jdev._compact_kernel(jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(rks),
                                jnp.asarray(rvs), cap=cap, merge_impl="scatter",
                                lowering="xla")
    assert np.array_equal(np.asarray(want[0]), from_lanes(got_ks))
    assert np.array_equal(np.asarray(want[1]), got_vs.numpy())
    assert int(want[2]) == int(got_n)
    ref_ks, ref_vs, ref_n = tdev._compact_fold_sort(*args, cap=cap)
    assert torch.equal(ref_ks, got_ks)
    assert torch.equal(ref_vs, got_vs)
    assert int(ref_n) == int(got_n)

    n = int(got_n)
    if name == "before_main":
        assert torch.equal(got_ks[0], to_lanes(rks)[0])
    if name == "past_main":
        assert n == len(m_ids) + len(r_ids)
        assert torch.equal(got_ks[n - 1], to_lanes(rks)[len(r_ids) - 1])
    if name == "empty_recent":
        assert torch.equal(got_ks, to_lanes(ks)) and torch.equal(got_vs, torch.from_numpy(vs))
    if name == "coalesce_seam":
        assert n < len(m_ids)  # the raising rows merged across the seam
    assert (n > cap) == (name == "overflow")


def _aten_ops(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("impl,scans", [("scatter", False), ("sort", True), ("gather", True)])
def test_only_the_referee_folds_scan(impl, scans):
    """The scatter fold (compact_fold, what the set runs) records no
    aten::cummax; the sort and gather referees keep `_ffill`'s scan, so
    they stay independent of the closed form they referee."""
    rng = np.random.default_rng(3)
    m_ids, m_vs, r_ids, r_vs, cap, rec_cap = _case("interleaved", rng)
    ks, vs = _level(m_ids, m_vs, cap, 5)
    rks, rvs = _level(r_ids, r_vs, rec_cap, 5)
    ops = _aten_ops(lambda: tdev.compact_lsm(
        to_lanes(ks), torch.from_numpy(vs), to_lanes(rks), torch.from_numpy(rvs),
        cap=cap, merge_impl=impl))
    assert ("aten::cummax" in ops) == scans
    if impl == "scatter":
        assert _aten_ops(lambda: tdev.compact_fold(
            to_lanes(ks), torch.from_numpy(vs), to_lanes(rks), torch.from_numpy(rvs),
            cap=cap)).isdisjoint({"aten::cummax", "aten::_cummax_helper"})
