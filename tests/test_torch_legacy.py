"""The port's legacy layouts (incremental=False: every batch merges into
the state, flat or into the LSM recent level) held against the reference
package on the CPU: verdicts, the exported state (recent level included),
node_count, compactions and search fallbacks batch by batch, over every
lsm x merge_impl x search_impl; the intra fixpoint's bits and iterations
against the reference's phase_intra on the same inputs; the three merges
and the three folds against the reference's on adversarial inputs; the
pipelined modes against the synchronous set; and the state carry."""

import functools
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from foundationdb_tpu import keys as jkeys
from foundationdb_tpu.conflict import device as jdev
from foundationdb_tpu.conflict.api import TxInfo
from foundationdb_tpu.conflict.oracle import OracleConflictSet
from foundationdb_tpu_torch.conflict import device as tdev
from foundationdb_tpu_torch.keys import from_lanes, to_lanes
from tests.test_pallas import _rand_batch, _rand_key, _rand_range
from tests.test_torch_device import jax_state

SENT = np.uint32(0xFFFFFFFF)
# main regrows from 8 rows; a recent level of 33 rows takes one batch of
# up to 16 writes (2 * 16 + 1 rows) and compacts on nearly every one
TINY = dict(capacity=1 << 3, recent_capacity=33, incremental=False)


def interpret_sweep_stream(seed, n_batches):
    """test_pallas_interpret_parity_sweep's stream: (version, txns, GC
    floor or None) per batch."""
    rng = random.Random(seed)
    oldest, version = 0, 0
    for _ in range(n_batches):
        version += rng.randrange(1, 8)
        txns = _rand_batch(rng, version, oldest, rng.randrange(1, 12))
        floor = None
        if rng.random() < 0.3:
            floor = rng.randrange(version + 1)
            oldest = max(oldest, floor)
        yield version, txns, floor


def merge_sweep_stream(seed, n_batches):
    """test_merge_impl_parity_sweep's stream: a two-letter alphabet (heavy
    duplicate boundaries) and every 4th batch write-free; no GC."""
    rng = random.Random(seed)
    version = 0
    for i in range(n_batches):
        version += rng.randrange(1, 6)
        txns = [
            TxInfo(
                read_snapshot=max(version - rng.randrange(1, 4), 0),
                read_ranges=[_rand_range(rng) for _ in range(rng.randrange(3))],
                write_ranges=(
                    [] if i % 4 == 3
                    else [(k := _rand_key(rng, b"ab", 2), k + b"\x00")
                          for _ in range(rng.randrange(1, 4))]
                ),
            )
            for _ in range(rng.randrange(1, 8))
        ]
        yield version, txns, None


def assert_same(want: dict, got: dict, where) -> None:
    assert set(got) == set(want), (where, set(got) ^ set(want))
    for k in want:
        assert np.array_equal(np.asarray(want[k]), np.asarray(got[k])), (where, k)


def held_against_jax(stream, pallas=None, **set_args):
    """The stream through the oracle, the reference set and the port on
    the CPU: identical verdicts, state, node_count, compactions and
    fallbacks after every batch.  Returns (reference, port)."""
    oracle = OracleConflictSet()
    ref = jdev.DeviceConflictSet(pallas=pallas, **set_args)
    port = tdev.DeviceConflictSet(device="cpu", **set_args)
    assert port.node_count == ref.node_count
    for version, txns, floor in stream:
        want = oracle.resolve_batch(version, txns)
        assert ref.resolve_batch(version, txns) == want
        assert port.resolve_batch(version, txns) == want, version
        assert_same(jax_state(ref), port.export_state(), version)
        assert port.node_count == ref.node_count, version
        assert port.stats.compactions == ref.compactions, version
        assert port.search_fallbacks == ref.search_fallbacks, version
        assert port.stats.full_merges == ref.stats.full_merges, version
        if floor is not None:
            for s in (oracle, ref, port):
                s.remove_before(floor)
    return ref, port


@pytest.mark.parametrize("search", ["sort", "bucket"])
@pytest.mark.parametrize("merge", ["scatter", "sort", "gather"])
@pytest.mark.parametrize("lsm", [False, True], ids=["flat", "lsm"])
def test_legacy_matches_reference(lsm, merge, search):
    """Every legacy layout against the reference batch by batch, on the
    interpret sweep's stream (with GC) for the sort search and the merge
    sweep's (duplicate-heavy, write-free batches) for the bucketed one, at
    capacities small enough that flat main regrows and the recent level
    compacts into main.  The LSM gather case runs the reference with its
    Pallas bodies in interpret mode (its compaction ranks through the
    Pallas rank kernel, the port's through K3's plain version)."""
    stream = (interpret_sweep_stream(3, 8) if search == "sort"
              else merge_sweep_stream(42, 10))
    # main regrows on the flat layout; the LSM one folds into a main level
    # that fits (the fold's regrow is the incremental path's, tested there)
    args = dict(TINY, capacity=1 << 6) if lsm else TINY
    pallas = "interpret" if (lsm, merge, search) == (True, "gather", "bucket") else None
    _ref, port = held_against_jax(stream, pallas=pallas, lsm=lsm, merge_impl=merge,
                                  search_impl=search, **args)
    if lsm:
        assert port.stats.compactions >= 3, "the recent level seldom compacted"
        assert list(port.stats.fold_wall_s) == [merge]
    else:
        assert port.capacity > TINY["capacity"], "main never regrew"
    assert port.stats.runs_appended == 0 and "runs_b" not in port.export_state()


def test_legacy_fixpoint_matches_reference_phase_intra(monkeypatch):
    """Each batch's intra-batch fixpoint, as the legacy path calls it, gives
    the reference phase_intra's bits and iteration count on the same
    inputs; the set's fixpoint_iterations() is their sum."""
    seen = []
    phase_intra = tdev.phase_intra

    def recording(rb, re_, wb, we, r_ok, w_ok, r_idx, w_idx, w_tx, active, hist, B):
        intra, n_iters = phase_intra(rb, re_, wb, we, r_ok, w_ok, r_idx, w_idx,
                                     w_tx, active, hist, B)
        rows = [jnp.asarray(from_lanes(t)) for t in (rb, re_, wb, we)]
        flags = [jnp.asarray(t.numpy()) for t in (r_ok, w_ok, r_idx.int(),
                                                   w_idx.int(), w_tx, active, hist)]
        w_intra, w_iters = jdev.phase_intra(*rows, *flags, B)
        assert np.array_equal(np.asarray(w_intra), intra.numpy())
        assert int(w_iters) == int(n_iters)
        seen.append(int(n_iters))
        return intra, n_iters

    monkeypatch.setattr(tdev, "phase_intra", recording)
    chain = [TxInfo(0, [(b"k%02d" % (t - 1), b"k%02d\x00" % (t - 1))] if t else [],
                    [(b"k%02d" % t, b"k%02d\x00" % t)]) for t in range(10)]
    port = tdev.DeviceConflictSet(device="cpu", **TINY, lsm=True)
    port.resolve_batch(1, chain)
    for version, txns, _floor in interpret_sweep_stream(8, 4):
        port.resolve_batch(version + 1, txns)
    assert seen[0] >= 10 and port.fixpoint_iterations() == sum(seen)


def _sorted_rows(rng, n, W=5, alphabet=b"abc"):
    raws = sorted({_rand_key(rng, alphabet, 4) for _ in range(n)} - {b""})
    return jkeys.encode_keys(raws, 16)


def _state(rng, cap, n):
    """A coalesced step function: the empty key, then sorted rows with
    random versions, sentinel-padded to cap."""
    rows = _sorted_rows(rng, n)[: cap - 1]
    ks = np.full((cap, rows.shape[1]), SENT, np.uint32)
    ks[0] = jkeys.encode_keys([b""], 16)[0]
    ks[1:1 + len(rows)] = rows
    vs = np.zeros(cap, np.int32)
    vals = np.array([rng.randrange(0, 4) for _ in range(1 + len(rows))], np.int32)
    keep = np.concatenate([[True], vals[1:] != vals[:-1]])
    live = np.flatnonzero(keep)
    out_ks = np.full_like(ks, SENT)
    out_ks[: len(live)] = ks[live]
    vs[: len(live)] = vals[live]
    return out_ks, vs, len(live)


@functools.lru_cache(maxsize=None)
def _jitted_merge(impl, cap):
    return jax.jit(functools.partial(jdev._MERGE_IMPLS[impl], cap=cap))


@pytest.mark.parametrize("seed", range(3))
def test_merges_match_reference(seed):
    """phase_merge, phase_merge_sort and phase_merge_gather against the
    reference's on one state and one write batch — duplicate write keys,
    writes equal to state boundaries, a few not committed — at a capacity
    that fits and at one that overflows (new_count > cap)."""
    rng = random.Random(90 + seed)
    for cap in (64, 8):
        ks, vs, count = _state(rng, cap, 40)
        Wn = 16
        # point writes (many boundaries) and one range
        pairs = [_rand_range(rng) if i == 0 else
                 (k := _rand_key(rng, b"abc", 4), k + b"\x00") for i in range(Wn - 3)]
        wb = jkeys.encode_keys([p[0] for p in pairs], 16)
        we = jkeys.encode_keys([p[1] for p in pairs], 16)
        wb = np.concatenate([wb, np.full((3, wb.shape[1]), SENT, np.uint32)])
        we = np.concatenate([we, np.full((3, we.shape[1]), SENT, np.uint32)])
        w_ins = np.array([rng.random() < 0.8 for _ in range(Wn - 3)] + [False] * 3)
        wb_rank, we_rank = (np.asarray(jdev.phase_search_sort(
            jnp.asarray(ks), jnp.int32(count), jnp.asarray(wb), jnp.asarray(we),
            jnp.asarray(wb), jnp.asarray(we), jnp.asarray(w_ins),
            jnp.asarray(w_ins))[i]) for i in (2, 3))
        t_ranks = tdev.phase_search_sort(to_lanes(ks), count, to_lanes(wb),
                                         to_lanes(we), to_lanes(wb), to_lanes(we))
        assert np.array_equal(t_ranks[2].numpy(), wb_rank)
        assert np.array_equal(t_ranks[3].numpy(), we_rank)
        for impl in ("scatter", "sort", "gather"):
            want = _jitted_merge(impl, cap)(
                jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(wb), jnp.asarray(we),
                jnp.asarray(wb_rank), jnp.asarray(we_rank), jnp.asarray(w_ins),
                jnp.int32(9))
            got = tdev._MERGE_IMPLS[impl](
                to_lanes(ks), torch.from_numpy(vs), to_lanes(wb), to_lanes(we),
                t_ranks[2], t_ranks[3], torch.from_numpy(w_ins), 9, cap=cap)
            assert int(want[2]) == int(got[2]), (impl, cap)
            if int(got[2]) <= cap:  # an overflowing merge's rows are dropped
                assert np.array_equal(np.asarray(want[0]), from_lanes(got[0])), impl
                assert np.array_equal(np.asarray(want[1]), got[1].numpy()), impl
        assert cap == 64 or int(got[2]) > cap


@pytest.mark.parametrize("seed", range(2))
def test_folds_match_reference(seed):
    """compact_lsm's three folds against the reference's compact_lsm, on a
    recent level that duplicates main boundaries exactly, on an empty one
    (only the floor row), and on one whose fold overflows main."""
    rng = random.Random(60 + seed)
    for cap, rec_cap, dup in ((64, 32, True), (64, 32, False), (8, 32, False)):
        ks, vs, count = _state(rng, cap, 40)
        rks, rvs, _ = _state(rng, rec_cap, 24 if not dup else 1)
        if dup:  # recent rows equal to main's
            rks[1:count // 2] = ks[1:count // 2]
            rvs[1:count // 2] = 5
        for impl in ("scatter", "sort", "gather"):
            want = jdev._compact_kernel(jnp.asarray(ks), jnp.asarray(vs),
                                        jnp.asarray(rks), jnp.asarray(rvs),
                                        cap=cap, merge_impl=impl, lowering="xla")
            got = tdev.compact_lsm(to_lanes(ks), torch.from_numpy(vs), to_lanes(rks),
                                   torch.from_numpy(rvs), cap=cap, merge_impl=impl)
            assert int(want[2]) == int(got[2]), (impl, cap)
            if int(got[2]) <= cap:
                assert np.array_equal(np.asarray(want[0]), from_lanes(got[0])), impl
                assert np.array_equal(np.asarray(want[1]), got[1].numpy()), impl


@pytest.mark.parametrize("lsm", [False, True], ids=["flat", "lsm"])
def test_legacy_pipelined_modes_match_sync(lsm):
    """resolve_arrays(sync=False) with check_pipelined(), and
    resolve_deferred waited one behind, give the synchronous set's
    verdicts and state — with the pipelined capacity margin (flat) and the
    recent level's compaction (LSM) firing inside the stream.  A pipelined
    LSM set compacts on the bound of its recent count, not the count, so
    its split between the levels may differ: folded into main, the state
    is the same step function."""
    args = dict(TINY, lsm=lsm, search_impl="bucket")
    stream = list(interpret_sweep_stream(11, 10))
    sync = tdev.DeviceConflictSet(device="cpu", **args)
    arrays = tdev.DeviceConflictSet(device="cpu", **args)
    deferred = tdev.DeviceConflictSet(device="cpu", **args)
    prev = None
    for version, txns, floor in stream:
        want = sync.resolve_batch(version, txns)
        packed = tdev.pack_batch(txns, arrays.oldest_version, arrays._offset, 32)
        got = arrays.resolve_arrays(version, *packed[:8], sync=False)
        assert isinstance(got, torch.Tensor)
        assert [int(c) for c in got[: len(txns)]] == [int(v) for v in want]
        h = deferred.resolve_deferred(version, txns)
        if prev is not None:
            assert prev[0].wait() == prev[1]
        prev = (h, want)
        if floor is not None:
            for s in (sync, arrays, deferred):
                s.remove_before(floor)
    assert prev[0].wait() == prev[1]
    arrays.check_pipelined()
    for s in (sync, arrays, deferred):
        if lsm:
            s._compact()
    want = sync.export_state()
    for s in (arrays, deferred):
        got = s.export_state()
        if lsm:
            n = want["count"]
            assert got["count"] == n
            assert np.array_equal(want["ks"][:n], got["ks"][:n])
            assert np.array_equal(want["vs"][:n], got["vs"][:n])
        else:
            assert_same(want, got, "pipelined")
    if lsm:
        assert sync.stats.compactions >= 1
    else:
        assert sync.capacity > TINY["capacity"]


def test_legacy_state_carry_from_reference():
    """A legacy LSM state built by the reference set (sort search: its
    bucket indexes left as they were) loads into the port, and both go on
    identically."""
    batches = list(interpret_sweep_stream(13, 10))
    args = dict(TINY, lsm=True, merge_impl="gather")
    ref = jdev.DeviceConflictSet(**args)
    for version, txns, floor in batches[:6]:
        ref.resolve_batch(version, txns)
        if floor is not None:
            ref.remove_before(floor)
    port = tdev.DeviceConflictSet(device="cpu", **dict(args, merge_impl="scatter"))
    port.load_state(jax_state(ref))
    assert port.stats.merge_impl == "gather"
    assert_same(jax_state(ref), port.export_state(), "loaded")
    for version, txns, floor in batches[6:]:
        assert port.resolve_batch(version, txns) == ref.resolve_batch(version, txns)
        assert_same(jax_state(ref), port.export_state(), version)
        if floor is not None:
            ref.remove_before(floor)
            port.remove_before(floor)


def test_constructor_keywords_are_validated():
    with pytest.raises(ValueError, match="merge_impl"):
        tdev.DeviceConflictSet(merge_impl="heap", device="cpu")
    with pytest.raises(ValueError, match="incremental"):
        tdev.DeviceConflictSet(incremental="0", device="cpu")
    with pytest.raises(ValueError, match="phase_timing"):
        tdev.DeviceConflictSet(phase_timing=1.5, device="cpu")
    s = tdev.DeviceConflictSet(rec_search_iters=99, device="cpu")
    assert s._rec_iters == 32
    assert tdev.DeviceConflictSet(rec_search_iters=0, device="cpu")._rec_iters == 1
    d = tdev.DeviceConflictSet(device="cpu")
    assert (d._incremental, d._merge_impl, d._rec_cap) == (True, "scatter", 1 << 13)
