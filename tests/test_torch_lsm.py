"""The port's best-known layout (bench.py's BEST_KNOWN: the bucketed search
and the LSM history table cached between compactions, incremental run
appends) held against the reference package on the CPU: the bucket index
and the bucketed search equal the reference's, and the port's set equals
the JAX DeviceConflictSet(lsm=True, search_impl="bucket") batch by batch —
verdicts, ks, vs, tab, bidx, runs, search fallbacks and compactions —
including a stream whose search does not converge after a compaction."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from foundationdb_tpu import keys as jkeys
from foundationdb_tpu.conflict import device as jdev
from foundationdb_tpu.conflict.api import TxInfo
from foundationdb_tpu.conflict.oracle import OracleConflictSet
from foundationdb_tpu.ops.rmq import _levels
from foundationdb_tpu_torch.conflict import device as tdev
from foundationdb_tpu_torch.keys import to_lanes
from tests.test_torch_device import _stream, assert_state_equal, jax_state

SENT = np.uint32(0xFFFFFFFF)
BEST = dict(lsm=True, search_impl="bucket")


def _key_rows(rng, n, shared_prefix=None, W=5):
    """`n` random key rows (uint32 layout) of 16-byte keys; word 0 spans
    the whole u32 range (both signs of the flipped lane), or keeps one
    fixed 16-bit prefix."""
    w0 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    if shared_prefix is not None:
        w0 = np.uint32(shared_prefix << 16) | (w0 & np.uint32(0xFFFF))
    rest = rng.integers(0, 1 << 32, (n, W - 2), dtype=np.uint64).astype(np.uint32)
    return np.concatenate([w0[:, None], rest, np.full((n, 1), 16, np.uint32)], 1)


def _sorted_rows(rng, n, cap, shared_prefix=None, W=5):
    """Main as the set holds it: the empty key, then sorted distinct rows
    of _key_rows, sentinel-padded to `cap`.  Returns (ks, count)."""
    rows = np.unique(_key_rows(rng, n, shared_prefix, W), axis=0)
    ks = np.full((cap, W), SENT, np.uint32)
    ks[0] = jkeys.encode_keys([b""], 16)[0]
    ks[1:1 + len(rows)] = rows
    return ks, 1 + len(rows)


@pytest.mark.parametrize("prefix", [None, 0x8000, 0xFFFE])
def test_bucket_index_matches(prefix):
    """host_bucket_index and the device _rebuild_buckets equal the
    reference's, sentinel rows and prefixes on both sides of the sign flip
    included."""
    ks, _n = _sorted_rows(np.random.default_rng(1), 600, 1024, prefix)
    want = jdev.host_bucket_index(ks)
    assert np.array_equal(want, np.asarray(jdev._rebuild_buckets(jnp.asarray(ks))))
    assert np.array_equal(want, tdev.host_bucket_index(ks))
    got = tdev._rebuild_buckets(to_lanes(ks))
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())
    assert int(got[-1]) == 1024 and int(got[-2]) == int(want[-2])


@pytest.mark.parametrize("case", ["random", "shared_prefix"])
def test_bucketed_search_matches(case):
    """_bucketed_lower_bound's ranks and convergence mask, and phase_search's
    five outputs, equal the reference's at the fast depth and at full depth
    — on random keys, and on 3000 keys of one 16-bit prefix whose bucket
    the fast depth cannot converge."""
    rng = np.random.default_rng(7)
    prefix = 0x5A5A if case == "shared_prefix" else None
    cap = 4096
    ks, count = _sorted_rows(rng, 3000, cap, prefix)
    live = ks[1:count]
    R, Wn = 64, 32
    # half the query keys are boundaries of main, half fall between them
    q = np.concatenate([live[rng.integers(0, len(live), R)],
                        _key_rows(rng, R, prefix)])
    q = q[rng.permutation(2 * R)]
    rb, re_ = np.minimum(q[:R], q[R:]), np.maximum(q[:R], q[R:])
    rb[-3:] = SENT
    re_[-3:] = SENT
    wb, we = rb[:Wn].copy(), re_[:Wn].copy()
    r_ok = np.arange(R) < R - 3
    w_ok = np.arange(Wn) < Wn - 3
    bidx = jdev.host_bucket_index(ks)
    for iters in (jdev.FAST_SEARCH_ITERS, _levels(cap) + 1):
        want = jdev._bucketed_lower_bound(jnp.asarray(ks), jnp.asarray(bidx),
                                          jnp.int32(count), jnp.asarray(rb), iters)
        got = tdev._bucketed_lower_bound(to_lanes(ks), torch.from_numpy(bidx),
                                         count, to_lanes(rb), iters)
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w), g.numpy()), iters
        want = jdev.phase_search(
            jnp.asarray(ks), jnp.asarray(bidx), jnp.int32(count),
            *map(jnp.asarray, (rb, re_, wb, we, r_ok, w_ok)), iters)
        got = tdev.phase_search(
            to_lanes(ks), torch.from_numpy(bidx), count, to_lanes(rb),
            to_lanes(re_), to_lanes(wb), to_lanes(we), torch.from_numpy(r_ok),
            torch.from_numpy(w_ok), iters)
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w), g.numpy()), iters
        converged = bool(got[-1])
        if iters > jdev.FAST_SEARCH_ITERS:
            assert converged
        else:
            assert converged == (case == "random")


def _deep_bucket_stream(n_keys=1100):
    """1100 point writes under one 16-bit prefix ("ZZ"), benign batches
    (one GC) until they are compacted into main, then probes whose search
    of the 2200-boundary bucket does not converge in FAST_SEARCH_ITERS."""
    keys = [b"ZZ%04d" % i for i in range(n_keys)]
    out = [(10, [TxInfo(0, [], [(k, k + b"\x00")]) for k in keys], None)]
    v = 10
    for i in range(3):
        v += 10
        out.append((v, [TxInfo(v - 5, [(b"ZZ%04d" % (100 * i + 7),
                                         b"ZZ%04d" % (100 * i + 8))],
                               [(b"a%02d" % i, b"a%02d\x00" % i)])],
                    v - 15 if i == 1 else None))
    v += 10
    out.append((v, [TxInfo(v - 5, [(b"ZZ0500", b"ZZ0501")], [(b"q", b"q\x00")]),
                    TxInfo(v - 5, [(b"ZZ0001", b"ZZ0999")], [])], None))
    return out


def _held_against_jax(stream, pallas, **set_args):
    """The stream through the oracle, the JAX best-known set (its Pallas
    kernels lowered as `pallas` says) and the port on the CPU."""
    oracle = OracleConflictSet()
    ref = jdev.DeviceConflictSet(**BEST, incremental=True, pallas=pallas,
                                 **set_args)
    port = tdev.DeviceConflictSet(**BEST, device="cpu", **set_args)
    for version, txns, floor in stream:
        want = oracle.resolve_batch(version, txns)
        assert ref.resolve_batch(version, txns) == want
        assert port.resolve_batch(version, txns) == want, version
        assert_state_equal(jax_state(ref), port.export_state(), version)
        assert port.node_count == ref.node_count, version
        assert port.search_fallbacks == ref.search_fallbacks, version
        assert port.stats.search_fallbacks == ref.stats.search_fallbacks
        assert port.stats.compactions == ref.compactions, version
        if floor is not None:
            for s in (oracle, ref, port):
                s.remove_before(floor)
    return port


def test_best_known_stream_matches_jax():
    """Randomized batches with GC at a capacity where the bucketed windows
    (not the full-depth search) run: identical verdicts and state after
    every batch; compactions and run regrows fire, the search converges."""
    port = _held_against_jax(list(_stream(0, 15)), "interpret", capacity=1 << 11,
                             run_slots=3, run_capacity=64)
    assert port.stats.compactions >= 4 and port._run_cap > 64
    assert port.search_fallbacks == 0
    assert "tab" in port.export_state()


def test_best_known_fallback_after_compaction_matches_jax():
    """A deep bucket compacted into main (regrowing it) makes later
    searches miss the fast depth: both sets replay at full depth on the
    same batches, and stay identical."""
    from foundationdb_tpu_torch.runtime import coverage

    before = coverage.hits("kernel.search_fallback.inc")
    port = _held_against_jax(_deep_bucket_stream(), "interpret", capacity=1 << 11,
                             run_slots=2, run_capacity=64)
    assert port.search_fallbacks == 2
    assert coverage.hits("kernel.search_fallback.inc") == before + 2
    assert port.capacity == 1 << 12  # main regrew at the compaction


def test_constructor_rejects_unknown_layouts():
    with pytest.raises(ValueError, match="search_impl"):
        tdev.DeviceConflictSet(search_impl="gather", device="cpu")
    with pytest.raises(ValueError, match="lsm"):
        tdev.DeviceConflictSet(lsm="1", device="cpu")
    flat = tdev.DeviceConflictSet(device="cpu")
    assert (flat._search_impl, flat._lsm, flat._tab) == ("sort", False, None)


def test_best_known_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.DeviceConflictSet(**BEST)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.BatchStager()


def test_gc_clamps_the_cached_table_as_a_rebuild_would():
    """remove_before clamps the cached table instead of rebuilding it; the
    clamp commutes with range-max, so the result is the rebuilt table."""
    port = tdev.DeviceConflictSet(**BEST, capacity=1 << 11, run_slots=2,
                                  run_capacity=64, device="cpu")
    for version, txns, _floor in _stream(3, 12):
        port.resolve_batch(version, txns)
    assert port.stats.compactions >= 2
    port.remove_before(port._last_commit - 3)
    rebuilt = tdev.build_sparse_table(port._vs, torch.maximum, 0)
    assert torch.equal(port._tab, rebuilt)


@pytest.mark.parametrize("incremental", [True, False], ids=["incremental", "legacy"])
def test_node_count_matches_reference_on_the_lsm_layout(incremental):
    """node_count (the reference's boundary_count) counts the recent
    level's rows whenever `lsm` is set: its floor row on the incremental
    path, where that level stays idle, and its live rows on the legacy
    path.  Equal to the reference's on a fresh set and after every batch
    and GC."""
    args = dict(BEST, incremental=incremental, capacity=1 << 8, run_slots=3,
                run_capacity=64, recent_capacity=65)
    ref = jdev.DeviceConflictSet(**args)
    port = tdev.DeviceConflictSet(device="cpu", **args)
    assert port.node_count == ref.node_count == 2
    for version, txns, floor in _stream(3, 12):
        assert port.resolve_batch(version, txns) == ref.resolve_batch(version, txns)
        assert port.node_count == ref.node_count, version
        if floor is not None:
            ref.remove_before(floor)
            port.remove_before(floor)
            assert port.node_count == ref.node_count, version
    assert port.stats.compactions >= 1
    assert port.kernel_stats()["node_count"] == ref.node_count
