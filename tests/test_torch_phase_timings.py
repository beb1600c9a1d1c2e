"""The port's phase_timings (foundationdb_tpu_torch/phase_timings.py) on the
CPU against the reference's truncations: the same packed batches prefill the
port's sets and the reference's, and each truncation's digest and the
fixpoint's iterations are equal (integer sums, so exactly); the three merges
of the shootout agree with each other and with the reference's scatter merge;
collect()'s report conforms to PHASE_PROFILE_SCHEMA with the reference's
labels; the CLI prints one PHASE_PROFILE line; no card, no run."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.conflict import device as jdev
from foundationdb_tpu_torch import bench, phase_timings
from foundationdb_tpu_torch.conflict import device as tdev
from foundationdb_tpu_torch.control.status import check_phase_profile
from foundationdb_tpu_torch.keys import from_lanes

TXNS, PREFILL = 48, 3
SMALL_CAP, SMALL_REC_CAP = 1 << 15, 1 << 12


@functools.cache
def _reference(compacted: bool):
    """The reference's default and LSM sets prefilled with the stream
    prepare() draws, and the next batch packed for it (built once a
    module; no test changes them)."""
    rng = np.random.default_rng(bench.SEED)
    pool = bench.gen_pool(rng)
    words = bench.pool_to_words(pool)
    batches = [bench.gen_batch(rng, pool, v, TXNS) for v in range(1, PREFILL + 2)]
    flat = jdev.DeviceConflictSet(max_key_bytes=bench.MAX_KEY_BYTES, capacity=SMALL_CAP)
    lsm = jdev.DeviceConflictSet(max_key_bytes=bench.MAX_KEY_BYTES, capacity=SMALL_CAP,
                                 lsm=True, recent_capacity=SMALL_REC_CAP)
    for b in batches[:-1]:
        for s in (flat, lsm):
            s.resolve_arrays(b["version"], *bench.device_pack(words, b, tdev._bucket))
    if compacted:
        flat._compact_runs()
        lsm._compact_runs()
    packed = [jnp.asarray(a) for a in bench.device_pack(words, batches[-1], tdev._bucket)]
    return flat, lsm, packed, jnp.int32(flat._offset(batches[-1]["version"]))


def _reference_digests(flat, lsm, packed, commit_off) -> dict:
    """The reference's truncations (phase_timings.py:77-126, :196-224),
    restated on its sets, compiled as one program."""
    state = (flat._ks, flat._vs, flat._bidx, flat._dev_count, lsm._ks, lsm._vs, lsm._tab,
             lsm._bidx, lsm._dev_count, lsm._rec_ks, lsm._rec_vs, lsm._rec_bidx,
             lsm._rec_dev_count)
    out = jax.jit(_truncations, static_argnums=(3, 4))(state, packed, commit_off,
                                                         flat._cap, lsm._rec_cap)
    return {k: int(v) for k, v in out.items()}


def _truncations(state, packed, commit_off, cap, rec_cap):
    D = jdev
    (ks, vs, bidx, count, lks, lvs, ltab, lbidx, lcount, rks, rvs, rbidx,
     rcount) = state
    rbv, rev, rtv, wbv, wev, wtv, snap_p, active_p = packed
    Bp, R, Wn = snap_p.shape[0], rbv.shape[0], wbv.shape[0]
    r_ok, r_idx = rtv >= 0, jnp.clip(rtv, 0, Bp - 1)
    w_ok, w_idx = (wtv >= 0) & ~D._is_sentinel(wbv), jnp.clip(wtv, 0, Bp - 1)
    g_lo, g_hi, wbr, wer, _c = D.phase_search(ks, bidx, count, rbv, rev, wbv, wev,
                                              r_ok, w_ok, D.FAST_SEARCH_ITERS)
    hist = D.phase_history(vs, g_lo, g_hi, snap_p, r_idx, r_ok, Bp)
    intra, n_iters = D.phase_intra(rbv, rev, wbv, wev, r_ok, w_ok, r_idx, w_idx, wtv,
                                   active_p, hist, Bp)
    verdict, _k, _v, ncount, nbidx, _c, _ok = D.resolve_core(
        ks, vs, bidx, count, rbv, rev, rtv, wbv, wev, wtv, snap_p, active_p, commit_off,
        cap=cap, n_txn=Bp, n_read=R, n_write=Wn)
    lverdict, _k, _v, _b, nrc, _c, _ok = D.resolve_core_lsm(
        lks, lvs, ltab, lbidx, lcount, rks, rvs, rbidx, rcount, rbv, rev, rtv, wbv, wev,
        wtv, snap_p, active_p, commit_off, cap=cap, rec_cap=rec_cap, n_txn=Bp,
        n_read=R, n_write=Wn)
    _k, _v, nc, nb, nt = D.compact_lsm(lks, lvs, rks, rvs, cap=cap)
    return {
        "search": g_lo.sum() + g_hi.sum() + wbr.sum() + wer.sum(),
        "search+hist": g_lo.sum() + hist.sum(),
        "search+hist+intra": g_lo.sum() + hist.sum() + intra.sum(),
        "FULL kernel": verdict.sum() + ncount + nbidx[0],
        "LSM FULL": lverdict.sum() + nrc,
        "LSM compaction": nc + nb[0] + nt[0, 0],
        "intra_iters": n_iters,
    }


def _port(compacted: bool):
    p = phase_timings.prepare(small=True, device="cpu", txns=TXNS, prefill=PREFILL)
    if compacted:
        p.flat._compact_runs()
        p.lsm._compact_runs()
    return p


@pytest.mark.parametrize("compacted", [False, True], ids=["runs_pending", "compacted"])
def test_truncation_digests_equal_the_reference(compacted):
    """Each of the six truncations and the fixpoint's iterations, on the
    state as the reference profiles it (runs pending) and on a main level
    holding the folded runs."""
    got = phase_timings.digests(_port(compacted))
    want = _reference_digests(*_reference(compacted))
    assert {k: got[k] for k in want} == want
    if compacted:  # a real main level: the search ranks are not all 0
        assert want["search"] != 0 and want["search+hist"] != 0


@pytest.mark.parametrize("level", [0, 1], ids=["recent", "main"])
def test_the_three_merges_agree_with_the_reference(level):
    """The shootout's sort, gather and scatter merges give one state, the
    reference's scatter merge's on the same level and ranks."""
    p = _port(True)
    flat, lsm, packed, _off = _reference(True)
    label, ks, vs, count = phase_timings._levels_of(p)[level]
    wbr, wer = phase_timings.merge_ranks(ks, count, p.batch)
    outs = [phase_timings.merge(impl, ks, vs, wbr, wer, p.batch)
            for impl in phase_timings.MERGES]
    for impl, (nk, nv, nc) in zip(phase_timings.MERGES[1:], outs[1:]):
        assert torch.equal(nk, outs[0][0]) and torch.equal(nv, outs[0][1]), impl
        assert int(nc) == int(outs[0][2]), impl
    jks, jvs, jcount = ((lsm._rec_ks, lsm._rec_vs, lsm._rec_dev_count) if level == 0
                        else (flat._ks, flat._vs, flat._dev_count))
    rbv, rev, rtv, wbv, wev, wtv, snap_p, active_p = packed
    w_ok = (wtv >= 0) & ~jdev._is_sentinel(wbv)
    _gl, _gh, jwbr, jwer, _c = jdev.phase_search_sort(jks, jcount, rbv, rev, wbv, wev,
                                                      rtv >= 0, w_ok)
    np.testing.assert_array_equal(wbr.numpy(), np.asarray(jwbr))
    jk, jv, jc = jdev._MERGE_IMPLS["scatter"](jks, jvs, wbv, wev, jwbr, jwer, w_ok,
                                              jnp.int32(1000), cap=jks.shape[0])
    nk, nv, nc = outs[0]
    np.testing.assert_array_equal(from_lanes(nk), np.asarray(jk))
    np.testing.assert_array_equal(nv.numpy(), np.asarray(jv))
    assert int(nc) == int(jc) > 1, label


def test_collect_conforms_with_the_reference_labels():
    doc = phase_timings.collect(small=True, device="cpu", txns=TXNS, prefill=PREFILL,
                                reps=1)
    assert check_phase_profile(doc) == []
    assert (doc["backend"], doc["small"], doc["merge_impl_default"]) == ("cpu", True,
                                                                         "scatter")
    assert (doc["cap"], doc["rec_cap"]) == (SMALL_CAP, SMALL_REC_CAP)
    assert list(doc["cumulative_ms"]) == ["search", "search+hist", "search+hist+intra",
                                          "FULL kernel"]
    assert list(doc["phases_ms"]) == ["search", "history", "intra", "merge_buckets",
                                      "full"]
    assert list(doc["lsm"]) == ["full_ms", "compact_ms", "batches_per_compact",
                                "effective_ms"]
    assert doc["lsm"]["batches_per_compact"] == max((SMALL_REC_CAP - 1) // (2 * 64), 1)
    assert {k: list(v) for k, v in doc["merge_shootout_ms"].items()} == {
        "recent2^12": ["sort", "gather", "scatter"], "main2^15": ["sort", "gather", "scatter"]}
    assert doc["shapes"] == {"n_txn": 64, "n_read": 128, "n_write": 64, "cap": SMALL_CAP}
    assert doc["intra_iters"] == phase_timings.digests(_port(False))["intra_iters"] >= 1


def test_cli_prints_one_phase_profile_line(monkeypatch, capsys):
    monkeypatch.setattr(bench, "TXNS_PER_BATCH", TXNS)
    assert phase_timings.main(["--small", "--json", "-", "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("PHASE_PROFILE ")]
    assert len(lines) == 1
    doc = json.loads(lines[0][len("PHASE_PROFILE "):])
    assert check_phase_profile(doc) == [] and doc["backend"] == "cpu" and doc["small"]


def test_collect_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        phase_timings.collect(small=True)
