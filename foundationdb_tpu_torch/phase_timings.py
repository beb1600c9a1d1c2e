"""Per-phase accounting of the conflict check on the card: the analog of
skipListTest's sort/combine/checkRead/merge PerfCounters
(fdbserver/SkipList.cpp:1412-1502).

    python -m foundationdb_tpu_torch.phase_timings [--small] [--json [PATH|-]]
    python -m foundationdb_tpu_torch.phase_timings --small --device cpu

Port of the repository root's phase_timings.py.  On a prefilled state at
the bench's shapes it times CUMULATIVE truncations of resolve_core (search,
+ history, + intra, the full legacy resolve), the LSM layout's full
resolve and its compaction (amortised over the batches a recent level
holds), and the three merges side by side at the recent level's size and
at main's.  Each truncation returns one scalar digest (the sums the
reference returns, wrapped to int32 as its jnp sums wrap), so the digests
of two devices can be compared.  A phase's cost is the difference between
successive truncations.

A truncation here is a run of torch launches, not one compiled program,
and the port's phases may read the device on the host inside (the
bucketed search's convergence is one): each time is the host clock around
the work and a synchronize, so the ladder measures what the port pays,
host syncs included.  `rtt_ms`, the floor subtracted from every time, is
one trivial launch plus a synchronize (the reference subtracts a tunnel
round trip).  As in the reference, the flat set is profiled with its runs
still pending: the truncations search its main level only.

`collect()` returns the report dict (control/status.py
PHASE_PROFILE_SCHEMA); `--json` writes it, or prints it as one
`PHASE_PROFILE {...}` line with `-`; bench.py embeds it as
`kernel.phase_profile`.  `digests(prepare(...))` returns each
truncation's digest.  The device is CUDA unless the caller asks for the
CPU; there is no fallback.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from . import bench as B
from .conflict import device as D
from .ops.rmq import build_sparse_table

LADDER = ("search", "search+hist", "search+hist+intra", "FULL kernel")
MERGES = ("sort", "gather", "scatter")
MERGE_COMMIT_OFF = 1000  # the shootout merges its writes at this offset


class Batch(NamedTuple):
    """One staged batch (stage_batch's eight tensors) and its commit offset."""
    rb: torch.Tensor
    re_: torch.Tensor
    r_tx: torch.Tensor
    wb: torch.Tensor
    we: torch.Tensor
    w_tx: torch.Tensor
    snap: torch.Tensor
    active: torch.Tensor
    commit_off: int


class Profiled(NamedTuple):
    """The prefilled sets and the batch the truncations run."""
    device: torch.device
    rec_cap: int
    flat: D.DeviceConflictSet   # the default set: incremental, flat main
    lsm: D.DeviceConflictSet    # lsm=True: main's cached history table
    batch: Batch


def _digest(*parts: torch.Tensor) -> torch.Tensor:
    """The sum of every element of every part, wrapped as the reference's
    int32 sums wrap (a 0-d int64 tensor)."""
    total = sum(p.sum(dtype=torch.int64) for p in parts)
    return torch.remainder(total + 2**31, 2**32) - 2**31


def _masks(b: Batch):
    return D._batch_masks(b.r_tx, b.wb, b.w_tx, b.snap.shape[0])


def _searched(ks, bidx, count, b: Batch):
    r_ok, r_idx, w_ok, w_idx = _masks(b)
    g_lo, g_hi, wbr, wer, _conv = D.phase_search(
        ks, bidx, count, b.rb, b.re_, b.wb, b.we, r_ok, w_ok, D.FAST_SEARCH_ITERS)
    return g_lo, g_hi, wbr, wer, (r_ok, r_idx, w_ok, w_idx)


def t_search(ks, vs, bidx, count, b: Batch) -> torch.Tensor:
    """The bucketed state search of every query class."""
    g_lo, g_hi, wbr, wer, _m = _searched(ks, bidx, count, b)
    return _digest(g_lo, g_hi, wbr, wer)


def _history(ks, vs, bidx, count, b: Batch):
    g_lo, g_hi, _wbr, _wer, m = _searched(ks, bidx, count, b)
    r_ok, r_idx, _w_ok, _w_idx = m
    return g_lo, D.phase_history(vs, g_lo, g_hi, b.snap, r_idx, r_ok, b.snap.shape[0]), m


def t_hist(ks, vs, bidx, count, b: Batch) -> torch.Tensor:
    """The search, then the history bits by range-max of vs."""
    g_lo, hist, _m = _history(ks, vs, bidx, count, b)
    return _digest(g_lo, hist)


def t_intra(ks, vs, bidx, count, b: Batch):
    """The search, history, then the intra-batch fixpoint (kernel K2).
    Returns (digest, fixpoint iterations)."""
    g_lo, hist, (r_ok, r_idx, w_ok, w_idx) = _history(ks, vs, bidx, count, b)
    intra, n_iters = D.phase_intra(b.rb, b.re_, b.wb, b.we, r_ok, w_ok, r_idx, w_idx,
                                   b.w_tx, b.active, hist, b.snap.shape[0])
    return _digest(g_lo, hist, intra), n_iters


def t_full(ks, vs, bidx, count, b: Batch) -> torch.Tensor:
    """The whole legacy resolve: search, history, intra, the scatter merge
    and the bucket rebuild."""
    verdict, _nks, _nvs, ncount, nbidx, _conv, _iters = D.resolve_core(
        ks, vs, bidx, count, *b[:8], b.commit_off, cap=ks.shape[0],
        n_txn=b.snap.shape[0])
    return _digest(verdict, ncount, nbidx[0])


def t_lsm(ks, tab, bidx, count, rks, rvs, rbidx, rcount, b: Batch) -> torch.Tensor:
    """The LSM layout's full resolve (no compaction): main searched and its
    cached table read, the recent level searched and merged into."""
    verdict, _rk, _rv, _rb, nrc, _conv, _iters = D.resolve_core_lsm(
        ks, tab, bidx, count, rks, rvs, rbidx, rcount, *b[:8], b.commit_off,
        rec_cap=rks.shape[0], n_txn=b.snap.shape[0])
    return _digest(verdict, nrc)


def t_comp(ks, vs, rks, rvs) -> torch.Tensor:
    """The LSM compaction: the recent level folded into main (kernel K3),
    then main's bucket index and history table rebuilt."""
    nks, nvs, nc = D.compact_lsm(ks, vs, rks, rvs, cap=ks.shape[0])
    nb = D._rebuild_buckets(nks)
    nt = build_sparse_table(nvs, torch.maximum, 0)
    return _digest(nc, nb[0], nt[0, 0])


def merge_ranks(ks, count, b: Batch):
    """The write ranks the shootout's merges take: the sort search (exact
    at any depth)."""
    _g_lo, _g_hi, wbr, wer = D.phase_search_sort(ks, count, b.rb, b.re_, b.wb, b.we)
    return wbr, wer


def merge(impl: str, ks, vs, wbr, wer, b: Batch):
    """Every live write of the batch merged into the level (ks, vs) by one
    merge.  Returns (new_ks, new_vs, new_count)."""
    _r_ok, _r_idx, w_ok, _w_idx = _masks(b)
    return D._MERGE_IMPLS[impl](ks, vs, b.wb, b.we, wbr, wer, w_ok, MERGE_COMMIT_OFF,
                                cap=ks.shape[0])


def t_merge(impl: str, ks, vs, wbr, wer, b: Batch) -> torch.Tensor:
    nk, nv, nc = merge(impl, ks, vs, wbr, wer, b)
    return _digest(nc, nv[0], nk[0, 0])


def prepare(*, small: bool = False, device=None, txns: int | None = None,
            prefill: int | None = None) -> Profiled:
    """The bench's stream (its seed, pool and batches): the default set and
    an LSM set prefilled, and the first batch after the prefill staged on
    the device.  `small` cuts the capacities and the prefill (the bench's
    embedded profile); `txns` defaults to the bench's, and `prefill`
    only serves tests."""
    dev = D.resolve_device(device)
    cap = (1 << 15) if small else B.CAP
    rec_cap = (1 << 12) if small else B.REC_CAP
    n_prefill = prefill if prefill is not None else (4 if small else B.PREFILL_BATCHES)
    n_txns = txns or B.TXNS_PER_BATCH
    rng = np.random.default_rng(B.SEED)
    pool = B.gen_pool(rng)
    words = B.pool_to_words(pool)
    versions = iter(range(1, 10_000))
    batches = [B.gen_batch(rng, pool, next(versions), n_txns) for _ in range(n_prefill + 1)]
    flat = D.DeviceConflictSet(max_key_bytes=B.MAX_KEY_BYTES, capacity=cap, device=dev)
    lsm = D.DeviceConflictSet(max_key_bytes=B.MAX_KEY_BYTES, capacity=cap, lsm=True,
                              recent_capacity=rec_cap, device=dev)
    for name, cs in (("", flat), ("LSM ", lsm)):
        t0 = time.perf_counter()
        for b in batches[:-1]:
            cs.resolve_arrays(b["version"], *B.device_pack(words, b, D._bucket))
        print(f"{name}prefill {time.perf_counter() - t0:.1f}s, live boundaries "
              f"{cs.boundary_count} (compactions: {cs.stats.compactions})", flush=True)
    last = batches[-1]
    staged = D.stage_batch(dev, *B.device_pack(words, last, D._bucket))
    return Profiled(dev, rec_cap, flat, lsm,
                    Batch(*staged, flat._offset(last["version"])))


def _flat_state(p: Profiled) -> tuple:
    return (p.flat._ks, p.flat._vs, p.flat._bidx, p.flat._main_count())


def _lsm_state(p: Profiled) -> tuple:
    s = p.lsm
    return (s._ks, s._tab, s._bidx, s._main_count(), s._rec_ks, s._rec_vs,
            s._rec_bidx, s._rec_count_now())


def _levels_of(p: Profiled) -> tuple:
    """(label, ks, vs, count) of the shootout's two levels, labelled as the
    reference labels them."""
    return ((f"recent 2^{p.rec_cap.bit_length() - 1}", p.lsm._rec_ks, p.lsm._rec_vs,
             p.lsm._rec_count_now()),
            (f"main   2^{p.flat._cap.bit_length() - 1}", p.flat._ks, p.flat._vs,
             p.flat._main_count()))


def step_ms(dev: torch.device, fn, *args, reps: int):
    """Median host-clock ms of fn(*args) followed by a synchronize, over
    `reps` calls after one untimed call.  Returns (ms, the last output)."""
    out = fn(*args)
    B._synchronize(dev)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        B._synchronize(dev)
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2] * 1e3, out


def rtt_ms(dev: torch.device) -> float:
    """The floor: one trivial launch plus a synchronize, median of 5."""
    one = torch.ones(8, dtype=torch.int32, device=dev)
    return step_ms(dev, torch.add, one, 1, reps=5)[0]


def digests(p: Profiled) -> dict:
    """Each truncation evaluated once on p's state: its digest as a host
    int, by its report label; `intra_iters`; and each shootout merge's
    digest as `merge <level> <impl>`."""
    st, b = _flat_state(p), p.batch
    intra, n_iters = t_intra(*st, b)
    out = {"search": t_search(*st, b), "search+hist": t_hist(*st, b),
           "search+hist+intra": intra, "FULL kernel": t_full(*st, b),
           "LSM FULL": t_lsm(*_lsm_state(p), b),
           "LSM compaction": t_comp(p.lsm._ks, p.lsm._vs, p.lsm._rec_ks, p.lsm._rec_vs)}
    for label, ks, vs, count in _levels_of(p):
        wbr, wer = merge_ranks(ks, count, b)
        for impl in MERGES:
            out[f"merge {label.replace(' ', '')} {impl}"] = t_merge(impl, ks, vs, wbr, wer, b)
    out = {k: int(v) for k, v in out.items()}
    out["intra_iters"] = int(n_iters)
    return out


def collect(*, small: bool = False, device=None, txns: int | None = None,
            prefill: int | None = None, reps: int | None = None) -> dict:
    """Measure every phase and return the report dict (the keys of
    PHASE_PROFILE_SCHEMA, the reference's labels).  `small` shrinks the
    capacities and repetitions for bench.py's embedded run, which also
    passes its `txns`; `prefill` and `reps` only serve tests (their
    defaults are the reference's)."""
    p = prepare(small=small, device=device, txns=txns, prefill=prefill)
    dev, b = p.device, p.batch
    reps = reps or (3 if small else 5)
    out: dict = {
        "backend": dev.type,
        "small": small,
        "cap": p.flat._cap,
        "rec_cap": p.rec_cap,
        "merge_impl_default": p.flat._merge_impl,
    }
    print(f"backend: {out['backend']}", flush=True)
    out["shapes"] = {"n_txn": b.snap.shape[0], "n_read": b.rb.shape[0],
                     "n_write": b.wb.shape[0], "cap": p.flat._cap}
    rtt = out["rtt_ms"] = rtt_ms(dev)
    print(f"RTT floor {rtt:.1f} ms (one trivial launch + synchronize)", flush=True)

    st, results = _flat_state(p), {}
    for name, fn in zip(LADDER, (t_search, t_hist, t_intra, t_full)):
        ms, o = step_ms(dev, fn, *st, b, reps=reps)
        results[name] = ms = ms - rtt
        extra = ""
        if name == "search+hist+intra":
            out["intra_iters"] = int(o[1])
            extra = f"  (fixpoint iters: {out['intra_iters']})"
        print(f"  {name:<22s} {ms:9.1f} ms{extra}", flush=True)

    s = results
    out["cumulative_ms"] = {k: round(v, 2) for k, v in results.items()}
    out["phases_ms"] = {
        "search": round(s["search"], 2),
        "history": round(s["search+hist"] - s["search"], 2),
        "intra": round(s["search+hist+intra"] - s["search+hist"], 2),
        "merge_buckets": round(s["FULL kernel"] - s["search+hist+intra"], 2),
        "full": round(s["FULL kernel"], 2),
    }
    print("\nphase deltas:", flush=True)
    print(f"  search          {s['search']:9.1f} ms")
    print(f"  history (RMQ)   {s['search+hist'] - s['search']:9.1f} ms")
    print(f"  intra fixpoint  {s['search+hist+intra'] - s['search+hist']:9.1f} ms")
    print(f"  merge+buckets   {s['FULL kernel'] - s['search+hist+intra']:9.1f} ms")

    # ---- LSM path: full resolve + amortised compaction ----------------------
    lsm_ms = step_ms(dev, t_lsm, *_lsm_state(p), b, reps=reps)[0] - rtt
    print(f"  LSM FULL (no compact)  {lsm_ms:9.1f} ms", flush=True)
    comp_ms = step_ms(dev, t_comp, p.lsm._ks, p.lsm._vs, p.lsm._rec_ks, p.lsm._rec_vs,
                      reps=3)[0] - rtt
    batches_per_compact = max((p.rec_cap - 1) // (2 * b.wb.shape[0]), 1)
    print(f"  LSM compaction         {comp_ms:9.1f} ms "
          f"(/{batches_per_compact} batches = "
          f"{comp_ms / batches_per_compact:.1f} ms amortized)", flush=True)
    print(f"  LSM effective/batch    {lsm_ms + comp_ms / batches_per_compact:9.1f} ms",
          flush=True)
    out["lsm"] = {
        "full_ms": round(lsm_ms, 2),
        "compact_ms": round(comp_ms, 2),
        "batches_per_compact": batches_per_compact,
        "effective_ms": round(lsm_ms + comp_ms / batches_per_compact, 2),
    }

    # ---- the merge shootout, at the recent level's size and at main's -------
    print("\nmerge-impl shootout:", flush=True)
    shootout = out["merge_shootout_ms"] = {}
    for label, ks, vs, count in _levels_of(p):
        wbr, wer = merge_ranks(ks, count, b)
        row = shootout[label.replace(" ", "")] = {}
        for impl in MERGES:
            ms = step_ms(dev, t_merge, impl, ks, vs, wbr, wer, b, reps=reps)[0] - rtt
            row[impl] = round(ms, 2)
            print(f"  {label} merge={impl:<8s} {ms:9.1f} ms", flush=True)
    return out


def main(argv=None) -> int:
    from .profile_kernel import card_line

    ap = argparse.ArgumentParser(prog="python -m foundationdb_tpu_torch.phase_timings",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="reduced capacities and repetitions (the bench's embedded run)")
    ap.add_argument("--json", nargs="?", const="-", default=None, metavar="PATH",
                    help="write the report to PATH, or print it as a PHASE_PROFILE line")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(f"card: {card_line(D.resolve_device(args.device))}", flush=True)
    report = collect(small=args.small, device=args.device)
    if args.json is not None:
        payload = json.dumps(report, sort_keys=True)
        if args.json == "-":
            print(f"PHASE_PROFILE {payload}", flush=True)
        else:
            with open(args.json, "w") as f:
                f.write(payload + "\n")
            print(f"phase profile written to {args.json}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
