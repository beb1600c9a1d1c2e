"""Device (PyTorch/CUDA) ConflictSet — the resolver's batched OCC check.

Port of foundationdb_tpu/conflict/device.py.  The committed-write
history is a step function over key space, held in fixed-capacity
tensors:

  main   ks    int32[CAP, W]       sorted boundary keys (keys.py flipped
                                   lanes; sentinel-padded past `count`)
         vs    int32[CAP]          version offset of gap [ks[i], ks[i+1])
         bidx  int32[2**16 + 1]    word0-prefix bucket index of ks
         tab   int32[L, CAP]       range-max sparse table of vs (LSM only)
  runs   runs_b/runs_e int32[K, RUN_CAP, W]   one sorted, disjoint interval
                                   run per batch since the last compaction
         runs_ver int32[K]         commit offset per run (0 = dead)
  recent rec_ks/rec_vs/rec_bidx    a second, small step function (LSM
                                   only; idle on the incremental path)

The layouts are chosen by the constructor's keywords (the reference's,
with its defaults): `lsm=False, search_impl="sort"` is the reference
constructor's default; `lsm=True, search_impl="bucket"` is bench.py's
BEST_KNOWN, the configuration the repo measures; `incremental=False` is
the legacy per-batch merge (below).

Per batch on the incremental path (`resolve_core_inc`, or
`resolve_core_inc_lsm`):
  search   `inc_search`: every read ranked against main, either with ONE
           multi-key sort (`phase_search_sort`) or by a binary search
           inside each read's 16-bit-prefix bucket (`phase_search`, a fixed
           FAST_SEARCH_ITERS rounds; a bucket deeper than that does not
           converge, and the batch is replayed at full depth);
  check    `inc_check`: range-max of main's versions over each read
           (history; from a table built per batch out of vs, or from the
           LSM layout's table cached between compactions), the run probe
           (kernel K1, fused with history), then the intra-batch fixpoint
           (`phase_intra`: kernel K2 runs every iteration of it in one
           launch);
  append   `inc_append`: the committed writes' canonical union becomes the
           next run.
Every K batches `_compact_runs` folds the runs into main: each run becomes
a step function (kernel K4, one launch for all runs), and the scatter
fold max-composes each into main from cross ranks (kernel K3); bidx and
tab are rebuilt there only.
`remove_before` rebases versions (and clamps tab: the clamp commutes with
range-max).  `phase_timing=True` dispatches search, check and append one
at a time, each waited out, and times them.

The legacy path (`incremental=False`; `resolve_core`, `resolve_core_lsm`):
ONE search ranks reads and writes, history is a range-max of vs (and, LSM,
of the cached table ORed with the recent level's), the fixpoint runs (K2),
and the committed writes' canonical union MERGES into the state every
batch: into main (flat; regrown and replayed when it outgrows it), or into
the recent level (LSM), which `_compact` folds into main (K3) when it
fills.  `merge_impl` picks the merge and the fold: "scatter" (merge-path
positions from the ranks, row scatters), or the referees "sort" (one
multi-key sort, a stable 1-bit sort to compact) and "gather" (positions by
searchsorted, rows by gathers); all three give the same state.

Pipelining (conflict/pipeline.py): `resolve_arrays(..., sync=False)`
dispatches a batch and returns its verdicts as a device tensor without
waiting; the search's convergence folds into a device flag that
`check_pipelined()` reads.  `resolve_deferred` builds the split-phase
resolve on it, with snapshot/replay recovery.  So that a snapshot can be a
dict of references, every update of the state REBINDS a new tensor and
never writes one in place.  `BatchStager` runs `stage_batch` for
`PipelinedPacker` on a side stream and records an event after it.

All-integer and deterministic: on the CPU (`device="cpu"`) the kernels'
plain torch versions run, and verdicts and state are bit-identical to the
reference package's DeviceConflictSet batch by batch.  JAX's `mode="drop"`
scatters become writes into one spare slot past the end that is then
sliced off; `.at[].min` becomes `scatter_reduce_(..., "amin")` and `.at[].add`
`index_add_`.  The fixpoint's `lax.while_loop` stays on the device: on the
card K2 runs the whole loop in one launch and hands back its iteration
count as a device tensor, which the set sums on the device
(`fixpoint_iterations()` reads the sum); on the CPU it is a Python loop.
`host_syncs` counts every read of a device value on the host, and
`stats.host_reads` by site (conflict/pipeline.py).  Under a torch profiler
the set's steps are spans (api.span): `cs.resolve` around each call, with
`cs.stage`, `cs.search`, `cs.check`, `cs.append`, and `cs.compact` (K4's
`cs.compact.step`, each `cs.compact.fold`, `cs.compact.index`) inside;
`cs.gc` and each read's `cs.read.<site>`.
"""

from __future__ import annotations

import functools
import time
from itertools import chain
from operator import attrgetter
from typing import Sequence

import numpy as np
import torch

from .. import keys as keymod
from ..keys import SENT_LANE, to_lanes, from_lanes, with_last_lane_inc
from ..ops.rmq import I32_MAX, _levels, build_sparse_table, query_sparse_table
from ..ops.search import lex_less, lexsort
from ..runtime.coverage import testcov
from . import kernels
from .api import ConflictSet, KernelStats, TxInfo, Verdict, span, validate_batch
from .pipeline import READ_SITES, PipelinedConflictMixin

_SENT_WORD = np.uint32(0xFFFFFFFF)  # numpy (uint32) layout of the sentinel

BUCKET_BITS = 16
N_BUCKETS = 1 << BUCKET_BITS
FAST_SEARCH_ITERS = 11  # converges windows up to 1024 boundaries (2**(n-1))
SEARCH_IMPLS = ("sort", "bucket")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises when CUDA is wanted and absent — never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # the index the tensors made on it will carry
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _is_sentinel(rows: torch.Tensor) -> torch.Tensor:
    # real keys have a length lane <= 4*(W-1), far below the sentinel
    return rows[:, -1] == SENT_LANE


def _cumsum32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=torch.int32)


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


def _spare(n: int, fill, like: torch.Tensor) -> torch.Tensor:
    """[n + 1, ...] filled with `fill`: n rows plus one spare slot that
    takes the writes JAX's `mode="drop"` scatters would drop."""
    return torch.full((n + 1,) + tuple(like.shape[1:]), fill, dtype=like.dtype,
                      device=like.device)


def _put(buf: torch.Tensor, pos: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """buf[pos[i]] = src[i], positions past the last row landing in the
    spare slot (which may then hold any of them)."""
    return buf.index_copy_(0, torch.clamp(pos, max=buf.shape[0] - 1).long(), src)


def _set_rows(n: int, fill, pos: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """JAX's `jnp.full(n, fill).at[pos].set(src, mode="drop")`."""
    return _put(_spare(n, fill, src), pos, src)[:n]


# ---------------------------------------------------------------------------
# batch-local ranks, search and the intra-batch fixpoint


def _local_ranks(rows: torch.Tensor) -> torch.Tensor:
    """Dense order ranks of int32[N, W] rows: equal rows share a rank and
    strict rank order == strict lexicographic order."""
    n, W = rows.shape
    perm = lexsort([rows[:, w] for w in range(W)])
    srt = rows[perm]
    first = torch.ones(n, dtype=torch.int32, device=rows.device)
    first[1:] = torch.any(srt[1:] != srt[:-1], dim=1).to(torch.int32)
    rank_sorted = _cumsum32(first) - 1
    return torch.empty(n, dtype=torch.int32, device=rows.device).index_copy_(
        0, perm, rank_sorted
    )


def phase_search_sort(ks, count, rb, re_, wb=None, we=None):
    """Phase "sort" (the reference's phase_search_sort): rank every query
    against the state with ONE multi-key sort:
    lower_bound(q) = #state keys < q = (sorted position of q) - (#queries
    before q), queries ordered before equal state keys (flag 0 vs 1).
    Read begins query as upper bounds via the (words, len+1) trick.
    Returns (g_lo, g_hi): the gap holding each read's begin, and the first
    boundary >= its end, clamped to the live prefix `count` (an int or a
    device scalar).  The legacy merge also needs the writes' ranks: given
    wb and we, returns (g_lo, g_hi, wb_rank, we_rank)."""
    R, W = rb.shape
    cap = ks.shape[0]
    writes = [] if wb is None else [wb, we]
    queries = torch.cat([with_last_lane_inc(rb), re_] + writes, dim=0)
    nq = queries.shape[0]
    rows = torch.cat([queries, ks], dim=0)
    flag = torch.cat([
        torch.zeros(nq, dtype=torch.int32, device=ks.device),
        torch.ones(cap, dtype=torch.int32, device=ks.device),
    ])
    idx = torch.cat([
        _arange(nq, ks), torch.full((cap,), -1, dtype=torch.int32, device=ks.device)
    ])
    perm = lexsort([rows[:, w] for w in range(W)] + [flag])
    sidx = idx[perm]
    is_q = (sidx >= 0).to(torch.int32)
    n_q_before = _cumsum32(is_q) - is_q
    state_rank = torch.clamp(_arange(nq + cap, ks) - n_q_before, max=count)
    ranks = torch.zeros(nq + 1, dtype=torch.int32, device=ks.device)
    ranks.index_copy_(0, torch.where(is_q > 0, sidx, nq).long(), state_rank)
    if wb is None:
        return ranks[:R] - 1, ranks[R:nq]
    Wn = wb.shape[0]
    return (ranks[:R] - 1, ranks[R:2 * R], ranks[2 * R:2 * R + Wn],
            ranks[2 * R + Wn:nq])


def host_bucket_index(ks_rows: np.ndarray) -> np.ndarray:
    """word0-prefix bucket index of sorted boundary rows, host-side, in the
    uint32 layout (sentinels land in the last bucket): bucket_idx[h] =
    lower_bound of prefix h, bucket_idx[-1] = cap."""
    h = (np.asarray(ks_rows)[:, 0] >> BUCKET_BITS).astype(np.int64)
    return np.cumsum(np.bincount(h + 1, minlength=N_BUCKETS + 1))[
        : N_BUCKETS + 1
    ].astype(np.int32)


def _bucket_of(lane0: torch.Tensor) -> torch.Tensor:
    """The 16-bit prefix u >> 16 of a flipped lane (u ^ 0x80000000 held as
    int32): (lane >> 16) + 32768 with an arithmetic shift; the sentinel
    lane lands in bucket 65535."""
    return (lane0 >> BUCKET_BITS) + (1 << (31 - BUCKET_BITS))


def _rebuild_buckets(new_ks: torch.Tensor) -> torch.Tensor:
    """host_bucket_index on the device (the reference's phase 3d)."""
    h = _bucket_of(new_ks[:, 0])
    hist_b = torch.zeros(N_BUCKETS + 1, dtype=torch.int32, device=new_ks.device)
    hist_b.index_add_(0, (h + 1).long(), torch.ones_like(h))
    return _cumsum32(hist_b)


def _bucketed_lower_bound(ks, bucket_idx, count: int, q, iters: int):
    """lower_bound of q rows into ks, binary-searching only inside each
    query's 16-bit-prefix bucket window (exact: every boundary outside the
    window is strictly below or above q), clamped to the live prefix
    [0, count).  At full depth (iters >= _levels(n)) the search runs over
    [0, n) instead.  Returns (ranks, converged_mask)."""
    n = ks.shape[0]
    if iters >= _levels(n):
        lo = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
        hi = torch.full((q.shape[0],), n, dtype=torch.int32, device=q.device)
    else:
        h = _bucket_of(q[:, 0]).long()
        lo = torch.clamp(bucket_idx[h], max=count)
        hi = torch.clamp(bucket_idx[h + 1], max=count)
    for _ in range(iters):
        active = lo < hi
        mid = torch.clamp(torch.div(lo + hi, 2, rounding_mode="floor"), 0, n - 1)
        right = lex_less(ks[mid.long()], q)
        lo = torch.where(active & right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    return lo, lo >= hi


def phase_search(ks, bucket_idx, count: int, rb, re_, wb, we, r_ok, w_ok,
                 search_iters: int):
    """The ONE bucketed state search: every query class concatenated into
    a single lower_bound (read begins as upper bounds via the (words,
    len+1) trick).  Returns (g_lo, g_hi, wb_rank, we_rank, converged), the
    last a device bool: every live query's window converged."""
    R, Wn = rb.shape[0], wb.shape[0]
    queries = torch.cat([with_last_lane_inc(rb), re_, wb, we], dim=0)
    q_live = torch.cat([r_ok, r_ok, w_ok, w_ok])
    ranks, conv = _bucketed_lower_bound(ks, bucket_idx, count, queries,
                                        search_iters)
    converged = ~torch.any(q_live & ~conv)
    return (ranks[:R] - 1, ranks[R:2 * R], ranks[2 * R:2 * R + Wn],
            ranks[2 * R + Wn:], converged)


def inc_search(ks, bucket_idx, count: int, rb, re_, r_tx, *,
               search_iters: int = FAST_SEARCH_ITERS,
               search_impl: str = "bucket"):
    """Phase "sort": rank the READ queries against main (the incremental
    path never needs write ranks).  Returns (g_lo, g_hi, converged);
    converged is None for the sort search, which is exact at any depth."""
    if search_impl == "sort":
        g_lo, g_hi = phase_search_sort(ks, count, rb, re_)
        return g_lo, g_hi, None
    r_ok = r_tx >= 0
    g_lo, g_hi, _wr, _wer, conv = phase_search(
        ks, bucket_idx, count, rb, re_, rb[:0], re_[:0], r_ok, r_ok[:0],
        search_iters,
    )
    return g_lo, g_hi, conv


def _intra_setup(rb, re_, wb, we):
    R, Wn = rb.shape[0], wb.shape[0]
    lr = _local_ranks(torch.cat([rb, re_, wb, we], dim=0))
    return lr[:R], lr[R:2 * R], lr[2 * R:2 * R + Wn], lr[2 * R + Wn:]


def phase_intra_dense(rb, re_, wb, we, r_ok, w_ok, r_idx, w_idx, w_tx, active,
                      hist, n_txn: int):
    """Dense-referee intra fixpoint: the [R, Wn] overlap predicate
    recomputed each iteration (O(R*Wn)); the referee of `phase_intra` in
    the tests.  Returns (intra, n_iters)."""
    B = n_txn
    rb_r, re_r, wb_r, we_r = _intra_setup(rb, re_, wb, we)
    tx_iota = _arange(B, rb)
    ov = (wb_r[None, :] < re_r[:, None]) & (rb_r[:, None] < we_r[None, :])

    def step(intra):
        committed = active & ~hist & ~intra
        w_com = w_ok & committed[w_idx.long()]
        w_cand = torch.where(w_com, w_tx, I32_MAX)
        minw = torch.where(ov, w_cand[None, :], I32_MAX).amin(dim=1)
        minw = torch.where(r_ok, minw, I32_MAX)
        tx_minw = torch.full((B,), I32_MAX, dtype=torch.int32, device=rb.device)
        tx_minw.scatter_reduce_(0, r_idx.long(), minw, "amin")
        return tx_minw < tx_iota

    return kernels._fixpoint(step, B, rb.device)


def phase_intra(rb, re_, wb, we, r_ok, w_ok, r_idx, w_idx, w_tx, active,
                hist, n_txn: int):
    """Intra-batch conflicts in RANK space (reference device.py:320): per
    iteration minw(r) = min txn index over committed writers overlapping
    read r, split exactly by where the writer begins —

      case 1  rb_r < wb_r < re_r: a min-sparse-table over writer begins,
              range-min on ranks (rb_r, re_r);
      case 2  wb_r <= rb_r < we_r: a block-decomposition stab, the min over
              write intervals containing rank rb_r;

    both per read.  "txn t conflicts iff a strictly earlier committed txn
    writes a range t reads" iterates to a fixpoint with the reference's
    exact iteration count: kernel K2 (`kernels.intra_fixpoint`) runs the
    whole loop in one launch.  Returns (intra, n_iters int32[1]), the count
    a device tensor."""
    rb_r, re_r, wb_r, we_r = _intra_setup(rb, re_, wb, we)
    return kernels.intra_fixpoint(rb_r, re_r, wb_r, we_r, r_ok, w_ok, r_idx,
                                  w_idx, w_tx, active, hist, n_txn)


# ---------------------------------------------------------------------------
# the per-batch check and the run append


def _batch_masks(r_tx, wb, w_tx, n_txn: int):
    """(r_ok, r_idx, w_ok, w_idx): live reads and writes, and their txn
    indices clamped into the batch."""
    r_ok = r_tx >= 0
    r_idx = torch.clamp(r_tx, 0, n_txn - 1).long()
    w_ok = (w_tx >= 0) & ~_is_sentinel(wb)
    w_idx = torch.clamp(w_tx, 0, n_txn - 1).long()
    return r_ok, r_idx, w_ok, w_idx


def _verdicts(active, committed):
    return torch.where(
        active,
        torch.where(committed, int(Verdict.COMMITTED), int(Verdict.CONFLICT)),
        int(Verdict.TOO_OLD),
    ).to(torch.int32)


def inc_check(hist_base, g_lo, g_hi, rb, re_, r_tx, wb, we, w_tx, snap,
              active, runs_b, runs_e, runs_ver, *, n_txn: int,
              from_table: bool = False):
    """Phase "scan": main-level history bits (from a range-max table built
    here out of the gap versions `hist_base`, or, `from_table`, from the
    LSM layout's cached table), the run probe fused with them (kernel K1),
    the intra-batch fixpoint.  Returns (verdict int32[B], w_ins bool[Wn],
    fixpoint iterations int32[1]) — w_ins marks the live writes of
    committed txns."""
    B = n_txn
    r_ok, r_idx, w_ok, w_idx = _batch_masks(r_tx, wb, w_tx, B)
    tab = hist_base if from_table else build_sparse_table(hist_base, torch.maximum, 0)
    read_max = query_sparse_table(tab, g_lo, g_hi, torch.maximum, 0)
    snap_r = snap[r_idx]
    hist_r = r_ok & (read_max > snap_r)
    conf_r = kernels.probe_fused(
        rb, re_, snap_r, r_ok, runs_b, runs_e, runs_ver, hist_r
    )
    hist = torch.zeros(B, dtype=torch.int32, device=rb.device).index_add_(
        0, r_idx, (r_ok & conf_r).to(torch.int32)
    ) > 0
    intra, n_iters = phase_intra(
        rb, re_, wb, we, r_ok, w_ok, r_idx, w_idx, w_tx, active, hist, B
    )
    committed = active & ~hist & ~intra
    return _verdicts(active, committed), w_ok & committed[w_idx], n_iters


def _union_intervals(wb, we, w_ins, *, run_cap: int):
    """Canonical disjoint interval union of the committed writes, compacted
    to the front and sentinel-padded to run_cap: ONE 2Wn-row multi-key
    sort finds coverage transitions (begins sort before equal ends, so
    adjacent intervals coalesce), then the begin/end rows compact by
    cumsum + row scatter.  Returns (u_b, u_e)."""
    Wn, W = wb.shape
    n = 2 * Wn
    live = torch.cat([w_ins, w_ins])
    rows = torch.where(live[:, None], torch.cat([wb, we], dim=0), SENT_LANE)
    tie = torch.cat([
        torch.zeros(Wn, dtype=torch.int32, device=wb.device),
        torch.ones(Wn, dtype=torch.int32, device=wb.device),
    ])
    delta = torch.where(
        live, torch.cat([torch.ones_like(tie[:Wn]), -torch.ones_like(tie[:Wn])]), 0
    ).to(torch.int32)
    perm = lexsort([rows[:, w] for w in range(W)] + [tie])
    srows = rows[perm]
    cov = _cumsum32(delta[perm])
    prev = torch.cat([torch.zeros(1, dtype=torch.int32, device=wb.device), cov[:-1]])
    is_beg = (cov > 0) & (prev <= 0)
    is_end = (cov <= 0) & (prev > 0)

    def compact(mask):
        pos = torch.where(mask, _cumsum32(mask.to(torch.int32)) - 1, n)
        out = _set_rows(n, SENT_LANE, pos, srows)
        if n < run_cap:
            pad = torch.full((run_cap - n, W), SENT_LANE, dtype=torch.int32,
                             device=wb.device)
            out = torch.cat([out, pad], dim=0)
        return out[:run_cap]

    return compact(is_beg), compact(is_end)


def inc_append(runs_b, runs_e, runs_ver, slot: int, wb, we, w_ins,
               commit_off: int, *, run_cap: int):
    """Phase "merge": this batch's canonical committed union becomes run
    `slot`.  Returns new (runs_b, runs_e, runs_ver) and never writes its
    inputs: a pipelined window's recovery snapshot may hold them."""
    u_b, u_e = _union_intervals(wb, we, w_ins, run_cap=run_cap)
    new_b, new_e, new_ver = runs_b.clone(), runs_e.clone(), runs_ver.clone()
    new_b[slot] = u_b
    new_e[slot] = u_e
    new_ver[slot] = commit_off
    return new_b, new_e, new_ver


def resolve_core_inc(ks, hist_base, bidx, count: int, runs_b, runs_e,
                     runs_ver, slot: int, rb, re_, r_tx, wb, we, w_tx, snap,
                     active, commit_off: int, *, n_txn: int, run_cap: int,
                     search_iters: int = FAST_SEARCH_ITERS,
                     search_impl: str = "bucket", from_table: bool = False):
    """One incremental resolve: main is read-only (searched for history
    only), committed writes append as run `slot`.  `hist_base` is main's
    gap versions, or its cached sparse table when `from_table`.  Returns
    (verdict int32[B], runs_b', runs_e', runs_ver', converged, fixpoint
    iterations int32[1]); converged is a device bool (None for the sort
    search)."""
    with span("cs.search"):
        g_lo, g_hi, conv = inc_search(
            ks, bidx, count, rb, re_, r_tx,
            search_iters=search_iters, search_impl=search_impl,
        )
    with span("cs.check"):
        verdict, w_ins, n_iters = inc_check(
            hist_base, g_lo, g_hi, rb, re_, r_tx, wb, we, w_tx, snap, active,
            runs_b, runs_e, runs_ver, n_txn=n_txn, from_table=from_table,
        )
    with span("cs.append"):
        new_b, new_e, new_ver = inc_append(
            runs_b, runs_e, runs_ver, slot, wb, we, w_ins, commit_off,
            run_cap=run_cap,
        )
    return verdict, new_b, new_e, new_ver, conv, n_iters


# the LSM twin: main's history from the sparse table cached between
# compactions (the reference's resolve_core_inc_lsm)
resolve_core_inc_lsm = functools.partial(resolve_core_inc, from_table=True)


# ---------------------------------------------------------------------------
# the deferred compaction


def _ffill(defined: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Forward-fill vals where defined; positions before the first defined
    entry fill with 0 (the reference's associative scan, as a cummax of
    defined positions plus one gather)."""
    pos = torch.where(
        defined, torch.arange(defined.shape[0], device=defined.device), -1
    )
    last = torch.cummax(pos, 0).values
    return torch.where(last >= 0, vals[torch.clamp(last, min=0)], 0).to(vals.dtype)


def compact_fold(ks, vs, rec_ks, rec_vs, *, cap: int):
    """The scatter fold (reference `_compact_fold_scatter`): kernel K3
    ranks the step function (rec_ks, rec_vs) into main, merge-path
    positions come from an arange + cumsum, the merged domain is built by
    row scatters, values max-compose per-source forward fills, and
    equal-valued neighbours coalesce.  Returns (new_ks, new_vs,
    new_count); new_count > cap means rows were dropped and the caller
    must regrow main and fold again."""
    rec_cap, W = rec_ks.shape
    M = cap + rec_cap
    rec_live = ~_is_sentinel(rec_ks)
    ub = kernels.compact_ranks(ks, rec_ks)
    # rec row j lands between main rows ub[j]-1 and ub[j] (main first on
    # equal keys); #rec rows before main row i is a prefix count of ub
    cnt = torch.zeros(cap + 1, dtype=torch.int32, device=ks.device)
    cnt.index_add_(0, torch.where(rec_live, ub, cap).long(),
                   torch.ones_like(ub))
    pos_main = _arange(cap, ks) + _cumsum32(cnt[:cap])
    pos_rec = torch.where(rec_live, _arange(rec_cap, ks) + ub, M)
    merged = _spare(M, SENT_LANE, ks)
    _put(merged, pos_main, ks)
    merged = _put(merged, pos_rec, rec_ks)[:M]
    true_c = torch.ones(cap, dtype=torch.bool, device=ks.device)
    true_r = torch.ones(rec_cap, dtype=torch.bool, device=ks.device)
    main_def = _set_rows(M, False, pos_main, true_c)
    rec_def = _set_rows(M, False, pos_rec, true_r)
    mval = _set_rows(M, 0, pos_main, vs)
    rval = _set_rows(M, 0, pos_rec, rec_vs)
    val = torch.maximum(_ffill(main_def, mval), _ffill(rec_def, rval))

    keep = ~_is_sentinel(merged)
    keep[1:] &= val[1:] != val[:-1]
    keep_i = keep.to(torch.int32)
    new_count = keep_i.sum(dtype=torch.int32)
    pos = torch.where(keep, _cumsum32(keep_i) - 1, M)
    new_ks = _set_rows(cap, SENT_LANE, pos, merged)
    new_vs = _set_rows(cap, 0, pos, val)
    return new_ks, new_vs, new_count


def _compact_by_sort(keep, rows, val, cap: int):
    """The reference's stable 1-bit sort compaction: kept rows to the
    front in order, the rest masked to sentinels behind them, then the
    first `cap` rows.  Returns (new_ks, new_vs)."""
    rows = torch.where(keep[:, None], rows, SENT_LANE)
    val = torch.where(keep, val, 0)
    perm = lexsort([(~keep).to(torch.int32)])
    return rows[perm][:cap], val[perm][:cap]


def _coalesce(merged, val):
    """Rows to keep of a merged step function: live, and a value other
    than the previous row's.  Returns (keep, new_count int32 scalar)."""
    keep = ~_is_sentinel(merged)
    keep[1:] &= val[1:] != val[:-1]
    return keep, keep.sum(dtype=torch.int32)


def _compact_fold_sort(ks, vs, rec_ks, rec_vs, *, cap: int):
    """The sort fold (the referee): ONE multi-key sort of both levels
    (main first on equal keys), per-source forward fills to evaluate each
    step function on the merged domain, max-compose, coalesce, and compact
    with a stable 1-bit sort.  Returns (new_ks, new_vs, new_count)."""
    rec_cap, W = rec_ks.shape
    rows = torch.cat([ks, rec_ks], dim=0)
    src = torch.cat([torch.zeros(cap, dtype=torch.int32, device=ks.device),
                     torch.ones(rec_cap, dtype=torch.int32, device=ks.device)])
    perm = lexsort([rows[:, w] for w in range(W)] + [src])
    merged, s_src, s_val = rows[perm], src[perm], torch.cat([vs, rec_vs])[perm]
    val = torch.maximum(_ffill(s_src == 0, s_val), _ffill(s_src == 1, s_val))
    keep, new_count = _coalesce(merged, val)
    new_ks, new_vs = _compact_by_sort(keep, merged, val, cap)
    return new_ks, new_vs, new_count


def _compact_fold_gather(ks, vs, rec_ks, rec_vs, *, cap: int):
    """The gather fold: the cross ranks (kernel K3) imply every output
    position, so the merged domain is built by row gathers — recent
    positions are strictly increasing, one searchsorted recovers "#recent
    rows at merged positions <= p" — and compacted with the stable 1-bit
    sort and two cap-row gathers.  Returns (new_ks, new_vs, new_count)."""
    rec_cap = rec_ks.shape[0]
    M = cap + rec_cap
    rec_live = ~_is_sentinel(rec_ks)
    ub = kernels.compact_ranks(ks, rec_ks)
    ar = _arange(rec_cap, ks)
    # dead recent rows (a suffix) pad past M so the domain stays sorted
    pos_rec = torch.where(rec_live, ar + ub, M + ar)
    p = _arange(M, ks)
    nb = torch.searchsorted(pos_rec, p, right=True).to(torch.int32)
    is_rec = nb > torch.cat([nb.new_zeros(1), nb[:-1]])
    rec_i = torch.clamp(nb - 1, 0, rec_cap - 1).long()
    main_raw = p - nb
    main_i = torch.clamp(main_raw, 0, cap - 1).long()
    merged = torch.where(is_rec[:, None], rec_ks[rec_i], ks[main_i])
    sent = ~is_rec & ((main_raw >= cap) | (ks[main_i, -1] == SENT_LANE))
    val = torch.maximum(_ffill(~is_rec, vs[main_i]), _ffill(is_rec, rec_vs[rec_i]))
    keep = ~sent
    keep[1:] &= val[1:] != val[:-1]
    new_count = keep.sum(dtype=torch.int32)
    kperm = lexsort([(~keep).to(torch.int32)])[:cap]
    q_live = _arange(cap, ks) < new_count
    out = torch.where(is_rec[kperm][:, None], rec_ks[rec_i[kperm]],
                      ks[main_i[kperm]])
    new_ks = torch.where(q_live[:, None], out, SENT_LANE)
    new_vs = torch.where(q_live, val[kperm], 0)
    return new_ks, new_vs, new_count


_COMPACT_FOLDS = {
    "scatter": compact_fold,
    "sort": _compact_fold_sort,
    "gather": _compact_fold_gather,
}
MERGE_IMPLS = tuple(_COMPACT_FOLDS)


def compact_lsm(ks, vs, rec_ks, rec_vs, *, cap: int, merge_impl: str = "scatter"):
    """Fold the step function (rec_ks, rec_vs) into main: the deferred
    k-way merge's inner step and the LSM compaction.  `merge_impl` picks
    the fold (scatter is the default; sort and gather are its bit-identical
    referees); the scatter and gather folds count their cross ranks with
    kernel K3 (whose plain version is the reference's `_compact_ub`).
    Returns (new_ks, new_vs, new_count); new_count > cap means
    rows were dropped and the caller must regrow main and fold again.  The
    caller rebuilds bidx and tab once, after its last fold."""
    return _COMPACT_FOLDS[merge_impl](ks, vs, rec_ks, rec_vs, cap=cap)


# ---------------------------------------------------------------------------
# the legacy (non-incremental) layouts: every batch merges its committed
# writes into the state (flat: main; LSM: the recent level)


def phase_history(vs, g_lo, g_hi, snap, r_idx, r_ok, n_txn: int):
    """History conflicts: range-max of `vs` over each read's covered gaps
    from a table built here; a txn conflicts iff a read's max > its
    snapshot.  Returns bool[n_txn]."""
    tab = build_sparse_table(vs, torch.maximum, 0)
    return history_from_table(tab, g_lo, g_hi, snap, r_idx, r_ok, n_txn)


def history_from_table(tab, g_lo, g_hi, snap, r_idx, r_ok, n_txn: int):
    """phase_history from a PREBUILT sparse table (the LSM main level's)."""
    read_max = query_sparse_table(tab, g_lo, g_hi, torch.maximum, 0)
    r_hist = r_ok & (read_max > snap[r_idx])
    return torch.zeros(n_txn, dtype=torch.int32, device=tab.device).index_add_(
        0, r_idx, r_hist.to(torch.int32)) > 0


def _canonical_union(ks, vs, wb, we, wb_rank, we_rank, w_ins, *, cap: int):
    """The committed writes' union on the write-endpoint slot domain (slots
    = unique endpoint keys in key order): coverage deltas + cumsum give
    where canonical intervals open and close.  Returns (u_rows, u_rank,
    is_beg, is_end, news_mask, resume_val) — resume_val is the state's
    value AT a slot's key, which a canonical end resumes."""
    Wn = wb.shape[0]
    nslots = 2 * Wn
    wlr = _local_ranks(torch.cat([wb, we], dim=0))
    ins = w_ins.to(torch.int32)
    delta = torch.zeros(nslots, dtype=torch.int32, device=wb.device)
    delta.index_add_(0, wlr[:Wn].long(), ins).index_add_(0, wlr[Wn:].long(), -ins)
    cov = _cumsum32(delta) > 0
    prev_cov = torch.cat([cov.new_zeros(1), cov[:-1]])
    is_beg = cov & ~prev_cov
    is_end = ~cov & prev_cov
    # slot -> representative row and state rank (duplicates write equals)
    slot = torch.where(torch.cat([w_ins, w_ins]), wlr, nslots)
    u_rows = _set_rows(nslots, SENT_LANE, slot, torch.cat([wb, we], dim=0))
    u_rank = _set_rows(nslots, 0, slot, torch.cat([wb_rank, we_rank]))
    return (u_rows, u_rank, is_beg, is_end, is_beg | is_end,
            _resume_values(ks, vs, u_rows, u_rank, cap))


def _resume_values(ks, vs, u_rows, u_rank, cap: int):
    """vs[u_rank] where the row is a boundary of the state, else
    vs[u_rank - 1]: the state's value at each row's key."""
    ks_at = ks[torch.clamp(u_rank, 0, cap - 1).long()]
    key_exists = torch.all(ks_at == u_rows, dim=1)
    idx = torch.where(key_exists, u_rank, u_rank - 1)
    return vs[torch.clamp(idx, 0, cap - 1).long()]


def phase_merge(ks, vs, wb, we, wb_rank, we_rank, w_ins, commit_off, *, cap: int):
    """The scatter merge: the canonical union's boundaries merge into the
    state at merge-path positions from the search's ranks (news before
    equal olds), values come from a coverage cumsum on the merged domain,
    equal-valued neighbours coalesce.  Returns (new_ks, new_vs,
    new_count)."""
    Wn = wb.shape[0]
    u_rows, u_rank, is_beg, _is_end, news_mask, resume_val = _canonical_union(
        ks, vs, wb, we, wb_rank, we_rank, w_ins, cap=cap)
    M = cap + 2 * Wn
    j = _cumsum32(news_mask.to(torch.int32)) - 1
    pos_new = torch.where(news_mask, u_rank + j, M)
    # news past a full state (rank == cap) shift no old row: dropped from
    # the count, never clamped into it
    cnt = torch.zeros(cap + 1, dtype=torch.int32, device=ks.device)
    cnt.index_add_(0, torch.where(news_mask & (u_rank < cap), u_rank, cap).long(),
                   torch.ones_like(u_rank))
    pos_old = _arange(cap, ks) + _cumsum32(cnt[:cap])
    merged = _put(_put(_spare(M, SENT_LANE, ks), pos_old, ks), pos_new, u_rows)[:M]
    step = torch.where(is_beg, 1, -1).to(torch.int32)
    mdelta = torch.zeros(M + 1, dtype=torch.int32, device=ks.device)
    mcov = _cumsum32(mdelta.index_add_(0, pos_new.long(), step)[:M]) > 0
    is_old = _set_rows(M, False, pos_old, torch.ones(cap, dtype=torch.bool,
                                                     device=ks.device))
    new_val = torch.where(is_beg, commit_off, resume_val).to(torch.int32)
    val = _put(_put(_spare(M, 0, vs), pos_old, vs), pos_new, new_val)[:M]
    val = torch.where(is_old & mcov, commit_off, val).to(torch.int32)
    keep, new_count = _coalesce(merged, val)
    pos = torch.where(keep, _cumsum32(keep.to(torch.int32)) - 1, M)
    return _set_rows(cap, SENT_LANE, pos, merged), _set_rows(cap, 0, pos, val), new_count


def phase_merge_sort(ks, vs, wb, we, wb_rank, we_rank, w_ins, commit_off, *,
                     cap: int):
    """The sort merge (a referee): one multi-key sort orders the state rows
    and the canonical news (news first on equal keys), coverage deltas and
    values riding along; then the scatter merge's cumsum and coalesce, and
    a stable 1-bit sort compacts.  Returns (new_ks, new_vs, new_count)."""
    Wn, W = wb.shape
    nslots = 2 * Wn
    u_rows, _u_rank, is_beg, _is_end, news_mask, resume_val = _canonical_union(
        ks, vs, wb, we, wb_rank, we_rank, w_ins, cap=cap)
    rows = torch.cat([torch.where(news_mask[:, None], u_rows, SENT_LANE), ks])
    flag = torch.cat([torch.zeros(nslots, dtype=torch.int32, device=ks.device),
                      torch.ones(cap, dtype=torch.int32, device=ks.device)])
    mdelta = torch.cat([torch.where(news_mask, torch.where(is_beg, 1, -1), 0),
                        torch.zeros(cap, dtype=torch.int64, device=ks.device)])
    val_in = torch.cat([torch.where(is_beg, commit_off, resume_val).to(torch.int32),
                        vs])
    perm = lexsort([rows[:, w] for w in range(W)] + [flag])
    merged = rows[perm]
    mcov = _cumsum32(mdelta[perm].to(torch.int32)) > 0
    val = torch.where((flag[perm] == 1) & mcov, commit_off, val_in[perm])
    val = val.to(torch.int32)
    keep, new_count = _coalesce(merged, val)
    new_ks, new_vs = _compact_by_sort(keep, merged, val, cap)
    return new_ks, new_vs, new_count


def _union_sorted(ks, vs, wb, we, wb_rank, we_rank, w_ins, *, cap: int):
    """The union on the element domain, produced sorted by one 2Wn-row
    sort (begins before equal ends): the coverage transitions ARE the
    canonical boundaries.  Returns (u_rows, u_rank, is_beg, news_mask,
    resume_val), all in sorted order."""
    Wn, W = wb.shape
    live = torch.cat([w_ins, w_ins])
    rows = torch.where(live[:, None], torch.cat([wb, we], dim=0), SENT_LANE)
    tie = torch.cat([torch.zeros(Wn, dtype=torch.int32, device=wb.device),
                     torch.ones(Wn, dtype=torch.int32, device=wb.device)])
    delta = torch.where(live, 1 - 2 * tie, 0)
    perm = lexsort([rows[:, w] for w in range(W)] + [tie])
    u_rows, u_rank = rows[perm], torch.cat([wb_rank, we_rank])[perm]
    cov = _cumsum32(delta[perm])
    prev = torch.cat([cov.new_zeros(1), cov[:-1]])
    is_beg = (cov > 0) & (prev <= 0)
    news_mask = is_beg | ((cov <= 0) & (prev > 0))
    return (u_rows, u_rank, is_beg, news_mask,
            _resume_values(ks, vs, u_rows, u_rank, cap))


def phase_merge_gather(ks, vs, wb, we, wb_rank, we_rank, w_ins, commit_off, *,
                       cap: int):
    """The gather merge (a referee): the news' positions follow from the
    search's ranks (rank + index among news), one searchsorted gives "#news
    at positions <= p", and the merged domain is built by gathers; a
    stable 1-bit sort and two cap-row gathers compact it.  Returns
    (new_ks, new_vs, new_count)."""
    n = 2 * wb.shape[0]
    u_rows, u_rank, is_beg, news_mask, resume_val = _union_sorted(
        ks, vs, wb, we, wb_rank, we_rank, w_ins, cap=cap)
    M = cap + n
    j = _cumsum32(news_mask.to(torch.int32)) - 1
    # news past a full state are dropped, not clamped (as phase_merge)
    pos_new = torch.where(news_mask & (u_rank < cap), u_rank + j, M).to(torch.int32)
    val_new = torch.where(is_beg, commit_off, resume_val).to(torch.int32)
    order = lexsort([pos_new])
    p = _arange(M, ks)
    nb = torch.searchsorted(pos_new[order], p, right=True).to(torch.int32)
    is_new = nb > torch.cat([nb.new_zeros(1), nb[:-1]])
    src = order[torch.clamp(nb - 1, 0, n - 1).long()]
    old_idx = torch.clamp(p - nb, 0, cap - 1).long()
    mcov = _cumsum32(torch.where(is_new, torch.where(is_beg[src], 1, -1), 0)
                     .to(torch.int32)) > 0
    sent = ~is_new & (ks[old_idx, -1] == SENT_LANE)
    val = torch.where(is_new, val_new[src],
                      torch.where(mcov, commit_off, vs[old_idx])).to(torch.int32)
    keep = ~sent
    keep[1:] &= val[1:] != val[:-1]
    new_count = keep.sum(dtype=torch.int32)
    kperm = lexsort([(~keep).to(torch.int32)])[:cap]
    q_live = _arange(cap, ks) < new_count
    out = torch.where(is_new[kperm][:, None], u_rows[src[kperm]],
                      ks[old_idx[kperm]])
    new_ks = torch.where(q_live[:, None], out, SENT_LANE)
    new_vs = torch.where(q_live, val[kperm], 0)
    return new_ks, new_vs, new_count


_MERGE_IMPLS = {
    "scatter": phase_merge,
    "sort": phase_merge_sort,
    "gather": phase_merge_gather,
}


def resolve_core(ks, vs, bidx, count, rb, re_, r_tx, wb, we, w_tx, snap,
                 active, commit_off, *, cap: int, n_txn: int,
                 search_iters: int = FAST_SEARCH_ITERS,
                 merge_impl: str = "scatter", search_impl: str = "bucket"):
    """One legacy resolve of the flat layout: ONE state search of every
    query class (bucketed, or the sort), history by range-max of vs, the
    intra-batch fixpoint (kernel K2), and the committed writes merged into
    the state.  `count` is an int or a device scalar.  Returns (verdict,
    new_ks, new_vs, new_count, new_bidx, converged, fixpoint iterations
    int32[1]); converged is a device bool (None for the sort search), and
    new_count > cap means the merge dropped rows."""
    B = n_txn
    r_ok, r_idx, w_ok, w_idx = _batch_masks(r_tx, wb, w_tx, B)
    if search_impl == "sort":
        g_lo, g_hi, wb_rank, we_rank = phase_search_sort(ks, count, rb, re_, wb, we)
        conv = None
    else:
        g_lo, g_hi, wb_rank, we_rank, conv = phase_search(
            ks, bidx, count, rb, re_, wb, we, r_ok, w_ok, search_iters)
    hist = phase_history(vs, g_lo, g_hi, snap, r_idx, r_ok, B)
    intra, n_iters = phase_intra(rb, re_, wb, we, r_ok, w_ok, r_idx, w_idx, w_tx,
                                 active, hist, B)
    committed = active & ~hist & ~intra
    new_ks, new_vs, new_count = _MERGE_IMPLS[merge_impl](
        ks, vs, wb, we, wb_rank, we_rank, w_ok & committed[w_idx], commit_off,
        cap=cap)
    # the bucket index feeds only the bucketed search
    new_bidx = bidx if search_impl == "sort" else _rebuild_buckets(new_ks)
    return (_verdicts(active, committed), new_ks, new_vs, new_count, new_bidx,
            conv, n_iters)


def resolve_core_lsm(ks, hist_tab, bidx, count, rec_ks, rec_vs, rec_bidx,
                     rec_count, rb, re_, r_tx, wb, we, w_tx, snap, active,
                     commit_off, *, rec_cap: int, n_txn: int,
                     search_iters: int = FAST_SEARCH_ITERS,
                     rec_iters: int = FAST_SEARCH_ITERS,
                     search_impl: str = "bucket", merge_impl: str = "scatter"):
    """One legacy resolve of the LSM layout: main is read-only (reads
    searched, history from its cached table), the recent level is searched
    for every query class, history is main's ORed with the recent level's,
    and the committed writes merge into the recent level only.  Returns
    (verdict, rec_ks', rec_vs', rec_bidx', rec_count', converged, fixpoint
    iterations int32[1])."""
    B = n_txn
    r_ok, r_idx, w_ok, w_idx = _batch_masks(r_tx, wb, w_tx, B)
    g_lo_m, g_hi_m, conv = inc_search(ks, bidx, count, rb, re_, r_tx,
                                      search_iters=search_iters,
                                      search_impl=search_impl)
    if search_impl == "sort":
        g_lo_r, g_hi_r, wb_rank, we_rank = phase_search_sort(
            rec_ks, rec_count, rb, re_, wb, we)
    else:
        g_lo_r, g_hi_r, wb_rank, we_rank, conv_r = phase_search(
            rec_ks, rec_bidx, rec_count, rb, re_, wb, we, r_ok, w_ok, rec_iters)
        conv = conv & conv_r
    hist = (history_from_table(hist_tab, g_lo_m, g_hi_m, snap, r_idx, r_ok, B)
            | phase_history(rec_vs, g_lo_r, g_hi_r, snap, r_idx, r_ok, B))
    intra, n_iters = phase_intra(rb, re_, wb, we, r_ok, w_ok, r_idx, w_idx, w_tx,
                                 active, hist, B)
    committed = active & ~hist & ~intra
    nrk, nrv, nrc = _MERGE_IMPLS[merge_impl](
        rec_ks, rec_vs, wb, we, wb_rank, we_rank, w_ok & committed[w_idx],
        commit_off, cap=rec_cap)
    nrb = rec_bidx if search_impl == "sort" else _rebuild_buckets(nrk)
    return _verdicts(active, committed), nrk, nrv, nrb, nrc, conv, n_iters


# ---------------------------------------------------------------------------
# host packing (numpy, byte-identical to the reference's packers)


def _bucket(n: int, lo: int = 16) -> int:
    """Round up to a power of two (the reference's jit-shape buckets; kept
    so packed shapes, and so verdict arrays, match it exactly)."""
    b = lo
    while b < n:
        b *= 2
    return b


def pack_batch_loop(txns, oldest: int, offset, max_key_bytes: int,
                    stats=None):
    """Reference (per-transaction, per-range loop) TxInfo marshaller: the
    parity referee of pack_batch, and its path for batches with
    over-length keys.  Returns (rbv, rev, rtv, wbv, wev, wtv, snap, active,
    bucketed_B) in the uint32 lane layout."""
    t_start = time.perf_counter()
    enc_spent = [0.0]
    B = len(txns)
    W = keymod.num_words(max_key_bytes)

    def enc(keys):
        t0 = time.perf_counter()
        out = keymod.encode_keys(keys, max_key_bytes=max_key_bytes)
        enc_spent[0] += time.perf_counter() - t0
        return out
    active = np.zeros(B, dtype=bool)
    snap = np.zeros(B, dtype=np.int32)
    rb_k: list[bytes] = []
    re_k: list[bytes] = []
    r_tx: list[int] = []
    wb_k: list[bytes] = []
    we_k: list[bytes] = []
    w_tx: list[int] = []
    for t, tx in enumerate(txns):
        if tx.read_snapshot < oldest:
            continue  # TOO_OLD, decided at add time (SkipList.cpp:985)
        active[t] = True
        snap[t] = offset(tx.read_snapshot)
        for b, e in tx.read_ranges:
            if b < e:
                rb_k.append(b)
                re_k.append(e)
                r_tx.append(t)
        for b, e in tx.write_ranges:
            if b < e:
                wb_k.append(b)
                we_k.append(e)
                w_tx.append(t)

    Bp, R, Wn = _bucket(B), _bucket(len(r_tx)), _bucket(len(w_tx))

    def pad(bk, ek, tx, n):
        out_b = np.full((n, W), _SENT_WORD, dtype=np.uint32)
        out_e = np.full((n, W), _SENT_WORD, dtype=np.uint32)
        out_t = np.full(n, -1, dtype=np.int32)
        if bk:
            out_b[: len(bk)] = enc(bk)
            out_e[: len(ek)] = enc(ek)
            out_t[: len(tx)] = tx
        return out_b, out_e, out_t

    rbv, rev, rtv = pad(rb_k, re_k, r_tx, R)
    wbv, wev, wtv = pad(wb_k, we_k, w_tx, Wn)
    snap_p = np.zeros(Bp, dtype=np.int32)
    snap_p[:B] = snap
    active_p = np.zeros(Bp, dtype=bool)
    active_p[:B] = active
    if stats is not None:
        stats.encode_s += enc_spent[0]
        stats.pad_s += time.perf_counter() - t_start - enc_spent[0]
    return rbv, rev, rtv, wbv, wev, wtv, snap_p, active_p, Bp


def _np_rows_less(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rowwise lexicographic a < b over uint32[N, W] lane rows, host-side."""
    neq = a != b
    any_neq = neq.any(axis=1)
    first = neq.argmax(axis=1)
    rows = np.arange(a.shape[0])
    return any_neq & (a[rows, first] < b[rows, first])


def _live_key_bytes(txns, oldest: int) -> int:
    """The longest endpoint of a live range (b < e) of a transaction that
    is not TOO_OLD: what a packing of `txns` must encode."""
    need = 0
    for tx in txns:
        if tx.read_snapshot < oldest:
            continue
        for b, e in chain(tx.read_ranges, tx.write_ranges):
            if b < e:
                need = max(need, len(b), len(e))
    return need


def pack_batch(txns, oldest: int, offset, max_key_bytes: int, *,
               arena=None, stats=None, offset_array=None, grow=False):
    """Marshal a TxInfo batch into padded lane arrays — the BULK path, the
    same arrays as pack_batch_loop without per-range Python loops: ONE
    flatten of every conflict-range endpoint, ONE keys.encode_concat, and
    the b < e liveness filter as a vectorized lane compare.  `offset_array`
    is the vectorized twin of `offset`.  With `arena` (pipeline.PackArena)
    the padded outputs fill its rotating staging slots, read and write rows
    from separate pools, instead of fresh arrays; only the previously-live
    pad region of a reused slot is re-sentinelled.  Batches with a key
    longer than max_key_bytes go to pack_batch_loop (its raise-vs-drop
    semantics need byte compares).  With `grow`, a batch whose live ranges
    need a wider encoding packs at `keys.grown_key_bytes` of its longest
    live endpoint instead of raising: the arrays carry their width, and
    the set widens to it.
    Returns (rbv, rev, rtv, wbv, wev, wtv, snap, active, bucketed_B)."""
    B = len(txns)
    if B == 0:
        return pack_batch_loop(txns, oldest, offset, max_key_bytes, stats=stats)
    t0 = time.perf_counter()
    W = keymod.num_words(max_key_bytes)
    snaps_raw = np.fromiter(
        (t.read_snapshot for t in txns), dtype=np.int64, count=B
    )
    active = snaps_raw >= oldest
    if active.all():
        act_txns = txns if isinstance(txns, list) else list(txns)
        act_ids = np.arange(B, dtype=np.int32)
    else:  # TOO_OLD txns contribute no ranges (SkipList.cpp:985)
        alist = active.tolist()
        act_txns = [t for t, a in zip(txns, alist) if a]
        act_ids = np.flatnonzero(active).astype(np.int32)
    nA = len(act_txns)
    r_counts = np.fromiter(
        map(len, map(attrgetter("read_ranges"), act_txns)),
        dtype=np.int64, count=nA,
    )
    w_counts = np.fromiter(
        map(len, map(attrgetter("write_ranges"), act_txns)),
        dtype=np.int64, count=nA,
    )
    r_keys = list(
        chain.from_iterable(chain.from_iterable(t.read_ranges for t in act_txns))
    )
    w_keys = list(
        chain.from_iterable(chain.from_iterable(t.write_ranges for t in act_txns))
    )
    all_keys = r_keys + w_keys
    n_all = len(all_keys)
    lens = np.fromiter(map(len, all_keys), dtype=np.int64, count=n_all)
    if n_all and int(lens.max()) > max_key_bytes:
        if grow:
            need = _live_key_bytes(act_txns, oldest)
            if need > max_key_bytes:
                max_key_bytes = keymod.grown_key_bytes(need)
                W = keymod.num_words(max_key_bytes)
        if int(lens.max()) > max_key_bytes:
            return pack_batch_loop(txns, oldest, offset, max_key_bytes,
                                   stats=stats)
    enc = keymod.encode_concat(b"".join(all_keys), lens, max_key_bytes)
    t1 = time.perf_counter()

    nR, nW = len(r_keys) // 2, len(w_keys) // 2
    pairs = enc.reshape(nR + nW, 2, W)
    renc, wenc = pairs[:nR], pairs[nR:]
    r_tx_all = np.repeat(act_ids, r_counts)
    w_tx_all = np.repeat(act_ids, w_counts)
    live = _np_rows_less(pairs[:, 0], pairs[:, 1]) if (nR + nW) else (
        np.zeros(0, dtype=bool)
    )
    all_live = bool(live.all())
    if all_live:
        r_idx = w_idx = None
        n_r, n_w = nR, nW
    else:
        r_idx = np.flatnonzero(live[:nR])
        w_idx = np.flatnonzero(live[nR:])
        n_r, n_w = len(r_idx), len(w_idx)
    Bp, R, Wn = _bucket(B), _bucket(n_r), _bucket(n_w)

    if offset_array is not None:
        snap_vals = offset_array(snaps_raw[active])
    else:
        snap_vals = np.fromiter(
            (offset(int(s)) for s in snaps_raw[active]), dtype=np.int64,
            count=nA,
        )

    def fill_rows(kind: str, n_rows: int, enc3, idx, tx_all):
        n = enc3.shape[0] if all_live else len(idx)
        if arena is not None:
            slot = arena.rows(kind, n_rows, W, _SENT_WORD)
            hi = slot.live
            if hi > n:  # re-sentinel only the previously-live pad region
                slot.b[n:hi] = _SENT_WORD
                slot.e[n:hi] = _SENT_WORD
                slot.t[n:hi] = -1
            slot.live = n
            out_b, out_e, out_t = slot.b, slot.e, slot.t
        else:
            out_b = np.full((n_rows, W), _SENT_WORD, dtype=np.uint32)
            out_e = np.full((n_rows, W), _SENT_WORD, dtype=np.uint32)
            out_t = np.full(n_rows, -1, dtype=np.int32)
        if n:
            if all_live:
                out_b[:n] = enc3[:, 0]
                out_e[:n] = enc3[:, 1]
                out_t[:n] = tx_all
            else:
                out_b[:n] = enc3[idx, 0]
                out_e[:n] = enc3[idx, 1]
                out_t[:n] = tx_all[idx]
        return out_b, out_e, out_t

    rbv, rev, rtv = fill_rows("r", R, renc, r_idx, r_tx_all)
    wbv, wev, wtv = fill_rows("w", Wn, wenc, w_idx, w_tx_all)
    if arena is not None:
        ts = arena.txns(Bp)
        hi = ts.live
        if hi > B:
            ts.snap[B:hi] = 0
            ts.active[B:hi] = False
        ts.live = B
        snap_p, active_p = ts.snap, ts.active
    else:
        snap_p = np.zeros(Bp, dtype=np.int32)
        active_p = np.zeros(Bp, dtype=bool)
    if nA == B:
        snap_p[:B] = snap_vals
    else:
        snap_p[:B] = 0
        snap_p[act_ids] = snap_vals
    active_p[:B] = active
    if stats is not None:
        stats.encode_s += t1 - t0
        stats.pad_s += time.perf_counter() - t1
    return rbv, rev, rtv, wbv, wev, wtv, snap_p, active_p, Bp


def _flatten_batch(rbv, rev, rtv, wbv, wev, wtv, snap_p, active_p):
    """A packed numpy batch as the parts of ONE int32 buffer (keys flipped
    to lanes) and how to split it again: (parts, n_elems, (R, W, Wn, Bp))."""
    R, W = rbv.shape
    Wn, Bp = wbv.shape[0], snap_p.shape[0]
    parts = [
        (np.asarray(rbv, np.uint32) ^ keymod.SIGN_FLIP).view(np.int32).ravel(),
        (np.asarray(rev, np.uint32) ^ keymod.SIGN_FLIP).view(np.int32).ravel(),
        np.asarray(rtv, np.int32),
        (np.asarray(wbv, np.uint32) ^ keymod.SIGN_FLIP).view(np.int32).ravel(),
        (np.asarray(wev, np.uint32) ^ keymod.SIGN_FLIP).view(np.int32).ravel(),
        np.asarray(wtv, np.int32),
        np.asarray(snap_p, np.int32),
        np.asarray(active_p).astype(np.int32),
    ]
    return parts, 2 * R * W + R + 2 * Wn * W + Wn + 2 * Bp, (R, W, Wn, Bp)


def _split_batch(buf: torch.Tensor, R: int, W: int, Wn: int, Bp: int):
    """The staged buffer as (rb, re_, r_tx, wb, we, w_tx, snap, active)."""
    sizes = [R * W, R * W, R, Wn * W, Wn * W, Wn, Bp, Bp]
    rb, re_, r_tx, wb, we, w_tx, snap, active = torch.split(buf, sizes)
    return (rb.view(R, W), re_.view(R, W), r_tx, wb.view(Wn, W),
            we.view(Wn, W), w_tx, snap, active.bool())


def stage_batch(device, rbv, rev, rtv, wbv, wev, wtv, snap_p, active_p):
    """Packed numpy batch -> device tensors with ONE conversion to lanes
    and ONE host-to-device copy: everything goes into one int32 host
    buffer, crosses once, and is split into views on the device.  For a
    CUDA device the buffer is pinned and the copy non_blocking, so staging
    never waits on the stream (torch's pinned-memory cache holds the
    buffer until the copy is done).  Returns (rb, re_, r_tx, wb, we, w_tx,
    snap, active)."""
    parts, n, shape = _flatten_batch(rbv, rev, rtv, wbv, wev, wtv, snap_p,
                                     active_p)
    if device.type == "cuda":
        host = torch.empty(n, dtype=torch.int32, pin_memory=True)
        np.concatenate(parts, out=host.numpy())
        buf = host.to(device, non_blocking=True)
    else:
        buf = torch.from_numpy(np.concatenate(parts)).to(device)
    return _split_batch(buf, *shape)


class StagedBatch:
    """A batch that BatchStager put on the device: its staging may still be
    in flight on the stager's stream.  `take()` hands out its tensors."""

    __slots__ = ("_tensors", "_ready")

    def __init__(self, tensors: tuple, ready) -> None:
        self._tensors = tensors
        self._ready = ready

    def take(self) -> tuple:
        """Make the caller's current stream wait for the staging, mark its
        memory as used on that stream (so the allocator does not hand it to
        the stager's stream while the caller still reads it), and return
        (rb, re_, r_tx, wb, we, w_tx, snap, active)."""
        if self._ready is not None:
            stream = torch.cuda.current_stream(self._tensors[0].device)
            stream.wait_event(self._ready)
            # rb views the one copied buffer; active is the cast's own block
            for t in (self._tensors[0], self._tensors[-1]):
                t.record_stream(stream)
        return self._tensors


class BatchStager:
    """`stage` for PipelinedPacker: runs on its worker thread and puts each
    packed numpy batch on the device ahead of the consumer.  It runs
    `stage_batch` (pinned buffer, one non_blocking copy, the cast of
    `active`) on a side stream and records an event after all of it; the
    consumer waits on that event through `StagedBatch.take()`.  torch's
    pinned-memory cache reuses a pinned buffer only after its copy is done.
    The device is CUDA unless the caller asks for the CPU, where a batch is
    ready at once."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def __call__(self, packed) -> StagedBatch:
        if self._stream is None:
            return StagedBatch(stage_batch(self.device, *packed[:8]), None)
        with torch.cuda.stream(self._stream):
            tensors = stage_batch(self.device, *packed[:8])
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return StagedBatch(tensors, ready)


# ---------------------------------------------------------------------------
# the conflict set


def _check_choice(kind: str, value, choices) -> None:
    if value not in choices:
        raise ValueError(f"unknown {kind} {value!r}; choose one of {choices}")


def _check_flag(name: str, value) -> None:
    if value not in (True, False):
        raise ValueError(f"{name} must be True or False, got {value!r}")


class DeviceConflictSet(PipelinedConflictMixin, ConflictSet):
    """ConflictSet backed by the torch/CUDA check above — the reference's
    DeviceConflictSet, with the same duck-typed surface the resolver role
    calls (resolve_batch, resolve_deferred, remove_before, oldest_version,
    kernel_stats, ...).  `device=None` means CUDA and raises without one;
    the CPU tests pass `device="cpu"`.

    The keywords are the reference constructor's, with its defaults and no
    environment read: `incremental=True` appends each batch as a run (the
    default), `incremental=False` merges it into the state every batch
    (the legacy layouts); `lsm=True` caches main's history table and, on
    the legacy path, merges into a recent level of `recent_capacity` rows
    that compacts into main when full; `search_impl` picks the state
    search, `merge_impl` the merge and fold ("scatter", or its referees
    "sort" and "gather"); `rec_search_iters` is the recent level's
    bucketed-search depth.  `lsm=True, search_impl="bucket"` is bench.py's
    best-known layout.  `phase_timing=True` runs each synchronous
    incremental resolve as three dispatches, search, check and append,
    each waited out, and adds their wall times to `stats.sort_s`,
    `scan_s` and `append_s` (profiling only: same verdicts and state).
    The split-phase resolve (`resolve_deferred`, conflict/pipeline.py)
    dispatches batch N+1 before batch N's verdicts are read, with
    snapshot/replay recovery when a deferred check fails.

    `max_key_bytes` is the key width the set starts at.  A batch with a
    longer live endpoint widens the set in place (`_widen`), to the least
    power of two of bytes that holds it, with the verdicts and state of a
    set built that wide.  The card's memory is the only limit: where the
    widened buffers do not fit, the batch raises KeyTooLongError and
    nothing changes.  (The reference's set raises at its width.)"""

    # everything a dispatch, GC, regrow or compaction can move: the
    # recovery snapshot of a pipelined window.  Safe as references because
    # every update rebinds these attributes and never writes a tensor in
    # place (conflict/pipeline.py says why).
    _PIPELINE_SNAPSHOT_ATTRS = (
        "_ks", "_vs", "_bidx", "_tab", "_count", "_count_ub", "_dev_count",
        "_cap", "_dev_ok", "_pipelined_since_check", "_last_commit", "_base",
        "_oldest", "_rec_ks", "_rec_vs", "_rec_bidx", "_rec_count",
        "_rec_count_ub", "_rec_dev_count", "_rec_cap",
        "_runs_b", "_runs_e", "_runs_ver", "_n_runs", "_run_rows_ub",
        "_run_cap", "_W", "_max_key_bytes",
    )

    def __init__(
        self,
        oldest_version: int = 0,
        *,
        max_key_bytes: int = keymod.DEFAULT_MAX_KEY_BYTES,
        capacity: int = 1 << 16,
        merge_impl: str = "scatter",     # "scatter" | "sort" | "gather"
        search_impl: str = "sort",       # "sort" | "bucket"
        lsm: bool = False,               # cache main's history table
        recent_capacity: int = 1 << 13,  # LSM recent-level capacity
        incremental: bool = True,        # run append + deferred merge
        run_slots: int = 8,              # K: deferred-merge compaction threshold
        run_capacity: int = 1 << 12,     # per-run interval capacity (auto-grows)
        rec_search_iters: int = FAST_SEARCH_ITERS,  # recent-level search depth
        phase_timing: bool = False,      # per-phase barriers and wall times
        device=None,
    ) -> None:
        _check_choice("search_impl", search_impl, SEARCH_IMPLS)
        _check_choice("merge_impl", merge_impl, MERGE_IMPLS)
        for name, flag in (("lsm", lsm), ("incremental", incremental),
                           ("phase_timing", phase_timing)):
            _check_flag(name, flag)
        self.device = resolve_device(device)
        self._search_impl = search_impl
        self._merge_impl = merge_impl
        self._lsm = bool(lsm)
        self._incremental = bool(incremental)
        self._phase_timing = bool(phase_timing)
        # a too-shallow depth costs a full-depth replay, never correctness
        self._rec_iters = max(1, min(int(rec_search_iters), 32))
        self._K = run_slots
        self._max_key_bytes = max_key_bytes
        self._W = keymod.num_words(max_key_bytes)
        self._base = oldest_version
        self._oldest = oldest_version
        self._last_commit = oldest_version
        self.stats = KernelStats(backend=self.device.type,
                                 key_bytes=max_key_bytes,
                                 launches=dict.fromkeys(kernels.launches, 0),
                                 host_reads=dict.fromkeys(READ_SITES, 0))
        self.stats.merge_impl = merge_impl
        self.search_fallbacks = 0  # bucketed searches replayed at full depth
        self.host_syncs = 0        # reads of a device value on the host
        # the fixpoint iterations of every resolve, summed on the device
        # (rebound, never updated in place)
        self._intra_iters = torch.zeros(1, dtype=torch.int64, device=self.device)
        # the pipelined stream's validity: the AND of every sync=False
        # dispatch's search convergence (and, legacy, capacity) since the
        # last check
        self._dev_ok = torch.ones((), dtype=torch.bool, device=self.device)
        self._pipelined_since_check = 0
        self._pipeline_init()
        self._init_state(capacity)
        self._rec_cap = recent_capacity
        self._rec_ks = self._rec_vs = self._rec_bidx = self._rec_dev_count = None
        self._rec_count = self._rec_count_ub = 0
        if self._lsm:
            self._init_recent(recent_capacity)
        self._runs_b = self._runs_e = self._runs_ver = None
        self._n_runs = self._run_rows_ub = 0
        self._run_cap = run_capacity
        if self._incremental:
            self._init_runs(run_capacity)

    # -- state ---------------------------------------------------------------
    def _floor_rows(self, n: int) -> np.ndarray:
        """n sentinel rows (uint32 layout) but the first, the empty key."""
        rows = np.full((n, self._W), _SENT_WORD, dtype=np.uint32)
        rows[0] = keymod.encode_keys([b""], self._max_key_bytes)[0]
        return rows

    def _init_state(self, capacity: int) -> None:
        nks = self._floor_rows(capacity)
        self._cap = capacity
        self._ks = to_lanes(nks, self.device)
        self._vs = torch.zeros(capacity, dtype=torch.int32, device=self.device)
        # the live count: `_count` on the host, or, while a legacy pipelined
        # stream is undrained, None and `_dev_count` on the device
        self._count = self._count_ub = 1
        self._dev_count = None
        self._bidx = torch.from_numpy(host_bucket_index(nks)).to(self.device)
        self._tab = self._history_table()

    def _main_count(self):
        return self._dev_count if self._count is None else self._count

    def _history_table(self):
        """The LSM layout's cached range-max table of main (None when flat:
        the check then builds it from vs every batch)."""
        return build_sparse_table(self._vs, torch.maximum, 0) if self._lsm else None

    def _init_recent(self, rec_cap: int) -> None:
        """A fresh recent level: the empty key at version 0.  Idle on the
        incremental path, where the runs play its part."""
        rk = self._floor_rows(rec_cap)
        self._rec_cap = rec_cap
        self._rec_ks = to_lanes(rk, self.device)
        self._rec_vs = torch.zeros(rec_cap, dtype=torch.int32, device=self.device)
        self._rec_bidx = torch.from_numpy(host_bucket_index(rk)).to(self.device)
        self._rec_count = self._rec_count_ub = 1
        self._rec_dev_count = None

    def _rec_count_now(self):
        return self._rec_dev_count if self._rec_count is None else self._rec_count

    def _grow_recent(self, new_rec_cap: int) -> None:
        """Sentinel-pad the recent level to new_rec_cap (no fold)."""
        rk = torch.full((new_rec_cap, self._W), SENT_LANE, dtype=torch.int32,
                        device=self.device)
        rk[: self._rec_cap] = self._rec_ks
        rv = torch.zeros(new_rec_cap, dtype=torch.int32, device=self.device)
        rv[: self._rec_cap] = self._rec_vs
        self._rec_cap, self._rec_ks, self._rec_vs = new_rec_cap, rk, rv
        self._rec_bidx = _rebuild_buckets(rk)

    def _init_runs(self, run_cap: int) -> None:
        run_cap = _bucket(run_cap)  # the reference's stride math wants 2**k
        self._run_cap = run_cap
        shape = (self._K, run_cap, self._W)
        self._runs_b = torch.full(shape, SENT_LANE, dtype=torch.int32,
                                  device=self.device)
        self._runs_e = torch.full(shape, SENT_LANE, dtype=torch.int32,
                                  device=self.device)
        self._runs_ver = torch.zeros(self._K, dtype=torch.int32,
                                     device=self.device)
        self._n_runs = 0
        self._run_rows_ub = 0   # upper bound on live run rows (node_count)

    def _grow_runs(self, new_cap: int) -> None:
        """Sentinel-pad every run slot to new_cap."""
        old = self._run_cap
        for name in ("_runs_b", "_runs_e"):
            grown = torch.full((self._K, new_cap, self._W), SENT_LANE,
                               dtype=torch.int32, device=self.device)
            grown[:, :old] = getattr(self, name)
            setattr(self, name, grown)
        self._run_cap = new_cap

    def _grow_main(self, new_cap: int) -> None:
        ks = torch.full((new_cap, self._W), SENT_LANE, dtype=torch.int32,
                        device=self.device)
        ks[: self._cap] = self._ks
        vs = torch.zeros(new_cap, dtype=torch.int32, device=self.device)
        vs[: self._cap] = self._vs
        self._cap, self._ks, self._vs = new_cap, ks, vs
        self._bidx = _rebuild_buckets(ks)
        self._tab = self._history_table()

    def export_state(self) -> dict:
        """The whole state as numpy, keys in the reference's uint32 layout
        (what the reference set holds as _ks/_vs/_bidx/_tab/_rec_*/_runs_*
        ...): the runs only on the incremental path, `tab` and the recent
        level only for the LSM layout.  Fresh arrays: nothing aliases the
        live tensors."""
        out = {
            "ks": from_lanes(self._ks),
            "vs": self._vs.cpu().numpy().copy(),
            "bidx": self._bidx.cpu().numpy().copy(),
            "count": self._host_count(),
            "cap": self._cap,
            "base": self._base,
            "oldest": self._oldest,
            "last_commit": self._last_commit,
            "merge_impl": self._merge_impl,
        }
        if self._incremental:
            out.update(
                runs_b=from_lanes(self._runs_b), runs_e=from_lanes(self._runs_e),
                runs_ver=self._runs_ver.cpu().numpy().copy(),
                n_runs=self._n_runs, run_cap=self._run_cap, K=self._K,
                run_rows_ub=self._run_rows_ub,
            )
        if self._lsm:
            out.update(
                tab=self._tab.cpu().numpy().copy(),
                rec_ks=from_lanes(self._rec_ks),
                rec_vs=self._rec_vs.cpu().numpy().copy(),
                rec_bidx=self._rec_bidx.cpu().numpy().copy(),
                rec_count=self._host_rec_count(), rec_cap=self._rec_cap,
            )
        return out

    def load_state(self, d: dict) -> None:
        """Adopt a state exported by `export_state` — or built from the
        reference set's attributes — and continue from it.  tab is a
        function of vs and is rebuilt; bidx (and rec_bidx) are adopted when
        given, since the sort search leaves them as they were, and rebuilt
        from ks when not."""
        self._drain_all()
        ks = np.asarray(d["ks"], dtype=np.uint32)
        W = ks.shape[1]
        if W != self._W or ks.shape != (int(d["cap"]), W):
            raise ValueError(
                f"state of key width {W} / shape {ks.shape} does not fit "
                f"this set (W={self._W})"
            )
        if self._incremental:
            runs_b = np.asarray(d["runs_b"], dtype=np.uint32)
            if runs_b.shape != (int(d["K"]), int(d["run_cap"]), W):
                raise ValueError("runs shape disagrees with K / run_cap")
        merge_impl = d.get("merge_impl", self._merge_impl)
        _check_choice("merge_impl", merge_impl, MERGE_IMPLS)
        self._merge_impl = self.stats.merge_impl = str(merge_impl)
        self._cap = int(d["cap"])
        self._ks = to_lanes(ks, self.device)
        self._vs = self._i32(d["vs"])
        self._bidx = (self._i32(d["bidx"]) if "bidx" in d
                      else _rebuild_buckets(self._ks))
        self._tab = self._history_table()
        self._count = self._count_ub = int(d["count"])
        self._dev_count = None
        for key in ("base", "oldest", "last_commit"):
            setattr(self, "_" + key, int(d[key]))
        if self._incremental:
            self._K, self._run_cap = int(d["K"]), int(d["run_cap"])
            self._runs_b = to_lanes(runs_b, self.device)
            self._runs_e = to_lanes(d["runs_e"], self.device)
            self._runs_ver = self._i32(d["runs_ver"])
            self._n_runs = int(d["n_runs"])
            self._run_rows_ub = int(d["run_rows_ub"])
        if self._lsm:
            self._rec_cap = int(d["rec_cap"])
            self._rec_ks = to_lanes(d["rec_ks"], self.device)
            self._rec_vs = self._i32(d["rec_vs"])
            self._rec_bidx = (self._i32(d["rec_bidx"]) if "rec_bidx" in d
                              else _rebuild_buckets(self._rec_ks))
            self._rec_count = self._rec_count_ub = int(d["rec_count"])
            self._rec_dev_count = None

    def _i32(self, a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(self.device)

    # -- properties ----------------------------------------------------------
    @property
    def oldest_version(self) -> int:
        return self._oldest

    @property
    def capacity(self) -> int:
        return self._cap

    def _host_count(self) -> int:
        if self._count is None:
            self._count = self._host_int(self._dev_count, "count")
        return self._count

    def _host_rec_count(self) -> int:
        if self._rec_count is None:
            self._rec_count = self._host_int(self._rec_dev_count, "count")
        return self._rec_count

    @property
    def boundary_count(self) -> int:
        """Live boundaries of main, plus the recent level's when `lsm`
        (1 on the incremental path, where that level stays idle), plus an
        upper bound on run rows (2*Wn per append) — the reference's count.
        Reads a count on the host while a legacy pipelined stream is
        undrained."""
        n = self._host_count()
        if self._lsm:
            n += self._host_rec_count()
        if self._incremental:
            n += self._run_rows_ub
        return n

    @property
    def node_count(self) -> int:
        """The skip-list node-count analog: `boundary_count`."""
        return self.boundary_count

    def healthcheck(self) -> bool:
        """One tiny host<->device round trip through the live state."""
        return int(self._vs[:1].sum()) >= 0

    def fixpoint_iterations(self) -> int:
        """The intra fixpoint's iterations summed over every resolve so
        far (a replayed batch counts again): one read on the host."""
        return self._host_int(self._intra_iters, "fixpoint")

    def _barrier(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _offset(self, version: int) -> int:
        off = version - self._base
        if off >= 2**31 - 2**24:
            raise OverflowError(
                "version offset overflow: call remove_before to advance the "
                "MVCC window (reference GCs every batch, SkipList.cpp:1199)"
            )
        return max(off, 0)

    def _offset_array(self, versions: np.ndarray) -> np.ndarray:
        off = np.asarray(versions, dtype=np.int64) - self._base
        if off.size and int(off.max()) >= 2**31 - 2**24:
            raise OverflowError(
                "version offset overflow: call remove_before to advance the "
                "MVCC window (reference GCs every batch, SkipList.cpp:1199)"
            )
        return np.maximum(off, 0)

    # -- resolve -------------------------------------------------------------
    def resolve_batch(self, commit_version: int, txns: Sequence[TxInfo]) -> list[Verdict]:
        self._drain_all()  # settle any deferred window before sync work
        validate_batch(commit_version, txns, self._oldest)
        if commit_version <= self._last_commit:
            raise ValueError(
                f"commit_version {commit_version} not after last batch {self._last_commit}"
            )
        B = len(txns)
        if B == 0:
            self._last_commit = commit_version
            return []
        t_pack = time.perf_counter()
        packed = pack_batch(
            txns, self._oldest, self._offset, self._max_key_bytes,
            arena=self._arena, stats=self.stats,
            offset_array=self._offset_array, grow=True,
        )
        self.stats.pack_s += time.perf_counter() - t_pack
        codes = self.resolve_arrays(commit_version, *packed[:8])
        return [Verdict(int(c)) for c in codes[:B]]

    def _stage(self, rbv, rev, rtv, wbv, wev, wtv, snap_p, active_p):
        """The batch as device tensors: a numpy batch staged in one copy,
        or the tensors of a staged batch, checked to lie on this device."""
        if isinstance(rtv, np.ndarray):
            t_h2d = time.perf_counter()
            batch = stage_batch(self.device, rbv, rev, rtv, wbv, wev, wtv,
                                snap_p, active_p)
            self.stats.h2d_s += time.perf_counter() - t_h2d
            return batch
        batch = (rbv, rev, rtv, wbv, wev, wtv, snap_p, active_p)
        for t in batch:
            if t.device != self.device:
                raise ValueError(
                    f"a staged batch tensor is on {t.device}, the set on "
                    f"{self.device}"
                )
        return batch

    def _fit_width(self, batch):
        """The staged batch at the set's key width: a batch packed before
        the set last widened (one packed ahead, PipelinedPacker) gains the
        inserted lanes here."""
        if batch[0].shape[1] == self._W:
            return batch
        rb, re_, r_tx, wb, we, w_tx, snap, active = batch
        return (keymod.widen_lanes(rb, self._W), keymod.widen_lanes(re_, self._W),
                r_tx, keymod.widen_lanes(wb, self._W),
                keymod.widen_lanes(we, self._W), w_tx, snap, active)

    def _widen(self, W: int) -> None:
        """Widen every W-wide buffer of the state in place to W lanes (the
        main level, the run slots, the recent level); versions, the LSM
        table and the bucket index (the first lane's prefix) do not change.
        The widened state is the one a set built at that width would hold
        (keys.widen_lanes).  Rebound, never written in place, like every
        state update (conflict/pipeline.py).  Every widened buffer is made
        before any is rebound: where the card cannot hold them, raises
        KeyTooLongError (the width and the bytes asked for) and the set
        keeps its state, width and counts."""
        names = [n for n in ("_ks", "_runs_b", "_runs_e", "_rec_ks")
                 if getattr(self, n) is not None]
        asked = sum(getattr(self, n).numel() // self._W * W * 4 for n in names)
        try:
            wide = [keymod.widen_lanes(getattr(self, n), W) for n in names]
        except torch.OutOfMemoryError as e:
            raise keymod.KeyTooLongError(
                f"widening the conflict set to {4 * (W - 1)}-byte keys (W = "
                f"{W}) asks {asked} bytes of {self.device}, which cannot hold "
                f"them: {e}") from None
        for n, t in zip(names, wide):
            setattr(self, n, t)
        self._W, self._max_key_bytes = W, 4 * (W - 1)
        self.stats.widenings += 1
        self.stats.key_bytes = self._max_key_bytes

    @kernels.counted
    def resolve_arrays(
        self, commit_version: int, rbv, rev, rtv, wbv, wev, wtv, snap_p, active_p,
        sync: bool = True,
    ):
        """Packed fast path.  The batch is numpy arrays in pack_batch's
        layout (snap_p already offset against this set's base), or the
        eight tensors that stage_batch or StagedBatch.take() give, already
        on this set's device.

        sync=True (default): returns the int32 verdicts of the padded batch
        as numpy.  A bucketed search that did not converge (a 16-bit-prefix
        bucket deeper than FAST_SEARCH_ITERS rounds reach) is replayed at
        full depth, counted in `search_fallbacks`; a legacy merge that
        outgrew its level regrows (flat) or compacts (LSM) and replays.

        sync=False: PIPELINED — dispatches and returns the verdicts as a
        device tensor without reading anything on the host (but a
        compaction's fold counts, on the batch that compacts).  The
        search's convergence (and, legacy, the merged count's fit) folds
        into a device flag; `check_pipelined()` reads it, and raises if a
        batch since the last check failed: its verdicts are wrong and the
        stream must be replayed through sync=True (resolve_deferred does
        that itself).

        The whole call is the span `cs.resolve` (api.span).  Every call
        counts in `stats.batches`.  A synchronous one notes its answer
        (transactions, CONFLICTs, time) unless a recovery's replay runs it;
        a pipelined one is answered, and noted, by whoever reads its
        verdicts (resolve_deferred's drain, or the recovery)."""
        with span("cs.resolve", commit_version):
            return self._resolve_arrays(commit_version, rbv, rev, rtv, wbv, wev,
                                        wtv, snap_p, active_p, sync)

    def _resolve_arrays(self, commit_version: int, rbv, rev, rtv, wbv, wev, wtv,
                        snap_p, active_p, sync: bool, note: bool = True):
        """resolve_arrays inside its span.  note=False: a synchronous
        resolve that counts in `batches` and notes no answer (a pipelined
        dispatch's, whose caller answers it)."""
        if sync and self._inflight:
            # a deferred window is open: settle it first so the sync
            # result (and any fallback replay) sees the final state
            self._drain_all()
        if commit_version <= self._last_commit:
            raise ValueError(
                f"commit_version {commit_version} not after last batch {self._last_commit}"
            )
        R, Wn = rbv.shape[0], wbv.shape[0]
        commit_off = self._offset(commit_version)
        t0 = time.perf_counter()
        if rbv.shape[1] > self._W:
            self._widen(rbv.shape[1])  # a batch with a longer endpoint
        if self._incremental:
            if 2 * Wn > self._run_cap:
                self._grow_runs(_bucket(2 * Wn))
            if self._n_runs >= self._K:
                self._compact_runs()
        elif self._lsm:
            if 2 * Wn + 1 > self._rec_cap:  # a batch bigger than the level
                self._grow_recent(_bucket(4 * Wn + 2))
            if self._rec_count_ub + 2 * Wn > self._rec_cap:
                self._compact()
        elif not sync and self._count_ub + 2 * Wn > self._cap:
            # the merge may outgrow main: learn the exact count, and if it
            # really is near capacity, go through sync (which regrows)
            self.check_pipelined()
            if self._count_ub + 2 * Wn > self._cap:
                v = self._resolve_arrays(commit_version, rbv, rev, rtv, wbv,
                                         wev, wtv, snap_p, active_p, True,
                                         note=False)
                return torch.from_numpy(v).to(self.device)
        with span("cs.stage", commit_version):
            batch = self._fit_width(
                self._stage(rbv, rev, rtv, wbv, wev, wtv, snap_p, active_p))
        if self._incremental:
            verdict, conv = self._resolve_inc(batch, commit_off, Wn, sync)
        elif self._lsm:
            verdict, conv = self._resolve_lsm(batch, commit_off, Wn, sync)
        else:
            verdict, conv = self._resolve_flat(batch, commit_off, Wn, sync)
        self._last_commit = commit_version
        if isinstance(rtv, np.ndarray):  # counting rows of a staged batch would sync
            self.stats.real_rows += int((rtv >= 0).sum()) + int((wtv >= 0).sum())
            self.stats.padded_rows += R + Wn
        self.stats.batches += 1
        if not sync:
            if conv is not None:
                # rebound, never updated in place: each deferred handle
                # keeps the flag as it stood at its own dispatch
                self._dev_ok = self._dev_ok & conv
            self._pipelined_since_check += 1
            return verdict  # answered by whoever reads its verdicts
        v_np = self._host_numpy(verdict)
        if note and not self._replaying:  # else the recovery or the caller answers
            self._note_sync_answer(rtv, active_p, v_np, t0)
        return v_np

    def _fell_back(self, site: str) -> None:
        self.search_fallbacks += 1
        self.stats.search_fallbacks += 1
        testcov(site)

    def _resolve_inc(self, batch, commit_off: int, Wn: int, sync: bool):
        """The incremental resolve: main read-only, the committed writes
        appended as run `_n_runs`.  Returns (verdict, the pipelined
        validity to fold in, or None)."""
        core, hist_base = ((resolve_core_inc_lsm, self._tab) if self._lsm
                           else (resolve_core_inc, self._vs))
        if sync and self._phase_timing:
            verdict, nb, ne, nv, n_iters = self._resolve_inc_timed(
                batch, commit_off, hist_base)
            conv = None
        else:
            iters = min(FAST_SEARCH_ITERS, _levels(self._cap) + 1)
            while True:
                verdict, nb, ne, nv, conv, n_iters = core(
                    self._ks, hist_base, self._bidx, self._count,
                    self._runs_b, self._runs_e, self._runs_ver, self._n_runs,
                    *batch, commit_off, n_txn=batch[6].shape[0],
                    run_cap=self._run_cap, search_iters=iters,
                    search_impl=self._search_impl,
                )
                if not sync or conv is None or self._host_bool(conv, "search"):
                    break
                # a bucket deeper than 2**iters (shared-prefix keys): replay
                # at full search depth — nothing was written, so it is exact
                self._fell_back("kernel.search_fallback.inc")
                iters = _levels(self._cap) + 1
        self._runs_b, self._runs_e, self._runs_ver = nb, ne, nv
        self._intra_iters = self._intra_iters + n_iters
        self._n_runs += 1
        self._run_rows_ub += 2 * Wn
        self.stats.runs_appended += 1
        return verdict, conv

    def _resolve_inc_timed(self, batch, commit_off: int, hist_base):
        """The split-phase synchronous resolve of `phase_timing`: search,
        check and append dispatched one at a time, each waited out, their
        wall times added to stats.sort_s / scan_s / append_s.  The same
        functions as the fused resolve, so the same verdicts and state.
        Returns (verdict, runs_b', runs_e', runs_ver', fixpoint
        iterations)."""
        rb, re_, r_tx, wb, we, w_tx, snap, active = batch
        iters = min(FAST_SEARCH_ITERS, _levels(self._cap) + 1)
        while True:
            t = time.perf_counter()
            with span("cs.search"):
                g_lo, g_hi, conv = inc_search(
                    self._ks, self._bidx, self._count, rb, re_, r_tx,
                    search_iters=iters, search_impl=self._search_impl,
                )
                self._barrier()
            self.stats.sort_s += time.perf_counter() - t
            if conv is None or self._host_bool(conv, "search"):
                break
            self._fell_back("kernel.search_fallback.inc_timed")
            iters = _levels(self._cap) + 1
        t = time.perf_counter()
        with span("cs.check"):
            verdict, w_ins, n_iters = inc_check(
                self._tab if self._lsm else self._vs, g_lo, g_hi, rb, re_, r_tx,
                wb, we, w_tx, snap, active, self._runs_b, self._runs_e,
                self._runs_ver, n_txn=snap.shape[0], from_table=self._lsm,
            )
            self._barrier()
        self.stats.scan_s += time.perf_counter() - t
        t = time.perf_counter()
        with span("cs.append"):
            nb, ne, nv = inc_append(self._runs_b, self._runs_e, self._runs_ver,
                                    self._n_runs, wb, we, w_ins, commit_off,
                                    run_cap=self._run_cap)
            self._barrier()
        self.stats.append_s += time.perf_counter() - t
        return verdict, nb, ne, nv, n_iters

    def _resolve_flat(self, batch, commit_off: int, Wn: int, sync: bool):
        """The legacy flat resolve: the whole state merges this batch's
        committed writes.  Synchronous, a merge that outgrew main regrows
        it from the pre-batch state (nothing was written) and replays.
        Returns (verdict, the pipelined validity to fold in)."""
        def dispatch(iters):
            return resolve_core(
                self._ks, self._vs, self._bidx, self._main_count(), *batch,
                commit_off, cap=self._cap, n_txn=batch[6].shape[0],
                search_iters=iters, merge_impl=self._merge_impl,
                search_impl=self._search_impl,
            )

        fast = min(FAST_SEARCH_ITERS, _levels(self._cap) + 1)
        if not sync:
            verdict, nk, nv, nc, nb, conv, n_iters = dispatch(fast)
            self._ks, self._vs, self._bidx = nk, nv, nb
            self._count, self._dev_count = None, nc
            self._count_ub += 2 * Wn
            fits = nc <= self._cap
            ok = fits if conv is None else conv & fits
        else:
            while True:
                iters = fast
                while True:
                    verdict, nk, nv, nc, nb, conv, n_iters = dispatch(iters)
                    if conv is None or self._host_bool(conv, "search"):
                        break
                    self._fell_back("kernel.search_fallback.flat")
                    iters = _levels(self._cap) + 1
                nc_i = self._host_int(nc, "count")
                if nc_i <= self._cap:
                    break
                # the merge dropped boundaries: regrow and replay
                self._grow_main(max(self._cap * 2, _bucket(nc_i)))
            self._ks, self._vs, self._bidx = nk, nv, nb
            self._count = self._count_ub = nc_i
            self._dev_count = None
            ok = None
        self._intra_iters = self._intra_iters + n_iters
        self.stats.full_merges += 1
        return verdict, ok

    def _resolve_lsm(self, batch, commit_off: int, Wn: int, sync: bool):
        """The legacy LSM resolve: the committed writes merge into the
        recent level.  Synchronous, a merge that outgrew the level (the
        coalescing estimate beaten) compacts it into main and replays.
        Returns (verdict, the pipelined validity to fold in)."""
        def dispatch(iters, rec_iters):
            return resolve_core_lsm(
                self._ks, self._tab, self._bidx, self._count, self._rec_ks,
                self._rec_vs, self._rec_bidx, self._rec_count_now(), *batch,
                commit_off, rec_cap=self._rec_cap, n_txn=batch[6].shape[0],
                search_iters=iters, rec_iters=rec_iters,
                search_impl=self._search_impl, merge_impl=self._merge_impl,
            )

        while True:
            iters = min(FAST_SEARCH_ITERS, _levels(self._cap) + 1)
            rec_iters = min(self._rec_iters, _levels(self._rec_cap) + 1)
            if not sync:
                verdict, nrk, nrv, nrb, nrc, conv, n_iters = dispatch(iters, rec_iters)
                self._rec_count, self._rec_dev_count = None, nrc
                self._rec_count_ub += 2 * Wn
                fits = nrc <= self._rec_cap
                ok = fits if conv is None else conv & fits
                break
            while True:
                verdict, nrk, nrv, nrb, nrc, conv, n_iters = dispatch(iters, rec_iters)
                if conv is None or self._host_bool(conv, "search"):
                    break
                self._fell_back("kernel.search_fallback.lsm")
                iters = _levels(self._cap) + 1
                rec_iters = _levels(self._rec_cap) + 1
            nrc_i = self._host_int(nrc, "count")
            if nrc_i <= self._rec_cap:
                self._rec_count = self._rec_count_ub = nrc_i
                self._rec_dev_count = None
                ok = None
                break
            self._compact()
        self._rec_ks, self._rec_vs, self._rec_bidx = nrk, nrv, nrb
        self._intra_iters = self._intra_iters + n_iters
        self.stats.full_merges += 1
        return verdict, ok

    def check_pipelined(self) -> None:
        """Read the deferred validity of the sync=False resolves since the
        last check: ONE device flag, folded across the stream (and, on the
        legacy path, the live count).  Raises if any of them failed; the
        stream must then be replayed through sync=True resolves."""
        if self._pipelined_since_check == 0:
            return
        n = self._pipelined_since_check
        self._pipelined_since_check = 0
        if not self._host_bool(self._dev_ok, "window_flag"):
            raise RuntimeError(
                f"a pipelined batch among the last {n} failed its deferred"
                " search-convergence/capacity check; replay through sync=True"
            )
        if self._incremental:
            return
        if self._lsm:
            self._rec_count_ub = self._host_rec_count()
        else:
            self._count_ub = self._host_count()

    def _fold_all(self, rec_pairs) -> int:
        """Fold each (rows, vals) step function into main in turn (a
        `cs.compact.fold` span each), regrowing main and folding again when
        a fold's union outgrows it; then rebuild bidx and the LSM table
        (`cs.compact.index`).  Adds the compaction's least bytes to
        `stats.compact_bytes`: main's live rows before and after, each row
        W int32 lanes and an int32 version, read once and written once.
        Returns the new count."""
        before = self._count
        for rows, vals in rec_pairs:
            with span("cs.compact.fold"):
                while True:
                    nk, nv, nc = compact_lsm(self._ks, self._vs, rows, vals,
                                             cap=self._cap,
                                             merge_impl=self._merge_impl)
                    nc_i = self._host_int(nc, "fold_count")
                    if nc_i <= self._cap:
                        break
                    self._grow_main(max(self._cap * 2, _bucket(nc_i)))
                self._ks, self._vs = nk, nv
        self._count = self._count_ub = nc_i
        self._dev_count = None
        with span("cs.compact.index"):
            self._bidx = _rebuild_buckets(self._ks)
            self._tab = self._history_table()
        self.stats.compact_bytes += (before + nc_i) * (4 * self._W + 4)
        return nc_i

    def _note_fold(self, t0: float, before: int, after: int, site: str) -> float:
        self.stats.compactions += 1
        self.stats.rows_reclaimed += max(0, before - after)
        dt = time.perf_counter() - t0
        self.stats.merge_s += dt
        self.stats.fold_wall_s[self._merge_impl] = (
            self.stats.fold_wall_s.get(self._merge_impl, 0.0) + dt
        )
        testcov(site)
        return dt

    def _compact_runs(self) -> None:
        """The deferred k-way merge: fold every appended run (a step
        function at one commit version) into main, regrowing main when a
        fold's union outgrows it; then rebuild bidx (and the LSM table)."""
        if self._n_runs == 0:
            return
        t0 = time.perf_counter()
        before = self._count + self._run_rows_ub
        n = self._n_runs
        with span("cs.compact"):
            # every run as a step function (K4): its intervals at its version
            with span("cs.compact.step"):
                rows, vals = kernels.run_to_step_runs(
                    self._runs_b[:n], self._runs_e[:n], self._runs_ver[:n]
                )
            nc_i = self._fold_all(list(zip(rows, vals)))
            self._init_runs(self._run_cap)
        self.stats.compact_s += self._note_fold(t0, before, nc_i,
                                                "kernel.run_compaction")

    def _compact(self) -> None:
        """The LSM compaction: fold the recent level into main (regrowing
        main if the union does not fit) and start a fresh recent level."""
        t0 = time.perf_counter()
        before = self._count_ub + self._rec_count_ub
        with span("cs.compact"):
            nc_i = self._fold_all([(self._rec_ks, self._rec_vs)])
            self._init_recent(self._rec_cap)
        self._note_fold(t0, before, nc_i, "kernel.lsm_compaction")

    def remove_before(self, version: int) -> None:
        if version <= self._oldest:
            return
        self._oldest = version
        off = version - self._base
        if off > 0:
            t0 = time.perf_counter()
            with span("cs.gc", version):
                self._vs = torch.clamp(self._vs - off, min=0)
                if self._lsm:
                    # range-max commutes with the monotone clamp: the cached
                    # table is clamped, not rebuilt
                    self._tab = torch.clamp(self._tab - off, min=0)
                    if not self._incremental:  # idle (all 0) on the incremental path
                        self._rec_vs = torch.clamp(self._rec_vs - off, min=0)
                if self._incremental:
                    # a run whose version falls out of the MVCC window clamps
                    # to 0 and can never conflict again (snapshots are >= 0)
                    self._runs_ver = torch.clamp(self._runs_ver - off, min=0)
            self._base = version
            self.stats.gc_calls += 1
            self.stats.merge_s += time.perf_counter() - t0
            self._note_pipeline_gc(version)
