"""The conflict check's kernels: a CUDA kernel and a plain torch version each.

Port of foundationdb_tpu/conflict/pallas_kernel.py.  Every wrapper below
takes its plain torch version only when its tensors lie on the CPU; on a
CUDA tensor it checks device, dtype, shape and contiguity, allocates the
output with `torch.empty`, launches the hand-written kernel of
csrc/conflict_kernels.cu on the current stream (never synchronising), and
raises if the launch is refused.  There is no fallback from one to the
other.  `launches` counts kernel launches per wrapper, so a run can show
that its main path went through the kernels.

  K1 probe_fused       <- _probe_fused_kernel  (pallas_kernel.py:189)
  K2 intra_fixpoint    <- _intra_kernel        (pallas_kernel.py:353) and the
                          lax.while_loop around it (device.py:394)
     intra_query       <- _intra_kernel, one query (the fixpoint's referee)
  K3 compact_ranks     <- _rank_count_kernel   (pallas_kernel.py:474)
  K4 run_to_step_runs  <- _interleave_kernel   (pallas_kernel.py:416);
     run_to_step          its one-run case
  K5 run_conflicts     <- _probe_kernel        (pallas_kernel.py:165)

K2 runs the whole intra-batch fixpoint in one cooperative launch and
reads nothing on the host; `intra_query` keeps the per-iteration query
kernel that the fixpoint replaced, which no system path calls: with
`intra_fixpoint_plain(..., query=intra_query)` it is the fixpoint's
referee on the card.  K5 is K1 without the history input.  No system path
calls it either: like the reference's `run_conflicts`, it is K1's unfused
referee, and its kernel keeps the thread-per-read design that K1's
parallel-over-runs kernel replaced.  The source note of each kernel (bound
on the card, what the design does about it) is at the top of
csrc/conflict_kernels.cu.  K1's and K3's launch geometry comes from
`plan_probe` and `plan_ranks`, pure functions of the shapes.  All are
integer functions: kernel and plain version agree exactly.
"""

from __future__ import annotations

import functools
from collections.abc import Callable
from typing import NamedTuple

import torch

from ..keys import SENT_LANE, with_last_lane_inc
from ..ops.rmq import (
    I32_MAX,
    build_sparse_table,
    query_sparse_table,
    range_update_point_query,
)
from ..ops.search import lex_less, lower_bound
from . import _build

launches: dict[str, int] = {
    "probe_fused": 0,
    "intra_query": 0,
    "compact_ranks": 0,
    "run_to_step": 0,
    "probe": 0,
    "intra_fixpoint": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# the open counted calls: (the set's dict, the process-wide count at entry)
_counting: list[tuple[dict[str, int], dict[str, int]]] = []


def counted(method: Callable) -> Callable:
    """Decorates a conflict set's method: the launches made inside it are
    added, by wrapper, to the set's own `stats.launches` as well as to the
    process-wide `launches`.  A call nested in another of the same set's
    counts once; one of another set's counts for that set alone."""

    @functools.wraps(method)
    def call(self, *args, **kwargs):
        into = self.stats.launches
        if any(d is into for d, _ in _counting):
            return method(self, *args, **kwargs)
        before = dict(launches)
        _counting.append((into, before))
        try:
            return method(self, *args, **kwargs)
        finally:
            _counting.pop()
            for name, n in launches.items():
                made = n - before[name]
                if made:
                    into[name] = into.get(name, 0) + made
                    for _, outer in _counting:  # not the enclosing sets'
                        outer[name] += made

    return call


# ---------------------------------------------------------------------------
# plain torch versions (the CPU path, and the kernels' referees on the card)


def run_conflicts_plain(rb, re_, snap_r, r_ok, runs_b, runs_e, runs_ver):
    """bool[R] = r_ok & any over runs k of [runs_ver[k] > snap and rank > 0
    and rb < ends[rank-1]], rank = #begins of run k < re — the per-run
    lower bound of run_conflicts_xla (pallas_kernel.py:253)."""
    K, run_cap, _ = runs_b.shape
    conf = torch.zeros(rb.shape[0], dtype=torch.bool, device=rb.device)
    for k in range(K):
        rank = lower_bound(runs_b[k], re_)
        e_last = runs_e[k][torch.clamp(rank - 1, 0, run_cap - 1).long()]
        intersects = (rank > 0) & lex_less(rb, e_last)
        conf = conf | (intersects & (runs_ver[k] > snap_r))
    return r_ok & conf


def probe_fused_plain(rb, re_, snap_r, r_ok, runs_b, runs_e, runs_ver, hist_r):
    """bool[R] = hist_r | run_conflicts_plain(...): the run probe with the
    main-level history bit fused in."""
    return hist_r | run_conflicts_plain(rb, re_, snap_r, r_ok, runs_b, runs_e,
                                        runs_ver)


def intra_query_plain(beg_tab, stab, rb_r, re_r):
    """int32[R] = min(range-min of beg_tab over ranks (rb_r, re_r),
    stab[rb_r]) — query_sparse_table plus one gather."""
    n = stab.shape[0]
    case1 = query_sparse_table(beg_tab, rb_r + 1, re_r, torch.minimum, I32_MAX)
    return torch.minimum(case1, stab[torch.clamp(rb_r, 0, n - 1).long()])


def _fixpoint(step, n_txn: int, device) -> tuple[torch.Tensor, int]:
    """The reference's `lax.while_loop(changed & (it < B + 2))`: run `step`
    until the intra bits stop changing, reading the flag on the host every
    iteration.  Returns (intra, n_iters)."""
    intra = torch.zeros(n_txn, dtype=torch.bool, device=device)
    changed, it = True, 0
    while changed and it < n_txn + 2:
        new_intra = step(intra)
        changed = bool(torch.any(new_intra != intra))
        intra = new_intra
        it += 1
    return intra, it


def intra_fixpoint_plain(rb_r, re_r, wb_r, we_r, r_ok, w_ok, r_idx, w_idx,
                         w_tx, active, hist, n_txn: int, *,
                         query=intra_query_plain):
    """The rank-space intra-batch fixpoint, one torch step a host loop
    iteration: per iteration the committed writers' begins scatter into a
    min-sparse-table (case 1), their spans into a range-update point-query
    array (case 2), `query` answers each read's min over both (K2's
    function; `intra_query` puts the K2 kernel in the loop), and a txn is
    intra-conflicted iff one of its reads' min is an earlier txn.  Returns
    (intra bool[n_txn], n_iters int32[1]), the count a device tensor."""
    B = n_txn
    n = 2 * (rb_r.shape[0] + wb_r.shape[0])
    tx_iota = torch.arange(B, dtype=torch.int32, device=rb_r.device)
    w_span = wb_r < we_r  # non-empty in rank space
    wb_idx = wb_r.long()

    def step(intra):
        committed = active & ~hist & ~intra
        w_com = w_ok & committed[w_idx.long()]
        w_cand = torch.where(w_com, w_tx, I32_MAX)
        begs = torch.full((n,), I32_MAX, dtype=torch.int32, device=rb_r.device)
        begs.scatter_reduce_(0, wb_idx, w_cand, "amin")
        beg_tab = build_sparse_table(begs, torch.minimum, I32_MAX)
        stab = range_update_point_query(
            n, wb_r, we_r, w_cand, w_com & w_span, "min", I32_MAX
        )
        minw = torch.where(r_ok, query(beg_tab, stab, rb_r, re_r), I32_MAX)
        tx_minw = torch.full((B,), I32_MAX, dtype=torch.int32, device=rb_r.device)
        tx_minw.scatter_reduce_(0, r_idx.long(), minw, "amin")
        return tx_minw < tx_iota

    intra, it = _fixpoint(step, B, rb_r.device)
    return intra, torch.tensor([it], dtype=torch.int32, device=rb_r.device)


def compact_ranks_plain(ks, rec_ks):
    """int32[n_rec] = #ks rows lexicographically <= rec_ks[j] (lower bound
    of the row with its length lane + 1; sentinel rows wrap)."""
    return lower_bound(ks, with_last_lane_inc(rec_ks))


def run_to_step_plain(u_b, u_e, ver):
    """One run as a step function: rows[2i] = u_b[i], rows[2i+1] = u_e[i];
    vals[2i] = ver on a live begin (0 on a sentinel), vals[2i+1] = 0."""
    rcap, W = u_b.shape
    rows = torch.stack([u_b, u_e], dim=1).reshape(2 * rcap, W)
    v = torch.where(u_b[:, -1] != SENT_LANE, ver.reshape(()), 0)
    vals = torch.stack([v, torch.zeros_like(v)], dim=1).reshape(2 * rcap)
    return rows, vals.to(torch.int32)


def run_to_step_runs_plain(runs_b, runs_e, runs_ver):
    """run_to_step_plain over every run, stacked: rows int32[K, 2*rcap, W],
    vals int32[K, 2*rcap]."""
    steps = [run_to_step_plain(b, e, v) for b, e, v in zip(runs_b, runs_e, runs_ver)]
    return torch.stack([s[0] for s in steps]), torch.stack([s[1] for s in steps])


# ---------------------------------------------------------------------------
# launch plans of K1 and K3 (pure functions of the shapes)

SMEM_MAX = 227 * 1024          # dynamic shared memory one block may take
PROBE_READS = 128              # reads per K1 block (the TPU's READ_BLOCK)
PROBE_MAX_THREADS = 1024
# the least summary stride: of 128 (the TPU kernel's SUMMARY_STRIDE) to
# 1024, K1 at the stream's shapes ran fastest on the card at 512 and 1024:
# every block stages the whole summary, and a sparser one saves more
# staging than its longer window search costs
PROBE_MIN_STRIDE = 512
PROBE_MAX_STRIDE = 1 << 16
PROBE_SUMMARY_BYTES = 40 * 1024
RANKS_THREADS = 128            # threads per K3 block (the kernel's kRanksThreads)
RANKS_SMEM = 112 * 1024        # two K3 blocks an SM


class ProbePlan(NamedTuple):
    group_log2: int   # lanes per read: 2**group_log2, K rounded up, <= 32
    stride_log2: int  # summary stride S = 2**stride_log2
    n_sum: int        # summary rows per run, ceil(run_cap / S); 0: no summary
    threads: int      # per block: reads per block << group_log2
    smem: int         # dynamic shared bytes per block


class RanksPlan(NamedTuple):
    span_rows: int    # main rows a block stages at most
    smem: int         # dynamic shared bytes per block
    queries: int      # recent rows per block, <= RANKS_THREADS


@functools.lru_cache(maxsize=None)
def plan_probe(K: int, run_cap: int, W: int) -> ProbePlan:
    """K1's launch: one lane per (read, run) pair, a read's lanes in one
    warp.  The summary stride is the least power of two >= PROBE_MIN_STRIDE
    whose summary (every S-th begin of every run) fits PROBE_SUMMARY_BYTES;
    where none up to PROBE_MAX_STRIDE does (wide keys, many runs) there is
    no summary (n_sum = 0) and the kernel ranks each read end against the
    whole run in global memory.  A block stages its reads' begins and ends
    beside the summary: PROBE_READS of them, halved until the block fits
    SMEM_MAX.  Raises where not even one read's rows fit."""
    group_log2 = min(max(K - 1, 0).bit_length(), 5)
    reads = min(PROBE_READS, PROBE_MAX_THREADS >> group_log2)
    stride_log2 = PROBE_MIN_STRIDE.bit_length() - 1
    while (summary := K * -(-run_cap >> stride_log2) * W * 4) > PROBE_SUMMARY_BYTES:
        if 1 << stride_log2 >= PROBE_MAX_STRIDE:
            break
        stride_log2 += 1
    n_sum = -(-run_cap >> stride_log2)
    if summary > PROBE_SUMMARY_BYTES:
        summary = n_sum = 0
    while reads > 1 and summary + 2 * reads * W * 4 > SMEM_MAX:
        reads //= 2
    smem = summary + 2 * reads * W * 4  # with the reads' begins and ends
    if smem > SMEM_MAX:
        raise ValueError(
            f"probe_fused: one read's rows exceed shared memory at K={K}, "
            f"run_cap={run_cap}, W={W} (block <= {SMEM_MAX} B)")
    return ProbePlan(group_log2, stride_log2, n_sum, reads << group_log2, smem)


@functools.lru_cache(maxsize=None)
def plan_ranks(W: int) -> RanksPlan:
    """K3's launch: RANKS_THREADS threads a block, and as many queries
    (halved until they, their 16-byte alignment slack and the least and
    the greatest query fit SMEM_MAX), staged with the main rows between
    their least and greatest rank when those fit RANKS_SMEM (else no span
    is staged and the queries search main in global memory).  Raises
    where not even one query fits."""
    row = 4 * W

    def fixed(queries: int) -> int:
        return queries * row + 16 + 4 * ((2 * W + 3) & ~3) + 12

    queries = RANKS_THREADS
    while queries > 1 and fixed(queries) > SMEM_MAX:
        queries //= 2
    if fixed(queries) > SMEM_MAX:
        raise ValueError(f"compact_ranks: one query row of W={W} lanes "
                         f"exceeds {SMEM_MAX} B of shared memory")
    span_rows = max((RANKS_SMEM - fixed(queries)) // row, 0)
    return RanksPlan(span_rows, fixed(queries) + span_rows * row, queries)


# ---------------------------------------------------------------------------
# launch plumbing


def _is_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"conflict kernels run on cuda or cpu, not {t.device}")
    return False


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> int:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


# entry point name -> bound ctypes function, filled at each one's first launch
_entries: dict[str, Callable[..., int]] = {}


def _launch(entry: str, device: torch.device, *args) -> None:
    fn = _entries.get(entry)
    if fn is None:
        fn = _entries[entry] = getattr(_build.load(), entry)
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:  # the runtime launches on its current device
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err:
        msg = _build.load().fdb_cuda_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: cuda error {err} ({msg})")


_I32, _I64, _BOOL = torch.int32, torch.int64, torch.bool


# ---------------------------------------------------------------------------
# wrappers


def probe_fused(rb, re_, snap_r, r_ok, runs_b, runs_e, runs_ver, hist_r):
    """K1: fused history + run probe.  rb, re_: int32[R, W]; snap_r:
    int32[R]; r_ok, hist_r: bool[R]; runs_b, runs_e: int32[K, run_cap, W];
    runs_ver: int32[K].  Returns bool[R].  On the card, raises where
    plan_probe cannot fit one read's rows in shared memory."""
    if _is_cpu(rb):
        return probe_fused_plain(rb, re_, snap_r, r_ok, runs_b, runs_e,
                                 runs_ver, hist_r)
    R, W = rb.shape
    K, run_cap, _ = runs_b.shape
    dev = rb.device
    ptrs = [
        _check("rb", rb, _I32, (R, W), dev),
        _check("re", re_, _I32, (R, W), dev),
        _check("snap_r", snap_r, _I32, (R,), dev),
        _check("r_ok", r_ok, _BOOL, (R,), dev),
        _check("hist_r", hist_r, _BOOL, (R,), dev),
        _check("runs_b", runs_b, _I32, (K, run_cap, W), dev),
        _check("runs_e", runs_e, _I32, (K, run_cap, W), dev),
        _check("runs_ver", runs_ver, _I32, (K,), dev),
    ]
    plan = plan_probe(K, run_cap, W)
    out = torch.empty(R, dtype=_BOOL, device=dev)
    if R:
        _launch("fdb_probe_fused", dev, *ptrs, out.data_ptr(), R, K, run_cap, W,
                *plan)
        launches["probe_fused"] += 1
    return out


def run_conflicts(rb, re_, snap_r, r_ok, runs_b, runs_e, runs_ver):
    """K5: the run probe alone (K1 without the history input), the
    contract of run_conflicts_xla (pallas_kernel.py:253).  Shapes as K1's.
    Returns bool[R]."""
    if _is_cpu(rb):
        return run_conflicts_plain(rb, re_, snap_r, r_ok, runs_b, runs_e,
                                   runs_ver)
    R, W = rb.shape
    K, run_cap, _ = runs_b.shape
    dev = rb.device
    ptrs = [
        _check("rb", rb, _I32, (R, W), dev),
        _check("re", re_, _I32, (R, W), dev),
        _check("snap_r", snap_r, _I32, (R,), dev),
        _check("r_ok", r_ok, _BOOL, (R,), dev),
        _check("runs_b", runs_b, _I32, (K, run_cap, W), dev),
        _check("runs_e", runs_e, _I32, (K, run_cap, W), dev),
        _check("runs_ver", runs_ver, _I32, (K,), dev),
    ]
    out = torch.empty(R, dtype=_BOOL, device=dev)
    if R:
        _launch("fdb_probe", dev, *ptrs, out.data_ptr(), R, K, run_cap, W)
        launches["probe"] += 1
    return out


def intra_query(beg_tab, stab, rb_r, re_r):
    """K2: per-read min query of the intra-batch fixpoint.  beg_tab:
    int32[L, n]; stab: int32[n]; rb_r, re_r: int32[R].  Returns int32[R]."""
    if _is_cpu(beg_tab):
        return intra_query_plain(beg_tab, stab, rb_r, re_r)
    L, n = beg_tab.shape
    R = rb_r.shape[0]
    dev = beg_tab.device
    ptrs = [
        _check("beg_tab", beg_tab, _I32, (L, n), dev),
        _check("stab", stab, _I32, (n,), dev),
        _check("rb_r", rb_r, _I32, (R,), dev),
        _check("re_r", re_r, _I32, (R,), dev),
    ]
    out = torch.empty(R, dtype=_I32, device=dev)
    if R:
        _launch("fdb_intra_query", dev, *ptrs, out.data_ptr(), R, L, n)
        launches["intra_query"] += 1
    return out


def compact_ranks(ks, rec_ks):
    """K3: ub[j] = #ks rows <= rec_ks[j].  ks: int32[cap, W] sorted;
    rec_ks: int32[n_rec, W].  Returns int32[n_rec].  On the card, raises
    where plan_ranks cannot take W."""
    if _is_cpu(ks):
        return compact_ranks_plain(ks, rec_ks)
    cap, W = ks.shape
    n_rec = rec_ks.shape[0]
    dev = ks.device
    ptrs = [
        _check("ks", ks, _I32, (cap, W), dev),
        _check("rec_ks", rec_ks, _I32, (n_rec, W), dev),
    ]
    plan = plan_ranks(W)
    out = torch.empty(n_rec, dtype=_I32, device=dev)
    if n_rec:
        _launch("fdb_compact_ranks", dev, *ptrs, out.data_ptr(), cap, n_rec, W,
                *plan)
        launches["compact_ranks"] += 1
    return out


def intra_fixpoint(rb_r, re_r, wb_r, we_r, r_ok, w_ok, r_idx, w_idx, w_tx,
                   active, hist, n_txn: int):
    """K2: the whole intra-batch fixpoint in one cooperative launch, the
    contract of intra_fixpoint_plain.  rb_r, re_r: int32[R]; wb_r, we_r,
    w_tx: int32[Wn]; r_ok: bool[R]; w_ok: bool[Wn]; r_idx: int64[R];
    w_idx: int64[Wn]; active, hist: bool[n_txn].  Returns (intra
    bool[n_txn], n_iters int32[1]), both on the device: nothing is read on
    the host.  Its domain is what _intra_setup and inc_check give: ranks in
    [0, n) with n = 2 * (R + Wn), r_idx and w_idx in [0, n_txn).  It is not
    checked here (that would read on the host); the kernel clamps each
    index into its buffer, so an input outside the domain gives a wrong
    answer, never a stray write.  Raises if the card refuses the
    cooperative launch."""
    if _is_cpu(rb_r):
        return intra_fixpoint_plain(rb_r, re_r, wb_r, we_r, r_ok, w_ok, r_idx,
                                    w_idx, w_tx, active, hist, n_txn)
    R, Wn, B = rb_r.shape[0], wb_r.shape[0], n_txn
    dev = rb_r.device
    ptrs = [
        _check("rb_r", rb_r, _I32, (R,), dev),
        _check("re_r", re_r, _I32, (R,), dev),
        _check("wb_r", wb_r, _I32, (Wn,), dev),
        _check("we_r", we_r, _I32, (Wn,), dev),
        _check("r_ok", r_ok, _BOOL, (R,), dev),
        _check("w_ok", w_ok, _BOOL, (Wn,), dev),
        _check("r_idx", r_idx, _I64, (R,), dev),
        _check("w_idx", w_idx, _I64, (Wn,), dev),
        _check("w_tx", w_tx, _I32, (Wn,), dev),
        _check("active", active, _BOOL, (B,), dev),
        _check("hist", hist, _BOOL, (B,), dev),
    ]
    n = 2 * (R + Wn)
    leaves = 1 << max(n - 1, 0).bit_length()  # a power of two >= max(n, 1)
    intra = torch.empty(B, dtype=_BOOL, device=dev)
    n_iters = torch.empty(1, dtype=_I32, device=dev)
    # two min trees over the ranks, the intra bits and the hit flags as
    # int32, and the two parity slots of the changed flag
    scratch = torch.empty(4 * leaves + 2 * B + 2, dtype=_I32, device=dev)
    _launch("fdb_intra_fixpoint", dev, *ptrs, intra.data_ptr(),
            n_iters.data_ptr(), scratch.data_ptr(), R, Wn, B, n, leaves)
    launches["intra_fixpoint"] += 1
    return intra, n_iters


def run_to_step_runs(runs_b, runs_e, runs_ver):
    """K4: every run as a step function, in one launch.  runs_b, runs_e:
    int32[K, rcap, W]; runs_ver: int32[K] (read on the device, no host
    sync).  Returns (rows int32[K, 2*rcap, W], vals int32[K, 2*rcap])."""
    if _is_cpu(runs_b):
        return run_to_step_runs_plain(runs_b, runs_e, runs_ver)
    K, rcap, W = runs_b.shape
    dev = runs_b.device
    ptrs = [
        _check("runs_b", runs_b, _I32, (K, rcap, W), dev),
        _check("runs_e", runs_e, _I32, (K, rcap, W), dev),
        _check("runs_ver", runs_ver, _I32, (K,), dev),
    ]
    rows = torch.empty((K, 2 * rcap, W), dtype=_I32, device=dev)
    vals = torch.empty((K, 2 * rcap), dtype=_I32, device=dev)
    if K * rcap:
        _launch("fdb_run_to_step", dev, *ptrs, rows.data_ptr(),
                vals.data_ptr(), K, rcap, W)
        launches["run_to_step"] += 1
    return rows, vals


def run_to_step(u_b, u_e, ver):
    """K4's one-run case.  u_b, u_e: int32[rcap, W]; ver: a one-element
    int32 tensor.  Returns (rows int32[2*rcap, W], vals int32[2*rcap])."""
    if _is_cpu(u_b):
        return run_to_step_plain(u_b, u_e, ver)
    rows, vals = run_to_step_runs(u_b[None], u_e[None], ver.reshape(1))
    return rows[0], vals[0]
