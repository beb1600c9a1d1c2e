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

K2 runs the whole intra-batch fixpoint in one launch and reads nothing
on the host: by `plan_intra`, a pure function of the shapes, in one
thread-block cluster whose blocks hold its state in shared memory (the
least of 1 to 16 blocks that holds it), or, for batches no cluster holds,
in one cooperative launch over device memory (the grid plan);
`intra_query` keeps the per-iteration query kernel that the fixpoint
replaced, which no system path calls: with
`intra_fixpoint_plain(..., query=intra_query)` it is the fixpoint's
referee on the card.  K5 is K1 without the history input.  No system path
calls it either: like the reference's `run_conflicts`, it is K1's unfused
referee, with a body of its own that shares no search or staging code
with K1's: by `plan_probe_tree`, a thread-block cluster a tile of reads,
block c of it searching runs c, c + C, ... for the tile (a thread a
(read, run) pair), the top levels of each run's search tree staged in
shared memory.  The source note of each kernel (bound on the card, what
the design does about it) is at the top of csrc/conflict_kernels.cu.  K1's and K3's plan and launch geometry come
from `plan_probe` and `plan_ranks`, pure functions of the shapes: the
staged kernels below WARP_FROM_W lanes, the warp kernels (a warp a (read,
run) pair, a warp a query, each search skipping the lanes its bounds share
with its key) from it.  K4's comes from `plan_run_to_step`: a thread an
output element, at every width, a run in row-aligned chunks of a 32-bit
index.  All are integer functions: kernel and plain version agree
exactly.
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
# K2's launches split by plan (plan_name: "grid", "cluster1" .. "cluster16");
# they sum to launches["intra_fixpoint"]
intra_launches: dict[str, int] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    intra_launches.clear()


def launch_counts() -> dict[str, int]:
    """`launches` and, under "intra_fixpoint.<plan>", K2's by plan: what a
    set, a process or a path reports of the kernels it launched."""
    return dict(launches, **{f"intra_fixpoint.{k}": n for k, n in intra_launches.items()})


# the open counted calls: (the set's dict, the process-wide count at entry)
_counting: list[tuple[dict[str, int], dict[str, int]]] = []


def counted(method: Callable) -> Callable:
    """Decorates a conflict set's method: the launches made inside it are
    added, by wrapper (and K2's by plan: launch_counts), to the set's own
    `stats.launches` as well as to the process-wide `launches`.  A call
    nested in another of the same set's counts once; one of another set's
    counts for that set alone."""

    @functools.wraps(method)
    def call(self, *args, **kwargs):
        into = self.stats.launches
        if any(d is into for d, _ in _counting):
            return method(self, *args, **kwargs)
        before = launch_counts()
        _counting.append((into, before))
        try:
            return method(self, *args, **kwargs)
        finally:
            _counting.pop()
            for name, n in launch_counts().items():
                made = n - before.get(name, 0)
                if made:
                    into[name] = into.get(name, 0) + made
                    for _, outer in _counting:  # not the enclosing sets'
                        outer[name] = outer.get(name, 0) + made

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
# T: from this key width (lanes) on, K1 and K3 take the warp plan (a warp
# a (read, run) pair, a warp a query, every search skipping the lanes its
# bounds share with its key); below it, the stream's W = 5 included, the
# staged plans.  Set from the card sweep (`chip_smoke.py --sweep`, cold ms,
# NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6): at W = 129 K1's warp
# plan loses on short keys in a widened set (0.1566 against the staged
# plan's 0.0815); at W = 257 the warp plans win all four (K1 0.1604 against
# 0.2189 on those keys and 0.1871 against 0.8702 behind a common prefix;
# K3 0.0768 against 0.2911 and 0.0969 against 0.9653), and by more at every
# wider W.
WARP_FROM_W = 257
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
WARP_BLOCK_WARPS = 8           # warps of a warp-plan block (K3's kRanksWarps)
PROBE_STAGE_BYTES = 96 * 1024  # K1's warp plan stages its read ends up to this
RANKS_WARP_QUERIES = 8         # recent rows per warp-plan K3 block: a query a warp


class ProbePlan(NamedTuple):
    group_log2: int   # a read's lanes (staged) or warps (warp plan): 2**group_log2
    stride_log2: int  # summary stride S = 2**stride_log2
    n_sum: int        # summary rows per run, ceil(run_cap / S); 0 in the warp plan
    threads: int      # per block
    smem: int         # dynamic shared bytes per block
    warp: int         # 1: the warp plan; 0: the staged plan


class RanksPlan(NamedTuple):
    span_rows: int    # main rows a block stages at most
    smem: int         # dynamic shared bytes per block
    queries: int      # recent rows per block
    warp: int         # 1: the warp plan; 0: the staged plan


def _group_log2(K: int) -> int:
    """log2 of K rounded up to a power of two, at most 32."""
    return min(max(K - 1, 0).bit_length(), 5)


def _summary_log2(K: int, run_cap: int, W: int) -> int | None:
    """log2 of the least summary stride >= PROBE_MIN_STRIDE whose summary
    (every S-th begin of every run) fits PROBE_SUMMARY_BYTES; None where
    none up to PROBE_MAX_STRIDE does."""
    for stride_log2 in range(PROBE_MIN_STRIDE.bit_length() - 1,
                             PROBE_MAX_STRIDE.bit_length()):
        if K * -(-run_cap >> stride_log2) * W * 4 <= PROBE_SUMMARY_BYTES:
            return stride_log2
    return None


@functools.lru_cache(maxsize=None)
def plan_probe(K: int, run_cap: int, W: int) -> ProbePlan:
    """K1's launch: the warp plan from W = WARP_FROM_W (T = 257 lanes,
    keys of 1024 bytes), and where the staged plan's run summary does not
    fit (hundreds of runs); else the staged plan."""
    if W >= WARP_FROM_W or _summary_log2(K, run_cap, W) is None:
        return plan_probe_warp(K, W)
    return plan_probe_staged(K, run_cap, W)


@functools.lru_cache(maxsize=None)
def plan_probe_staged(K: int, run_cap: int, W: int) -> ProbePlan:
    """K1's staged plan: one lane per (read, run) pair, a read's lanes in
    one warp.  The summary stride is the least power of two >=
    PROBE_MIN_STRIDE whose summary (every S-th begin of every run) fits
    PROBE_SUMMARY_BYTES.  A block stages its reads' begins and ends beside
    the summary: PROBE_READS of them (at most PROBE_MAX_THREADS lanes),
    halved until the block fits SMEM_MAX.  Raises where no summary fits or
    not even one read's rows do."""
    group_log2 = _group_log2(K)
    reads = min(PROBE_READS, PROBE_MAX_THREADS >> group_log2)
    stride_log2 = _summary_log2(K, run_cap, W)
    if stride_log2 is None:
        raise ValueError(f"no K1 summary of {K} runs of {run_cap} rows fits at W={W}")
    summary = K * -(-run_cap >> stride_log2) * W * 4
    while reads > 1 and summary + 2 * reads * W * 4 > SMEM_MAX:
        reads //= 2
    smem = summary + 2 * reads * W * 4  # with the reads' begins and ends
    if smem > SMEM_MAX:
        raise ValueError(f"K1's staged plan does not fit a block at W={W}")
    return ProbePlan(group_log2, stride_log2, -(-run_cap >> stride_log2),
                     reads << group_log2, smem, 0)


@functools.lru_cache(maxsize=None)
def plan_probe_warp(K: int, W: int, stage_bytes: int = PROBE_STAGE_BYTES) -> ProbePlan:
    """K1's warp plan: a warp per (read, run) pair, K rounded up to a power
    of two (at most 32; a warp then takes every 32nd run) warps a read,
    and as many reads as make WARP_BLOCK_WARPS warps (at least one).  The
    block stages its read ends in shared memory where they fit
    `stage_bytes` (each (W + 6) & ~3 ints: stage_async's alignment
    shift); else each search reads its key from L2 (a sweep times both)."""
    group_log2 = _group_log2(K)
    reads = max(WARP_BLOCK_WARPS >> group_log2, 1)
    staged = reads * 4 * ((W + 6) & ~3)
    smem = staged if staged <= min(stage_bytes, SMEM_MAX) else 0
    return ProbePlan(group_log2, 0, 0, 32 * (reads << group_log2), smem, 1)


@functools.lru_cache(maxsize=None)
def plan_ranks(W: int) -> RanksPlan:
    """K3's launch: the warp plan from W = WARP_FROM_W (T = 257 lanes,
    keys of 1024 bytes), else the staged plan."""
    return RANKS_WARP_PLAN if W >= WARP_FROM_W else plan_ranks_staged(W)


# K3's warp plan: kRanksWarps warps and RANKS_WARP_QUERIES queries a block
RANKS_WARP_PLAN = RanksPlan(0, 0, RANKS_WARP_QUERIES, 1)


@functools.lru_cache(maxsize=None)
def plan_ranks_staged(W: int) -> RanksPlan:
    """K3's staged plan: RANKS_THREADS threads and as many queries a block,
    staged with their 16-byte alignment slack and the least and the
    greatest query, and with the main rows between their least and
    greatest rank when those fit RANKS_SMEM (else no span is staged and
    the queries search main in global memory).  Raises where the queries
    do not fit a block (from about W = 440)."""
    row = 4 * W
    fixed = RANKS_THREADS * row + 16 + 4 * ((2 * W + 3) & ~3) + 12
    if fixed > SMEM_MAX:
        raise ValueError(f"K3's staged plan does not fit a block at W={W}")
    span_rows = max((RANKS_SMEM - fixed) // row, 0)
    return RanksPlan(span_rows, fixed + span_rows * row, RANKS_THREADS, 0)


# ---------------------------------------------------------------------------
# K4's launch plan (a pure function of the shapes)

STEP_THREADS = 256              # threads per K4 block (the kernel's kThreads)
STEP_PER = 8                    # elements a thread (the kernel's kStepPer)
STEP_MAX_ELEMS = (1 << 31) - 1  # a chunk's step elements: its index is 32-bit
STEP_MAX_GRID = 65535           # runs a launch (grid.y), chunks a run (grid.z)


class StepPlan(NamedTuple):
    magic: int       # o // W = (o * magic >> 32) >> shift for 0 <= o < 2**31; 0: W = 1
    shift: int
    chunk_rows: int  # step rows a chunk (even): a run's 2 rcap rows in `chunks`
    chunks: int      # chunks a run: grid.z, 1 unless 2 rcap W >= 2**31
    blocks: int      # blocks a chunk: ceil(chunk_rows W / (STEP_THREADS STEP_PER))


def step_divisor(W: int) -> tuple[int, int]:
    """(magic, shift) with o // W == (o * magic >> 32) >> shift for every
    0 <= o < 2**31: magic = ceil(2**(31 + l) / W) with l = ceil(log2 W),
    which is below 2**32 (Granlund and Montgomery 1994, theorem 4.2, with
    31-bit dividends); (0, 0) for W = 1, where the row is the element."""
    if W < 1:
        raise ValueError(f"K4 needs rows of at least one lane, not W={W}")
    if W == 1:
        return 0, 0
    l2 = (W - 1).bit_length()
    return -(-(1 << (31 + l2)) // W), l2 - 1


@functools.lru_cache(maxsize=None)
def plan_run_to_step(rcap: int, W: int) -> StepPlan:
    """K4's launch: each run's 2 rcap step rows in the fewest even-sized
    chunks of at most STEP_MAX_ELEMS elements (the kernel's 32-bit index),
    balanced, a chunk in tiles of STEP_THREADS * STEP_PER elements, a block
    a tile; the divisor's multiply-shift."""
    magic, shift = step_divisor(W)
    pairs = STEP_MAX_ELEMS // (2 * W)  # row pairs a chunk holds
    if pairs < 1:
        raise ValueError(f"K4 needs rows of at most {STEP_MAX_ELEMS // 2} lanes, not W={W}")
    chunks = max(1, -(-rcap // pairs))
    if chunks > STEP_MAX_GRID:
        raise ValueError(f"K4 cuts a run of {rcap} rows at W={W} into {chunks} "
                         f"chunks, past {STEP_MAX_GRID}")
    chunk_rows = 2 * -(-rcap // chunks)
    return StepPlan(magic, shift, chunk_rows, chunks,
                    -(-chunk_rows * W // (STEP_THREADS * STEP_PER)))


# ---------------------------------------------------------------------------
# K2's launch plans (pure functions of the shapes)

INTRA_THREADS = 1024           # threads per cluster-plan block (the kernel's kClusterThreads)
INTRA_CLUSTERS = (1, 2, 4, 8, 16)  # blocks of a cluster; the H100 takes 16 (non-portable above 8)


class IntraPlan(NamedTuple):
    cluster: int  # blocks of the one thread-block cluster; 0: the grid plan
    smem: int     # dynamic shared bytes per block (0 in the grid plan)


# the cooperative kernel over scratch in device memory, for the shapes
# whose state no cluster's shared memory holds
INTRA_GRID_PLAN = IntraPlan(0, 0)


def intra_leaves(n: int, cluster: int) -> int:
    """Leaves of K2's two min trees over n ranks: in the cluster plan
    (`cluster` > 0) ceil(n / cluster) a block, at least one, so the blocks
    share the ranks evenly; in the grid plan (0) a power of two >= n."""
    if cluster:
        return cluster * max(-(-n // cluster), 1)
    return 1 << max(n - 1, 0).bit_length()


def intra_room(items: int, cluster: int) -> int:
    """A block's room for `items` reads (or writes) over `cluster` blocks
    (the kernel's intra_room): its share and, beside other blocks, an
    eighth more, so that begins spread a little unevenly still land in
    the block that holds their rank."""
    share = -(-items // cluster)
    return share + share // 8 if cluster > 1 else share


def intra_cluster_bytes(R: int, Wn: int, B: int, cluster: int) -> int:
    """Shared bytes one block of K2's cluster plan takes (the kernel's
    intra_cluster_bytes, the same sum): three int32 trees (tree 1 and one
    tree 2 an iteration parity) over its S = leaves / cluster ranks, each
    in a room of 2 S ints or of a third of what staging parks there (a
    4-int record and a place for each read and write of its slice) where
    that is more; room (intra_room) for reads and writes, a 4-int record
    each; a header of 8 ints (the claim counts, the range flag) and the
    staging's counts and bases by block (4 x 16 ints); every txn's state
    byte and its hit bytes of two iterations; each part rounded up to 16
    bytes."""
    r4 = lambda ints: -(-ints // 4) * 4  # noqa: E731
    r16 = lambda b: -(-b // 16) * 16  # noqa: E731
    share = lambda x: -(-x // cluster)  # noqa: E731
    S = intra_leaves(2 * (R + Wn), cluster) // cluster
    tree = r4(max(2 * S, -(-5 * (share(R) + share(Wn)) // 3)))
    return (4 * (3 * tree + 4 * intra_room(R, cluster) + 4 * intra_room(Wn, cluster)
                 + 8 + 4 * INTRA_CLUSTERS[-1])
            + 3 * r16(B))


@functools.lru_cache(maxsize=None)
def plan_intra_cluster(R: int, Wn: int, B: int, cluster: int) -> IntraPlan:
    """K2's cluster plan at `cluster` blocks; raises where a block's share
    does not fit SMEM_MAX."""
    if cluster not in INTRA_CLUSTERS:
        raise ValueError(f"K2's cluster plan takes {INTRA_CLUSTERS} blocks, not {cluster}")
    smem = intra_cluster_bytes(R, Wn, B, cluster)
    if smem > SMEM_MAX:
        raise ValueError(f"K2's cluster of {cluster} blocks does not hold R={R}, "
                         f"Wn={Wn}, B={B}: {smem} B a block")
    return IntraPlan(cluster, smem)


@functools.lru_cache(maxsize=None)
def plan_intra(R: int, Wn: int, B: int) -> IntraPlan:
    """K2's launch: the least cluster whose blocks' shared memory holds the
    fixpoint (the trees are int32: Hopper has no 16-bit atomic min, and the
    offers are atomic); where none of 16 blocks does (the stream's mix of
    2 reads and 1 write a txn from 15,097 txns, the proxy's cap of 32,768
    among them), the grid plan."""
    for cluster in INTRA_CLUSTERS:
        if intra_cluster_bytes(R, Wn, B, cluster) <= SMEM_MAX:
            return plan_intra_cluster(R, Wn, B, cluster)
    return INTRA_GRID_PLAN


# ---------------------------------------------------------------------------
# K5's launch plan (a pure function of the shapes)

PROBE_TREE_READS = 256          # reads a K5 tile: threads of a block
PROBE_TREE_MAX_READS = 1024     # the kernel's kTreeMaxReads (and its verdict bytes)
PROBE_TREE_MAX_LEVELS = 16      # the kernel's kTreeMaxLevels
# The staged tree: at most PROBE_TREE_LEVELS levels, within PROBE_TREE_BYTES
# a block, set from the card (`chip_smoke.py --sweep`, PERF.md section 6):
# every block stages its run's top rows, so the bytes staged grow with 2**L
# while the compares saved grow with L, and at wide keys a staged level saves
# less than it costs.  W = 5 stages 7 levels (127 rows), 17 5, 65 4, 257 2,
# and from W = 1024 none (every compare of a search then reads global
# memory).
PROBE_TREE_LEVELS = 7
PROBE_TREE_BYTES = 4 * 1024
PROBE_TREE_MAX_CLUSTER = 16     # blocks of a cluster (non-portable above 8)
PROBE_TREE_MAX_TILES = 65535    # tiles a launch (grid.y)


class ProbeTreePlan(NamedTuple):
    levels: int   # levels of each run's search tree staged in shared memory (0: none)
    reads: int    # reads a tile: threads of a block
    cluster: int  # blocks of a cluster: a tile's runs dealt out among them


def tree_depth(run_cap: int) -> int:
    """The most compares a binary search of run_cap rows makes:
    ceil(log2(run_cap + 1)), the depth of its search tree."""
    return run_cap.bit_length()


def probe_tree_bytes(levels: int, W: int) -> int:
    """Shared bytes of K5's staged tree: 2**levels - 1 nodes, each its run
    row's index and its W lanes."""
    return ((1 << levels) - 1) * (W + 1) * 4


def probe_tree_cluster(K: int) -> int:
    """K5's blocks a cluster: one a run up to PROBE_TREE_MAX_CLUSTER runs;
    past it the fewest runs a block, dealt out evenly (K = 17: 9 blocks of
    2 runs or 1)."""
    per_block = max(-(-K // PROBE_TREE_MAX_CLUSTER), 1)
    return max(-(-K // per_block), 1)


@functools.lru_cache(maxsize=None)
def plan_probe_tree(K: int, run_cap: int, W: int) -> ProbeTreePlan:
    """K5's launch: the most levels of a run's search tree, at most
    PROBE_TREE_LEVELS and its depth, whose nodes fit PROBE_TREE_BYTES (0
    where not even the root does: every compare then reads global memory);
    tiles of PROBE_TREE_READS reads; a block a run up to 16 runs
    (probe_tree_cluster)."""
    levels = 0
    while (levels < min(tree_depth(run_cap), PROBE_TREE_LEVELS)
           and probe_tree_bytes(levels + 1, W) <= PROBE_TREE_BYTES):
        levels += 1
    return ProbeTreePlan(levels, PROBE_TREE_READS, probe_tree_cluster(K))


def check_probe_tree_plan(plan: ProbeTreePlan, R: int, W: int) -> None:
    """Raises ValueError where the kernel does not take `plan` for R reads
    at width W (the C entry refuses the same)."""
    levels, reads, cluster = plan
    if not 0 <= levels <= PROBE_TREE_MAX_LEVELS:
        raise ValueError(f"K5 stages 0 to {PROBE_TREE_MAX_LEVELS} levels, not {levels}")
    if not (32 <= reads <= PROBE_TREE_MAX_READS and reads % 32 == 0):
        raise ValueError(f"K5's tile is a multiple of 32 reads up to "
                         f"{PROBE_TREE_MAX_READS}, not {reads}")
    if not 1 <= cluster <= PROBE_TREE_MAX_CLUSTER:
        raise ValueError(f"K5's cluster is 1 to {PROBE_TREE_MAX_CLUSTER} blocks, not {cluster}")
    if probe_tree_bytes(levels, W) + PROBE_TREE_MAX_READS > SMEM_MAX:
        raise ValueError(f"K5's {levels} levels at W={W} take "
                         f"{probe_tree_bytes(levels, W)} B, past a block's {SMEM_MAX} "
                         f"beside its {PROBE_TREE_MAX_READS} B of verdicts")
    if -(-R // reads) > PROBE_TREE_MAX_TILES:
        raise ValueError(f"K5 takes at most {PROBE_TREE_MAX_TILES} tiles of {reads} "
                         f"reads a launch, not R={R}")


PROBE_TREE_SWEEP_LEVELS = 10    # the most levels probe_tree_plans tries


def probe_tree_plans(K: int, run_cap: int, W: int) -> list[ProbeTreePlan]:
    """Every plan the tests and the sweep force at a shape: the planned one
    first, then each level from 0 to PROBE_TREE_SWEEP_LEVELS the tree has
    and a block holds, tiles of 128 and 512 reads, and clusters of half the
    blocks (two runs a block) and of one block (every run in turn)."""
    p = plan_probe_tree(K, run_cap, W)
    out = [p]
    for levels in range(min(tree_depth(run_cap), PROBE_TREE_SWEEP_LEVELS) + 1):
        if probe_tree_bytes(levels, W) + PROBE_TREE_MAX_READS <= SMEM_MAX:
            out.append(p._replace(levels=levels))
    out += [p._replace(reads=128), p._replace(reads=512),
            p._replace(cluster=max(p.cluster // 2, 1)), p._replace(cluster=1)]
    return list(dict.fromkeys(out))


QUERY_THREADS = 256  # the per-query referee's block (the kernel's kThreads), a thread a read


def plan_name(plan: IntraPlan) -> str:
    """"grid", or "cluster<C>": the key of K2's launches by plan."""
    return f"cluster{plan.cluster}" if plan.cluster else "grid"


def warp_plan_occupancy(name: str, plan: ProbePlan | RanksPlan) -> int:
    """Blocks of K1's ("probe_fused") or K3's ("compact_ranks") warp-plan
    kernel that one SM of the current card holds at once under `plan`
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Needs the card."""
    k1 = name == "probe_fused"
    threads = plan.threads if k1 else 32 * WARP_BLOCK_WARPS
    got = _build.load().fdb_warp_plan_occupancy(0 if k1 else 1, threads, plan.smem)
    if got < 0:
        msg = _build.load().fdb_cuda_error_string(-got).decode()
        raise RuntimeError(f"occupancy of {name}'s warp plan: cuda error {-got} ({msg})")
    return got


@functools.lru_cache(maxsize=None)
def probe_tree_occupancy(device_index: int, plan: ProbeTreePlan, W: int) -> int:
    """Clusters of K5's `plan` at width W that the card holds at once
    (cudaOccupancyMaxActiveClusters); raises where it is 0 or the runtime
    refuses.  Needs the card; asked once a device, plan and width."""
    with torch.cuda.device(device_index):
        got = _build.load().fdb_probe_tree_occupancy(*plan, W)
    if got < 0:
        msg = _build.load().fdb_cuda_error_string(-got).decode()
        raise RuntimeError(f"occupancy of K5's plan {tuple(plan)} at W={W}: cuda error "
                           f"{-got} ({msg})")
    if got == 0:
        raise RuntimeError(f"the card holds no cluster of K5's plan {tuple(plan)} at W={W}")
    return got


@functools.lru_cache(maxsize=None)
def intra_cluster_occupancy(device_index: int, plan: IntraPlan) -> int:
    """Clusters of K2's cluster plan that the card holds at once
    (cudaOccupancyMaxActiveClusters); raises where it is 0 or the runtime
    refuses.  Needs the card; asked once a device and plan."""
    with torch.cuda.device(device_index):
        got = _build.load().fdb_intra_cluster_occupancy(plan.cluster, plan.smem)
    if got < 0:
        msg = _build.load().fdb_cuda_error_string(-got).decode()
        raise RuntimeError(f"occupancy of K2's {plan_name(plan)} plan: cuda error "
                           f"{-got} ({msg})")
    if got == 0:
        raise RuntimeError(f"the card holds no cluster of K2's {plan_name(plan)} plan "
                           f"({plan.smem} B a block)")
    return got


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


def probe_fused(rb, re_, snap_r, r_ok, runs_b, runs_e, runs_ver, hist_r, *,
                plan: ProbePlan | None = None):
    """K1: fused history + run probe.  rb, re_: int32[R, W]; snap_r:
    int32[R]; r_ok, hist_r: bool[R]; runs_b, runs_e: int32[K, run_cap, W];
    runs_ver: int32[K].  `plan`: plan_probe's unless given (a sweep times
    both plans).  Returns bool[R]."""
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
    plan = plan or plan_probe(K, run_cap, W)
    out = torch.empty(R, dtype=_BOOL, device=dev)
    if R:
        _launch("fdb_probe_fused", dev, *ptrs, out.data_ptr(), R, K, run_cap, W,
                *plan)
        launches["probe_fused"] += 1
    return out


def run_conflicts(rb, re_, snap_r, r_ok, runs_b, runs_e, runs_ver, *,
                  plan: ProbeTreePlan | None = None):
    """K5: the run probe alone (K1 without the history input), the
    contract of run_conflicts_xla (pallas_kernel.py:253).  Shapes as K1's.
    `plan`: plan_probe_tree's unless given (the tests and a sweep force
    each plan).  Raises where the kernel does not take the plan, the card
    holds no cluster of it or refuses the launch.  Returns bool[R]."""
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
    plan = plan or plan_probe_tree(K, run_cap, W)
    check_probe_tree_plan(plan, R, W)
    out = torch.empty(R, dtype=_BOOL, device=dev)
    if R:
        probe_tree_occupancy(dev.index, plan, W)
        _launch("fdb_probe", dev, *ptrs, out.data_ptr(), R, K, run_cap, W, *plan)
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


def compact_ranks(ks, rec_ks, *, plan: RanksPlan | None = None):
    """K3: ub[j] = #ks rows <= rec_ks[j].  ks: int32[cap, W] sorted;
    rec_ks: int32[n_rec, W].  `plan`: plan_ranks' unless given (a sweep
    times both plans).  Returns int32[n_rec]."""
    if _is_cpu(ks):
        return compact_ranks_plain(ks, rec_ks)
    cap, W = ks.shape
    n_rec = rec_ks.shape[0]
    dev = ks.device
    ptrs = [
        _check("ks", ks, _I32, (cap, W), dev),
        _check("rec_ks", rec_ks, _I32, (n_rec, W), dev),
    ]
    plan = plan or plan_ranks(W)
    out = torch.empty(n_rec, dtype=_I32, device=dev)
    if n_rec:
        _launch("fdb_compact_ranks", dev, *ptrs, out.data_ptr(), cap, n_rec, W,
                *plan)
        launches["compact_ranks"] += 1
    return out


def intra_fixpoint(rb_r, re_r, wb_r, we_r, r_ok, w_ok, r_idx, w_idx, w_tx,
                   active, hist, n_txn: int, *, plan: IntraPlan | None = None):
    """K2: the whole intra-batch fixpoint in one launch, the contract of
    intra_fixpoint_plain.  rb_r, re_r: int32[R]; wb_r, we_r, w_tx:
    int32[Wn]; r_ok: bool[R]; w_ok: bool[Wn]; r_idx: int64[R]; w_idx:
    int64[Wn]; active, hist: bool[n_txn].  `plan`: plan_intra's unless
    given (the tests and a sweep force each plan): one thread-block cluster
    holding the fixpoint in its shared memory, or the grid plan, one
    cooperative launch over scratch in device memory.  Returns (intra
    bool[n_txn], n_iters int32[1]), both on the device: nothing is read on
    the host.  Its domain is what _intra_setup and inc_check give: ranks in
    [0, n) with n = 2 * (R + Wn), r_idx and w_idx in [0, n_txn).  It is not
    checked here (that would read on the host); the kernels clamp each
    index into its buffer, so an input outside the domain gives a wrong
    answer, never a stray write.  Raises if the card refuses the launch or
    holds no cluster of the plan."""
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
    plan = plan or plan_intra(R, Wn, B)
    n = 2 * (R + Wn)
    leaves = intra_leaves(n, plan.cluster)
    intra = torch.empty(B, dtype=_BOOL, device=dev)
    n_iters = torch.empty(1, dtype=_I32, device=dev)
    if plan.cluster:
        intra_cluster_occupancy(dev.index, plan)
        scratch = None
    else:
        # two min trees over the ranks, the intra bits and the hit flags
        # as int32, and the two parity slots of the changed flag
        scratch = torch.empty(4 * leaves + 2 * B + 2, dtype=_I32, device=dev)
    _launch("fdb_intra_fixpoint", dev, *ptrs, intra.data_ptr(), n_iters.data_ptr(),
            None if scratch is None else scratch.data_ptr(), R, Wn, B, n, leaves, *plan)
    launches["intra_fixpoint"] += 1
    key = plan_name(plan)
    intra_launches[key] = intra_launches.get(key, 0) + 1
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
    if K > STEP_MAX_GRID:
        raise ValueError(f"K4 takes at most {STEP_MAX_GRID} runs a launch, not {K}")
    rows = torch.empty((K, 2 * rcap, W), dtype=_I32, device=dev)
    vals = torch.empty((K, 2 * rcap), dtype=_I32, device=dev)
    if K * rcap:
        _launch("fdb_run_to_step", dev, *ptrs, rows.data_ptr(),
                vals.data_ptr(), K, rcap, W, *plan_run_to_step(rcap, W))
        launches["run_to_step"] += 1
    return rows, vals


def run_to_step(u_b, u_e, ver):
    """K4's one-run case.  u_b, u_e: int32[rcap, W]; ver: a one-element
    int32 tensor.  Returns (rows int32[2*rcap, W], vals int32[2*rcap])."""
    if _is_cpu(u_b):
        return run_to_step_plain(u_b, u_e, ver)
    rows, vals = run_to_step_runs(u_b[None], u_e[None], ver.reshape(1))
    return rows[0], vals[0]
