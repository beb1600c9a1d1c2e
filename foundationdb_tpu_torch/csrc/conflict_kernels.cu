// Hopper (sm_90a) kernels of the resolver's conflict check.
//
// Each kernel replaces one Pallas kernel of
// foundationdb_tpu/conflict/pallas_kernel.py and computes what that kernel
// computes; it is not a block-by-block copy of the TPU grid.  Keys are rows
// of W int32 lanes holding u32 ^ 0x80000000 (foundationdb_tpu_torch/keys.py),
// so a signed lexicographic compare over the lanes is the byte-string order
// of the keys, and the sentinel row is all 0x7FFFFFFF.
//
// Plain C interface, loaded with ctypes (foundationdb_tpu_torch/conflict/
// _build.py).  Every entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after its launch; the Python
// wrapper (conflict/kernels.py) raises on a non-zero code.  K1 and K3 take
// their launch geometry (threads, shared bytes, summary stride) from the
// wrapper's pure planners, kernels.plan_probe and kernels.plan_ranks.
//
// K1 fdb_probe_fused  replaces _probe_fused_kernel (pallas_kernel.py:189,
//    built by _build_probe_fused :292, wrapper run_conflicts_fused :322).
//    bool[R] = hist | (r_ok & some run k newer than the read's snapshot
//    intersects the read): with rank = #begins of run k < read end, the
//    read intersects run k iff rank > 0 and read begin < ends[rank - 1]
//    (the run's intervals are disjoint, so their ends are sorted too).
//    Bound: at the stream's shape (R = 16384 reads, K = 8 runs of 16384
//    rows, W = 5) bytes in principle — the sectors on the searches' paths,
//    ~2 MB of the ~6 MB of inputs — but a binary search is a chain of
//    dependent loads, so load latency in practice.
//    Design: parallel over (read, run) pairs.  A block takes a tile of
//    reads (128 while K <= 8; the TPU kernel's READ_BLOCK) and all K runs.
//    G = K rounded up to a power of two (at most 32) lanes of one warp
//    serve one read, lane g probing runs g, g + G, ...; one ballot ORs the
//    group's results and the group's first lane writes the read's output
//    once: no atomics, no second pass.  The block first stages into shared
//    memory its reads' begin and end rows and the summary, every S-th
//    begin of every run (K x ceil(run_cap / S) rows), with cp.async copies
//    that are all in flight at once.  A probe then finds the summary rank
//    c in shared memory (log2(run_cap / S) steps), counts inside the one
//    window [(c - 1) S + 1, min(c S, run_cap)) of the run in global memory
//    (log2 S dependent loads where a whole-run search takes log2 run_cap) and
//    loads ends[rank - 1].  S is the least power of two >= 512 whose
//    summary fits 40 KB: every block stages the whole summary, and on the
//    card 512 ran faster than the TPU kernel's SUMMARY_STRIDE of 128.  This is the TPU
//    kernel's two-level scan (_block_rank, pallas_kernel.py:130-151: a
//    count against every 128th begin, then a count inside one window)
//    reshaped for 132 SMs: one wave of blocks, 10 dependent global loads a
//    pair at the stream's shapes, all runs of a read at once.  A read whose
//    history bit is set, or whose r_ok is false, loads nothing of the
//    runs; a run not newer than the snapshot is skipped without a load.
//    Unlike K5, a read's lanes do not stop at its first conflict.
//    Wide keys (up to W = 4097 lanes, 16 KB keys; kernels.plan_probe): a
//    read's two rows take 8 W bytes of shared memory, so the plan halves
//    the reads a block stages until the block fits 227 KB (4 reads at W =
//    4097), and where no summary fits 40 KB even at a stride of 2^16 it
//    plans none (n_sum = 0): each read end is then ranked by a binary
//    search over the whole run in global memory, its compares loading four
//    lanes at a time and stopping at the first lane that differs.  A
//    block may then be a single partial warp (K = 1), so the group's
//    ballot takes the mask of the lanes the block has.
//
// K5 fdb_probe  replaces _probe_kernel (pallas_kernel.py:165, built by
//    _build_probe :213, wrapper run_conflicts_pallas :240, dispatched by
//    run_conflicts :271): K1 without the history input, i.e. bool[R] =
//    r_ok & (some run newer than the read's snapshot intersects it).  No
//    system path calls it; it is the unfused referee of K1 (the reference's
//    tests hold run_conflicts | hist against run_conflicts_fused).  It keeps
//    the thread-per-read design K1 had before its redesign: one thread per
//    read (256 per block) walks the runs newer than its snapshot in order,
//    a full binary search over each run's begins, until its first
//    conflict.  It shares only row_less and count_below with K1 (no
//    tiling, summary or window), so K5 | hist == K1 checks K1 against an
//    independent body, and K5's time is the same-card "before" of K1.
//    Bound: as K1's (bytes in principle, dependent-load latency in
//    practice), less the R bytes of the history bits it does not read.
//
// K2 fdb_intra_fixpoint  replaces _intra_kernel (pallas_kernel.py:353, built
//    by _build_intra :376, wrapper intra_query :395) together with the
//    lax.while_loop around it (foundationdb_tpu/conflict/device.py:394):
//    the whole intra-batch fixpoint of phase_intra in ONE cooperative
//    launch.  Per iteration, with intra the bits so far: a write of a txn
//    t that is active, not history-conflicted and not intra-conflicted
//    offers w_cand = w_tx; read r's minimum is the least offer of a write
//    that begins strictly inside its rank range (rb_r, re_r) (case 1) or
//    covers its begin rank, wb_r <= rb_r < we_r (case 2); txn t becomes
//    intra-conflicted iff one of its live reads' minimum is below t.  The
//    loop stops on the first iteration that changes no bit, or at
//    n_txn + 2 iterations, as the reference's does; the kernel writes the
//    bits and the count.
//    Bound: bytes — every input read once (at the stream's shapes R =
//    16384 reads and Wn = 8192 writes of 17-21 bytes, 8192 txns: ~0.45 MB,
//    a fraction of a microsecond); the operations are a few per element an
//    iteration.  What sets its time in practice is the three grid-wide
//    barriers an iteration (plus one before the first) and the atomics.
//    Design: a min is the same whatever structure computes it, so the
//    plain version's 17-level sparse table and 17-level down-sweep (each
//    level a barrier here) become two min segment trees over the ranks,
//    2 * 2^ceil(log2 n) ints each (512 KB at n = 49152, L2-resident).
//    Phase A, per committed write: atomicMin its offer into tree 1 at leaf
//    wb_r and up the ancestors, stopping at the first node that already
//    held a value <= the offer (whoever wrote that value carries it up
//    the same path); where wb_r < we_r, atomicMin into the canonical nodes
//    of [wb_r, we_r) in tree 2.  Phase B, per live read: tree 1's range
//    min over [rb_r + 1, re_r) and tree 2's min along leaf rb_r's path to
//    the root; a minimum below the read's txn sets that txn's hit flag (a
//    plain store of 1: the flags need no minimum, only whether one is
//    below t).  Phase C, per txn: the new bit is the hit flag; a change
//    sets this iteration's changed slot; the hit flags and both trees are
//    reset for the next iteration.  After the third barrier every block
//    reads the same slot and the same count and takes the same decision
//    (a block that left the loop alone would deadlock the grid).  The
//    slots alternate by iteration parity; the next one is cleared in
//    phase B, after every block has read it for the iteration before.
//    State that other blocks write inside the launch is read with
//    __ldcg (L2, never a stale L1 line).  Grid: the least of the blocks
//    the largest phase needs and what is resident at once
//    (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SMs), launched
//    with cudaLaunchCooperativeKernel, which refuses a grid that cannot
//    be resident (the wrapper then raises); the kernel is right for any
//    grid of at least one block.  grid.sync() needs no -rdc=true since
//    CUDA 11.
//
// fdb_intra_query: the per-iteration query that K2 ran before, kept as
//    the fixpoint's referee (intra_fixpoint_plain with query=intra_query:
//    the same loop on the host) and as its same-card "before".  One thread
//    per read: k = 31 - clz(len), two clamped lookups into the
//    min-sparse-table (empty rank range -> INT32_MAX) and one into the
//    stab array.  Bound: bytes — one random 4-byte gather per read (two
//    more when its rank range is not empty) and three coalesced 4-byte
//    streams; the loop has just built the table ([17, 49152] ints, 3.3
//    MB), so it is in L2.
//
// K3 fdb_compact_ranks  replaces _rank_count_kernel (pallas_kernel.py:474,
//    built by _build_rank_count :490, wrapper compact_ranks :509).
//    int32[n_rec]: per recent row, #main rows <= it, i.e. #rows < the row
//    with 1 added to its length lane (on the unsigned bits, so the
//    sentinel wraps as uint32 does and no signed overflow occurs).
//    Bound: bytes in principle (main is 10.5 MB at cap = 2^19, of which
//    the searches touch only the sectors on their paths), dependent-load
//    latency in practice: a thread-per-query search is 20 steps deep.
//    Design: narrow per block.  A block of 128 queries stages them in
//    shared memory (then adds the 1) and finds their lexicographic min and
//    max: the first and the last query when they are in key order, else
//    lane by lane, a block-wide min and max over the rows still tied on
//    the earlier lanes.  The whole block ranks the two in main at once with
//    a 129-ary search (each round every thread loads one pivot row per
//    query, four lanes a load when the leading lane ties, and
//    __syncthreads_count sums the compares: 3 rounds for 2^19 rows, not 20
//    dependent steps), giving lo = rank(min) and hi = rank(max).  Every query's rank lies in [lo, hi], sorted or not.  When
//    main[lo, hi) fits the block's shared memory (plan_ranks: 112 KB with
//    the queries, two blocks an SM) the block stages it (16-byte cp.async
//    copies, all in flight at once: a loop of plain loads would pay one
//    load latency per row it copies) and every query searches it there;
//    otherwise every query searches [lo, hi) in global memory.  On the main
//    path the queries are one run's step rows in key order, so a block
//    spans a few thousand main rows and takes the staged branch; a block
//    whose queries are all equal (the sentinel tail) does one search and
//    no other load of main.  Wide keys (kernels.plan_ranks): a block takes
//    128 queries while they fit shared memory with the least and the
//    greatest query, and halves that as W grows (8 at W = 4097, 16 KB a
//    row); the 128 threads still run the 129-ary search, and where the
//    queries leave no room for a span every query searches main in global
//    memory.

// K4 fdb_run_to_step  replaces _interleave_kernel (pallas_kernel.py:416,
//    built by _build_interleave :428, wrapper run_to_step_pallas :453), for
//    all K runs of a compaction in one launch (a compaction used to launch
//    it once a run: eight launches of ~2 us of copying, each behind a
//    ~35 us host call).  One thread per (run, row pair) in a grid-stride
//    loop: rows[k][2i] = begins[k][i], rows[k][2i+1] = ends[k][i], vals the
//    run's version on a live begin (0 on a sentinel begin and on every
//    end).  Bound: bytes, a pure copy (2 * K * run_cap * W * 4 B read, as
//    much again written, plus vals: ~11.5 MB for 8 runs of 16384 rows at
//    W = 5); neighbouring threads copy neighbouring rows, so both sides
//    coalesce.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr int kThreads = 256;  // intra_query, K4, K5
constexpr int kFixThreads = 512;  // K2's block
constexpr int kProbeMaxThreads = 1024;
constexpr int kRanksThreads = 128;  // K3's block: a compile-time divisor
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kSentLane = 0x7FFFFFFF;
constexpr int kI32Max = 0x7FFFFFFF;
constexpr int kI32Min = -kI32Max - 1;
constexpr int kSmemWithoutOptIn = 48 * 1024;

// a < b over W lanes
__device__ __forceinline__ bool row_less(const int* __restrict__ a,
                                         const int* __restrict__ b, int W) {
  for (int w = 0; w < W; ++w) {
    const int x = a[w];
    const int y = b[w];
    if (x != y) return x < y;
  }
  return false;
}

// a < b over W lanes, four lanes loaded before any is compared: in global
// memory a tie on the leading lanes (a sentinel query against main's
// sentinel tail ties on all but the last) then costs one load latency per
// four lanes, not one per lane.  (In shared memory the plain loop is
// faster.)
__device__ __forceinline__ bool row_less4(const int* __restrict__ a,
                                          const int* __restrict__ b, int W) {
  for (int w = 0; w < W; w += 4) {
    int x[4], y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[j] = w + j < W ? a[w + j] : 0;
      y[j] = w + j < W ? b[w + j] : 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (x[j] != y[j]) return x[j] < y[j];
    }
  }
  return false;
}

// Asynchronous copies into shared memory (cp.async): a thread issues all
// of its copies, then waits once, so a block's staging costs about one
// load latency where a loop of plain loads and stores would pay one per
// iteration.  16-byte copies need both addresses 16-byte aligned.
__device__ __forceinline__ void copy_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_async16(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stages the n ints at src into shared memory, 16 bytes a copy where it
// can: returns where src[0] landed, at most 3 ints past `buf` (which must
// be 16-byte aligned and hold n + 3 ints).  The caller waits and syncs.
__device__ __forceinline__ int* stage_async(int* buf, const int* src, int n) {
  const int shift = static_cast<int>((reinterpret_cast<size_t>(src) & 15) >> 2);
  int* dst = buf + shift;                  // dst and src agree mod 16 bytes
  const int head = min(n, (4 - shift) & 3);  // ints before src's next boundary
  const int n_vec = (n - head) >> 2;
  for (int t = threadIdx.x; t < head; t += blockDim.x) {
    copy_async4(dst + t, src + t);
  }
  for (int t = threadIdx.x; t < n_vec; t += blockDim.x) {
    copy_async16(dst + head + 4 * t, src + head + 4 * t);
  }
  for (int t = head + 4 * n_vec + threadIdx.x; t < n; t += blockDim.x) {
    copy_async4(dst + t, src + t);
  }
  return dst;
}

// #rows of the sorted [n, W] block lexicographically below q, the rows in
// global memory: each compare loads four lanes at a time
__device__ __forceinline__ int count_below4(const int* __restrict__ rows, int n,
                                            int W, const int* __restrict__ q) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (row_less4(rows + static_cast<size_t>(mid) * W, q, W)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// #rows of the sorted [n, W] block lexicographically below q
__device__ __forceinline__ int count_below(const int* __restrict__ rows, int n,
                                           int W, const int* __restrict__ q) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (row_less(rows + static_cast<size_t>(mid) * W, q, W)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// K1: a block is `threads >> group_log2` reads x all K runs; n_sum == 0:
// no summary, every read end ranked against the whole run
__global__ void __launch_bounds__(kProbeMaxThreads)
    probe_fused_kernel(const int* __restrict__ rb, const int* __restrict__ re,
                       const int* __restrict__ snap,
                       const bool* __restrict__ r_ok,
                       const bool* __restrict__ hist,
                       const int* __restrict__ runs_b,
                       const int* __restrict__ runs_e,
                       const int* __restrict__ runs_ver,
                       bool* __restrict__ out, int R, int K, int run_cap,
                       int W, int group_log2, int stride_log2, int n_sum) {
  extern __shared__ __align__(16) int smem[];
  const int G = 1 << group_log2;
  const int tile = static_cast<int>(blockDim.x) >> group_log2;
  const int r0 = blockIdx.x * tile;
  const int n_tile = min(tile, R - r0);
  const size_t run_rows = static_cast<size_t>(run_cap) * W;
  const int sum_elems = K * n_sum * W;
  int* summary = smem;                // [K][n_sum][W]: begins[k][j * S]
  int* q_b = summary + sum_elems;     // [tile][W]: the reads' begins
  int* q_e = q_b + tile * W;          // [tile][W]: the reads' ends
  for (int t = threadIdx.x; t < sum_elems; t += blockDim.x) {
    const int row = t / W;
    const int k = row / n_sum;
    const size_t j = static_cast<size_t>(row - k * n_sum) << stride_log2;
    copy_async4(summary + t, runs_b + k * run_rows + j * W + (t - row * W));
  }
  const int* src_b = rb + static_cast<size_t>(r0) * W;
  const int* src_e = re + static_cast<size_t>(r0) * W;
  for (int t = threadIdx.x; t < n_tile * W; t += blockDim.x) {
    copy_async4(q_b + t, src_b + t);
    copy_async4(q_e + t, src_e + t);
  }
  copy_async_wait();
  __syncthreads();

  const int local = threadIdx.x >> group_log2;
  const int g = threadIdx.x & (G - 1);
  const int i = r0 + local;
  const bool valid = local < n_tile;
  const bool h = valid && hist[i];
  bool conflict = false;
  if (valid && !h && r_ok[i]) {
    const int s = snap[i];
    const int* qb = q_b + local * W;
    const int* qe = q_e + local * W;
    for (int k = g; k < K && !conflict; k += G) {
      if (runs_ver[k] <= s) continue;
      const int* begins = runs_b + k * run_rows;
      if (n_sum == 0) {
        const int rank = count_below4(begins, run_cap, W, qe);
        conflict = rank > 0 &&
                   row_less4(qb, runs_e + k * run_rows +
                                     static_cast<size_t>(rank - 1) * W, W);
        continue;
      }
      const int c = count_below(summary + static_cast<size_t>(k) * n_sum * W,
                                n_sum, W, qe);
      if (c == 0) continue;  // begins[0] >= read end: rank 0
      // begins[(c - 1) S] < read end <= begins[c S] (or c S is past the run)
      const int lo = static_cast<int>((static_cast<long long>(c - 1) << stride_log2) + 1);
      const long long window_end = static_cast<long long>(c) << stride_log2;
      const int hi = window_end < run_cap ? static_cast<int>(window_end) : run_cap;
      const int rank = lo + count_below(begins + static_cast<size_t>(lo) * W,
                                        hi - lo, W, qe);
      conflict = row_less(qb, runs_e + k * run_rows +
                                  static_cast<size_t>(rank - 1) * W, W);
    }
  }
  // G divides 32, so a read's lanes share one warp; a block of fewer than
  // 32 threads is one partial warp
  const unsigned lanes = blockDim.x >= 32 ? kFull : (1u << blockDim.x) - 1u;
  const unsigned votes = __ballot_sync(lanes, conflict);
  if (valid && g == 0) {
    const int lane = threadIdx.x & 31;
    const unsigned mine =
        G == 32 ? votes : (votes >> lane) & ((1u << G) - 1u);
    out[i] = h || mine != 0;
  }
}

// K5: one thread per read, every run newer than its snapshot in order
__global__ void probe_kernel(const int* __restrict__ rb,
                             const int* __restrict__ re,
                             const int* __restrict__ snap,
                             const bool* __restrict__ r_ok,
                             const int* __restrict__ runs_b,
                             const int* __restrict__ runs_e,
                             const int* __restrict__ runs_ver,
                             bool* __restrict__ out, int R, int K, int run_cap,
                             int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  bool conflict = false;
  if (r_ok[i]) {
    const int* qb = rb + static_cast<size_t>(i) * W;
    const int* qe = re + static_cast<size_t>(i) * W;
    const int s = snap[i];
    const size_t run_rows = static_cast<size_t>(run_cap) * W;
    for (int k = 0; k < K && !conflict; ++k) {
      if (runs_ver[k] <= s) continue;
      const int rank = count_below(runs_b + k * run_rows, run_cap, W, qe);
      if (rank > 0) {
        conflict = row_less(qb, runs_e + k * run_rows +
                                    static_cast<size_t>(rank - 1) * W, W);
      }
    }
  }
  out[i] = conflict;
}

__global__ void intra_query_kernel(const int* __restrict__ tab,
                                   const int* __restrict__ stab,
                                   const int* __restrict__ rb_r,
                                   const int* __restrict__ re_r,
                                   int* __restrict__ out, int R, int L,
                                   int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const int rbr = rb_r[i];
  const int hi = re_r[i];
  const int lo = rbr + 1;
  const bool nonempty = hi > lo;
  const int len = max(hi - lo, 1);
  // len <= n <= 2**(L-1), so k < L; the clamp only guards memory
  const int k = min(31 - __clz(len), L - 1);
  const int pw = 1 << k;
  const int i1 = min(max(lo, 0), n - 1);
  const int i2 = min(max(hi - pw, 0), n - 1);
  const int* level = tab + static_cast<size_t>(k) * n;
  const int case1 = nonempty ? min(level[i1], level[i2]) : kI32Max;
  const int case2 = stab[min(max(rbr, 0), n - 1)];
  out[i] = min(case1, case2);
}

// row < q where x0 is the row's lane 0, loaded by the caller
__device__ __forceinline__ bool row_less_at(const int* __restrict__ row, int x0,
                                            const int* __restrict__ q, int W) {
  return x0 != q[0] ? x0 < q[0] : row_less4(row + 1, q + 1, W - 1);
}

// One round of a (P + 1)-ary search for #rows < q, rank in [lo, hi]: with
// more than P rows left thread i tests pivot lo + (i + 1) len / (P + 1),
// else row lo + i.
__device__ __forceinline__ int pivot_of(int lo, int hi, int i) {
  constexpr int P = kRanksThreads;
  const int len = hi - lo;
  return len > P ? lo + static_cast<int>(static_cast<long long>(i + 1) * len / (P + 1))
                 : lo + i;
}

// narrows [lo, hi] given m = #tested rows below q
__device__ __forceinline__ void narrow(int& lo, int& hi, int m) {
  constexpr int P = kRanksThreads;
  if (hi - lo <= P) {
    lo += m;
    hi = lo;
    return;
  }
  const int new_lo = m > 0 ? pivot_of(lo, hi, m - 1) + 1 : lo;
  const int new_hi = m < P ? pivot_of(lo, hi, m) : hi;
  lo = new_lo;
  hi = new_hi;
}

// #rows of the sorted [n, W] rows below qa and below qb (qb == qa when
// `same`), by the whole block: each round every thread loads lane 0 of
// one pivot row per query (both loads in flight together) and
// __syncthreads_count gives the counts: a 129-ary search, 3 rounds for 2^19
// rows.  blockDim.x == kRanksThreads.
__device__ void block_rank_pair(const int* __restrict__ rows, int n, int W,
                                const int* qa, const int* qb, bool same,
                                int* ra, int* rb) {
  const int i = threadIdx.x;
  int lo_a = 0, hi_a = n, lo_b = 0, hi_b = n;
  while (hi_a > lo_a || hi_b > lo_b) {  // block-uniform
    const int pa = pivot_of(lo_a, hi_a, i);
    const int pb = pivot_of(lo_b, hi_b, i);
    const bool ta = pa < hi_a;  // hi - lo <= P leaves threads without a row
    const bool tb = !same && pb < hi_b;
    const int* row_a = rows + static_cast<size_t>(pa) * W;
    const int* row_b = rows + static_cast<size_t>(pb) * W;
    const int xa = ta ? row_a[0] : 0;
    const int xb = tb ? row_b[0] : 0;
    const int ma = __syncthreads_count(ta && row_less_at(row_a, xa, qa, W));
    const int mb = __syncthreads_count(tb && row_less_at(row_b, xb, qb, W));
    narrow(lo_a, hi_a, ma);
    if (same) {
      lo_b = lo_a;
      hi_b = hi_a;
    } else {
      narrow(lo_b, hi_b, mb);
    }
  }
  *ra = lo_a;
  *rb = lo_b;
}

// The least and the greatest of the block's n >= 1 staged rows, written to
// least[0, W) and greatest[0, W): one lane at a time, a block-wide min and
// max over the rows still tied with the extreme on every earlier lane.
// Every thread of the block calls it; blockDim.x <= 1024.
__device__ void block_extremes(const int* qs, int n, int W, int* least,
                               int* greatest) {
  __shared__ int part[2][2][32];  // [lane parity][min, max][warp]
  const int tid = threadIdx.x;
  const int warps = (blockDim.x + 31) >> 5;
  bool at_min = tid < n;
  bool at_max = tid < n;
  for (int w = 0; w < W; ++w) {
    const int v = tid < n ? qs[static_cast<size_t>(tid) * W + w] : 0;
    // a warp with no row still tied contributes the identity
    const int lo = __reduce_min_sync(kFull, at_min ? v : kI32Max);
    const int hi = __reduce_max_sync(kFull, at_max ? v : kI32Min);
    if ((tid & 31) == 0) {
      part[w & 1][0][tid >> 5] = lo;
      part[w & 1][1][tid >> 5] = hi;
    }
    __syncthreads();
    int m = kI32Max;
    int M = kI32Min;
    for (int i = 0; i < warps; ++i) {
      m = min(m, part[w & 1][0][i]);
      M = max(M, part[w & 1][1][i]);
    }
    at_min = at_min && v == m;
    at_max = at_max && v == M;
    if (tid == 0) {
      least[w] = m;
      greatest[w] = M;
    }
  }
  __syncthreads();
}

// K3: a block is `queries` <= kRanksThreads recent rows
__global__ void __launch_bounds__(kRanksThreads)
    compact_ranks_narrowed_kernel(const int* __restrict__ ks,
                                  const int* __restrict__ rec,
                                  int* __restrict__ out, int cap, int n_rec,
                                  int W, int span_rows, int queries) {
  // [queries][W] queries (+ 4 ints), the least and the greatest query
  // (2 W ints, rounded up to 16 bytes), then [span_rows][W] main rows
  // (+ 3 ints): kernels.plan_ranks sizes it
  extern __shared__ __align__(16) int smem[];
  int* least = smem + static_cast<size_t>(queries) * W + 4;
  int* greatest = least + W;
  int* span_buf = least + ((2 * W + 3) & ~3);
  const int j0 = blockIdx.x * queries;
  const int n = min(queries, n_rec - j0);
  int* qs = stage_async(smem, rec + static_cast<size_t>(j0) * W, n * W);
  copy_async_wait();
  __syncthreads();
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    int* last = qs + static_cast<size_t>(r) * W + W - 1;
    *last = static_cast<int>(static_cast<unsigned>(*last) + 1u);
  }
  __syncthreads();
  // in key order (one run's step rows, as on the main path) the first and
  // the last query are the extremes; otherwise reduce
  const int tid = threadIdx.x;
  const bool in_order = tid + 1 >= n || !row_less(qs + static_cast<size_t>(tid + 1) * W,
                                                  qs + static_cast<size_t>(tid) * W, W);
  if (__syncthreads_and(in_order)) {
    least = qs;
    greatest = qs + static_cast<size_t>(n - 1) * W;
  } else {
    block_extremes(qs, n, W, least, greatest);
  }

  int lo, hi;  // every query's rank lies in [lo, hi]
  block_rank_pair(ks, cap, W, least, greatest, !row_less(least, greatest, W),
                  &lo, &hi);
  const int len = hi - lo;
  const int* rows = ks + static_cast<size_t>(lo) * W;
  const int* q = qs + static_cast<size_t>(tid) * W;
  if (len > 0 && len <= span_rows) {  // block-uniform
    const int* staged = stage_async(span_buf, rows, len * W);
    copy_async_wait();
    __syncthreads();
    if (tid < n) out[j0 + tid] = lo + count_below(staged, len, W, q);
  } else if (tid < n) {
    out[j0 + tid] = lo + count_below(rows, len, W, q);
  }
}

__device__ __forceinline__ int clamp_to(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ int clamp_idx(long long x, int hi) {
  return static_cast<int>(min(max(x, 0LL), static_cast<long long>(hi)));
}

// K2: the whole fixpoint; scratch = [2 * leaves] tree 1 (writer begins),
// [2 * leaves] tree 2 (writer spans), [B] intra bits, [B] hit flags, [2]
// changed slots, every int written by the kernel before it is read
__global__ void __launch_bounds__(kFixThreads)
    intra_fixpoint_kernel(const int* __restrict__ rb_r,
                          const int* __restrict__ re_r,
                          const int* __restrict__ wb_r,
                          const int* __restrict__ we_r,
                          const bool* __restrict__ r_ok,
                          const bool* __restrict__ w_ok,
                          const long long* __restrict__ r_idx,
                          const long long* __restrict__ w_idx,
                          const int* __restrict__ w_tx,
                          const bool* __restrict__ active,
                          const bool* __restrict__ hist,
                          bool* __restrict__ out, int* __restrict__ n_iters,
                          int* scratch, int R, int Wn, int B, int n,
                          int leaves) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  int* begins = scratch;
  int* covers = begins + 2 * static_cast<size_t>(leaves);
  int* intra = covers + 2 * static_cast<size_t>(leaves);
  int* hit = intra + B;
  int* changed = hit + B;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int last_rank = max(n - 1, 0);
  const int last_txn = max(B - 1, 0);
  for (int k = first; k < 2 * leaves; k += stride) {
    begins[k] = kI32Max;
    covers[k] = kI32Max;
  }
  for (int t = first; t < B; t += stride) {
    intra[t] = 0;
    hit[t] = 0;
    out[t] = false;
  }
  if (first == 0) changed[0] = 0;
  grid.sync();

  int it = 0;
  for (;;) {
    // A: every committed write offers its txn index to both trees
    for (int j = first; j < Wn; j += stride) {
      if (!w_ok[j]) continue;
      const int t = clamp_idx(w_idx[j], last_txn);
      if (!active[t] || hist[t] || __ldcg(intra + t)) continue;
      const int v = w_tx[j];
      const int wb = clamp_to(wb_r[j], 0, last_rank);
      const int we = clamp_to(we_r[j], 0, n);
      for (int node = leaves + wb; node >= 1; node >>= 1) {
        if (atomicMin(begins + node, v) <= v) break;
      }
      for (int lo = leaves + wb, hi = leaves + we; lo < hi; lo >>= 1, hi >>= 1) {
        if (lo & 1) atomicMin(covers + lo++, v);
        if (hi & 1) atomicMin(covers + --hi, v);
      }
    }
    grid.sync();

    // B: each live read's minimum, against its own txn
    if (first == 0) changed[(it + 1) & 1] = 0;
    for (int i = first; i < R; i += stride) {
      if (!r_ok[i]) continue;
      const int t = clamp_idx(r_idx[i], last_txn);
      const int rb = clamp_to(rb_r[i], 0, last_rank);
      int m = kI32Max;
      for (int lo = leaves + rb + 1, hi = leaves + clamp_to(re_r[i], 0, n); lo < hi;
           lo >>= 1, hi >>= 1) {
        if (lo & 1) m = min(m, __ldcg(begins + lo++));
        if (hi & 1) m = min(m, __ldcg(begins + --hi));
      }
#pragma unroll 4
      for (int node = leaves + rb; node >= 1; node >>= 1) {
        m = min(m, __ldcg(covers + node));
      }
      if (m < t) hit[t] = 1;
    }
    grid.sync();

    // C: the new bits; clear the flags and the trees for the next round
    for (int t = first; t < B; t += stride) {
      const int now = __ldcg(hit + t);
      if (now != __ldcg(intra + t)) {
        changed[it & 1] = 1;
        intra[t] = now;
        out[t] = now != 0;
      }
      hit[t] = 0;
    }
    for (int k = first; k < 2 * leaves; k += stride) {
      begins[k] = kI32Max;
      covers[k] = kI32Max;
    }
    grid.sync();
    ++it;
    if (!__ldcg(changed + ((it - 1) & 1)) || it >= B + 2) break;
  }
  if (first == 0) *n_iters = it;
}

// K4: one thread per (run, row pair); pair p = k * rcap + i writes rows
// 2p and 2p + 1 of the [K * 2 rcap, W] output
__global__ void run_to_step_kernel(const int* __restrict__ runs_b,
                                   const int* __restrict__ runs_e,
                                   const int* __restrict__ ver,
                                   int* __restrict__ rows,
                                   int* __restrict__ vals, int K, int rcap,
                                   int W) {
  const size_t pairs = static_cast<size_t>(K) * rcap;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t p = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < pairs; p += stride) {
    const int* b = runs_b + p * W;
    const int* e = runs_e + p * W;
    int* out = rows + 2 * p * W;
    for (int w = 0; w < W; ++w) {
      out[w] = b[w];
      out[W + w] = e[w];
    }
    vals[2 * p] = b[W - 1] != kSentLane ? ver[p / rcap] : 0;
    vals[2 * p + 1] = 0;
  }
}

inline unsigned blocks_for(size_t n, int threads = kThreads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

// lets `kernel` take `bytes` of dynamic shared memory; returns the error
// (cleared from the runtime's last-error slot) when it cannot
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes) {
  if (bytes <= kSmemWithoutOptIn) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace

extern "C" {

const char* fdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int fdb_probe_fused(const void* rb, const void* re, const void* snap,
                    const void* r_ok, const void* hist, const void* runs_b,
                    const void* runs_e, const void* runs_ver, void* out, int R,
                    int K, int run_cap, int W, int group_log2, int stride_log2,
                    int n_sum, int threads, int smem_bytes, void* stream) {
  const cudaError_t err = allow_smem(probe_fused_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_fused_kernel<<<blocks_for(R, threads >> group_log2), threads,
                       smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rb), static_cast<const int*>(re),
      static_cast<const int*>(snap), static_cast<const bool*>(r_ok),
      static_cast<const bool*>(hist), static_cast<const int*>(runs_b),
      static_cast<const int*>(runs_e), static_cast<const int*>(runs_ver),
      static_cast<bool*>(out), R, K, run_cap, W, group_log2, stride_log2,
      n_sum);
  return static_cast<int>(cudaGetLastError());
}

int fdb_probe(const void* rb, const void* re, const void* snap,
              const void* r_ok, const void* runs_b, const void* runs_e,
              const void* runs_ver, void* out, int R, int K, int run_cap, int W,
              void* stream) {
  probe_kernel<<<blocks_for(R), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rb), static_cast<const int*>(re),
      static_cast<const int*>(snap), static_cast<const bool*>(r_ok),
      static_cast<const int*>(runs_b), static_cast<const int*>(runs_e),
      static_cast<const int*>(runs_ver), static_cast<bool*>(out), R, K, run_cap,
      W);
  return static_cast<int>(cudaGetLastError());
}

int fdb_intra_query(const void* tab, const void* stab, const void* rb_r,
                    const void* re_r, void* out, int R, int L, int n,
                    void* stream) {
  intra_query_kernel<<<blocks_for(R), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tab), static_cast<const int*>(stab),
      static_cast<const int*>(rb_r), static_cast<const int*>(re_r),
      static_cast<int*>(out), R, L, n);
  return static_cast<int>(cudaGetLastError());
}

int fdb_compact_ranks(const void* ks, const void* rec, void* out, int cap,
                      int n_rec, int W, int span_rows, int smem_bytes,
                      int queries, void* stream) {
  const cudaError_t err = allow_smem(compact_ranks_narrowed_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_ranks_narrowed_kernel<<<blocks_for(n_rec, queries), kRanksThreads,
                                  smem_bytes,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ks), static_cast<const int*>(rec),
      static_cast<int*>(out), cap, n_rec, W, span_rows, queries);
  return static_cast<int>(cudaGetLastError());
}

int fdb_intra_fixpoint(const void* rb_r, const void* re_r, const void* wb_r,
                       const void* we_r, const void* r_ok, const void* w_ok,
                       const void* r_idx, const void* w_idx, const void* w_tx,
                       const void* active, const void* hist, void* out,
                       void* n_iters, void* scratch, int R, int Wn, int B,
                       int n, int leaves, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  int sms = 0;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, intra_fixpoint_kernel, kFixThreads, 0);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  // every block resident at once: no more than the card holds, and no
  // more than the largest phase has items for (fewer blocks, cheaper
  // barriers)
  const int work = std::max(std::max(R, Wn), std::max(B, 2 * leaves));
  const int grid =
      std::min(per_sm * sms, static_cast<int>(blocks_for(work, kFixThreads)));
  if (grid < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int* a_rb = static_cast<const int*>(rb_r);
  const int* a_re = static_cast<const int*>(re_r);
  const int* a_wb = static_cast<const int*>(wb_r);
  const int* a_we = static_cast<const int*>(we_r);
  const bool* a_rok = static_cast<const bool*>(r_ok);
  const bool* a_wok = static_cast<const bool*>(w_ok);
  const long long* a_ridx = static_cast<const long long*>(r_idx);
  const long long* a_widx = static_cast<const long long*>(w_idx);
  const int* a_wtx = static_cast<const int*>(w_tx);
  const bool* a_active = static_cast<const bool*>(active);
  const bool* a_hist = static_cast<const bool*>(hist);
  bool* a_out = static_cast<bool*>(out);
  int* a_iters = static_cast<int*>(n_iters);
  int* a_scratch = static_cast<int*>(scratch);
  void* args[] = {&a_rb,   &a_re,  &a_wb,    &a_we,      &a_rok,
                  &a_wok,  &a_ridx, &a_widx, &a_wtx,     &a_active,
                  &a_hist, &a_out, &a_iters, &a_scratch, &R,
                  &Wn,     &B,     &n,       &leaves};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(intra_fixpoint_kernel),
                                    dim3(grid), dim3(kFixThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

int fdb_run_to_step(const void* runs_b, const void* runs_e, const void* ver,
                    void* rows, void* vals, int K, int rcap, int W,
                    void* stream) {
  const size_t pairs = static_cast<size_t>(K) * rcap;
  run_to_step_kernel<<<std::min(blocks_for(pairs), 65535u), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(runs_b), static_cast<const int*>(runs_e),
      static_cast<const int*>(ver), static_cast<int*>(rows),
      static_cast<int*>(vals), K, rcap, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
