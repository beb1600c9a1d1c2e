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
//    summary fits 40 KB (plan_probe, which raises where none up to 2^16
//    does): every block stages the whole summary, and on the card 512 ran
//    faster than the TPU kernel's SUMMARY_STRIDE of 128.  This is the TPU
//    kernel's two-level scan (_block_rank, pallas_kernel.py:130-151: a
//    count against every 128th begin, then a count inside one window)
//    reshaped for 132 SMs: one wave of blocks, 10 dependent global loads a
//    pair at the stream's shapes, all runs of a read at once.  A read whose
//    history bit is set, or whose r_ok is false, loads nothing of the
//    runs; a run not newer than the snapshot is skipped without a load.
//    Unlike K5, a read's lanes do not stop at its first conflict.
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
// K2 fdb_intra_query  replaces _intra_kernel (pallas_kernel.py:353, built by
//    _build_intra :376, wrapper intra_query :395).  One thread per read:
//    k = 31 - clz(len), two clamped lookups into the min-sparse-table
//    (empty rank range -> INT32_MAX) and one into the stab array.
//    Bound: bytes — one random 4-byte gather per read (two more when its
//    rank range is not empty) and three coalesced 4-byte streams; the
//    fixpoint has just built the table ([17, 49152] ints, 3.3 MB), so it
//    is in L2.
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
//    no other load of main.

// K4 fdb_run_to_step  replaces _interleave_kernel (pallas_kernel.py:416,
//    built by _build_interleave :428, wrapper run_to_step_pallas :453).  One
//    thread per output lane: rows[2i] = begins[i], rows[2i+1] = ends[i];
//    the thread of lane 0 also writes vals (the run's version on a live
//    begin, 0 on a sentinel begin and on every end).  Bound: bytes, a pure
//    copy (2 * run_cap * W * 4 B read, as much again written, plus vals);
//    neighbouring threads touch neighbouring addresses, so both sides
//    coalesce.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;  // K2, K4, K5
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

// K1: a block is `threads >> group_log2` reads x all K runs
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
      const int c = count_below(summary + static_cast<size_t>(k) * n_sum * W,
                                n_sum, W, qe);
      if (c == 0) continue;  // begins[0] >= read end: rank 0
      // begins[(c - 1) S] < read end <= begins[c S] (or c S is past the run)
      const int lo = static_cast<int>((static_cast<long long>(c - 1) << stride_log2) + 1);
      const long long window_end = static_cast<long long>(c) << stride_log2;
      const int hi = window_end < run_cap ? static_cast<int>(window_end) : run_cap;
      const int* begins = runs_b + k * run_rows;
      const int rank = lo + count_below(begins + static_cast<size_t>(lo) * W,
                                        hi - lo, W, qe);
      conflict = row_less(qb, runs_e + k * run_rows +
                                  static_cast<size_t>(rank - 1) * W, W);
    }
  }
  // G divides 32, so a read's lanes share one warp
  const unsigned votes = __ballot_sync(kFull, conflict);
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

// K3: a block is kRanksThreads recent rows
__global__ void __launch_bounds__(kRanksThreads)
    compact_ranks_narrowed_kernel(const int* __restrict__ ks,
                                  const int* __restrict__ rec,
                                  int* __restrict__ out, int cap, int n_rec,
                                  int W, int span_rows) {
  // [blockDim.x][W] queries (+ 4 ints), the least and the greatest query
  // (2 W ints, rounded up to 16 bytes), then [span_rows][W] main rows
  // (+ 3 ints): kernels.plan_ranks sizes it
  extern __shared__ __align__(16) int smem[];
  int* least = smem + static_cast<size_t>(blockDim.x) * W + 4;
  int* greatest = least + W;
  int* span_buf = least + ((2 * W + 3) & ~3);
  const int j0 = blockIdx.x * blockDim.x;
  const int n = min(static_cast<int>(blockDim.x), n_rec - j0);
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

__global__ void run_to_step_kernel(const int* __restrict__ u_b,
                                   const int* __restrict__ u_e,
                                   const int* __restrict__ ver,
                                   int* __restrict__ rows,
                                   int* __restrict__ vals, int rcap, int W) {
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(2) * rcap * W;
  if (t >= total) return;
  const size_t r = t / W;
  const int w = static_cast<int>(t - r * W);
  const size_t i = r >> 1;
  const bool is_end = (r & 1) != 0;
  rows[t] = (is_end ? u_e : u_b)[i * W + w];
  if (w == 0) {
    vals[r] = (!is_end && u_b[i * W + W - 1] != kSentLane) ? ver[0] : 0;
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
                      void* stream) {
  const cudaError_t err = allow_smem(compact_ranks_narrowed_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_ranks_narrowed_kernel<<<blocks_for(n_rec, kRanksThreads),
                                  kRanksThreads, smem_bytes,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ks), static_cast<const int*>(rec),
      static_cast<int*>(out), cap, n_rec, W, span_rows);
  return static_cast<int>(cudaGetLastError());
}

int fdb_run_to_step(const void* u_b, const void* u_e, const void* ver,
                    void* rows, void* vals, int rcap, int W, void* stream) {
  run_to_step_kernel<<<blocks_for(static_cast<size_t>(2) * rcap * W), kThreads,
                       0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(u_b), static_cast<const int*>(u_e),
      static_cast<const int*>(ver), static_cast<int*>(rows),
      static_cast<int*>(vals), rcap, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
