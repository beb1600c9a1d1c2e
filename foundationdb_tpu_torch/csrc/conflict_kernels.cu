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
// wrapper (conflict/kernels.py) raises on a non-zero code.
//
// K1 fdb_probe_fused  replaces _probe_fused_kernel (pallas_kernel.py:189,
//    built by _build_probe_fused :292, wrapper run_conflicts_fused :322).
//    One thread per read.  For each run k newer than the read's snapshot,
//    a binary search over the run's sorted begins gives
//    rank = #begins < read end; the read intersects run k iff rank > 0 and
//    read begin < ends[rank - 1] (the run's intervals are disjoint, so their
//    ends are sorted too).  Because the begins are sorted, the binary search
//    gives exactly the rank of the TPU's two-level scan (a count against
//    every 128th begin, then a count inside one 128-wide window,
//    pallas_kernel.py:146-151).  Results OR across runs, then OR with the
//    caller's main-level history bit.
//    Bound: at the slice's shape (R = 16384 reads, K = 8 runs of 16384 rows,
//    W = 5) the inputs are ~6 MB, but a read searches only the runs newer
//    than its snapshot and touches only the sectors on its searches' paths,
//    mostly one lane a step; the compares are a few million integer
//    operations.  So bytes bound it in principle, but a binary search is a
//    chain of dependent loads: the real limit is load latency.  The design answers with occupancy (one light thread per read,
//    256 per block) and by leaving the 5.2 MB of runs to the 50 MB L2; runs
//    whose version is not above the snapshot are skipped without a load,
//    and a thread stops at its first conflicting run.
//
// K5 fdb_probe  replaces _probe_kernel (pallas_kernel.py:165, built by
//    _build_probe :213, wrapper run_conflicts_pallas :240, dispatched by
//    run_conflicts :271): K1 without the history input, i.e. bool[R] =
//    r_ok & (some run newer than the read's snapshot intersects it).  No
//    system path calls it; it is the unfused referee of K1 (the reference's
//    tests hold run_conflicts | hist against run_conflicts_fused).  It shares
//    K1's device code through the template parameter kFused of
//    probe_kernel: the two must compute the same probe, and one body keeps
//    the referee from drifting from what it referees, while K5 keeps its own
//    entry point, launch counter and this note.  Bound: as K1 (bytes in
//    principle, dependent-load latency in practice), less the R bytes of the
//    history bits it does not read; every read with r_ok set probes every
//    run newer than its snapshot up to its first conflict.
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
//    built by _build_rank_count :490, wrapper compact_ranks :509).  One
//    thread per recent row: add 1 to the row's length lane (on the unsigned
//    bits, so the sentinel wraps as uint32 does and no signed overflow
//    occurs), then binary-search the sorted main rows for #rows < that key,
//    i.e. #rows <= the recent row.  Bound: as K1 — bytes in principle
//    (main is 10.5 MB at cap = 2^19, of which the searches touch only the
//    sectors on their paths), dependent-load latency in practice
//    (20 steps per query); the upper levels of the search hit the same few
//    rows in every thread and stay in L1/L2.
//
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

constexpr int kThreads = 256;
constexpr int kSentLane = 0x7FFFFFFF;
constexpr int kI32Max = 0x7FFFFFFF;

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

// row < (q[0..W-2], q_last): the query's last lane is passed apart so the
// K3 upper-bound trick needs no copy of the query row
__device__ __forceinline__ bool row_less_q(const int* __restrict__ row,
                                           const int* __restrict__ q,
                                           int q_last, int W) {
  for (int w = 0; w < W - 1; ++w) {
    const int x = row[w];
    const int y = q[w];
    if (x != y) return x < y;
  }
  return row[W - 1] < q_last;
}

// #rows of the sorted [n, W] block lexicographically below the query
__device__ __forceinline__ int count_below(const int* __restrict__ rows, int n,
                                           int W, const int* __restrict__ q,
                                           int q_last) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (row_less_q(rows + static_cast<size_t>(mid) * W, q, q_last, W)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// K1 (kFused: the history bit ORed in) and K5 (no history input)
template <bool kFused>
__global__ void probe_kernel(const int* __restrict__ rb,
                             const int* __restrict__ re,
                             const int* __restrict__ snap,
                             const bool* __restrict__ r_ok,
                             const bool* __restrict__ hist,
                             const int* __restrict__ runs_b,
                             const int* __restrict__ runs_e,
                             const int* __restrict__ runs_ver,
                             bool* __restrict__ out, int R, int K, int run_cap,
                             int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  bool conflict = kFused ? hist[i] : false;
  if (!conflict && r_ok[i]) {
    const int* qb = rb + static_cast<size_t>(i) * W;
    const int* qe = re + static_cast<size_t>(i) * W;
    const int s = snap[i];
    const size_t run_rows = static_cast<size_t>(run_cap) * W;
    for (int k = 0; k < K && !conflict; ++k) {
      if (runs_ver[k] <= s) continue;
      const int* begins = runs_b + k * run_rows;
      const int rank = count_below(begins, run_cap, W, qe, qe[W - 1]);
      if (rank > 0) {
        const int* e_last = runs_e + k * run_rows +
                            static_cast<size_t>(rank - 1) * W;
        conflict = row_less(qb, e_last, W);
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

__global__ void compact_ranks_kernel(const int* __restrict__ ks,
                                     const int* __restrict__ rec,
                                     int* __restrict__ out, int cap, int n_rec,
                                     int W) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_rec) return;
  const int* q = rec + static_cast<size_t>(j) * W;
  const int q_last = static_cast<int>(static_cast<unsigned>(q[W - 1]) + 1u);
  out[j] = count_below(ks, cap, W, q, q_last);
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

inline unsigned blocks_for(size_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

const char* fdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int fdb_probe_fused(const void* rb, const void* re, const void* snap,
                    const void* r_ok, const void* hist, const void* runs_b,
                    const void* runs_e, const void* runs_ver, void* out, int R,
                    int K, int run_cap, int W, void* stream) {
  probe_kernel<true><<<blocks_for(R), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rb), static_cast<const int*>(re),
      static_cast<const int*>(snap), static_cast<const bool*>(r_ok),
      static_cast<const bool*>(hist), static_cast<const int*>(runs_b),
      static_cast<const int*>(runs_e), static_cast<const int*>(runs_ver),
      static_cast<bool*>(out), R, K, run_cap, W);
  return static_cast<int>(cudaGetLastError());
}

int fdb_probe(const void* rb, const void* re, const void* snap,
              const void* r_ok, const void* runs_b, const void* runs_e,
              const void* runs_ver, void* out, int R, int K, int run_cap, int W,
              void* stream) {
  probe_kernel<false><<<blocks_for(R), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rb), static_cast<const int*>(re),
      static_cast<const int*>(snap), static_cast<const bool*>(r_ok), nullptr,
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
                      int n_rec, int W, void* stream) {
  compact_ranks_kernel<<<blocks_for(n_rec), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ks), static_cast<const int*>(rec),
      static_cast<int*>(out), cap, n_rec, W);
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
