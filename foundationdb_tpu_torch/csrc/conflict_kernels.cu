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
// their plan and launch geometry (threads, shared bytes, summary stride)
// from the wrapper's pure planners, kernels.plan_probe and
// kernels.plan_ranks: the staged kernels below T = kernels.WARP_FROM_W
// lanes, the warp kernels from it; K5 from kernels.plan_probe_tree (staged
// levels, reads a tile, cluster size).
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
//    The stream's design above serves W below T = kernels.WARP_FROM_W = 257
//    lanes (keys under 1024 bytes; a read's two rows take 8 W bytes of
//    shared memory, so the plan halves the reads a block stages until the
//    block fits 227 KB).  From T on, and where no run summary fits (hundreds
//    of runs), K1 is probe_fused_warp_kernel, the design for wide keys:
//    Bound: bytes — the sectors of the searches' least reading
//    (chip_smoke.trace_search): each compare reads the mid row and the read
//    end from the lanes both bounds of its interval already share with the
//    end (every row between shares them, the rows being sorted) to the first
//    lane that differs; then the read begin and ends[rank - 1] to theirs.
//    Where the time went before (PR 12-13's plans, one thread a compare,
//    four lanes a load): a compare that ties on a long prefix (keys behind a
//    common prefix; a key against its key_after, which a widened set makes
//    differ only in the last lane; sentinel tails) is W / 4 dependent loads,
//    and a search repeats it at every step; blocks of 8-32 threads ran one
//    an SM.  The design: (1) a warp compares two rows, 128 lanes a step
//    (four coalesced 128-byte loads a row, all in flight, a ballot for the
//    first lane that differs); (2) each compare starts at the lanes both
//    bounds share with the key, rounded down to a 128-lane step
//    (warp_search), so a search of n rows reads about W + 128 log2 n lanes
//    where one from lane 0 reads W log2 n; (3) a warp per (read, run) pair,
//    not a warp a read: K times
//    the warps in flight, a block of 8 warps (one read at K = 8), the runs'
//    verdicts ORed in a shared flag with one store a read and no atomics;
//    a warp whose read is already in conflict stops; (4) the block's read
//    ends, which each of its warps re-reads at every step, staged once in
//    shared memory (cp.async, stage_async's 16-byte copies) where they fit
//    kernels.PROBE_STAGE_BYTES (96 KB: up to W ~ 24,500 at K = 8), else
//    read from L2 (W = 32769: a row is 128 KB, and one block an SM would
//    hold it).  A read with its history bit set or r_ok false loads
//    nothing, as below T.  Registers and occupancy:
//    chip_smoke.py phase 2 prints them (-Xptxas -v, and
//    cudaOccupancyMaxActiveBlocksPerMultiprocessor at each wide W).
//
// K5 fdb_probe  replaces _probe_kernel (pallas_kernel.py:165, built by
//    _build_probe :213, wrapper run_conflicts_pallas :240, dispatched by
//    run_conflicts :271): K1 without the history input, i.e. bool[R] =
//    r_ok & (some run newer than the read's snapshot intersects it).  No
//    system path calls it; it is the unfused referee of K1 (the reference's
//    tests hold run_conflicts | hist against run_conflicts_fused).
//    Independence: the point of K5 | hist == K1 is that two different
//    bodies agree, so K5 shares no search or staging code with K1 (not
//    K1's summary, window, read staging, warp search or ballot groups); it
//    shares only row_less, row_less4 and the cp.async instruction wrappers
//    (copy_async4, copy_async_wait), which decide nothing.
//    Bound: as K1's (bytes in principle, dependent-load latency in
//    practice), less the R bytes of the history bits it does not read.
//    The design before: a thread a read, 256 a block (64 blocks on 132 SMs
//    at R = 16384), walking its runs in order with a full binary search of
//    each (15 dependent global compares at run_cap = 16384, then ends[rank
//    - 1]: up to ~120 dependent loads a thread).  The design
//    (probe_tree_kernel): parallel over (read, run) pairs, as the TPU grid
//    is, its minor run axis made a thread-block cluster: a tile of reads
//    is one cluster of C blocks, block c searches runs c, c + C, ... for
//    every read of the tile, a thread a read, so a thread's chain is one
//    run's search (C = K up to 16 runs, the non-portable size above 8; more
//    runs are dealt out evenly, kernels.plan_probe_tree).  A block first
//    stages the top L levels of its run's implicit search tree (the rows a
//    binary search of the run compares first, breadth first: 2^L - 1 rows,
//    tree_row) in shared memory with cp.async copies all in flight at
//    once, unless no read of its tile probes that run; each search descends
//    those levels there, finishes the remaining ceil(log2(run_cap + 1)) - L
//    steps in global memory and loads ends[rank - 1] (at the stream's
//    shapes L = 7, 3 KB a block: up to 9 dependent global loads a pair,
//    where the design before made up to 16 a run).  Each node's run row is
//    computed once a block into shared memory, so a warp's copies take
//    consecutive lanes of 32 / W rows (a row's sectors once, where a thread
//    a row would issue W scattered copies); each compare in global memory
//    reads lane 0 of the run's row first against the read's lane 0 held in
//    a register, and 4 lanes a load only on a tie.  A warp's load of 32
//    scattered rows costs the L1 a pass per row, so a step that loads 4
//    lanes of both rows (row_less4) costs 8 passes where this one costs 1:
//    at this many searches the L1's gathers, not the loads' latency alone,
//    set the time.  The search is a plain lower bound, so sentinel rows tie
//    and a sentinel read end ranks at the live rows.  The verdicts are ORed
//    in the leader block's shared memory through distributed shared memory
//    (a store where a read conflicts) behind one cluster barrier, and the
//    leader writes `out` once: no atomics, no memset, one launch.  A pair
//    whose run is not newer than its snapshot, or whose r_ok is false,
//    loads nothing of the run.  L is the most levels, at most 7, whose
//    nodes fit kernels.PROBE_TREE_BYTES (4 KB), 0 from W = 1024 (then every
//    step is in global memory): every block stages its run's top rows, so
//    the bytes staged grow with 2^L while the compares saved grow with L.
//
// K2 fdb_intra_fixpoint  replaces _intra_kernel (pallas_kernel.py:353, built
//    by _build_intra :376, wrapper intra_query :395) together with the
//    lax.while_loop around it (foundationdb_tpu/conflict/device.py:394):
//    the whole intra-batch fixpoint of phase_intra in ONE launch.  Per
//    iteration, with intra the bits so far: a write of a txn t that is
//    active, not history-conflicted and not intra-conflicted offers w_cand
//    = w_tx; read r's minimum is the least offer of a write that begins
//    strictly inside its rank range (rb_r, re_r) (case 1) or covers its
//    begin rank, wb_r <= rb_r < we_r (case 2); txn t becomes
//    intra-conflicted iff one of its live reads' minimum is below t.  The
//    loop stops on the first iteration that changes no bit, or at n_txn + 2
//    iterations, as the reference's does; the kernel writes the bits and
//    the count.
//    Bound: bytes — every input read once (at the stream's shapes R =
//    16384 reads and Wn = 8192 writes of 17-21 bytes, 8192 txns: ~0.45 MB,
//    a fraction of a microsecond); the operations are a few per element an
//    iteration.  What sets its time in practice is latency: the barriers
//    between an iteration's phases and the round trips of its accesses.
//    Design: a min is the same whatever structure computes it, so the
//    plain version's 17-level sparse table and 17-level down-sweep become
//    two min segment trees over the ranks (tree 1: the writers' begins,
//    point offers and range queries; tree 2: the writers' spans, range
//    offers and point queries).  Two plans, chosen by shape
//    (kernels.plan_intra, a pure function of R, Wn and B):
//    The cluster plan (intra_cluster_kernel, the main path's): the whole
//    fixpoint held in the shared memory of ONE thread-block cluster of C
//    blocks of 1024 threads (cudaLaunchKernelEx with a cluster dimension; C
//    the least of 1, 2, 4, 8, 16 whose blocks hold the state, 8 at the
//    stream's shapes: 222 KB a block; 16 needs the non-portable cluster
//    size; the wrapper checks cudaOccupancyMaxActiveClusters once a plan).
//    Block c holds ranks [c S, (c + 1) S), S = ceil(n / C), as its own
//    trees (bottom-up segment trees of S leaves; nothing above the C roots
//    is stored: a range spanning blocks takes the roots between its end
//    blocks one by one); a read or write is staged in the block that holds
//    its begin rank, so its tree accesses are shared-memory ones (with
//    room for an eighth more than a block's share; past that, in the next
//    block with room, its accesses then distributed shared memory), and
//    every block holds every txn's state and hit bytes.  The barriers are
//    the cluster's (a hardware barrier, no cooperative launch; a one-block
//    cluster's is __syncthreads), two an iteration: tree 2 and the hit
//    bytes are double-buffered by iteration parity, so one is cleared
//    while the other is used, and a hit is sent to every block, so every
//    block decides the stop rule alone and alike.  Phase A offers (tree 1
//    walked up with early exit, and kept only where some read's rank range
//    is not empty; tree 2's nodes over the span, a point write's its leaf,
//    its height kept in node 0 so that a point query and the clearing stop
//    there); phase B queries.  Values are int32: Hopper has no 16-bit
//    atomic min, and the offers are atomic.  The staging reads the inputs
//    in one round and sends each item in one 16-byte store; device memory
//    is read there and written only for the bits and the count.
//    The grid plan (intra_fixpoint_kernel, the design before the cluster
//    plan), for the shapes whose state no 16-block cluster holds (from
//    15,097 txns of the stream's mix; the proxy's cap of 32,768): the
//    trees, 2 * 2^ceil(log2 n) ints
//    each, in device memory (L2-resident), one cooperative launch of the
//    resident blocks, three grid barriers an iteration.  Phase A, per
//    committed write: atomicMin its offer into tree 1 at leaf wb_r and up
//    the ancestors, stopping at the first node that already held a value
//    <= the offer; where wb_r < we_r, atomicMin into the canonical nodes of
//    [wb_r, we_r) in tree 2.  Phase B, per live read: tree 1's range min
//    over [rb_r + 1, re_r) and tree 2's min along leaf rb_r's path to the
//    root; a minimum below the read's txn sets that txn's hit flag.  Phase
//    C, per txn: the new bit is the hit flag; a change sets this
//    iteration's changed slot; the hit flags and both trees are reset.
//    After the third barrier every block reads the same slot and count and
//    takes the same decision (a block that left the loop alone would
//    deadlock the grid).  The slots alternate by iteration parity; the next
//    one is cleared in phase B, after every block has read it for the
//    iteration before.  State that other blocks write inside the launch is
//    read with __ldcg (L2, never a stale L1 line).  Grid: the least of the
//    blocks the largest phase needs and what is resident at once
//    (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SMs), launched
//    with cudaLaunchCooperativeKernel, which refuses a grid that cannot be
//    resident (the wrapper then raises).
//
// fdb_intra_query: the per-iteration query that K2 ran before, kept as
//    the fixpoint's referee (intra_fixpoint_plain with query=intra_query:
//    the host loop) and as its same-card "before".  A thread a read, 256 a
//    block: k = 31 - clz(len), two clamped lookups into the min-sparse-table (empty rank
//    range -> INT32_MAX) and one into the stab array.  Bound: bytes — one
//    random 4-byte gather per read (two more when its rank range is not
//    empty) and three coalesced 4-byte streams; the loop has just built
//    the table ([17, 49152] ints, 3.3 MB), so it is in L2.  The bound
//    (0.116 us at R = 16384) is below one launch: what the event pair
//    around it holds past its floor is the launch and two dependent L2
//    round trips.  A redesign to fill the card (blocks of 32-128 threads,
//    or 2-4 reads a thread, every gather issued before any min) ran
//    slower on the card than this kernel, at its own grid too, so this
//    one stays (PERF.md section 6).
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
//    no other load of main.  This design serves W below T =
//    kernels.WARP_FROM_W = 257 lanes (the queries take 4 W bytes each of
//    shared memory).  From T on, K3 is compact_ranks_warp_kernel, the
//    design for wide keys.  Bound: bytes — the sectors of each query's
//    least reading (chip_smoke.trace_search, as K1's).  Before (PR 12-13),
//    one thread a compare, four lanes a load, every compare from lane 0;
//    and a step function's rows tie on long prefixes (a key and its
//    key_after differ only in the last lane; sentinel rows, their last
//    lane + 1, in all but the last).  The design: a warp a query, the warp
//    compare and prefix-skipping search of K1's warp plan (warp_search with
//    the query's last lane + 1 inside the compare: the query is never
//    written), and PR 3's narrowing of a block of consecutive queries
//    (kernels.RANKS_WARP_QUERIES, 8 warps) where the block's first and last
//    query share more than one 128-lane step (a long common prefix, or the
//    sentinel tail): those two are ranked in all of main, and every query
//    between them searches only between their ranks, starting past the
//    lanes it shares with both (the lcp identities in
//    compact_ranks_warp_kernel's comment), so the shared prefix is read
//    once a block, not once a step; a block of equal queries searches
//    once.  A block of distinct short keys has no prefix to save: its
//    queries search at once, none waiting on another.  A query outside its
//    block's first and last (not in key order: not on the main path)
//    searches all of main, so any input is ranked right.

// K4 fdb_run_to_step  replaces _interleave_kernel (pallas_kernel.py:416,
//    built by _build_interleave :428, wrapper run_to_step_pallas :453), for
//    all K runs of a compaction in one launch.  rows[k][2i] = begins[k][i],
//    rows[k][2i+1] = ends[k][i], vals the run's version on a live begin (0
//    on a sentinel begin and on every end): the rows are
//    torch.stack((begins, ends), dim=2), a pure copy.
//    Bound: HBM bytes, each input read once and each output written once:
//    2 K run_cap W 4 B in, as much again out, plus vals (11.5 MB for 8 runs
//    of 16384 rows at W = 5, 3.4 us at 3.35 TB/s; 17.2 GB for 8 runs of
//    4096 rows at W = 32769, 5.1 ms).  Nothing is computed, so the copy
//    runs at the rate the memory system sustains, or slower where too few
//    bytes are in flight or each access wastes most of its sectors.
//    Design: a thread an output element, not a row.  Element o of run k
//    (grid.y) is lane o - r W of step row r = o / W (a multiply-shift with
//    the wrapper's constants, kernels.plan_run_to_step: no divide), which
//    is element o - ceil(r / 2) W of begins (r even) or ends (r odd).  A
//    warp's 32 consecutive o store 128 contiguous bytes and load at most
//    one contiguous span of begins and one of ends (consecutive step rows
//    alternate between them, consecutive rows of each), so both sides
//    coalesce at every width, where one thread a row pair (the design this
//    one replaced) put neighbouring threads 4W bytes apart: each warp
//    access touched 32 sectors for 4 bytes of each, and at the default
//    set's shapes 128 blocks walked 16-128 KB rows lane by lane.  Each
//    thread takes kStepPer = 8 elements a block's width apart, and issues
//    all their loads before any store, so every SM keeps several KB of
//    loads in flight; blocks of 256 cover each run (a 2048-element tile a
//    block: 640 blocks at W = 5, 1 M at W = 32769).  The thread that copies
//    lane W - 1 of a row writes its vals entry, reading the run's version
//    on the device.  The index o is 32-bit: a run of 2^31 step elements or
//    more (2 slots of 16384 rows at W = 65537) is cut into row-aligned
//    chunks of fewer (grid.z), each from a 64-bit base; 8 runs at W = 32769
//    hold 2^31 + 65536 step elements, one chunk each.  On an
//    NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, cold L2) it takes
//    1.10-1.33x the bound from W = 65 and beats torch.stack of the same
//    rows at every width; at W = 5 the launch and tail (~10 us) dominate.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr int kThreads = 256;  // intra_query, K4
constexpr int kTreeMaxReads = 1024;  // K5's block: reads of a tile, at most
constexpr int kTreeMaxLevels = 16;   // K5's staged levels, at most
constexpr int kSmemMax = 227 * 1024;    // dynamic shared memory a block may take
// K4's elements a thread (kernels.STEP_PER).  From the card sweep (NVIDIA
// H100 80GB HBM3 at 700 W): 4 and 8 within 1% of each other from W = 17 to
// 32769, 16 4-8% slower at W = 17 and 33, 2 4-11% slower
constexpr int kStepPer = 8;
constexpr int kFixThreads = 512;  // K2's block, the grid plan
constexpr int kClusterThreads = 1024;  // K2's block, the cluster plan: 32 warps
constexpr int kMaxCluster = 16;  // blocks of a cluster on the H100 (non-portable above 8)
constexpr int kProbeMaxThreads = 1024;
constexpr int kRanksThreads = 128;  // K3's block: a compile-time divisor
constexpr int kRanksWarps = 8;  // K3's warp-plan block
constexpr int kWarpProbeMaxReads = 32;  // K1's warp-plan block: reads, at most
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

// The two halves of a cluster barrier, so that a block can work between
// its arrival and its wait (every thread calls both, C > 1 only)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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

// K1 below kernels.WARP_FROM_W: a block is `threads >> group_log2` reads x
// all K runs
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

// K5's staged tree: node e (1-based, breadth first: node e's children
// are 2 e and 2 e + 1) is the row that a binary search of [0, n) for #rows
// < q compares at depth floor(log2 e) when its earlier compares went as
// e's bits below the leading one say, highest first (1: the row was below
// q); -1 where the search cannot reach that depth on that path (its
// interval is empty: n is not 2^d - 1).
__device__ __forceinline__ int tree_row(int e, int n) {
  int lo = 0, hi = n;
  for (int d = 30 - __clz(e); d >= 0; --d) {
    if (lo >= hi) return -1;
    const int mid = lo + ((hi - lo) >> 1);
    if ((e >> d) & 1) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < hi ? lo + ((hi - lo) >> 1) : -1;
}

// K5: grid (C, tiles) in clusters of C blocks (C = gridDim.x), a tile of
// blockDim.x reads a cluster, a thread a read.  Block c takes runs c, c +
// C, ...: for each, unless no read of the tile probes it, it first stages
// the top `levels` levels of the run's search tree (node e at the run row
// tree_row(e, run_cap), computed once a block) with cp.async copies, all
// in flight at once, a warp copying consecutive lanes of 32 / W rows a
// pass; then each read with r_ok set and a snapshot below the run's
// version descends the staged levels in shared memory, finishes its
// search in global memory and compares its begin with ends[rank - 1],
// each compare reading lane 0 of the run's row first (the read's lanes 0
// are held in registers).  The verdicts meet in the leader block's shared
// memory (a store of 1 through distributed shared memory where a read
// conflicts, after the leader has cleared them) and the leader writes
// `out` once.  Only the leader's shared memory is addressed by other
// blocks, and it leaves last.
__global__ void __launch_bounds__(kTreeMaxReads)
    probe_tree_kernel(const int* __restrict__ rb, const int* __restrict__ re,
                      const int* __restrict__ snap, const bool* __restrict__ r_ok,
                      const int* __restrict__ runs_b, const int* __restrict__ runs_e,
                      const int* __restrict__ runs_ver, bool* __restrict__ out,
                      int R, int K, int run_cap, int W, int levels) {
  // [2^levels - 1] the run row of each node, then [2^levels - 1][W] the
  // staged rows, node e at place e - 1
  extern __shared__ __align__(16) int tree_smem[];
  __shared__ unsigned char hit[kTreeMaxReads];  // the leader's: the tile's verdicts
  namespace cg = cooperative_groups;
  auto cluster = cg::this_cluster();
  const int C = static_cast<int>(gridDim.x);
  const int me = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int i = blockIdx.y * blockDim.x + tid;
  const bool valid = i < R;
  const int nodes = (1 << levels) - 1;
  int* pos = tree_smem;
  int* tree = tree_smem + nodes;
  if (C > 1) {
    if (me == 0) hit[tid] = 0;
    cluster_arrive();  // the leader's verdicts are cleared
  }
  for (int e = 1 + tid; e <= nodes; e += blockDim.x) pos[e - 1] = tree_row(e, run_cap);
  // a staging pass: a warp copies g rows, lane l lane l % W of row l / W
  // (W <= 32), or lanes l, l + 32, ... of one row
  const int lane = tid & 31;
  const int g = W <= 32 ? 32 / W : 1;
  const int sub = W <= 32 ? lane / W : 0;
  const int lane_w = lane - sub * (W <= 32 ? W : 0);
  const int step_w = W <= 32 ? W : 32;
  const int pass = (static_cast<int>(blockDim.x) >> 5) * g;
  const bool live = valid && r_ok[i];
  const int s = live ? snap[i] : 0;
  const size_t row_i = static_cast<size_t>(valid ? i : 0) * W;
  const int* q = re + row_i;
  const int q0 = live ? q[0] : 0;
  const int b0 = live ? rb[row_i] : 0;
  const size_t run_rows = static_cast<size_t>(run_cap) * W;
  bool conflict = false;
  for (int k = me; k < K; k += C) {
    const bool need = live && !conflict && runs_ver[k] > s;
    const int* begins = runs_b + k * run_rows;
    if (levels) {
      // block-uniform; also the barrier between the node rows' writes (or
      // the last run's searches of the tree) and this run's staging
      if (!__syncthreads_or(need)) continue;
      if (sub < g) {
        for (int r = (tid >> 5) * g + sub; r < nodes; r += pass) {
          const int row = pos[r];
          if (row < 0) continue;
          const int* src = begins + static_cast<size_t>(row) * W;
          int* dst = tree + static_cast<size_t>(r) * W;
          for (int w = lane_w; w < W; w += step_w) copy_async4(dst + w, src + w);
        }
      }
      copy_async_wait();
      __syncthreads();
    }
    if (!need) continue;
    int lo = 0, hi = run_cap;
    for (int d = 0, e = 1; d < levels && lo < hi; ++d) {
      const int* x = tree + static_cast<size_t>(e - 1) * W;
      const bool below = x[0] != q0 ? x[0] < q0 : row_less(x + 1, q + 1, W - 1);
      const int mid = lo + ((hi - lo) >> 1);
      lo = below ? mid + 1 : lo;
      hi = below ? hi : mid;
      e = 2 * e + below;
    }
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      const int* x = begins + static_cast<size_t>(mid) * W;
      const int x0 = x[0];
      if (x0 != q0 ? x0 < q0 : row_less4(x + 1, q + 1, W - 1)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo > 0) {
      const int* e_last = runs_e + k * run_rows + static_cast<size_t>(lo - 1) * W;
      const int y0 = e_last[0];
      conflict = b0 != y0 ? b0 < y0 : row_less4(rb + row_i + 1, e_last + 1, W - 1);
    }
  }
  if (C == 1) {
    if (valid) out[i] = conflict;
    return;
  }
  __syncwarp();
  cluster_wait();  // every block runs, and the leader's verdicts are cleared
  if (conflict) *cluster.map_shared_rank(hit + tid, 0) = 1;
  cluster.sync();  // every verdict has arrived
  if (me == 0 && valid) out[i] = hit[tid] != 0;
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

// The first lane at which rows a and b differ as the compare sees them
// (with `inc_a` / `inc_b`, that row's last lane counts 1 more, on the
// unsigned bits, wrapping as uint32 does: neither row is written), W when
// none does; *less: a < b.  The caller guarantees that the two agree on
// lanes [0, from), so the walk starts at `from` rounded down to a 128-lane
// step.  By one whole warp: each step loads 128 lanes of both rows (four
// coalesced 128-byte loads a row, all in flight) and a ballot finds the
// first lane that differs.  (Wider steps, or prefetching the next steps
// to L2, cost registers and so blocks an SM: both ran slower on the card.)
// Every lane of the warp returns the same.
__device__ __forceinline__ int warp_first_diff(const int* __restrict__ a, bool inc_a,
                                               const int* __restrict__ b, bool inc_b,
                                               int W, int from, bool* less) {
  const int l = threadIdx.x & 31;
  for (int w0 = from & ~127; w0 < W; w0 += 128) {
    int x[4], y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = w0 + 32 * j + l;
      x[j] = w < W ? a[w] : 0;
      y[j] = w < W ? b[w] : 0;
      if (w == W - 1) {
        if (inc_a) x[j] = static_cast<int>(static_cast<unsigned>(x[j]) + 1u);
        if (inc_b) y[j] = static_cast<int>(static_cast<unsigned>(y[j]) + 1u);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned diff = __ballot_sync(kFull, x[j] != y[j]);
      if (diff) {
        const int src = __ffs(diff) - 1;
        *less = __shfl_sync(kFull, x[j], src) < __shfl_sync(kFull, y[j], src);
        return w0 + 32 * j + src;
      }
    }
  }
  *less = false;
  return W;
}

// #rows of the sorted rows[lo, hi) below q (its last lane + 1 with
// `inc_q`), the rank known to lie in [lo, hi], by one whole warp.  *l_lo
// is how many leading lanes rows[lo - 1] shares with q as the compare
// sees it, *l_hi the same of rows[hi] (0 where unknown or where the row
// does not exist).  The rows are sorted, so every row between shares the
// lesser of the two with q: each compare starts there, and the side that
// moves takes the mid row's share.  Returns the rank, with *l_lo and *l_hi
// the shares of the final bounds.
__device__ __forceinline__ int warp_search(const int* __restrict__ rows, int lo,
                                           int hi, int W, const int* __restrict__ q,
                                           bool inc_q, int* l_lo, int* l_hi) {
  int a = *l_lo;
  int b = *l_hi;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    bool less;
    const int f = warp_first_diff(rows + static_cast<size_t>(mid) * W, false, q,
                                  inc_q, W, min(a, b), &less);
    if (less) {
      lo = mid + 1;
      a = f;
    } else {
      hi = mid;
      b = f;
    }
  }
  *l_lo = a;
  *l_hi = b;
  return lo;
}

// K1 from W = kernels.WARP_FROM_W: a warp per (read, run) pair.  A block
// is `reads` reads x G = 2^group_log2 warps (warp g of a read takes runs g,
// g + G, ...); with `stage`, the block's read ends are staged in shared
// memory first ([reads][(W + 6) & ~3] ints, 16-byte copies where they
// can).  The runs' results meet in a shared flag a read: one store a read.
__global__ void __launch_bounds__(kProbeMaxThreads)
    probe_fused_warp_kernel(const int* __restrict__ rb, const int* __restrict__ re,
                            const int* __restrict__ snap,
                            const bool* __restrict__ r_ok,
                            const bool* __restrict__ hist,
                            const int* __restrict__ runs_b,
                            const int* __restrict__ runs_e,
                            const int* __restrict__ runs_ver,
                            bool* __restrict__ out, int R, int K, int run_cap,
                            int W, int group_log2, int stage) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int hit[kWarpProbeMaxReads];
  const int warp = threadIdx.x >> 5;
  const int reads = static_cast<int>(blockDim.x >> 5) >> group_log2;
  const int r0 = blockIdx.x * reads;
  const int n_reads = min(reads, R - r0);
  const int local = warp >> group_log2;
  const int i = r0 + local;
  const bool valid = local < n_reads;
  const int* qe = re + static_cast<size_t>(valid ? i : r0) * W;
  if (stage) {
    const int stride = (W + 6) & ~3;  // W and stage_async's shift, 16-byte rows
    for (int r = 0; r < n_reads; ++r) {
      int* row = stage_async(smem + static_cast<size_t>(r) * stride,
                             re + static_cast<size_t>(r0 + r) * W, W);
      if (r == local) qe = row;
    }
    copy_async_wait();
  }
  if (threadIdx.x < reads) hit[threadIdx.x] = 0;
  __syncthreads();

  if (valid && !hist[i] && r_ok[i]) {  // warp-uniform
    const int s = snap[i];
    const int* qb = rb + static_cast<size_t>(i) * W;
    const size_t run_rows = static_cast<size_t>(run_cap) * W;
    volatile int* mine = hit + local;
    for (int k = warp & ((1 << group_log2) - 1); k < K; k += 1 << group_log2) {
      if (runs_ver[k] <= s) continue;
      if (__any_sync(kFull, *mine != 0)) break;  // another warp found one
      int l_lo = 0, l_hi = 0;
      const int rank = warp_search(runs_b + k * run_rows, 0, run_cap, W, qe,
                                   false, &l_lo, &l_hi);
      if (rank == 0) continue;
      bool less;
      warp_first_diff(qb, false,
                      runs_e + k * run_rows + static_cast<size_t>(rank - 1) * W,
                      false, W, 0, &less);
      if (less) {
        if ((threadIdx.x & 31) == 0) *mine = 1;
        break;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < n_reads) {
    out[r0 + threadIdx.x] = hist[r0 + threadIdx.x] || hit[threadIdx.x] != 0;
  }
}

// K3 from W = kernels.WARP_FROM_W: a block is kRanksWarps warps and
// `queries` consecutive recent rows, a warp a query.  Warp 1 first walks
// the last query against the first: P, the lanes they share.  Where they
// differ within the first 128-lane step (distinct keys, as in a step
// function of short keys), narrowing would save only the top steps of
// each search and chain two searches, so every query searches all of
// main at once.  Else (a long shared prefix, or equal queries: the
// sentinel tail) warp 0 ranks the first query in all of main and warp 1
// the last unless it equals the first (so a block of equal queries
// searches once), and every other query is walked against the first and,
// from min(that share, P) (lcp(x, z) >= min(lcp(x, y), lcp(y, z)) for any
// rows), against the last: where it lies between them (in key order, one
// run's step rows, as on the main path) its rank lies between theirs, and
// the sorted-lcp identity (lcp(a, c) = min(lcp(a, b), lcp(b, c)) for
// a <= b <= c) gives the lanes it shares with both bounds, so its search
// starts past them.  A query outside them searches all of main.  Every
// compare sees a query with its last lane + 1.
__global__ void __launch_bounds__(32 * kRanksWarps)
    compact_ranks_warp_kernel(const int* __restrict__ ks,
                              const int* __restrict__ rec,
                              int* __restrict__ out, int cap, int n_rec, int W,
                              int queries) {
  // P; lo and the lanes rows[lo - 1] shares with the first query; hi (-1:
  // the last query equals the first) and the lanes rows[hi] shares with
  // the last
  __shared__ int bounds[5];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * queries;
  const int n = min(queries, n_rec - j0);
  const int* first = rec + static_cast<size_t>(j0) * W;
  const int* last = first + static_cast<size_t>(n - 1) * W;
  if (warp == 1) {
    bool less;
    const int shared = warp_first_diff(first, true, last, true, W, 0, &less);
    if (lane == 0) bounds[0] = shared;
  }
  __syncthreads();
  const int P = bounds[0];
  if (P < 128) {  // block-uniform
    for (int j = warp; j < n; j += kRanksWarps) {
      int a = 0, b = 0;
      const int rank = warp_search(ks, 0, cap, W, first + static_cast<size_t>(j) * W,
                                   true, &a, &b);
      if (lane == 0) out[j0 + j] = rank;
    }
    return;
  }
  if (warp < 2 && (warp == 0 || P < W)) {
    int a = 0, b = 0;
    const int rank = warp_search(ks, 0, cap, W, warp ? last : first, true, &a, &b);
    if (lane == 0) {
      bounds[1 + 2 * warp] = rank;
      bounds[2 + 2 * warp] = warp ? b : a;
      if (warp == 0) out[j0] = rank;
    }
  } else if (warp == 1 && lane == 0) {
    bounds[3] = -1;  // the last query equals the first: rank lo
    bounds[4] = 0;
  }
  __syncthreads();
  const int lo = bounds[1];
  const int hi = bounds[3] < 0 ? lo : bounds[3];
  for (int j = warp; j < n; j += kRanksWarps) {
    if (j == 0) continue;
    const int* q = first + static_cast<size_t>(j) * W;
    int rank = hi;
    if (j < n - 1) {
      bool after, before;  // first < q, q < last
      const int f1 = warp_first_diff(first, true, q, true, W, 0, &after);
      const int f2 = warp_first_diff(q, true, last, true, W, min(f1, P), &before);
      int a = 0, b = 0, from = 0, to = cap;
      if ((f1 == W || after) && (f2 == W || before)) {
        a = min(bounds[2], f1);
        b = min(f2, bounds[4]);
        from = lo;
        to = hi;
      }
      rank = warp_search(ks, from, to, W, q, true, &a, &b);
    }
    if (lane == 0) out[j0 + j] = rank;
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

// K2's cluster plan: the layout of one block's shared memory, in the order
// below, each part 16-byte aligned (kernels.intra_cluster_bytes is the same
// sum): tree 1 and two trees 2 (one an iteration parity), 2 S ints each
// (node 1 the root of the block's slice of S ranks, its leaves at S .. 2 S
// - 1, node 0 tree 2's height), each in a room of intra_tree_ints (staging
// parks its records there first); room for `intra_room` reads and writes,
// an int4 record each; a header of 8 ints (the two claim counts of reads
// and writes, the range flag), the staging's counts and bases by block (4
// kMaxCluster ints), every txn's state byte (B: active and not
// history-conflicted) and every txn's hit byte of two iterations (2 B,
// one an iteration parity).
__host__ __device__ __forceinline__ size_t round4(size_t ints) {
  return (ints + 3) & ~static_cast<size_t>(3);
}

__host__ __device__ __forceinline__ size_t round16(size_t bytes) {
  return (bytes + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// a block's room for `items` spread over C blocks: its share, and an
// eighth more where there are other blocks, so that begins spread
// unevenly (a few percent above the share at the stream's shapes) still
// land in the block that holds them
__host__ __device__ __forceinline__ int intra_room(int items, int C) {
  const int share = cdiv(items, C);
  return C > 1 ? share + share / 8 : share;
}

// ints of each tree's room: the tree's 2 S, or a third of what staging
// parks in the three (a record and a place, 5 ints, for each read and
// write of the block's slice) where that is more
__host__ __device__ __forceinline__ size_t intra_tree_ints(int S, int R, int Wn, int C) {
  const size_t parked = 5 * (static_cast<size_t>(cdiv(R, C)) + cdiv(Wn, C));
  const size_t tree = 2 * static_cast<size_t>(S);
  return round4(tree > (parked + 2) / 3 ? tree : (parked + 2) / 3);
}

__host__ __device__ __forceinline__ size_t intra_cluster_bytes(int S, int R, int Wn,
                                                               int B, int C) {
  return 4 * (3 * intra_tree_ints(S, R, Wn, C) + 4 * static_cast<size_t>(intra_room(R, C)) +
              4 * static_cast<size_t>(intra_room(Wn, C)) + 8 + 4 * kMaxCluster) +
         3 * round16(B);
}

// f(p), with p in block c's shared memory: a shared-memory pointer for
// the calling block (so its accesses compile to shared-memory ones), else
// the distributed-shared-memory address of p in block c
template <typename Cluster, typename T, typename F>
__device__ __forceinline__ auto at_block(Cluster& cluster, T* p, unsigned me, int c,
                                         F&& f) {
  if (static_cast<unsigned>(c) == me) return f(p);
  return f(cluster.map_shared_rank(p, c));
}

// Each block's tree is a bottom-up segment tree of S leaves (S any size:
// min is commutative): leaf j is node S + j, node x's parent x / 2, node 1
// the root; node 0 is no node.  slice_min: the min over leaves [a, b);
// slice_offer: v offered to the nodes that cover leaves [a, b) (a point
// query then takes the min along its leaf's path); it returns the most
// halvings from a leaf to a node it offered to (0: leaves only).
__device__ __forceinline__ int slice_min(const int* t, int S, int a, int b) {
  int m = kI32Max;
  for (int lo = S + a, hi = S + b; lo < hi; lo >>= 1, hi >>= 1) {
    if (lo & 1) m = min(m, t[lo++]);
    if (hi & 1) m = min(m, t[--hi]);
  }
  return m;
}

__device__ __forceinline__ int slice_offer(int* t, int S, int a, int b, int v) {
  int high = 0;
  for (int lo = S + a, hi = S + b, k = 0; lo < hi; lo >>= 1, hi >>= 1, ++k) {
    if (lo & 1) {
      atomicMin(t + lo++, v);
      high = k;
    }
    if (hi & 1) {
      atomicMin(t + --hi, v);
      high = k;
    }
  }
  return high;
}

// Tree 2's node 0 holds the most halvings k from a leaf to any node
// offered to since the tree was reset (kTop: the root, from a span over
// the whole slice).  Such a node lies in [S >> k, 2 S), which the reset
// clears; it covers only leaves k or k + 1 halvings below it (S need not
// be a power of two: the leaves take two depths), so a point query walks
// k + 1 halvings up (none at k = 0: every offer was to a leaf).
constexpr int kTop = 31;

__device__ __forceinline__ void raise_top(int* t, int k) {
  if (k > 0 && t[0] < k) atomicMax(t, k);
}

// The cluster's trees over ranks [0, C S): block c holds ranks [c S, (c +
// 1) S) as its own tree; nothing above the C roots is stored: a range that
// spans blocks takes the roots of the blocks between its end blocks (at
// most C - 2) one by one.  cluster_min: tree 1's min over ranks [a, b);
// cluster_offer: v offered in tree 2 to every rank of [a, b).
template <typename Cluster>
__device__ __forceinline__ int cluster_min(Cluster& cluster, const int* t, unsigned me,
                                           int S, int a, int b) {
  const int ca = a / S, cb = (b - 1) / S;
  auto part = [&](int c, int lo, int hi) {
    return at_block(cluster, t, me, c, [&](const int* q) { return slice_min(q, S, lo, hi); });
  };
  if (ca == cb) return part(ca, a - ca * S, b - ca * S);
  int m = min(part(ca, a - ca * S, S), part(cb, 0, b - cb * S));
  for (int c = ca + 1; c < cb; ++c)
    m = min(m, at_block(cluster, t, me, c, [](const int* q) { return q[1]; }));
  return m;
}

template <typename Cluster>
__device__ __forceinline__ void cluster_offer(Cluster& cluster, int* t, unsigned me,
                                              int S, int a, int b, int v) {
  const int ca = a / S, cb = (b - 1) / S;
  auto part = [&](int c, int lo, int hi) {
    at_block(cluster, t, me, c, [&](int* q) { raise_top(q, slice_offer(q, S, lo, hi, v)); });
  };
  if (ca == cb) {
    part(ca, a - ca * S, b - ca * S);
    return;
  }
  part(ca, a - ca * S, S);
  part(cb, 0, b - cb * S);
  for (int c = ca + 1; c < cb; ++c) {
    at_block(cluster, t, me, c, [&](int* q) {
      atomicMin(q + 1, v);
      raise_top(q, kTop);
    });
  }
}

// INT32_MAX into ints [from, to) of the 16-byte aligned `base`, 16 bytes a
// store where it can
__device__ __forceinline__ void fill_max(int* base, int from, int to) {
  const int head = min(to, (from + 3) & ~3), tail = max(head, to & ~3);
  for (int k = from + threadIdx.x; k < head; k += blockDim.x) base[k] = kI32Max;
  int4* vec = reinterpret_cast<int4*>(base);
  const int4 all = make_int4(kI32Max, kI32Max, kI32Max, kI32Max);
  for (int k = (head >> 2) + threadIdx.x; k < (tail >> 2); k += blockDim.x) vec[k] = all;
  for (int k = tail + threadIdx.x; k < to; k += blockDim.x) base[k] = kI32Max;
}

// A slot for one item whose block has no room left: in the buffer of the
// next block after `full` with room (the cluster has room for every item);
// returns that block, or -1 after every other block
template <typename Cluster>
__device__ __forceinline__ int claim_slot(Cluster& cluster, int* count, unsigned me,
                                          int full, int C, int room, int* slot) {
  for (int k = 1; k < C; ++k) {
    const int c = full + k < C ? full + k : full + k - C;
    *slot = at_block(cluster, count, me, c, [](int* q) { return atomicAdd(q, 1); });
    if (*slot < room) return c;
  }
  return -1;
}

// the cluster's barrier; a one-block cluster's is the block's
template <typename Cluster>
__device__ __forceinline__ void cluster_barrier(Cluster& cluster, int C) {
  if (C == 1) {
    __syncthreads();
  } else {
    cluster.sync();
  }
}

// Staging's first pass over a warp's 32 items (lane's `key`: its block,
// or -1 for none): each block's items in the warp take consecutive places
// after one shared atomicAdd on this block's count for that block;
// returns (block << 27) | place, or -1
__device__ __forceinline__ int place_in_block(int* by_block, int key) {
  const int lane = threadIdx.x & 31;
  const unsigned group = __match_any_sync(kFull, key);
  const int leader = __ffs(group) - 1;
  int first = 0;
  if (key >= 0 && lane == leader) first = atomicAdd(by_block + key, __popc(group));
  first = __shfl_sync(kFull, first, leader);
  if (key < 0) return -1;
  return (key << 27) | (first + __popc(group & ((1u << lane) - 1)));
}

constexpr int kLow27 = (1 << 27) - 1;  // a packed field's low part
constexpr int kStageRound = 2;         // items of each kind a thread stages at once

// K2, the cluster plan: the whole fixpoint in one thread-block cluster of
// C = gridDim.x blocks (the launch's cluster dimension), its state in the
// blocks' shared memory (layout: intra_cluster_bytes).  Block c holds
// ranks [c S, (c + 1) S) (S = ceil(n / C): the blocks share the ranks
// evenly) as its own trees; every block holds every txn's state and hit
// bytes, and writes out the bits of txns [c Bc, (c + 1) Bc).  Staging: a
// live read (write) goes to the buffer of the block holding its begin
// rank, so that its tree accesses are local wherever the begins are
// spread.  Each block reads its slice of the inputs in one round (every
// load of a thread in flight at once), parks each item's record in its
// tree room and counts its items by block (a shared atomic a warp and
// block), reserves each count with one atomicAdd on that block's claim
// count, and sends each record there in one 16-byte store; an item past
// that block's room (many begins on few ranks) claims a slot in the next
// block with room, one atomicAdd at a time.  A dead read or write is not
// staged.  A record: a read's begin packed as (block << 27) | its leaf's
// node in that block's tree, its end rank, its txn and its begin rank; a
// write's packed begin, end rank, txn and offer.  Tree 1 is kept only
// where some read's rank range (rb, re) is not empty (the range flag; a
// point read's is empty).  Iteration i, its tree 2 and hit bytes those of
// parity i & 1: (A) each write of a txn active, not history-conflicted
// and not hit in iteration i - 1 offers w_tx to tree 1 at its begin's leaf
// and up the ancestors, stopping at the first node that already held a
// value <= the offer (whoever wrote that value carries it up the same
// path), and to tree 2's nodes covering its span (a span of one rank: its
// leaf), raising that block's tree 2 height (node 0) to the highest of
// them; meanwhile each block clears its other tree 2 (read in iteration
// i - 1) up to its height and its hit bytes of this parity; barrier; (B)
// each read takes the min of tree 2 along its begin leaf's path up to that
// height, plus one above a leaf, and of tree 1 over (rb, re), and when that
// is below its txn marks the txn hit in every block; barrier.  The intra
// bits after iteration i are its hits, and every block holds them all, so
// every block finds alone, and alike, whether any bit changed (the stop
// rule: none changed, or B + 2 iterations).  Tree 1, where kept, is reset
// behind a third barrier.
__global__ void __launch_bounds__(kClusterThreads, 1)
    intra_cluster_kernel(const int* __restrict__ rb_r,
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
                         int R, int Wn, int B, int n, int S) {
  namespace cg = cooperative_groups;
  auto cluster = cg::this_cluster();
  const unsigned me = cluster.block_rank();
  const int C = static_cast<int>(gridDim.x);
  const int Rc = cdiv(R, C), Wc = cdiv(Wn, C), Bc = cdiv(B, C);
  const int r_room = intra_room(R, C), w_room = intra_room(Wn, C);
  const int tree_ints = static_cast<int>(intra_tree_ints(S, R, Wn, C));
  const int B16 = static_cast<int>(round16(B));
  extern __shared__ __align__(16) int fix_smem[];
  int* t1 = fix_smem;
  int* t2_even = t1 + tree_ints;  // tree 2 of the even iterations
  int* t2_odd = t1 + 2 * tree_ints;
  int4* rd = reinterpret_cast<int4*>(t1 + 3 * tree_ints);
  int4* wr = rd + r_room;
  int* claimed = reinterpret_cast<int*>(wr + w_room);  // [0]: reads, [1]: writes here
  int* ranges = claimed + 2;              // some read's rank range is not empty
  int* by_block = claimed + 8;            // [2 C]: this block's items by block
  int* base = by_block + 2 * kMaxCluster; // [2 C]: their first slot there
  unsigned char* state = reinterpret_cast<unsigned char*>(base + 2 * kMaxCluster);
  unsigned char* hits_even = state + B16;  // hit bytes of the even iterations
  unsigned char* hits_odd = state + 2 * B16;
  const int tid = threadIdx.x, lane = tid & 31;
  const int last_rank = max(n - 1, 0), last_txn = max(B - 1, 0);
  const int r0 = me * Rc, w0 = me * Wc, t0 = me * Bc;
  const int r_n0 = max(min(Rc, R - r0), 0), w_n0 = max(min(Wc, Wn - w0), 0);
  const int b_n = max(min(Bc, B - t0), 0);
  // staging parks, in the trees' room, a record and a place for each read
  // and write of the block's slice: block (4 bits) << 27 | place among
  // this block's items for that block, or -1 for a dead one
  int4* parked = reinterpret_cast<int4*>(t1);
  int* place = t1 + 4 * (Rc + Wc);
  const bool aligned =  // 4 txns' bytes a load (bool is one byte, 0 or 1)
      ((reinterpret_cast<size_t>(active) | reinterpret_cast<size_t>(hist)) & 3) == 0;
  const int words = aligned ? B / 4 : 0;
  const int k_end = max(max(r_n0, w_n0), words);

  // staging: the only reads of device memory before the output
  if (tid < 8) claimed[tid] = 0;  // the claim counts, the range flag
  if (tid < 2 * C) by_block[tid] = 0;
  for (int w = tid; w < 2 * B16 / 16; w += kClusterThreads)
    reinterpret_cast<int4*>(hits_even)[w] = make_int4(0, 0, 0, 0);
  for (int t = 4 * words + tid; t < B16; t += kClusterThreads)
    state[t] = t < B && active[t] && !hist[t];
  __syncthreads();
  if (C > 1) cluster_arrive();  // this block's claim counts are at 0
  bool range_seen = false;
  for (int k0 = tid & ~31; k0 < k_end; k0 += kStageRound * kClusterThreads) {
    bool rok[kStageRound], wok[kStageRound];
    int rb[kStageRound], re[kStageRound], wb[kStageRound], we[kStageRound];
    int v[kStageRound];
    unsigned a4[kStageRound], h4[kStageRound];
    long long rt[kStageRound], wt[kStageRound];
#pragma unroll
    for (int u = 0; u < kStageRound; ++u) {  // the loads, all in flight at once
      const int k = k0 + u * kClusterThreads + lane;
      const bool r_in = k < r_n0, w_in = k < w_n0, s_in = k < words;
      rok[u] = r_in && r_ok[r0 + k];
      rb[u] = r_in ? rb_r[r0 + k] : 0;
      re[u] = r_in ? re_r[r0 + k] : 0;
      rt[u] = r_in ? r_idx[r0 + k] : 0;
      wok[u] = w_in && w_ok[w0 + k];
      wb[u] = w_in ? wb_r[w0 + k] : 0;
      we[u] = w_in ? we_r[w0 + k] : 0;
      wt[u] = w_in ? w_idx[w0 + k] : 0;
      v[u] = w_in ? w_tx[w0 + k] : 0;
      a4[u] = s_in ? reinterpret_cast<const unsigned*>(active)[k] : 0;
      h4[u] = s_in ? reinterpret_cast<const unsigned*>(hist)[k] : 0;
    }
#pragma unroll
    for (int u = 0; u < kStageRound; ++u) {
      const int k = k0 + u * kClusterThreads + lane;
      if (k < words) reinterpret_cast<unsigned*>(state)[k] = a4[u] & ~h4[u] & 0x01010101u;
      const int r_b = clamp_to(rb[u], 0, last_rank), r_e = clamp_to(re[u], 0, n);
      const int r_key = rok[u] && B > 0 ? r_b / S : -1;
      range_seen |= r_key >= 0 && r_b + 1 < r_e;
      const int r_at = place_in_block(by_block, r_key);
      if (r_key >= 0) {
        parked[k] = make_int4((r_key << 27) | (S + r_b - r_key * S), r_e,
                              clamp_idx(rt[u], last_txn), r_b);
      }
      if (k < r_n0) place[k] = r_at;
      const int w_b = clamp_to(wb[u], 0, last_rank);
      const int w_key = wok[u] && B > 0 ? w_b / S : -1;
      const int w_at = place_in_block(by_block + C, w_key);
      if (w_key >= 0) {
        parked[Rc + k] = make_int4((w_key << 27) | (S + w_b - w_key * S),
                                   clamp_to(we[u], 0, n), clamp_idx(wt[u], last_txn), v[u]);
      }
      if (k < w_n0) place[Rc + k] = w_at;
    }
  }
  __syncthreads();
  if (C > 1) cluster_wait();  // every block is running, its claim counts at 0
  if (__any_sync(kFull, range_seen) && lane == 0) {
    for (int c = 0; c < C; ++c) at_block(cluster, ranges, me, c, [](int* q) { *q = 1; });
  }
  if (tid < 2 * C) {
    const int n_here = by_block[tid];
    base[tid] = n_here ? at_block(cluster, claimed + tid / C, me, tid % C,
                                  [&](int* q) { return atomicAdd(q, n_here); })
                       : 0;
  }
  __syncthreads();
  for (int k = tid; k < Rc + Wc; k += kClusterThreads) {
    const bool is_read = k < Rc;
    if (k >= (is_read ? r_n0 : Rc + w_n0)) continue;  // past the block's slice
    const int at = place[k];
    if (at < 0) continue;
    const int own = at >> 27, room = is_read ? r_room : w_room;
    int c = own, slot = base[is_read ? own : C + own] + (at & kLow27);
    if (slot >= room) c = claim_slot(cluster, claimed + !is_read, me, own, C, room, &slot);
    const int4 record = parked[k];
    if (c >= 0) {  // always: the cluster has room for every item
      at_block(cluster, is_read ? rd : wr, me, c, [&](int4* q) { q[slot] = record; });
    }
  }
  __syncthreads();  // the parked records are sent: the trees' room is free
  fill_max(t2_even, 1, 2 * S);
  if (tid == 0) t2_even[0] = 0;
  cluster_barrier(cluster, C);
  const int r_n = min(claimed[0], r_room), w_n = min(claimed[1], w_room);
  const bool tree1 = *ranges != 0;
  if (tree1) {
    fill_max(t1, 0, 2 * S);
    cluster_barrier(cluster, C);
  }

  int it = 0, last_top = kTop;  // the other tree 2 is cleared whole the first time
  for (;;) {
    int* t2 = it & 1 ? t2_odd : t2_even;
    int* t2_last = it & 1 ? t2_even : t2_odd;
    unsigned char* hit = it & 1 ? hits_odd : hits_even;
    const unsigned char* hit_last = it & 1 ? hits_even : hits_odd;
    // A: every committed write offers its txn index to both trees
    for (int j = tid; j < w_n; j += kClusterThreads) {
      const int4 w = wr[j];  // packed begin, end rank, txn, offer
      if (!state[w.z] || hit_last[w.z]) continue;
      const int c = w.x >> 27, leaf = w.x & kLow27, wb = c * S + leaf - S;
      if (tree1) {
        at_block(cluster, t1, me, c, [&](int* up) {
          for (int x = leaf; x >= 1; x >>= 1) {
            if (atomicMin(up + x, w.w) <= w.w) break;
          }
        });
      }
      if (w.y == wb + 1) {
        at_block(cluster, t2, me, c, [&](int* q) { atomicMin(q + leaf, w.w); });
      } else if (wb < w.y) {
        cluster_offer(cluster, t2, me, S, wb, w.y, w.w);
      }
    }
    fill_max(t2_last, max(S >> last_top, 1), 2 * S);
    if (tid == 0) t2_last[0] = 0;
    for (int w = tid; w < B16 / 16; w += kClusterThreads)
      reinterpret_cast<int4*>(hit)[w] = make_int4(0, 0, 0, 0);
    cluster_barrier(cluster, C);

    // B: each live read's minimum, against its own txn
    for (int i = tid; i < r_n; i += kClusterThreads) {
      const int4 r = rd[i];  // packed begin, end rank, txn, begin rank
      const int c = r.x >> 27, leaf = r.x & kLow27;
      int m = at_block(cluster, t2, me, c, [&](const int* path) {
        const int high = min(path[0], kTop), stop = high ? high + 1 : 0;
        int low = path[leaf];
        for (int x = leaf >> 1, k = 1; k <= stop && x >= 1; x >>= 1, ++k)
          low = min(low, path[x]);
        return low;
      });
      if (r.w + 1 < r.y) m = min(m, cluster_min(cluster, t1, me, S, r.w + 1, r.y));
      if (m < r.z) {
        for (int c2 = 0; c2 < C; ++c2)
          at_block(cluster, hit, me, c2, [&](unsigned char* h) { h[r.z] = 1; });
      }
    }
    cluster_barrier(cluster, C);

    // the stop rule, alike in every block: did any txn's bit change?
    unsigned moved = 0;
    for (int w = tid; w < B16 / 4; w += kClusterThreads)
      moved |= reinterpret_cast<const unsigned*>(hit)[w] ^
               reinterpret_cast<const unsigned*>(hit_last)[w];
    last_top = min(t2[0], kTop);
    ++it;
    if (!__syncthreads_or(moved != 0) || it >= B + 2) break;
    if (tree1) {
      fill_max(t1, 0, 2 * S);
      cluster_barrier(cluster, C);
    }
  }
  const unsigned char* bits = it & 1 ? hits_even : hits_odd;  // iteration it - 1's
  for (int l = tid; l < b_n; l += kClusterThreads) out[t0 + l] = bits[t0 + l] != 0;
  if (me == 0 && tid == 0) *n_iters = it;
  cluster_barrier(cluster, C);  // no block leaves while another may address its shared memory
}

// K4: element o of chunk blockIdx.z of run blockIdx.y's step rows (the
// chunk: step rows [z chunk_rows, +chunk_rows), chunk_rows even, so a
// chunk's rows alternate begin, end from a begin), for o = the block's tile
// start + threadIdx.x + u kThreads (u < kStepPer): row r = o / W as
// umulhi(o, magic) >> shift (exact for o < 2^31; magic 0: W = 1), lane
// o - r W, copied from element o - ceil(r / 2) W of the chunk's begins (r
// even) or ends (r odd).  All kStepPer loads are issued before the stores.
__global__ void __launch_bounds__(kThreads)
run_to_step_kernel(const int* __restrict__ runs_b, const int* __restrict__ runs_e,
                   const int* __restrict__ ver, int* __restrict__ rows,
                   int* __restrict__ vals, int rcap, int W, unsigned magic,
                   int shift, int chunk_rows) {
  const unsigned z_row = blockIdx.z * static_cast<unsigned>(chunk_rows);
  const unsigned n_rows = min(static_cast<unsigned>(chunk_rows), 2u * rcap - z_row);
  const unsigned n = n_rows * static_cast<unsigned>(W);
  const size_t row0 = 2 * static_cast<size_t>(blockIdx.y) * rcap + z_row;  // even
  const int* b = runs_b + (row0 >> 1) * W;
  const int* e = runs_e + (row0 >> 1) * W;
  int* out = rows + row0 * W;
  int* out_vals = vals + row0;
  const unsigned first = blockIdx.x * (kStepPer * kThreads) + threadIdx.x;
  int v[kStepPer];
  unsigned r[kStepPer];
#pragma unroll
  for (int u = 0; u < kStepPer; ++u) {
    const unsigned o = first + u * kThreads;
    if (o < n) {
      r[u] = magic ? __umulhi(o, magic) >> shift : o;
      v[u] = ((r[u] & 1u) ? e : b)[o - ((r[u] + 1u) >> 1) * W];
    }
  }
#pragma unroll
  for (int u = 0; u < kStepPer; ++u) {
    const unsigned o = first + u * kThreads;
    if (o < n) {
      out[o] = v[u];
      if (o - r[u] * W == static_cast<unsigned>(W - 1))
        out_vals[r[u]] = (r[u] & 1u) == 0 && v[u] != kSentLane ? ver[blockIdx.y] : 0;
    }
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

// Lets intra_cluster_kernel take `smem_bytes` of dynamic shared memory
// and, above 8 blocks, a non-portable cluster size; fills `cfg` for one
// cluster of `cluster` blocks.
cudaError_t intra_cluster_config(int cluster, int smem_bytes, cudaStream_t stream,
                                 cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(intra_cluster_kernel, smem_bytes);
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(intra_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) cudaGetLastError();
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster);
  cfg->blockDim = dim3(kClusterThreads);
  cfg->dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

// Lets probe_tree_kernel take its staged tree ((2^levels - 1) (W + 1) ints
// of dynamic shared memory: each node's run row and its lanes) and, above 8 blocks, a non-portable cluster size;
// fills `cfg` for tiles of `reads` reads over R reads in clusters of
// `cluster` blocks.  Refuses a plan the kernel does not take.
cudaError_t probe_tree_config(int levels, int reads, int cluster, int W, int R,
                              cudaStream_t stream, cudaLaunchConfig_t* cfg,
                              cudaLaunchAttribute* attr) {
  if (levels < 0 || levels > kTreeMaxLevels || reads < 32 || reads > kTreeMaxReads ||
      reads % 32 || cluster < 1 || cluster > kMaxCluster || W < 1)
    return cudaErrorInvalidValue;
  // the kernel's static shared memory (the leader's verdicts) counts too
  const size_t bytes = static_cast<size_t>((1 << levels) - 1) * (W + 1) * 4;
  const size_t tiles = (static_cast<size_t>(R) + reads - 1) / reads;
  if (bytes + kTreeMaxReads > static_cast<size_t>(kSmemMax) || tiles > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (bytes + kTreeMaxReads > static_cast<size_t>(kSmemWithoutOptIn)) {
    err = cudaFuncSetAttribute(probe_tree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) cudaGetLastError();
  }
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(probe_tree_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) cudaGetLastError();
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster, static_cast<unsigned>(std::max<size_t>(tiles, 1)));
  cfg->blockDim = dim3(reads);
  cfg->dynamicSmemBytes = bytes;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

}  // namespace

extern "C" {

const char* fdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Blocks of a warp-plan kernel (0: K1's, 1: K3's) that one SM holds at
// once with `threads` threads and `smem_bytes` of dynamic shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); minus the error code
// when the runtime refuses.
int fdb_warp_plan_occupancy(int kernel, int threads, int smem_bytes) {
  int blocks = 0;
  cudaError_t err;
  if (kernel == 0) {
    err = allow_smem(probe_fused_warp_kernel, smem_bytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, probe_fused_warp_kernel, threads, smem_bytes);
    }
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, compact_ranks_warp_kernel, threads, smem_bytes);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return blocks;
}

int fdb_probe_fused(const void* rb, const void* re, const void* snap,
                    const void* r_ok, const void* hist, const void* runs_b,
                    const void* runs_e, const void* runs_ver, void* out, int R,
                    int K, int run_cap, int W, int group_log2, int stride_log2,
                    int n_sum, int threads, int smem_bytes, int warp,
                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (warp) {  // `threads` / 32 warps: reads of 2^group_log2 warps each
    const cudaError_t err = allow_smem(probe_fused_warp_kernel, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    probe_fused_warp_kernel<<<blocks_for(R, (threads >> 5) >> group_log2), threads,
                              smem_bytes, st>>>(
        static_cast<const int*>(rb), static_cast<const int*>(re),
        static_cast<const int*>(snap), static_cast<const bool*>(r_ok),
        static_cast<const bool*>(hist), static_cast<const int*>(runs_b),
        static_cast<const int*>(runs_e), static_cast<const int*>(runs_ver),
        static_cast<bool*>(out), R, K, run_cap, W, group_log2, smem_bytes > 0);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t err = allow_smem(probe_fused_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_fused_kernel<<<blocks_for(R, threads >> group_log2), threads,
                       smem_bytes, st>>>(
      static_cast<const int*>(rb), static_cast<const int*>(re),
      static_cast<const int*>(snap), static_cast<const bool*>(r_ok),
      static_cast<const bool*>(hist), static_cast<const int*>(runs_b),
      static_cast<const int*>(runs_e), static_cast<const int*>(runs_ver),
      static_cast<bool*>(out), R, K, run_cap, W, group_log2, stride_log2,
      n_sum);
  return static_cast<int>(cudaGetLastError());
}

// K5 under the plan (levels, reads, cluster) of kernels.plan_probe_tree
int fdb_probe(const void* rb, const void* re, const void* snap,
              const void* r_ok, const void* runs_b, const void* runs_e,
              const void* runs_ver, void* out, int R, int K, int run_cap, int W,
              int levels, int reads, int cluster, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = probe_tree_config(levels, reads, cluster, W, R,
                                      static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (err == cudaSuccess) {
    err = cudaLaunchKernelEx(
        &cfg, probe_tree_kernel, static_cast<const int*>(rb), static_cast<const int*>(re),
        static_cast<const int*>(snap), static_cast<const bool*>(r_ok),
        static_cast<const int*>(runs_b), static_cast<const int*>(runs_e),
        static_cast<const int*>(runs_ver), static_cast<bool*>(out), R, K, run_cap, W,
        levels);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// Clusters of K5's plan (levels, reads, cluster) at width W that the
// current card holds at once (cudaOccupancyMaxActiveClusters); minus the
// error code when the runtime refuses.
int fdb_probe_tree_occupancy(int levels, int reads, int cluster, int W) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = probe_tree_config(levels, reads, cluster, W, 1, nullptr, &cfg, &attr);
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, probe_tree_kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return clusters;
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
                      int queries, int warp, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (warp) {  // a warp a query, `queries` a block
    if (queries < 1) return static_cast<int>(cudaErrorInvalidValue);
    compact_ranks_warp_kernel<<<blocks_for(n_rec, queries), 32 * kRanksWarps, 0,
                                st>>>(static_cast<const int*>(ks),
                                      static_cast<const int*>(rec),
                                      static_cast<int*>(out), cap, n_rec, W, queries);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t err = allow_smem(compact_ranks_narrowed_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_ranks_narrowed_kernel<<<blocks_for(n_rec, queries), kRanksThreads,
                                  smem_bytes, st>>>(
      static_cast<const int*>(ks), static_cast<const int*>(rec),
      static_cast<int*>(out), cap, n_rec, W, span_rows, queries);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of K2's cluster plan (`cluster` blocks, `smem_bytes` a block)
// that the current card holds at once (cudaOccupancyMaxActiveClusters);
// minus the error code when the runtime refuses.
int fdb_intra_cluster_occupancy(int cluster, int smem_bytes) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = intra_cluster_config(cluster, smem_bytes, nullptr, &cfg, &attr);
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, intra_cluster_kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return clusters;
}

// K2: `cluster` 0 is the grid plan (one cooperative launch over `scratch`),
// else the cluster plan: one cluster of `cluster` blocks with `smem_bytes`
// of shared memory each (at least intra_cluster_bytes) and the trees'
// `leaves` (a multiple of `cluster`, at least n) split evenly among them.
int fdb_intra_fixpoint(const void* rb_r, const void* re_r, const void* wb_r,
                       const void* we_r, const void* r_ok, const void* w_ok,
                       const void* r_idx, const void* w_idx, const void* w_tx,
                       const void* active, const void* hist, void* out,
                       void* n_iters, void* scratch, int R, int Wn, int B,
                       int n, int leaves, int cluster, int smem_bytes,
                       void* stream) {
  if (cluster) {
    const int S = leaves / cluster;
    if (S < 1 || S * cluster != leaves || leaves < n ||
        static_cast<size_t>(smem_bytes) < intra_cluster_bytes(S, R, Wn, B, cluster))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = intra_cluster_config(cluster, smem_bytes,
                                           static_cast<cudaStream_t>(stream), &cfg, &attr);
    if (err == cudaSuccess) {
      err = cudaLaunchKernelEx(
          &cfg, intra_cluster_kernel, static_cast<const int*>(rb_r),
          static_cast<const int*>(re_r), static_cast<const int*>(wb_r),
          static_cast<const int*>(we_r), static_cast<const bool*>(r_ok),
          static_cast<const bool*>(w_ok), static_cast<const long long*>(r_idx),
          static_cast<const long long*>(w_idx), static_cast<const int*>(w_tx),
          static_cast<const bool*>(active), static_cast<const bool*>(hist),
          static_cast<bool*>(out), static_cast<int*>(n_iters), R, Wn, B, n, S);
    }
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    return static_cast<int>(cudaGetLastError());
  }
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
                    unsigned magic, int shift, int chunk_rows, int chunks,
                    int blocks, void* stream) {
  run_to_step_kernel<<<dim3(blocks, K, chunks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(runs_b), static_cast<const int*>(runs_e),
      static_cast<const int*>(ver), static_cast<int*>(rows),
      static_cast<int*>(vals), rcap, W, magic, shift, chunk_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
