#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Drives the port (foundationdb_tpu_torch) and nothing of the JAX package:

  1. device   the card's name, device count, name and power limit;
  2. build    nvcc builds the conflict kernels from csrc/, and the
              compiler's -Xptxas -v lines are printed, K1's and K3's with
              the dynamic shared memory a block takes at phase 3's shapes;
  3. kernels  each kernel (K1-K5, K2's per-query referee) on seeded inputs
              at the resolver's full-width shapes, held against its plain
              torch version on the same CUDA tensors (exact: integer
              functions), timed with L2 cold and warm, and set against the
              least time the bytes and operations its inputs need would
              take the card; K5 also against K1 with no history bit set,
              and K5 | history against K1; K5's cold time (the
              thread-per-read design K1 had before its redesign) is
              printed beside K1's.  K2, the whole intra fixpoint in one
              launch, on the first stream batch and on a 1024-txn chain
              (a trajectory as long as the batch), also against the loop
              it replaced (the per-query kernel in a host loop: same bits,
              same iteration count), whose time is printed beside it; K4
              over the 8 runs of a compaction at once;
  4. stream   the full-width resolver stream (8192 txns per batch, 2 point
              reads + 1 point write each, uniform 16-byte keys, 8 prefill
              + 16 timed batches, GC from the 10th batch) through
              DeviceConflictSet.resolve_batch on "cuda" and on "cpu":
              identical verdicts every batch and identical final state,
              the same fixpoint iterations, every kernel of the path
              launched by the cuda run (K2 once a batch, K4 once a
              compaction), host syncs and iterations per batch.  Then a
              few more batches, timed plain and profiled on a twin set
              (device busy share, launches, the ops that take the time);
  6. best-known  the same stream through bench.py's BEST_KNOWN layout
              (lsm=True, search_impl="bucket") on "cpu" once and on
              "cuda" in three modes (`drive`): synchronous resolve_batch,
              resolve_deferred waited one behind, and a PipelinedPacker
              with BatchStager feeding resolve_arrays(sync=False).  Every
              mode's verdicts equal phase 4's and the cpu run's batch by
              batch, its final state the cpu run's; checks/s, latency,
              pack/h2d time, host syncs, fixpoint iterations (equal to the
              cpu run's) and (profiled) device-busy share and launches
              per mode.  On one batch of the live state K5 referees K1,
              and the per-query loop referees K2;
  7. recovery a deep 16-bit-prefix bucket through resolve_deferred on the
              card: the deferred check fails, the window recovers, and the
              verdicts equal the oracle's;
  8. oracle   a reduced stream (variable-length keys with shared prefixes,
              main capacity small enough to regrow) on "cuda" against the
              port's OracleConflictSet: identical verdicts;
  9. supervised  the best-known set on "cuda" inside the port's
              DeviceSupervisor, the port's native skip list as its CPU
              fallback: (a) phase 4's stream through resolve_batch and
              then resolve_deferred (one behind), in turns with the bare
              best-known set (bare, supervised, supervised, bare), verdicts
              equal phase 4's, healthy with 0 trips and 1 promotion, the
              native set serving the first batch's parity check only, and
              the supervised / bare checks/s; (b) the drill: the
              port's buggify loses the device 3 times mid-stream, the
              breaker trips once, the native set serves, force_promote()
              rebuilds the set on the card from the committed-write record
              and a parity batch re-promotes it (healthy, 1 trip, 2
              promotions; the times to degrade and to re-promote printed);
              (c) four batches with the wall watchdog on, and a
              BatchStager batch resolved on the watchdog's worker thread;
 10. bench    the port's headline bench (foundationdb_tpu_torch/bench.py)
              at its full shape in this process: its JSON line (abort-set
              parity against the native set on the timed batches and on
              the resolver e2e run's), then native and card checks/s,
              vs_baseline, p50/p99 and the resolver e2e rate.

Each path is driven with the launch counts set to 0 just before it and read
just after.  Prints the kernels' JSON line (`launches`: K1-K4 on phase 4's
stream, K5 and the per-query intra kernel in their referee roles;
`launches_by_path` for every path), then
the card's name and power limit, then as its last line
{"ok": true, "device": {...}}.  Any failure raises and
exits non-zero; without a CUDA device, or without the package beside this
script, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 20260729

# the deployment bench.py models (BASELINE.json config 1): one resolver,
# 8192-transaction batches of 2 point reads + 1 point write, keys uniform
# over 2**20 random 16-byte keys, snapshots within 13 versions
TXNS = 8192
READS_PER_TXN = 2
KEY_BYTES = 16
KEY_POOL = 1 << 20
SNAP_WINDOW = 13
PREFILL_BATCHES = 8
TIMED_BATCHES = 16
PROFILED_BATCHES = 3    # after the stream, under torch.profiler
GC_FROM_BATCH = 10      # remove_before(commit - GC_LAG) from this batch on
GC_LAG = 8
SET_ARGS = dict(max_key_bytes=16, capacity=1 << 19, run_slots=8,
                run_capacity=1 << 14)

# the card's published peaks (H100 SXM data sheet): memory bandwidth, and
# the 32-bit non-tensor rate used for the kernels' integer compares
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
SECTOR = 32              # bytes: the unit in which memory serves a gather
FLUSH_BYTES = 256 << 20  # written before a cold launch: 5x the 50 MB L2
SPIN_CYCLES = 200_000    # ~0.1 ms of device spin ahead of a timed launch

SOURCE = "foundationdb_tpu_torch/csrc/conflict_kernels.cu"
KERNELS = (  # (counter name, TPU kernel it replaces, CUDA symbol)
    ("probe_fused", "foundationdb_tpu/conflict/pallas_kernel.py:189",
     "probe_fused_kernel"),
    ("intra_query", "foundationdb_tpu/conflict/pallas_kernel.py:353",
     "intra_query_kernel"),
    ("compact_ranks", "foundationdb_tpu/conflict/pallas_kernel.py:474",
     "compact_ranks_narrowed_kernel"),
    ("run_to_step", "foundationdb_tpu/conflict/pallas_kernel.py:416",
     "run_to_step_kernel"),
    ("probe", "foundationdb_tpu/conflict/pallas_kernel.py:165",
     "probe_kernel"),
    ("intra_fixpoint", "foundationdb_tpu/conflict/pallas_kernel.py:353",
     "intra_fixpoint_kernel"),
)
SYMBOLS = {name: symbol for name, _where, symbol in KERNELS}
MAIN_PATH = ("probe_fused", "intra_fixpoint", "compact_ranks", "run_to_step")
CHAIN_TXNS = 1024  # the chain batch of phase 3: txn t reads what t - 1 writes
# cudaLaunchKernel and, for K2, cudaLaunchCooperativeKernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel")
# bench.py's BEST_KNOWN layout, run in three modes over the same stream
BEST_KNOWN = dict(lsm=True, search_impl="bucket")
MODES = ("sync", "deferred", "packer")
# each mode twice, in turns, so that drift over the call (the shared host's
# load) falls on every mode alike
TURNS = MODES + MODES[::-1]


def log(*parts) -> None:
    print(*parts, flush=True)


def card_power_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


# ---------------------------------------------------------------------------
# timing


def call_ms(torch, fn, reps: int, warm: int = 3) -> float:
    """Time per call made back to back: CUDA events around `reps` calls,
    over `reps`.  A kernel shorter than its host-side launch leaves the
    stream idle between calls, so this is the cost of a call on the path,
    host launch included."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def launch_ms(torch, fn, reps: int, flush=None) -> float:
    """Median time of one launch between its own pair of CUDA events.
    Before each launch the stream first writes `flush` (when given: the
    L2 holds none of the inputs then, as on the main path where the
    kernel's inputs were written batches or a large sort earlier) and then
    spins ~0.1 ms, so the host has enqueued the launch before the start
    event fires: the pair times the device's work, not the host's."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.fill_(1)
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def _is_kernel(key: str, symbol: str) -> bool:
    """Whether a profiler record names the CUDA kernel `symbol` (no
    kernel's name is a part of another's)."""
    return symbol in key


def device_ms(torch, fn, symbol: str, reps: int) -> float:
    """The kernel's own duration per launch, from the profiler's device
    records (CUPTI), over `reps` launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    mine = [e for e in prof.key_averages() if _is_kernel(e.key, symbol)]
    require(mine, f"the profiler recorded no launch of {symbol}")
    return sum(_device_us(e) for e in mine) / 1e3 / reps


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# the work each kernel's inputs need: its searches replayed on the same
# tensors, every lane they read collected, and the reads counted in the
# 32-byte sectors memory serves them in (each sector once).  Operations:
# one compare per lane read plus four integer operations per search step.
# Each replay also returns the kernel's function, which the caller holds
# against the kernel, so a replay that went astray cannot pass.


def _sectors(torch, elems, elem_bytes: int = 4) -> int:
    """Distinct sectors holding the given elements of one buffer."""
    if elems.numel() == 0:
        return 0
    return int(torch.unique(elems.long() * elem_bytes // SECTOR).numel())


def _first_diff(torch, a, b):
    """Per row pair: the lane where a lexicographic compare of a with b
    decides (the first lane that differs, the last when none does) and
    whether a < b."""
    W = a.shape[1]
    diff = a != b
    first = torch.where(diff.any(1), diff.to(torch.int32).argmax(1), W - 1)
    at = first[:, None]
    return first, a.gather(1, at)[:, 0] < b.gather(1, at)[:, 0]


def _lanes_upto(torch, rows, first, W: int):
    """Element indices of lanes 0..first[j] of row rows[j]."""
    lane = torch.arange(W, device=rows.device)
    return (rows.long()[:, None] * W + lane)[lane[None, :] <= first[:, None]]


def trace_search(torch, table, qq, qid):
    """Replays count_below of csrc/conflict_kernels.cu: the binary search
    of the sorted rows `table` for #rows < qq[j].  qid[j] is query j's row
    in its own buffer.  Returns the ranks, the element indices of every
    lane the searches read of the table and of the query buffer, the
    search steps and the lanes compared."""
    n, W = table.shape
    lo = torch.zeros(qq.shape[0], dtype=torch.long, device=qq.device)
    hi = torch.full_like(lo, n)
    t_el, q_el = [lo[:0]], [lo[:0]]
    steps = lanes = 0
    while True:
        a = (lo < hi).nonzero()[:, 0]
        if a.numel() == 0:
            return lo, torch.cat(t_el), torch.cat(q_el), steps, lanes
        mid = lo[a] + (hi[a] - lo[a]) // 2
        first, less = _first_diff(torch, table[mid], qq[a])
        t_el.append(_lanes_upto(torch, mid, first, W))
        q_el.append(_lanes_upto(torch, qid[a], first, W))
        steps += a.numel()
        lanes += int((first + 1).sum())
        lo[a] = torch.where(less, mid + 1, lo[a])
        hi[a] = torch.where(less, hi[a], mid)


def probe_fused_work(torch, rb, re_, snap, r_ok, runs_b, runs_e, runs_ver,
                     hist=None):
    """K1: a thread reads hist; when clear, r_ok; when set, snap, and for
    each run newer than snap (until its first conflict) searches the run's
    begins with its read end and, on rank > 0, compares its read begin with
    ends[rank - 1].  With hist None, K5: the same without the history
    input (every thread reads r_ok).  Returns (bytes, operations, the
    kernel's output)."""
    R, W = rb.shape
    K, cap, _ = runs_b.shape
    fused = hist is not None
    if not fused:
        hist = torch.zeros_like(r_ok)
    live = ~hist & r_ok
    conflict = torch.zeros_like(hist)
    el = {"rb": [], "re": [], "runs_b": [], "runs_e": []}
    steps = lanes = 0
    for k in range(K):
        a = (live & ~conflict & (runs_ver[k] > snap)).nonzero()[:, 0]
        if a.numel() == 0:
            continue
        rank, t, q, s, n_lanes = trace_search(torch, runs_b[k], re_[a], a)
        el["runs_b"].append(t + k * cap * W)
        el["re"] += [q, a * W + W - 1]  # and the end's last lane, kept apart
        steps, lanes = steps + s, lanes + n_lanes
        hit = rank > 0
        a, rank = a[hit], rank[hit]
        first, less = _first_diff(torch, rb[a], runs_e[k][rank - 1])
        el["rb"].append(_lanes_upto(torch, a, first, W))
        el["runs_e"].append(_lanes_upto(torch, k * cap + rank - 1, first, W))
        lanes += int((first + 1).sum())
        conflict[a] = less
    n_bytes = ((2 if fused else 1) * R + SECTOR  # hist, out; runs_ver
               + SECTOR * _sectors(torch, (~hist).nonzero()[:, 0], 1)
               + SECTOR * _sectors(torch, live.nonzero()[:, 0])
               + SECTOR * sum(_sectors(torch, torch.cat(v)) for v in el.values() if v))
    return n_bytes, lanes + 4 * steps, hist | conflict


def intra_query_work(torch, rmq, beg_tab, stab, rb_r, re_r):
    """K2: per read, the rank bounds, two table lookups when its rank range
    is not empty, one stab lookup, one output."""
    L, n = beg_tab.shape
    R = rb_r.shape[0]
    lo, hi = rb_r.long() + 1, re_r.long()
    nonempty = hi > lo
    k = torch.clamp(rmq.floor_log2(torch.clamp(hi - lo, min=1).to(torch.int32)),
                    max=L - 1).long()
    i1 = torch.clamp(lo, 0, n - 1)
    i2 = torch.clamp(hi - torch.bitwise_left_shift(torch.ones_like(k), k), 0, n - 1)
    tab = beg_tab.reshape(-1)
    s_idx = torch.clamp(rb_r.long(), 0, n - 1)
    out = torch.minimum(
        torch.where(nonempty, torch.minimum(tab[k * n + i1], tab[k * n + i2]),
                    rmq.I32_MAX),
        stab[s_idx])
    t_el = torch.cat([(k * n + i1)[nonempty], (k * n + i2)[nonempty]])
    n_bytes = 3 * R * 4 + SECTOR * (_sectors(torch, t_el) + _sectors(torch, s_idx))
    return n_bytes, 12 * R, out


def intra_fixpoint_work(fx, n_iters: int):
    """K2's fixpoint: each input read once (a kernel could hold them on
    chip across iterations: ~0.45 MB at the stream's shapes) and the bits
    and the count written once; one operation a read, write and txn an
    iteration."""
    *tensors, B = fx
    n_bytes = sum(t.numel() * t.element_size() for t in tensors) + B + 4
    return n_bytes, n_iters * (fx[0].shape[0] + fx[2].shape[0] + B), None


def run_to_step_work(K: int, rcap: int, W: int):
    """K4: a pure copy, so it reads every input byte whatever the data:
    the runs' rows and versions in, the step rows and values out."""
    return 2 * K * rcap * W * 4 * 2 + 2 * K * rcap * 4 + 4 * K, 0, None


def compact_ranks_work(torch, keys_mod, ks, rec):
    """K3: per recent row, its last lane (+1) and one search of main."""
    n_rec, W = rec.shape
    rid = torch.arange(n_rec, device=rec.device)
    rank, t, q, steps, lanes = trace_search(torch, ks, keys_mod.with_last_lane_inc(rec), rid)
    q = torch.cat([q, rid * W + W - 1])
    n_bytes = SECTOR * (_sectors(torch, t) + _sectors(torch, q)) + n_rec * 4
    return n_bytes, lanes + 4 * steps + n_rec, rank.to(torch.int32)


# ---------------------------------------------------------------------------
# seeded inputs in the stream's key layout


def key_pool(rng, n=KEY_POOL):
    """n random 16-byte keys, and each key's successor as a 128-bit
    big-endian integer: [k, succ(k)) holds exactly the key k among 16-byte
    keys, the point range of this key space."""
    pool = rng.integers(0, 256, size=(n, KEY_BYTES), dtype=np.uint8)
    succ = pool.copy()
    carry = np.ones(n, dtype=bool)
    for j in range(KEY_BYTES - 1, -1, -1):
        v = succ[:, j].astype(np.uint16) + carry
        succ[:, j] = v & 0xFF
        carry = v > 0xFF
    require(not carry.any(), "an all-0xFF key has no successor")
    return pool, succ


def point_rows(keys_mod, pool, succ, idx):
    """Lane rows of the point ranges [k, succ(k)) for pool indices idx."""
    return (keys_mod.encode_fixed(pool[idx], KEY_BYTES),
            keys_mod.encode_fixed(succ[idx], KEY_BYTES))


def sorted_run(keys_mod, rng, pool, succ, n_live, run_cap):
    """A run as the append builds it: sorted, disjoint point intervals of
    distinct pool keys, sentinel-padded to run_cap."""
    idx = np.unique(rng.integers(0, len(pool), n_live))
    b, e = point_rows(keys_mod, pool, succ, idx)
    order = np.lexsort(b.T[::-1])
    out_b = np.full((run_cap, b.shape[1]), 0xFFFFFFFF, np.uint32)
    out_e = out_b.copy()
    out_b[: len(idx)] = b[order]
    out_e[: len(idx)] = e[order]
    return out_b, out_e


def chain_inputs(torch, keys_mod, tdev, dev, pool, succ, B):
    """K2's arguments for a chain batch of B txns: txn t writes pool key t
    and reads pool key t - 1 (txn 0 reads key B, which nobody writes), so
    the fixpoint settles about one txn an iteration."""
    t = np.arange(B)
    rb, re_ = (keys_mod.to_lanes(a, dev) for a in point_rows(
        keys_mod, pool, succ, np.where(t > 0, t - 1, B)))
    wb, we = (keys_mod.to_lanes(a, dev) for a in point_rows(keys_mod, pool, succ, t))
    tx = torch.arange(B, device=dev)
    ones = torch.ones(B, dtype=torch.bool, device=dev)
    return (*tdev._intra_setup(rb, re_, wb, we), ones, ones, tx, tx,
            tx.to(torch.int32), ones, ~ones, B)


def fixpoint_check(check, results, torch, kernels, fx, key, reps):
    """K2 on `fx` against its plain version (`check`) and against the loop
    it replaced (the per-query kernel in a host loop): the same bits and
    iteration count; logs the loop's time beside the kernel's."""
    got = kernels.intra_fixpoint(*fx)
    n_iters = int(got[1])
    loop = lambda: kernels.intra_fixpoint_plain(*fx, query=kernels.intra_query)  # noqa: E731
    before = kernels.launches["intra_query"]
    k2_loop = loop()
    require(kernels.launches["intra_query"] - before == n_iters,
            f"{key}: the per-query loop launched K2 once an iteration")
    require(torch.equal(k2_loop[0], got[0]) and int(k2_loop[1]) == n_iters,
            f"{key}: the fixpoint kernel disagrees with the per-query loop")
    check("intra_fixpoint", list(got), list(kernels.intra_fixpoint_plain(*fx)),
          intra_fixpoint_work(fx, n_iters), fn=lambda: kernels.intra_fixpoint(*fx),
          plain_fn=lambda: kernels.intra_fixpoint_plain(*fx), reps=reps, cold=False,
          key=key)
    loop_ms = launch_ms(torch, loop, 3)
    ms = results[key]["ms"]
    results[key].update(iterations=n_iters, k2_loop_ms=loop_ms)
    log(f"kernel {key}: {n_iters} iterations, {int(got[0].sum())} of {fx[-1]} "
        f"txns intra-conflicted; same bits and count as the per-query loop; "
        f"fixpoint kernel {ms:.6f} ms vs the loop {loop_ms:.6f} ms "
        f"(loop / kernel = {loop_ms / ms:.1f})")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version


def kernel_phase(torch, fdb, dev, rng, pool, succ, first_batch):
    keys_mod, kernels, tdev, rmq = fdb["keys"], fdb["kernels"], fdb["device"], fdb["rmq"]
    run_cap = SET_ARGS["run_capacity"]
    W = keys_mod.num_words(SET_ARGS["max_key_bytes"])
    R = TXNS * READS_PER_TXN
    lanes = lambda a: keys_mod.to_lanes(a, dev)  # noqa: E731
    results = {}
    kernels.reset_launches()
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    log(f"kernels: an event pair with no launch between reads "
        f"{launch_ms(torch, lambda: None, 100):.6f} ms (the floor under each "
        f"per-launch time below)")

    def check(name, got, want, work, fn, plain_fn, reps, cold, key=None):
        """`cold`: the main path finds the kernel's inputs out of L2, so
        its `ms` (and the plain version's) is timed after a flush.  `key`:
        where the results go (the kernel's name by default)."""
        torch.cuda.synchronize()
        n_bytes, n_ops, replay = work
        got = [g.to(torch.int64) for g in got]
        want = [w.to(torch.int64) for w in want]
        mismatches = sum(int((g != w).sum()) for g, w in zip(got, want))
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        require(replay is None or torch.equal(replay.to(torch.int64), got[0]),
                f"{name}: the replay that counts its work disagrees with it")
        warm_ms = launch_ms(torch, fn, reps)
        cold_ms = launch_ms(torch, fn, reps, flush)
        own_ms = device_ms(torch, fn, SYMBOLS[name], reps)
        back_to_back = call_ms(torch, fn, reps)
        plain_ms = launch_ms(torch, plain_fn, max(3, reps // 10), flush if cold else None)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        ms = cold_ms if cold else warm_ms
        results[key or name] = dict(mismatches=mismatches, max_abs_err=err, ms=ms,
                                    cold_ms=cold_ms, warm_ms=warm_ms, device_ms=own_ms,
                                    call_ms=back_to_back, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by)
        log(f"kernel {key or name}: mismatches={mismatches} ms={ms:.6f} "
            f"({'cold' if cold else 'warm'} L2, as on the main path) "
            f"cold_ms={cold_ms:.6f} warm_ms={warm_ms:.6f} "
            f"device_ms={own_ms:.6f} (profiler, warm) "
            f"call_ms={back_to_back:.6f} (back to back, host launch included) "
            f"plain_ms={plain_ms:.6f} bound_us={bound_ms * 1e3:.3f} ({bound_by}: "
            f"{n_bytes} B, {n_ops} ops) ms/bound={ms / bound_ms:.1f} "
            f"launches={kernels.launches[name]} (this phase)")
        require(mismatches == 0, f"kernel {name} disagrees with its plain version")

    # K1: 8 runs of ~8K point intervals (one dead, one empty), 16384
    # reads with padding (sentinel) rows and TOO_OLD (r_ok False) rows
    half = run_cap // 2  # a batch's 8192 point writes, before coalescing
    runs = [sorted_run(keys_mod, rng, pool, succ, int(f * half), run_cap)
            for f in (1, 0.98, 0.96, 0.99, 1, 0.85, 0.01, 0)]
    runs_b = lanes(np.stack([r[0] for r in runs]))
    runs_e = lanes(np.stack([r[1] for r in runs]))
    runs_ver_np = np.array([0, 3, 5, 6, 8, 9, 11, 12], dtype=np.int32)
    runs_ver = torch.from_numpy(runs_ver_np).to(dev)
    n_live = R - 64
    rb_np = np.full((R, W), 0xFFFFFFFF, np.uint32)
    re_np = rb_np.copy()
    live_idx = rng.integers(0, len(pool), n_live)
    # half the reads hit keys of the runs, so the probe finds conflicts
    hit = rng.random(n_live) < 0.5
    run_keys = keys_mod.from_lanes(runs_b.reshape(-1, W))
    run_keys = run_keys[run_keys[:, -1] != 0xFFFFFFFF]
    rb_np[:n_live], re_np[:n_live] = point_rows(keys_mod, pool, succ, live_idx)
    pick = run_keys[rng.integers(0, len(run_keys), int(hit.sum()))]
    rb_np[:n_live][hit] = pick
    re_np[:n_live][hit] = pick
    re_np[:n_live][hit, -1] += 1  # [k, k + b"\0") in the lane encoding
    snap_np = rng.integers(0, 13, R).astype(np.int32)
    r_ok_np = (np.arange(R) < n_live) & (rng.random(R) < 0.9)
    hist_np = r_ok_np & (rng.random(R) < 0.05)
    k1 = (lanes(rb_np), lanes(re_np), torch.from_numpy(snap_np).to(dev),
          torch.from_numpy(r_ok_np).to(dev), runs_b, runs_e, runs_ver,
          torch.from_numpy(hist_np).to(dev))
    check("probe_fused", [kernels.probe_fused(*k1)],
          [kernels.probe_fused_plain(*k1)], probe_fused_work(torch, *k1),
          fn=lambda: kernels.probe_fused(*k1),
          plain_fn=lambda: kernels.probe_fused_plain(*k1), reps=50, cold=True)

    # K5: K1's inputs without the history bits; it must also equal K1 run
    # with no history bit set, and ORed with the history bits equal K1
    k5 = k1[:7]
    no_hist = torch.zeros_like(k1[7])
    k5_out = kernels.run_conflicts(*k5)
    require(torch.equal(k5_out, kernels.probe_fused(*k5, no_hist)),
            "K5 disagrees with K1 run without history bits")
    require(torch.equal(k5_out | k1[7], kernels.probe_fused(*k1)),
            "K5 | history disagrees with K1")
    check("probe", [k5_out], [kernels.run_conflicts_plain(*k5)],
          probe_fused_work(torch, *k5),
          fn=lambda: kernels.run_conflicts(*k5),
          plain_fn=lambda: kernels.run_conflicts_plain(*k5), reps=50, cold=True)
    k1_ms, k5_ms = results["probe_fused"]["cold_ms"], results["probe"]["cold_ms"]
    log(f"kernel probe_fused vs probe, cold, same inputs (K5 without history "
        f"bits): K1 {k1_ms:.6f} ms, K5 (the thread-per-read design) "
        f"{k5_ms:.6f} ms, K5 / K1 = {k5_ms / k1_ms:.2f}")

    # K2: the first fixpoint iteration's tables of a real stream batch
    rb, re_, r_tx, wb, we, w_tx, _snap, active = tdev.stage_batch(dev, *first_batch[:8])
    rb_r, re_r, wb_r, we_r = tdev._intra_setup(rb, re_, wb, we)
    n = 2 * (rb.shape[0] + wb.shape[0])
    w_ok = w_tx >= 0
    w_cand = torch.where(w_ok, w_tx, rmq.I32_MAX)
    begs = torch.full((n,), rmq.I32_MAX, dtype=torch.int32, device=dev)
    begs.scatter_reduce_(0, wb_r.long(), w_cand, "amin")
    beg_tab = rmq.build_sparse_table(begs, torch.minimum, rmq.I32_MAX)
    stab = rmq.range_update_point_query(n, wb_r, we_r, w_cand, w_ok & (wb_r < we_r),
                                        "min", rmq.I32_MAX)
    k2 = (beg_tab, stab, rb_r, re_r)
    # warm: the fixpoint builds both tables just before each query
    check("intra_query", [kernels.intra_query(*k2)], [kernels.intra_query_plain(*k2)],
          intra_query_work(torch, rmq, *k2),
          fn=lambda: kernels.intra_query(*k2),
          plain_fn=lambda: kernels.intra_query_plain(*k2), reps=100, cold=False)

    # K2 redesigned: the whole fixpoint of the first stream batch (no
    # history yet), then of a chain batch, held against its plain version
    # and against the loop it replaced (the per-query kernel above in a
    # host loop); warm, as on the main path, where the ranks were just made
    B = active.shape[0]
    w_ok = (w_tx >= 0) & ~tdev._is_sentinel(wb)
    fx = (rb_r, re_r, wb_r, we_r, r_tx >= 0, w_ok,
          torch.clamp(r_tx, 0, B - 1).long(), torch.clamp(w_tx, 0, B - 1).long(),
          w_tx, active, torch.zeros(B, dtype=torch.bool, device=dev), B)
    fixpoint_check(check, results, torch, kernels, fx, "intra_fixpoint", reps=50)
    fixpoint_check(check, results, torch, kernels,
                   chain_inputs(torch, keys_mod, tdev, dev, pool, succ, CHAIN_TXNS),
                   "intra_fixpoint_chain", reps=10)

    # K3: ~447K live boundaries of main at cap 2**19 (the stream's size
    # after 24 batches) against one run's step rows (2 * run_cap,
    # sentinels included)
    cap = SET_ARGS["capacity"]
    idx = np.unique(rng.integers(0, len(pool), int(0.48 * cap)))
    b, e = point_rows(keys_mod, pool, succ, idx)
    main = np.concatenate([keys_mod.encode_keys([b""], KEY_BYTES), b, e])
    main = main[np.lexsort(main.T[::-1])]
    ks_np = np.full((cap, W), 0xFFFFFFFF, np.uint32)
    ks_np[: len(main)] = main
    ks = lanes(ks_np)
    u_b, u_e = lanes(runs[1][0]), lanes(runs[1][1])
    rec, _ = kernels.run_to_step_plain(u_b, u_e, runs_ver[1])
    check("compact_ranks", [kernels.compact_ranks(ks, rec)],
          [kernels.compact_ranks_plain(ks, rec)],
          compact_ranks_work(torch, keys_mod, ks, rec),
          fn=lambda: kernels.compact_ranks(ks, rec),
          plain_fn=lambda: kernels.compact_ranks_plain(ks, rec), reps=50, cold=True)

    # K4: the 8 runs of a compaction (of the stream's shape) as step
    # functions, in one launch
    k4 = (runs_b, runs_e, runs_ver)
    check("run_to_step", list(kernels.run_to_step_runs(*k4)),
          list(kernels.run_to_step_runs_plain(*k4)),
          run_to_step_work(*runs_b.shape),
          fn=lambda: kernels.run_to_step_runs(*k4),
          plain_fn=lambda: kernels.run_to_step_runs_plain(*k4), reps=100, cold=True)
    log("kernels " + json.dumps({k: v["mismatches"] for k, v in results.items()}))
    return results


# ---------------------------------------------------------------------------
# phases 4 and 5: the resolver's conflict check end to end


def stream_batches(TxInfo, rng, pool, succ, n_batches, txns=TXNS):
    """(commit_version, [TxInfo]) per batch, as bench.py draws them."""
    kb, sb = pool.tobytes(), succ.tobytes()
    key = lambda i: kb[i * KEY_BYTES:(i + 1) * KEY_BYTES]  # noqa: E731
    nxt = lambda i: sb[i * KEY_BYTES:(i + 1) * KEY_BYTES]  # noqa: E731
    out = []
    for version in range(1, n_batches + 1):
        reads = rng.integers(0, len(pool), size=(txns, READS_PER_TXN)).tolist()
        writes = rng.integers(0, len(pool), size=txns).tolist()
        snaps = np.maximum(version - 1 - rng.integers(0, SNAP_WINDOW, txns), 0).tolist()
        out.append((version, [
            TxInfo(s, [(key(i), nxt(i)) for i in r], [(key(w), nxt(w))])
            for s, r, w in zip(snaps, reads, writes)
        ]))
    return out


def stream_phase(torch, fdb, batches, power):
    """Phase 4: the flat layout (the reference constructor's default)
    through resolve_batch on "cuda" and on "cpu".  Returns (launches, the
    cuda set, the verdicts per batch, the fixpoint's iterations)."""
    tdev, kernels, Verdict = fdb["device"], fdb["kernels"], fdb["Verdict"]
    on_gpu = tdev.DeviceConflictSet(**SET_ARGS, device="cuda")
    on_cpu = tdev.DeviceConflictSet(**SET_ARGS, device="cpu")
    kernels.reset_launches()
    gpu_ms, verdicts = [], []
    for i, (version, txns) in enumerate(batches, start=1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = on_gpu.resolve_batch(version, txns)
        torch.cuda.synchronize()
        gpu_ms.append((time.perf_counter() - t0) * 1e3)
        verdicts.append(got)
        if i >= GC_FROM_BATCH:
            on_gpu.remove_before(version - GC_LAG)
    launches = dict(kernels.launches)
    syncs = on_gpu.host_syncs / len(batches)
    iters = on_gpu.fixpoint_iterations()
    t_cpu = time.perf_counter()
    for i, ((version, txns), got) in enumerate(zip(batches, verdicts), start=1):
        want = on_cpu.resolve_batch(version, txns)
        require(got == want, f"batch {i}: cuda and cpu verdicts differ")
        if i >= GC_FROM_BATCH:
            on_cpu.remove_before(version - GC_LAG)
    cpu_s = time.perf_counter() - t_cpu
    same_state(on_gpu, on_cpu, "flat stream")
    require(iters == on_cpu.fixpoint_iterations(),
            "flat stream: the fixpoint's iterations differ from the cpu run's")
    counts = {v: sum(1 for vs in verdicts for x in vs if x == v) for v in Verdict}
    timed = gpu_ms[PREFILL_BATCHES:]
    checks = TIMED_BATCHES * TXNS * (READS_PER_TXN + 1)
    stats = on_gpu.kernel_stats()
    log(f"stream: {len(batches)} batches x {TXNS} txns identical on cuda and "
        f"cpu; verdicts {({k.name: n for k, n in counts.items()})}; "
        f"compactions={on_gpu.stats.compactions} node_count={on_gpu.node_count} "
        f"cap={on_gpu.capacity}")
    log(f"stream: resolve_batch ms on cuda ({power}), timed batches: "
        f"p50={float(np.percentile(timed, 50)):.3f} "
        f"p99={float(np.percentile(timed, 99)):.3f} max={max(timed):.3f} "
        f"(n={len(timed)}); checks/s={checks / (sum(timed) / 1e3):.1f}")
    log(f"stream: all batches: pack_ms={stats['pack_ms']:.3f} "
        f"h2d_ms={stats['h2d_ms']:.3f} resolve_ms={stats['resolve_ms']:.3f} "
        f"compact_ms={stats['phase']['compact_ms']:.3f} "
        f"resolve_arrays p50={stats['resolve_ms_p50']:.3f} "
        f"p99={stats['resolve_ms_p99']:.3f}; host syncs per batch "
        f"{syncs:.2f}; fixpoint iterations per batch {iters / len(batches):.3f} "
        f"(= the cpu run's)")
    log(f"stream: per-batch ms on cuda: {[round(x, 3) for x in gpu_ms]}")
    log(f"stream: cpu cross-check took {cpu_s:.1f} s")
    log(f"stream: launches {json.dumps(launches)}")
    check_path_launches(launches, len(batches), on_gpu.stats.compactions, "flat stream")
    require(syncs <= 2.0, f"flat stream: {syncs:.2f} host syncs a batch, more than 2")
    require(counts[Verdict.TOO_OLD] > 0, "the GC clamp never made a txn TOO_OLD")
    return launches, on_gpu, verdicts, iters


def check_path_launches(launches, n_batches: int, compactions: int, where: str) -> None:
    """The main path's kernels: K1 and K2 once a batch, K4 once a
    compaction, K3 once a run it folds (8 a compaction, more on a regrow);
    the referees never."""
    require(compactions == 2, f"{where}: {compactions} compactions, expected 2")
    need = {"probe_fused": n_batches, "intra_fixpoint": n_batches,
            "run_to_step": compactions, "intra_query": 0, "probe": 0}
    for name, n in need.items():
        require(launches[name] == n, f"{where}: {name} launched {launches[name]} times, not {n}")
    require(launches["compact_ranks"] >= 8 * compactions,
            f"{where}: compact_ranks launched {launches['compact_ranks']} times")


def same_state(a, b, where: str) -> None:
    """The two sets' exported states are equal, key by key."""
    sa, sb = a.export_state(), b.export_state()
    require(sa.keys() == sb.keys(), f"{where}: the state keys differ")
    for k in sa:
        require(np.array_equal(np.asarray(sa[k]), np.asarray(sb[k])),
                f"{where}: final state {k!r} differs")


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def launch_calls(events) -> int:
    return sum(e.count for e in events if e.key in LAUNCH_CALLS)


def sync_calls(events) -> int:
    return sum(e.count for e in events if "Synchronize" in e.key)


def busy_ms(torch, events) -> float:
    """Device time of a profile: the device-side records (the kernels)
    only, since an op's own record repeats the time of its kernels."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(_device_us(e) for e in events if e.device_type == cuda) / 1e3


def profile_phase(torch, fdb, on_gpu, batches, power):
    """A few more batches past the stream, twice from the same state: on
    the stream's cuda set with nothing attached (the wall time), and on a
    twin loaded from its exported state under torch.profiler (device time
    per op; the profiler's own start-up would swamp its wall clock).
    Gives the device's busy share of the wall time and the ops that take
    the most device and host time — the where-the-time-goes breakdown."""
    from torch.profiler import ProfilerActivity, profile

    twin = fdb["device"].DeviceConflictSet(**SET_ARGS, device="cuda")
    twin.load_state(on_gpu.export_state())
    walls, plain = [], []
    for version, txns in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain.append(on_gpu.resolve_batch(version, txns))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = [twin.resolve_batch(version, txns) for version, txns in batches]
        torch.cuda.synchronize()
    require(traced == plain, "the profiled twin's verdicts differ")
    events = prof.key_averages()
    busy = busy_ms(torch, events)
    wall_ms = sum(walls)
    log(f"profile: {len(batches)} batches (the first compacts 8 runs), wall "
        f"{[round(w, 3) for w in walls]} ms, device busy {busy:.3f} ms = "
        f"{100 * busy / wall_ms:.1f}% of {wall_ms:.3f} ms on {power}; "
        f"{launch_calls(events) / len(batches):.1f} launches and "
        f"{sync_calls(events) / len(batches):.2f} synchronize calls a batch")
    ours = {name: sum(_device_us(e) for e in events if _is_kernel(e.key, symbol)) / 1e3
            for name, _where, symbol in KERNELS}
    log(f"profile: the hand kernels' device ms {json.dumps(ours)} = "
        f"{100 * sum(ours.values()) / max(busy, 1e-9):.1f}% of device busy")
    for e in sorted(events, key=_device_us, reverse=True)[:12]:
        log(f"  device {_device_us(e) / 1e3:9.3f} ms  calls={e.count:6d}  {e.key[:70]}")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]:
        log(f"  host   {e.self_cpu_time_total / 1e3:9.3f} ms  calls={e.count:6d}  {e.key[:70]}")


# ---------------------------------------------------------------------------
# phase 6: the best-known layout (bench.py's BEST_KNOWN) in three modes


def gc_floor(index: int, version: int):
    """The stream's GC schedule: after batch `index` (1-based) the set
    drops versions below commit - GC_LAG, from GC_FROM_BATCH on."""
    return version - GC_LAG if index >= GC_FROM_BATCH else None


def drive(torch, fdb, mode: str, cs, batches, first: int):
    """Runs `batches` (numbered from `first` for the GC schedule) through
    `cs` in one mode and returns (verdicts per batch, wall ms per batch):

      sync      resolve_batch, the wall of each call ending in the verdicts;
      deferred  resolve_deferred, each handle waited one batch behind, as
                the resolver role's split-phase path does; a batch's wall
                is its iteration (dispatch it, wait the one before, GC);
      packer    a PipelinedPacker packs and stages (BatchStager, pinned
                memory, a side stream) up to two batches ahead on its
                thread, as bench.py's resolver-e2e stream does; each
                staged batch goes to resolve_arrays(sync=False), verdicts
                are read two batches behind, and one check_pipelined()
                ends the stream.  Packing needs the MVCC floor the set
                will have at dispatch, which the GC schedule gives.
    The last wait (and the check) is added to the last batch's wall."""
    tdev, pipeline, Verdict = fdb["device"], fdb["pipeline"], fdb["Verdict"]
    walls, out = [], []
    torch.cuda.synchronize()
    if mode == "sync":
        for i, (version, txns) in enumerate(batches, start=first):
            t0 = time.perf_counter()
            out.append(cs.resolve_batch(version, txns))
            walls.append((time.perf_counter() - t0) * 1e3)
            floor = gc_floor(i, version)
            if floor is not None:
                cs.remove_before(floor)
        return out, walls
    if mode == "deferred":
        prev = None
        for i, (version, txns) in enumerate(batches, start=first):
            t0 = time.perf_counter()
            h = cs.resolve_deferred(version, txns)
            if prev is not None:
                out.append(prev.wait())
            floor = gc_floor(i, version)
            if floor is not None:
                cs.remove_before(floor)
            prev = h
            walls.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        out.append(prev.wait())
        walls[-1] += (time.perf_counter() - t0) * 1e3
        return out, walls
    require(mode == "packer", f"unknown mode {mode}")
    floors, floor = [], cs.oldest_version
    for i, (version, _txns) in enumerate(batches, start=first):
        floors.append(floor)
        nxt = gc_floor(i, version)
        floor = floor if nxt is None else nxt
    arena = pipeline.PackArena(depth=6)

    def pack(item):
        txns, floor = item
        return tdev.pack_batch(txns, floor, lambda v: max(v - floor, 0),
                               SET_ARGS["max_key_bytes"], arena=arena,
                               stats=cs.stats)

    packer = pipeline.PipelinedPacker(pack, depth=2, stage=tdev.BatchStager("cuda"),
                                      stats=cs.stats)
    pending, submitted = [], 0

    def read(entry):
        verdict, n = entry
        codes = verdict[:n].cpu().numpy()
        out.append([Verdict(int(c)) for c in codes])

    try:
        for i, (version, txns) in enumerate(batches, start=first):
            t0 = time.perf_counter()
            while submitted < len(batches) and submitted <= i - first + 1:
                packer.submit((batches[submitted][1], floors[submitted]))
                submitted += 1
            staged = packer.get()
            require(cs._base == floors[i - first], "packed against a stale floor")
            pending.append((cs.resolve_arrays(version, *staged.take(), sync=False),
                            len(txns)))
            if len(pending) > 2:
                read(pending.pop(0))
            floor = gc_floor(i, version)
            if floor is not None:
                cs.remove_before(floor)
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        packer.close()
    t0 = time.perf_counter()
    for entry in pending:
        read(entry)
    cs.check_pipelined()
    walls[-1] += (time.perf_counter() - t0) * 1e3
    return out, walls


def best_known_phase(torch, fdb, batches, flat_verdicts, flat_iters, power):
    """Phase 6: the stream through DeviceConflictSet(lsm=True,
    search_impl="bucket") on "cpu" once, then on "cuda" in each mode of
    `drive`, twice, in TURNS, each turn on a fresh set: verdicts equal the
    flat run's and the cpu run's batch by batch, the final state (ks, vs,
    tab, bidx, runs) equals the cpu run's, no search fell back, and every
    kernel of the path launched.  Returns {mode: (the first turn's set,
    its launches, {"turns": [metrics per turn]})}."""
    tdev, kernels = fdb["device"], fdb["kernels"]
    t = time.perf_counter()
    on_cpu = tdev.DeviceConflictSet(**SET_ARGS, **BEST_KNOWN, device="cpu")
    cpu_verdicts = []
    for i, (version, txns) in enumerate(batches, start=1):
        cpu_verdicts.append(on_cpu.resolve_batch(version, txns))
        floor = gc_floor(i, version)
        if floor is not None:
            on_cpu.remove_before(floor)
    require(cpu_verdicts == flat_verdicts, "best-known cpu run differs from the flat run")
    require(on_cpu.fixpoint_iterations() == flat_iters,
            "best-known cpu run: the fixpoint's iterations differ from the flat run's")
    log(f"best-known: cpu reference run took {time.perf_counter() - t:.1f} s")
    checks = TIMED_BATCHES * TXNS * (READS_PER_TXN + 1)
    runs = {}
    for turn, mode in enumerate(TURNS, start=1):
        cs = tdev.DeviceConflictSet(**SET_ARGS, **BEST_KNOWN, device="cuda")
        kernels.reset_launches()
        got, walls = drive(torch, fdb, mode, cs, batches, 1)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        for i, (a, b) in enumerate(zip(got, flat_verdicts), start=1):
            require(a == b, f"best-known {mode}: batch {i} differs from the flat run")
        require(len(got) == len(batches), f"best-known {mode}: verdicts missing")
        same_state(cs, on_cpu, f"best-known {mode}")
        require(cs.search_fallbacks == 0, f"best-known {mode}: a search fell back")
        check_path_launches(launches, len(batches), cs.stats.compactions,
                            f"best-known {mode}")
        timed = walls[PREFILL_BATCHES:]
        stats = cs.kernel_stats()
        reads = len(batches) if mode == "packer" else 0  # the caller's own
        syncs = cs.host_syncs + reads
        iters = cs.fixpoint_iterations()
        require(iters == flat_iters,
                f"best-known {mode}: the fixpoint's iterations differ from the cpu run's")
        m = dict(checks_per_s=checks / (sum(timed) / 1e3),
                 p50_ms=float(np.percentile(timed, 50)),
                 p99_ms=float(np.percentile(timed, 99)), n=len(timed),
                 pack_ms=stats["pack_ms"],
                 encode_pad_ms=stats["encode_ms"] + stats["pad_ms"],
                 h2d_ms=stats["h2d_ms"],
                 syncs_per_batch=syncs / len(batches),
                 iters_per_batch=iters / len(batches))
        runs.setdefault(mode, (cs, launches, {"turns": []}))[2]["turns"].append(m)
        log(f"best-known {mode} (turn {turn}): {len(batches)} batches identical to the flat "
            f"run and the cpu run, final state equal; checks/s="
            f"{m['checks_per_s']:.1f} timed-batch ms p50={m['p50_ms']:.3f} "
            f"p99={m['p99_ms']:.3f} (n={m['n']}); all batches: pack_ms="
            f"{m['pack_ms']:.3f} encode+pad_ms={m['encode_pad_ms']:.3f} "
            f"h2d_ms={m['h2d_ms']:.3f} host syncs per batch="
            f"{m['syncs_per_batch']:.2f} fixpoint iterations per batch="
            f"{m['iters_per_batch']:.3f} (= the cpu run's); "
            f"compactions={cs.stats.compactions} on {power}")
        log(f"best-known {mode} (turn {turn}): per-batch ms {[round(w, 3) for w in walls]}")
        log(f"best-known {mode} (turn {turn}): launches {json.dumps(launches)}")
    return runs


def best_known_profile(torch, fdb, runs, batches, first: int, power):
    """Each mode's device-busy share: the few batches past the stream run
    in that mode on the mode's set with nothing attached (the wall), and
    on a twin loaded from its state under torch.profiler (device time)."""
    from torch.profiler import ProfilerActivity, profile

    for mode, (cs, _launches, m) in runs.items():
        twin = fdb["device"].DeviceConflictSet(**SET_ARGS, **BEST_KNOWN, device="cuda")
        twin.load_state(cs.export_state())
        plain, walls = drive(torch, fdb, mode, cs, batches, first)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced, _ = drive(torch, fdb, mode, twin, batches, first)
            torch.cuda.synchronize()
        require(traced == plain, f"best-known {mode}: the profiled twin differs")
        events = prof.key_averages()
        busy = busy_ms(torch, events)
        m["busy_share"] = busy / sum(walls)
        syncs, launches = sync_calls(events), launch_calls(events)
        m["launches_per_batch"] = launches / len(batches)
        log(f"best-known {mode} profile: {len(batches)} batches, wall "
            f"{[round(w, 3) for w in walls]} ms, device busy {busy:.3f} ms = "
            f"{100 * m['busy_share']:.1f}% on {power}; the profiler saw "
            f"{syncs} synchronize calls and {launches} kernel launches")


def referee_phase(torch, fdb, cs, version, txns):
    """The referees in their roles, on one batch against the live state of
    a best-known set (its runs, its cached table): K5, K1's unfused
    referee, and the per-query intra kernel in the host loop K2 replaced,
    held against K2 on the batch's history bits.  Nothing is written to
    the set.  Returns the referees' launches in this phase."""
    tdev, kernels = fdb["device"], fdb["kernels"]
    packed = tdev.pack_batch(txns, cs.oldest_version, cs._offset,
                             SET_ARGS["max_key_bytes"])
    rb, re_, r_tx, wb, we, w_tx, snap, active = tdev.stage_batch(cs.device, *packed[:8])
    kernels.reset_launches()
    g_lo, g_hi, conv = tdev.inc_search(cs._ks, cs._bidx, cs._count, rb, re_, r_tx)
    require(bool(conv), "referee batch: the bucketed search did not converge")
    r_ok = r_tx >= 0
    snap_r = snap[torch.clamp(r_tx, 0, snap.shape[0] - 1).long()]
    read_max = fdb["rmq"].query_sparse_table(cs._tab, g_lo, g_hi, torch.maximum, 0)
    hist_r = r_ok & (read_max > snap_r)
    runs = (cs._runs_b, cs._runs_e, cs._runs_ver)
    fused = kernels.probe_fused(rb, re_, snap_r, r_ok, *runs, hist_r)
    unfused = kernels.run_conflicts(rb, re_, snap_r, r_ok, *runs) | hist_r
    torch.cuda.synchronize()
    launches = kernels.launches["probe"]
    require(torch.equal(fused, unfused), "K5 | history disagrees with K1 on live state")
    require(launches > 0, "the referee never launched K5")
    log(f"referee: K5 | history == K1 on a live batch ({int(fused.sum())} of "
        f"{int(r_ok.sum())} live reads conflict; {cs._n_runs} live runs); "
        f"K5 launches {launches}")
    B = active.shape[0]
    r_idx = torch.clamp(r_tx, 0, B - 1).long()
    hist = torch.zeros(B, dtype=torch.int32, device=cs.device).index_add_(
        0, r_idx, (r_ok & fused).to(torch.int32)) > 0
    fx = (*tdev._intra_setup(rb, re_, wb, we), r_ok,
          (w_tx >= 0) & ~tdev._is_sentinel(wb), r_idx,
          torch.clamp(w_tx, 0, B - 1).long(), w_tx, active, hist, B)
    intra, n_iters = kernels.intra_fixpoint(*fx)
    loop_intra, loop_iters = kernels.intra_fixpoint_plain(*fx, query=kernels.intra_query)
    torch.cuda.synchronize()
    k2 = kernels.launches["intra_query"]
    require(torch.equal(intra, loop_intra) and int(n_iters) == int(loop_iters),
            "the per-query loop disagrees with K2 on a live batch")
    require(k2 == int(n_iters), "the referee loop did not launch the query once an iteration")
    log(f"referee: the per-query loop == K2 on the live batch ({int(hist.sum())} "
        f"history-conflicted, {int(intra.sum())} intra-conflicted txns, "
        f"{int(n_iters)} iterations); per-query launches {k2}")
    return {"probe": launches, "intra_query": k2}


def recovery_drill(fdb):
    """A deep 16-bit-prefix bucket on the card: 3000 point writes under
    "ZZ", benign batches until a compaction folds them into main, then
    probes whose bucketed search cannot converge — all through
    resolve_deferred.  The window must recover (the coverage site
    kernel.pipeline_recover) and match OracleConflictSet."""
    tdev, TxInfo = fdb["device"], fdb["TxInfo"]
    zz = [b"ZZ%04d" % i for i in range(3000)]
    stream = [(10, [TxInfo(0, [], [(k, k + b"\x00")]) for k in zz])]
    for v in (20, 30, 40):
        stream.append((v, [TxInfo(v - 5, [(b"b%d" % v, b"c")], [(b"d%d" % v, b"e")])]))
    probes = [(b"ZZ%04d" % i, b"ZZ%04d" % (i + 1)) for i in range(7, 3000, 97)]
    stream.append((50, [TxInfo(45, probes, [(b"q", b"q\x00")]),
                        TxInfo(45, [(b"ZZ0001", b"ZZ2999")], [])]))
    oracle = fdb["oracle"].OracleConflictSet()
    cs = tdev.DeviceConflictSet(**BEST_KNOWN, max_key_bytes=16, capacity=1 << 14,
                                run_slots=2, device="cuda")
    before = fdb["coverage"].hits("kernel.pipeline_recover")
    handles = [cs.resolve_deferred(v, t) for v, t in stream]
    for (v, t), h in zip(stream, handles):
        require(h.wait() == oracle.resolve_batch(v, t), f"recovery drill: batch {v} differs")
    recovered = fdb["coverage"].hits("kernel.pipeline_recover") - before
    require(recovered == 1, f"recovery drill: {recovered} recoveries, expected 1")
    require(cs.search_fallbacks >= 1, "recovery drill: the replay never fell back")
    log(f"recovery: deep bucket (3000 keys under one prefix) recovered once, "
        f"search_fallbacks={cs.search_fallbacks}, verdicts equal to the oracle")


def oracle_batches(TxInfo, rng, n_batches=24, txns=512):
    """Variable-length keys sharing prefixes, point and short ranges."""
    def raw(lo, hi, n):
        return rng.integers(lo, hi, size=n, dtype=np.uint8).tobytes()

    stems = [raw(97, 101, int(rng.integers(1, 9))) for _ in range(64)]

    def key():
        stem = stems[int(rng.integers(0, len(stems)))]
        return stem + raw(0, 256, int(rng.integers(0, 9)))

    def rng_range():
        k = key()
        if rng.random() < 0.7:
            return k, k + b"\x00"
        return k, k + raw(0, 256, int(rng.integers(1, 4)))

    out = []
    for version in range(1, n_batches + 1):
        out.append((version, [
            TxInfo(int(max(version - 1 - rng.integers(0, 6), 0)),
                   [rng_range() for _ in range(int(rng.integers(0, 4)))],
                   [rng_range() for _ in range(int(rng.integers(0, 3)))])
            for _ in range(txns)
        ]))
    return out


def oracle_phase(fdb, batches):
    cs = fdb["device"].DeviceConflictSet(capacity=1 << 10, device="cuda")
    oracle = fdb["oracle"].OracleConflictSet()
    for i, (version, txns) in enumerate(batches, start=1):
        require(cs.resolve_batch(version, txns) == oracle.resolve_batch(version, txns),
                f"oracle batch {i}: verdicts differ")
        if i % 5 == 0:
            cs.remove_before(version - 3)
            oracle.remove_before(version - 3)
    require(cs.capacity > 1 << 10, "main never regrew in the oracle stream")
    log(f"oracle: {len(batches)} batches x {len(batches[0][1])} txns identical "
        f"to OracleConflictSet; compactions={cs.stats.compactions} cap={cs.capacity}")


# ---------------------------------------------------------------------------
# phase 9: the supervised set (DeviceSupervisor over the best-known set)


class StepClock:
    """The supervisor's clock in the drill: `step` seconds a batch, so the
    retry backoff (0.05 s, then 0.1 s) elapses between batches and the
    re-probe interval (5 s) does not before the drill promotes by hand."""

    def __init__(self, step: float) -> None:
        self.t, self.step = 0.0, step

    def __call__(self) -> float:
        return self.t

    def tick(self) -> None:
        self.t += self.step


def supervised_set(fdb, natives: list, **kw):
    """DeviceSupervisor over the best-known set on "cuda", the port's native
    skip list as its CPU fallback; every native set it builds goes into
    `natives`."""
    def fallback(oldest=0):
        natives.append(fdb["native"].NativeConflictSet(oldest))
        return natives[-1]

    return fdb["supervisor"].DeviceSupervisor(
        lambda oldest=0: fdb["device"].DeviceConflictSet(
            oldest, **SET_ARGS, **BEST_KNOWN, device="cuda"),
        fallback_factory=fallback, **kw)


def served(natives: list) -> int:
    """Batches the native fallback sets resolved (record replays included)."""
    return sum(n.stats.batches for n in natives)


# bare and supervised in turns, so that drift over the call falls on both
SUPERVISED_TURNS = ("bare", "supervised", "supervised", "bare")


def supervised_phase(torch, fdb, batches, flat_verdicts, power):
    """Phase 9 (a): the stream through the supervised set, synchronous and
    then deferred (waited one behind), in SUPERVISED_TURNS with the bare
    best-known set, each turn on a fresh set: verdicts equal phase 4's
    batch by batch; every supervised turn healthy, 0 trips, 1 promotion,
    0 s degraded, the native set resolving the first batch only (the
    promotion's parity check) and every batch after it served from the
    card.  Returns {path: launches} (each mode's first supervised turn)."""
    kernels = fdb["kernels"]
    checks = TIMED_BATCHES * TXNS * (READS_PER_TXN + 1)
    out = {}
    for mode in ("sync", "deferred"):
        rates = {"bare": [], "supervised": []}
        for turn, kind in enumerate(SUPERVISED_TURNS, start=1):
            natives: list = []
            cs = (supervised_set(fdb, natives) if kind == "supervised" else
                  fdb["device"].DeviceConflictSet(**SET_ARGS, **BEST_KNOWN, device="cuda"))
            kernels.reset_launches()
            got, walls = drive(torch, fdb, mode, cs, batches, 1)
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
            where = f"{kind} {mode} (turn {turn})"
            for i, (a, b) in enumerate(zip(got, flat_verdicts), start=1):
                require(a == b, f"{where}: batch {i} differs from the flat run")
            require(len(got) == len(batches), f"{where}: verdicts missing")
            dev_set = cs
            if kind == "supervised":
                h = cs.health()
                require(h["state"] == "healthy" and h["serving"] == "device"
                        and h["trips"] == 0 and h["promotions"] == 1
                        and h["time_degraded_s"] == 0 and h["consecutive_failures"] == 0,
                        f"{where}: a degrade or a failure on the healthy run: {h}")
                require(served(natives) == 1 and cs._cpu is None,
                        f"{where}: the native set served {served(natives)} batches, "
                        f"not only the first batch's parity check")
                dev_set = cs._dev
                out.setdefault("supervised" if mode == "sync" else f"supervised_{mode}",
                               launches)
            check_path_launches(launches, len(batches), dev_set.stats.compactions, where)
            timed = walls[PREFILL_BATCHES:]
            rates[kind].append(checks / (sum(timed) / 1e3))
            log(f"{where}: {len(batches)} batches identical to the flat run"
                + (f"; health {json.dumps(h)}; the native set served 1 batch (the "
                   f"parity check)" if kind == "supervised" else "")
                + f"; checks/s={rates[kind][-1]:.1f} timed-batch ms "
                f"p50={float(np.percentile(timed, 50)):.3f} "
                f"p99={float(np.percentile(timed, 99)):.3f} on {power}")
            log(f"{where}: launches {json.dumps(launches)}")
            cs.close()
        bare, sup = (float(np.median(rates[k])) for k in ("bare", "supervised"))
        log(f"supervised {mode}: checks/s supervised {[round(r, 1) for r in rates['supervised']]}"
            f" bare {[round(r, 1) for r in rates['bare']]} (turns "
            f"{' '.join(SUPERVISED_TURNS)}); supervised / bare medians = {sup / bare:.3f}")
    return out


DRILL_LOST_AT = 10     # device.lost forced 3 times from this batch on
DRILL_PROMOTE_AT = 16  # force_promote() before this batch


def drill_phase(torch, fdb, batches, flat_verdicts, power):
    """Phase 9 (b): the port's buggify (seeded, only forced sites fire)
    loses the device 3 times from batch DRILL_LOST_AT on: one failed
    dispatch and two failed re-probes trip the breaker once, and the
    native set serves those batches and the ones after; force_promote()
    before batch DRILL_PROMOTE_AT rebuilds the set on the card from the
    committed-write record, the parity batch checks it, and the rest is
    served from the card.  Verdicts equal phase 4's throughout; the end
    state is healthy, 1 trip, 2 promotions.  Returns the path's launches."""
    kernels, buggify = fdb["kernels"], fdb["buggify"]
    natives: list = []
    clock = StepClock(0.5)
    sup = supervised_set(fdb, natives, clock=clock)
    buggify.enable(fdb["DeterministicRandom"](SEED), enable_prob=0.0)
    kernels.reset_launches()
    walls, replayed = {}, None
    try:
        for i, (version, txns) in enumerate(batches, start=1):
            clock.tick()
            if i == DRILL_LOST_AT:
                buggify.force("device.lost", 3)
            if i == DRILL_PROMOTE_AT:
                replayed = sup.health()["recorded_batches"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sup.force_promote()
                torch.cuda.synchronize()
                walls["force_promote"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            got = sup.resolve_batch(version, txns)
            torch.cuda.synchronize()
            walls[i] = (time.perf_counter() - t0) * 1e3
            require(got == flat_verdicts[i - 1], f"drill: batch {i} differs from the flat run")
            floor = gc_floor(i, version)
            if floor is not None:
                sup.remove_before(floor)
            h = sup.health()
            on_cpu = DRILL_LOST_AT <= i < DRILL_PROMOTE_AT
            require(h["serving"] == ("cpu" if on_cpu else "device"),
                    f"drill: batch {i} served from {h['serving']}")
            if i == DRILL_LOST_AT + 2:
                require(h["state"] == "degraded" and h["trips"] == 1,
                        f"drill: the breaker did not trip at batch {i}: {h}")
        census = buggify.census()
    finally:
        buggify.disable()
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    h = sup.health()
    require(h["state"] == "healthy" and h["trips"] == 1 and h["promotions"] == 2,
            f"drill: end state {h}")
    require(census["device.lost"]["fires"] == 3, f"drill: the buggify census {census}")
    on_card = (DRILL_LOST_AT - 1) + replayed + (len(batches) - DRILL_PROMOTE_AT + 1)
    require(launches["probe_fused"] == on_card,
            f"drill: K1 launched {launches['probe_fused']} times, not the "
            f"{on_card} batches resolved on the card (replay included)")
    n_cpu = DRILL_PROMOTE_AT - DRILL_LOST_AT
    log(f"drill: device.lost x3 from batch {DRILL_LOST_AT}: degraded at batch "
        f"{DRILL_LOST_AT + 2} (1 trip), the native set served batches "
        f"{DRILL_LOST_AT}-{DRILL_PROMOTE_AT - 1} and the parity batch "
        f"({served(natives)} native batches with its rebuild replays), "
        f"force_promote() replayed {replayed} recorded batches onto the card; "
        f"all {len(batches)} batches identical to the flat run; end health "
        f"{json.dumps(h)}")
    log(f"drill: time to degrade (the call that lost the device: CPU rebuild "
        f"from the record + the native resolve) {walls[DRILL_LOST_AT]:.3f} ms; "
        f"time to re-promote: force_promote() {walls['force_promote']:.3f} ms "
        f"(new set, record replay on the card) + the parity batch "
        f"{walls[DRILL_PROMOTE_AT]:.3f} ms (card and native); degraded batches "
        f"{[round(walls[i], 3) for i in range(DRILL_LOST_AT, DRILL_PROMOTE_AT)]} ms "
        f"({n_cpu} on the native set) on {power}")
    log(f"drill: launches {json.dumps(launches)}")
    sup.close()
    return launches


def watchdog_phase(torch, fdb, batches, flat_verdicts):
    """Phase 9 (c): four batches through a supervised set with the wall
    watchdog on (every device call on its worker thread): two through
    resolve_batch, two through resolve_deferred; and one batch staged by
    BatchStager on its side stream, taken and resolved on a watchdog's
    worker thread.  Verdicts equal phase 4's.  Returns the launches."""
    tdev, kernels, sup_mod = fdb["device"], fdb["kernels"], fdb["supervisor"]
    natives: list = []
    sup = supervised_set(fdb, natives)
    sup.enable_wall_watchdog()
    kernels.reset_launches()
    got, _ = drive(torch, fdb, "sync", sup, batches[:2], 1)
    more, _ = drive(torch, fdb, "deferred", sup, batches[2:4], 3)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    require(got + more == flat_verdicts[:4], "watchdog: verdicts differ from the flat run")
    worker = sup._watchdog._worker
    require(sup._watchdog.wall and worker is not None and worker.is_alive(),
            "watchdog: the wall watchdog's worker never ran")
    h = sup.health()
    require(h["state"] == "healthy" and h["serving"] == "device" and h["trips"] == 0,
            f"watchdog: {h}")
    require(launches["probe_fused"] == 4 and launches["intra_fixpoint"] == 4,
            f"watchdog: {launches}")
    sup.close()

    cs = tdev.DeviceConflictSet(**SET_ARGS, **BEST_KNOWN, device="cuda")
    version, txns = batches[0]
    packed = tdev.pack_batch(txns, 0, cs._offset, SET_ARGS["max_key_bytes"])
    staged = tdev.BatchStager("cuda")(packed)
    wd = sup_mod.Watchdog(60.0, wall=True)
    codes = wd.run(lambda: cs.resolve_arrays(version, *staged.take()))
    wd.close()
    require([fdb["Verdict"](int(c)) for c in codes[:len(txns)]] == flat_verdicts[0],
            "watchdog: a staged batch resolved on the worker thread differs")
    log(f"watchdog: 4 batches (2 sync, 2 deferred) on the wall watchdog's worker "
        f"thread and a BatchStager batch taken there, identical to the flat run; "
        f"health {json.dumps(h)}; launches {json.dumps(launches)}")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the port's headline bench


def bench_phase(fdb, power):
    """The port's bench at its full shape in this process: its JSON line
    (abort-set parity against the port's native set inside), then its
    numbers beside the card.  Returns the path's launches."""
    kernels, bench = fdb["kernels"], fdb["bench"]
    kernels.reset_launches()
    doc = bench.run("cuda")
    launches = dict(kernels.launches)
    print(json.dumps(doc), flush=True)
    k = doc["kernel"]
    require(k["parity_batches"] == bench.TIMED_BATCHES
            and k["e2e_parity_batches"] == bench.E2E_BATCHES + 2 and doc["value"] > 0,
            f"bench: {doc}")
    n_batches = (bench.PREFILL_BATCHES + bench.TIMED_BATCHES + bench.POST_BATCHES
                 + bench.E2E_BATCHES + 2)
    require(launches["probe_fused"] == n_batches and launches["intra_fixpoint"] == n_batches
            and launches["run_to_step"] >= 1 and launches["compact_ranks"] >= 8
            and launches["probe"] == 0 and launches["intra_query"] == 0,
            f"bench: launches {launches}")
    log(f"bench: native {k['native_checks_per_sec']:.1f} checks/s, card "
        f"{doc['value']:.1f} checks/s, vs_baseline {doc['vs_baseline']}, sync "
        f"p50 {k['resolve_ms_p50']} ms p99 {k['resolve_ms_p99']} ms, resolver e2e "
        f"{k['resolver_e2e_checks_per_sec']:.1f} checks/s; abort-set parity on "
        f"{k['parity_batches']} timed and {k['e2e_parity_batches']} e2e batches; "
        f"on {power}")
    log(f"bench: launches {json.dumps(launches)}")
    return launches


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "foundationdb_tpu_torch").is_dir():
        print("chip_smoke: the foundationdb_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from foundationdb_tpu_torch import bench, keys
    from foundationdb_tpu_torch.conflict import (
        _build, device, kernels, native, oracle, pipeline, supervisor)
    from foundationdb_tpu_torch.conflict.api import TxInfo, Verdict
    from foundationdb_tpu_torch.ops import rmq
    from foundationdb_tpu_torch.runtime import buggify, coverage
    from foundationdb_tpu_torch.runtime.core import DeterministicRandom

    fdb = dict(keys=keys, device=device, kernels=kernels, oracle=oracle,
               pipeline=pipeline, rmq=rmq, coverage=coverage, TxInfo=TxInfo,
               Verdict=Verdict, supervisor=supervisor, native=native,
               buggify=buggify, DeterministicRandom=DeterministicRandom,
               bench=bench)
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    power = card_power_line()
    log(f"device: {name} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(f"nvidia-smi: {power}")

    t = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t:.1f} s")
    W = keys.num_words(SET_ARGS["max_key_bytes"])
    smem = {SYMBOLS["probe_fused"]: kernels.plan_probe(
                SET_ARGS["run_slots"], SET_ARGS["run_capacity"], W).smem,
            SYMBOLS["compact_ranks"]: kernels.plan_ranks(W).smem}
    entry = None
    for line in _build.ptxas_report().splitlines():
        if "Compiling entry function" in line:
            entry = next((s for s in smem if s in line), None)
        if "ptxas" in line or "Used" in line or "spill" in line:
            extra = (f"  [+ {smem[entry]} B dynamic shared memory per block at "
                     f"phase 3's shapes]" if entry and "Used" in line else "")
            log("  " + line.strip() + extra)

    rng = np.random.default_rng(SEED)
    pool, succ = key_pool(rng)
    t = time.perf_counter()
    n_stream = PREFILL_BATCHES + TIMED_BATCHES
    batches = stream_batches(TxInfo, rng, pool, succ, n_stream + PROFILED_BATCHES)
    stream, extra = batches[:n_stream], batches[n_stream:]
    log(f"stream data: {time.perf_counter() - t:.1f} s")
    first = device.pack_batch(batches[0][1], 0, lambda v: v,
                              SET_ARGS["max_key_bytes"])

    t = time.perf_counter()
    results = kernel_phase(torch, fdb, dev, rng, pool, succ, first)
    log(f"kernels phase: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    launches, on_gpu, flat_verdicts, flat_iters = stream_phase(torch, fdb, stream, power)
    log(f"stream phase: {time.perf_counter() - t:.1f} s")
    profile_phase(torch, fdb, on_gpu, extra, power)

    t = time.perf_counter()
    runs = best_known_phase(torch, fdb, stream, flat_verdicts, flat_iters, power)
    referee_launches = referee_phase(torch, fdb, runs["sync"][0], *extra[0])
    best_known_profile(torch, fdb, runs, extra, n_stream + 1, power)
    log(f"best-known phase: {time.perf_counter() - t:.1f} s")
    log("best-known summary " + json.dumps(
        {mode: m for mode, (_cs, _l, m) in runs.items()}))

    t = time.perf_counter()
    recovery_drill(fdb)
    oracle_phase(fdb, oracle_batches(TxInfo, np.random.default_rng(SEED + 1)))
    log(f"recovery + oracle phases: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    supervised = supervised_phase(torch, fdb, stream, flat_verdicts, power)
    supervised["drill"] = drill_phase(torch, fdb, stream, flat_verdicts, power)
    supervised["watchdog"] = watchdog_phase(torch, fdb, stream, flat_verdicts)
    log(f"supervised phase: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    bench_launches = bench_phase(fdb, power)
    log(f"bench phase: {time.perf_counter() - t:.1f} s")

    log(f"total: {time.perf_counter() - t_start:.1f} s on {power}")
    by_path = {"flat": launches, "referee": referee_launches}
    by_path.update({f"best_{mode}": l for mode, (_cs, l, _m) in runs.items()})
    by_path.update(supervised, bench=bench_launches)
    path_launches = dict(launches, **referee_launches)
    timed = ("ms", "cold_ms", "warm_ms", "device_ms", "call_ms", "plain_ms",
             "bound_ms", "bound_by")
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=SOURCE, replaces=where,
             launches=path_launches[k], max_abs_err=results[k]["max_abs_err"],
             **{key: results[k][key] for key in timed}, library_ms=None,
             launches_by_path={p: n.get(k, 0) for p, n in by_path.items()})
        for k, where, _symbol in KERNELS
    ]}))
    print(power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
