"""Headline benchmark of the port: the resolver's conflict check on the
CUDA card against the native CPU skip list, with abort-set parity.

    python -m foundationdb_tpu_torch.bench     # needs one CUDA card
    python -m foundationdb_tpu_torch.bench --phase-profile {small,full,off}

The counterpart of the reference package's root `bench.py` headline path,
with the same stream and constants: history pre-populated to ~64K live
write ranges (8 untimed batches), then 16 timed batches of 8192
transactions, each 2 point reads + 1 point write of 16-byte keys uniform
over a pool of 2**20, snapshots uniform in the window.  Both backends
consume pre-packed arrays (the proxy->resolver wire format is packed, so
marshalling is not what is compared):

  * native: the skip list (native/conflictset.cpp) through the plugin
    seam's packed path, timed over the 16 batches;
  * device: the best-known layout (bucketed search, cached LSM history
    table, incremental runs; 8 run slots of 2**14) on the card.  The timed
    batches are staged on the card first; the 16 go through
    resolve_arrays(sync=False), closed by a synchronize and
    check_pipelined();
  * parity: every timed batch's verdicts equal the native set's, or the
    run exits non-zero;
  * a synchronous pass over 6 more batches gives the per-batch p50/p99,
    and, with phase timing on for those batches only, the per-phase split
    (`kernel.phase`: sort_ms, scan_ms, merge_ms, compact_ms);
  * `kernel.phase_profile`: phase_timings.collect() in this process (the
    truncation ladder, the LSM amortisation, the merge shootout), at its
    reduced shapes unless --phase-profile says full or off;
  * resolver end to end: 6 batches of TxInfo through PipelinedPacker +
    BatchStager into resolve_arrays(sync=False), host packing included;
    its verdicts, warm batches included, must equal the native set's on
    the same transactions, or the run exits non-zero.

Then the reference bench's three probes, as blocks of the same line:

  * page_cache: a cold and a warm full-range scan of one ssd-engine
    B-tree, with the file-level page cache on and off, counted in preads;
  * metrics_series: every ResolverMetrics sample of a fixed 200-commit
    workload on SimCluster(seed=5, n_resolvers=2), both resolvers on the
    port's default set on this device, with the kernels each launched;
  * commit_wire: codec encode/decode of a bench-class resolver batch and
    TLog push against protocol-4 pickle, and the frames per flush of a
    loopback-TCP burst.

The reference catches a probe's failure and drops its block ("additive
data"); here a probe that fails fails the run.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"page_cache", "kernel", "commit_wire", "metrics_series"}: value is the
card's checks/s, vs_baseline its speedup over the native set on this
host.  There is no fallback: without a card, or on any failure, the run
raises and exits non-zero without printing a result.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from . import keys as keymod
from .conflict import device as tdev
from .conflict.api import TxInfo
from .conflict.native import NativeConflictSet
from .conflict.pipeline import PackArena, PipelinedPacker

TXNS_PER_BATCH = 8192  # the BASELINE configs' 10K-class commit batches
READS_PER_TXN = 2
TIMED_BATCHES = 16
PREFILL_BATCHES = 8  # 8 * 8192 point writes ≈ 64K live ranges at t0
POST_BATCHES = 6
E2E_BATCHES = 6
KEY_BYTES = 16  # reference benchmark key width (performance.rst:14)
# 16-byte lanes: the [k, k+\x00) end key differs from its begin only in the
# length lane (the \x00 is zero padding), so 4 data words + length suffice
MAX_KEY_BYTES = 16
KEY_POOL = 1 << 20
WINDOW = PREFILL_BATCHES + TIMED_BATCHES + 2  # no GC mid-run: window covers it
CAP = 1 << 19
REC_CAP = 1 << 17  # LSM recent level: ~8 batches (2*8192 boundaries each)
SEED = 20260729
# the reference bench's BEST_KNOWN (search, merge, lsm, incremental) =
# (bucket, scatter, True, True); scatter folds and the incremental layout
# are the port's only ones
BEST_KNOWN = dict(search_impl="bucket", lsm=True, run_slots=8,
                  run_capacity=1 << 14)


def gen_pool(rng, n: int = KEY_POOL):
    return rng.integers(0, 256, size=(n, KEY_BYTES), dtype=np.uint8)


def gen_batch(rng, pool, version, txns: int = TXNS_PER_BATCH):
    """One batch as index arrays: reads[B, READS], writes[B], snaps[B]."""
    b = txns
    return dict(
        version=version,
        reads=rng.integers(0, pool.shape[0], size=(b, READS_PER_TXN)),
        writes=rng.integers(0, pool.shape[0], size=(b,)),
        snaps=np.maximum(version - 1 - rng.integers(0, WINDOW // 2, size=(b,)), 0).astype(np.int64),
    )


def device_pack(pool_words, batch, bucket):
    """resolve_arrays inputs from index arrays, fully vectorized (uint32
    word lanes in the keys.py layout)."""
    b = batch["writes"].shape[0]
    n_read, n_write = b * READS_PER_TXN, b
    R, Wn = bucket(2 * n_read) // 2, bucket(n_write)
    R = max(R, n_read)
    W = pool_words.shape[1]  # data words + length lane

    def keyed(idx, is_end):
        k = pool_words[idx.ravel()]
        if is_end:  # [k, k + b"\x00"): same words, length 17
            k = k.copy()
            k[:, -1] = KEY_BYTES + 1
        return k

    rbv = np.full((R, W), 0xFFFFFFFF, dtype=np.uint32)
    rev = np.full((R, W), 0xFFFFFFFF, dtype=np.uint32)
    rtv = np.full(R, -1, dtype=np.int32)
    rbv[:n_read] = keyed(batch["reads"], False)
    rev[:n_read] = keyed(batch["reads"], True)
    rtv[:n_read] = np.repeat(np.arange(b, dtype=np.int32), READS_PER_TXN)

    wbv = np.full((Wn, W), 0xFFFFFFFF, dtype=np.uint32)
    wev = np.full((Wn, W), 0xFFFFFFFF, dtype=np.uint32)
    wtv = np.full(Wn, -1, dtype=np.int32)
    wbv[:n_write] = keyed(batch["writes"], False)
    wev[:n_write] = keyed(batch["writes"], True)
    wtv[:n_write] = np.arange(b, dtype=np.int32)

    Bp = bucket(b)
    snap = np.zeros(Bp, dtype=np.int32)
    snap[:b] = batch["snaps"]
    active = np.zeros(Bp, dtype=bool)
    active[:b] = True
    return rbv, rev, rtv, wbv, wev, wtv, snap, active


def pool_to_words(pool):
    """uint8[P, 16] -> uint32[P, words+1] in the keys.py lane layout."""
    return keymod.encode_fixed(pool, MAX_KEY_BYTES)


def native_pack(pool, batch):
    """C-ABI arrays: per txn, reads (b,e)* then write (b,e); e = k+\\x00."""
    b = batch["writes"].shape[0]
    keys_per_txn = 2 * (READS_PER_TXN + 1)
    lens = np.tile(
        np.array([KEY_BYTES, KEY_BYTES + 1] * (READS_PER_TXN + 1), dtype=np.int64),
        b,
    )
    offsets = np.zeros(b * keys_per_txn + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    buf = np.zeros(offsets[-1], dtype=np.uint8)
    # txn t occupies a fixed-size slab; fill via strided views
    slab = KEY_BYTES * keys_per_txn + (READS_PER_TXN + 1)  # ends carry +1 byte
    view = buf.reshape(b, slab)
    pos = 0
    for r in range(READS_PER_TXN):
        k = pool[batch["reads"][:, r]]
        view[:, pos : pos + KEY_BYTES] = k
        pos += KEY_BYTES
        view[:, pos : pos + KEY_BYTES] = k
        pos += KEY_BYTES + 1  # trailing \x00 already zero
    k = pool[batch["writes"]]
    view[:, pos : pos + KEY_BYTES] = k
    pos += KEY_BYTES
    view[:, pos : pos + KEY_BYTES] = k
    return (
        batch["snaps"],
        np.full(b, READS_PER_TXN, dtype=np.int32),
        np.ones(b, dtype=np.int32),
        buf,
        offsets,
    )


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _check_parity(label: str, want, got) -> None:
    """Batch by batch, the native verdicts `want` against the card's `got`
    (padded tensors); SystemExit with the count of differing batches."""
    mismatches = 0
    for i, (nv, dv) in enumerate(zip(want, got, strict=True)):
        nv = np.asarray([int(x) for x in nv])
        dv = dv[: len(nv)].cpu().numpy()
        if not np.array_equal(nv, dv):
            mismatches += 1
            log(f"PARITY MISMATCH {label} batch {i} txns {np.nonzero(nv != dv)[0][:5]}")
    if mismatches:
        raise SystemExit(f"{label} abort-set parity FAILED in {mismatches} batches")
    log(f"{label} abort-set parity OK")


def _resolver_e2e(dev: torch.device, n_batches: int, n_txns: int, set_args: dict, *,
                  warm_batches: int = 2):
    """Steady-state TxInfo→verdict throughput through the PIPELINED input
    path — the resolver-e2e number, not the bare kernel: a PipelinedPacker
    packs and stages (BatchStager: pinned memory, a side stream) batch N+1
    on its thread while the card runs batch N's sync=False dispatch;
    verdicts are read two batches behind, and the deferred validity is
    checked once at the end.  After the timed window the same batches go
    through a native set, and every verdict must match.

    Returns (checks_per_sec, kernel_stats snapshot, batches checked):
    encode_ms/pad_ms/h2d_ms are the input pipeline's split for this
    stream.  Keys are 15 bytes so the [k, k+\\x00) end keys fit the
    bench's 16-byte lanes."""
    rng = np.random.default_rng(SEED + 1)
    cs = tdev.DeviceConflictSet(**set_args, device=dev)
    pool = rng.integers(0, 256, size=(1 << 16, MAX_KEY_BYTES - 1), dtype=np.uint8)
    keys = [bytes(pool[i]) for i in range(pool.shape[0])]

    def mk_batch(version):
        idx = rng.integers(0, len(keys), size=(n_txns, 3))
        return version, [
            TxInfo(
                max(version - 2, 0),
                [(keys[i], keys[i] + b"\x00"), (keys[j], keys[j] + b"\x00")],
                [(keys[k], keys[k] + b"\x00")],
            )
            for i, j, k in idx
        ]

    batches = [mk_batch(v) for v in range(1, warm_batches + n_batches + 1)]
    warm = [cs.resolve_batch(v, txns) for v, txns in batches[:warm_batches]]  # untimed
    # batch k+1 consumes batch k's state, so dispatches run in order; a
    # depth-6 arena + depth-2 packer backpressure + a 2-deep dispatch
    # window keeps every slot untouched until it has been staged
    arena = PackArena(depth=6)
    packer = PipelinedPacker(
        lambda item: tdev.pack_batch(
            item[1], cs.oldest_version, cs._offset, cs._max_key_bytes,
            arena=arena, stats=cs.stats, offset_array=cs._offset_array,
        )[:8],
        depth=2, stage=tdev.BatchStager(dev), stats=cs.stats,
    )
    timed = batches[warm_batches:]
    try:
        t0 = time.perf_counter()
        verdicts: list = []
        submitted = 0
        for i, (v, _txns) in enumerate(timed):
            while submitted < len(timed) and submitted <= i + 1:
                packer.submit(timed[submitted])
                submitted += 1
            staged = packer.get()
            if i >= 2:
                verdicts[i - 2] = verdicts[i - 2].cpu()
            verdicts.append(cs.resolve_arrays(v, *staged.take(), sync=False))
        verdicts = [v.cpu() for v in verdicts]
        cs.check_pipelined()
        dt = time.perf_counter() - t0
    finally:
        packer.close()
    nat = NativeConflictSet()
    try:
        want = [nat.resolve_batch(v, txns) for v, txns in batches]
    finally:
        nat.close()
    _check_parity("e2e", want, [torch.tensor([int(x) for x in w]) for w in warm] + verdicts)
    checks = n_batches * n_txns * (READS_PER_TXN + 1)
    return checks / dt, cs.kernel_stats(), len(batches)


def run(device=None, *, txns: int = TXNS_PER_BATCH, key_pool: int = KEY_POOL,
        cap: int = CAP, run_capacity: int = BEST_KNOWN["run_capacity"],
        phase_profile: str = "small") -> dict:
    """The whole bench on `device` (CUDA unless the caller asks for the
    CPU, where the check runs its plain torch versions: the tests' small
    shapes): the headline with its phase profile (`phase_profile`:
    "small", "full" or "off"), then the reference's three probes as blocks
    of the same document.  Raises on any failure, and SystemExit on a
    parity mismatch."""
    doc = run_headline(device, txns=txns, key_pool=key_pool, cap=cap,
                       run_capacity=run_capacity)
    if phase_profile != "off":
        doc["kernel"]["phase_profile"] = phase_profile_probe(device, phase_profile, txns)
    return dict(doc, page_cache=page_cache_probe(), commit_wire=commit_wire_probe(),
                metrics_series=metrics_series_probe(tdev.resolve_device(device)))


def phase_profile_probe(device=None, mode: str = "small",
                        txns: int = TXNS_PER_BATCH) -> dict:
    """The kernel.phase_profile block: phase_timings.collect() in this
    process ("small": the reduced shapes; "full": the reference's), with
    the bench's transactions a batch.  Raises when the report does not
    conform to PHASE_PROFILE_SCHEMA."""
    from . import phase_timings
    from .control.status import check_phase_profile

    if mode not in ("small", "full"):
        raise ValueError(f"phase_profile must be small, full or off, not {mode!r}")
    report = phase_timings.collect(small=mode == "small", device=device, txns=txns)
    problems = check_phase_profile(report)
    if problems:
        raise RuntimeError(f"phase profile does not conform: {problems}")
    return report


def run_headline(device=None, *, txns: int = TXNS_PER_BATCH, key_pool: int = KEY_POOL,
                 cap: int = CAP, run_capacity: int = BEST_KNOWN["run_capacity"]) -> dict:
    """The headline alone: the card's checks/s against the native set, with
    the timed and e2e abort-set parity checks and the kernel counters."""
    dev = tdev.resolve_device(device)
    rng = np.random.default_rng(SEED)
    pool = gen_pool(rng, key_pool)
    pool_words = pool_to_words(pool)
    versions = iter(range(1, 10_000))
    prefill = [gen_batch(rng, pool, next(versions), txns) for _ in range(PREFILL_BATCHES)]
    timed = [gen_batch(rng, pool, next(versions), txns) for _ in range(TIMED_BATCHES)]
    # resolved SYNC one by one after the headline timing: per-batch
    # resolve-time percentiles
    post = [gen_batch(rng, pool, next(versions), txns) for _ in range(POST_BATCHES)]
    total_checks = TIMED_BATCHES * txns * (READS_PER_TXN + 1)

    # ---------------- native baseline ----------------
    nat = NativeConflictSet()
    try:
        for b in prefill:
            nat.resolve_packed(b["version"], *native_pack(pool, b))
        packed_nat = [(b["version"], native_pack(pool, b)) for b in timed]
        t0 = time.perf_counter()
        nat_verdicts = [nat.resolve_packed(v, *args) for v, args in packed_nat]
        native_s = time.perf_counter() - t0
        live_ranges = nat.node_count // 2
    finally:
        nat.close()
    native_rate = total_checks / native_s
    log(f"native: {native_s * 1e3:.1f} ms for {total_checks} checks "
        f"({native_rate / 1e6:.2f} M checks/s), ~{live_ranges} live ranges "
        f"at timing start")

    # ---------------- device ----------------
    set_args = dict(BEST_KNOWN, max_key_bytes=MAX_KEY_BYTES, capacity=cap,
                    run_capacity=run_capacity)
    cs = tdev.DeviceConflictSet(**set_args, device=dev)
    for b in prefill:
        cs.resolve_arrays(b["version"], *device_pack(pool_words, b, tdev._bucket))
    # start the timed stream with empty run slots (compactions that fire
    # mid-stream are still timed — the honest amortized cost)
    cs._compact_runs()
    # the timed batches staged on the card first: the resolver's input is
    # already device-resident, so the window times the check alone
    staged = [(b["version"],
               tdev.stage_batch(dev, *device_pack(pool_words, b, tdev._bucket)))
              for b in timed]
    _synchronize(dev)
    t0 = time.perf_counter()
    dev_verdicts = [cs.resolve_arrays(v, *t, sync=False) for v, t in staged]
    _synchronize(dev)
    cs.check_pipelined()
    device_s = time.perf_counter() - t0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device[{name}]: {device_s * 1e3:.1f} ms "
        f"({total_checks / device_s / 1e6:.2f} M checks/s)")

    _check_parity("timed", nat_verdicts, dev_verdicts)

    # ---------------- per-batch latency ----------------
    # each post batch's wall alone, and with phase timing on for just these
    # batches, the per-phase sort/scan/merge split (each phase its own
    # dispatch, waited out; the timed stream above stayed fused)
    sync_ms = []
    cs._phase_timing = True
    for b in post:
        packed = device_pack(pool_words, b, tdev._bucket)
        t0 = time.perf_counter()
        cs.resolve_arrays(b["version"], *packed)
        sync_ms.append((time.perf_counter() - t0) * 1e3)
    cs._phase_timing = False
    snap = cs.kernel_stats()
    kernel = {
        "occupancy": round(snap["occupancy"], 4),
        "recompiles": snap["recompiles"],
        "search_fallbacks": snap["search_fallbacks"],
        "compactions": snap["compactions"],
        "node_count": snap["node_count"],
        "abort_rate": round(snap["abort_rate"], 4),
        "resolve_ms_p50": round(float(np.percentile(sync_ms, 50)), 2),
        "resolve_ms_p99": round(float(np.percentile(sync_ms, 99)), 2),
        "pipelined_ms_per_batch": round(device_s * 1e3 / len(timed), 2),
        "runs_appended": snap["runs_appended"],
        "full_merges": snap["full_merges"],
        "incremental": True,
        "probe_impl": "cuda" if dev.type == "cuda" else "plain",
        "merge_impl": snap["merge_impl"],
        "native_checks_per_sec": round(native_rate, 1),
        "parity_batches": len(timed),
        "phase": {k: round(v, 2) for k, v in snap["phase"].items()},
        "phase_backend": dev.type,
    }

    # ---------------- resolver e2e (input pipeline) ----------------
    e2e_rate, e2e, e2e_checked = _resolver_e2e(dev, E2E_BATCHES, txns, set_args)
    kernel["resolver_e2e_checks_per_sec"] = round(e2e_rate, 1)
    kernel["e2e_parity_batches"] = e2e_checked
    kernel["encode_ms"] = round(e2e["encode_ms"], 2)
    kernel["pad_ms"] = round(e2e["pad_ms"], 2)
    kernel["h2d_ms"] = round(e2e["h2d_ms"], 2)
    log(f"kernel counters: {kernel}")
    return {
        "metric": f"occ_conflict_checks_per_sec_{dev.type}_64k_live_ranges",
        "value": round(total_checks / device_s, 1),
        "unit": "checks/s",
        "vs_baseline": round(native_s / device_s, 3),
        "device": name,
        "kernel": kernel,
    }


# ---------------------------------------------------------------------------
# the reference bench's probes (bench.py:461-700), raising where it drops


def page_cache_probe(keys: int = 4000) -> dict:
    """The ssd engine's read path with the file-level page cache on vs off
    (storage/pagecache.py): build one B-tree, then a COLD full-range scan
    (fresh recover, pool cleared) and the same scan warm, counting the
    disk preads each needed.  Simulated reads are instant, so the pread
    COUNT is the measurable; the counters carry hit/miss/read-ahead
    attribution.  Host only, deterministic by seed."""
    from .runtime.core import DeterministicRandom, EventLoop
    from .storage.btree import BTreeKeyValueStore
    from .storage.files import SimFilesystem
    from .storage.pagecache import PageCachePool

    def scan_ops(fs, store) -> int:
        ops0 = sum(fs.disk(p).reads for p in ("pc.a", "pc.b", "pc.hdr"))
        rows = store.range_read(b"", b"\xff" * 8, 1 << 30)
        if len(rows) != keys:
            raise RuntimeError(f"page cache probe scanned {len(rows)} of {keys} rows")
        return sum(fs.disk(p).reads for p in ("pc.a", "pc.b", "pc.hdr")) - ops0

    def one(cache_on: bool) -> dict:
        loop = EventLoop()
        fs = SimFilesystem(loop, DeterministicRandom(5))
        if cache_on:
            fs.page_pool = PageCachePool(4096, 1 << 20, 8)
        store = BTreeKeyValueStore(fs, "pc", None, cache_bytes=1 << 14)

        async def build():
            for i in range(keys):
                store.set(b"k%06d" % i, b"v" * 64)
            await store.commit({})

        loop.run_until(loop.spawn(build()), 1e12)
        # a fresh process lifetime: parsed cache empty, pool cold
        if fs.page_pool is not None:
            fs.page_pool.clear()
        s2 = BTreeKeyValueStore.recover(fs, "pc", None, cache_bytes=1 << 14)
        cold = scan_ops(fs, s2)
        warm = scan_ops(fs, s2)
        out = {"cold_scan_preads": cold, "warm_scan_preads": warm}
        out.update(s2.page_cache_stats())
        return out

    on, off = one(True), one(False)
    return {
        "keys": keys,
        "cache_on": on,
        "cache_off": off,
        "cold_preads_saved": off["cold_scan_preads"] - on["cold_scan_preads"],
        "warm_preads_saved": off["warm_scan_preads"] - on["warm_scan_preads"],
    }


def metrics_series_probe(device=None, n_commits: int = 200) -> dict:
    """The periodic-metrics time series: a fixed sim commit workload with a
    fast METRICS_INTERVAL, returning every ResolverMetrics emission (rates
    per interval, the conflict backend's wall-ms deltas, the MVCC version
    floor over simulated time).  Both resolvers host the port's default
    set on `device` (CUDA unless the caller asks for the CPU);
    `kernel_launches` counts the kernels the run launched, K2's also by
    plan (kernels.launch_counts; none on the CPU, whose plain versions
    count nothing).  Raises when no sample
    came."""
    from .cluster import SimCluster
    from .conflict import kernels
    from .runtime.knobs import CoreKnobs

    knobs = CoreKnobs()
    knobs.METRICS_INTERVAL = 0.25
    launches0 = kernels.launch_counts()
    c = SimCluster(seed=5, n_resolvers=2, n_tlogs=1, knobs=knobs, device=device)
    try:
        db = c.database()

        async def drive():
            for i in range(n_commits):
                tr = db.create_transaction()
                tr.set(b"m%04d" % (i % 97), b"v%04d" % i)
                await tr.commit()

        c.run_until(c.loop.spawn(drive()), 120.0)
        series = [
            {
                "t": round(e["Time"], 4),
                "instance": e["Instance"],  # two resolvers interleave here
                "txns_per_sec": round(e["TxnsPerSec"], 1),
                "conflicts_per_sec": round(e["ConflictsPerSec"], 1),
                "version": e["Version"],
                "kernel_resolve_ms_delta": round(e["KernelResolveMsDelta"], 3),
            }
            for e in c.trace.find("ResolverMetrics")
        ]
    finally:
        c.stop()
    if not series:
        raise RuntimeError("metrics series probe: no ResolverMetrics sample")
    return {
        "interval_s": 0.25,
        "workload_commits": n_commits,
        "ResolverMetrics": series,
        "kernel_launches": {k: n - launches0.get(k, 0)
                            for k, n in kernels.launch_counts().items()},
    }


def commit_wire_probe(n_txns: int = 4096, reps: int = 5) -> dict:
    """The commit-plane wire path at bench shapes: codec encode/decode of
    ONE bench-class ResolveTransactionBatchRequest (n_txns txns x 2 point
    reads + 1 point write, 16-byte keys) and the matching
    TLogCommitRequest, best of `reps`, against protocol-4 pickle; then a
    loopback-TCP burst through two RealNetworks for the transport's
    frames per flush.  Host only."""
    import pickle

    from .roles.types import (
        Mutation,
        MutationType,
        ResolveTransactionBatchRequest,
        TLogCommitRequest,
    )
    from .runtime.metrics import WireStats
    from .runtime.serialize import decode_payload, encode_payload

    rng = np.random.default_rng(SEED + 7)
    pool = rng.integers(0, 256, size=(1 << 14, KEY_BYTES), dtype=np.uint8)
    keys = [bytes(pool[i]) for i in range(pool.shape[0])]
    idx = rng.integers(0, len(keys), size=(n_txns, 3))
    req = ResolveTransactionBatchRequest(9, 10, [
        TxInfo(
            5,
            [(keys[i], keys[i] + b"\x00"), (keys[j], keys[j] + b"\x00")],
            [(keys[k], keys[k] + b"\x00")],
        )
        for i, j, k in idx
    ])
    push = TLogCommitRequest(9, 10, {
        f"ss-{t}": [
            Mutation(MutationType.SET_VALUE, keys[i], b"v" * 16)
            for i in rng.integers(0, len(keys), size=n_txns // 4)
        ]
        for t in range(4)
    }, known_committed=8)

    def best(f):
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            f()
            out.append(time.perf_counter() - t0)
        return min(out)

    stats = WireStats()
    blobs = [(m, encode_payload(m, stats=stats)) for m in (req, push)]
    out = {"pickle_fallbacks": stats.pickle_fallbacks}
    enc_s = dec_s = pk_enc_s = pk_dec_s = 0.0
    nbytes = pk_bytes = 0
    for msg, blob in blobs:
        pk = pickle.dumps(msg, protocol=4)
        enc_s += best(lambda m=msg: encode_payload(m))
        dec_s += best(lambda b=blob: decode_payload(b))
        pk_enc_s += best(lambda m=msg: pickle.dumps(m, protocol=4))
        pk_dec_s += best(lambda b=pk: pickle.loads(b))
        nbytes += len(blob)
        pk_bytes += len(pk)
    out.update(
        encode_ms=round(enc_s * 1e3, 3),
        decode_ms=round(dec_s * 1e3, 3),
        bytes=nbytes,
        pickle_bytes=pk_bytes,
        vs_pickle_encode=round(pk_enc_s / enc_s, 2) if enc_s else 0.0,
        vs_pickle_decode=round(pk_dec_s / dec_s, 2) if dec_s else 0.0,
        txns=n_txns,
    )
    out.update(wire_flush_probe())
    return out


def wire_flush_probe(n_frames: int = 64) -> dict:
    """A burst of small resolver batches across two in-process
    RealNetworks (real loopback TCP): the sender's coalescing factor,
    frames per flushed write.  Raises if the burst does not arrive within
    10 s of wall time."""
    from .roles.types import ResolveTransactionBatchRequest
    from .rpc.stream import RequestStream, RequestStreamRef
    from .rpc.transport import RealNetwork, WallDriver
    from .runtime.core import EventLoop

    loop = EventLoop()
    a = RealNetwork(loop, name="bench-a")
    b = RealNetwork(loop, name="bench-b")
    try:
        rs = RequestStream(b.process, "wlt:sink")
        got = []

        async def sink():
            while True:
                got.append(await rs.next())

        loop.spawn(sink())
        ref = RequestStreamRef(a, a.process, rs.endpoint)
        msg = ResolveTransactionBatchRequest(
            1, 2, [TxInfo(1, [(b"k%04d" % i, b"k%04d\x00" % i)], []) for i in range(32)]
        )
        for _ in range(n_frames):
            ref.send(msg)  # one-way: the burst queues before any flush

        async def waiter():
            while len(got) < n_frames:
                await loop.delay(0.001)

        WallDriver(loop, [a.pump, b.pump]).run_until(
            loop.spawn(waiter()), wall_timeout=10.0)
        snap = a.wire.snapshot()
        return {
            "frames_per_flush": round(snap["frames_per_flush"], 1),
            "flushes": snap["flushes"],
        }
    finally:
        a.close()
        b.close()


def main(argv=()) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m foundationdb_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase-profile", choices=("small", "full", "off"), default="small",
                    help="the kernel.phase_profile block's shapes, or none")
    args = ap.parse_args(list(argv))
    print(json.dumps(run(phase_profile=args.phase_profile)))


if __name__ == "__main__":
    main(sys.argv[1:])
