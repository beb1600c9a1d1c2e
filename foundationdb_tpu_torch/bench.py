"""Headline benchmark of the port: the resolver's conflict check on the
CUDA card against the native CPU skip list, with abort-set parity.

    python -m foundationdb_tpu_torch.bench     # needs one CUDA card

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
  * a synchronous pass over 6 more batches gives the per-batch p50/p99;
  * resolver end to end: 6 batches of TxInfo through PipelinedPacker +
    BatchStager into resolve_arrays(sync=False), host packing included;
    its verdicts, warm batches included, must equal the native set's on
    the same transactions, or the run exits non-zero.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"kernel"}: value is the card's checks/s, vs_baseline its speedup over the
native set on this host.  There is no fallback: without a card, or on any
failure, the run raises and exits non-zero without printing a result.
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
        cap: int = CAP, run_capacity: int = BEST_KNOWN["run_capacity"]) -> dict:
    """The whole bench on `device` (CUDA unless the caller asks for the
    CPU, where the check runs its plain torch versions: the tests' small
    shapes).  Returns the result document; raises on any failure, and
    SystemExit on a parity mismatch."""
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
    sync_ms = []
    for b in post:
        packed = device_pack(pool_words, b, tdev._bucket)
        t0 = time.perf_counter()
        cs.resolve_arrays(b["version"], *packed)
        sync_ms.append((time.perf_counter() - t0) * 1e3)
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


def main() -> None:
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
