"""The conflict check's per-phase wall times on a synthetic stream.

    python -m foundationdb_tpu_torch.profile_kernel --phase            # the card
    python -m foundationdb_tpu_torch.profile_kernel --phase --device cpu

Port of the `--phase` mode of the root profile_kernel.py: a
DeviceConflictSet with `phase_timing=True` (search, check and append each
dispatched alone and waited out) resolves a stream of point-read /
point-write batches, and the split of the wall time over the phases (sort
= the search of main, scan = history + run probe + intra-batch fixpoint,
merge = the run append, compact = the deferred folds) is printed with the
pack split and the resolve latency.  The card's name and power limit come
first, as nvidia-smi reports them.  The stream's shape is set by
--batches, --txns and --cap.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np

from .conflict.api import TxInfo
from .conflict.device import DeviceConflictSet, resolve_device


def drive_phase_stream(n_batches: int, n_txns: int, cap: int,
                       run_slots: int = 4, seed: int = 11, *, device=None):
    """The synthetic stream with phase timing on: 8-byte keys, 2 point
    reads and 1 point write a txn, snapshots 2 versions back (the same
    draws as the root profile_kernel.py's, so the same batches).  Returns
    (the set, its kernel_stats snapshot)."""
    rng = np.random.default_rng(seed)
    dev = DeviceConflictSet(capacity=cap, run_slots=run_slots,
                            phase_timing=True, device=device)
    version = 0
    for _ in range(n_batches):
        version += 1
        txns = []
        for _ in range(n_txns):
            ks = [rng.bytes(8) for _ in range(3)]
            txns.append(TxInfo(max(version - 2, 0),
                               [(k, k + b"\x00") for k in ks[:2]],
                               [(ks[2], ks[2] + b"\x00")]))
        dev.resolve_batch(version, txns)
    return dev, dev.kernel_stats()


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi reports them (or the
    device's name where nvidia-smi is not there)."""
    if device.type != "cuda":
        return str(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        import torch

        return f"{torch.cuda.get_device_name(device)} (power limit unknown)"


def phase_main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m foundationdb_tpu_torch.profile_kernel",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", action="store_true", required=True,
                    help="the whole-check phase breakdown (the only mode ported)")
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--txns", type=int, default=512)
    ap.add_argument("--cap", type=int, default=1 << 15)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(f"card: {card_line(resolve_device(args.device))}", flush=True)
    dev, snap = drive_phase_stream(args.batches, args.txns, args.cap,
                                   device=args.device)
    print(f"device: {dev.device}  incremental: {dev._incremental}  "
          f"cap: {args.cap}")
    phase = snap["phase"]
    total = sum(phase.values()) or 1.0
    print(f"\n{args.batches} batches x {args.txns} txns "
          f"(runs_appended={snap['runs_appended']} "
          f"compactions={snap['compactions']} "
          f"full_merges={snap['full_merges']}):")
    for name in ("sort_ms", "scan_ms", "merge_ms", "compact_ms"):
        ms = phase[name]
        print(f"  {name:<12s} {ms:9.2f} ms  {100 * ms / total:5.1f}%")
    print(f"  {'pack_ms':<12s} {snap['pack_ms']:9.2f} ms  "
          f"(encode {snap['encode_ms']:.2f} + pad {snap['pad_ms']:.2f} + "
          f"h2d {snap['h2d_ms']:.2f})")
    print(f"  resolve p50 {snap['resolve_ms_p50']:.2f} ms  "
          f"p99 {snap['resolve_ms_p99']:.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(phase_main())
