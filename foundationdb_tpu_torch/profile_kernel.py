"""The conflict check's per-phase wall times on a synthetic stream.

    python -m foundationdb_tpu_torch.profile_kernel --phase            # the card
    python -m foundationdb_tpu_torch.profile_kernel --phase --device cpu
    python -m foundationdb_tpu_torch.profile_kernel --lex-less [--device cpu]

Port of the `--phase` mode of the root profile_kernel.py: a
DeviceConflictSet with `phase_timing=True` (search, check and append each
dispatched alone and waited out) resolves a stream of point-read /
point-write batches, and the split of the wall time over the phases (sort
= the search of main, scan = history + run probe + intra-batch fixpoint,
merge = the run append, compact = the deferred folds) is printed with the
pack split and the resolve latency.  The card's name and power limit come
first, as nvidia-smi reports them.  The stream's shape is set by
--batches, --txns and --cap.

`--lex-less` times the two forms of the row compare under the search
(ops/search.lex_less): a loop of elementwise ops a lane, and a decision
at the first lane that differs, at W = 5, 9, 17, 129 and 4097 lanes on
--rows rows; one JSON line a width, after the card's line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

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


def lex_less_by_lane(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b a lane at a time: 3 elementwise ops a lane."""
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    lt = torch.zeros(shape, dtype=torch.bool, device=a.device)
    eq = torch.ones(shape, dtype=torch.bool, device=a.device)
    for w in range(a.shape[-1]):
        aw, bw = a[..., w], b[..., w]
        lt = lt | (eq & (aw < bw))
        eq = eq & (aw == bw)
    return lt


def lex_less_first_lane(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b at the first lane that differs: a fixed number of ops."""
    a, b = torch.broadcast_tensors(a, b)
    first = (a != b).to(torch.uint8).argmax(-1, keepdim=True)
    return (a.gather(-1, first) < b.gather(-1, first)).squeeze(-1)


LEX_WIDTHS = (5, 9, 17, 129, 4097)


def time_lex_less(device, rows: int, reps: int = 20, seed: int = 5) -> list[dict]:
    """Median ms of each form at each of LEX_WIDTHS on [rows, W] int32
    pairs that share a prefix and differ at a random lane of their second
    half (a search's compares of keys behind a common prefix).  Both forms
    must give the same bits."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for W in LEX_WIDTHS:
        a = torch.randint(-2**31, 2**31 - 1, (rows, W), generator=gen, dtype=torch.int32)
        b = a.clone()
        lane = torch.randint(W // 2, W, (rows,), generator=gen)
        b[torch.arange(rows), lane] += torch.randint(-1, 2, (rows,), generator=gen,
                                                     dtype=torch.int32)
        a, b = a.to(device), b.to(device)
        want = lex_less_by_lane(a, b)
        if not torch.equal(want, lex_less_first_lane(a, b)):
            raise AssertionError(f"the two forms of lex_less disagree at W = {W}")
        row = {"W": W, "rows": rows}
        for name, fn in (("by_lane_ms", lex_less_by_lane),
                         ("first_lane_ms", lex_less_first_lane)):
            for _ in range(3):
                fn(a, b)
            times = []
            for _ in range(reps):
                if device.type == "cuda":
                    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    t0.record()
                    fn(a, b)
                    t1.record()
                    t1.synchronize()
                    times.append(t0.elapsed_time(t1))
                else:
                    t = time.perf_counter()
                    fn(a, b)
                    times.append((time.perf_counter() - t) * 1e3)
            row[name] = statistics.median(times)
        out.append(row)
    return out


def phase_main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m foundationdb_tpu_torch.profile_kernel",
                                 description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--phase", action="store_true",
                      help="the whole-check phase breakdown")
    mode.add_argument("--lex-less", action="store_true",
                      help="the two forms of the search's row compare, timed")
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--txns", type=int, default=512)
    ap.add_argument("--cap", type=int, default=1 << 15)
    ap.add_argument("--rows", type=int, default=4096, help="--lex-less: rows a width")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(f"card: {card_line(resolve_device(args.device))}", flush=True)
    if args.lex_less:
        for row in time_lex_less(resolve_device(args.device), args.rows):
            print(json.dumps(row), flush=True)
        return 0
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
