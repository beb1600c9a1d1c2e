"""Driver entry points on the card: the single-resolver check, and the
multi-resolver dry run.

    python -m foundationdb_tpu_torch.graft_entry              # the card(s)
    python -m foundationdb_tpu_torch.graft_entry --device cpu

Port of the repository root's __graft_entry__.py.  The flagship
computation is the batched OCC conflict check (conflict/device.py
resolve_core), the replacement for the reference Resolver's SkipList
ConflictSet (fdbserver/SkipList.cpp detectConflicts).  The distributed
step is the multi-resolver form (parallel/sharded.py): key-space
partitions, the batch clipped to each, verdicts min-combined on the first
partition's device, the analog of the proxy's fan-out to N resolvers and
its min-combine (fdbserver/MasterProxyServer.actor.cpp:280-320, :558-569).

`entry()` returns resolve_core with its static sizes bound and the
tensors of a crafted batch; `dryrun_multichip(n)` drives every layout of
the sharded set over n partitions, then a bench-class run.  The partitions
go on the CUDA cards there are, round-robin through the set's `devices=`
(on one card, all of them on it); there is no mesh and no virtual device.
The device is CUDA unless the caller asks for the CPU, and nothing falls
back.
"""

from __future__ import annotations

import argparse
import functools
import sys

import numpy as np
import torch

from . import keys as keymod
from .conflict import device as D
from .conflict.api import TxInfo, Verdict
from .parallel.sharded import ShardedDeviceConflictSet

_MAX_KEY_BYTES = 16  # the reference benchmark's key width (performance.rst:14)
# (lsm, merge_impl, incremental): the incremental run-append layout over
# flat and LSM main levels, and the legacy per-batch merges
LAYOUTS = ((False, "sort", True), (True, "sort", True), (False, "sort", False),
           (True, "sort", False), (True, "gather", False))


def _check(cond: bool, what) -> None:
    if not cond:
        raise AssertionError(what)


def _example_batch(device, cap: int = 256, n_txn: int = 16):
    """A tiny but non-trivial batch: a state with two committed ranges,
    reads that hit and miss them, and an intra-batch write/read collision.
    Returns (resolve_core's positional tensors, its static sizes)."""
    W = keymod.num_words(_MAX_KEY_BYTES)
    ks = np.full((cap, W), D._SENT_WORD, dtype=np.uint32)
    boundary_keys = [b"", b"b", b"c", b"m", b"n"]
    ks[: len(boundary_keys)] = keymod.encode_keys(boundary_keys, _MAX_KEY_BYTES)
    vs = np.zeros(cap, dtype=np.int32)
    vs[1], vs[3] = 80, 90  # [b,c) written @80, [m,n) @90

    txns = [
        TxInfo(70, [(b"b", b"b0")], [(b"q", b"r")]),   # history conflict
        TxInfo(85, [(b"m", b"z")], []),                # history conflict @90
        TxInfo(85, [(b"c", b"d")], [(b"e", b"f")]),    # commits
        TxInfo(85, [(b"e", b"e0")], []),               # intra-batch conflict
    ] + [
        TxInfo(85, [(bytes([65 + i]) * 2, bytes([65 + i]) * 3)], [])
        for i in range(n_txn - 4)
    ]
    packed = D.pack_batch(txns, 0, lambda v: v, _MAX_KEY_BYTES)
    Bp = packed[8]

    def i32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.int32), device=device)

    args = (keymod.to_lanes(ks, device), i32(vs), i32(D.host_bucket_index(ks)),
            i32(len(boundary_keys)), *D.stage_batch(device, *packed[:8]), i32(100))
    return args, dict(cap=cap, n_txn=Bp)


def entry(device=None):
    """(function, example args): one resolver conflict-check step,
    resolve_core with its sizes bound, and the crafted batch on `device`."""
    args, dims = _example_batch(D.resolve_device(device))
    return functools.partial(D.resolve_core, **dims), args


def _devices(device) -> list:
    """Where the partitions go: every CUDA card, or the one device asked."""
    dev = D.resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def _synchronize(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def dryrun_multichip(n_partitions: int, device=None) -> None:
    """Drive the multi-resolver set over `n_partitions` key-space
    partitions in every layout: one write across every partition, then a
    read in each (each must conflict), GC and a TOO_OLD read, and the
    deferred fold (incremental) or the recent level's fold (legacy LSM).
    Then the bench-class run.  Raises on any wrong verdict."""
    devices = _devices(device)
    n = n_partitions
    splits = [bytes([i]) for i in range(1, n)]
    for lsm, merge, inc in LAYOUTS:
        cs = ShardedDeviceConflictSet(
            splits, max_key_bytes=_MAX_KEY_BYTES, capacity=256, lsm=lsm,
            recent_capacity=128, merge_impl=merge, incremental=inc, run_slots=2,
            run_capacity=64, devices=devices)
        got = cs.resolve_batch(10, [TxInfo(0, [], [(b"\x00", bytes([n]))])])
        _check(got == [Verdict.COMMITTED], got)
        reads = [TxInfo(5, [(bytes([i, 0x80]), bytes([i, 0x81]))], []) for i in range(n)]
        got = cs.resolve_batch(20, reads)
        _check(got == [Verdict.CONFLICT] * n, got)
        cs.remove_before(15)
        got = cs.resolve_batch(30, [TxInfo(12, [], [])])
        _check(got[0] == Verdict.TOO_OLD, got)
        if inc or lsm:
            if inc:
                cs._compact_runs()  # the sharded deferred fold
            else:
                cs._compact()  # the recent levels folded into main
            got = cs.resolve_batch(40, [TxInfo(35, [], [(b"q", b"r")])])
            _check(got == [Verdict.COMMITTED], got)
        _synchronize(devices)
    _dryrun_bench_class(n, devices)


def _dryrun_bench_class(n: int, devices) -> None:
    """Bench-class shapes over the partitions: main 2**16 rows a
    partition, a recent level of 2**17, three 256-transaction batches
    through the default incremental LSM layout, packed by the bulk path
    and dispatched split-phase (resolve_deferred).  Every key is fresh, so
    every transaction must commit.  The shape line is printed so a log
    records what was driven."""
    cap, rec_cap, n_txn, n_batches = 1 << 16, 1 << 17, 256, 3
    print(
        f"[multichip] bench-class dryrun: devices={n} cap={cap} "
        f"rec_cap={rec_cap} txns_per_batch={n_txn} batches={n_batches} "
        f"reads_per_txn=2 writes_per_txn=1 layout=incremental+lsm "
        f"dispatch=split-phase",
        flush=True,
    )
    splits = [bytes([256 * i // n]) for i in range(1, n)]
    cs = ShardedDeviceConflictSet(
        splits, max_key_bytes=_MAX_KEY_BYTES, capacity=cap, lsm=True,
        recent_capacity=rec_cap, incremental=True, run_slots=4,
        run_capacity=1 << 12, devices=devices)
    rng = np.random.default_rng(0xA7)
    pool = rng.integers(0, 256, size=(1 << 12, _MAX_KEY_BYTES - 1), dtype=np.uint8)
    keys = [bytes(pool[i]) for i in range(pool.shape[0])]
    # distinct keys across the whole stream: no intra- or cross-batch
    # collision, so the all-commit check below is exact
    picks = iter(rng.permutation(len(keys)))
    version = 100
    handles = []
    for _ in range(n_batches):
        version += 10
        idx = np.array([[next(picks) for _ in range(3)] for _ in range(n_txn)])
        txns = [
            TxInfo(
                version - 5,
                [(keys[i], keys[i] + b"\x00"), (keys[j], keys[j] + b"\x00")],
                [(keys[k], keys[k] + b"\x00")],
            )
            for i, j, k in idx
        ]
        handles.append(cs.resolve_deferred(version, txns))
    verdict_sets = [h.wait() for h in handles]
    _check(all(len(v) == n_txn for v in verdict_sets), [len(v) for v in verdict_sets])
    _check(all(v == Verdict.COMMITTED for vs in verdict_sets for v in vs),
           "a transaction of fresh keys did not commit")
    cs._compact_runs()  # the deferred fold at bench-class capacity
    _synchronize(devices)
    print(
        f"[multichip] bench-class dryrun OK: compactions={cs.compactions} "
        f"pack encode_ms={cs.stats.encode_s * 1e3:.1f} "
        f"pad_ms={cs.stats.pad_s * 1e3:.1f}",
        flush=True,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m foundationdb_tpu_torch.graft_entry",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print("entry OK:", [tuple(o.shape) for o in out])
    n = max(4, len(_devices(args.device)))
    dryrun_multichip(n, args.device)
    print(f"dryrun_multichip({n}) OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
