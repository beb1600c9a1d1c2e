"""The conflict check's primitives and per-phase wall times on the card.

    python -m foundationdb_tpu_torch.profile_kernel                    # the card
    python -m foundationdb_tpu_torch.profile_kernel --phase [--device cpu]
    python -m foundationdb_tpu_torch.profile_kernel --lex-less [--device cpu]

Port of the root profile_kernel.py.  With no mode it prints the primitive
table of its `main`: each primitive of resolve_core at the bench's shapes
(CAP = 2**19, R = 16384, Wn = 8192, W = 5, M = CAP + 2 Wn), in the
reference's order and with its labels, then the whole legacy resolve.  The
rows are data (PRIMITIVES: label, function, the arguments it takes from
the seeded inputs), so their outputs can be held against the reference's.
A row's time is the median of 5 runs after a warm-up, CUDA events around
each on the card (the host clock on the CPU), less the same clock's floor
around one trivial launch (the reference subtracts a tunnel round trip).
`Timer` is that clock; profile2.py times its rows with it too.

`--phase` ports the reference's mode of that name: a
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
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from .conflict import device as D
from .conflict.api import TxInfo
from .conflict.device import DeviceConflictSet, resolve_device
from .keys import SENT_LANE, to_lanes
from .ops.rmq import I32_MAX, build_sparse_table, query_sparse_table
from .ops.search import lexsort


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


# ---------------------------------------------------------------------------
# the primitive table (the reference's `main`)


class Timer:
    """A row's clock: on the card CUDA events around each run, on the CPU
    the host clock; the median of `n` runs after one warm-up, less the
    same clock's floor around one trivial launch (median of 7)."""

    def __init__(self, device) -> None:
        self.device = device
        self.floor_ms = 0.0
        one = torch.ones(8, dtype=torch.int32, device=device)
        self.floor_ms = self.ms(torch.add, one, 1, n=7)

    def ms(self, fn, *args, n: int = 5) -> float:
        fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            pairs = []
            for _ in range(n):
                t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0.record()
                fn(*args)
                t1.record()
                pairs.append((t0, t1))
            torch.cuda.synchronize(self.device)
            times = [a.elapsed_time(b) for a, b in pairs]
        else:
            times = []
            for _ in range(n):
                t = time.perf_counter()
                fn(*args)
                times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times) - self.floor_ms

    def one(self, name: str, fn, *args, n: int = 5) -> float:
        """Time one row and print it as the reference's bench_one does."""
        ms = self.ms(fn, *args, n=n)
        print(f"  {name:<42s} {ms:9.2f} ms", flush=True)
        return ms


class Shapes(NamedTuple):
    cap: int  # main's rows
    R: int    # reads
    Wn: int   # writes
    W: int    # lanes a key
    B: int    # transactions

    @property
    def M(self) -> int:  # the merged domain: main plus a batch's endpoints
        return self.cap + 2 * self.Wn


TABLE_SHAPES = Shapes(cap=1 << 19, R=16384, Wn=8192, W=5, B=8192)
KEY_ROWS = ("ks_rows", "q_rows", "scat_rows", "mrows")  # uint32 lane rows


def primitive_arrays(s: Shapes = TABLE_SHAPES, seed: int = 7) -> dict:
    """The reference table's inputs as numpy, drawn from its seed in its
    order (key rows in the uint32 layout).  bucket_idx spreads main over
    the 65536 buckets evenly: the reference's arange * (CAP // 65536) at
    its CAP, and not all zero at a test's smaller one."""
    rng = np.random.default_rng(seed)
    cap, R, Wn, W, B, M = s.cap, s.R, s.Wn, s.W, s.B, s.M

    def words(*shape):
        return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)

    def ints(lo, hi, n):
        return rng.integers(lo, hi, size=(n,), dtype=np.int64).astype(np.int32)

    a = {}
    words(cap)  # the reference's sorted 1-lane keys, which no row reads
    a["ks_rows"] = words(cap, W)
    a["vs"] = ints(0, 1 << 20, cap)
    a["q_rows"] = words(2 * R + 2 * Wn, W)
    a["bidx"] = (np.arange(65537, dtype=np.int64) * cap // 65536).astype(np.int32)
    a["scat_idx"] = np.sort(rng.choice(M, size=2 * Wn, replace=False)).astype(np.int32)
    a["scat_rows"] = words(2 * Wn, W)
    a["pos_old"] = (np.arange(cap) + np.linspace(0, 2 * Wn, cap).astype(np.int64)
                    ).astype(np.int32)
    a["gidx"] = ints(0, cap, M)
    a["g_lo"] = ints(0, cap - 1, R)
    a["g_hi"] = np.minimum(a["g_lo"] + ints(1, 3, R), cap - 1)
    a["rb_r"] = ints(0, 2 * (R + Wn), R)
    a["re_r"] = a["rb_r"] + 1
    a["wb_r"] = ints(0, 2 * (R + Wn), Wn)
    a["we_r"] = a["wb_r"] + 1
    a["w_cand"] = ints(0, B, Wn)
    a["keep"] = rng.random(M) < 0.5
    a["mrows"] = words(M, W)
    a["argsort_x"] = ints(0, M, 2 * Wn)
    a["sort_k"] = ints(0, 2**31, M)
    a["sort_p"] = np.arange(M, dtype=np.int32)
    # the whole resolve's batch: q_rows are its reads' and writes' endpoints
    a["r_tx"] = np.repeat(np.arange(B, dtype=np.int32), 2)
    a["w_tx"] = np.arange(B, dtype=np.int32)
    a["snap"] = np.zeros(B, dtype=np.int32)
    a["active"] = np.ones(B, dtype=bool)
    return a


def primitive_inputs(a: dict, s: Shapes, device) -> SimpleNamespace:
    """The arrays on `device` (key rows as flipped lanes), with what the
    reference builds before its rows: the sparse table of vs and the
    buckets of main's first lane."""
    x = {k: to_lanes(v, device) if k in KEY_ROWS else torch.from_numpy(v).to(device)
         for k, v in a.items()}
    x["tbl"] = build_sparse_table(x["vs"], torch.maximum, 0)
    x["h_all"] = D._bucket_of(x["ks_rows"][:, 0])
    return SimpleNamespace(**x, cap=s.cap, M=s.M)


def _p2_iter(rb_r, re_r, wb_r, we_r, w_cand):
    """One iteration of the dense intra referee: an R x Wn masked min."""
    ov = (wb_r[None, :] < re_r[:, None]) & (rb_r[:, None] < we_r[None, :])
    return torch.where(ov, w_cand[None, :], I32_MAX).amin(dim=1)


def _scatter_add_drop(m: int, idx):
    """jnp.zeros(m).at[idx].add(1, mode="drop"): a spare slot takes what
    lands past the end."""
    out = torch.zeros(m + 1, dtype=torch.int32, device=idx.device)
    return out.index_add_(0, torch.clamp(idx, max=m).long(), torch.ones_like(idx))[:m]


def _both_scatters(m: int, pos_old, ks_rows, pos_new, rows):
    merged = D._spare(m, SENT_LANE, ks_rows)
    return D._put(D._put(merged, pos_old, ks_rows), pos_new, rows)[:m]


def _compaction_scatter(cap: int, keep, rows):
    pos = torch.where(keep, D._cumsum32(keep.to(torch.int32)) - 1, keep.shape[0])
    return D._set_rows(cap, SENT_LANE, pos, rows)


def sort_payload(*cols):
    """lax.sort of (key..., payload) with num_keys = len(cols) - 1: stable,
    the payload following its keys."""
    perm = (torch.sort(cols[0], stable=True).indices if len(cols) == 2
            else lexsort(list(cols[:-1])))
    return tuple(c[perm] for c in cols)


def _histogram(h):
    """The bucket index's rebuild: a scatter-add of main's rows into 65537
    bins, then a cumsum."""
    hist = torch.zeros(D.N_BUCKETS + 1, dtype=torch.int32, device=h.device)
    return D._cumsum32(hist.index_add_(0, (h + 1).long(), torch.ones_like(h)))


def _whole(ks_rows, vs, bidx, q_rows, r_tx, w_tx, snap, active):
    """resolve_core at the table's shapes: main of random rows with the
    first half live, the query rows as the batch's endpoints."""
    cap, R, Wn = ks_rows.shape[0], r_tx.shape[0], w_tx.shape[0]
    return D.resolve_core(
        ks_rows, vs, bidx, cap // 2, q_rows[:R], q_rows[R:2 * R], r_tx,
        q_rows[2 * R:2 * R + Wn], q_rows[2 * R + Wn:], w_tx, snap, active, 1 << 20,
        cap=cap, n_txn=snap.shape[0])


WHOLE = "WHOLE resolve_core kernel"
# (label, function, its arguments from primitive_inputs), the reference's rows
PRIMITIVES = (
    ("search: bucketed_lower_bound 49K q, 11 it",
     lambda k, bi, cap, q: D._bucketed_lower_bound(k, bi, cap, q, 11)[0],
     lambda x: (x.ks_rows, x.bidx, x.cap, x.q_rows)),
    ("p1: build_sparse_table over CAP",
     lambda v: build_sparse_table(v, torch.maximum, 0), lambda x: (x.vs,)),
    ("p1: query_sparse_table 16K ranges",
     lambda t, lo, hi: query_sparse_table(t, lo, hi, torch.maximum, 0),
     lambda x: (x.tbl, x.g_lo, x.g_hi)),
    ("p2: one R x Wn masked-min iteration", _p2_iter,
     lambda x: (x.rb_r, x.re_r, x.wb_r, x.we_r, x.w_cand)),
    ("p3: row scatter 16K rows into M",
     lambda m, idx, rows: D._set_rows(m, SENT_LANE, idx, rows),
     lambda x: (x.M, x.scat_idx, x.scat_rows)),
    ("p3: row scatter CAP rows into M (pos_old)",
     lambda m, idx, rows: D._set_rows(m, SENT_LANE, idx, rows),
     lambda x: (x.M, x.pos_old, x.ks_rows)),
    ("p3: BOTH merge scatters (old+new)", _both_scatters,
     lambda x: (x.M, x.pos_old, x.ks_rows, x.scat_idx, x.scat_rows)),
    ("p3: scalar scatter-add 16K into M", _scatter_add_drop,
     lambda x: (x.M, x.scat_idx)),
    ("p3: scalar scatter CAP vals into M",
     lambda m, idx, v: D._set_rows(m, 0, idx, v), lambda x: (x.M, x.pos_old, x.vs)),
    ("p3: cumsum over M", D._cumsum32,
     lambda x: (torch.zeros(x.M, dtype=torch.int32, device=x.vs.device),)),
    ("p3: gather M rows from CAP", lambda k, i: k[i.long()],
     lambda x: (x.ks_rows, x.gidx)),
    ("p3: compaction scatter M rows -> CAP", _compaction_scatter,
     lambda x: (x.cap, x.keep, x.mrows)),
    ("alt: argsort 16K int32", lambda v: torch.argsort(v, stable=True),
     lambda x: (x.argsort_x,)),
    ("alt: lexsort M rows (W keys)",
     lambda r: lexsort([r[:, w] for w in range(r.shape[1])]), lambda x: (x.mrows,)),
    ("alt: sort M int32 + payload", sort_payload, lambda x: (x.sort_k, x.sort_p)),
    ("bucket: histogram scatter-add CAP -> 65K + cumsum", _histogram,
     lambda x: (x.h_all,)),
    (WHOLE, _whole,
     lambda x: (x.ks_rows, x.vs, x.bidx, x.q_rows, x.r_tx, x.w_tx, x.snap, x.active)),
)


def primitive_table(device=None, shapes: Shapes = TABLE_SHAPES) -> list:
    """Time every row of PRIMITIVES (the whole resolve over 3 runs, as the
    reference) and print it.  Returns [(label, ms)]."""
    dev = resolve_device(device)
    timer = Timer(dev)
    print(f"host<->device floor: {timer.floor_ms:.3f} ms (one trivial launch; subtracted)")
    s = shapes
    print(f"shapes: CAP={s.cap} R={s.R} Wn={s.Wn} M={s.M} W={s.W}", flush=True)
    x = primitive_inputs(primitive_arrays(s), s, dev)
    return [(label, timer.one(label, fn, *args(x), n=3 if label == WHOLE else 5))
            for label, fn, args in PRIMITIVES]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m foundationdb_tpu_torch.profile_kernel",
                                 description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
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
    if not (args.phase or args.lex_less):
        primitive_table(args.device)
        return 0
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
    sys.exit(main())
