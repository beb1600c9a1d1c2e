"""Scaling probes on the card: how the costs of gather, scatter, sort and
sparse-table builds scale with the index count and the output size.

    python -m foundationdb_tpu_torch.profile2                 # the card
    python -m foundationdb_tpu_torch.profile2 --device cpu

Port of the repository root's profile2.py, row for row and with its
labels, at its sizes (a table of 2**19 rows of 5 lanes, 2**19 versions):
row and scalar gathers, scalar scatter-sets into outputs of 2**16 to 2**19,
the drop-mode, sorted and row variants, a scatter-add and the histogram it
computes through a sort and a searchsorted, sort scaling with a payload
and with two key words, the sparse table built four ways, and a few
elementwise, cumsum and searchsorted rows.  These are the primitives a
forward fill without `cummax` would be built from.  Each row is timed by
profile_kernel's Timer (CUDA events on the card, less a trivial launch).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .conflict import device as D
from .conflict.device import resolve_device
from .keys import to_lanes
from .ops.rmq import _levels, build_sparse_table
from .profile_kernel import Timer, card_line, sort_payload

CAP = 1 << 19
W = 5
LANE_ZERO = -(2**31)  # the key word 0 as a flipped lane
GATHER_K = (1 << 14, 1 << 16, 1 << 17, 1 << 18, 1 << 19)
SCALAR_GATHER_K = (1 << 16, 1 << 19)
SCATTER_M = (1 << 16, 1 << 18, 1 << 19)
SCATTER_K = (1 << 14, 1 << 16, 1 << 18)
SORT_K = (1 << 16, 1 << 18, (1 << 19) + (1 << 14))


def _take(src, idx):
    return src[idx.long()]


def _scatter_set(m: int, idx, v):
    return torch.zeros(m, dtype=v.dtype, device=v.device).index_copy_(0, idx.long(), v)


def _scatter_set_rows(m: int, idx, rows):
    out = torch.full((m, rows.shape[1]), LANE_ZERO, dtype=torch.int32, device=rows.device)
    return out.index_copy_(0, idx.long(), rows)


def _scatter_add(m: int, idx, v):
    return torch.zeros(m, dtype=v.dtype, device=v.device).index_add_(0, idx.long(), v)


def _sort_hist(m: int, idx):
    """The histogram of idx over [0, m) without a scatter: sort, then the
    first position of every bin."""
    pos = torch.searchsorted(torch.sort(idx).values,
                             torch.arange(m + 1, dtype=idx.dtype, device=idx.device))
    return torch.diff(pos)


def build_concat(v):
    """The sparse table's recurrence keeping only the previous level, the
    levels concatenated into one vector."""
    out, prev = [v], v
    for level in range(1, _levels(v.shape[0])):
        s = 1 << (level - 1)
        prev = torch.maximum(prev, torch.cat([prev[s:], prev.new_zeros(s)]))
        out.append(prev)
    return torch.cat(out)


def build_rolled(v):
    """The recurrence written level by level into one [L, n] table, each
    level a roll of the previous one with its wrapped tail zeroed."""
    n = v.shape[0]
    t = v.new_zeros((_levels(n), n))
    t[0] = v
    live = torch.arange(n, device=v.device)
    for level in range(1, t.shape[0]):
        s = 1 << (level - 1)
        shifted = torch.where(live + s < n, torch.roll(t[level - 1], -s), 0)
        t[level] = torch.maximum(t[level - 1], shifted)
    return t


def build_pyramid(v):
    """A disjoint-block pyramid: each level the pairwise max of the last,
    half its length (2n entries in all)."""
    out, prev = [v], v
    while prev.shape[0] > 1:
        h = prev.shape[0] // 2
        prev = torch.maximum(prev[0:2 * h:2], prev[1:2 * h:2])
        out.append(prev)
    return out


def rows(device=None, seed: int = 3) -> list:
    """The rows (label, function, arguments) on `device`, their inputs
    drawn from the reference's seed in its order (key rows as flipped
    lanes)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def ints(lo, hi, n):
        return torch.from_numpy(
            rng.integers(lo, hi, size=(n,), dtype=np.int64).astype(np.int32)).to(dev)

    def lanes(n):
        return to_lanes(rng.integers(0, 2**32, size=(n, W), dtype=np.uint64)
                        .astype(np.uint32), dev)

    def distinct(m, k):
        return torch.from_numpy(rng.choice(m, size=k, replace=False).astype(np.int32)).to(dev)

    table, vals = lanes(CAP), ints(0, 1 << 20, CAP)
    out = [(f"gather rows k={k:>7}", _take, (table, ints(0, CAP, k))) for k in GATHER_K]
    out += [(f"gather scalars k={k:>7}", _take, (vals, ints(0, CAP, k)))
            for k in SCALAR_GATHER_K]
    for m in SCATTER_M:
        for k in SCATTER_K:
            if k <= m:
                idx = distinct(m, k)
                out.append((f"scat-set scalars k={k:>7} m={m:>7}", _scatter_set,
                            (m, idx, ints(0, 100, k))))
    m, k = 1 << 19, 1 << 16
    idx = distinct(m, k)
    v, key_rows = ints(0, 100, k), lanes(k)
    sidx = torch.sort(idx).values
    out += [
        ("scat-set scalars drop-mode", lambda m, i, v: D._set_rows(m, 0, i, v), (m, idx, v)),
        ("scat-set scalars sorted idx", _scatter_set, (m, sidx, v)),
        # index_copy_ takes no sortedness or uniqueness hint: this is the
        # sorted row again, under the reference's label for the hinted one
        ("scat-set scalars sorted+hints", _scatter_set, (m, sidx, v)),
        ("scat-set rows k=65K m=524K", _scatter_set_rows, (m, idx, key_rows)),
        ("scat-add scalars k=65K m=524K", _scatter_add, (m, idx, v)),
        ("hist via sort+searchsorted k=65K m=524K", _sort_hist, (m, idx)),
    ]
    for k in SORT_K:
        x = ints(0, 2**31, k)
        out.append((f"sort i32+payload k={k:>7}", sort_payload,
                    (x, torch.arange(k, dtype=torch.int32, device=dev))))
    k = 1 << 19
    x0, x1 = ints(0, 2**31, k), ints(0, 2**31, k)
    out += [
        ("sort 2-key+1payload k=524K", sort_payload,
         (x0, x1, torch.arange(k, dtype=torch.int32, device=dev))),
        ("table build (current, stack of L)",
         lambda v: build_sparse_table(v, torch.maximum, 0), (vals,)),
        ("table build (concat out)", build_concat, (vals,)),
        ("table build (fori dyn-update)", build_rolled, (vals,)),
        ("disjoint pyramid build (total 2N)", build_pyramid, (vals,)),
        ("elementwise max CAP x20",
         lambda v: sum(torch.maximum(v, v + i) for i in range(20)), (vals,)),
        ("concat shift + max, one level",
         lambda v: torch.maximum(v, torch.cat([v[256:], v.new_zeros(256)])), (vals,)),
        ("cumsum CAP", D._cumsum32, (vals,)),
        ("searchsorted 49K into CAP", torch.searchsorted,
         (torch.sort(vals).values, ints(0, 1 << 20, 49152))),
    ]
    return out


def run(device=None) -> list:
    """Time every row and print it.  Returns [(label, ms)]."""
    dev = resolve_device(device)
    timer = Timer(dev)
    print(f"floor {timer.floor_ms:.3f} ms (one trivial launch; subtracted)", flush=True)
    return [(label, timer.one(label, fn, *args)) for label, fn, args in rows(dev)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m foundationdb_tpu_torch.profile2",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(f"card: {card_line(resolve_device(args.device))}", flush=True)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
