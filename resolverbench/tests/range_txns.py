"""A traffic generator of transactions that carry key ranges, made from the
seed: what a cell of range reads adds as a new file under `traffic/`.  The
tests copy it into a benchmark tree's `traffic/` and run a cell on it
through the unmodified harness.

What it reads:
  the configuration: `max_key_bytes`, the number of pool keys
    (`key_count`), their lengths (`keys.bytes`: [lo, hi], hi below
    max_key_bytes), the read and write ranges a transaction (`txn.reads`,
    `txn.writes`: [lo, hi], none included), the pool keys a range spans
    (`txn.read_span`, `txn.write_span`: [lo, hi]; a span of 0 is the point
    range [k, k + b"\\x00")) and the MVCC window (`mvcc`);
  the traffic mix's `traffic` block: the transactions a batch, how many
    batches back a snapshot is taken, the share of transactions that hold
    a read version past the MVCC window.

The pool is `key_count` random keys of random lengths, sorted in byte
order (duplicates dropped).  Key id j is pool key j // 2, with a zero byte
appended where j is odd, so a range of span s from pool key p is
[2p, 2(p + s)) in ids, and a point range [2p, 2p + 1).  Versions, floors
and the write-only history batches are those of point_txns.
"""

from __future__ import annotations

import numpy as np

from resolverbench import layout
from resolverbench.reference import Keys, RangeReference

ENDS = ("r_begin", "r_end", "w_begin", "w_end")


class Generator:
    def __init__(self, config: dict, traffic: dict, seed: int) -> None:
        txn, mvcc = config["txn"], config["mvcc"]
        self.seed = int(seed)
        self.max_key_bytes = int(config["max_key_bytes"])
        lo, hi = (int(x) for x in config["keys"]["bytes"])
        if not 0 <= lo <= hi < self.max_key_bytes:
            raise ValueError("pool keys and a zero byte past them must fit max_key_bytes")
        self.reads, self.writes = txn["reads"], txn["writes"]
        self.read_span, self.write_span = txn["read_span"], txn["write_span"]
        self.step = int(mvcc["version_step"])
        self.window = int(mvcc["window_versions"])
        self.batch_txns = int(traffic["batch_txns"])
        self.lag_lo, self.lag_hi = (int(x) for x in traffic["snapshot_lag_batches"])
        self.too_old_share = float(traffic["too_old_share"])
        rng = np.random.default_rng([self.seed, 0])
        n = int(config["key_count"])
        lens = rng.integers(lo, hi + 1, n)
        rows = rng.integers(0, 256, (n, self.max_key_bytes), dtype=np.uint8)
        rows[np.arange(self.max_key_bytes) >= lens[:, None]] = 0
        # lanes sort in byte order
        self.pool = np.unique(layout.key_lanes(rows, lens, self.max_key_bytes), axis=0)
        if self.pool.shape[0] <= max(self.read_span[1], self.write_span[1]):
            raise ValueError("a range spans more keys than the pool holds")

    def version(self, i: int) -> int:
        return (i + 1) * self.step

    def oldest(self, i: int) -> int:
        return max(0, self.version(i - 1) - self.window) if i > 0 else 0

    def lanes_of(self, ids: np.ndarray) -> np.ndarray:
        lanes = self.pool[ids // 2]
        lanes[:, -1] += (ids % 2).astype(np.uint32)
        return lanes

    def key_bytes(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        lanes = self.pool[ids // 2]
        rows = lanes[:, :-1].astype(">u4").view(np.uint8)
        return rows, lanes[:, -1].astype(np.int64) + ids % 2

    def _ranges(self, rng, count, span) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        tx = np.repeat(np.arange(self.batch_txns), rng.integers(count[0], count[1] + 1,
                                                                self.batch_txns))
        s = rng.integers(span[0], span[1] + 1, tx.size)
        start = 2 * rng.integers(0, self.pool.shape[0] - s)
        return start, np.where(s == 0, start + 1, start + 2 * s), tx

    def batch(self, i: int, write_only: bool = False) -> dict:
        rng = np.random.default_rng([self.seed, 1, i])
        B = self.batch_txns
        version, oldest = self.version(i), self.oldest(i)
        wb, we, wt = self._ranges(rng, self.writes, self.write_span)
        if write_only:
            none = np.zeros(0, dtype=np.int64)
            return dict(version=version, oldest=oldest, r_begin=none, r_end=none, r_tx=none,
                        w_begin=wb, w_end=we, w_tx=wt,
                        snaps=np.full(B, max(version - self.step, 0), dtype=np.int64))
        rb, re, rt = self._ranges(rng, self.reads, self.read_span)
        lag = rng.integers(self.lag_lo, self.lag_hi + 1, size=B)
        snaps = np.maximum(version - lag * self.step, 0)
        stale = rng.random(B) < self.too_old_share
        if oldest > 0:
            snaps = np.where(stale, np.maximum(oldest - 1 - rng.integers(0, self.step, B), 0),
                             snaps)
        return dict(version=version, oldest=oldest, r_begin=rb, r_end=re, r_tx=rt,
                    w_begin=wb, w_end=we, w_tx=wt, snaps=snaps.astype(np.int64))

    def pack(self, b: dict, width: int) -> tuple:
        ids, where = np.unique(np.concatenate([b[k] for k in ENDS]), return_inverse=True)
        lanes = self.lanes_of(ids)[where]  # each distinct key encoded once
        rb, re, wb, we = np.split(lanes, np.cumsum([b[k].size for k in ENDS[:3]]))
        return layout.pack_ranges(rb, re, b["r_tx"], wb, we, b["w_tx"], b["snaps"],
                                  b["oldest"], width)

    def reference(self, last: int, write_only_below: int, **guarantees):
        seen = np.unique(np.concatenate([
            np.concatenate([b[k] for k in ENDS])
            for b in (self.batch(i, i < write_only_below) for i in range(last + 1))]))
        keys = Keys(seen, self.key_bytes)
        ref = RangeReference(keys.count, **guarantees)
        for i in range(last + 1):
            b = self.batch(i, i < write_only_below)
            yield ref.resolve(b["version"], b["oldest"], keys(b["r_begin"]), keys(b["r_end"]),
                              b["r_tx"], keys(b["w_begin"]), keys(b["w_end"]), b["w_tx"],
                              b["snaps"])
