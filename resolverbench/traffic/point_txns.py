"""A traffic generator: batches of point-key transactions that a commit
proxy sends one resolver, made from the seed.

What it reads:
  the configuration (`configs/<name>.json`): the number of keys
    (`key_count`), the key space (`keys`: a pool of random byte strings,
    or YCSB's ``"user"`` + FNV-hashed record ids), the request
    distribution over it (uniform, or YCSB's scrambled zipfian), the
    shape of a transaction (`txn`: point reads, point writes, whether the
    writes are the keys read) and the MVCC window (`mvcc`);
  the traffic mix (`workloads/<name>.json`, its `traffic` block): the
    transactions a batch, how many batches back a snapshot is taken, the
    share of transactions that hold a read version past the MVCC window.

Batch i has commit version (i + 1) * version_step.  Its draws come from a
generator seeded with (seed, i) alone, so batch i is the same in every run
of a seed, whatever the run's speed, and every seed makes batches of the
same sizes.  The oldest version batch i is checked against is the MVCC
floor the resolver set after batch i - 1: version(i - 1) - window, once
that is positive.

Besides its batches a generator owns two duties of the harness: `pack`
lays a batch out as the program takes it, and `reference` answers the
batches again with the plain reference.  Here a read or a write is a key
id; `pack` writes it as the point range [k, k + b"\\x00") (layout.pack)
and `reference` checks key equality (reference.Reference).
"""

from __future__ import annotations

import numpy as np

from resolverbench import layout
from resolverbench.reference import Keys, Reference

FNV_OFFSET_64 = 0xCBF29CE484222325
FNV_PRIME_64 = 1099511628211
_USER = np.frombuffer(b"user", dtype=np.uint8)


def fnv_hash64(ids: np.ndarray) -> np.ndarray:
    """YCSB's Utils.fnvhash64 over the 8 bytes of each id, as Java does it
    (wrapping 64-bit product), then Math.abs: int64 results."""
    val = ids.astype(np.uint64)
    h = np.full(val.shape, FNV_OFFSET_64, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for _ in range(8):
            h ^= val & np.uint64(0xFF)
            h *= np.uint64(FNV_PRIME_64)
            val >>= np.uint64(8)
        s = h.view(np.int64)
        return np.where(s < 0, -s, s)  # Math.abs: Long.MIN_VALUE stays negative


def ycsb_key_bytes(hashed: np.ndarray, width: int) -> tuple[np.ndarray, np.ndarray]:
    """``"user" + Long.toString(h)`` for each int64 h, as uint8[n, width]
    rows (zero past the end) and lengths."""
    text = hashed.astype("S20").view(np.uint8).reshape(-1, 20)  # NumPy's decimal, zero padded
    out = np.zeros((hashed.shape[0], width), dtype=np.uint8)
    out[:, :4] = _USER
    out[:, 4:24] = text
    return out, 4 + (text != 0).sum(axis=1)


class Generator:
    """One cell's batches (module docstring); the harness looks the class
    up by this name."""

    def __init__(self, config: dict, traffic: dict, seed: int) -> None:
        keys, txn, mvcc = config["keys"], config["txn"], config["mvcc"]
        self.seed = int(seed)
        self.max_key_bytes = int(config["max_key_bytes"])
        self.key_format = keys["format"]
        self.n_keys = int(config["key_count"])
        self.reads = int(txn["reads"])
        self.writes = int(txn["writes"])
        self.rmw = bool(txn.get("writes_are_reads", False))
        if self.rmw and self.reads != self.writes:
            raise ValueError("writes_are_reads needs as many writes as reads")
        self.step = int(mvcc["version_step"])
        self.window = int(mvcc["window_versions"])
        self.batch_txns = int(traffic["batch_txns"])
        self.lag_lo, self.lag_hi = (int(x) for x in traffic["snapshot_lag_batches"])
        self.too_old_share = float(traffic["too_old_share"])
        if self.key_format == "random_bytes":
            rng = np.random.default_rng([self.seed, 0])
            self.pool = rng.integers(0, 256, size=(self.n_keys, int(keys["bytes"])),
                                     dtype=np.uint8)
            # a key a (void) element: its rows gather as one copy each
            self._pool_rows = self.pool.view(f"V{self.pool.shape[1]}")
        elif self.key_format != "ycsb_user":
            raise ValueError(f"unknown key format {self.key_format!r}")
        dist = keys["distribution"]
        self.dist = dist["kind"]
        if self.dist == "scrambled_zipfian":
            # YCSB's ScrambledZipfianGenerator, what CoreWorkload draws for
            # requestdistribution=zipfian: a ZipfianGenerator over
            # item_count + 1 items with YCSB's precomputed zeta, each item
            # hashed onto the records
            self.theta = float(dist["theta"])
            self.items = int(dist["item_count"]) + 1
            self.zetan = float(dist["zetan"])
            zeta2 = 1.0 + 2.0 ** -self.theta
            self.alpha = 1.0 / (1.0 - self.theta)
            self.eta = ((1.0 - (2.0 / self.items) ** (1.0 - self.theta))
                        / (1.0 - zeta2 / self.zetan))
        elif self.dist != "uniform":
            raise ValueError(f"unknown distribution {self.dist!r}")

    # -- versions --------------------------------------------------------------
    def version(self, i: int) -> int:
        return (i + 1) * self.step

    def oldest(self, i: int) -> int:
        """The MVCC floor batch i is checked against."""
        return max(0, self.version(i - 1) - self.window) if i > 0 else 0

    # -- keys ------------------------------------------------------------------
    def key_bytes(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The keys of ids: uint8[n, L] rows, zero past each length, and
        the lengths."""
        if self.key_format == "random_bytes":
            rows = self._pool_rows[ids].view(np.uint8)
            return rows, np.full(ids.shape[0], rows.shape[1], dtype=np.int64)
        return ycsb_key_bytes(fnv_hash64(ids), self.max_key_bytes)

    def lanes_of(self, ids: np.ndarray) -> np.ndarray:
        rows, lens = self.key_bytes(ids)
        return layout.key_lanes(rows, lens, self.max_key_bytes)

    def _draw(self, rng, n: int) -> np.ndarray:
        if self.dist == "uniform":
            return rng.integers(0, self.n_keys, size=n)
        return self.scrambled_zipfian(rng.random(n))

    def scrambled_zipfian(self, u: np.ndarray) -> np.ndarray:
        """Record ids for uniform draws u in [0, 1): YCSB's
        ZipfianGenerator.nextLong (Gray et al.; item 0 the hottest), then
        ScrambledZipfianGenerator's ``fnvhash64(item) % recordcount``."""
        uz = u * self.zetan
        item = (self.items * (self.eta * u - self.eta + 1.0) ** self.alpha).astype(np.int64)
        item = np.where(uz < 1.0 + 0.5 ** self.theta, 1, item)
        item = np.where(uz < 1.0, 0, item)
        return np.fmod(fnv_hash64(item), self.n_keys)  # Java's %: the dividend's sign

    # -- batches ---------------------------------------------------------------
    def batch(self, i: int, write_only: bool = False) -> dict:
        """Batch i: key ids `reads` [B, r] and `writes` [B, w], read
        versions `snaps` [B], its `version` and `oldest`.  A write-only
        batch (the history the window starts from) has no reads and
        snapshots one batch back."""
        rng = np.random.default_rng([self.seed, 1, i])
        B = self.batch_txns
        version, oldest = self.version(i), self.oldest(i)
        if write_only:
            writes = self._draw(rng, B * self.writes).reshape(B, self.writes)
            reads = np.zeros((B, 0), dtype=np.int64)
            snaps = np.full(B, max(version - self.step, 0), dtype=np.int64)
            return dict(version=version, oldest=oldest, reads=reads, writes=writes,
                        snaps=snaps)
        reads = self._draw(rng, B * self.reads).reshape(B, self.reads)
        writes = (reads if self.rmw else
                  self._draw(rng, B * self.writes).reshape(B, self.writes))
        lag = rng.integers(self.lag_lo, self.lag_hi + 1, size=B)
        snaps = np.maximum(version - lag * self.step, 0)
        stale = rng.random(B) < self.too_old_share
        back = rng.integers(0, self.step, size=B)
        if oldest > 0:  # a read version from before the MVCC floor
            snaps = np.where(stale, np.maximum(oldest - 1 - back, 0), snaps)
        return dict(version=version, oldest=oldest, reads=reads, writes=writes,
                    snaps=snaps.astype(np.int64))

    # -- the harness's two duties ----------------------------------------------
    def pack(self, b: dict, width: int) -> tuple:
        """Batch b as resolve_arrays' eight arrays, `width` lanes a row."""
        return layout.pack(b["reads"], b["writes"], b["snaps"], b["oldest"], self.lanes_of,
                           width)

    def reference(self, last: int, write_only_below: int, **guarantees):
        """The plain reference's verdicts of batches 0..last, in order, as
        int8 arrays; batches below `write_only_below` are write-only.
        `guarantees` are Reference's switches (a control turns one off)."""
        seen = np.zeros(0, dtype=np.int64)
        chunk = []
        for i in range(last + 1):
            b = self.batch(i, i < write_only_below)
            chunk.append(np.unique(np.concatenate([b["reads"].ravel(), b["writes"].ravel()])))
            if len(chunk) == 64 or i == last:
                seen = np.unique(np.concatenate([seen] + chunk))
                chunk = []
        keys = Keys(seen, self.key_bytes)
        ref = Reference(keys.count, **guarantees)
        for i in range(last + 1):
            b = self.batch(i, i < write_only_below)
            yield ref.resolve(b["version"], b["oldest"], keys(b["reads"]), keys(b["writes"]),
                              b["snaps"])
