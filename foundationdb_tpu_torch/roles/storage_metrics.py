"""Byte-sampled storage load metrics — the StorageMetrics.actor.h analog.

The reference never scans a shard to learn its size or traffic: the
storage server keeps a *byte sample* (StorageServerMetrics::byteSample)
updated on the write path, plus decayed read/write bandwidth samples
(bytesReadSample / bytesWriteSample feeding bytesReadPerKSecond and
bytesWrittenPerKSecond), and answers waitMetrics/splitMetrics queries
from those samples in O(sampled keys in range).  DataDistributionTracker
polls the estimates to pick split points and find read-hot shards.

Two estimators, one trick (Horvitz–Thompson): an entry of size `sz` is
sampled with probability p = min(1, sz / unit) and stored with weight
sz / p = max(sz, unit), so the expected stored weight equals the true
size — range sums are unbiased, entries >= unit are exact, and the
per-range relative error shrinks as 1/sqrt(range_bytes / unit).

* `ByteSample` — stored-bytes estimate.  The sample decision is a
  DETERMINISTIC hash of the key (the reference hashes the key too), so
  re-setting or clearing a key always touches the same sample entry and
  a seeded simulation replays identically.
* `BandwidthSample` — read/write traffic estimate.  Per-op sampling uses
  a private xorshift (the ContinuousSample determinism idiom: no global
  random state) because the same key is counted once per operation, not
  once per presence.  Entries decay lazily with time constant `tau`
  (exponential forgetting, applied on touch/query — O(1) per op): in
  steady state an input rate R holds the decayed weight at R*tau, so
  rate = weight / tau.

Copy of the reference package's module: the same writes sample the same
keys (blake2b) and give the same estimates in both packages.
"""

from __future__ import annotations

import bisect
import hashlib
import math

# decayed bandwidth entries below this fraction of the sampling unit are
# dropped at query/touch time — bounds sample memory without a sweeper
_EXPIRE_FRACTION = 1e-3


def _key_hash01(key: bytes) -> float:
    """Deterministic uniform [0,1) draw per key (replaces the reference's
    hashlittle2 over the key): the same key samples the same way in every
    process of every run, so clears remove exactly what sets added."""
    h = hashlib.blake2b(key, digest_size=8).digest()
    return int.from_bytes(h, "big") / float(1 << 64)


class ByteSample:
    """Sampled estimate of stored bytes per range (byteSample analog).

    `set(key, entry_bytes)` / `remove(key)` mirror the storage engine's
    live contents; `bytes_range` returns the unbiased byte estimate and
    `split_point` the sampled byte-weighted median — both O(log n + k)
    in the number of SAMPLED keys, never a data scan."""

    def __init__(self, unit: int) -> None:
        self.unit = max(1, unit)
        self._keys: list[bytes] = []
        self._weights: dict[bytes, int] = {}
        self.total = 0

    def __len__(self) -> int:
        return len(self._keys)

    def set(self, key: bytes, entry_bytes: int) -> None:
        """The key now stores `entry_bytes` (len(key)+len(value)); replaces
        any previous sample entry for the key."""
        sampled = _key_hash01(key) * self.unit < entry_bytes
        old = self._weights.pop(key, None)
        if old is not None:
            self.total -= old
            if not sampled:
                i = bisect.bisect_left(self._keys, key)
                del self._keys[i]
        if sampled:
            w = max(entry_bytes, self.unit)
            if old is None:
                bisect.insort(self._keys, key)
            self._weights[key] = w
            self.total += w

    def remove(self, key: bytes) -> None:
        old = self._weights.pop(key, None)
        if old is not None:
            self.total -= old
            i = bisect.bisect_left(self._keys, key)
            del self._keys[i]

    def clear_range(self, begin: bytes, end: bytes) -> None:
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        for k in self._keys[lo:hi]:
            self.total -= self._weights.pop(k)
        del self._keys[lo:hi]

    def bytes_range(self, begin: bytes, end: bytes) -> int:
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        return sum(self._weights[k] for k in self._keys[lo:hi])

    def split_point(self, begin: bytes, end: bytes) -> bytes | None:
        """Sampled byte-weighted median of [begin, end): the key where the
        cumulative sampled weight crosses half the range's weight — the
        reference's splitMetrics estimate, no scan.  None when fewer than
        two sampled keys fall in the range (nothing to split by)."""
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        if hi - lo < 2:
            return None
        half = sum(self._weights[k] for k in self._keys[lo:hi]) / 2.0
        acc = 0
        for k in self._keys[lo:hi]:
            acc += self._weights[k]
            if acc >= half:
                # never split AT the range start — that is not a split
                return k if k > begin else self._keys[lo + 1]
        return self._keys[hi - 1]


class BandwidthSample:
    """Decayed, sampled per-key traffic (bytesReadSample analog): feeds
    bytes_read_per_ksec / bytes_written_per_ksec range estimates."""

    def __init__(self, unit: int, tau: float) -> None:
        self.unit = max(1, unit)
        self.tau = tau
        self._keys: list[bytes] = []
        # key -> (decayed weight, last-touch sim time)
        self._entries: dict[bytes, tuple[float, float]] = {}
        self._x = 0x9E3779B9  # private xorshift: no global random state

    def _rand01(self) -> float:
        self._x = (self._x * 0x2545F491) & 0xFFFFFFFF
        self._x ^= self._x >> 13
        return self._x / float(1 << 32)

    def add(self, key: bytes, nbytes: int, now: float) -> None:
        """One operation moved `nbytes` for `key` at sim time `now`."""
        if nbytes <= 0:
            return
        p = min(1.0, nbytes / self.unit)
        if p < 1.0 and self._rand01() >= p:
            return
        w = nbytes / p
        old = self._entries.get(key)
        if old is None:
            bisect.insort(self._keys, key)
            self._entries[key] = (w, now)
        else:
            ow, ot = old
            self._entries[key] = (ow * math.exp((ot - now) / self.tau) + w, now)

    def _drop_index(self, i: int) -> None:
        del self._entries[self._keys[i]]
        del self._keys[i]

    def rate_range(self, begin: bytes, end: bytes, now: float) -> float:
        """Estimated bytes/sec over [begin, end) at `now` (decayed-weight
        sum / tau); prunes entries that decayed to noise."""
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        floor = self.unit * _EXPIRE_FRACTION
        total = 0.0
        i = lo
        while i < hi:
            w, t = self._entries[self._keys[i]]
            w *= math.exp((t - now) / self.tau)
            if w < floor:
                self._drop_index(i)
                hi -= 1
                continue
            total += w
            i += 1
        return total / self.tau

    def busiest_key(self, now: float) -> tuple[bytes | None, float]:
        """(key, bytes/sec) of the hottest sampled key — ratekeeper's
        limiting-shard attribution hint.  (None, 0.0) when the sample is
        empty or fully decayed."""
        best_k, best_w = None, 0.0
        floor = self.unit * _EXPIRE_FRACTION
        i = 0
        while i < len(self._keys):
            w, t = self._entries[self._keys[i]]
            w *= math.exp((t - now) / self.tau)
            if w < floor:
                self._drop_index(i)
                continue
            if w > best_w:
                best_k, best_w = self._keys[i], w
            i += 1
        return best_k, best_w / self.tau

    def clear_range(self, begin: bytes, end: bytes) -> None:
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        for k in self._keys[lo:hi]:
            del self._entries[k]
        del self._keys[lo:hi]


class StorageServerMetrics:
    """The storage server's load-metric plane: one byte sample plus read
    and write bandwidth samples, with the write-path / serve-path hooks
    StorageServer calls and the range-query surface DataDistribution and
    ratekeeper poll (StorageServerMetrics in the reference)."""

    def __init__(self, knobs) -> None:
        self.byte_sample = ByteSample(knobs.BYTE_SAMPLE_UNIT)
        self.read_bw = BandwidthSample(
            knobs.BANDWIDTH_SAMPLE_UNIT, knobs.BANDWIDTH_SMOOTH_SECONDS
        )
        self.write_bw = BandwidthSample(
            knobs.BANDWIDTH_SAMPLE_UNIT, knobs.BANDWIDTH_SMOOTH_SECONDS
        )

    # -- write-path hooks ---------------------------------------------------
    def on_set(self, key: bytes, value_len: int, now: float) -> None:
        nb = len(key) + value_len
        self.byte_sample.set(key, nb)
        self.write_bw.add(key, nb, now)

    def on_clear_range(self, begin: bytes, end: bytes, now: float) -> None:
        self.byte_sample.clear_range(begin, end)
        # a clear is write traffic at its boundary (the reference charges
        # clears to the range's begin key)
        self.write_bw.add(begin, len(begin) + len(end), now)

    def on_fetch_rows(self, rows) -> None:
        """Moved-in snapshot rows (fetchKeys dest): present, not traffic."""
        for k, v in rows:
            self.byte_sample.set(k, len(k) + len(v))

    def drop_range(self, begin: bytes, end: bytes) -> None:
        """The range left this server (source side of a completed move)."""
        self.byte_sample.clear_range(begin, end)
        self.read_bw.clear_range(begin, end)
        self.write_bw.clear_range(begin, end)

    # -- serve-path hook ----------------------------------------------------
    def on_read(self, key: bytes, nbytes: int, now: float) -> None:
        self.read_bw.add(key, nbytes, now)

    # -- query surface ------------------------------------------------------
    def metrics(self, begin: bytes, end: bytes, now: float) -> dict:
        """The waitMetrics reply: sampled bytes + per-kilosecond bandwidth
        estimates for [begin, end) — the reference's bytesPerKSecond units
        so rates compare directly against the DD shard-split knobs."""
        return {
            "bytes": self.byte_sample.bytes_range(begin, end),
            "bytes_read_per_ksec":
                self.read_bw.rate_range(begin, end, now) * 1e3,
            "bytes_written_per_ksec":
                self.write_bw.rate_range(begin, end, now) * 1e3,
            "sampled_keys": len(self.byte_sample),
        }

    def split_point(self, begin: bytes, end: bytes) -> bytes | None:
        return self.byte_sample.split_point(begin, end)

    def busiest_range(self, now: float) -> tuple[bytes | None, float]:
        """(hot key, combined bytes/sec) — the hottest sampled key by
        read+write traffic, for ratekeeper's limiting-shard attribution."""
        rk, rr = self.read_bw.busiest_key(now)
        wk, wr = self.write_bw.busiest_key(now)
        return (rk, rr) if rr >= wr else (wk, wr)
