"""Metrics core: exponential smoothing + percentile sampling
(flow/Smoother.h Smoother/TimerSmoother; flow/ContinuousSample.h) — the
time-series primitives the ratekeeper, load balancer, and perf workloads
build on (flow/Stats.h counters live in runtime/trace.py).

Copy of the reference package's module: the same observations give the
same snapshots in both packages."""

from __future__ import annotations

import math
from typing import Callable


class Smoother:
    """Exponentially-smoothed total: `smooth_total` chases the true total
    with time constant `e_time`, and `smooth_rate` is the smoothed
    d(total)/dt — the reference's Smoother, used for rates and latencies
    that must not whipsaw the control loops reading them."""

    def __init__(self, e_time: float, clock: Callable[[], float]) -> None:
        self.e_time = e_time
        self._clock = clock
        self._time = clock()
        self._total = 0.0
        self._estimate = 0.0

    def reset(self, value: float) -> None:
        self._total = value
        self._estimate = value
        self._time = self._clock()

    def set_total(self, value: float) -> None:
        self._advance()
        self._total = value

    def add_delta(self, delta: float) -> None:
        self._advance()
        self._total += delta

    def _advance(self) -> None:
        now = self._clock()
        dt = now - self._time
        if dt > 0:
            self._estimate += (self._total - self._estimate) * (
                1 - math.exp(-dt / self.e_time)
            )
            self._time = now

    def smooth_total(self) -> float:
        self._advance()
        return self._estimate

    def smooth_rate(self) -> float:
        """Smoothed rate of change: (total - estimate) / e_time — exact for
        a constant-rate input, lagging for steps (by design)."""
        self._advance()
        return (self._total - self._estimate) / self.e_time


# SLO-facing latency thresholds (seconds): the flow/Stats.h LatencyBands
# defaults the reference wires into GRV/commit/read stats — operators alert
# on band counts, Ratekeeper reasons about the tail bands.
DEFAULT_LATENCY_BANDS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)


class LatencyBands:
    """Counts per latency threshold bucket (flow/Stats.h:155 LatencyBands).

    Buckets are DISJOINT — measurement m lands in the first band with
    m < threshold, or the overflow band — so the bucket counts always sum
    to the total number of operations (the invariant status consumers
    check).  The reference keeps cumulative <=threshold counters; disjoint
    buckets carry the same information and sum cleanly across roles."""

    def __init__(self, thresholds: tuple[float, ...] = DEFAULT_LATENCY_BANDS) -> None:
        self.thresholds = tuple(thresholds)
        self.counts = [0] * (len(self.thresholds) + 1)

    def add(self, latency: float) -> None:
        for i, t in enumerate(self.thresholds):
            if latency < t:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    @property
    def count(self) -> int:
        return sum(self.counts)

    def snapshot(self) -> dict:
        bands = {f"<{t:g}": c for t, c in zip(self.thresholds, self.counts)}
        bands[f">={self.thresholds[-1]:g}"] = self.counts[-1]
        return {"count": self.count, "bands": bands}


class LatencyTracker:
    """One pipeline stage's latency model: SLO bands + a uniform reservoir
    for percentiles + sum/max — the LatencyBands-plus-ContinuousSample pair
    every instrumented station in the commit/GRV/read paths owns."""

    def __init__(
        self,
        thresholds: tuple[float, ...] = DEFAULT_LATENCY_BANDS,
        sample_size: int = 500,
    ) -> None:
        self.bands = LatencyBands(thresholds)
        self.sample = ContinuousSample(sample_size)
        self.sum = 0.0
        self.max = 0.0

    def observe(self, latency: float) -> None:
        self.bands.add(latency)
        self.sample.add(latency)
        self.sum += latency
        if latency > self.max:
            self.max = latency

    @property
    def count(self) -> int:
        return self.bands.count

    def snapshot(self) -> dict:
        n = self.count
        return {
            "count": n,
            "mean": self.sum / n if n else 0.0,
            "max": self.max,
            "p50": self.sample.percentile(0.5),
            "p95": self.sample.percentile(0.95),
            "p99": self.sample.percentile(0.99),
            "bands": self.bands.snapshot()["bands"],
        }

    @classmethod
    def merged(cls, trackers: "list[LatencyTracker]") -> dict:
        """One snapshot over several trackers (e.g. the same stage across
        all proxies): counts and bands sum, percentiles come from the
        pooled reservoirs — the merge the status roll-up needs, done on
        the tracker objects because percentiles cannot be merged from
        finished snapshots.

        Reservoirs are fixed-size, so each sample is WEIGHTED by how many
        observations it represents (t.count / len(samples)): a proxy that
        served 100k commits must not be averaged 50/50 against one that
        served 500, or the merged p50 reads like the idle proxy."""
        out = cls()
        bands: dict[str, int] = {}
        weighted: list[tuple[float, float]] = []
        n = 0
        for t in trackers:
            n += t.count
            out.sum += t.sum
            out.max = max(out.max, t.max)
            for k, v in t.bands.snapshot()["bands"].items():
                bands[k] = bands.get(k, 0) + v
            if t.sample._samples:
                w = t.count / len(t.sample._samples)
                weighted.extend((v, w) for v in t.sample._samples)
        weighted.sort()
        total_w = sum(w for _v, w in weighted)

        def pct(p: float) -> float:
            if not weighted:
                return 0.0
            target = p * total_w
            acc = 0.0
            for v, w in weighted:
                acc += w
                if acc >= target:
                    return v
            return weighted[-1][0]

        return {
            "count": n,
            "mean": out.sum / n if n else 0.0,
            "max": out.max,
            "p50": pct(0.5),
            "p95": pct(0.95),
            "p99": pct(0.99),
            "bands": bands,
        }


class WireStats:
    """Commit-plane wire counters (the tentpole's observability surface —
    docs/WIRE.md): bytes and wall time through the codec registry, frames
    per transport flush, and — the trust/coverage signal — how often a
    payload fell back to pickle (by type, so a hot message regressing onto
    the fallback path is visible by name, not just as a count).

    Wall times are host-measured (time.perf_counter) and observability
    only: they never feed back into simulation behavior, exactly like
    KernelStats, so determinism is unaffected."""

    __slots__ = (
        "frames_encoded", "frames_decoded", "bytes_encoded", "bytes_decoded",
        "encode_s", "decode_s", "pickle_fallbacks", "fallback_types",
        "flushes", "frames_flushed", "decode_fallbacks",
    )

    def __init__(self) -> None:
        self.frames_encoded = 0
        self.frames_decoded = 0
        self.bytes_encoded = 0
        self.bytes_decoded = 0
        self.encode_s = 0.0
        self.decode_s = 0.0
        self.pickle_fallbacks = 0          # encode-side payloads that left the
        self.fallback_types: dict[str, int] = {}  # codec registry (by type)
        self.decode_fallbacks = 0          # tag-0 frames decoded
        self.flushes = 0                   # transport write coalescing
        self.frames_flushed = 0

    def note_fallback(self, obj) -> None:
        self.pickle_fallbacks += 1
        name = type(obj).__name__
        self.fallback_types[name] = self.fallback_types.get(name, 0) + 1

    def snapshot(self) -> dict:
        return {
            "frames_encoded": self.frames_encoded,
            "frames_decoded": self.frames_decoded,
            "bytes_encoded": self.bytes_encoded,
            "bytes_decoded": self.bytes_decoded,
            "encode_ms": self.encode_s * 1e3,
            "decode_ms": self.decode_s * 1e3,
            "pickle_fallbacks": self.pickle_fallbacks,
            "fallback_types": dict(self.fallback_types),
            "decode_fallbacks": self.decode_fallbacks,
            "flushes": self.flushes,
            "frames_flushed": self.frames_flushed,
            "frames_per_flush": (
                self.frames_flushed / self.flushes if self.flushes else 0.0
            ),
        }


class ContinuousSample:
    """Fixed-size uniform reservoir over a stream, with percentile reads
    (flow/ContinuousSample.h): every element ever added has equal
    probability of being in the sample, so percentiles track the whole
    stream, not a recent window."""

    def __init__(self, size: int, rng=None) -> None:
        self._size = size
        self._rng = rng
        self._samples: list[float] = []
        self._n = 0
        self._sorted = True

    def add(self, value: float) -> None:
        self._n += 1
        if len(self._samples) < self._size:
            self._samples.append(value)
            self._sorted = False
        else:
            if self._rng is not None:
                j = self._rng.random_int(0, self._n)
            else:
                # private xorshift, NOT the global random module: sampling
                # must never make a seeded simulation replay differently
                self._x = (getattr(self, "_x", 0x9E3779B9) * 0x2545F491) & 0xFFFFFFFF
                self._x ^= self._x >> 13
                j = self._x % self._n
            if j < self._size:
                self._samples[j] = value
                self._sorted = False

    @property
    def count(self) -> int:
        return self._n

    def percentile(self, p: float) -> float:
        if not self._samples:
            return 0.0
        if not self._sorted:
            self._samples.sort()
            self._sorted = True
        idx = min(int(p * len(self._samples)), len(self._samples) - 1)
        return self._samples[idx]

    def median(self) -> float:
        return self.percentile(0.5)
