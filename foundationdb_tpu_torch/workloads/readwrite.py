"""ReadWrite — the reference's throughput/latency benchmark workload
(fdbserver/workloads/ReadWrite.actor.cpp: configurable read/write mix,
skewed "hot traffic" key choice, range reads, warmup-then-measure
phases, per-operation latency samples, :252-270 metrics emission).

Each client loops transactions of `reads_per_tx` point reads,
`range_reads_per_tx` range reads of `range_len` keys, and
`writes_per_tx` point writes over a configurable key pool for a fixed
duration, recording GRV / read / range / commit latencies.  Key choice
is uniform by default; `skew > 0` draws key RANKS from a zipf-like
distribution with that exponent (the reference's skewed-workload knob),
with ranks scattered across the keyspace by a fixed multiplicative hash
so hot keys spread over shards instead of piling into the first one.

`warmup` seconds split the run into a cold-start phase and a measured
warmed phase (the reference's metrics-start discipline): the headline
rates/percentiles cover only the warmed phase, and the cold phase's
read percentiles are reported separately — the cold-vs-warm split is
what makes a page-cache effect visible in one run.  Metrics report op
rates and p50/p90/p99 latencies — the repo counterpart of BASELINE.md's
per-core ops/s rows, so perf regressions show up in CI.

Copy of the reference package's workload.
"""

from __future__ import annotations

import bisect

from .base import Workload
from ..client.transaction import RETRYABLE_ERRORS
from ..runtime.combinators import wait_all


def _key(i: int) -> bytes:
    return b"rw/%06d" % i


# rank -> key-index scatter (Knuth's multiplicative hash): hot zipf ranks
# land all over the keyspace, so skewed load exercises every shard
_SCATTER = 2654435761


def percentile(sorted_xs: list[float], p: float) -> float:
    if not sorted_xs:
        return 0.0
    idx = min(int(p * len(sorted_xs)), len(sorted_xs) - 1)
    return sorted_xs[idx]


def _pcts(lat: list[float], prefix: str, out: dict) -> None:
    xs = sorted(lat)
    out[f"{prefix}_p50_ms"] = round(percentile(xs, 0.50) * 1e3, 3)
    out[f"{prefix}_p90_ms"] = round(percentile(xs, 0.90) * 1e3, 3)
    out[f"{prefix}_p99_ms"] = round(percentile(xs, 0.99) * 1e3, 3)


class ReadWriteWorkload(Workload):
    description = "ReadWrite"

    def __init__(
        self,
        keys: int = 1000,
        clients: int = 8,
        duration: float = 5.0,
        reads_per_tx: int = 9,
        writes_per_tx: int = 1,
        value_bytes: int = 16,
        skew: float = 0.0,
        scatter: bool = True,
        range_reads_per_tx: int = 0,
        range_len: int = 10,
        warmup: float = 0.0,
        start_delay: float = 0.0,
    ):
        self.keys = keys
        self.clients = clients
        self.duration = duration
        self.reads_per_tx = reads_per_tx
        self.writes_per_tx = writes_per_tx
        self.value_bytes = value_bytes
        self.skew = skew
        # scatter=False keeps hot zipf ranks CONTIGUOUS at the bottom of
        # the keyspace — the hot-shard workload: skewed traffic piles into
        # one shard so the load-metric plane has something to detect
        self.scatter = scatter
        self.range_reads_per_tx = range_reads_per_tx
        self.range_len = range_len
        self.warmup = warmup
        self.start_delay = start_delay
        self.committed = 0
        self.retries = 0
        # measured (post-warmup) samples; the cold phase keeps its own
        self.grv_lat: list[float] = []
        self.read_lat: list[float] = []
        self.range_lat: list[float] = []
        self.commit_lat: list[float] = []
        self.cold_read_lat: list[float] = []
        self.cold_committed = 0
        self._warm_committed = 0
        self._elapsed = 0.0
        self._zipf_cdf: list[float] | None = None

    def _build_zipf(self) -> None:
        w = [(i + 1) ** -self.skew for i in range(self.keys)]
        total = sum(w)
        cdf, acc = [], 0.0
        for x in w:
            acc += x / total
            cdf.append(acc)
        self._zipf_cdf = cdf

    def _pick(self, crng) -> int:
        if self.skew <= 0.0:
            return crng.random_int(0, self.keys)
        rank = min(bisect.bisect_left(self._zipf_cdf, crng.random()),
                   self.keys - 1)
        return (rank * _SCATTER) % self.keys if self.scatter else rank

    async def setup(self, cluster, rng) -> None:
        if self.skew > 0.0:
            self._build_zipf()
        db = cluster.database()
        val = b"x" * self.value_bytes
        # chunked fills (one giant txn would blow batch limits)
        for lo in range(0, self.keys, 500):

            async def fill(tr, lo=lo):
                for i in range(lo, min(lo + 500, self.keys)):
                    tr.set(_key(i), val)

            await db.run(fill)

    async def start(self, cluster, rng) -> None:
        if self.skew > 0.0 and self._zipf_cdf is None:
            self._build_zipf()  # runSetup=false still needs the CDF
        db = cluster.database()
        loop = cluster.loop
        if self.start_delay > 0:
            # composes with fault workloads: measure after their rounds
            await loop.delay(self.start_delay)
        t_start = loop.now()
        t_warm = t_start + self.warmup
        t_end = t_start + self.duration
        val = b"y" * self.value_bytes

        async def client(crng):
            while loop.now() < t_end:
                warm = loop.now() >= t_warm
                tr = db.create_transaction()
                try:
                    t0 = loop.now()
                    await tr.get_read_version()
                    if warm:
                        self.grv_lat.append(loop.now() - t0)
                    for _ in range(self.reads_per_tx):
                        k = _key(self._pick(crng))
                        t0 = loop.now()
                        await tr.get(k)
                        (self.read_lat if warm else self.cold_read_lat).append(
                            loop.now() - t0
                        )
                    for _ in range(self.range_reads_per_tx):
                        lo = self._pick(crng)
                        t0 = loop.now()
                        await tr.get_range(
                            _key(lo), _key(min(lo + self.range_len, self.keys)),
                            limit=self.range_len,
                        )
                        if warm:
                            self.range_lat.append(loop.now() - t0)
                    for _ in range(self.writes_per_tx):
                        tr.set(_key(self._pick(crng)), val)
                    t0 = loop.now()
                    await tr.commit()
                    if warm:
                        self.commit_lat.append(loop.now() - t0)
                        self._warm_committed += 1
                    else:
                        self.cold_committed += 1
                    self.committed += 1
                except RETRYABLE_ERRORS as e:
                    self.retries += 1
                    await tr.on_error(e)

        await wait_all(
            [loop.spawn(client(rng.split())) for _ in range(self.clients)]
        )
        # the measured window excludes warmup (cold fills are setup cost)
        self._elapsed = max(loop.now() - t_warm, 1e-9)

    async def check(self, cluster, rng) -> bool:
        return self.committed > 0

    def metrics(self) -> dict:
        measured = self._warm_committed if self.warmup > 0 else self.committed
        out = {
            "committed": self.committed,
            "retries": self.retries,
            "elapsed_s": round(self._elapsed, 3),
            "tx_per_s": round(measured / self._elapsed, 1),
            "reads_per_s": round(len(self.read_lat) / self._elapsed, 1),
        }
        for name, lat in (
            ("grv", self.grv_lat),
            ("read", self.read_lat),
            ("commit", self.commit_lat),
        ):
            _pcts(lat, name, out)
        if self.range_reads_per_tx:
            out["ranges_per_s"] = round(len(self.range_lat) / self._elapsed, 1)
            _pcts(self.range_lat, "range", out)
        if self.warmup > 0:
            # the cold-start phase's read tail vs the warmed one above —
            # the page-cache effect in one row pair
            out["cold_committed"] = self.cold_committed
            _pcts(self.cold_read_lat, "cold_read", out)
        return out
