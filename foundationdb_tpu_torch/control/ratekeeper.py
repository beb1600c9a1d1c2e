"""Ratekeeper — global admission control (fdbserver/Ratekeeper.actor.cpp).

Watches every storage server's durability lag and every TLog's queue depth
and computes a cluster-wide transactions-per-second budget (updateRate
:250) that the proxies' GRV service spends, shedding load *before* queues
melt down — the reference's core flow-control loop.

Per-server model (the reference's shape, simplified to this runtime's
observables): each server's lag is exponentially SMOOTHED (Smoother, so
transient spikes don't whipsaw admission), a proportional controller maps
smoothed lag to a per-server TPS limit with slack above the target, the
binding (minimum) constraint wins, and the published budget is itself
smoothed.  `status()` exposes the per-server model the reference prints
in its RkUpdate trace events.

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

from ..roles.storage import StorageServer
from ..runtime.core import EventLoop, TaskPriority
from ..runtime.coverage import testcov
from ..runtime.knobs import CoreKnobs
from ..runtime.metrics import Smoother
from ..runtime.trace import SEV_INFO, SEV_WARN


class Ratekeeper:
    def __init__(
        self,
        loop: EventLoop,
        knobs: CoreKnobs,
        storage: list[StorageServer],
        tlogs_fn,  # callable -> current list[TLog] (generation changes)
        max_tps: float = 1e6,
        trace=None,  # TraceCollector: RkUpdate track_latest events feed the
                     # status messages roll-up (the reference's RkUpdate)
    ) -> None:
        self.loop = loop
        self.knobs = knobs
        self.storage = storage
        self.tlogs_fn = tlogs_fn
        self.max_tps = max_tps
        self.trace = trace
        self.tps_budget = max_tps
        self.batch_tps_budget = max_tps
        # operator-imposed cap (fdbcli `throttle`, `\xff/conf/throttle_tps`):
        # an upper bound composed with the automatic model, None = off
        self.manual_tps_cap: float | None = None
        self.limit_reason = "unlimited"
        self.limiting_server: str | None = None
        # WHICH range drove a storage-side limit (the load-metric plane's
        # attribution): the limiting server's hottest sampled key + its
        # bytes/sec, so saturation reports point at the hot range, not
        # just the hot process; None while unlimited / TLog-limited
        self.limiting_shard: str | None = None
        self.limiting_shard_bps: float = 0.0
        # e-brake: a queue crossed its HARD limit or a disk is nearly full —
        # the budget is slammed to the floor (no smoothing) until it clears
        self.e_brake = False
        self._lag_smoothers: dict[str, Smoother] = {}
        self._queue_smoothers: dict[int, Smoother] = {}
        self._squeue_smoothers: dict[str, Smoother] = {}
        self._tlog_names: dict = {}  # endpoint token -> "tlogN" (status keys)
        self._budget = Smoother(
            knobs.RATEKEEPER_SMOOTHING_E, clock=loop.now
        )
        self._budget.reset(max_tps)
        self._task = loop.spawn(self._run(), TaskPriority.RATEKEEPER, "ratekeeper")

    def _smoothed(self, table: dict, key, value: float) -> float:
        s = table.get(key)
        if s is None:
            s = table[key] = Smoother(
                self.knobs.RATEKEEPER_SMOOTHING_E, clock=self.loop.now
            )
            s.reset(value)
        else:
            s.set_total(value)
        return s.smooth_total()

    @staticmethod
    def _limit(lag: float, target: float, max_tps: float) -> float:
        """Proportional controller: full rate below target, linear squeeze
        to the 1% floor as lag approaches 2x target (the spring the
        reference's updateRate builds per server)."""
        if lag <= target:
            return max_tps
        frac = max(0.0, (2 * target - lag) / target)
        return max(max_tps * frac, max_tps * 0.01)

    def _free_space(self, ss) -> float | None:
        """The storage server's disk free-space FRACTION, or None when its
        store has no bounded disk (pure-memory engines, unlimited sim
        disks) — the storage_server_min_free_space input."""
        du = getattr(getattr(ss, "store", None), "disk_usage", None)
        if du is None:
            return None
        used, cap = du()
        if cap is None or cap <= 0:
            return None
        return max(0.0, 1.0 - used / cap)

    def _update(self) -> None:
        tps = self.max_tps
        reason = "unlimited"
        limiting = None
        brake = None  # (server,) that crossed a HARD limit / min free space

        # TLog smoothers are keyed by the TLog's own endpoint token: a
        # recovery's fresh TLogs must start with fresh models, not inherit a
        # deposed slot-mate's backlog estimate; departed keys are pruned
        target_bytes = float(self.knobs.TARGET_QUEUE_BYTES)
        hard_tlog = float(self.knobs.TLOG_HARD_LIMIT_BYTES)
        tlogs = self.tlogs_fn()
        live_keys = set()
        self._tlog_names = {}
        for i, t in enumerate(tlogs):
            key = t.commit_stream.endpoint.token
            live_keys.add(key)
            self._tlog_names[key] = f"tlog{i}"
            raw = float(t.bytes_queued)
            q = self._smoothed(self._queue_smoothers, key, raw)
            lim = self._limit(q, target_bytes, self.max_tps)
            if lim < tps:
                tps, reason, limiting = lim, "tlog_queue", f"tlog{i}"
            if hard_tlog and raw >= hard_tlog and brake is None:
                # the RAW gauge, not the smoothed model: the e-brake exists
                # for exactly the moment smoothing would lag behind
                brake = f"tlog{i}"
        for key in [k for k in self._queue_smoothers if k not in live_keys]:
            del self._queue_smoothers[key]

        # storage smoothers key by TAG: a healed replacement inherits its
        # predecessor's model on purpose (same data responsibility)
        target_lag = 2.0 * self.knobs.mvcc_window_versions
        target_squeue = float(self.knobs.TARGET_STORAGE_QUEUE_BYTES)
        hard_squeue = float(self.knobs.STORAGE_HARD_LIMIT_BYTES)
        free_target = self.knobs.FREE_SPACE_TARGET_FRACTION
        free_min = self.knobs.MIN_FREE_SPACE_FRACTION
        live_tags = set()
        for ss in self.storage:
            live_tags.add(ss.tag)
            lag = self._smoothed(
                self._lag_smoothers, ss.tag,
                float(ss.version.get() - ss.durable_version),
            )
            lim = self._limit(lag, target_lag, self.max_tps)
            if lim < tps:
                tps, reason, limiting = lim, "storage_lag", ss.tag
            # bytes-in-queue spring (applied-above-durable; the reference's
            # storage queue input to updateRate)
            raw_q = float(getattr(ss, "queue_bytes", 0))
            q = self._smoothed(self._squeue_smoothers, ss.tag, raw_q)
            lim = self._limit(q, target_squeue, self.max_tps)
            if lim < tps:
                tps, reason, limiting = lim, "storage_queue", ss.tag
            if hard_squeue and raw_q >= hard_squeue and brake is None:
                brake = ss.tag
            # free-space squeeze (storage_server_min_free_space): linear
            # from full rate at the target fraction down to the floor at
            # the minimum; at or below the minimum the e-brake engages
            free = self._free_space(ss)
            if free is not None and free < free_target:
                frac = max(0.0, (free - free_min) / (free_target - free_min))
                lim = max(self.max_tps * frac, self.max_tps * 0.01)
                if lim < tps:
                    tps, reason, limiting = lim, "free_space", ss.tag
                if free <= free_min and brake is None:
                    brake = ss.tag
        for tag in [t for t in self._lag_smoothers if t not in live_tags]:
            del self._lag_smoothers[tag]
        for tag in [t for t in self._squeue_smoothers if t not in live_tags]:
            del self._squeue_smoothers[tag]

        if self.manual_tps_cap is not None and self.manual_tps_cap < tps:
            tps, reason, limiting = self.manual_tps_cap, "manual_throttle", None

        self.e_brake = brake is not None
        if brake is not None:
            # e-brake: slam the budget to the floor NOW — the smoother's
            # job is to keep transients from whipsawing admission, but a
            # queue past its hard limit / a nearly-full disk is not a
            # transient, and every admitted transaction digs the hole
            # deeper.  The floor (0.1% of max) keeps the recovery path and
            # operator transactions alive.
            tps, reason, limiting = self.max_tps * 0.001, "e_brake", brake
            self._budget.reset(tps)
            self.tps_budget = tps
            self.batch_tps_budget = 0.0
        else:
            self._budget.set_total(tps)
            self.tps_budget = max(self._budget.smooth_total(), self.max_tps * 0.01)
            if self.manual_tps_cap is not None:
                # the cap is a hard ceiling, not a smoothed target
                self.tps_budget = min(self.tps_budget, self.manual_tps_cap)
            # batch-priority budget (the reference's separate batch limit):
            # batch traffic starves FIRST — it reaches zero while
            # default-class work still has 25% of the full rate left
            self.batch_tps_budget = max(
                0.0, (self.tps_budget - 0.25 * self.max_tps) / 0.75
            )
        # attribute the hot RANGE behind a storage-side limit from the
        # limiting server's bandwidth samples (busiest sampled key): the
        # difference between "ss-1-r0 is slow" and "rw/000123 is hot"
        shard, shard_bps = None, 0.0
        if reason in ("storage_queue", "storage_lag", "e_brake"):
            ss = next((s for s in self.storage if s.tag == limiting), None)
            busiest = getattr(ss, "busiest_range", None)
            if busiest is not None:
                hot_key, shard_bps = busiest()
                if hot_key is not None:
                    shard = repr(hot_key)
        self.limiting_shard = shard
        self.limiting_shard_bps = shard_bps

        if reason != self.limit_reason:
            if reason == "storage_queue":
                testcov("ratekeeper.limit_storage_queue")
            elif reason == "free_space":
                testcov("ratekeeper.limit_free_space")
            elif reason == "e_brake":
                testcov("ratekeeper.e_brake")
            if self.trace is not None:
                # only on TRANSITIONS (not every 0.25s tick): the latest
                # event is what status scrapes; WARN while limited makes it
                # a message
                self.trace.trace(
                    "RkUpdate",
                    severity=SEV_WARN if reason != "unlimited" else SEV_INFO,
                    track_latest="ratekeeper",
                    Reason=reason,
                    LimitingServer=limiting,
                    LimitingShard=shard,
                    LimitingShardBps=round(shard_bps, 1),
                    TPSBudget=round(self.tps_budget, 1),
                )
        self.limit_reason = reason
        self.limiting_server = limiting

    def status(self) -> dict:
        """The RkUpdate view: budget, binding constraint, per-server model.
        TLog rows are attributed as `tlogN` (the limiting_server naming),
        never raw endpoint tokens — the model is keyed by token internally
        so recoveries reset it, but operators read slot names."""
        return {
            "tps_budget": self.tps_budget,
            "batch_tps_budget": self.batch_tps_budget,
            "limit_reason": self.limit_reason,
            "limiting_server": self.limiting_server,
            "limiting_shard": self.limiting_shard,
            "limiting_shard_bps": self.limiting_shard_bps,
            "e_brake": self.e_brake,
            "storage_lag_smoothed": {
                tag: s.smooth_total() for tag, s in self._lag_smoothers.items()
            },
            "storage_queue_smoothed": {
                tag: s.smooth_total()
                for tag, s in self._squeue_smoothers.items()
            },
            "free_space": {
                ss.tag: self._free_space(ss) for ss in self.storage
            },
            "tlog_queue_smoothed": {
                self._tlog_names.get(k, f"tlog?{k[:6]}"): s.smooth_total()
                for k, s in self._queue_smoothers.items()
            },
        }

    async def _run(self) -> None:
        while True:
            await self.loop.delay(self.knobs.RATEKEEPER_UPDATE_INTERVAL, TaskPriority.RATEKEEPER)
            self._update()

    def stop(self) -> None:
        self._task.cancel()
