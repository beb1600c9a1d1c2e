"""Structured trace events + metrics — the TraceEvent system (flow/Trace.h:137).

Events are dicts with severity/type/fields, collected per-process by a
TraceCollector: in tests/simulation they stay in memory for assertions; in
production they stream to rolling JSONL files (the reference rolls XML
files under --maxlogssize/--maxlogs; `TraceFileSink` is that analog).
`track_latest` retains the newest event per key — the transport the status
subsystem scrapes (fdbserver/Status.actor.cpp:1698 reads trackLatest
snapshots).  Counters mirror flow/Stats.h:57 CounterCollection, including
the periodic rate-converted `*Metrics` emission every role runs
(`spawn_role_metrics`).

Copy of the reference package's module.  `g_trace_batch` is this module's
own global, apart from the reference's: the port's roles land their
stations here.
"""

from __future__ import annotations

import json
import os
import time as _time
from collections import deque
from typing import Any, Callable


SEV_DEBUG, SEV_INFO, SEV_WARN, SEV_WARN_ALWAYS, SEV_ERROR = 5, 10, 20, 30, 40


# The SEV_WARN+ event vocabulary — the status-schema discipline applied to
# warning traces (the reference checks status docs against Schemas.cpp; we
# check WARN+ trace call sites against this set).  Every `trace(...)` call
# site with severity SEV_WARN or above must name EXACTLY ONE entry here,
# and each entry must have exactly one call site, so a new warning event
# can never silently shadow an existing one in `track_latest` or the
# operator message list (tests/test_trace_plane.py walks the codebase).
WARN_EVENT_TYPES = frozenset({
    "TransportFrameRejected",    # rpc/transport.py: length-corrupt header
    "TransportDecodeFailed",     # rpc/transport.py: undecodable frame body
    "TransportProtocolMismatch", # rpc/transport.py: mixed-version peer
    "RkUpdate",                  # control/ratekeeper.py: limiting reason
    "SlowTask",                  # runtime/core.py: run-loop callback over
                                 # SLOW_TASK_THRESHOLD host wall seconds
    "SoakSeedFailed",            # tools/soak.py: a campaign seed's verdict
                                 # with the failure, for triage scrapes
    "BlobRequestRetried",        # storage/blobstore.py: one blob-store
                                 # retry (backoff in flight); soak triage
                                 # summarizes retry storms per seed
    "IoTimeoutKilled",           # storage/files.py: a disk sync stalled
                                 # past IO_TIMEOUT_S fail-fasted its
                                 # process (kill/recovery takes over)
    "TLogCommitRefused",         # roles/tlog.py: queue past
                                 # TLOG_HARD_LIMIT_BYTES — commit refused,
                                 # never silently acked
    "TLogDiskError",             # roles/tlog.py: the durable log's disk
                                 # refused (ENOSPC/injected error); the
                                 # push is unacked and the proxy escalates
    "ProcessDied",               # tools/fdbmonitor.py: a supervised OS
                                 # process exited (Section/Pid/ExitCode);
                                 # soak triage folds these into
                                 # first_events per artifact dir
    "MonitorConfInvalid",        # tools/fdbmonitor.py: torn/unparseable
                                 # conf — the LAST GOOD conf stays live
                                 # (never kill the world over a half-save)
})


class TraceFileSink:
    """Rolling line-buffered JSONL trace files — the reference's rolling
    trace files (`--maxlogssize` / `--maxlogs`, flow/Trace.cpp).  Lines go
    to `<path>.<seq>.jsonl`; once the current file passes `roll_size`
    bytes the NEXT line opens `<seq+1>`, and files older than `max_logs`
    generations are deleted.  Line-buffered (buffering=1): every event is
    flushed to the OS as it is written, so a crashed process loses at most
    the line being formatted — the crash-safe property operators rely on
    to debug the crash itself."""

    def __init__(self, path: str, roll_size: int = 10 << 20,
                 max_logs: int = 10) -> None:
        self.path = path
        self.roll_size = int(roll_size)
        self.max_logs = max(int(max_logs), 1)
        # resume after the newest existing generation rather than appending
        # to (and re-rolling) a previous run's files — scan the DIRECTORY
        # for the highest sequence, since a previous run's pruning leaves a
        # gap at the low numbers (stepping up from 0 would stop there and
        # collide with the old run's surviving files)
        base = os.path.basename(path)
        seqs = []
        for f in os.listdir(os.path.dirname(path) or "."):
            if f.startswith(base + ".") and f.endswith(".jsonl"):
                mid = f[len(base) + 1 : -len(".jsonl")]
                if mid.isdigit():
                    seqs.append(int(mid))
        self._seq = max(seqs) + 1 if seqs else 0
        self._f = None
        self._bytes = 0
        self._open()

    def _fname(self, seq: int) -> str:
        return f"{self.path}.{seq}.jsonl"

    def _open(self) -> None:
        self._f = open(self._fname(self._seq), "a", buffering=1)
        self._bytes = self._f.tell()

    @property
    def current_file(self) -> str:
        return self._fname(self._seq)

    def files(self) -> list[str]:
        """Every generation still on disk, oldest first."""
        return [
            self._fname(s) for s in range(self._seq + 1)
            if os.path.exists(self._fname(s))
        ]

    def write(self, line: str) -> None:
        if self._bytes > 0 and self._bytes + len(line) > self.roll_size:
            self._roll()
        self._f.write(line)
        self._bytes += len(line)

    def _roll(self) -> None:
        self._f.close()
        self._seq += 1
        self._open()
        stale = self._seq - self.max_logs
        if stale >= 0:
            try:
                os.remove(self._fname(stale))
            except OSError:
                pass

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class TraceCollector:
    """Per-process event collector.  The event ring is a flight recorder:
    `keep` bounds memory and the ring keeps the NEWEST events (old ones
    are overwritten — `count()` still reports every event ever traced).
    `min_severity` drops events below the `TRACE_SEVERITY` knob entirely;
    `machine` (when set) stamps a host/process identity on every event for
    cross-process trace joins (tools/trace_tool.py)."""

    def __init__(self, clock: Callable[[], float] | None = None,
                 sink=None, keep: int = 50000,
                 min_severity: int = SEV_DEBUG,
                 machine: str | None = None,
                 wall_clock: Callable[[], float] | None = None) -> None:
        self._clock = clock or (lambda: 0.0)
        # the clock behind the file lines' WallTime stamp.  Real processes
        # keep the default (cross-process trace joins need a SHARED clock,
        # which only the host wall provides); deterministic sim clusters
        # bind their virtual clock instead, so a seed's rolled trace files
        # are byte-stable across reruns — same discipline as the reference,
        # where sim trace time is g_network->now().  The one sanctioned
        # exception is SlowTask: its DurationS payload is a HOST-wall
        # measurement of a reactor stall (runtime/core.py) — profiling
        # data virtual time cannot see — so those lines may differ
        # between reruns (tests/test_flowlint.py pins the carve-out)
        self._wall_clock = wall_clock or _time.time  # flowlint: ok wall-clock (default for real processes; sim binds the sim clock)
        self._sink = sink  # TextIO or TraceFileSink: anything with write(str)
        self.min_severity = min_severity
        self.machine = machine
        self.events: deque[dict[str, Any]] = deque(maxlen=keep)
        self.latest: dict[str, dict[str, Any]] = {}
        self._counts: dict[str, int] = {}

    def trace(self, event_type: str, severity: int = SEV_INFO,
              track_latest: str | None = None, **fields: Any) -> dict[str, Any]:
        ev = {"Type": event_type, "Severity": severity, "Time": self._clock(), **fields}
        if self.machine is not None:
            ev["Machine"] = self.machine
        if severity < self.min_severity:
            return ev
        self._counts[event_type] = self._counts.get(event_type, 0) + 1
        self.events.append(ev)
        if track_latest is not None:
            self.latest[track_latest] = ev
        if self._sink is not None:
            # WallTime rides only the FILE copy: cross-process joins need a
            # shared clock (each process's `Time` has its own origin), and
            # the in-memory events deterministic sim tests read must not
            # carry wall time
            try:
                self._sink.write(
                    json.dumps({**ev, "WallTime": self._wall_clock()},
                               default=str)
                    + "\n"
                )
            except OSError:
                pass  # a full disk must not kill the process
        return ev

    def find(self, event_type: str) -> list[dict[str, Any]]:
        return [e for e in self.events if e["Type"] == event_type]

    def count(self, event_type: str) -> int:
        """Events of this type ever traced — INCLUDING ones the ring has
        since overwritten (a flight recorder forgets the payload, not the
        count)."""
        return self._counts.get(event_type, 0)


class TraceBatch:
    """Per-transaction pipeline timelines — the g_traceBatch analog
    (flow/Trace.h:253; the reference emits TransactionDebug/CommitDebug
    events keyed by a sampled debug ID at every pipeline station, and tools
    reconstruct a transaction's journey by joining on the ID).

    A module global, exactly like the reference's: role code at any layer
    calls `g_trace_batch.add(location, debug_id)` without plumbing a
    collector through every constructor.  The newest cluster attaches its
    clock AND (when given) its TraceCollector, so every station also lands
    in the collector as a `TransactionDebug` event — which is how stations
    reach the per-process trace FILES that tools/trace_tool.py joins across
    processes; tests read `timeline(debug_id)` in memory."""

    def __init__(self) -> None:
        self.events: list[dict[str, Any]] = []
        self.suppressed = 0
        self._clock: Callable[[], float] = lambda: 0.0
        self._collector: TraceCollector | None = None
        self._keep = 100_000

    def attach_clock(self, clock: Callable[[], float],
                     collector: TraceCollector | None = None) -> None:
        """Bind the newest cluster's clock AND start a fresh event log: two
        same-seed clusters derive identical debug IDs, so carrying events
        across would interleave different runs under one ID (and pin the
        previous cluster's loop in memory via the old clock closure).
        `collector` additionally mirrors every station into that cluster's
        TraceCollector (and thus its trace files)."""
        self._clock = clock
        self._collector = collector
        self.clear()

    def add(self, location: str, debug_id: str | None) -> None:
        if debug_id is None:
            return
        if len(self.events) < self._keep:
            self.events.append(
                {"Time": self._clock(), "Location": location, "ID": debug_id}
            )
        else:
            self.suppressed += 1
        if self._collector is not None:
            self._collector.trace(
                "TransactionDebug", Location=location, ID=debug_id
            )

    def timeline(self, debug_id: str) -> list[dict[str, Any]]:
        return sorted(
            (e for e in self.events if e["ID"] == debug_id),
            key=lambda e: e["Time"],
        )

    def clear(self) -> None:
        self.events = []
        self.suppressed = 0


g_trace_batch = TraceBatch()


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str, collection: "CounterCollection | None" = None) -> None:
        self.name = name
        self.value = 0
        if collection is not None:
            collection.add(self)

    def add(self, n: int = 1) -> None:
        self.value += n

    __iadd__ = None  # use .add()


class CounterCollection:
    def __init__(self, name: str) -> None:
        self.name = name
        self.counters: list[Counter] = []
        self._prev: dict[str, int] | None = None
        self._prev_time = 0.0

    def add(self, c: Counter) -> None:
        self.counters.append(c)

    def counter(self, name: str) -> Counter:
        return Counter(name, self)

    def snapshot(self) -> dict[str, int]:
        return {c.name: c.value for c in self.counters}

    def rates(self, now: float) -> dict[str, float]:
        """Per-second deltas since the previous rates() call — the
        Counter::getRate analog (flow/Stats.h): `*Metrics` events and
        status report RATES over the emission interval, not lifetime
        totals.  The first call (no remembered snapshot) reports zeros and
        arms the baseline."""
        cur = self.snapshot()
        prev, prev_t = self._prev, self._prev_time
        self._prev, self._prev_time = cur, now
        dt = now - prev_t
        if prev is None or dt <= 0:
            return {k: 0.0 for k in cur}
        return {k: (v - prev.get(k, 0)) / dt for k, v in cur.items()}


def spawn_role_metrics(loop, process, trace: TraceCollector, event_type: str,
                       fields_fn: Callable[[], dict], interval: float,
                       priority: int = 0, instance: str | None = None):
    """Periodic `<Role>Metrics` trace emission — the reference's
    CounterCollection cadence (flow/Stats.h:57 traceCounters): every
    `interval` (simulated) seconds the role's `fields_fn()` snapshot lands
    in the cluster's collector, `track_latest`-keyed per role instance so
    status always holds the newest sample while the event stream carries
    the time-series.

    `process` bounds the emitter's life: a deposed directly-constructed
    role loses its process without `stop()` ever being called, and a stale
    generation's emitter must not keep narrating over its successor's.
    Pass None for emitters not tied to a process (the network fabric)."""

    name = instance or (process.name if process is not None else event_type)
    try:
        fields_fn()  # arm the rate baselines NOW, so the first emission
    except Exception:  # reports the first interval's real deltas, not zeros
        pass

    async def emit() -> None:
        last = loop.now()
        while True:
            await loop.delay(interval, priority)
            if process is not None and not process.alive:
                return
            now = loop.now()
            trace.trace(
                event_type,
                track_latest=f"{event_type}:{name}",
                Elapsed=now - last,
                # per-instance attribution IN the event too: several
                # same-role emitters in one process must stay separable in
                # the event stream / trace files, not just in track_latest
                Instance=name,
                **fields_fn(),
            )
            last = now

    return loop.spawn(emit(), priority, f"metrics-{event_type}")


def spawn_wire_metrics(loop, trace: TraceCollector, wire, interval: float,
                       source: str, priority: int = 0, process=None):
    """WireStats delta emission (`WireMetrics`): the transport's slice of
    the periodic metrics plane — codec frame/byte rates plus the cumulative
    pickle-fallback and coalescing counters (docs/WIRE.md)."""
    prev: dict = {}

    def fields() -> dict:
        snap = wire.snapshot()
        dt = max(loop.now() - prev.get("_t", loop.now() - interval), 1e-9)
        out = {
            "Source": source,
            "FramesEncodedPerSec":
                (snap["frames_encoded"] - prev.get("frames_encoded", 0)) / dt,
            "FramesDecodedPerSec":
                (snap["frames_decoded"] - prev.get("frames_decoded", 0)) / dt,
            "BytesEncodedPerSec":
                (snap["bytes_encoded"] - prev.get("bytes_encoded", 0)) / dt,
            "BytesDecodedPerSec":
                (snap["bytes_decoded"] - prev.get("bytes_decoded", 0)) / dt,
            "PickleFallbacks": snap["pickle_fallbacks"],
            "DecodeFallbacks": snap["decode_fallbacks"],
            "FramesPerFlush": snap["frames_per_flush"],
        }
        prev.update(snap)
        prev["_t"] = loop.now()
        return out

    return spawn_role_metrics(
        loop, process, trace, "WireMetrics", fields, interval, priority,
        instance=source,
    )
