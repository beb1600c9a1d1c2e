"""Typed tunables registry — the knobs system (flow/Knobs.h:37-48).

Defaults here; simulation may randomize (the reference's
Knobs(randomize=true), fdbserver/Knobs.cpp:33) and anything is overridable
by name, the `--knob_NAME=value` path.

Copy of the reference package's `Knobs`, `ClientKnobs` and `CoreKnobs`,
with the same defaults and the same randomization: the same
`DeterministicRandom` seed gives the same values in both packages.  The
reference's `ENV_KNOBS` table of environment switches is not carried: the
port reads no environment, and each switch is a keyword of the class it
selects (`Resolver(pipeline=...)`, `RealNetwork(protocol_version=...)`,
`DeviceConflictSet(phase_timing=...)`)."""

from __future__ import annotations

from typing import Any


class Knobs:
    """A bag of typed knobs.  Subclasses declare defaults in __init__ via
    self.init(name, value, randomize=fn) and users override by attribute or
    set_knob(name, string_value)."""

    def __init__(self) -> None:
        self._defs: dict[str, type] = {}

    def init(self, name: str, value: Any) -> None:
        self._defs[name] = type(value)
        setattr(self, name, value)

    def set_knob(self, name: str, value: str) -> None:
        if name not in self._defs:
            raise KeyError(f"no such knob: {name}")
        ty = self._defs[name]
        setattr(self, name, ty(value) if ty is not bool else value in ("1", "true", "True"))

    def names(self) -> list[str]:
        return sorted(self._defs)


class ClientKnobs(Knobs):
    """Client-side tunables — the reference splits knobs into ClientKnobs
    (fdbclient/Knobs.cpp) and ServerKnobs; these govern the NativeAPI
    retry loop and request routing, not any server role."""

    def __init__(self, randomize=None) -> None:
        super().__init__()
        r = randomize
        # on_error retry backoff (reference DEFAULT_BACKOFF/BACKOFF_GROWTH_RATE)
        self.init("DEFAULT_BACKOFF", 0.01 if r is None else 0.005 + r.random() * 0.02)
        self.init("MAX_BACKOFF", 1.0)
        # per-request deadline before the client re-routes / reports
        # TimedOut (covers GRV, reads, watches)
        self.init("REQUEST_TIMEOUT", 5.0)
        # commit deadline: past it the result is UNKNOWN (the fence dance)
        self.init("COMMIT_TIMEOUT", 5.0)
        # pause before re-picking a replica after a dead endpoint
        self.init("REROUTE_DELAY", 0.05)
        # RYW SnapshotCache byte cap per transaction (client/
        # snapshot_cache.py): prior reads at the transaction's read version
        # are kept and re-served locally; past the cap the least-recently-
        # touched known range is evicted (LRU-ish — the newest survivor
        # never is, so an over-cap read still completes consistently)
        self.init("RYW_CACHE_BYTES", 1 << 22)


class CoreKnobs(Knobs):
    def __init__(self, randomize=None) -> None:
        super().__init__()
        r = randomize  # DeterministicRandom or None
        # MVCC window: versions/sec * seconds (reference VERSIONS_PER_SECOND
        # 1e6 and MAX_WRITE_TRANSACTION_LIFE 5.0, fdbserver/Knobs.cpp:30-34;
        # simulation sometimes shrinks the window to 1s to stress TooOld)
        self.init("VERSIONS_PER_SECOND", 1_000_000)
        life = 5.0 if r is None or not r.coinflip(0.25) else 1.0
        self.init("MAX_WRITE_TRANSACTION_LIFE", life)
        self.init("MAX_READ_TRANSACTION_LIFE", life)
        # proxy commit batching (reference COMMIT_TRANSACTION_BATCH_INTERVAL_*)
        self.init("COMMIT_BATCH_INTERVAL_MIN", 0.0005)
        self.init("COMMIT_BATCH_INTERVAL_MAX", 0.010)
        self.init("COMMIT_BATCH_MAX_COUNT", 32768)
        # grv batching
        self.init("GRV_BATCH_INTERVAL", 0.0005)
        # how far version assignment may outrun the newest committed version
        # (reference MAX_VERSIONS_IN_FLIGHT, fdbserver/Knobs.cpp: 100e6) —
        # the sequencer clamps assignment and the proxy's phase-4 throttle
        # parks batches past it
        self.init("MAX_VERSIONS_IN_FLIGHT", 100_000_000)
        # resolver
        self.init("RESOLVER_STATE_MEMORY_LIMIT", 1 << 30)
        # resolutionBalancing (masterserver.actor.cpp:964): poll cadence and
        # the busiest/mean load ratio that triggers a split move
        self.init("RESOLUTION_BALANCE_INTERVAL", 0.5)
        self.init("RESOLUTION_BALANCE_RATIO", 2.0)
        self.init("RESOLUTION_BALANCE_MIN_LOAD", 64)
        # dynamic configuration poll (\xff/conf watcher)
        self.init("CONF_POLL_INTERVAL", 0.5)
        self.init("SAMPLE_OFFSET_PER_KEY", 100)
        # storage
        self.init("STORAGE_DURABILITY_LAG", 0.05)
        self.init("DESIRED_TEAM_SIZE", 3)
        # commit-path retry budget: past this, the proxy reports UNKNOWN and
        # escalates to recovery (longer than FAILURE_TIMEOUT so dead-role
        # heartbeat detection normally wins; this covers proxy-only partitions)
        self.init("COMMIT_PATH_GIVEUP", 4.0)
        # failure detection
        self.init("FAILURE_TIMEOUT", 1.0 if r is None else 0.5 + r.random())
        self.init("HEARTBEAT_INTERVAL", 0.2)
        # ratekeeper
        self.init("TARGET_QUEUE_BYTES", 1 << 27)
        self.init("RATEKEEPER_UPDATE_INTERVAL", 0.25)
        # smoothing time constant for the ratekeeper's per-server model and
        # published budget (reference SMOOTHING_AMOUNT, Knobs.cpp)
        self.init("RATEKEEPER_SMOOTHING_E", 1.0)
        # -- resource-exhaustion plane (docs/OPERATIONS.md "Disk pressure")
        # TLog queue hard limit (reference TLOG_HARD_LIMIT_BYTES): past it
        # the TLog REFUSES commits loudly (SEV_WARN TLogCommitRefused,
        # never a silent ack) instead of growing without bound; ratekeeper
        # e-brakes admission before a healthy cluster ever reaches it —
        # which needs HEADROOM above TARGET_QUEUE_BYTES (1<<27): the
        # spring must have squeezed long before the refusal line
        self.init("TLOG_HARD_LIMIT_BYTES", 1 << 28)
        # storage queue-byte spring (reference TARGET_BYTES_PER_STORAGE_
        # SERVER / STORAGE_HARD_LIMIT_BYTES): smoothed bytes-in-queue per
        # storage server squeeze admission toward the target; crossing the
        # hard limit slams the e-brake
        self.init("TARGET_STORAGE_QUEUE_BYTES", 1 << 26)
        self.init("STORAGE_HARD_LIMIT_BYTES", 1 << 27)
        # free-space limiting (reference storage_server_min_free_space):
        # admission squeezes proportionally once a storage disk's free
        # fraction drops below the target, and the e-brake engages at the
        # minimum — commits stop before the disk physically fills
        self.init("FREE_SPACE_TARGET_FRACTION", 0.25)
        self.init("MIN_FREE_SPACE_FRACTION", 0.05)
        # io_timeout fail-fast (reference io_timeout / MAX_STORAGE_COMMIT_
        # TIME): a disk sync stalled past this many virtual seconds KILLS
        # the owning process through the ordinary kill/recovery machinery
        # rather than wedging the commit plane (storage/files.py)
        self.init("IO_TIMEOUT_S", 5.0)
        # file-level page cache (storage/pagecache.py, the AsyncFileCached
        # analog / reference PAGE_CACHE_4K pool): ONE byte-bounded LRU
        # pool per process lifetime shared by every storage file (B-tree
        # data+header, memory-engine WAL, TLog queue); 0 disables.
        # PAGE_CACHE_4K is the cache page size; READAHEAD_PAGES is how
        # many extra pages a sequential-scan miss fetches in the same
        # pread.  Simulation sometimes shrinks the pool to a few pages so
        # chaos seeds stress eviction/refill instead of an always-hot
        # cache.
        self.init(
            "PAGE_CACHE_BYTES",
            2 << 20 if r is None or not r.coinflip(0.25) else 1 << 14,
        )
        self.init("PAGE_CACHE_4K", 4096)
        self.init("READAHEAD_PAGES", 8)
        # the ssd engine's PARSED-page cache budget (storage/btree.py):
        # decoded pages held above the file-level cache, in approximate
        # heap bytes — byte-bounded so a few huge leaves can't blow the
        # host heap (was a page COUNT blind to page size)
        self.init("BTREE_CACHE_BYTES", 4 << 20)

        # device supervisor (conflict/supervisor.py): the DEFAULT_BACKOFF
        # family applied to the hardware conflict backend.  Every device
        # interaction is bounded by DEVICE_WATCHDOG_S (wall-clock watchdog
        # on the real network; under sim the hang is injected virtually);
        # failed attempts retry with exponential backoff
        # (DEVICE_RETRY_BACKOFF doubling to DEVICE_MAX_BACKOFF), and after
        # DEVICE_RETRY_LIMIT consecutive failures the circuit breaker trips
        # to the CPU reference backend; re-probes then run every
        # DEVICE_REPROBE_INTERVAL seconds until a parity-checked promotion
        # succeeds (docs/OPERATIONS.md "Degraded device backend")
        self.init("DEVICE_WATCHDOG_S", 30.0)
        self.init("DEVICE_RETRY_LIMIT", 3)
        self.init("DEVICE_RETRY_BACKOFF", 0.05 if r is None else 0.02 + r.random() * 0.1)
        self.init("DEVICE_MAX_BACKOFF", 5.0)
        self.init("DEVICE_REPROBE_INTERVAL", 5.0 if r is None else 1.0 + r.random() * 8.0)

        # blob store (storage/blobstore.py): the retrying client's budget.
        # Every operation against the object store retries transient and
        # checksum failures BLOB_RETRY_LIMIT times with exponential backoff
        # from BLOB_BACKOFF_S doubling to BLOB_MAX_BACKOFF_S (each retry
        # traces a SEV_WARN BlobRequestRetried); BLOB_PART_BYTES is the
        # multipart chunk size uploads are split into.
        self.init("BLOB_RETRY_LIMIT", 6)
        self.init("BLOB_BACKOFF_S", 0.02 if r is None else 0.01 + r.random() * 0.05)
        self.init("BLOB_MAX_BACKOFF_S", 1.0)
        self.init("BLOB_PART_BYTES", 1 << 15)

        # trace plane (docs/OBSERVABILITY.md "Distributed tracing"): the
        # TraceEvent file/ring discipline.  TRACE_SEVERITY drops events
        # below it entirely (the reference's --trace severity floor);
        # TRACE_ROLL_SIZE / TRACE_MAX_LOGS bound the rolling per-process
        # trace files (--maxlogssize / --maxlogs analogs); every role
        # emits its rate-converted `*Metrics` event each METRICS_INTERVAL
        # (flow/Stats.h traceCounters cadence)
        self.init("TRACE_SEVERITY", 5)
        self.init("TRACE_ROLL_SIZE", 10 << 20)
        self.init("TRACE_MAX_LOGS", 10)
        self.init("METRICS_INTERVAL", 5.0)
        # Net2 slow-task analog: one run-loop callback exceeding this many
        # HOST WALL seconds traces a SEV_WARN SlowTask event (the stall a
        # virtual clock cannot see — a long jit compile, a blocking
        # syscall).  Soak triage (tools/soak.py) surfaces the per-seed
        # SlowTask count.
        self.init("SLOW_TASK_THRESHOLD", 0.5)

        # process supervisor (tools/fdbmonitor.py; fdbmonitor.cpp restart
        # backoff): a crashed child restarts after MONITOR_RESTART_BACKOFF
        # seconds, doubling per death up to MONITOR_MAX_BACKOFF; a run of
        # MONITOR_BACKOFF_RESET seconds before dying resets the delay (only
        # a crash LOOP escalates).  The conf file is polled for changes
        # every MONITOR_CONF_POLL seconds (SIGHUP forces it), and a stopped
        # child gets MONITOR_KILL_GRACE seconds between SIGTERM and
        # SIGKILL.  The conf's [general] section overrides all five
        # (restart-delay / max-restart-delay / backoff-reset / conf-poll /
        # kill-grace).
        self.init("MONITOR_RESTART_BACKOFF", 0.25)
        self.init("MONITOR_MAX_BACKOFF", 8.0)
        self.init("MONITOR_BACKOFF_RESET", 10.0)
        self.init("MONITOR_CONF_POLL", 0.5)
        self.init("MONITOR_KILL_GRACE", 5.0)

        # commit-plane wire (docs/WIRE.md): transport write coalescing.
        # Queued frames flush once per reactor tick, or immediately once a
        # connection's queue passes WIRE_FLUSH_BYTES (bounds both memory
        # and burst latency); WIRE_COALESCE=false restores flush-per-send.
        self.init("WIRE_COALESCE", True)
        self.init("WIRE_FLUSH_BYTES", 1 << 18)

        # data distribution (DataDistribution.actor.cpp): storage failure
        # ping cadence, shard-size poll cadence, and the split threshold
        # (the reference splits on byte size via StorageMetrics; we count keys)
        # TLog in-memory budget before lagging tags spill payloads to the
        # disk queue (TLogServer spilled-data; TLOG_SPILL_THRESHOLD analog)
        self.init("TLOG_SPILL_BYTES", 1 << 22)

        self.init("DD_PING_INTERVAL", 0.25)
        self.init("DD_SPLIT_INTERVAL", 0.5)
        self.init("DD_SHARD_SPLIT_KEYS", 100_000)
        # StorageMetrics-style split thresholds: shard byte size and
        # committed write bandwidth (reference SHARD_MAX_BYTES +
        # shardSplitter's bandwidth half)
        self.init("DD_SHARD_SPLIT_BYTES", 10_000_000)
        self.init("DD_SHARD_SPLIT_WRITE_BYTES_PER_SEC", 1_000_000)
        # shardMerger (DataDistributionTracker): ADJACENT shards whose
        # combined size is below the merge threshold collapse into one —
        # a fraction of the split point so merge/split cannot oscillate
        self.init("DD_SHARD_MERGE_BYTES", 1_000_000)
        self.init("DD_SHARD_MERGE_KEYS", 10_000)
        # -- load-metric plane (roles/storage_metrics.py; StorageMetrics.
        # actor.h byteSample / bytesReadSample analogs).  The sampling UNIT
        # is the Horvitz-Thompson weight floor: an entry of size sz is
        # sampled with probability min(1, sz/unit), so per-range estimates
        # are unbiased with relative error ~ sqrt(unit / range_bytes).
        # Simulation sometimes shrinks the units so chaos seeds exercise
        # the dense-sample paths too.
        self.init(
            "BYTE_SAMPLE_UNIT",
            512 if r is None or not r.coinflip(0.25) else 32,
        )
        self.init(
            "BANDWIDTH_SAMPLE_UNIT",
            512 if r is None or not r.coinflip(0.25) else 32,
        )
        # bandwidth decay time constant (reference's 2x SMOOTHING_AMOUNT
        # spirit): rate = decayed_weight / tau
        self.init("BANDWIDTH_SMOOTH_SECONDS", 10.0)
        # hot-shard detection + priority relocation (readHotShard analog):
        # a shard whose combined read+write sampled bandwidth exceeds the
        # threshold — and that cannot usefully split — is queued for
        # relocation to the least-loaded team every relocation interval
        self.init("DD_HOT_SHARD_BYTES_PER_KSEC", 50_000_000)
        self.init("DD_HOT_RELOCATION_INTERVAL", 2.0)

    @property
    def mvcc_window_versions(self) -> int:
        return int(self.VERSIONS_PER_SECOND * self.MAX_WRITE_TRANSACTION_LIFE)
