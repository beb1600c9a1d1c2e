"""Cluster status document — the clusterGetStatus analog
(fdbserver/Status.actor.cpp:1698; schema fdbclient/Schemas.cpp).

Aggregates role counters, trace `track_latest` snapshots, and queue depths
into one machine-readable dict, the surface `fdbcli status` renders and
operators script against.

Copy of the reference package's module: the kernel roll-up and the
device messages report the port's sets (`kernel.backend` is "cuda" or
"cpu")."""

from __future__ import annotations

from typing import Any

from ..runtime.metrics import LatencyTracker
from ..runtime.trace import SEV_WARN


def _severity_name(sev: int) -> str:
    return {5: "debug", 10: "info", 20: "warn", 30: "warn_always"}.get(
        sev, "error"
    )


def _device_messages(resolvers) -> list[dict[str, Any]]:
    """A degraded or probing device backend is exactly the kind of
    'cluster serves but you should know' condition cluster.messages exists
    for (the runbook entry point: docs/OPERATIONS.md)."""
    msgs: list[dict[str, Any]] = []
    for i, r in enumerate(resolvers):
        h = getattr(r.cs, "health", None)
        if h is None:
            continue
        health = h()
        # message while NOT fully recovered: degraded/probing state, live
        # failure streak, or still serving from the CPU after a trip.  A
        # fresh resolver that hasn't probed yet (lazy first promotion) and
        # a fully re-promoted one (healthy, serving device) stay silent —
        # an empty message list must mean healthy.
        if (
            health["state"] != "healthy"
            or health["consecutive_failures"]
            or (health["serving"] == "cpu" and health["trips"])
        ):
            msgs.append({
                "name": "device_backend_degraded",
                "severity": "warn",
                "time": None,
                "description": (
                    f"resolver{i} conflict backend {health['state']}"
                    f" (serving {health['serving']},"
                    f" trips {health['trips']},"
                    f" last_failure {health['last_failure']},"
                    f" degraded {health['time_degraded_s']:.3f}s)"
                ),
            })
    return msgs


def _messages(trace, ratekeeper) -> list[dict[str, Any]]:
    """Operator-facing message list (the reference status doc's
    cluster.messages): every SEV_WARN+ `track_latest` snapshot becomes a
    message, plus the ratekeeper's live limiting reason — the two channels
    that say WHY a cluster is degraded rather than just that it is."""
    msgs: list[dict[str, Any]] = []
    for key, ev in sorted(trace.latest.items()):
        if ev.get("Severity", 0) >= SEV_WARN:
            msgs.append({
                "name": ev["Type"],
                "severity": _severity_name(ev["Severity"]),
                "time": ev.get("Time", 0.0),
                "description": ", ".join(
                    f"{k}={v}" for k, v in ev.items()
                    if k not in ("Type", "Severity", "Time")
                ),
            })
    if ratekeeper is not None and ratekeeper.limit_reason != "unlimited":
        msgs.append({
            "name": "performance_limited",
            "severity": "warn",
            "time": None,
            "description": (
                f"admission limited by {ratekeeper.limit_reason}"
                + (
                    f" on {ratekeeper.limiting_server}"
                    if ratekeeper.limiting_server else ""
                )
                + (
                    # the load-metric plane's attribution: the hot RANGE
                    # behind the limit, not just the hot process
                    f" (hot range {ratekeeper.limiting_shard})"
                    if ratekeeper.limiting_shard else ""
                )
                + f" (tps_budget {ratekeeper.tps_budget:.0f})"
            ),
        })
    return msgs


def _data_block(cluster, dd) -> dict[str, Any]:
    """cluster.data — the movingData/totalKVBytes analog, fed entirely by
    the storage servers' SAMPLED metric plane (dd.shard_load: one
    waitMetrics-style poll per shard, no scans): total estimated bytes,
    bytes overlapping in-flight fetchKeys ranges, and the top-k hottest
    shards by sampled read+write bandwidth."""
    load = dd.shard_load()
    moving_ranges = [
        (fs.begin, fs.end_key)
        for ss in cluster.storage for fs in ss._fetching
    ]

    def overlaps(m) -> bool:
        me = m["end"] if m["end"] is not None else b"\xff\xff\xff\xff\xff\xff"
        return any(b < me and m["begin"] < e for b, e in moving_ranges)

    ranked = sorted(
        load,
        key=lambda m: -(m["bytes_read_per_ksec"] + m["bytes_written_per_ksec"]),
    )
    return {
        "total_kv_bytes_estimate": sum(m["bytes"] for m in load),
        "moving_bytes_estimate": sum(m["bytes"] for m in load if overlaps(m)),
        "moving_ranges": len(moving_ranges),
        "shard_count": len(load),
        "hot_shards": [
            {
                "begin": repr(m["begin"]),
                "end": repr(m["end"]) if m["end"] is not None else None,
                "bytes": m["bytes"],
                "bytes_read_per_ksec": round(m["bytes_read_per_ksec"], 1),
                "bytes_written_per_ksec":
                    round(m["bytes_written_per_ksec"], 1),
                "team": list(m["team"]),
            }
            for m in ranked[:3]
        ],
    }


# Schema of the offline phase-profile artifact (phase_timings.py --json,
# embedded by bench.py as kernel.phase_profile).  Not part of the live
# status document — the profile needs dispatch barriers the hot path
# must not pay — but schema'd here next to the kernel roll-up so the two
# kernel-cost surfaces stay reviewed together.  Optional-key convention
# matches STATUS_SCHEMA ("?" suffix = may be absent).
PHASE_PROFILE_SCHEMA: dict[str, Any] = {
    "backend": str,            # torch device the profile ran on
    "small": bool,             # reduced shapes (bench embed) vs full probe
    "cap": int,                # main state capacity profiled
    "rec_cap": int,            # LSM recent capacity profiled
    "merge_impl_default": str,  # compiled-in fold default (scatter)
    "shapes": dict,            # {n_txn, n_read, n_write, cap}
    "rtt_ms": (int, float),    # host<->device dispatch floor
    "intra_iters": int,        # intra-batch fixpoint iterations observed
    "cumulative_ms": dict,     # truncation ladder, keyed by probe.log label
    "phases_ms": dict,         # {search, history, intra, merge_buckets, full}
    "lsm": dict,               # {full_ms, compact_ms, batches_per_compact,
                               #  effective_ms}
    "merge_shootout_ms": dict,  # {level_size: {sort, gather, scatter}}
}


def check_phase_profile(doc: dict) -> list[str]:
    """Validate a phase-profile dict against PHASE_PROFILE_SCHEMA; returns
    human-readable problems (empty = conforming).  Used by the bench embed
    test so the artifact can't silently drift from the schema."""
    problems: list[str] = []
    for key, typ in PHASE_PROFILE_SCHEMA.items():
        if key not in doc:
            problems.append(f"phase_profile missing key: {key}")
        elif not isinstance(doc[key], typ):
            problems.append(
                f"phase_profile.{key}: expected {typ}, got "
                f"{type(doc[key]).__name__}"
            )
    for key in doc:
        if key not in PHASE_PROFILE_SCHEMA:
            problems.append(f"phase_profile unknown key: {key}")
    return problems


def _kernel_rollup(resolvers) -> dict[str, Any]:
    """Aggregate the resolvers' conflict-backend KernelStats into one
    cluster-level view (counters sum; occupancy re-derives from the summed
    row counts; resolve-time percentiles take the worst resolver — the one
    that paces the commit pipeline's barrier)."""
    per = [r.cs.kernel_stats() for r in resolvers]
    if not per:
        from ..conflict.api import KernelStats

        return {
            **KernelStats(backend="none").snapshot(),
            "per_resolver": [],
        }
    out: dict[str, Any] = {
        "backend": per[0]["backend"],
        "per_resolver": per,
    }
    for k in (
        "batches", "txns", "aborted", "rows_real", "rows_padded",
        "recompiles", "search_fallbacks", "compactions", "gc_calls",
        "rows_reclaimed", "node_count", "pack_ms", "encode_ms", "pad_ms",
        "h2d_ms", "resolve_ms", "merge_ms",
        "runs_appended", "full_merges", "host_wait_ms", "compact_bytes",
    ):
        out[k] = sum(p.get(k, 0) for p in per)
    out["phase"] = {
        k: sum(p.get("phase", {}).get(k, 0.0) for p in per)
        for k in ("sort_ms", "scan_ms", "merge_ms", "compact_ms")
    }
    # fold impl: single value when the fleet agrees, "mixed" otherwise
    # (an autotune sweep can leave resolvers on different impls); fold_ms
    # sums per impl so mixed fleets stay attributable
    impls = {p.get("merge_impl", "?") for p in per}
    out["merge_impl"] = impls.pop() if len(impls) == 1 else "mixed"
    fold: dict[str, float] = {}
    for p in per:
        for k, v in p.get("fold_ms", {}).items():
            fold[k] = fold.get(k, 0.0) + v
    out["fold_ms"] = dict(sorted(fold.items()))
    # the device sets' key width and widenings (conflict/device.py)
    out["widenings"] = sum(p.get("widenings", 0) for p in per)
    out["key_bytes"] = max(p.get("key_bytes", 0) for p in per)
    # the conflict kernels launched for the resolvers' sets, by wrapper
    # (empty where no set ran a kernel): what a served cluster shows of
    # the card
    launched: dict[str, int] = {}
    for p in per:
        for k, v in p.get("launches", {}).items():
            launched[k] = launched.get(k, 0) + v
    out["launches"] = launched
    # the device sets' blocking reads of a device value, by site
    # (conflict/pipeline.py READ_SITES)
    reads: dict[str, int] = {}
    for p in per:
        for k, v in p.get("host_reads", {}).items():
            reads[k] = reads.get(k, 0) + v
    out["host_reads"] = reads
    out["abort_rate"] = out["aborted"] / out["txns"] if out["txns"] else 0.0
    out["occupancy"] = (
        out["rows_real"] / out["rows_padded"] if out["rows_padded"] else 1.0
    )
    for k in ("resolve_ms_p50", "resolve_ms_p99"):
        out[k] = max(p[k] for p in per)
    sup = [p["supervisor"] for p in per if "supervisor" in p]
    if sup:
        # supervised device backends (conflict/supervisor.py): one roll-up
        # of the degraded/healthy/probing fleet — counts by state, total
        # breaker trips, and the worst time-in-degraded
        out["device"] = {
            "states": {
                s: sum(1 for h in sup if h["state"] == s)
                for s in ("healthy", "probing", "degraded")
            },
            "serving_cpu": sum(1 for h in sup if h["serving"] == "cpu"),
            "trips": sum(h["trips"] for h in sup),
            "promotions": sum(h["promotions"] for h in sup),
            "probes": sum(h["probes"] for h in sup),
            "time_degraded_s": max(h["time_degraded_s"] for h in sup),
        }
    return out


def cluster_status(cluster) -> dict[str, Any]:
    """Works on SimCluster (static generation) and RecoverableCluster."""
    loop = cluster.loop
    trace = cluster.trace
    controller = getattr(cluster, "controller", None)
    if controller is not None:
        gen = controller.generation
        proxy = gen.proxy
        proxies = gen.proxies
        resolvers = gen.resolvers
        tlogs = gen.tlogs
        epoch = controller.epoch
        recovery = {
            "state": controller.recovery_state,
            "epoch": epoch,
            "count": controller.recoveries,
        }
    else:
        proxy = cluster.proxy
        proxies = [cluster.proxy]
        resolvers = cluster.resolvers
        tlogs = cluster.tlogs
        recovery = {"state": "accepting_commits", "epoch": 1, "count": 0}

    doc: dict[str, Any] = {
        "cluster": {
            "generation": recovery,
            "clock": loop.now(),
            "messages_sent": cluster.net.messages_sent,
            "messages_dropped": cluster.net.messages_dropped,
            "processes": {
                str(addr): {"name": p.name, "alive": p.alive, "reboots": p.reboots}
                for addr, p in cluster.net.processes.items()
            },
            "latest_events": {k: v for k, v in trace.latest.items()},
        },
        "proxy": {
            **proxy.counters.snapshot(),
            "committed_version": proxy.committed_version.get(),
            "batch_interval": proxy._batch_interval,
        },
        "resolvers": [
            {
                **r.counters.snapshot(),
                "version": r.version.get(),
                "oldest_version": r.cs.oldest_version,
                "latency": r.latency.snapshot(),
            }
            for r in resolvers
        ],
        "tlogs": [
            {"version": t.version.get(), "bytes_queued": t.bytes_queued,
             "locked": t.locked, "spill_events": getattr(t, "spill_events", 0),
             "commits_refused": getattr(t, "commits_refused", 0)}
            for t in tlogs
        ],
        "storage": [
            {
                "tag": ss.tag,
                "version": ss.version.get(),
                "durable_version": ss.durable_version,
                "keys": ss.store.key_count(),
                "queue_bytes": getattr(ss, "queue_bytes", 0),
                "read_latency": ss.read_latency.snapshot(),
                # ssd engine only: parsed-page cache accounting (kept for
                # continuity; the structured block below carries the rest)
                **(
                    {"cache_hits": ss.store.cache_hits,
                     "cache_misses": ss.store.cache_misses}
                    if hasattr(ss.store, "cache_hits") else {}
                ),
                # durable engines: the file-level page-cache counter block
                # (storage/pagecache.py — hit/miss/read-ahead per store,
                # plus the ssd engine's parsed-page cache gauges)
                **(
                    {"page_cache": ss.store.page_cache_stats()}
                    if hasattr(ss.store, "page_cache_stats") else {}
                ),
            }
            for ss in cluster.storage
        ],
    }
    # -- latency bands + per-stage histograms (tentpole seam 1) -------------
    # commit/GRV merge across ALL proxies (each proxy owns its trackers);
    # the stage histograms say where inside commitBatch the time goes
    doc["latency_bands"] = {
        "commit": LatencyTracker.merged([p.latency["commit"] for p in proxies]),
        "grv": LatencyTracker.merged([p.latency["grv"] for p in proxies]),
        "stages": {
            stage: LatencyTracker.merged([p.latency[stage] for p in proxies])
            for stage in ("batch_wait", "version_assign", "resolution",
                          "tlog_push")
        },
        "resolver": LatencyTracker.merged([r.latency for r in resolvers]),
        "storage_read": LatencyTracker.merged(
            [ss.read_latency for ss in cluster.storage]
        ),
    }

    # -- conflict-kernel profiling counters (tentpole seam 2) ---------------
    doc["kernel"] = _kernel_rollup(resolvers)

    # -- commit-plane wire counters (docs/WIRE.md) --------------------------
    # codec bytes/wall, frames per coalesced flush, and the pickle-fallback
    # census (by type: a hot message regressing off its codec shows up here
    # by NAME).  SimNetwork and RealNetwork expose the same WireStats shape;
    # the cluster fabric is the sim one, so the coalescing counters live in
    # the REAL transport's snapshot — merged under `transport` when the
    # server runs a wall-clock TCP fabric alongside (tools/server.py).
    wire = getattr(cluster.net, "wire", None)
    if wire is not None:
        doc["commit_wire"] = snap = wire.snapshot()
        rnet = getattr(getattr(cluster, "_wall_driver", None), "net", None)
        rwire = getattr(rnet, "wire", None)
        if rwire is not None:
            snap["transport"] = rwire.snapshot()

    # -- client-side RYW SnapshotCache counters -----------------------------
    # aggregated across every Database handle the cluster handed out
    # (client/snapshot_cache.py): hit/miss/insert/eviction totals, the live
    # byte gauge, and selector resolutions through the merged view
    dbs = getattr(cluster, "client_dbs", None)
    if dbs is not None:
        agg: dict[str, int] = {
            "cache_hits": 0, "cache_misses": 0, "cache_inserts": 0,
            "cache_evictions": 0, "selector_reads": 0, "bytes": 0,
            "transactions": 0,
        }
        for db in dbs:
            for k, v in db.cache_stats.snapshot().items():
                agg[k] = agg.get(k, 0) + v
        doc["clients"] = {"databases": len(dbs), "ryw_cache": agg}

    rk = getattr(cluster, "ratekeeper", None)
    doc["cluster"]["messages"] = _messages(trace, rk) + _device_messages(resolvers)

    # -- per-disk gauges (storage/files.py fault plane) ----------------------
    # bytes used vs capacity, degraded-mode multiplier, stall/error/ENOSPC
    # counters: the operator's which-disk-is-melting table (the runbook's
    # first read when ratekeeper says free_space / e_brake)
    fs = getattr(cluster, "fs", None)
    if fs is not None:
        doc["cluster"]["disks"] = fs.disk_usage()
        # the SHARED page pool's gauges (one pool per process lifetime —
        # byte budget, live bytes, evictions; per-store hit/miss counters
        # live in the storage rows above)
        pool = getattr(fs, "page_pool", None)
        if pool is not None:
            doc["cluster"]["page_cache"] = pool.stats()

    dd = getattr(cluster, "dd", None)
    if dd is not None:
        doc["cluster"]["data_distribution"] = {
            "moves": dd.moves,
            "heals": dd.heals,
            "shard_splits": dd.shard_splits,
            "shard_merges": dd.shard_merges,
            "hot_relocations": dd.hot_relocations,
            "frozen": dd.frozen,
            "shards": len(controller.storage_teams_tags),
            "exclusion_drains": dd.exclusion_drains,
        }
        try:
            doc["cluster"]["data"] = _data_block(cluster, dd)
        except KeyError:
            pass  # keyServers map churning mid-status; omit this scrape
    if controller is not None:
        doc["cluster"]["backup_running"] = controller.backup_worker is not None
        # round-5 operational surface (ManagementAPI state + liveness map)
        fm = controller.failure_monitor
        doc["cluster"]["configuration"] = {
            "excluded": sorted(controller.excluded_targets),
            "locked": controller._locked is not None,
            "coordinators": len(getattr(cluster, "coordinators", []) or []),
            "maintenance_zones": sorted(controller.maintenance_zones),
            "redundancy_policy": repr(controller.replication_policy)
            if controller.replication_policy is not None else None,
            "team_sizes": [len(t) for t in controller.storage_teams_tags],
        }
        devices = fm.device_report()
        doc["cluster"]["failure_monitor"] = {
            "tracked": len(fm._status),
            "failed": [str(a) for a in fm.failed_addresses()],
            "transitions": fm.transitions,
            **(
                {"devices": devices,
                 "device_transitions": fm.device_transitions}
                if devices else {}
            ),
        }
        doc["cluster"]["stream_consumers"] = sorted(controller.stream_consumers)
        rc = getattr(controller, "region_config", None)
        lr = getattr(cluster, "log_router", None)
        if rc is not None and (
            rc.usable_regions >= 2 or getattr(cluster, "remote_storage", [])
        ):
            # the region plane (control/region.py): applied configuration +
            # relay health — the operator's failover dashboard
            doc["cluster"]["regions"] = {
                "usable_regions": rc.usable_regions,
                "satellite": rc.satellite,
                "primary": rc.primary,
                "promoted": bool(getattr(cluster, "_region_promoted", False)),
                "remote_replicas": len(getattr(cluster, "remote_storage", [])),
                "router": (
                    {
                        "version": lr.version.get(),
                        "known_committed": lr.known_committed,
                        "queue_depth": sum(len(q) for q in lr._tags.values()),
                    }
                    if lr is not None else None
                ),
            }
    if rk is not None:
        doc["ratekeeper"] = rk.status()
    if loop.profile:
        doc["profiler"] = {
            "busy_s_by_priority": dict(loop.busy_s_by_priority),
            "slow_tasks": len(loop.slow_tasks),
        }
    return doc


# -- status schema (fdbclient/Schemas.cpp + tests/status/* goldens) ----------
#
# A field spec is: a type (isinstance check), a dict (required keys,
# recursed), a [spec] (list, every element validated), or a tuple of
# accepted types.  Optional keys are suffixed '?'.

_LATENCY_SPEC: dict = {
    "count": int,
    "mean": (int, float),
    "max": (int, float),
    "p50": (int, float),
    "p95": (int, float),
    "p99": (int, float),
    "bands": dict,
}

STATUS_SCHEMA: dict = {
    "cluster": {
        "generation": {"state": str, "epoch": int, "count": int},
        "clock": (int, float),
        "messages_sent": int,
        "messages_dropped": int,
        "processes": dict,
        "latest_events": dict,
        "messages": [
            {"name": str, "severity": str, "description": str}
        ],
        "data_distribution?": {
            "moves": int, "heals": int, "shard_splits": int,
            "shard_merges": int, "hot_relocations": int, "frozen": bool,
            "shards": int, "exclusion_drains": int,
        },
        # the load-metric plane roll-up (cluster.data — movingData /
        # totalKVBytes analog): sampled byte totals + top-k hot shards
        "data?": {
            "total_kv_bytes_estimate": int,
            "moving_bytes_estimate": int,
            "moving_ranges": int,
            "shard_count": int,
            "hot_shards": [
                {
                    "begin": str,
                    "end": (str, type(None)),
                    "bytes": int,
                    "bytes_read_per_ksec": (int, float),
                    "bytes_written_per_ksec": (int, float),
                    "team": list,
                }
            ],
        },
        "backup_running?": bool,
        "configuration?": {
            "excluded": list,
            "locked": bool,
            "coordinators": int,
            "maintenance_zones": list,
            "redundancy_policy": (str, type(None)),
            "team_sizes": list,
        },
        "failure_monitor?": {
            "tracked": int, "failed": list, "transitions": int,
            "devices?": dict, "device_transitions?": int,
        },
        "stream_consumers?": list,
        # per-disk gauges (storage/files.py SimFilesystem.disk_usage):
        # path -> {bytes_used, capacity, latency_mult, stalled, ops, syncs,
        # stalls, errors_injected, enospc_errors, corrupt_reads, sync_s}
        "disks?": dict,
        # shared file-level page pool (storage/pagecache.py PageCachePool):
        # budget/occupancy/eviction gauges for the one per-process pool
        "page_cache?": {
            "page_size": int,
            "capacity_bytes": int,
            "bytes": int,
            "pages": int,
            "evictions": int,
            "invalidations": int,
            "readahead_batches": int,
        },
        "regions?": {
            "usable_regions": int,
            "satellite": str,
            "primary": str,
            "promoted": bool,
            "remote_replicas": int,
            "router": (dict, type(None)),
        },
    },
    "proxy": {
        "committed_version": int,
        "batch_interval": (int, float),
        "txns_committed": int,
        "txns_conflicted": int,
        "commit_batches": int,
        "mvcc_window_throttles": int,
    },
    "resolvers": [
        {"version": int, "oldest_version": int, "latency": _LATENCY_SPEC}
    ],
    "tlogs": [
        {"version": int, "bytes_queued": int, "locked": bool,
         "spill_events": int, "commits_refused": int}
    ],
    "storage": [
        {"tag": str, "version": int, "durable_version": int, "keys": int,
         "queue_bytes": int, "read_latency": _LATENCY_SPEC,
         # durable engines: file-level page-cache counters for this
         # store's files + the ssd engine's parsed-page cache gauges
         "page_cache?": {
             "hits": int, "misses": int,
             "readahead_pages": int, "readahead_hits": int,
             "parsed_hits": int, "parsed_misses": int, "parsed_bytes": int,
         }}
    ],
    "latency_bands": {
        "commit": _LATENCY_SPEC,
        "grv": _LATENCY_SPEC,
        "stages": {
            "batch_wait": _LATENCY_SPEC,
            "version_assign": _LATENCY_SPEC,
            "resolution": _LATENCY_SPEC,
            "tlog_push": _LATENCY_SPEC,
        },
        "resolver": _LATENCY_SPEC,
        "storage_read": _LATENCY_SPEC,
    },
    "kernel": {
        "backend": str,
        "batches": int,
        "txns": int,
        "abort_rate": (int, float),
        "occupancy": (int, float),
        "recompiles": int,
        "search_fallbacks": int,
        "compactions": int,
        "gc_calls": int,
        "rows_reclaimed": int,
        "node_count": int,
        "runs_appended": int,
        "full_merges": int,
        "merge_impl": str,
        "key_bytes?": int,
        "widenings?": int,
        "launches?": dict,
        "host_reads?": dict,
        "host_wait_ms?": (int, float),
        "compact_bytes?": int,
        "fold_ms": dict,
        "phase": dict,
        "resolve_ms_p50": (int, float),
        "resolve_ms_p99": (int, float),
        "per_resolver": list,
        "device?": {
            "states": dict,
            "serving_cpu": int,
            "trips": int,
            "promotions": int,
            "probes": int,
            "time_degraded_s": (int, float),
        },
    },
    "commit_wire?": {
        "frames_encoded": int,
        "frames_decoded": int,
        "bytes_encoded": int,
        "bytes_decoded": int,
        "encode_ms": (int, float),
        "decode_ms": (int, float),
        "pickle_fallbacks": int,
        "fallback_types": dict,
        "decode_fallbacks": int,
        "flushes": int,
        "frames_flushed": int,
        "frames_per_flush": (int, float),
        # the wall-clock TCP fabric's WireStats (same shape), present when
        # the server runs one alongside the sim fabric (tools/server.py) —
        # its flushes/frames_per_flush are where coalescing actually shows
        "transport?": dict,
    },
    # client-side RYW SnapshotCache roll-up (client/snapshot_cache.py):
    # aggregated over every Database handle the cluster handed out
    "clients?": {
        "databases": int,
        "ryw_cache": {
            "cache_hits": int,
            "cache_misses": int,
            "cache_inserts": int,
            "cache_evictions": int,
            "selector_reads": int,
            "bytes": int,
            "transactions": int,
        },
    },
    "profiler?": {"busy_s_by_priority": dict, "slow_tasks": int},
    "ratekeeper?": {
        "tps_budget": (int, float),
        "batch_tps_budget": (int, float),
        "limit_reason": str,
        "limiting_server": (str, type(None)),
        # hot-range attribution from the bandwidth samples (repr'd key)
        "limiting_shard": (str, type(None)),
        "limiting_shard_bps": (int, float),
        "e_brake": bool,
        "storage_lag_smoothed": dict,
        # keyed by tag (storage) / `tlogN` slot name (tlogs) — the
        # ratekeeper status test pins the key shapes
        "storage_queue_smoothed": dict,
        "free_space": dict,
        "tlog_queue_smoothed": dict,
    },
}


# -- periodic role-metrics events (runtime/trace.py spawn_role_metrics) ------
#
# The `*Metrics` vocabulary every role emits each METRICS_INTERVAL: one
# schema per event type, validated with the same field-spec machinery as
# the status document (the reference's status-schema discipline applied to
# the trace plane — tests assert every role type emits a conforming event
# within one interval).

_NUM = (int, float)

ROLE_METRICS_SCHEMA: dict = {
    "ProxyMetrics": {
        "Elapsed": _NUM,
        "TxnsCommittedPerSec": _NUM,
        "TxnsConflictedPerSec": _NUM,
        "CommitBatchesPerSec": _NUM,
        "ThrottlesPerSec": _NUM,
        "CommittedVersion": int,
        "BatchInterval": _NUM,
        "CommitP99Ms": _NUM,
        "GrvP99Ms": _NUM,
    },
    "ResolverMetrics": {
        "Elapsed": _NUM,
        "BatchesPerSec": _NUM,
        "TxnsPerSec": _NUM,
        "ConflictsPerSec": _NUM,
        "Version": int,
        "OldestVersion": int,
        "LatencyP99Ms": _NUM,
        "KernelBackend": str,
        "KernelBatchesDelta": int,
        "KernelPackMsDelta": _NUM,
        "KernelResolveMsDelta": _NUM,
        "KernelMergeMsDelta": _NUM,
        "DeviceState?": str,
        "DeviceServing?": str,
        "DeviceTrips?": int,
    },
    "TLogMetrics": {
        "Elapsed": _NUM,
        "Version": int,
        "KnownCommitted": int,
        "BytesQueued": int,
        "SpillEvents": int,
        "Locked": bool,
        "CommitsPerSec": _NUM,
        "BytesPerSec": _NUM,
    },
    "StorageMetrics": {
        "Elapsed": _NUM,
        "Tag": str,
        "Version": int,
        "DurableVersion": int,
        "KnownCommitted": int,
        "Keys": int,
        "QueueBytes": int,
        "ReadsPerSec": _NUM,
        "MutationsPerSec": _NUM,
        "ReadP99Ms": _NUM,
        # load-metric plane gauges (roles/storage_metrics.py): byte-sample
        # totals + decayed read/write bandwidth estimates
        "SampledBytes": int,
        "SampledKeys": int,
        "BytesReadPerKSec": _NUM,
        "BytesWrittenPerKSec": _NUM,
        # durable engines: cumulative page-cache counters (storage/
        # pagecache.py) — present when the store exposes the block
        "PageCacheHits?": int,
        "PageCacheMisses?": int,
        "PageCacheReadaheadHits?": int,
        "PageCacheParsedHits?": int,
    },
    "SequencerMetrics": {
        "Elapsed": _NUM,
        "LastAssigned": int,
        "MaxCommitted": int,
        "RequestsPerSec": _NUM,
        "VersionsAssignedPerSec": _NUM,
    },
    "LogRouterMetrics": {
        "Elapsed": _NUM,
        "Version": int,
        "KnownCommitted": int,
        "EntriesPerSec": _NUM,
        "QueueDepth": int,
    },
    "ClientMetrics": {
        "Elapsed": _NUM,
        "CacheHitsPerSec": _NUM,
        "CacheMissesPerSec": _NUM,
        "CacheInsertsPerSec": _NUM,
        "CacheEvictionsPerSec": _NUM,
        "SelectorReadsPerSec": _NUM,
        "CacheBytes": int,
        "CachedTransactions": int,
    },
    "WireMetrics": {
        "Elapsed": _NUM,
        "Source": str,
        "FramesEncodedPerSec": _NUM,
        "FramesDecodedPerSec": _NUM,
        "BytesEncodedPerSec": _NUM,
        "BytesDecodedPerSec": _NUM,
        "PickleFallbacks": int,
        "DecodeFallbacks": int,
        "FramesPerFlush": _NUM,
    },
}


# every emission carries its per-instance attribution (spawn_role_metrics
# stamps it centrally, so the event stream stays separable when several
# same-role instances share one process)
for _spec in ROLE_METRICS_SCHEMA.values():
    _spec["Instance"] = str


# -- coverage census events (runtime/coverage.py + runtime/buggify.py) -------
#
# One `CodeCoverage` event per testcov name / buggify site, emitted at sim
# teardown (the reference's coveragetool rows, ridden over the trace plane
# so the soak driver can scrape census data out of per-seed trace files
# instead of a side channel).  Kind says which namespace the Name lives
# in; Armed distinguishes a buggify site that enabled this run from one
# that only fired because a test force()d it.

CODE_COVERAGE_SCHEMA: dict = {
    "Name": str,
    "Kind": str,   # "testcov" | "buggify"
    "Hits": int,
    "Armed": bool,
}


def validate_coverage_event(ev: dict) -> None:
    """Raise ValueError where a `CodeCoverage` trace event violates its
    schema (same field-spec machinery as the status document)."""
    if ev.get("Type") != "CodeCoverage":
        raise ValueError(f"not a CodeCoverage event: {ev.get('Type')!r}")
    if ev.get("Kind") not in ("testcov", "buggify"):
        raise ValueError(f"coverage.Kind: unknown kind {ev.get('Kind')!r}")
    validate_status(ev, CODE_COVERAGE_SCHEMA, "coverage")


# -- process-supervisor events (tools/fdbmonitor.py) --------------------------
#
# The supervisor's trace plane is an operator-facing contract: the bounce
# driver (tools/bounce.py) and soak triage parse these events, so their
# shapes are schema-pinned like role metrics.  Extra harness-stamped
# fields (Time/Severity/Machine/WallTime) pass through unchecked, same as
# every other event schema here.

MONITOR_EVENT_SCHEMA: dict = {
    "MonitorStarted": {
        "Conf": str,
        "Pid": int,
        "Sections": str,        # comma-joined section names
    },
    "MonitorStopped": {
        "Pid": int,
    },
    "ProcessStarted": {
        "Section": str,
        "Pid": int,
        "Cmd": str,
    },
    "ProcessRestarted": {
        "Section": str,
        "Pid": int,
        "Restarts": int,
    },
    "ProcessStopped": {
        "Section": str,
        "Pid": int,
        "Reason": str,          # shutdown | conf-removed | conf-changed
    },
    "ProcessDied": {
        "Section": str,
        "Pid": int,
        "ExitCode": int,        # negative = killed by that signal number
        "RanS": _NUM,
        "RestartInS": _NUM,     # -1.0 = restart disabled: stays dead
    },
    "ProcessSpawnFailed": {
        "Section": str,
        "Error": str,
        "RetryInS": _NUM,
    },
    "MonitorConfInvalid": {
        "Conf": str,
        "Error": str,
    },
    "ConfReloaded": {
        "Generation": int,
        "Added": str,           # comma-joined section names (may be empty)
        "Removed": str,
        "Changed": str,
    },
}


def validate_monitor_event(ev: dict) -> None:
    """Raise ValueError where a supervisor trace event violates its schema
    (unknown supervisor event types also raise)."""
    spec = MONITOR_EVENT_SCHEMA.get(ev.get("Type"))
    if spec is None:
        raise ValueError(f"unknown monitor event type {ev.get('Type')!r}")
    validate_status(ev, spec, f"monitor.{ev['Type']}")


def validate_metrics_event(ev: dict) -> None:
    """Raise ValueError where a `*Metrics` trace event violates its schema
    (unknown metrics event types also raise: a new role metric must be
    schema-listed before it ships)."""
    spec = ROLE_METRICS_SCHEMA.get(ev.get("Type"))
    if spec is None:
        raise ValueError(f"unknown metrics event type {ev.get('Type')!r}")
    validate_status(ev, spec, f"metrics.{ev['Type']}")


def validate_status(doc, schema=None, path: str = "status") -> None:
    """Raise ValueError where `doc` violates the schema — the analog of the
    reference's schema-checked status (Status.actor.cpp checks emitted docs
    against Schemas.cpp in simulation)."""
    schema = STATUS_SCHEMA if schema is None else schema
    if isinstance(schema, dict):
        if not isinstance(doc, dict):
            raise ValueError(f"{path}: expected object, got {type(doc).__name__}")
        for key, sub in schema.items():
            optional = key.endswith("?")
            k = key[:-1] if optional else key
            if k not in doc:
                if optional:
                    continue
                raise ValueError(f"{path}.{k}: missing")
            validate_status(doc[k], sub, f"{path}.{k}")
    elif isinstance(schema, list):
        if not isinstance(doc, list):
            raise ValueError(f"{path}: expected array, got {type(doc).__name__}")
        for i, item in enumerate(doc):
            validate_status(item, schema[0], f"{path}[{i}]")
    else:
        if not isinstance(doc, schema):
            raise ValueError(
                f"{path}: expected {schema}, got {type(doc).__name__}"
            )
