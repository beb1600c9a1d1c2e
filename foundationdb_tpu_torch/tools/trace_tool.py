"""Cross-process trace analysis — the transaction-profiling analyzer
(contrib/transaction_profiling_analyzer.py in the reference) generalized
over the rolling JSONL trace files every process writes
(runtime/trace.py TraceFileSink).

Reads one or more trace files or directories, joins the `TransactionDebug`
station events back into per-transaction timelines BY DEBUG ID — across
processes: each file's events carry a `WallTime` stamp (a shared clock,
unlike the per-process `Time` origins) and the file they came from, so one
sampled transaction's journey client → proxy → resolver → TLog → storage
reassembles even when the stations landed in different OS processes'
trace files.  Also: event-type histograms by severity, and named-metric
time-series extraction from the periodic `*Metrics` events (BENCH
artifacts / dashboards).

    python -m foundationdb_tpu_torch.tools.trace_tool PATH [PATH...] \
        [--slow N] [--id DEBUG_ID] [--histogram] \
        [--series EVENT_TYPE:FIELD] [--json OUT]

`tools/timeline.py` (the in-process, in-memory view over g_trace_batch)
is a thin consumer of the same join: both build their reports through
`report_from_stations`.

Copy of the reference package's module, on the port's own modules.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Iterable

# station-location prefix -> pipeline role, the attribution the reference
# encodes in its analyzer's station tables (Location's first dotted
# component is the emitting role's namespace)
ROLE_BY_PREFIX = {
    "NativeAPI": "client",
    "GatewayClient": "client",
    "CommitProxyServer": "proxy",
    "GrvProxyServer": "proxy",
    "MasterServer": "sequencer",
    "Resolver": "resolver",
    "TLog": "tlog",
    "StorageServer": "storage",
    "LogRouter": "logrouter",
}


def role_of(location: str) -> str:
    return ROLE_BY_PREFIX.get(location.split(".", 1)[0], "unknown")


# ---------------------------------------------------------------------------
# loading


def trace_files(paths: Iterable[str]) -> list[str]:
    """Expand files/directories into the trace files they name: a
    directory contributes every `*.jsonl` inside it (the rolled
    generations of any collectors logging there), sorted so generation
    order is stable."""
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(
                os.path.join(p, f) for f in sorted(os.listdir(p))
                if f.endswith(".jsonl")
            )
        else:
            out.append(p)
    return out


def load_events(paths: Iterable[str]) -> list[dict[str, Any]]:
    """Every parseable event from every named trace file, stamped with the
    `File` it came from (basename) — a DISTINCT key, because events may
    carry their own `Source` field (WireMetrics' sim/tcp fabric label)
    that must survive the load.  Torn trailing lines — the crash the
    line-buffered flush is for — are skipped, not fatal."""
    events: list[dict[str, Any]] = []
    for path in trace_files(paths):
        src = os.path.basename(path)
        try:
            f = open(path)
        except OSError:
            continue
        with f:
            for line in f:
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue  # torn write at a crash/roll boundary
                if isinstance(ev, dict):
                    ev["File"] = src
                    events.append(ev)
    return events


# ---------------------------------------------------------------------------
# the join


def _ev_time(ev: dict[str, Any]) -> float:
    # WallTime is the cross-process clock (stamped at file write); Time is
    # each process's own loop origin — only comparable within one file
    return ev.get("WallTime", ev.get("Time", 0.0))


def join_timelines(events: list[dict[str, Any]]) -> dict[str, list[dict[str, Any]]]:
    """debug ID -> time-sorted station list, one pass over the events.
    A station is any `TransactionDebug` event (or raw g_trace_batch shape
    with Location+ID); each becomes {time, location, role, source}."""
    groups: dict[str, list[dict[str, Any]]] = {}
    for ev in events:
        loc = ev.get("Location")
        did = ev.get("ID")
        if loc is None or did is None:
            continue
        groups.setdefault(did, []).append({
            "time": _ev_time(ev),
            "location": loc,
            "role": role_of(loc),
            "source": ev.get("File"),
            "machine": ev.get("Machine"),
        })
    for stations in groups.values():
        stations.sort(key=lambda s: s["time"])
    return groups


def report_from_stations(debug_id: str,
                         stations: list[dict[str, Any]]) -> dict[str, Any]:
    """One transaction's journey from its TIME-SORTED stations: per-station
    deltas (time attributable to the hop INTO each station), the roles and
    source files it crossed — THE report shape, shared with
    tools/timeline.py's in-memory view."""
    out: list[dict[str, Any]] = []
    prev: float | None = None
    for s in stations:
        entry = dict(s)
        entry["delta"] = 0.0 if prev is None else s["time"] - prev
        prev = s["time"]
        out.append(entry)
    return {
        "id": debug_id,
        "station_count": len(out),
        "total_s": out[-1]["time"] - out[0]["time"] if out else 0.0,
        "roles": sorted({s["role"] for s in out if s.get("role")}),
        "sources": sorted({s["source"] for s in out if s.get("source")}),
        "stations": out,
    }


def top_slow(events: list[dict[str, Any]], n: int = 5) -> list[dict[str, Any]]:
    """The n slowest joined transactions by end-to-end span — where an
    operator starts when the commit bands degrade."""
    reports = [
        report_from_stations(did, stations)
        for did, stations in join_timelines(events).items()
    ]
    reports.sort(key=lambda r: r["total_s"], reverse=True)
    return reports[:n]


# ---------------------------------------------------------------------------
# histograms + metric series


def event_histogram(events: list[dict[str, Any]]) -> dict[str, Any]:
    """Event-type counts bucketed by severity (the trace-file triage view:
    what warned, what flooded)."""
    by_type: dict[str, dict[str, int]] = {}
    for ev in events:
        t = ev.get("Type")
        if t is None:
            continue
        row = by_type.setdefault(t, {"count": 0, "severity": 0})
        row["count"] += 1
        row["severity"] = max(row["severity"], ev.get("Severity", 0))
    by_severity: dict[int, int] = {}
    for row in by_type.values():
        by_severity[row["severity"]] = (
            by_severity.get(row["severity"], 0) + row["count"]
        )
    return {
        "by_type": dict(
            sorted(by_type.items(), key=lambda kv: -kv[1]["count"])
        ),
        "by_severity": {str(k): v for k, v in sorted(by_severity.items())},
    }


def metric_series(events: list[dict[str, Any]], event_type: str,
                  field: str) -> list[dict[str, Any]]:
    """A named metric's time-series out of the periodic `*Metrics` events
    — the BENCH-artifact extraction (one point per emission, per-instance
    attribution kept so a per-role series can be plotted)."""
    series = [
        {
            "t": _ev_time(ev),
            "value": ev[field],
            # per-emitter attribution: the Instance every spawn_role_metrics
            # emission carries, else the host, else the file it came from
            "instance": ev.get("Instance") or ev.get("Machine") or ev.get("File"),
        }
        for ev in events
        if ev.get("Type") == event_type and field in ev
    ]
    series.sort(key=lambda p: p["t"])
    return series


# ---------------------------------------------------------------------------
# rendering + CLI


def format_timeline(report: dict[str, Any]) -> str:
    """Printable per-station delta table with role/host attribution."""
    lines = [
        f"transaction {report['id']}: {report['station_count']} stations, "
        f"{report['total_s'] * 1e3:.3f} ms total, "
        f"roles {'/'.join(report['roles'])}"
        + (f", files {'/'.join(report['sources'])}" if report["sources"] else "")
    ]
    for s in report["stations"]:
        where = s.get("machine") or s.get("source") or ""
        lines.append(
            f"  {s['time']:16.6f}  +{s['delta'] * 1e3:9.3f} ms  "
            f"[{s['role']:>9s}] {s['location']}"
            + (f"  ({where})" if where else "")
        )
    return "\n".join(lines)


def run_report(argv: list[str]) -> str:
    """The CLI body, returning the printable report (shared with the
    `tracetool` subcommand in tools/cli.py)."""
    ap = argparse.ArgumentParser(
        prog="trace_tool", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("paths", nargs="+",
                    help="trace files and/or directories of *.jsonl")
    ap.add_argument("--slow", type=int, default=5, metavar="N",
                    help="top-N slow transactions (default 5)")
    ap.add_argument("--id", default=None,
                    help="print one transaction's full timeline")
    ap.add_argument("--histogram", action="store_true",
                    help="event-type histogram by severity")
    ap.add_argument("--series", default=None, metavar="TYPE:FIELD",
                    help="extract a metric time-series, e.g. "
                         "ResolverMetrics:TxnsPerSec")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="also write the selected data as JSON to OUT "
                         "('-' for stdout)")
    args = ap.parse_args(argv)

    events = load_events(args.paths)
    lines: list[str] = [
        f"{len(events)} events from {len(trace_files(args.paths))} files"
    ]
    doc: dict[str, Any] = {}
    if args.id is not None:
        joined = join_timelines(events)
        if args.id not in joined:
            lines.append(f"no stations for debug id {args.id!r}")
        else:
            rep = report_from_stations(args.id, joined[args.id])
            doc["timeline"] = rep
            lines.append(format_timeline(rep))
    elif args.series is not None:
        etype, _, field = args.series.partition(":")
        series = metric_series(events, etype, field)
        doc["series"] = {"event": etype, "field": field, "points": series}
        lines.append(f"{etype}.{field}: {len(series)} points")
        for p in series:
            lines.append(f"  {p['t']:16.6f}  {p['value']}")
    elif args.histogram:
        hist = event_histogram(events)
        doc["histogram"] = hist
        lines.append(f"{'count':>8s}  {'sev':>4s}  type")
        for t, row in hist["by_type"].items():
            lines.append(f"{row['count']:8d}  {row['severity']:4d}  {t}")
    else:
        slow = top_slow(events, args.slow)
        doc["slow"] = slow
        lines.append(f"top {len(slow)} slow transactions:")
        for rep in slow:
            lines.append(format_timeline(rep))
    if args.json is not None:
        blob = json.dumps(doc, indent=2, default=str)
        if args.json == "-":
            lines.append(blob)
        else:
            with open(args.json, "w") as f:
                f.write(blob)
    return "\n".join(lines)


def main(argv=None) -> None:
    import sys

    print(run_report(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
