"""Transaction timeline reconstruction — the transaction-profiling analyzer
over g_traceBatch (flow/Trace.h:253; the reference's contrib
transaction_profiling_analyzer.py joins TransactionDebug/CommitDebug events
on their sampled debug ID to print where a transaction spent its time).

A sampled transaction (Database.debug_sample_rate) emits one event per
pipeline station — client create/GRV/read/commit, proxy commitBatch phases,
storage getValue — all keyed by its debug ID.  This module joins them back
into a per-station delta report:

    from foundationdb_tpu_torch.tools.timeline import timeline_report, format_report
    print(format_report(timeline_report(debug_id)))

Scrape surfaces: the special key `\\xff\\xff/timeline/json` (any client /
the gateway protocol, so `fdbcli get` works) and tools/server.py's
`--timeline-file` periodic JSON dump.

Copy of the reference package's module, on the port's own modules.
"""

from __future__ import annotations

from typing import Any

from ..runtime.trace import TraceBatch, g_trace_batch
from .trace_tool import report_from_stations, role_of


def _report_from_events(debug_id: str, events: list[dict[str, Any]]) -> dict[str, Any]:
    """Build one report from a transaction's TIME-SORTED events — a thin
    consumer of trace_tool's join (the same report shape in-memory that
    trace_tool builds from cross-process trace files)."""
    return report_from_stations(debug_id, [
        {"location": e["Location"], "time": e["Time"],
         "role": role_of(e["Location"])}
        for e in events
    ])


def _grouped(tb: TraceBatch) -> dict[str, list[dict[str, Any]]]:
    """ONE pass over the event ring: events per debug ID, in
    first-appearance order (dict insertion order) — every multi-transaction
    entry point goes through here so a full 100k-event ring is scanned
    once per scrape, not once per transaction."""
    groups: dict[str, list[dict[str, Any]]] = {}
    for e in tb.events:
        groups.setdefault(e["ID"], []).append(e)
    for evs in groups.values():
        evs.sort(key=lambda e: e["Time"])
    return groups


def timeline_report(debug_id: str, batch: TraceBatch | None = None) -> dict[str, Any]:
    """One transaction's journey: stations in time order with per-station
    deltas (the time attributable to the hop INTO each station)."""
    tb = batch or g_trace_batch
    return _report_from_events(debug_id, tb.timeline(debug_id))


def sampled_ids(batch: TraceBatch | None = None) -> list[str]:
    """Every sampled debug ID, in first-appearance order."""
    tb = batch or g_trace_batch
    return list(dict.fromkeys(e["ID"] for e in tb.events))


def timeline_dump(batch: TraceBatch | None = None, limit: int = 200) -> dict[str, Any]:
    """The scrape document: newest `limit` sampled transactions, fully
    reconstructed, plus how much the ring buffer dropped."""
    tb = batch or g_trace_batch
    groups = _grouped(tb)
    ids = list(groups)
    return {
        "sampled": len(ids),
        "suppressed_events": tb.suppressed,
        "transactions": [
            _report_from_events(i, groups[i]) for i in ids[-limit:]
        ],
    }


def slowest(n: int = 5, batch: TraceBatch | None = None) -> list[dict[str, Any]]:
    """The n slowest sampled transactions by end-to-end span — where an
    operator starts when the commit latency bands degrade."""
    tb = batch or g_trace_batch
    reports = [_report_from_events(i, evs) for i, evs in _grouped(tb).items()]
    reports.sort(key=lambda r: r["total_s"], reverse=True)
    return reports[:n]


def format_report(report: dict[str, Any]) -> str:
    """Printable per-station delta table."""
    lines = [
        f"transaction {report['id']}: {report['station_count']} stations, "
        f"{report['total_s'] * 1e3:.3f} ms total"
    ]
    for s in report["stations"]:
        lines.append(
            f"  {s['time']:12.6f}  +{s['delta'] * 1e3:9.3f} ms  {s['location']}"
        )
    return "\n".join(lines)
