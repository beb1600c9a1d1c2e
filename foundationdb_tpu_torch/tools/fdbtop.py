"""fdbtop — a live `top`-style cluster monitor over the status surface
(the community fdbtop tool's slot; data from the clusterGetStatus analog
rendered the way `fdbcli status details` + StorageMetrics trace events
would be eyeballed in production).

    python -m foundationdb_tpu_torch.tools.server --port 4690 &
    python -m foundationdb_tpu_torch.tools.fdbtop --port 4690 [--interval 2]
    python -m foundationdb_tpu_torch.tools.fdbtop --port 4690 --once   # one frame

Connects like any client (client/gateway_client.py), reads the
`\\xff\\xff/status/json` special key plus the `\\xff\\xff/metrics/`
shard-load range each refresh, and renders:

  - the admission headline: tps budget, limiting reason/server, and the
    load-metric plane's hot-RANGE attribution (which shard, not just
    which process, drove the limit);
  - per-role throughput (commit/conflict rates differenced between
    frames) and queue depths (TLog queues, storage queues + lag);
  - the data-distribution roll-up (total/moving bytes, shard count,
    hot relocations, frozen state);
  - the per-shard table from the sampled metric plane: bytes +
    read/write bandwidth per shard, hottest first.

Also reachable as `cli top` (tools/cli.py).  `--once` prints a single
frame and exits — the scriptable/testable flavor.

Copy of the reference package's module, on this package's gateway client:
the same status document renders the same frame.
"""
# flowlint: file ok wall-clock (live monitor: refresh cadence is host wall)

from __future__ import annotations

import argparse
import json
import sys
import time

_CLEAR = "\x1b[2J\x1b[H"


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024.0 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}GB"


def _fmt_rate(per_ksec: float) -> str:
    """Render a bytes-per-kilosecond gauge as bytes/sec."""
    return _fmt_bytes(per_ksec / 1e3) + "/s"


def snapshot(db) -> tuple[dict, list[dict]]:
    """One scrape: the status document + the decoded shard-load rows from
    the `\\xff\\xff/metrics/` special range (both read through a single
    transaction, like any other client read)."""
    tr = db.transaction()
    try:
        raw = tr.get(b"\xff\xff/status/json")
        doc = json.loads(raw) if raw else {}
        rows = tr.get_range(b"\xff\xff/metrics/", b"\xff\xff/metrics0")
        shards = []
        for k, v in rows:
            m = json.loads(v)
            m["begin"] = repr(k[len(b"\xff\xff/metrics/"):])
            shards.append(m)
        return doc, shards
    finally:
        tr.destroy()


def render(doc: dict, shards: list[dict], prev: dict | None,
           dt: float, max_shards: int = 12) -> str:
    """One frame of the monitor as text (pure: doc+shards in, str out —
    the unit the tests pin)."""
    lines: list[str] = []
    cl = doc.get("cluster", {})
    gen = cl.get("generation", {})
    lines.append(
        f"fdbtpu top — epoch {gen.get('epoch', '?')} "
        f"({gen.get('state', '?')}), {gen.get('count', 0)} recoveries, "
        f"sim clock {cl.get('clock', 0.0):.1f}s"
    )

    rk = doc.get("ratekeeper")
    if rk:
        head = (f"admission: {rk['tps_budget']:.0f} tps budget "
                f"({rk['limit_reason']}")
        if rk.get("limiting_server"):
            head += f" on {rk['limiting_server']}"
        if rk.get("limiting_shard"):
            head += (f", hot range {rk['limiting_shard']} "
                     f"@ {_fmt_bytes(rk.get('limiting_shard_bps', 0.0))}/s")
        head += ")" + ("  [E-BRAKE]" if rk.get("e_brake") else "")
        lines.append(head)

    px = doc.get("proxy", {})
    if px:
        row = (f"proxy: version {px.get('committed_version', 0)}, "
               f"{px.get('txns_committed', 0)} committed, "
               f"{px.get('txns_conflicted', 0)} conflicted")
        if prev is not None and dt > 0:
            ppx = prev.get("proxy", {})
            c = (px.get("txns_committed", 0)
                 - ppx.get("txns_committed", 0)) / dt
            x = (px.get("txns_conflicted", 0)
                 - ppx.get("txns_conflicted", 0)) / dt
            row += f"  ({c:.0f} commit/s, {x:.0f} conflict/s)"
        lines.append(row)

    data = cl.get("data")
    dd = cl.get("data_distribution")
    if data:
        row = (f"data: {_fmt_bytes(data['total_kv_bytes_estimate'])} total "
               f"(sampled), {data['shard_count']} shards, "
               f"{_fmt_bytes(data['moving_bytes_estimate'])} moving "
               f"in {data['moving_ranges']} range(s)")
        if dd:
            row += (f", {dd.get('hot_relocations', 0)} hot relocation(s)"
                    + (", DD FROZEN" if dd.get("frozen") else ""))
        lines.append(row)

    tlogs = doc.get("tlogs", [])
    if tlogs:
        lines.append("tlogs:")
        for i, t in enumerate(tlogs):
            lines.append(
                f"  tlog{i}  v{t['version']}  "
                f"queue {_fmt_bytes(t['bytes_queued'])}"
                + ("  LOCKED" if t.get("locked") else "")
            )

    storage = doc.get("storage", [])
    if storage:
        lines.append("storage:")
        lines.append(f"  {'tag':12s} {'version':>10s} {'lag':>6s} "
                     f"{'queue':>9s} {'keys':>8s}")
        for s in storage:
            lag = s["version"] - s["durable_version"]
            lines.append(
                f"  {s['tag']:12s} {s['version']:>10d} {lag:>6d} "
                f"{_fmt_bytes(s['queue_bytes']):>9s} {s['keys']:>8d}"
            )

    if shards:
        ranked = sorted(
            shards,
            key=lambda m: -(m.get("bytes_read_per_ksec", 0.0)
                            + m.get("bytes_written_per_ksec", 0.0)),
        )
        lines.append("shards (hottest first, sampled):")
        lines.append(f"  {'begin':24s} {'bytes':>9s} {'read':>12s} "
                     f"{'write':>12s}  team")
        for m in ranked[:max_shards]:
            lines.append(
                f"  {m['begin'][:24]:24s} "
                f"{_fmt_bytes(m.get('bytes', 0)):>9s} "
                f"{_fmt_rate(m.get('bytes_read_per_ksec', 0.0)):>12s} "
                f"{_fmt_rate(m.get('bytes_written_per_ksec', 0.0)):>12s}  "
                f"{','.join(m.get('team', []))}"
            )
        if len(ranked) > max_shards:
            lines.append(f"  … {len(ranked) - max_shards} more shard(s)")

    for m in cl.get("messages", []):
        lines.append(f"message [{m['severity']}] {m['name']}: "
                     f"{m['description']}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="fdbtop", description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=None,
                    help="gateway port (tools/server.py prints it at boot)")
    ap.add_argument("--cluster-file", default=None,
                    help="discover the gateway from a coordinator quorum "
                         "instead of --port")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="seconds between refreshes")
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit (no screen clearing)")
    ap.add_argument("--iterations", type=int, default=None,
                    help="exit after N frames (default: run until ^C)")
    ap.add_argument("--max-shards", type=int, default=12,
                    help="shard-table rows shown")
    args = ap.parse_args(argv)

    from ..client.gateway_client import GatewayClient, open_cluster

    if args.cluster_file:
        db = open_cluster(args.cluster_file)
    elif args.port is not None:
        db = GatewayClient(args.host, args.port)
    else:
        ap.error("need --port or --cluster-file")
        return 2

    prev: dict | None = None
    prev_t = 0.0
    frames = 0
    try:
        while True:
            doc, shards = snapshot(db)
            now = time.monotonic()
            frame = render(doc, shards, prev,
                           now - prev_t if prev is not None else 0.0,
                           max_shards=args.max_shards)
            if args.once or args.iterations is not None:
                print(frame, flush=True)
            else:
                print(_CLEAR + frame, flush=True)
            prev, prev_t = doc, now
            frames += 1
            if args.once or (args.iterations is not None
                             and frames >= args.iterations):
                return 0
            time.sleep(args.interval)
    except (KeyboardInterrupt, ConnectionError):
        return 0
    finally:
        db.close()


if __name__ == "__main__":
    sys.exit(main())
