"""Interactive admin shell — the fdbcli analog (fdbcli/fdbcli.actor.cpp).

Runs an in-process cluster (simulated world driven by the real clock, the
same role code production would run) and exposes the operational verbs:
reads/writes, range scans, status, and chaos (kill a pipeline process to
watch recovery).  Scriptable: `echo "set k v; get k" | python -m
foundationdb_tpu_torch.tools.cli [--device cpu]`.

Batch subcommand: `cli soak SPEC [--seeds N ...]` runs a multi-seed soak
campaign (tools/soak.py; runbook in docs/OPERATIONS.md) and exits with
the campaign verdict instead of opening the REPL.

Copy of the reference package's module on this package's modules, with
one keyword of its own: `device` (`--device`, default cuda) is the device
of the cluster's conflict sets (RecoverableCluster's default backend, the
DR secondary's too), and `cli spec` and `cli soak` pass their `--device`
on.  Without a card the default raises before the cluster starts.
"""

from __future__ import annotations

import json
import shlex
import sys

from ..client.transaction import Database
from ..control.recoverable import RecoverableCluster
from ..control.status import cluster_status


HELP = """\
commands:
  get <key>                   read a key
  set <key> <value>           write a key (one transaction)
  clear <key>                 delete a key
  clearrange <begin> <end>    delete a range
  getrange <begin> <end> [n]  scan up to n keys (default 25)
  watch <key>                 block until the key changes
  status [json]               cluster status summary (or full json)
  sample <rate>               sample a fraction of txns into the timeline
  timeline [id]               sampled-transaction station report(s)
  tracetool <path> [args...]  analyze rolling trace files (cross-process
                              timeline joins, --slow N, --histogram,
                              --series TYPE:FIELD, --id DEBUG_ID)
  configure k=v ...           change role counts (n_tlogs/n_proxies/n_resolvers)
  exclude <target> ...        drain + ban machines/processes (ManagementAPI)
  include [target ...]        re-admit targets (none = all)
  excluded                    list exclusions + whether removal is safe
  lock | unlock <uid>         lock/unlock the database (error 1038 to others)
  coordinators <n>            change the coordinator quorum size
  maintenance <zone> <secs>   suppress healing for a zone while it bounces
  throttle <tps>|off          cap cluster admission at tps transactions/s
  datadistribution on|off     resume/freeze load-driven shard movement
                              (splits, merges, hot-shard relocations;
                              healing and exclusion drains keep running)
  move <begin> <end> <shard>  MoveKeys: migrate a range to shard's team
  backup start <prefix>       continuous backup + snapshot into the cluster fs
  backup status | stop        backup progress / stop
  dr start|status|switch|stop cluster-to-cluster DR to an embedded secondary
                              (the fdbdr verbs; switch = drain + promote)
  errorcode <n>               name a numeric error code
  kill <process-name>         kill a process by name (recovery chaos)
  processes                   list processes
  help                        this text
  exit                        quit
keys/values are text; use \\xNN escapes for binary."""


def _b(s: str) -> bytes:
    return s.encode("utf-8").decode("unicode_escape").encode("latin-1")


class Cli:
    def __init__(self, seed: int = 0, device="cuda", **cluster_kw) -> None:
        self.device = device
        self.cluster = RecoverableCluster(seed=seed, device=device, **cluster_kw)
        self.db: Database = self.cluster.database()

    def _run(self, coro):
        return self.cluster.run_until(self.cluster.loop.spawn(coro), 600.0)

    def one_command(self, line: str) -> str:
        parts = shlex.split(line)
        if not parts:
            return ""
        cmd, *args = parts
        c = self.cluster

        if cmd == "help":
            return HELP
        if cmd == "get":
            async def go():
                tr = self.db.create_transaction()
                return await tr.get(_b(args[0]))
            v = self._run(go())
            return repr(v) if v is not None else "<missing>"
        if cmd == "set":
            async def go():
                tr = self.db.create_transaction()
                tr.set(_b(args[0]), _b(args[1]))
                return await tr.commit()
            return f"committed @{self._run(go())}"
        if cmd == "clear":
            async def go():
                tr = self.db.create_transaction()
                tr.clear(_b(args[0]))
                return await tr.commit()
            return f"committed @{self._run(go())}"
        if cmd == "clearrange":
            async def go():
                tr = self.db.create_transaction()
                tr.clear_range(_b(args[0]), _b(args[1]))
                return await tr.commit()
            return f"committed @{self._run(go())}"
        if cmd == "getrange":
            limit = int(args[2]) if len(args) > 2 else 25
            async def go():
                tr = self.db.create_transaction()
                return await tr.get_range(_b(args[0]), _b(args[1]), limit=limit)
            rows = self._run(go())
            return "\n".join(f"{k!r} -> {v!r}" for k, v in rows) or "<empty>"
        if cmd == "watch":
            async def go():
                fut = await self.db.watch(_b(args[0]))
                return await fut
            return f"changed @{self._run(go())}"
        if cmd == "status":
            doc = cluster_status(c)
            if args and args[0] == "json":
                return json.dumps(doc, indent=2, default=str)
            g = doc["cluster"]["generation"]
            lines = [
                f"generation: epoch {g['epoch']} ({g['state']}), "
                f"{g['count']} recoveries",
                f"proxy: {doc['proxy']['txns_committed']} committed, "
                f"{doc['proxy']['txns_conflicted']} conflicted, "
                f"version {doc['proxy']['committed_version']}",
            ]
            lb = doc.get("latency_bands")
            if lb and lb["commit"]["count"]:
                lines.append(
                    f"commit latency: p50 {lb['commit']['p50'] * 1e3:.2f} ms, "
                    f"p99 {lb['commit']['p99'] * 1e3:.2f} ms "
                    f"({lb['commit']['count']} txns); "
                    f"grv p99 {lb['grv']['p99'] * 1e3:.2f} ms"
                )
            for m in doc["cluster"].get("messages", []):
                lines.append(f"message [{m['severity']}] {m['name']}: "
                             f"{m['description']}")
            conf = doc["cluster"].get("configuration")
            if conf is not None:
                lines.append(
                    f"config: {conf['coordinators']} coordinators, "
                    f"teams {conf['team_sizes']}"
                    + (", LOCKED" if conf["locked"] else "")
                    + (f", excluded {conf['excluded']}" if conf["excluded"] else "")
                    + (f", maintenance {conf['maintenance_zones']}"
                       if conf["maintenance_zones"] else "")
                )
            fm = doc["cluster"].get("failure_monitor")
            if fm is not None and fm["failed"]:
                lines.append(f"failed addresses: {fm['failed']}")
            for i, r in enumerate(doc["resolvers"]):
                lines.append(
                    f"resolver {i}: {r['txns']} txns, {r['conflicts']} conflicts"
                )
            for s in doc["storage"]:
                lines.append(
                    f"storage {s['tag']}: {s['keys']} keys, v{s['version']}"
                )
            return "\n".join(lines)
        if cmd == "sample":
            self.db.debug_sample_rate = float(args[0])
            return f"debug sample rate = {self.db.debug_sample_rate}"
        if cmd == "timeline":
            from .timeline import format_report, timeline_dump, timeline_report

            if args:
                return format_report(timeline_report(args[0]))
            reports = timeline_dump(limit=25)["transactions"]
            if not reports:
                return "<no sampled transactions; use `sample 1.0` first>"
            return "\n".join(
                f"{r['id']}  ({r['station_count']} stations, "
                f"{r['total_s'] * 1e3:.3f} ms)"
                for r in reports
            )
        if cmd == "tracetool":
            # offline trace-file analysis (tools/trace_tool.py): joins
            # cross-process timelines by debug ID, histograms, series
            from .trace_tool import run_report

            try:
                return run_report(args)
            except SystemExit:  # argparse error must not kill the REPL
                return ("usage: tracetool <path>... [--slow N] [--id ID] "
                        "[--histogram] [--series TYPE:FIELD] [--json OUT]")
        if cmd == "configure":
            # configure n_tlogs=3 n_proxies=2 ... (ManagementAPI changeConfig)
            from ..client.management import configure

            kw = dict(p.split("=") for p in args)
            async def go():
                await configure(self.db, **{k: int(v) for k, v in kw.items()})
            self._run(go())
            return f"configured {kw} (takes effect at next conf poll)"
        if cmd == "exclude":
            from ..client import management as mgmt

            self._run(mgmt.exclude(self.db, list(args)))
            return (
                f"excluded {list(args)} (drain in progress; "
                f"'excluded' reports when removal is safe)"
            )
        if cmd == "include":
            from ..client import management as mgmt

            self._run(mgmt.include(self.db, list(args) or None))
            return f"included {list(args) or 'all'}"
        if cmd == "excluded":
            from ..client import management as mgmt

            targets = self._run(mgmt.get_excluded(self.db))
            if not targets:
                return "no exclusions"
            safe = mgmt.exclusion_safe(c, targets)
            return f"excluded: {targets} — {'SAFE to remove' if safe else 'draining…'}"
        if cmd == "lock":
            from ..client import management as mgmt

            uid = self._run(mgmt.lock_database(self.db))
            return f"locked; uid {uid.decode()}"
        if cmd == "unlock":
            from ..client import management as mgmt

            self._run(mgmt.unlock_database(self.db, _b(args[0])))
            return "unlocked"
        if cmd == "coordinators":
            from ..client import management as mgmt

            self._run(mgmt.set_coordinators(self.db, int(args[0])))
            return f"coordinator change to {args[0]} requested"
        if cmd == "maintenance":
            from ..client import management as mgmt

            self._run(mgmt.set_maintenance(self.db, args[0], float(args[1])))
            return f"maintenance on {args[0]} for {args[1]}s"
        if cmd == "throttle":
            from ..client import management as mgmt

            tps = None if args[0] == "off" else float(args[0])
            self._run(mgmt.set_throttle(self.db, tps))
            return "throttle cleared" if tps is None else f"throttled to {tps} tps"
        if cmd == "datadistribution":
            # fdbcli `datadistribution on|off`: freeze/resume LOAD-driven
            # movement only — correctness moves (healing, exclusion
            # drains) are never frozen
            if args and args[0] in ("on", "off"):
                c.dd.frozen = args[0] == "off"
            return ("data distribution frozen (splits/merges/hot "
                    "relocations paused)" if c.dd.frozen
                    else "data distribution running")
        if cmd == "move":
            # move BEGIN END SHARD_IDX — MoveKeys through data distribution
            dest = c.controller.storage_teams_tags[int(args[2])]
            ok = self._run(c.dd.move_range(_b(args[0]), _b(args[1]), list(dest)))
            return "moved" if ok else "move refused (range/team invalid or busy)"
        if cmd == "backup":
            # backup start PREFIX | backup status | backup stop
            from ..client.backup import BackupAgent, BackupContainer

            if args[0] == "start":
                self._agent = BackupAgent(c)
                self._container = BackupContainer(c.fs, args[1])
                vm = self._run(self._agent.start(self._container))
                snap_v = self._run(self._agent.snapshot(self._container))
                return f"backup running from v{vm}, snapshot @v{snap_v}"
            if args[0] == "status":
                if getattr(self, "_agent", None) is None or self._agent.worker is None:
                    return "no backup running"
                return f"backed up to v{self._agent.worker.backed_up.get()}"
            if args[0] == "stop":
                self._run(self._agent.stop())
                return "backup stopped"
        if cmd == "dr":
            # dr start | dr status | dr switch | dr stop — the fdbdr tool
            # verbs (fdbbackup/backup.actor.cpp dr role).  The secondary is
            # an embedded cluster on the same loop; switch drains the
            # stream to the primary's final commit and promotes it.
            from ..client.dr import DRAgent
            from ..control.recoverable import RecoverableCluster

            if args[0] == "start":
                if getattr(self, "_dr", None) is not None:
                    return "dr already running"
                self._dr_secondary = RecoverableCluster(
                    seed=self.cluster.rng.random_int(1, 1 << 30),
                    loop=c.loop, device=self.device,
                )
                self._dr = DRAgent(c, self._dr_secondary)
                vm = self._run(self._dr.start())
                return f"dr streaming from v{vm} (secondary locked)"
            if args[0] == "status":
                if getattr(self, "_dr", None) is None or self._dr.worker is None:
                    return "no dr running"
                return (
                    f"dr applied to v{self._dr.worker.applied.get()}, "
                    f"lag {self._dr.lag_versions} versions"
                )
            if args[0] == "switch":
                final = self._run(self._dr.failover())
                self._dr = None
                return (
                    f"switched: secondary exact at v{final}; "
                    f"primary locked (use the secondary now)"
                )
            if args[0] == "stop":
                self._run(self._dr.stop(unlock_secondary=True))
                self._dr = None
                return "dr stopped"
        if cmd == "errorcode":
            from ..roles.errors import error_name

            return error_name(int(args[0]))
        if cmd == "processes":
            return "\n".join(
                f"{p.name:28s} {addr} {'up' if p.alive else 'DOWN'}"
                for addr, p in c.net.processes.items()
            )
        if cmd == "kill":
            for p in c.net.processes.values():
                if p.name == args[0]:
                    p.kill()
                    # let the failure monitor notice and recover
                    c.run_until(c.loop.delay(8.0), deadline=c.loop.now() + 60)
                    return f"killed {args[0]}; epoch now {c.controller.epoch}"
            return f"no such process: {args[0]}"
        return f"unknown command: {cmd} (try help)"

    def repl(self, stdin=None, stdout=None) -> None:
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        interactive = stdin.isatty()
        while True:
            if interactive:
                stdout.write("fdb-tpu> ")
                stdout.flush()
            line = stdin.readline()
            if not line:
                break
            for piece in line.split(";"):
                piece = piece.strip()
                if piece in ("exit", "quit"):
                    return
                if piece:
                    try:
                        stdout.write(self.one_command(piece) + "\n")
                    except Exception as e:  # noqa: BLE001 — REPL resilience
                        stdout.write(f"ERROR: {e!r}\n")


def spec_main(argv: list[str]) -> int:
    """`cli spec PATH [--seed N] [--deadline S] [--image-dir DIR] [--device
    D]`: run one
    spec file — or a restarting pair, auto-discovered when PATH is either
    half (`Name-1.txt`/`Name-2.txt`) or the bare stem — and print the
    metrics JSON.  The single-spec flavor of `cli soak` (tester.actor.cpp
    running one tests/*.txt file)."""
    import argparse

    from ..workloads import spec as _spec

    ap = argparse.ArgumentParser(prog="spec", description=spec_main.__doc__)
    ap.add_argument("path", help="spec file, pair half, or pair stem")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the spec's cluster seed (both pair halves)")
    ap.add_argument("--deadline", type=float, default=900.0,
                    help="virtual-clock deadline inside the run")
    ap.add_argument("--image-dir", default=None,
                    help="restart-image directory for a pair (default: a "
                         "temp dir)")
    ap.add_argument("--device", default="cuda",
                    help="device of the spec's supervised conflict sets")
    args = ap.parse_args(argv)
    if _spec.should_run_pair(args.path):
        metrics = _spec.run_restarting_pair(
            args.path, deadline=args.deadline, seed=args.seed,
            image_dir=args.image_dir, device=args.device,
        )
    else:
        metrics = _spec.run_spec_file(
            args.path, deadline=args.deadline, seed=args.seed,
            save_dir=args.image_dir, device=args.device,
        )
    print(json.dumps(metrics, indent=2, default=str))
    return 0


def main(argv: list[str] | None = None) -> None:
    # batch subcommands ride the same entry point as the REPL (fdbcli's
    # --exec flavor): `cli soak SPEC ...` runs a soak campaign and exits;
    # `cli spec PATH` runs one spec file or restarting pair; `cli lint
    # [paths...]` runs the flowlint static pass (docs/LINT.md)
    argv = sys.argv[1:] if argv is None else list(argv)
    sub, rest = (argv[0], argv[1:]) if argv else (None, [])
    if sub == "soak":
        from .soak import main as soak_main

        sys.exit(soak_main(rest))
    if sub == "spec":
        sys.exit(spec_main(rest))
    if sub == "lint":
        from .flowlint import main as lint_main

        # flowlint itself defaults to this package and its tests when no
        # paths are given, so flag-only invocations (`cli lint --json`)
        # work too
        sys.exit(lint_main(rest))
    if sub == "top":
        # live cluster monitor against a running tools/server.py gateway
        # (tools/fdbtop.py; `cli top --port P`, `--once` for one frame)
        from .fdbtop import main as top_main

        sys.exit(top_main(rest))
    if sub == "monitor":
        # process supervisor daemon (tools/fdbmonitor.py; the fdbmonitor
        # analog): `cli monitor --conf fdbmonitor.conf [--trace-file ...]`
        from .fdbmonitor import main as monitor_main

        sys.exit(monitor_main(rest))
    if sub == "bounce":
        # rolling-bounce campaign driver over the supervisor on the real
        # TCP fabric (tools/bounce.py; runbook in docs/OPERATIONS.md)
        from .bounce import main as bounce_main

        sys.exit(bounce_main(rest))
    import argparse

    ap = argparse.ArgumentParser(prog="cli", description=HELP,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="device of the cluster's conflict sets")
    Cli(device=ap.parse_args(argv).device).repl()


if __name__ == "__main__":
    main()
