"""Rolling-bounce campaign driver — upgrades-under-load on the real TCP
fabric (the operational discipline the reference exercises with fdbmonitor
+ kill -TERM during `configure`/upgrade runbooks).

    python -m foundationdb_tpu_torch.tools.bounce --out DIR [--device cuda|cpu]
    python -m foundationdb_tpu_torch.tools.cli bounce --out DIR

Builds a real multi-OS-process cluster under the tools/fdbmonitor.py
supervisor (N coordserver processes + one fdbserver process with a
durable restart image), runs sustained gateway load from client threads,
and proves three operator stories end to end:

  1. ROLLING BOUNCE — every supervised OS process is SIGTERMed exactly as
     an operator would, one at a time, under load.  The supervisor
     restarts each with backoff; the server saves/boots its restart image
     across the bounce.  Asserted: ZERO acked-commit loss (a watermark
     counter every acked increment must be visible in), the cycle
     workload's ring stays a permutation, and each bounce's availability
     gap (longest stretch between consecutive acked commits overlapping
     the bounce window) stays under --max-gap.  Per-bounce LatencyBands
     land in the campaign artifact.

  2. MIXED PROTOCOL VERSION — one coordinator is hot-reload-bounced with
     its `protocol-version` argument pinned to the PREVIOUS wire version.
     The new-version server redials it every leader-reassert period and
     severs at hello each time; asserted: exactly ONE traced
     TransportProtocolMismatch per (old process, new peer) pair for the
     whole mixed window (the transport's dedupe), zero decode-failure
     loops, and the pair reconnects once the conf reverts and the peers
     agree again.

  3. COORDINATOR CHANGE DURING BOUNCE — a fourth coordinator is added via
     conf hot-reload, the cluster file is rewritten to the new quorum,
     the server is bounced mid-load (it republishes to the NEW quorum
     from its restart image), the old coordinator's section is removed,
     and a FRESH client must still discover the gateway through the new
     quorum and read the workload's state.

Artifacts under --out: campaign.json (machine-checkable), campaign.md
(the recorded-campaign document, docs/campaigns/), the supervisor conf +
status + trace files, and every process's logs and rolling traces.

Copy of the reference package's module on this package's modules.  The
server's section carries `device = <--device>` (default cuda): every
bounce of it starts a new process, a new CUDA context and a new conflict
set on the card, booted from its restart image.  The old wire version is
the coordinator's `--protocol-version` argument (tools/coordserver.py,
passed to RealNetwork), where the reference pins an environment variable.
Nothing here reads or writes the environment: the children inherit it,
and each section's `env.PYTHONPATH` names this checkout so that `python
-m foundationdb_tpu_torch...` finds the package from the campaign dir.
The seed write and the audits go through the client's retry loop (`run`),
where the reference's one-shot transaction and `read` fail on a retryable
error (transaction_too_old, or commit_unknown_result when a loaded
server answers late)."""
# flowlint: file ok wall-clock (campaign driver over real OS processes: load pacing, bounce windows and availability gaps are host wall by design; never sim-reachable)

from __future__ import annotations

import argparse
import glob
import json
import os
import shlex
import signal
import socket
import struct
import sys
import threading
import time

from ..runtime.metrics import DEFAULT_LATENCY_BANDS, LatencyBands
from .fdbmonitor import Monitor

# the previous wire protocol version (runtime/serialize.py PROTOCOL_VERSION
# is 0x0fdb7103): what an un-upgraded process would announce at hello
OLD_PROTOCOL = "0x0fdb7102"
RING = 5
COUNTER_KEY = b"bounce/count"
# the checkout that holds this package: the children's import path
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _build_conf(coord_ports: list[int], gw_port: int,
                old_version_port: int | None = None,
                device: str = "cuda") -> str:
    """The fdbmonitor.conf for this campaign's process set.  Rewritten
    (atomically) between phases — the supervisor's hot-reload is the
    mechanism every scenario drives."""
    exe = shlex.quote(sys.executable)
    lines = [
        "[general]",
        "restart-delay = 0.25",
        "max-restart-delay = 4",
        "backoff-reset = 10",
        "conf-poll = 0.2",
        "kill-grace = 20",
        "logdir = logs",
        "",
        "[coordserver]",
        f"command = {exe} -m foundationdb_tpu_torch.tools.coordserver",
        f"env.PYTHONPATH = {PKG_ROOT}",
        "ip = 127.0.0.1",
        "port = $ID",
        "run-seconds = 900",
        "trace-file = logs/coord.$ID.trace",
        "ready-file = logs/coord.$ID.ready",
        "store-dir = logs/coord.$ID.store",
        "",
    ]
    for p in coord_ports:
        lines.append(f"[coordserver.{p}]")
        if p == old_version_port:
            lines.append(f"protocol-version = {OLD_PROTOCOL}")
        lines.append("")
    lines += [
        "[fdbserver]",
        f"command = {exe} -m foundationdb_tpu_torch.tools.server",
        f"env.PYTHONPATH = {PKG_ROOT}",
        "port = $ID",
        "cluster-file = fdb.cluster",
        "shards = 1",
        "replication = 1",
        "workers = 0",
        "engine = memory",
        f"device = {device}",
        "image-dir = image",
        "trace-file = logs/server.trace",
        "ready-file = logs/server.ready",
        "run-seconds = 900",
        "",
        f"[fdbserver.{gw_port}]",
        "",
    ]
    return "\n".join(lines)


def _pinned_protocol(spec) -> str | None:
    """The `--protocol-version` a supervised section starts with, if any."""
    argv = spec.argv
    if "--protocol-version" in argv[:-1]:
        return argv[argv.index("--protocol-version") + 1]
    return None


def _write_atomic(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


class Load:
    """Shared state between the driver and its load threads: the acked-op
    timeline (the availability record), the acked-increment ledger the
    zero-loss check audits, and the cycle-workload step count."""

    def __init__(self) -> None:
        self.stop = threading.Event()
        self._lock = threading.Lock()
        self.acks: list[tuple[float, float]] = []  # (wall time, latency s)
        self.acked_increments = 0
        self.cycle_steps = 0
        self.errors: list[str] = []

    def ack(self, t: float, latency: float) -> None:
        with self._lock:
            self.acks.append((t, latency))

    def error(self, e: Exception) -> None:
        with self._lock:
            self.errors.append(repr(e)[:200])


def _new_client(host: str, port: int):
    from ..client.gateway_client import GatewayClient

    # generous redial window: a server bounce (image save + recovery)
    # must never exhaust the client's patience mid-campaign
    return GatewayClient(host, port, timeout=30.0, reconnect_backoff=0.05,
                         reconnect_max=1.0, reconnect_window=120.0)


def _counter_loop(load: Load, host: str, port: int) -> None:
    """Watermark load: db.run(atomic_add(+1)).  Every return from run() is
    an ACKED commit — the final counter must cover all of them (unknown-
    result retries may overshoot, never undershoot)."""
    db = _new_client(host, port)
    try:
        while not load.stop.is_set():
            t0 = time.time()
            try:
                db.run(lambda tr: tr.atomic_add(COUNTER_KEY, 1))
            except Exception as e:  # noqa: BLE001 — record, keep loading
                load.error(e)
                time.sleep(0.2)
                continue
            now = time.time()
            load.ack(now, now - t0)
            load.acked_increments += 1
    finally:
        db.close()


def _cycle_loop(load: Load, host: str, port: int) -> None:
    """Cycle workload (workloads/cycle.py's ring on the wire protocol):
    each transaction swaps two ring links; the value multiset must stay a
    permutation of 0..RING-1 through every bounce."""
    db = _new_client(host, port)
    try:
        i = 0
        while not load.stop.is_set():
            a, b = i % RING, (i + 2) % RING

            def fn(tr, a=a, b=b):
                va = tr.get(b"cyc%d" % a)
                vb = tr.get(b"cyc%d" % b)
                tr.set(b"cyc%d" % a, vb)
                tr.set(b"cyc%d" % b, va)

            t0 = time.time()
            try:
                db.run(fn)
            except Exception as e:  # noqa: BLE001 — record, keep loading
                load.error(e)
                time.sleep(0.2)
                continue
            now = time.time()
            load.ack(now, now - t0)
            load.cycle_steps += 1
            i += 1
    finally:
        db.close()


class Campaign:
    def __init__(self, out: str, n_coords: int, max_gap: float,
                 settle: float, device: str = "cuda") -> None:
        self.out = os.path.abspath(out)
        self.device = device
        self.max_gap = max_gap
        self.settle = settle
        os.makedirs(os.path.join(self.out, "logs"), exist_ok=True)
        self.coord_ports = [_free_port() for _ in range(n_coords)]
        self.spare_coord_port = _free_port()
        self.gw_port = _free_port()
        self.conf_path = os.path.join(self.out, "fdbmonitor.conf")
        self.cluster_file = os.path.join(self.out, "fdb.cluster")
        self.mon: Monitor | None = None
        self.load = Load()
        self.threads: list[threading.Thread] = []
        self.bounces: list[dict] = []
        self.checks: list[dict] = []
        self.mixed_version: dict = {}

    # -- plumbing -------------------------------------------------------------
    def check(self, name: str, ok: bool, detail: str = "") -> bool:
        self.checks.append({"name": name, "ok": bool(ok), "detail": detail})
        print(f"  [{'ok' if ok else 'FAIL'}] {name}"
              + (f" — {detail}" if detail else ""), flush=True)
        return ok

    def pump(self, until, timeout: float, step: float = 0.05) -> bool:
        """Drive the in-process supervisor's poll loop until `until()` or
        the deadline."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            self.mon.poll()
            if until():
                return True
            time.sleep(step)
        return False

    def _ready(self, section: str) -> bool:
        child = self.mon.children.get(section)
        return child is not None and self.mon._ready(child)

    def all_ready(self) -> bool:
        return all(self._ready(s) for s in self.mon.children)

    def _write_cluster_file(self, ports: list[int]) -> None:
        from ..client.cluster_file import write_cluster_file
        from ..rpc.network import NetworkAddress

        write_cluster_file(
            self.cluster_file,
            [NetworkAddress("127.0.0.1", p) for p in ports],
        )

    def _rewrite_conf(self, coord_ports: list[int],
                      old_version_port: int | None = None) -> None:
        _write_atomic(
            self.conf_path,
            _build_conf(coord_ports, self.gw_port, old_version_port,
                        self.device),
        )

    # -- phases ---------------------------------------------------------------
    def boot(self) -> None:
        print(f"booting {len(self.coord_ports)} coordinators + 1 server "
              f"under fdbmonitor (out {self.out})", flush=True)
        self._write_cluster_file(self.coord_ports)
        self._rewrite_conf(self.coord_ports)
        self.mon = Monitor(
            self.conf_path,
            trace_file=os.path.join(self.out, "logs", "monitor.trace"),
            status_file=os.path.join(self.out, "monitor.status.json"),
        )
        self.mon.start()
        if not self.pump(self.all_ready, timeout=180.0):
            states = {s: c.state() for s, c in self.mon.children.items()}
            raise RuntimeError(f"cluster never became ready: {states}")
        self.initial_sections = set(self.mon.children)
        db = _new_client("127.0.0.1", self.gw_port)

        def seed(tr):
            tr.set(COUNTER_KEY, struct.pack("<q", 0))
            for i in range(RING):
                tr.set(b"cyc%d" % i, b"%d" % ((i + 1) % RING))

        try:  # run: the seed write is idempotent, so a retry is safe
            db.run(seed)
        finally:
            db.close()
        for fn in (_counter_loop, _cycle_loop):
            t = threading.Thread(
                target=fn, args=(self.load, "127.0.0.1", self.gw_port),
                daemon=True)
            t.start()
            self.threads.append(t)
        # let the load establish a pre-bounce ack baseline
        self.pump(lambda: len(self.load.acks) >= 10, timeout=60.0)

    def bounce_section(self, section: str, label: str) -> dict:
        """SIGTERM one supervised process under load (the operator's
        `kill -TERM`), wait for the supervisor to restart it and for the
        child to report ready again."""
        child = self.mon.children[section]
        old_pid = child.pid
        print(f"bouncing [{section}] pid {old_pid} ({label})", flush=True)
        t0 = time.time()
        os.kill(old_pid, signal.SIGTERM)
        restarted = self.pump(
            lambda: child.pid != old_pid and self._ready(section),
            timeout=180.0,
        )
        t1 = time.time()
        rec = {"section": section, "label": label, "old_pid": old_pid,
               "new_pid": child.pid, "t0": t0, "t1": t1,
               "restart_s": round(t1 - t0, 3), "restarted": restarted}
        self.bounces.append(rec)
        self.check(f"bounce {section} restarted", restarted,
                   f"{rec['restart_s']}s, pid {old_pid} -> {child.pid}")
        # settle: gather post-restart acks so the availability window and
        # the per-bounce bands cover the recovery tail
        self.pump(lambda: False, timeout=self.settle)
        return rec

    def rolling_bounce(self) -> None:
        print("\n== phase 1: rolling bounce, one process at a time ==",
              flush=True)
        for section in sorted(self.mon.children):
            self.bounce_section(section, "rolling")

    def mixed_protocol(self) -> None:
        print("\n== phase 2: mixed-protocol-version bounce ==", flush=True)
        victim_port = self.coord_ports[0]
        section = f"coordserver.{victim_port}"
        child = self.mon.children[section]
        old_pid = child.pid
        # hot-reload the conf with the old wire version pinned on ONE
        # coordinator: the supervisor bounces exactly that section
        self._rewrite_conf(self.coord_ports, old_version_port=victim_port)
        flipped = self.pump(
            lambda: _pinned_protocol(child.spec)
            == OLD_PROTOCOL and child.pid != old_pid
            and self._ready(section),
            timeout=120.0,
        )
        self.check("old-version coordinator hot-reload-bounced", flipped,
                   f"[{section}] --protocol-version {OLD_PROTOCOL}")
        mixed_t0 = time.time()
        # the mixed window: the new-version server re-asserts leadership
        # every 2s, redialing the old coordinator and severing at hello
        # each time — long enough for several severed attempts, so the
        # single traced event below proves the dedupe, not a lucky count
        self.pump(lambda: False, timeout=8.0)
        mixed_t1 = time.time()
        # revert: the pair must agree and reconnect
        self._rewrite_conf(self.coord_ports)
        old_pid2 = child.pid
        reverted = self.pump(
            lambda: _pinned_protocol(child.spec) is None
            and child.pid != old_pid2 and self._ready(section),
            timeout=120.0,
        )
        self.check("coordinator reverted to current version", reverted)
        self.pump(lambda: False, timeout=3.0)  # let the server redial it
        # audit the OLD coordinator's trace files: one mismatch per peer
        # pair, no decode loops
        events = []
        pattern = os.path.join(self.out, "logs",
                               f"coord.{victim_port}.trace.*.jsonl")
        for path in sorted(glob.glob(pattern)):
            with open(path) as f:
                for line in f:
                    try:
                        events.append(json.loads(line))
                    except ValueError:
                        pass
        mismatches = [e for e in events
                      if e.get("Type") == "TransportProtocolMismatch"]
        decode_fails = [e for e in events
                        if e.get("Type") == "TransportDecodeFailed"]
        pairs: dict = {}
        for e in mismatches:
            pairs.setdefault(
                (e.get("PeerAddress"), e.get("Theirs")), []).append(e)
        from ..runtime.serialize import PROTOCOL_VERSION

        self.mixed_version = {
            "victim": section,
            "window_s": round(mixed_t1 - mixed_t0, 3),
            "mismatch_events": len(mismatches),
            "peer_pairs": len(pairs),
            "decode_failures": len(decode_fails),
            "ours": OLD_PROTOCOL,
            "theirs_expected": hex(PROTOCOL_VERSION),
        }
        self.check("mismatch traced for at least one old/new pair",
                   len(pairs) >= 1, f"{len(pairs)} pair(s)")
        self.check(
            "exactly one TransportProtocolMismatch per peer pair",
            bool(pairs) and all(len(v) == 1 for v in pairs.values()),
            f"{len(mismatches)} event(s) over a {self.mixed_version['window_s']}s "
            f"mixed window with ~2s redials",
        )
        self.check(
            "mismatch names both versions",
            bool(mismatches)
            and all(e.get("Ours") == hex(int(OLD_PROTOCOL, 16))
                    and e.get("Theirs") == hex(PROTOCOL_VERSION)
                    for e in mismatches),
        )
        self.check("no decode-failure loops on the old coordinator",
                   not decode_fails, f"{len(decode_fails)} TransportDecodeFailed")

    def coordinator_change(self) -> None:
        print("\n== phase 3: coordinator change during bounce ==", flush=True)
        new_port = self.spare_coord_port
        retired_port = self.coord_ports[0]
        # 1) add the new coordinator via conf hot-reload
        grown = self.coord_ports + [new_port]
        self._rewrite_conf(grown)
        added = self.pump(
            lambda: self._ready(f"coordserver.{new_port}"), timeout=120.0)
        self.check("new coordinator added via conf hot-reload", added,
                   f"[coordserver.{new_port}]")
        # 2) rewrite the cluster file to the new quorum (the server reads
        # it at boot), then bounce the server mid-load: it comes back from
        # its restart image and publishes the gateway to the NEW quorum
        new_quorum = [p for p in grown if p != retired_port]
        self._write_cluster_file(new_quorum)
        self.bounce_section(f"fdbserver.{self.gw_port}", "coordinator-change")
        # 3) retire the old coordinator: conf section removed -> stopped
        self.coord_ports = [p for p in grown if p != retired_port]
        self._rewrite_conf(self.coord_ports)
        retired = self.pump(
            lambda: f"coordserver.{retired_port}" not in self.mon.children,
            timeout=60.0,
        )
        self.check("old coordinator retired via conf hot-reload", retired,
                   f"[coordserver.{retired_port}] stopped")
        # 4) a FRESH client must discover the gateway through the new
        # quorum and see the workload's state
        from ..client.gateway_client import open_cluster

        try:
            db = open_cluster(self.cluster_file, timeout=60.0)
            try:
                # run, not read: a read version gone too old under load
                # (transaction_too_old) is retryable, and run retries it
                ring = db.run(lambda tr: sorted(
                    int(tr.get(b"cyc%d" % i)) for i in range(RING)))
            finally:
                db.close()
            self.check("fresh discovery through the new quorum",
                       ring == list(range(RING)), f"ring {ring}")
        except Exception as e:  # noqa: BLE001 — a failed check, not a crash
            self.check("fresh discovery through the new quorum", False,
                       repr(e)[:200])

    # -- verdicts -------------------------------------------------------------
    def finish(self) -> dict:
        print("\n== final audit ==", flush=True)
        self.load.stop.set()
        for t in self.threads:
            t.join(timeout=60.0)
        db = _new_client("127.0.0.1", self.gw_port)
        try:
            raw = db.run(lambda tr: tr.get(COUNTER_KEY))
            ring = db.run(lambda tr: sorted(
                int(tr.get(b"cyc%d" % i)) for i in range(RING)))
        finally:
            db.close()
        final = struct.unpack("<q", raw)[0] if raw else 0
        acked = self.load.acked_increments
        lost = max(0, acked - final)
        self.check(
            "zero acked-commit loss",
            lost == 0,
            f"counter {final} >= {acked} acked increments "
            f"({final - acked} unknown-result overshoot)",
        )
        self.check("cycle ring is a permutation",
                   ring == list(range(RING)), f"{ring}")
        # per-bounce availability + latency out of the ack timeline
        acks = sorted(self.load.acks)
        times = [t for t, _lat in acks]
        for rec in self.bounces:
            w0, w1 = rec["t0"], rec["t1"] + self.settle
            gap = 0.0
            for a, b in zip(times, times[1:]):
                if b >= w0 and a <= w1:
                    gap = max(gap, b - a)
            bands = LatencyBands(DEFAULT_LATENCY_BANDS)
            lats = [lat for t, lat in acks if w0 <= t <= w1]
            for lat in lats:
                bands.add(lat)
            lats.sort()
            rec["availability_gap_s"] = round(gap, 3)
            rec["acks_in_window"] = len(lats)
            rec["p50_ms"] = round(lats[len(lats) // 2] * 1e3, 2) if lats else None
            rec["p99_ms"] = (round(lats[min(len(lats) - 1, int(len(lats) * 0.99))]
                                   * 1e3, 2) if lats else None)
            rec["latency_bands"] = bands.snapshot()
            self.check(
                f"availability gap bounded ({rec['section']}, {rec['label']})",
                rec["restarted"] and gap <= self.max_gap and len(lats) > 0,
                f"gap {gap:.2f}s <= {self.max_gap}s, {len(lats)} acks in window",
            )
        # every supervised process was bounced at least once, and the
        # supervisor's own trace plane stays schema-valid
        from ..control.status import validate_monitor_event

        died = {e.get("Section") for e in self.mon.trace.events
                if e["Type"] == "ProcessDied"}
        missing = sorted(self.initial_sections - died)
        self.check("every OS process bounced at least once", not missing,
                   f"never died: {missing}" if missing
                   else f"{sorted(died)}")
        bad = []
        for e in self.mon.trace.events:
            try:
                validate_monitor_event(e)
            except ValueError as ve:
                bad.append(str(ve))
        self.check("supervisor trace events schema-valid", not bad,
                   "; ".join(bad[:3]))
        client_errors = list(self.load.errors)
        report = {
            "out": self.out,
            "gateway_port": self.gw_port,
            "coordinators": self.coord_ports,
            "acked_increments": acked,
            "final_counter": final,
            "acked_loss": lost,
            "cycle_steps": self.load.cycle_steps,
            "total_acks": len(acks),
            "client_errors": client_errors[:20],
            "client_error_count": len(client_errors),
            "bounces": self.bounces,
            "mixed_version": self.mixed_version,
            "checks": self.checks,
            "ok": all(c["ok"] for c in self.checks),
        }
        return report

    def shutdown(self) -> None:
        if self.mon is not None:
            self.load.stop.set()
            self.mon.shutdown()


def render_markdown(report: dict) -> str:
    lines = [
        "# Rolling-bounce campaign (fdbmonitor + real TCP fabric)",
        "",
        f"- processes: {len(report['coordinators'])} coordservers + 1 "
        f"fdbserver (gateway :{report['gateway_port']}), supervised by "
        "`tools/fdbmonitor.py`; load: watermark counter + cycle ring "
        "from 2 client threads (`client/gateway_client.py` reconnect path)",
        f"- acked commits: **{report['total_acks']}** "
        f"({report['acked_increments']} counter increments, "
        f"{report['cycle_steps']} cycle steps); acked-commit loss: "
        f"**{report['acked_loss']}** (counter {report['final_counter']}, "
        "unknown-result retries may overshoot, never undershoot)",
        f"- campaign verdict: "
        f"{'**OK**' if report['ok'] else '**FAILED**'}",
        "",
        "## Per-bounce availability (SIGTERM under load)",
        "",
        "| process | phase | restart s | avail gap s | acks in window "
        "| p50 ms | p99 ms |",
        "|---|---|---|---|---|---|---|",
    ]
    for b in report["bounces"]:
        lines.append(
            f"| `[{b['section']}]` | {b['label']} | {b['restart_s']} "
            f"| {b.get('availability_gap_s')} | {b.get('acks_in_window')} "
            f"| {b.get('p50_ms')} | {b.get('p99_ms')} |"
        )
    mv = report.get("mixed_version") or {}
    if mv:
        lines += [
            "",
            "## Mixed protocol version window",
            "",
            f"- `[{mv['victim']}]` hot-reload-bounced announcing "
            f"`{mv['ours']}` against the cluster's "
            f"`{mv['theirs_expected']}` for {mv['window_s']}s "
            "(~2s leader-reassert redials severing at hello each time)",
            f"- traced `TransportProtocolMismatch`: "
            f"**{mv['mismatch_events']}** event(s) across "
            f"**{mv['peer_pairs']}** old/new peer pair(s) — the per-pair "
            "dedupe, not one event per severed dial",
            f"- `TransportDecodeFailed` loops: {mv['decode_failures']}",
        ]
    lines += ["", "## Checks", "", "| check | verdict | detail |",
              "|---|---|---|"]
    for c in report["checks"]:
        d = (c["detail"] or "").replace("|", "\\|")
        lines.append(
            f"| {c['name']} | {'ok' if c['ok'] else '**FAIL**'} | {d} |")
    if report["client_error_count"]:
        lines += [
            "",
            f"Client-side retry-exhausted errors during the campaign: "
            f"{report['client_error_count']} (the load loops recreate "
            "their client and continue; acked-loss above is the "
            "correctness signal).",
        ]
    lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bounce", description=__doc__)
    ap.add_argument("--out", required=True,
                    help="campaign artifact directory (conf, logs, traces, "
                         "campaign.json/.md)")
    ap.add_argument("--coords", type=int, default=3)
    ap.add_argument("--max-gap", type=float, default=30.0,
                    help="per-bounce availability-gap bound (seconds)")
    ap.add_argument("--settle", type=float, default=2.0,
                    help="post-restart settle window folded into each "
                         "bounce's availability/latency accounting")
    ap.add_argument("--skip-phases", default="",
                    help="comma list of phases to skip (2,3) for quick runs")
    ap.add_argument("--device", default="cuda",
                    help="device of the server's conflict sets")
    args = ap.parse_args(argv)
    skip = {s.strip() for s in args.skip_phases.split(",") if s.strip()}
    camp = Campaign(args.out, n_coords=args.coords, max_gap=args.max_gap,
                    settle=args.settle, device=args.device)
    try:
        camp.boot()
        camp.rolling_bounce()
        if "2" not in skip:
            camp.mixed_protocol()
        if "3" not in skip:
            camp.coordinator_change()
        report = camp.finish()
    finally:
        camp.shutdown()
    with open(os.path.join(camp.out, "campaign.json"), "w") as f:
        json.dump(report, f, indent=2, default=str)
    md = render_markdown(report)
    with open(os.path.join(camp.out, "campaign.md"), "w") as f:
        f.write(md)
    print(f"\ncampaign {'OK' if report['ok'] else 'FAILED'} — artifacts in "
          f"{camp.out}", flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
