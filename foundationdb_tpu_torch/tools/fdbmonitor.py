"""Process supervisor daemon — the fdbmonitor analog
(fdbmonitor/fdbmonitor.cpp:501 fork/exec of the conf-declared process set,
:1052 inotify conf hot-reload, restart backoff).

    python -m foundationdb_tpu_torch.tools.fdbmonitor --conf fdbmonitor.conf
           [--trace-file PATH] [--status-file PATH]

Production clusters are *operated*, not launched: one supervisor per host
reads an ini conf describing the processes that should exist there, keeps
them running (crash -> restart with per-process exponential backoff,
reset after a stable run), and reshapes the live process set when the
conf changes — added/removed/changed sections start/stop/bounce exactly
the affected processes, a torn or unparseable conf is ignored in favor of
the last good one (never kill the world over an editor's half-written
save).  Supervision decisions land in the supervisor's OWN rolling trace
files (MonitorStarted/ProcessDied/ProcessRestarted/ConfReloaded...), so
`tools/trace_tool.py` and soak triage join the supervisor's timeline with
the servers' — "which process died, when, and who restarted it" is
answerable from one artifact dir.

Conf format (fdbmonitor.conf analog)::

    [general]
    restart-delay = 0.25        ; initial backoff (MONITOR_RESTART_BACKOFF)
    max-restart-delay = 8       ; backoff cap    (MONITOR_MAX_BACKOFF)
    backoff-reset = 10          ; stable-run seconds that reset the backoff
    conf-poll = 0.5             ; conf change poll cadence (SIGHUP also works)
    kill-grace = 5              ; SIGTERM -> SIGKILL escalation window
    logdir = ./logs

    [fdbserver]                 ; base section: defaults for fdbserver.*
    command = python -m foundationdb_tpu_torch.tools.server
    port = $ID                  ; $ID = the instance's section suffix

    [fdbserver.4500]            ; one process: argv = command + --key value
    cluster-file = ./fdb.cluster
    ready-file = logs/fdbserver.4500.ready     ; child writes, monitor observes
    device = cuda                              ; the resolvers' card
    env.PYTHONPATH = /srv/fdb                  ; env.* -> child environment
    restart = true              ; false: stay dead after a crash

Every merged key other than command/restart/ready-file/env.* becomes a
`--key value` argument ($ID substituted); an empty value is a bare flag.
`ready-file` is resolved against the conf dir and passed to the child as
`--ready-file PATH`; the child writes it once serving and the supervisor
(and the bounce driver) treat its existence as readiness.
The supervisor is host-wall, blocking, single-threaded code by design —
it never runs under deterministic simulation.

Copy of the reference package's module, on this package's modules.  A
child inherits the supervisor's environment untouched; its section's
env.* entries are added by starting it through `env NAME=VALUE ...`, so
the supervisor itself reads no environment variable.  A command that
cannot be found is a spawn failure, as in the reference.
"""
# flowlint: file ok wall-clock (supervisor daemon: backoff timers, stable-run reset and conf polling are host wall by design; never sim-reachable)

from __future__ import annotations

import argparse
import configparser
import json
import os
import shlex
import shutil
import signal
import subprocess
import sys
import time

from ..runtime.knobs import CoreKnobs
from ..runtime.trace import SEV_WARN, TraceCollector, TraceFileSink

# [general] keys that override the MONITOR_* knob defaults
_GENERAL_KNOBS = {
    "restart-delay": "MONITOR_RESTART_BACKOFF",
    "max-restart-delay": "MONITOR_MAX_BACKOFF",
    "backoff-reset": "MONITOR_BACKOFF_RESET",
    "conf-poll": "MONITOR_CONF_POLL",
    "kill-grace": "MONITOR_KILL_GRACE",
}
# merged section keys that are supervisor directives, not child arguments
_RESERVED_KEYS = ("command", "restart", "ready-file")


class ConfError(Exception):
    """The conf is unreadable/unparseable or a section is malformed; the
    caller keeps the last good conf (never kill the world)."""


class ProcessSpec:
    """One conf section resolved to a concrete child: argv, env overlay,
    restart policy, optional ready-file to observe."""

    def __init__(self, section: str, argv: list[str], env: dict[str, str],
                 restart: bool, ready_file: str | None) -> None:
        self.section = section
        self.argv = argv
        self.env = env
        self.restart = restart
        self.ready_file = ready_file

    def key(self) -> tuple:
        """Identity for the hot-reload diff: any change bounces the child."""
        return (tuple(self.argv), tuple(sorted(self.env.items())),
                self.restart, self.ready_file)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ProcessSpec) and self.key() == other.key()


def _subst(value: str, instance_id: str) -> str:
    return value.replace("$ID", instance_id)


def parse_conf(path: str) -> tuple[dict[str, str], dict[str, ProcessSpec]]:
    """(general, {section -> ProcessSpec}) for a conf file.  Instance
    sections (`[name.id]`) inherit the base section (`[name]`) with
    instance keys winning; `$ID` in any value becomes the instance id.
    Raises ConfError on anything unparseable — the caller's contract is to
    keep the previous conf."""
    cp = configparser.ConfigParser(interpolation=None, strict=True)
    try:
        with open(path, encoding="utf-8") as f:
            cp.read_file(f)
    except (OSError, configparser.Error, UnicodeDecodeError) as e:
        raise ConfError(f"unreadable conf {path}: {e}") from e
    general = dict(cp["general"]) if cp.has_section("general") else {}
    specs: dict[str, ProcessSpec] = {}
    for section in cp.sections():
        if section == "general" or "." not in section:
            continue  # general + base sections define no process themselves
        base, _, instance_id = section.partition(".")
        merged: dict[str, str] = {}
        if cp.has_section(base):
            merged.update(cp[base])
        merged.update(cp[section])
        merged = {k: _subst(v, instance_id) for k, v in merged.items()}
        command = merged.get("command")
        if not command:
            raise ConfError(f"section [{section}] has no command")
        argv = shlex.split(command)
        env = {}
        for k in sorted(merged):
            if k.startswith("env."):
                env[k[len("env."):].upper()] = merged[k]
        for k, v in merged.items():
            if k in _RESERVED_KEYS or k.startswith("env."):
                continue
            argv.append(f"--{k}")
            if v:
                argv.append(v)
        ready_file = merged.get("ready-file") or None
        if ready_file:
            # resolve against the conf dir (children run there; the
            # supervisor may not) and pass it down: the child WRITES the
            # file once serving, the supervisor only observes it
            if not os.path.isabs(ready_file):
                ready_file = os.path.join(
                    os.path.dirname(os.path.abspath(path)), ready_file)
            argv += ["--ready-file", ready_file]
        specs[section] = ProcessSpec(
            section, argv, env,
            restart=merged.get("restart", "true").lower()
            not in ("false", "0", "no"),
            ready_file=ready_file,
        )
    if not specs:
        raise ConfError(f"conf {path} declares no [name.id] process sections")
    return general, specs


class Child:
    """Supervision state for one section: the live Popen (if running), the
    restart-backoff schedule (if dead), and the counters status reports."""

    def __init__(self, spec: ProcessSpec, initial_delay: float) -> None:
        self.spec = spec
        self.proc: subprocess.Popen | None = None
        self.pid: int | None = None
        self.started_at = 0.0
        self.restarts = 0
        self.delay = initial_delay       # next death's restart delay
        self.next_start: float | None = None  # pending restart fire time
        self.dead = False                # crashed with restart disabled

    def state(self) -> str:
        if self.proc is not None:
            return "running"
        if self.dead:
            return "dead"
        return "backoff" if self.next_start is not None else "stopped"


class Monitor:
    """The supervisor.  `start()` + repeated `poll()` is the whole control
    loop (`run()` wraps it with signal handling for daemon use); tests
    drive poll() directly."""

    def __init__(self, conf_path: str, trace_file: str | None = None,
                 status_file: str | None = None,
                 knobs: CoreKnobs | None = None) -> None:
        self.conf_path = os.path.abspath(conf_path)
        self.knobs = knobs or CoreKnobs()
        self.children: dict[str, Child] = {}
        self.generation = 0  # successful conf loads
        self._conf_bytes = b""  # last-seen raw conf (change detection)
        self._last_bad = b""    # last conf that failed to parse (trace once)
        self._hup = False
        self._stopping = False
        self._t0 = time.time()
        self._sink = None
        if trace_file:
            self._sink = TraceFileSink(
                trace_file, roll_size=self.knobs.TRACE_ROLL_SIZE,
                max_logs=self.knobs.TRACE_MAX_LOGS)
        self.trace = TraceCollector(
            clock=lambda: time.time() - self._t0, sink=self._sink,
            machine=f"monitor:{os.getpid()}")
        self.status_file = status_file
        self.logdir = None  # set by the conf's [general] logdir

    # -- conf -----------------------------------------------------------------
    def _read_conf_bytes(self) -> bytes:
        try:
            with open(self.conf_path, "rb") as f:
                return f.read()
        except OSError:
            return b""

    def _apply_general(self, general: dict[str, str]) -> None:
        for conf_key, knob in _GENERAL_KNOBS.items():
            if conf_key in general:
                self.knobs.set_knob(knob, general[conf_key])
        self.logdir = general.get("logdir")
        if self.logdir:
            self.logdir = os.path.join(
                os.path.dirname(self.conf_path), self.logdir)
            os.makedirs(self.logdir, exist_ok=True)

    def load_conf(self) -> dict[str, ProcessSpec]:
        raw = self._read_conf_bytes()
        general, specs = parse_conf(self.conf_path)
        self._apply_general(general)
        self._conf_bytes = raw
        self._last_bad = b""
        self.generation += 1
        return specs

    # -- child lifecycle ------------------------------------------------------
    def _start_child(self, child: Child, restarted: bool) -> None:
        spec = child.spec
        if spec.ready_file:
            try:
                os.remove(spec.ready_file)
            except OSError:
                pass
        log = subprocess.DEVNULL
        if self.logdir:
            log = open(os.path.join(self.logdir, f"{spec.section}.log"), "ab")
        argv = spec.argv
        if spec.env:
            # the inherited environment plus the overlay, set by env(1)
            argv = ["env", *(f"{k}={v}" for k, v in sorted(spec.env.items())),
                    *argv]
        try:
            if spec.env and shutil.which(spec.argv[0]) is None:
                # env(1) would start and fail; Popen raises this itself
                raise FileNotFoundError(
                    2, "No such file or directory", spec.argv[0])
            child.proc = subprocess.Popen(
                argv,
                cwd=os.path.dirname(self.conf_path) or None,
                stdout=log, stderr=subprocess.STDOUT,
                start_new_session=False,
            )
        except OSError as e:
            # unspawnable (bad command): treat as an instant death so the
            # ordinary backoff loop owns the retry cadence
            if log is not subprocess.DEVNULL:
                log.close()
            child.proc = None
            child.pid = None
            child.next_start = time.time() + child.delay
            child.delay = min(child.delay * 2,
                              self.knobs.MONITOR_MAX_BACKOFF)
            self.trace.trace("ProcessSpawnFailed", Section=spec.section,
                             Error=str(e), RetryInS=round(child.delay, 3))
            return
        finally:
            if log is not subprocess.DEVNULL:
                log.close()
        child.pid = child.proc.pid
        child.started_at = time.time()
        child.next_start = None
        child.dead = False
        if restarted:
            child.restarts += 1
            self.trace.trace("ProcessRestarted", Section=spec.section,
                             Pid=child.pid, Restarts=child.restarts)
        else:
            self.trace.trace("ProcessStarted", Section=spec.section,
                             Pid=child.pid, Cmd=" ".join(spec.argv))

    def _stop_child(self, child: Child, reason: str) -> None:
        """SIGTERM, wait up to the kill-grace window, then SIGKILL."""
        proc, child.proc = child.proc, None
        child.next_start = None
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=self.knobs.MONITOR_KILL_GRACE)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        self.trace.trace("ProcessStopped", Section=child.spec.section,
                         Pid=child.pid or -1, Reason=reason)

    def _ready(self, child: Child) -> bool:
        if child.proc is None:
            return False
        if child.spec.ready_file is None:
            return True  # nothing to observe: running counts as ready
        return os.path.exists(child.spec.ready_file)

    # -- control loop ---------------------------------------------------------
    def start(self) -> None:
        specs = self.load_conf()
        self.trace.trace("MonitorStarted", Conf=self.conf_path,
                         Pid=os.getpid(),
                         Sections=",".join(sorted(specs)))
        for section in sorted(specs):
            child = Child(specs[section], self.knobs.MONITOR_RESTART_BACKOFF)
            self.children[section] = child
            self._start_child(child, restarted=False)
        self.write_status()

    def poll(self) -> None:
        """One supervision turn: reap deaths, fire due restarts, check the
        conf for changes (or a delivered SIGHUP), refresh status."""
        now = time.time()
        for child in self.children.values():
            if child.proc is not None and child.proc.poll() is not None:
                self._on_death(child, now)
            elif child.next_start is not None and now >= child.next_start:
                self._start_child(child, restarted=True)
        raw = self._read_conf_bytes()
        if self._hup or (raw != self._conf_bytes and raw != self._last_bad):
            self._hup = False
            self.reload()
        self.write_status()

    def _on_death(self, child: Child, now: float) -> None:
        code = child.proc.returncode
        ran = now - child.started_at
        child.proc = None
        # a stable run earns a fresh backoff (fdbmonitor's
        # restart-delay-reset-interval): only a crash LOOP escalates
        if ran >= self.knobs.MONITOR_BACKOFF_RESET:
            child.delay = self.knobs.MONITOR_RESTART_BACKOFF
        delay = child.delay
        child.delay = min(child.delay * 2, self.knobs.MONITOR_MAX_BACKOFF)
        if child.spec.restart:
            child.next_start = now + delay
        else:
            child.dead = True
        self.trace.trace(
            "ProcessDied", severity=SEV_WARN, track_latest="ProcessDied",
            Section=child.spec.section, Pid=child.pid or -1, ExitCode=code,
            RanS=round(ran, 3),
            RestartInS=round(delay, 3) if child.spec.restart else -1.0,
        )

    def reload(self) -> None:
        raw = self._read_conf_bytes()
        try:
            specs = self.load_conf()
        except ConfError as e:
            # keep the last good conf; trace once per distinct bad content
            self._last_bad = raw
            self.trace.trace("MonitorConfInvalid", severity=SEV_WARN,
                             track_latest="MonitorConfInvalid",
                             Conf=self.conf_path, Error=str(e)[:300])
            return
        added = sorted(set(specs) - set(self.children))
        removed = sorted(set(self.children) - set(specs))
        changed = sorted(
            s for s in set(specs) & set(self.children)
            if specs[s] != self.children[s].spec
        )
        for section in removed:
            # a section in restart-backoff just forgets its pending start
            self._stop_child(self.children.pop(section), reason="conf-removed")
        for section in added:
            child = Child(specs[section], self.knobs.MONITOR_RESTART_BACKOFF)
            self.children[section] = child
            self._start_child(child, restarted=False)
        for section in changed:
            child = self.children[section]
            child.spec = specs[section]
            if child.proc is not None:
                # bounce NOW with a fresh backoff: a deliberate conf change
                # is not a crash loop
                self._stop_child(child, reason="conf-changed")
                child.delay = self.knobs.MONITOR_RESTART_BACKOFF
                self._start_child(child, restarted=True)
            else:
                # mid-crash-loop param change: the already-scheduled restart
                # picks up the NEW argv/env; a disabled->enabled restart flip
                # revives a dead child on the normal cadence
                child.dead = False
                if child.next_start is None and child.spec.restart:
                    child.next_start = time.time() + child.delay
        # unaffected sections are untouched by contract: same pid after
        self.trace.trace("ConfReloaded", Generation=self.generation,
                         Added=",".join(added), Removed=",".join(removed),
                         Changed=",".join(changed))

    def write_status(self) -> None:
        """Atomic status snapshot for operators and the bounce driver: which
        pid owns each section, its supervision state, and readiness."""
        if not self.status_file:
            return
        doc = {
            "pid": os.getpid(),
            "conf": self.conf_path,
            "generation": self.generation,
            "processes": {
                s: {
                    "pid": c.pid,
                    "state": c.state(),
                    "restarts": c.restarts,
                    "ready": self._ready(c),
                }
                for s, c in sorted(self.children.items())
            },
        }
        tmp = self.status_file + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, self.status_file)
        except OSError:
            pass  # a full disk must not kill the supervisor

    def shutdown(self) -> None:
        if self._stopping:
            return
        self._stopping = True
        for section in sorted(self.children):
            self._stop_child(self.children[section], reason="shutdown")
        self.trace.trace("MonitorStopped", Pid=os.getpid())
        self.write_status()
        if self._sink is not None:
            self._sink.close()

    def run(self, run_seconds: float | None = None) -> None:
        """Daemon loop: poll on the conf-poll cadence until SIGTERM/SIGINT
        (clean shutdown of the whole process set) or the deadline."""
        def _term(_sig, _frm):
            raise KeyboardInterrupt
        def _hup(_sig, _frm):
            self._hup = True
        signal.signal(signal.SIGTERM, _term)
        signal.signal(signal.SIGHUP, _hup)
        deadline = None if run_seconds is None else time.time() + run_seconds
        try:
            while deadline is None or time.time() < deadline:
                self.poll()
                time.sleep(self.knobs.MONITOR_CONF_POLL)
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fdbmonitor", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--conf", required=True, help="fdbmonitor.conf path")
    ap.add_argument("--trace-file", default=None,
                    help="base path for the supervisor's own rolling trace "
                         "files (joinable with server traces by trace_tool)")
    ap.add_argument("--status-file", default=None,
                    help="atomic JSON snapshot of the supervised process "
                         "set (default: <conf>.status.json)")
    ap.add_argument("--run-seconds", type=float, default=None,
                    help="exit (clean shutdown) after N seconds")
    args = ap.parse_args(argv)
    mon = Monitor(
        args.conf, trace_file=args.trace_file,
        status_file=args.status_file or args.conf + ".status.json",
    )
    mon.start()
    print(f"fdbmonitor running {len(mon.children)} processes "
          f"(conf {mon.conf_path})", flush=True)
    mon.run(run_seconds=args.run_seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
