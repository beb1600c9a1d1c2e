"""The port's process supervisor (foundationdb_tpu_torch/tools/fdbmonitor.py)
against the reference's (foundationdb_tpu/tools/fdbmonitor.py): every
scenario of tests/test_fdbmonitor.py is one function over a namespace of
modules, run on both packages' Monitor with the same assertions.

Unit scenarios drive Monitor.poll() against cheap `python -c` children:
conf parsing (inheritance, $ID, env.* overlays, ready-file, garbage),
crash-restart backoff and its reset, restart-disabled sections, hot-reload
add/remove/change (mid-backoff and mid-crash-loop too), a torn conf,
SIGHUP, spawn failure, and the soak's fold of process deaths.  The port
starts a child with env.* entries through env(1) (it reads no environment
itself): a child sees the supervisor's environment untouched plus its
overlay, as the reference's does, and a missing command with an overlay
is still a spawn failure.  The real-fabric scenario: a supervised
coordserver and the port's fdbserver (`--device cpu`), the server
SIGTERMed under a live gateway client, acked data surviving the bounce;
then one `fdbtop --once` frame from the live cluster, equal to the
reference's rendering of the same scrape."""

from __future__ import annotations

import json
import os
import signal
import socket
import sys
import time
import types

import pytest

import foundationdb_tpu.control.status as ref_status
import foundationdb_tpu.tools.fdbmonitor as ref_monitor
import foundationdb_tpu.tools.soak as ref_soak
import foundationdb_tpu_torch.control.status as port_status
import foundationdb_tpu_torch.tools.fdbmonitor as port_monitor
import foundationdb_tpu_torch.tools.soak as port_soak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY = sys.executable
PKGS = {
    "ref": types.SimpleNamespace(monitor=ref_monitor, status=ref_status, soak=ref_soak),
    "port": types.SimpleNamespace(monitor=port_monitor, status=port_status,
                                  soak=port_soak),
}


@pytest.fixture(params=sorted(PKGS))
def m(request):
    return PKGS[request.param]


def write_conf(path, body: str) -> None:
    tmp = str(path) + ".tmp"
    with open(tmp, "w") as f:
        f.write(body)
    os.replace(tmp, str(path))


def pump(mon, until, timeout: float = 15.0, step: float = 0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        mon.poll()
        if until():
            return True
        time.sleep(step)
    return False


SLEEPER = f"command = {PY} -c \"import time; time.sleep(60)\""
CRASHER = f"command = {PY} -c \"raise SystemExit(3)\""


def base_conf(*sections: str) -> str:
    return "\n".join(["[general]", "restart-delay = 0.05", "max-restart-delay = 0.4",
                      "backoff-reset = 5", "conf-poll = 0.05", "kill-grace = 5", ""]
                     + list(sections))


def make_monitor(m, tmp_path, *sections: str, status: bool = True):
    conf = tmp_path / "m.conf"
    write_conf(conf, base_conf(*sections))
    mon = m.monitor.Monitor(
        str(conf), status_file=str(tmp_path / "status.json") if status else None)
    mon.start()
    return mon


def events(mon, kind: str, **match) -> list:
    return [e for e in mon.trace.events if e["Type"] == kind
            and all(e.get(k) == v for k, v in match.items())]


# -- conf parsing -------------------------------------------------------------


def test_parse_conf_inheritance_and_substitution(m, tmp_path):
    conf = tmp_path / "m.conf"
    write_conf(conf, "\n".join([
        "[general]", "restart-delay = 1", "[worker]", "command = prog serve",
        "port = $ID", "mode = shared", "env.COMMON = base", "[worker.4001]",
        "[worker.4002]", "mode = special", "env.EXTRA = $ID", "restart = false",
    ]))
    general, specs = m.monitor.parse_conf(str(conf))
    assert general["restart-delay"] == "1"
    assert sorted(specs) == ["worker.4001", "worker.4002"]
    s1, s2 = specs["worker.4001"], specs["worker.4002"]
    assert s1.argv[:2] == ["prog", "serve"]
    assert ["--port", "4001"] == s1.argv[s1.argv.index("--port"):][:2]
    assert ["--mode", "shared"] == s1.argv[s1.argv.index("--mode"):][:2]
    assert ["--mode", "special"] == s2.argv[s2.argv.index("--mode"):][:2]
    assert s1.env == {"COMMON": "base"}
    assert s2.env == {"COMMON": "base", "EXTRA": "4002"}
    assert not any(a.startswith("--env") for a in s1.argv)
    assert s1.restart and not s2.restart
    assert "--restart" not in " ".join(s2.argv)
    # the same conf text parses to the same specs in both packages
    other = PKGS["port" if m is PKGS["ref"] else "ref"].monitor.parse_conf(str(conf))
    assert general == other[0]
    assert {k: v.key() for k, v in specs.items()} == {k: v.key() for k, v in other[1].items()}


def test_parse_conf_ready_file_resolved_and_passed(m, tmp_path):
    conf = tmp_path / "m.conf"
    write_conf(conf, "\n".join(["[w]", "command = prog",
                                "ready-file = run/w.$ID.ready", "[w.1]"]))
    _, specs = m.monitor.parse_conf(str(conf))
    spec = specs["w.1"]
    assert spec.ready_file == str(tmp_path / "run" / "w.1.ready")
    assert spec.argv[spec.argv.index("--ready-file") + 1] == spec.ready_file


def test_parse_conf_rejects_garbage(m, tmp_path):
    conf = tmp_path / "m.conf"
    for body in ("[w.1]\nport = 5\n", "not an ini at all [[[",
                 "[general]\nrestart-delay = 1\n"):
        write_conf(conf, body)
        with pytest.raises(m.monitor.ConfError):
            m.monitor.parse_conf(str(conf))


# -- supervision --------------------------------------------------------------


def test_crash_restart_backoff_and_disabled(m, tmp_path):
    mon = make_monitor(m, tmp_path, "[crash]", CRASHER, "[crash.1]", "",
                       "[oneshot]", CRASHER, "restart = false", "[oneshot.1]")
    try:
        crash = mon.children["crash.1"]
        assert pump(mon, lambda: crash.restarts >= 3)
        delays = [e["RestartInS"] for e in events(mon, "ProcessDied", Section="crash.1")]
        assert delays[0] == pytest.approx(0.05, abs=0.01)
        assert all(b >= a for a, b in zip(delays, delays[1:]))
        assert max(delays) <= 0.4 + 1e-9
        assert all(e["ExitCode"] == 3 for e in events(mon, "ProcessDied", Section="crash.1"))
        one = mon.children["oneshot.1"]
        assert pump(mon, lambda: one.state() == "dead")
        dead = events(mon, "ProcessDied", Section="oneshot.1")
        assert len(dead) == 1 and dead[0]["RestartInS"] == -1.0
        mon.poll()
        assert one.state() == "dead"
        status = json.load(open(tmp_path / "status.json"))
        assert status["processes"]["oneshot.1"]["state"] == "dead"
        assert status["processes"]["crash.1"]["restarts"] >= 3
    finally:
        mon.shutdown()


def test_backoff_resets_after_stable_run(m, tmp_path):
    mon = make_monitor(m, tmp_path, "[w]", SLEEPER, "[w.1]")
    mon.knobs.MONITOR_BACKOFF_RESET = 0.3
    try:
        child = mon.children["w.1"]
        for _ in range(2):
            pid = child.pid
            os.kill(pid, signal.SIGKILL)
            assert pump(mon, lambda: child.pid not in (None, pid) and child.proc is not None)
        assert child.delay > mon.knobs.MONITOR_RESTART_BACKOFF
        time.sleep(0.35)
        pid = child.pid
        os.kill(pid, signal.SIGKILL)
        assert pump(mon, lambda: events(mon, "ProcessDied", Pid=pid))
        assert events(mon, "ProcessDied", Pid=pid)[-1]["RestartInS"] == pytest.approx(
            0.05, abs=0.01)
    finally:
        mon.shutdown()


def test_hot_reload_add_remove_change(m, tmp_path):
    conf = tmp_path / "m.conf"
    mon = make_monitor(m, tmp_path, "[w]", SLEEPER, "[w.1]")
    try:
        keeper = mon.children["w.1"].pid
        write_conf(conf, base_conf("[w]", SLEEPER, "[w.1]", "[w.2]"))
        assert pump(mon, lambda: "w.2" in mon.children
                    and mon.children["w.2"].proc is not None)
        assert mon.children["w.1"].pid == keeper
        pid2 = mon.children["w.2"].pid
        write_conf(conf, base_conf("[w]", SLEEPER, "[w.1]", "[w.2]",
                                   f"command = {PY} -c \"import time; time.sleep(61)\""))
        assert pump(mon, lambda: mon.children["w.2"].pid not in (None, pid2))
        assert mon.children["w.1"].pid == keeper
        write_conf(conf, base_conf("[w]", SLEEPER, "[w.1]"))
        assert pump(mon, lambda: "w.2" not in mon.children)
        assert mon.children["w.1"].pid == keeper
        reloads = events(mon, "ConfReloaded")
        assert [r["Added"] for r in reloads] == ["w.2", "", ""]
        assert [r["Removed"] for r in reloads] == ["", "", "w.2"]
        assert [r["Changed"] for r in reloads] == ["", "w.2", ""]
    finally:
        mon.shutdown()


def test_hot_reload_remove_during_backoff(m, tmp_path):
    conf = tmp_path / "m.conf"
    mon = make_monitor(m, tmp_path, "[w]", SLEEPER, "[w.1]", "",
                       "[crash]", CRASHER, "[crash.1]")
    mon.knobs.MONITOR_RESTART_BACKOFF = 2.0
    try:
        crash = mon.children["crash.1"]
        assert pump(mon, lambda: crash.state() == "backoff")
        write_conf(conf, base_conf("[w]", SLEEPER, "[w.1]"))
        assert pump(mon, lambda: "crash.1" not in mon.children)
        before = len(events(mon, "ProcessDied"))
        time.sleep(0.15)
        mon.poll()
        assert len(events(mon, "ProcessDied")) == before
    finally:
        mon.shutdown()


def test_hot_reload_param_change_during_crash_loop(m, tmp_path):
    conf = tmp_path / "m.conf"
    marker = tmp_path / "fixed.marker"
    mon = make_monitor(m, tmp_path, "[crash]", CRASHER, "[crash.1]")
    mon.knobs.MONITOR_RESTART_BACKOFF = 0.3
    try:
        crash = mon.children["crash.1"]
        assert pump(mon, lambda: crash.state() == "backoff")
        write_conf(conf, base_conf(
            "[crash]", f"command = {PY} -c \"import sys, time; "
            f"open({str(marker)!r}, 'w').close(); time.sleep(60)\"", "[crash.1]"))
        assert pump(mon, lambda: marker.exists() and crash.proc is not None)
        assert crash.state() == "running"
    finally:
        mon.shutdown()


def test_torn_conf_keeps_last_good(m, tmp_path):
    conf = tmp_path / "m.conf"
    mon = make_monitor(m, tmp_path, "[w]", SLEEPER, "[w.1]")
    try:
        pid = mon.children["w.1"].pid
        write_conf(conf, "[w]\ncommand = ")
        assert pump(mon, lambda: events(mon, "MonitorConfInvalid"))
        n = len(events(mon, "MonitorConfInvalid"))
        for _ in range(5):
            mon.poll()
            time.sleep(0.02)
        assert len(events(mon, "MonitorConfInvalid")) == n
        assert mon.children["w.1"].pid == pid
        assert mon.children["w.1"].state() == "running"
        write_conf(conf, base_conf("[w]", SLEEPER, "[w.1]", "[w.2]"))
        assert pump(mon, lambda: "w.2" in mon.children)
        assert mon.children["w.1"].pid == pid
    finally:
        mon.shutdown()


def test_sighup_triggers_reload_and_events_validate(m, tmp_path):
    conf = tmp_path / "m.conf"
    mon = make_monitor(m, tmp_path, "[w]", SLEEPER, "[w.1]")
    try:
        mon._hup = True
        mon.poll()
        assert events(mon, "ConfReloaded")
        os.kill(mon.children["w.1"].pid, signal.SIGKILL)
        assert pump(mon, lambda: events(mon, "ProcessDied"))
        write_conf(conf, "totally [[ torn")
        assert pump(mon, lambda: events(mon, "MonitorConfInvalid"))
    finally:
        mon.shutdown()
    types_seen = {e["Type"] for e in mon.trace.events}
    assert {"MonitorStarted", "ProcessStarted", "ProcessDied", "ConfReloaded",
            "MonitorConfInvalid", "ProcessStopped", "MonitorStopped"} <= types_seen
    for e in mon.trace.events:
        m.status.validate_monitor_event(e)
        PKGS["ref"].status.validate_monitor_event(e)  # the same schema


@pytest.mark.parametrize("overlay", [False, True])
def test_spawn_failure_backs_off(m, tmp_path, overlay):
    mon = make_monitor(m, tmp_path, "[w]", "command = /nonexistent/binary-xyzzy",
                       *(["env.SOME = 1"] if overlay else []), "[w.1]")
    try:
        child = mon.children["w.1"]
        assert child.proc is None
        assert pump(mon, lambda: len(events(mon, "ProcessSpawnFailed")) >= 2)
        assert child.state() == "backoff"
        assert "binary-xyzzy" in events(mon, "ProcessSpawnFailed")[0]["Error"]
    finally:
        mon.shutdown()


def test_children_inherit_the_environment_plus_their_overlay(m, tmp_path, monkeypatch):
    """A child sees the supervisor's environment untouched and its
    section's env.* entries on top ($ID substituted), in both packages."""
    monkeypatch.setenv("BOUNCE_INHERITED", "from-the-supervisor")
    out = tmp_path / "env.json"
    dump = (f"command = {PY} -c \"import json, os; json.dump(dict(os.environ), "
            f"open({str(out)!r} + os.environ['ENV_ID'], 'w')); import time; time.sleep(60)\"")
    mon = make_monitor(m, tmp_path, "[w]", dump, "env.ENV_ID = .$ID", "env.EXTRA = x y",
                       "[w.1]", "[w.2]", "env.BOUNCE_INHERITED = overridden")
    try:
        assert pump(mon, lambda: all(os.path.exists(f"{out}.{i}") for i in (1, 2)))
        time.sleep(0.2)
        env1, env2 = (json.load(open(f"{out}.{i}")) for i in (1, 2))
    finally:
        mon.shutdown()
    assert env1["BOUNCE_INHERITED"] == "from-the-supervisor"
    assert env2["BOUNCE_INHERITED"] == "overridden"
    assert (env1["EXTRA"], env1["ENV_ID"], env2["ENV_ID"]) == ("x y", ".1", ".2")
    assert env1.get("PATH") == os.environ.get("PATH")


def test_soak_folds_process_deaths(m, tmp_path):
    mon = make_monitor(m, tmp_path, "[crash]", CRASHER, "[crash.1]", "",
                       "[oneshot]", CRASHER, "restart = false", "[oneshot.1]")
    try:
        assert pump(mon, lambda: mon.children["crash.1"].restarts >= 2
                    and mon.children["oneshot.1"].state() == "dead")
    finally:
        mon.shutdown()
    rows = m.soak.process_deaths(list(mon.trace.events))
    assert rows == PKGS["ref"].soak.process_deaths(list(mon.trace.events))
    by_sec = {r["section"]: r for r in rows}
    assert by_sec["crash.1"]["deaths"] >= 2 and by_sec["crash.1"]["last_exit_code"] == 3
    assert not by_sec["crash.1"]["restart_disabled"]
    assert by_sec["oneshot.1"]["restart_disabled"]
    assert rows[0]["section"] == "crash.1"
    report = {  # the port's report names the workers' device (its repro line)
        "spec": "monitor-fold", "seeds": [0], "jobs": 1, "wall_s": 0.0, "ok": False,
        "device": "cpu",
        "verdicts": {"pass": 0, "fail": 1, "timeout": 0, "crash": 0},
        "coverage": {"required": [], "missing_required": [],
                     "merged": {"buggify": {}, "testcov": {}}},
        "per_seed": [{"seed": 0, "verdict": "fail", "wall_s": 0.0, "error": "x",
                      "triage": {"process_deaths": rows}}],
    }
    md = m.soak.render_markdown(report)
    assert "supervised process deaths (fdbmonitor)" in md
    assert "restart disabled, stayed dead" in md


# -- the real fabric ----------------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_supervised_cluster_server_bounce(m, tmp_path, capsys, monkeypatch):
    """A supervised coordserver + the port's fdbserver on "cpu" (children
    find the package through env.PYTHONPATH); the server is SIGTERMed
    under a live gateway client and acked data survives the bounce
    (restart image, durable coordinator registers, client reconnect).
    Then `fdbtop --once` against the live gateway prints the frame the
    reference's renderer makes of the same scrape."""
    from foundationdb_tpu.tools import fdbtop as ref_top
    from foundationdb_tpu_torch.client.cluster_file import write_cluster_file
    from foundationdb_tpu_torch.client.gateway_client import GatewayClient
    from foundationdb_tpu_torch.rpc.network import NetworkAddress
    from foundationdb_tpu_torch.tools import fdbtop as port_top

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the children's: see test_torch_bounce.py
    coord_port, gw_port = _free_port(), _free_port()
    write_cluster_file(str(tmp_path / "fdb.cluster"),
                       [NetworkAddress("127.0.0.1", coord_port)])
    conf = tmp_path / "m.conf"
    write_conf(conf, "\n".join([
        "[general]", "restart-delay = 0.25", "conf-poll = 0.2", "kill-grace = 20",
        "logdir = logs", "",
        "[coordserver]", f"command = {PY} -m foundationdb_tpu_torch.tools.coordserver",
        f"env.PYTHONPATH = {REPO}", "port = $ID", "run-seconds = 300",
        "ready-file = logs/coord.$ID.ready", "store-dir = logs/coord.$ID.store",
        f"[coordserver.{coord_port}]", "",
        "[fdbserver]", f"command = {PY} -m foundationdb_tpu_torch.tools.server",
        f"env.PYTHONPATH = {REPO}", "port = $ID", "cluster-file = fdb.cluster",
        "shards = 1", "replication = 1", "workers = 0", "engine = memory",
        "device = cpu", "image-dir = image", "ready-file = logs/server.ready",
        "run-seconds = 300", f"[fdbserver.{gw_port}]",
    ]))
    mon = m.monitor.Monitor(str(conf), status_file=str(tmp_path / "status.json"))
    mon.start()
    try:
        assert pump(mon, lambda: all(mon._ready(c) for c in mon.children.values()),
                    timeout=120.0)
        db = GatewayClient("127.0.0.1", gw_port, timeout=30.0, reconnect_window=60.0)
        try:
            db.run(lambda tr: tr.set(b"bounce/k", b"v1"))
            server = mon.children[f"fdbserver.{gw_port}"]
            pid = server.pid
            os.kill(pid, signal.SIGTERM)
            assert pump(mon, lambda: server.pid not in (None, pid) and mon._ready(server),
                        timeout=120.0)
            assert db.run(lambda tr: tr.get(b"bounce/k")) == b"v1"
            db.run(lambda tr: tr.set(b"bounce/k2", b"v2"))
            assert db.read(lambda tr: tr.get(b"bounce/k2")) == b"v2"
            doc, shards = port_top.snapshot(db)
            assert doc["kernel"]["backend"] == "cpu"
            assert port_top.render(doc, shards, None, 0.0) == ref_top.render(
                doc, shards, None, 0.0)
        finally:
            db.close()
        capsys.readouterr()
        assert port_top.main(["--port", str(gw_port), "--once"]) == 0
        frame = capsys.readouterr().out
        assert frame.startswith("fdbtpu top") and "proxy: version" in frame
        died = events(mon, "ProcessDied")
        assert [e["Section"] for e in died] == [f"fdbserver.{gw_port}"]
        for e in mon.trace.events:
            m.status.validate_monitor_event(e)
    finally:
        mon.shutdown()
    assert all(c.proc is None for c in mon.children.values())
