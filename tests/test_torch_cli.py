"""The port's admin shell (foundationdb_tpu_torch/tools/cli.py) against the
reference's (foundationdb_tpu/tools/cli.py): tests/test_cli.py's four
sessions, each one function over a `Cli` class, run on both packages with
the same seed (the port's cluster on device="cpu", its default backend,
the port's DeviceConflictSet), must print the same lines: reads, commit
versions, status, the kill's recovery epoch, move, backup, configure and
the DR verbs.  The DR session runs the reference with the port's
DRWorker `_pull` bound in (it applies nothing above the TLogs'
known-committed version, the reference's DRWorker does: ROADMAP C.2, and
tests/test_torch_dr.py does the same).  Each runs with the garbage collector off after a
collection (a collected transaction frees its cache's bytes, which status
reports: ROADMAP C.5).  Also the port's vexillographer against the
reference's: the same document but the reference's "Environment knobs"
section (the port reads no environment and carries no ENV_KNOBS) and the
generator's module path in the header line; and `cli`'s subcommand
dispatch and `--device`."""

import gc
import io
import types

import pytest

from foundationdb_tpu.client import dr as ref_dr
from foundationdb_tpu.tools import cli as ref_cli
from foundationdb_tpu_torch.client import dr as port_dr
from foundationdb_tpu.tools import vexillographer as ref_vex
from foundationdb_tpu_torch.tools import cli as port_cli
from foundationdb_tpu_torch.tools import vexillographer as port_vex
from tests.torch_threads import one_torch_thread  # noqa: F401


def commands_and_kill_recovery(Cli, kw):
    cli = Cli(seed=51, n_storage_shards=2, **kw)
    out = [cli.one_command(c) for c in (
        "set k1 v1", "get k1", "get nothing", "set k2 v2", "getrange k k3",
        "clear k1", "get k1", "status", "processes")]
    proxy_name = next(line.split()[0] for line in out[-1].splitlines()
                      if line.startswith("proxy"))
    out += [cli.one_command(c) for c in (
        f"kill {proxy_name}", "set after-kill yes", "get after-kill", "status")]
    cli.cluster.stop()
    return out


def scriptable_repl(Cli, kw):
    cli = Cli(seed=52, **kw)
    out = io.StringIO()
    cli.repl(stdin=io.StringIO("set a 1; get a\nhelp; bogus\nexit\n"), stdout=out)
    cli.cluster.stop()
    return [out.getvalue()]


def move_backup_configure_errorcode(Cli, kw):
    cli = Cli(seed=1701, n_storage_shards=2, storage_replication=2, **kw)
    out = [cli.one_command(f"set mk{i:03d} v{i}") for i in range(30)]
    out += [cli.one_command(c) for c in (
        "move mk010 mk020 1", "get mk015", "backup start bk-cli", "backup status",
        "backup stop", "configure n_tlogs=3", "errorcode 1020", "status")]
    cli.cluster.stop()
    return out


def dr_verbs(Cli, kw):
    cli = Cli(seed=61, **kw)
    out = [cli.one_command(c) for c in (
        "set drk v1", "dr start", "set drk2 v2", "dr status", "dr switch")]
    c2 = cli._dr_secondary
    db2 = c2.database()

    async def check():
        tr = db2.create_transaction()
        return await tr.get(b"drk"), await tr.get(b"drk2")

    out.append(repr(cli.cluster.run_until(cli.cluster.loop.spawn(check()), 120)))
    try:
        cli.one_command("set stale x")
    except Exception as e:  # noqa: BLE001 - compared by name
        out.append(type(e).__name__)
    cli.cluster.stop()
    c2.stop()
    return out


SESSIONS = {f.__name__: f for f in (commands_and_kill_recovery, scriptable_repl,
                                    move_backup_configure_errorcode, dr_verbs)}


def _run(session, Cli, kw):
    gc.collect()
    gc.disable()
    try:
        return SESSIONS[session](Cli, kw)
    finally:
        gc.enable()


@pytest.mark.parametrize("session", sorted(SESSIONS))
def test_sessions_print_the_references_lines(session, monkeypatch):
    code = port_dr.DRWorker._pull
    monkeypatch.setattr(ref_dr.DRWorker, "_pull", types.FunctionType(
        code.__code__, vars(ref_dr), code.__name__, code.__defaults__, code.__closure__))
    got = _run(session, port_cli.Cli, dict(device="cpu"))
    want = _run(session, ref_cli.Cli, {})
    assert got == want
    text = "\n".join(got)
    assert "committed" in text
    if session == "commands_and_kill_recovery":
        assert "epoch now 2" in text
    if session == "dr_verbs":
        assert got[-2:] == [repr((b"v1", b"v2")), "DatabaseLocked"]


def test_the_cli_takes_a_device():
    """`Cli` builds its cluster (and the DR secondary) on `device`: its
    resolvers host the port's set there; with no card the default raises
    before any cluster exists."""
    import torch

    cli = port_cli.Cli(seed=3, device="cpu")
    try:
        assert cli.device == "cpu"
        assert "cpu" in cli.one_command("status json")
    finally:
        cli.cluster.stop()
    if not torch.cuda.is_available():
        with pytest.raises(Exception):
            port_cli.Cli(seed=3)


def test_vexillographer_is_the_references_without_env_knobs():
    ref = ref_vex.generate()
    head, _, rest = ref.partition("\n## Environment knobs")
    tail = rest[rest.index("\n## Atomic operations"):]
    want = (head + tail).replace("python -m foundationdb_tpu.tools.vexillographer",
                                 "python -m foundationdb_tpu_torch.tools.vexillographer")
    assert port_vex.generate() == want
    assert "ENV_KNOBS" not in port_vex.generate()


def test_main_dispatches_subcommands(monkeypatch, capsys):
    """Each subcommand reaches its tool's main with the remaining
    arguments; `spec` passes --device on."""
    from foundationdb_tpu_torch.tools import bounce, fdbmonitor, fdbtop, flowlint, soak
    from foundationdb_tpu_torch.workloads import spec

    seen = []
    for mod in (soak, flowlint, fdbtop, fdbmonitor, bounce):
        monkeypatch.setattr(mod, "main", lambda argv, m=mod: seen.append(
            (m.__name__.rsplit(".", 1)[1], argv)) or 0)
    monkeypatch.setattr(spec, "run_spec_file", lambda path, **kw: seen.append(
        ("spec", path, kw["device"])) or {"ok": 1})
    monkeypatch.setattr(spec, "should_run_pair", lambda path: False)
    for argv in (["soak", "S.txt", "--device", "cpu"], ["lint", "--json"],
                 ["top", "--once"], ["monitor", "--conf", "m.conf"],
                 ["bounce", "--out", "o"], ["spec", "S.txt", "--device", "cpu"]):
        with pytest.raises(SystemExit) as ex:
            port_cli.main(argv)
        assert ex.value.code == 0
    assert seen == [("soak", ["S.txt", "--device", "cpu"]), ("flowlint", ["--json"]),
                    ("fdbtop", ["--once"]), ("fdbmonitor", ["--conf", "m.conf"]),
                    ("bounce", ["--out", "o"]), ("spec", "S.txt", "cpu")]
    assert '"ok": 1' in capsys.readouterr().out
