"""The port's flowlint (foundationdb_tpu_torch/lint/, tools/flowlint.py)
against the reference's (foundationdb_tpu/lint/, tools/flowlint.py).

- Every rule's fixture pair under tests/lint_fixtures/ (shared, unchanged)
  gives the same findings, as (rule, file, line, message), from both
  analyzers: the bad tree trips the rule, the ok tree does not.
- The port's tree is clean: `cli lint --json` with no paths lints
  foundationdb_tpu_torch and tests/test_torch_*.py, with no baseline
  (none is committed), and reports nothing.
- knob-env-sync: without an ENV_KNOBS registry among the linted files (the
  port carries none), a package file naming an env knob string is a
  finding, and a test file naming one is not (tests drive the reference
  package, whose switches they name).  The scratch packages are written
  under tmp_path; this file holds no such string itself.
- The baseline ratchet on the port's CLI (grandfathered, then stale, then
  pruned), its default baseline path of its own (the reference's
  .flowlint-baseline.json untouched by --write-baseline), and `--diff`."""

from __future__ import annotations

import json
import os
import pathlib
import subprocess

import pytest

from foundationdb_tpu import lint as ref_lint
from foundationdb_tpu.tools import flowlint as ref_flowlint
from foundationdb_tpu_torch import lint as port_lint
from foundationdb_tpu_torch.tools import cli as port_cli
from foundationdb_tpu_torch.tools import flowlint as port_flowlint

REPO_ROOT = port_flowlint.REPO_ROOT
FIXTURES = pathlib.Path(REPO_ROOT) / "tests" / "lint_fixtures"
RULE_DIRS = sorted(d.name for d in FIXTURES.iterdir() if d.is_dir())
ENV_KNOB = "FDBTPU" + "_SCRATCH_SWITCH"  # built, so this file names none


def _rows(findings) -> list[tuple]:
    return [(f.rule, f.path, f.line, f.message) for f in findings]


def test_the_rules_are_the_references():
    assert [r.id for r in port_lint.default_rules()] == [
        r.id for r in ref_lint.default_rules()]
    assert {r.id for r in port_lint.default_rules()} | {"suppression"} == set(RULE_DIRS)


@pytest.mark.parametrize("which", ["bad", "ok"])
@pytest.mark.parametrize("rule", RULE_DIRS)
def test_fixtures_give_the_references_findings(rule, which):
    paths = [str(FIXTURES / rule / which)]
    got = _rows(port_lint.run_lint(paths, root=REPO_ROOT, spec_dir=None))
    want = _rows(ref_lint.run_lint(paths, root=REPO_ROOT, spec_dir=None))
    assert got == want
    hits = [row for row in got if row[0] == rule]
    assert bool(hits) == (which == "bad"), got


def test_cli_lint_is_green_on_the_port_with_no_baseline(capsys):
    assert not os.path.exists(port_flowlint.DEFAULT_BASELINE)
    paths = port_flowlint.default_paths()
    assert paths[0] == os.path.join(REPO_ROOT, "foundationdb_tpu_torch")
    assert all(os.path.basename(p).startswith("test_torch_") for p in paths[1:])
    assert os.path.join(REPO_ROOT, "tests", "test_torch_flowlint.py") in paths
    with pytest.raises(SystemExit) as ex:
        port_cli.main(["lint", "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert ex.value.code == 0, doc["new"]
    assert doc == {"new": [], "baselined": [], "stale_baseline": []}


def _write_pkg(tmp_path: pathlib.Path, name: str, body: str) -> pathlib.Path:
    pkg = tmp_path / "foundationdb_tpu_torch"
    pkg.mkdir(exist_ok=True)
    mod = pkg / name
    mod.write_text(body)
    return mod


def test_knob_env_sync_fires_on_an_env_knob_in_the_package(tmp_path):
    _write_pkg(tmp_path, "mod.py", f'SWITCH = "{ENV_KNOB}"\n')
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_x.py").write_text(f'NAME = "{ENV_KNOB}"\n')
    findings = port_lint.run_lint([str(tmp_path / "foundationdb_tpu_torch"),
                                   str(tmp_path / "tests")], root=str(tmp_path))
    assert _rows(findings) == [(
        "knob-env-sync", "foundationdb_tpu_torch/mod.py", 1,
        f"env knob {ENV_KNOB!r} in a package that reads no environment")]
    # the same file beside a registry that names it is clean, as in the reference
    _write_pkg(tmp_path, "knobs.py", f'ENV_KNOBS = {{"{ENV_KNOB}": "a switch"}}\n')
    assert port_lint.run_lint([str(tmp_path / "foundationdb_tpu_torch")],
                              root=str(tmp_path)) == []


def test_baseline_grandfathers_then_goes_stale(tmp_path):
    mod = _write_pkg(tmp_path, "mod.py", "import time\n\n\ndef f():\n    return time.time()\n")
    bl = tmp_path / "baseline.json"
    args = [str(tmp_path / "foundationdb_tpu_torch"), "--root", str(tmp_path),
            "--baseline", str(bl)]
    assert port_flowlint.main(args[:3]) == 1  # no baseline: the finding fails
    assert port_flowlint.main(args + ["--write-baseline"]) == 0
    assert json.loads(bl.read_text())["findings"] == [
        {"line": 5, "path": "foundationdb_tpu_torch/mod.py", "rule": "wall-clock"}]
    assert port_flowlint.main(args) == 0
    mod.write_text("def f(loop):\n    return loop.now()\n")
    assert port_flowlint.main(args) == 1  # the entry went stale
    assert port_flowlint.main(args + ["--write-baseline"]) == 0
    assert json.loads(bl.read_text())["findings"] == []
    assert port_flowlint.main(args) == 0


def test_the_default_baseline_is_the_ports_own(tmp_path, monkeypatch, capsys):
    """--write-baseline with no --baseline writes the port's default path;
    the reference's committed baseline is neither read nor written."""
    ref_baseline = pathlib.Path(ref_flowlint.DEFAULT_BASELINE)
    before = ref_baseline.read_bytes()
    assert port_flowlint.DEFAULT_BASELINE != ref_flowlint.DEFAULT_BASELINE
    assert pathlib.Path(port_flowlint.DEFAULT_BASELINE).parent == pathlib.Path(
        port_lint.__file__).parent
    own = tmp_path / "own-baseline.json"
    monkeypatch.setattr(port_flowlint, "DEFAULT_BASELINE", str(own))
    _write_pkg(tmp_path, "mod.py", "import time\n\n\ndef f():\n    return time.time()\n")
    args = [str(tmp_path / "foundationdb_tpu_torch"), "--root", str(tmp_path)]
    assert port_flowlint.main(args + ["--write-baseline"]) == 0
    assert port_flowlint.main(args) == 0  # read back from the port's path
    assert len(json.loads(own.read_text())["findings"]) == 1
    assert ref_baseline.read_bytes() == before
    capsys.readouterr()


def test_diff_mode_reports_only_changed_files(tmp_path):
    ws = tmp_path / "ws"
    pkg = ws / "foundationdb_tpu_torch"
    pkg.mkdir(parents=True)
    bad = pkg / "bad.py"
    bad.write_text("import time\n\n\ndef f():\n    return time.time()\n")
    clean = pkg / "clean.py"
    clean.write_text("def g():\n    return 1\n")
    env = {**os.environ, "GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
           "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t"}

    def git(*args):
        r = subprocess.run(["git", *args], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=30)
        assert r.returncode == 0, r.stderr

    git("init", "-q")
    git("add", "-A")
    git("commit", "-qm", "seed")
    clean.write_text("def g():\n    return 2\n")
    argv = [str(pkg), "--root", str(ws)]
    assert port_flowlint.main(argv) == 1
    assert port_flowlint.main(argv + ["--diff", "HEAD"]) == 0
    bad.write_text("import time\n\n\ndef f():\n    return time.time()\n\n")
    assert port_flowlint.main(argv + ["--diff", "HEAD"]) == 1
    assert port_flowlint.main(argv + ["--diff", "no-such-rev"]) == 1
    with pytest.raises(SystemExit) as ex:
        port_cli.main(["lint", *argv, "--diff", "HEAD"])
    assert ex.value.code == 1
