"""The soak-campaign harness (foundationdb_tpu_torch/tools/soak.py): the
reference's tests/test_soak.py cases rerun on the port, with the
reference's two environment switches as the port's keywords
(`force_fail_seed=`, `device="cpu"`): the census merge and the required
check, the census's round trip through CodeCoverage trace events, a
campaign's verdicts, census and triage with one seed forced to fail, the
triage's repro command rerunning that seed, and the timeout verdict.  The
census pieces are also held against the reference's functions on the same
inputs, and a whole campaign against the reference's campaign on the same
spec and seeds.  A campaign on the card raises without one before it starts a
worker."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from foundationdb_tpu.tools import soak as jsoak
from foundationdb_tpu_torch.control.status import validate_coverage_event
from foundationdb_tpu_torch.runtime import buggify, coverage
from foundationdb_tpu_torch.runtime.core import DeterministicRandom
from foundationdb_tpu_torch.runtime.trace import SEV_ERROR, TraceCollector, TraceFileSink
from foundationdb_tpu_torch.tools import soak, trace_tool

REPO = pathlib.Path(__file__).resolve().parent.parent

MINI_SPEC = """\
testTitle=MiniSoak
seed=7
chaos=true

testName=Cycle
nodes=6
clients=2
txnsPerClient=4

testName=Attrition
kills=1
interval=2.0
startDelay=0.8
"""


@pytest.fixture(autouse=True)
def _census_clean():
    """The port's census is process-global, like the reference's (whose
    conftest isolates it): each test starts and ends clean."""
    cov, bug = coverage.snapshot(), buggify.snapshot()
    coverage.restore({})
    buggify.disable()
    yield
    coverage.restore(cov)
    buggify.restore(bug)


def _write_spec(tmp_path, coverage_lines="recovery.triggered\n"):
    spec = tmp_path / "Mini.txt"
    spec.write_text(MINI_SPEC)
    (tmp_path / "Mini.coverage").write_text(coverage_lines)
    return spec


def test_census_merge_and_required_check():
    per_seed = {
        1: {"buggify": {"a": {"armed": True, "fires": 2},
                        "b": {"armed": True, "fires": 0}},
            "testcov": {"x": 3, "buggify.a": 2}},
        2: {"buggify": {"a": {"armed": False, "fires": 0},
                        "b": {"armed": True, "fires": 0}},
            "testcov": {"y": 1}},
    }
    m = soak.merge_census(per_seed)
    assert m == jsoak.merge_census(per_seed)
    assert m["buggify"]["a"] == {"armed_seeds": 1, "hit_seeds": 1, "fires": 2}
    assert m["buggify"]["b"] == {"armed_seeds": 2, "hit_seeds": 0, "fires": 0}
    assert m["testcov"]["x"] == {"hit_seeds": 1, "hits": 3}
    assert soak.check_required(m, ["x", "y", "buggify.a"]) == []
    assert soak.check_required(m, ["buggify.b", "z", "x"]) == ["buggify.b", "z"]


def test_census_round_trips_through_trace_plane(tmp_path):
    """The port's buggify and coverage emit CodeCoverage events into a
    trace file; census_from_events rebuilds the same census, and the
    reference's function reads the port's events alike."""
    buggify.enable(DeterministicRandom(5))
    buggify.force("soaktest.site", 2)
    assert buggify.buggify("soaktest.site")
    assert buggify.buggify("soaktest.site")
    buggify.force("soaktest.unreached", 3)
    coverage.testcov("soaktest.path")
    sink = TraceFileSink(str(tmp_path / "t"))
    tc = TraceCollector(sink=sink)
    buggify.emit_coverage(tc)
    coverage.emit_coverage(tc)
    sink.close()
    events = trace_tool.load_events([str(tmp_path)])
    for ev in events:
        validate_coverage_event(ev)
    census = soak.census_from_events(events)
    assert census == jsoak.census_from_events(events)
    assert census["buggify"]["soaktest.site"] == {"armed": True, "fires": 2}
    assert census["buggify"]["soaktest.unreached"] == {"armed": True, "fires": 0}
    assert census["testcov"]["soaktest.path"] == 1
    assert census["testcov"]["buggify.soaktest.site"] == 2
    assert soak.seed_census()["buggify"]["soaktest.site"]["fires"] == 2


def test_soak_campaign_verdicts_census_and_triage(tmp_path):
    """A campaign on "cpu" writes JSON and markdown reports with per-seed
    verdicts and a merged census with no missing required site; the seed
    forced to fail carries a triage block with the first-error events,
    the slowest sampled transaction and a repro that names the port's
    module, the device and the forced seed."""
    spec = _write_spec(tmp_path)
    report = soak.run_campaign(
        str(spec), [3000, 3001, 3002], str(tmp_path / "out"),
        jobs=3, seed_deadline=240.0, device="cpu", force_fail_seed=3001,
    )
    assert report["verdicts"] == {"pass": 2, "fail": 1, "timeout": 0, "crash": 0}
    assert not report["ok"] and report["device"] == "cpu"
    assert report["coverage"]["missing_required"] == []
    assert report["coverage"]["merged"]["testcov"][
        "recovery.triggered"]["hit_seeds"] == 3
    assert set(report["coverage"]["per_seed"]) == {"3000", "3001", "3002"}
    # each worker's conflict-kernel launches: none on the CPU
    assert all("probe_fused" in r["launches"] and not any(r["launches"].values())
               for r in report["per_seed"])

    failing = [r for r in report["per_seed"] if r["verdict"] == "fail"]
    assert [r["seed"] for r in failing] == [3001]
    assert failing[0]["error"] == "AssertionError: forced failure (force_fail_seed)"
    t = failing[0]["triage"]
    assert any(ev["Type"] == "SoakSeedFailed" and ev["Severity"] >= SEV_ERROR
               for ev in t["first_events"]), t["first_events"]
    assert t["error_count"] >= 1 and "slow_task_count" in t
    st = t["slowest_transaction"]
    assert st is not None and st["station_count"] >= 3
    assert t["repro"] == (
        f"python -m foundationdb_tpu_torch.tools.soak {spec} --seeds 1 "
        "--first-seed 3001 --out repro-3001 --keep-traces --device cpu "
        "--force-fail-seed 3001")

    out = tmp_path / "out"
    assert json.loads((out / "campaign.json").read_text())["ok"] is False
    md = (out / "campaign.md").read_text()
    assert "seed 3001 — fail" in md and "repro" in md
    assert "buggify site" in md and "testcov name" in md
    assert (out / "seed-3001").is_dir()
    assert not list((out / "seed-3000").glob("trace*"))
    r3000 = json.loads((out / "seed-3000" / "result.json").read_text())
    assert r3000["verdict"] == "pass" and r3000["census"]["testcov"]


def _normalised(row: dict, forced: str) -> dict:
    """A campaign's seed row less its wall time, with the forced failure's
    text and the repro line (which name each package's own switch and
    module) cut to what both campaigns share."""
    row = {k: v for k, v in row.items() if k not in ("wall_s", "launches")}
    if row["error"] is not None:
        row["error"] = row["error"].replace(forced, "forced")
    if "triage" in row:
        t = dict(row["triage"], repro=None)
        t["first_events"] = [
            dict(ev, detail=dict(ev["detail"], Error=ev["detail"]["Error"].replace(
                forced, "forced"))) if ev["Type"] == "SoakSeedFailed" else ev
            for ev in t["first_events"]]
        row["triage"] = t
    return row


@pytest.mark.parametrize("forced", [None, 3001])
def test_soak_campaign_equals_the_reference_campaign(tmp_path, monkeypatch, forced):
    """The same spec and seeds through the reference's campaign (its
    workers on JAX's CPU, the forced seed through its environment switch)
    and the port's (device="cpu", force_fail_seed=): the verdicts, every
    seed's metrics, error and triage, the per-seed and merged census and
    the missing required sites are equal."""
    spec = _write_spec(tmp_path)
    seeds = [3000, 3001, 3002]
    if forced is None:
        monkeypatch.delenv("FDBTPU_SOAK_FORCE_FAIL", raising=False)
    else:
        monkeypatch.setenv("FDBTPU_SOAK_FORCE_FAIL", str(forced))
    ref = jsoak.run_campaign(str(spec), seeds, str(tmp_path / "ref"), jobs=3,
                             seed_deadline=240.0)
    monkeypatch.delenv("FDBTPU_SOAK_FORCE_FAIL", raising=False)
    port = soak.run_campaign(str(spec), seeds, str(tmp_path / "port"), jobs=3,
                             seed_deadline=240.0, device="cpu",
                             force_fail_seed=forced)
    assert port["verdicts"] == ref["verdicts"]
    assert port["verdicts"]["fail"] == (0 if forced is None else 1)
    assert port["ok"] == ref["ok"] == (forced is None)
    assert port["coverage"] == ref["coverage"]
    assert [r["seed"] for r in port["per_seed"]] == seeds
    assert ([_normalised(r, "(force_fail_seed)") for r in port["per_seed"]]
            == [_normalised(r, "(FDBTPU_SOAK_FORCE_FAIL)") for r in ref["per_seed"]])


def test_soak_repro_command_reruns_the_failing_seed(tmp_path):
    """The triage's repro line is a working command: run from another
    directory, it reruns exactly that seed and the failure reproduces."""
    spec = _write_spec(tmp_path)
    cmd = soak.repro_command(str(spec), 3001, "cpu", force_fail_seed=3001).split()
    assert cmd[:3] == ["python", "-m", "foundationdb_tpu_torch.tools.soak"]
    cmd[0] = sys.executable
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run(cmd, cwd=str(tmp_path), env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 1, p.stdout + p.stderr
    rep = json.loads((tmp_path / "repro-3001" / "campaign.json").read_text())
    assert rep["per_seed"][0]["seed"] == 3001
    assert rep["per_seed"][0]["verdict"] == "fail"
    assert rep["per_seed"][0]["triage"]["first_events"]


def test_soak_timeout_verdict_and_triage(tmp_path):
    """A seed past its wall deadline is killed and recorded as timeout,
    with a triage block from what its trace files held."""
    spec = tmp_path / "Long.txt"
    spec.write_text("testTitle=LongRun\n\n"
                    "testName=Cycle\nnodes=8\nclients=2\ntxnsPerClient=100000\n")
    report = soak.run_campaign(str(spec), [3000], str(tmp_path / "out"), jobs=1,
                               seed_deadline=3.0, device="cpu")
    assert report["verdicts"]["timeout"] == 1
    r = report["per_seed"][0]
    assert r["verdict"] == "timeout" and "deadline" in r["error"]
    assert "--device cpu" in r["triage"]["repro"]


def test_campaign_on_the_card_raises_without_one(monkeypatch, tmp_path):
    spec = _write_spec(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soak.run_campaign(str(spec), [3000], str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soak.main([str(spec), "--seeds", "1", "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out" / "seed-3000").exists()
