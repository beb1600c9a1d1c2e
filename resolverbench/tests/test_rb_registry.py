"""The harness finds a cell's parts by name: a configuration, a traffic mix
or a metric added as files (and entries) needs no edit of a file that is
there.  And BENCHMARK.json keeps to its contract."""

import json
import re
import shutil
from pathlib import Path

import pytest

from resolverbench.harness import run_cell
from resolverbench.registry import ROOT, Registry
from resolverbench.tests.conftest import TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_in_benchmark_json_resolves():
    reg = Registry()
    for w in reg.doc["workloads"]:
        config, traffic = reg.config(w["config"]), reg.traffic(w["traffic"])
        entry = next(c for c in reg.doc["configs"] if c["name"] == w["config"])
        assert config["name"] == w["config"] and config["reduced"] == entry["reduced"]
        assert set(config["why_reduced"]) == set(entry["reduced"])
        assert hasattr(reg.generator(traffic["generator"]), "Generator")
    for kind in ("end_to_end", "per_layer"):
        for m in reg.doc[kind]:
            assert callable(reg.reader(m["name"]))


def test_benchmark_json_keeps_to_its_contract():
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(doc) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert doc["paths"] == ["resolverbench"] and 1 <= doc["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in doc[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("resolverbench/") and (ROOT / c["file"]).is_file()
    cells = {w["name"] for w in doc["workloads"]}
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in doc["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in doc["end_to_end"]}
    e2e = {m["name"] for m in doc["end_to_end"]}
    for m in doc["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    assert len(json.dumps(doc)) < 64 * 1024


def test_files_added_in_a_new_tree_are_found_by_name(tmp_path: Path):
    bench = tmp_path / "rb"
    for part in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(ROOT / "resolverbench" / part, bench / part)
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / doc["configs"][0]["file"]).read_text())
    config["name"] = "fdb_rw16_small_pool"
    config["key_count"] = 200
    config["mvcc"] = TINY["config.mvcc"]
    (bench / "configs" / "fdb_rw16_small_pool.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "workloads" / "rw16.b8k.json").read_text())
    traffic["traffic"]["batch_txns"] = 48
    traffic["loop"] = TINY["traffic.loop"]
    (bench / "workloads" / "rw16.b48.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "window_batches.py").write_text(
        "def read(run):\n    return float(len(run.window))\n")
    doc["configs"].append(dict(doc["configs"][0], name="fdb_rw16_small_pool",
                               file="rb/configs/fdb_rw16_small_pool.json"))
    doc["workloads"].append(dict(doc["workloads"][0], name="rw16.b48",
                                 config="fdb_rw16_small_pool", traffic="rw16.b48"))
    doc["per_layer"].append(dict(doc["per_layer"][0], name="window_batches", unit="batches",
                                 workloads=["rw16.b48"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    reg = Registry(root=tmp_path, bench_dir=bench)
    assert [m["name"] for m in reg.metrics("rw16.b48", "per_layer")] == ["window_batches"]
    out = run_cell(reg, "rw16.b48", 4, 0.3, False, device="cpu")
    assert out["result"]["correct"]
    assert out["run"].window[0].txns == 48
    assert reg.reader("window_batches")(out["run"]) == len(out["run"].window)


def test_an_unknown_name_is_an_error():
    reg = Registry()
    with pytest.raises(KeyError):
        reg.cell("no_such_cell")
    with pytest.raises(FileNotFoundError):
        reg.reader("no_such_metric")
