"""On the card: one short run of a cell through the command, traced, and
the command in a tree that holds only the benchmark, which must fail."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from resolverbench.registry import ROOT

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _command(cwd, *args):
    return subprocess.run([sys.executable, "-m", "resolverbench.run", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=900,
                          env=dict(os.environ, USE_FLAX="0"))


@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_short_run_is_correct_on_the_card(card, trace):
    out = _command(ROOT, "--workload", "rw16.b8k", "--seed", "2147483999",
                   "--seconds", "2", "--trace", trace)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace == "1" else "end_to_end"
    assert set(line["metrics"]) == {m["name"] for m in doc[kind]}
    if trace == "1":
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"] and line["breakdown"]["idle_gaps"]


def test_a_tree_of_the_benchmark_alone_gives_no_result(card, tmp_path: Path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "resolverbench", tmp_path / "resolverbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path, "--workload", "rw16.b8k", "--seed", "1", "--seconds", "1",
                   "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
