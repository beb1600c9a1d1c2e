"""A cell whose transactions carry key ranges, added to a copy of the
benchmark as new files and entries only (a generator under `traffic/`, a
configuration, a traffic mix, the cell), runs correct on the CPU through
the unmodified harness, and the controls catch a broken reference there."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from resolverbench.control import run_control
from resolverbench.harness import load_cell, run_cell
from resolverbench.reference import CONFLICT
from resolverbench.registry import ROOT, Registry
from resolverbench.tests.conftest import small_tree

HARNESS = ("harness.py", "layout.py", "reference.py", "control.py", "registry.py", "run.py")
CELL = "ranges.b64"
CONFIG = {
    "name": "tiny_ranges",
    "max_key_bytes": 16,
    "key_count": 400,
    "keys": {"bytes": [1, 15]},
    "txn": {"reads": [0, 3], "read_span": [1, 40], "writes": [0, 2], "write_span": [0, 2]},
    "mvcc": {"window_versions": 400, "version_step": 10},
    "reduced": [],
}
TRAFFIC = {
    "generator": "range_txns",
    "traffic": {"batch_txns": 64, "snapshot_lag_batches": [1, 4], "too_old_share": 0.05},
    "loop": {"warmup_batches": 9, "trace_batches": 10},
}


@pytest.fixture
def range_tree(tmp_path: Path) -> Registry:
    """The copy, with the range cell's files and entries added."""
    reg = small_tree(tmp_path)
    bench = tmp_path / "resolverbench"
    before = sorted(p.relative_to(bench) for p in bench.rglob("*") if p.is_file())
    shutil.copy(Path(__file__).with_name("range_txns.py"), bench / "traffic")
    (bench / "configs" / "tiny_ranges.json").write_text(json.dumps(CONFIG))
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps(TRAFFIC))
    doc = reg.doc
    doc["configs"].append({"name": "tiny_ranges", "source": "resolverbench/tests/range_txns.py",
                           "file": "resolverbench/configs/tiny_ranges.json", "reduced": [],
                           "why": "ragged range reads and range or point writes"})
    doc["workloads"].append({"name": CELL, "config": "tiny_ranges", "traffic": CELL,
                             "chips": 1, "why": "overlaps that are not key equality"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    after = sorted(p.relative_to(bench) for p in bench.rglob("*") if p.is_file())
    assert set(before) <= set(after) and len(after) == len(before) + 3
    for name in HARNESS:
        assert (bench / name).read_bytes() == (ROOT / "resolverbench" / name).read_bytes()
    return Registry(tmp_path, bench)


def _conflicts_without_an_equal_key(gen, last: int, live: int) -> tuple[int, int]:
    """The reference's CONFLICTs, and those of them that no write with a
    begin key equal to one of the transaction's read begins explains: the
    conflicts that only an overlap of different keys gives."""
    newest: dict[int, int] = {}  # write begin key id -> last committed version
    conflicts = only_ranges = 0
    for i, verdicts in enumerate(gen.reference(last, live)):
        b = gen.batch(i, i < live)
        in_batch: set[int] = set()
        for t, v in enumerate(verdicts.tolist()):
            reads = b["r_begin"][b["r_tx"] == t].tolist()
            if v == CONFLICT:
                conflicts += 1
                snap = int(b["snaps"][t])
                only_ranges += not any(newest.get(k, -1) > snap or k in in_batch for k in reads)
            elif v == 2:
                in_batch.update(b["w_begin"][b["w_tx"] == t].tolist())
        newest.update(dict.fromkeys(in_batch, b["version"]))
    return conflicts, only_ranges


def test_a_range_cell_added_as_new_files_runs_correct(range_tree):
    out = run_cell(range_tree, CELL, 2**31 + 41, 1.0, False, device="cpu")
    assert out["checks"]["mismatched_verdicts"]["value"] == 0
    assert out["checks"]["unanswered_batches"]["value"] == 0
    assert out["result"]["correct"] and out["result"]["failed"] == 0
    run = out["run"]
    assert run.window and run.counters["compactions"] > 0
    config, traffic = load_cell(range_tree, CELL)
    gen = range_tree.generator("range_txns").Generator(config, traffic["traffic"], 2**31 + 41)
    live = gen.window // gen.step
    conflicts, only_ranges = _conflicts_without_an_equal_key(gen, live + 20, live)
    assert conflicts > 0 and only_ranges > conflicts // 4
    assert np.array_equal(run.window[0].verdicts,
                          list(gen.reference(run.window[0].index, live))[-1])


@pytest.mark.parametrize("control", ["no_history", "no_intra", "no_too_old"])
def test_the_controls_are_not_correct_on_the_range_cell(control, range_tree):
    for seed in (1, 2**31 + 43):
        out = run_control(range_tree, CELL, seed, 16, control)
        assert not out["correct"]
        assert out["checks"]["mismatched_verdicts"]["value"] > 0
