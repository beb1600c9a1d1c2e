"""Settings of the benchmark's own tests (run them from the repository's
root: `python -m pytest resolverbench/tests`).  The tests that need a CUDA
card carry the `gpu` marker and skip without one; on the card:
`python -m pytest resolverbench/tests -m gpu`."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from resolverbench.registry import ROOT, Registry

# the cells at a size the CPU holds: a 40-batch MVCC window of 64-txn
# batches; each key names a part of a configuration or a traffic mix file
# ("config.<key>...", "traffic.<key>...") and entries to update there
TINY = {
    "config": {"key_count": 300},
    "config.mvcc": {"window_versions": 400, "version_step": 10},
    "traffic.traffic": {"batch_txns": 64, "too_old_share": 0.05},
    "traffic.loop": {"warmup_batches": 9, "trace_batches": 10},
}
# YCSB keys share their first bytes: past ~1024 boundaries in one 16-bit
# bucket the set's bucketed search does not converge, and the harness
# recovers every pipelined window
DEEP_BUCKET = dict(TINY, **{"config": {"key_count": 20000},
                            "traffic.traffic": {"batch_txns": 128, "too_old_share": 0.05}})


def small_tree(root: Path, sizes: dict = TINY) -> Registry:
    """BENCHMARK.json and the benchmark's files copied under `root`, every
    configuration and traffic mix rewritten at `sizes`; the registry of
    that tree."""
    bench = root / "resolverbench"
    shutil.copytree(ROOT / "resolverbench", bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    reg = Registry(root, bench)
    files = [(root / c["file"], "config") for c in reg.doc["configs"]]
    files += [(bench / "workloads" / f"{w['traffic']}.json", "traffic")
              for w in reg.doc["workloads"]]
    for path, part in files:
        data = json.loads(path.read_text())
        for key, values in sizes.items():
            head, *keys = key.split(".")
            if head == part:
                target = data
                for k in keys:
                    target = target[k]
                target.update(values)
        path.write_text(json.dumps(data))
    return reg


@pytest.fixture
def tiny(tmp_path) -> Registry:
    return small_tree(tmp_path, TINY)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one "
        "(on the card: python -m pytest resolverbench/tests -m gpu)")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
