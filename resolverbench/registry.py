"""Finds what a cell is made of by the names in BENCHMARK.json: the
configuration's file, the traffic mix (`workloads/<traffic>.json`), the
generator it names (`traffic/<generator>.py`) and one reader a metric
(`metrics/<metric>.py`).  Adding a configuration, a mix or a metric is
adding files and entries; nothing here changes.

A generator module holds a class `Generator(config, traffic, seed)` with
`max_key_bytes`, the MVCC `window` and the versions a batch (`step`),
`version(i)`, and three duties the harness calls on it:
  batch(i, write_only)  batch i as a dict with at least `version`,
                        `oldest` and the read versions `snaps`;
  pack(b, width)        batch b as resolve_arrays' eight arrays, in the
                        layout of layout.py (`pack` for point keys,
                        `pack_ranges` for key ranges);
  reference(last, write_only_below, **guarantees)
                        the plain reference's verdicts of batches 0..last
                        in order (reference.py's `Reference` for point
                        keys, `RangeReference` for ranges), the guarantees
                        (`intra`, `history`, `too_old`) for the controls.
So a cell whose transactions carry another kind of key or range adds its
generator; the harness, the comparison and the controls stay as they
are."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Registry:
    def __init__(self, root: Path = ROOT, bench_dir: Path = HERE) -> None:
        self.root = Path(root)
        self.bench_dir = Path(bench_dir)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench_dir / "workloads" / f"{name}.json").read_text())

    def generator(self, name: str):
        return _load(self.bench_dir / "traffic" / f"{name}.py")

    def reader(self, metric: str):
        return _load(self.bench_dir / "metrics" / f"{metric}.py").read

    def metrics(self, cell: str, kind: str) -> list[dict]:
        """The cell's `end_to_end` or `per_layer` metrics."""
        return [m for m in self.doc[kind] if cell in m.get("workloads", [cell])]


def _load(path: Path):
    if not path.is_file():
        raise FileNotFoundError(path)
    name = "resolverbench_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
