"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the program."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from resolverbench.harness import FORBIDDEN

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
PROGRAM = "foundationdb_tpu_torch"


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py") if "tests" not in p.parts))
def test_no_benchmark_file_imports_jax_or_the_jax_package(path):
    assert not _imports(BENCH / path) & set(FORBIDDEN)


# Every traffic generator is yardstick: it names the reference that decides
# `correct`.  So is the range generator the tests write into a tree's traffic/.
GENERATORS = sorted(p.relative_to(BENCH).as_posix() for p in BENCH.glob("traffic/*.py")) + [
    "tests/range_txns.py"]
READERS = sorted(p.relative_to(BENCH).as_posix() for p in BENCH.glob("metrics/*.py"))


@pytest.mark.parametrize("path", ["reference.py", "layout.py", "trace.py", "registry.py",
                                  "control.py"] + GENERATORS + READERS)
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert PROGRAM not in _imports(BENCH / path)


@pytest.mark.parametrize("path", GENERATORS)
def test_loading_a_generator_loads_nothing_of_the_program(path):
    """What a generator imports by way of another module shows only when it is
    loaded: load it as the registry does and look at sys.modules."""
    code = ("import json, pathlib, sys\n"
            "from resolverbench.registry import _load\n"
            f"_load(pathlib.Path({str(BENCH / path)!r}))\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = set(_run(code))
    assert PROGRAM not in tops and not tops & set(FORBIDDEN)


def _run(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_on_the_cpu_loads_no_forbidden_module(tmp_path):
    code = (
        "import json, pathlib, sys\n"
        "from resolverbench.harness import run_cell, forbidden_modules\n"
        "from resolverbench.tests.conftest import small_tree\n"
        f"reg = small_tree(pathlib.Path({str(tmp_path)!r}))\n"
        "out = run_cell(reg, 'ycsb_f.zipf099.b8k', 3, 0.3, True, device='cpu')\n"
        "for kind in ('end_to_end', 'per_layer'):\n"
        "    for m in reg.metrics('ycsb_f.zipf099.b8k', kind):\n"
        "        reg.reader(m['name'])(out['run'])\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps(dict(forbidden=forbidden_modules(), tops=tops,\n"
        "                      correct=out['result']['correct'])))\n")
    got = _run(code)
    assert got["correct"] and got["forbidden"] == []
    assert PROGRAM in got["tops"]


def test_the_reference_and_the_control_load_nothing_of_the_program():
    code = ("import json, sys\n"
            "import resolverbench.control, resolverbench.reference\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PROGRAM not in tops and not tops & set(FORBIDDEN)


def test_without_a_card_the_run_exits_non_zero_and_prints_nothing():
    out = subprocess.run([sys.executable, "-m", "resolverbench.run", "--workload", "rw16.b8k",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
