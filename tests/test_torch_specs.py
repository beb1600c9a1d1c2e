"""The simulation-spec corpus on the port (foundationdb_tpu_torch/
workloads/spec.py): every tests/specs/*.txt through the port's
`run_spec_file(path, device="cpu")` and the reference's, same seed.  The
workload metrics, the end virtual time and the census that teardown emits
as `CodeCoverage` trace events (the buggify and testcov halves, less the
device set's own `kernel.*` sites) must be identical.

A spec's `backend=oracle` (the default) runs the port's OracleConflictSet,
so the run is the reference's simulation.  DeviceFaultSwizzle names
`backend=supervised`: the port's supervised DeviceConflictSet on the CPU
against the reference's JAX set, under swizzle, attrition and forced
`device.*` faults.  `run_spec_compared` serves tests/test_torch_specs_heavy.py
and tests/test_torch_spec_pairs.py too."""

import gc
import io
import json
import pathlib

import pytest

from foundationdb_tpu.runtime import buggify as jbuggify
from foundationdb_tpu.workloads import spec as jspec
from foundationdb_tpu_torch.runtime import buggify
from foundationdb_tpu_torch.workloads import spec
from tests.torch_threads import one_torch_thread  # noqa: F401

SPEC_DIR = pathlib.Path(__file__).parent / "specs"
SPECS = sorted(SPEC_DIR.glob("*.txt"))
# the slowest specs run in tests/test_torch_specs_heavy.py
HEAVY = ("DeviceFaultSwizzle", "HotShardSplit", "LowSpace")


@pytest.fixture(autouse=True)
def _buggify_off():
    yield
    jbuggify.disable()
    buggify.disable()


def traced(run, *args, **kw) -> tuple:
    """`run(*args, trace_sink=..., **kw)` with the collector off (after a
    collection) -> (its metrics, the census of its CodeCoverage events
    less `kernel.*`, the virtual time of its last event)."""
    sink = io.StringIO()
    gc.collect()
    gc.disable()
    try:
        metrics = run(*args, trace_sink=sink, **kw)
    finally:
        gc.enable()
        jbuggify.disable()
        buggify.disable()
    events = [json.loads(line) for line in sink.getvalue().splitlines()]
    census = sorted((e["Name"], e["Kind"], e["Hits"], e["Armed"]) for e in events
                    if e["Type"] == "CodeCoverage" and not e["Name"].startswith("kernel."))
    return metrics, census, max(e["Time"] for e in events)


def run_spec_compared(path: str) -> dict:
    """One spec file through both packages; returns the port's metrics."""
    got = traced(spec.run_spec_file, path, device="cpu")
    want = traced(jspec.run_spec_file, path)
    for part, g, w in zip(("metrics", "census", "end time"), got, want):
        assert g == w, f"{path}: {part} differs"
    assert got[2] > 0
    return got[0]


def test_corpus_is_the_fifteen_specs():
    assert len(SPECS) == 15
    assert set(HEAVY) < {p.stem for p in SPECS}


@pytest.mark.parametrize("path", [p for p in SPECS if p.stem not in HEAVY],
                         ids=lambda p: p.stem)
def test_spec_file_matches_the_reference(path):
    assert run_spec_compared(str(path))["testTitle"]


def test_parse_rejects_unknowns_as_the_reference():
    for text, match in (("testName=NoSuchWorkload\n", "unknown workload"),
                        ("bogus=1\ntestName=Cycle\n", "unknown cluster key"),
                        ("seed=1\n", "no testName"),
                        ("chaos=maybe\ntestName=Cycle\n", "expected true/false")):
        for m in (spec, jspec):
            with pytest.raises(ValueError, match=match):
                m.parse_spec(text)


def test_parse_spec_equals_the_reference_on_the_corpus():
    """Every spec and restarting half parses to the reference's (title,
    cluster keywords, stanzas), knob lines and camelCase mapping too."""
    paths = SPECS + sorted((SPEC_DIR / "restarting").glob("*.txt"))
    for p in paths:
        text = p.read_text()
        assert spec.parse_spec(text) == jspec.parse_spec(text), p.name
    text = "seed=5\nknob.PAGE_CACHE_BYTES=8192\ntestName=Cycle\ntxnsPerClient=7\n"
    assert spec.parse_spec(text) == (
        "untitled", {"seed": 5, "knob_overrides": {"PAGE_CACHE_BYTES": "8192"}},
        [("Cycle", {"txns_per_client": 7})])


def test_workload_factory_has_the_reference_names():
    assert sorted(spec.WORKLOAD_FACTORY) == sorted(jspec.WORKLOAD_FACTORY)
    assert len(spec.WORKLOAD_FACTORY) == 21
    for name, cls in spec.WORKLOAD_FACTORY.items():
        assert cls.__module__.startswith("foundationdb_tpu_torch.workloads."), name
        assert cls.__name__ == jspec.WORKLOAD_FACTORY[name].__name__
