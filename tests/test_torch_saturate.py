"""The saturation harness (foundationdb_tpu_torch/tools/saturate.py)
against the reference's on the CPU: both modes on a tiny ladder (two
steps of 1 virtual s, a few hundred keys, seed 11), the port's clusters on
their default backend (each resolver the port's DeviceConflictSet on
"cpu"), the reference's on its oracle.  The conflict sets' verdicts are
the same, so every curve must be the reference's field for field: the
cold and warm scans' preads and page-cache counters, and each step's
offered and achieved tps, virtual-time latencies, latency bands,
ratekeeper reason and budget, data-distribution counters and page-cache
deltas; the knees too.  The port's entry points default to the card and
raise without one."""

import gc

import pytest
import torch

from foundationdb_tpu.runtime import buggify as jbuggify
from foundationdb_tpu.tools import saturate as jsat
from foundationdb_tpu_torch.runtime import buggify
from foundationdb_tpu_torch.tools import saturate as tsat
from tests.torch_threads import one_torch_thread  # noqa: F401

STEPS = [20.0, 40.0]
LADDER = dict(step_duration=1.0, keys=300, seed=11)


@pytest.fixture(autouse=True)
def _buggify_off():
    yield
    jbuggify.disable()
    buggify.disable()


def _both(run, *args, **kw):
    """`run` of each package with the same arguments, the collector off
    (a collected transaction frees snapshot-cache bytes at a random
    moment otherwise)."""
    out = {}
    for name, extra in (("ref", {}), ("port", {"device": "cpu"})):
        gc.collect()
        gc.disable()
        try:
            out[name] = run[name](*args, **kw, **extra)
        finally:
            gc.enable()
    return out


@pytest.mark.parametrize("cache_on", [True, False])
def test_cache_curve_equals_the_reference(cache_on):
    got = _both({"ref": jsat.run_curve, "port": tsat.run_curve},
                cache_on, STEPS, **LADDER)
    assert got["port"] == got["ref"]
    curve = got["port"]
    assert [s["offered_tps"] for s in curve["steps"]] == STEPS
    assert all(s["committed"] > 0 for s in curve["steps"])
    assert curve["cold_scan"]["rows"] == LADDER["keys"]


@pytest.mark.parametrize("dd_on", [False, True])
def test_hot_curve_equals_the_reference(dd_on):
    got = _both({"ref": jsat.run_hot_curve, "port": tsat.run_hot_curve},
                dd_on, STEPS, **LADDER, skew=1.2)
    assert got["port"] == got["ref"]
    assert got["port"]["dd"] == ("on" if dd_on else "frozen")
    assert all(s["committed"] > 0 for s in got["port"]["steps"])


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without a card, run_curve, run_hot_curve and main raise before any
    step runs (the cluster's own check: no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tsat.run_curve(True, STEPS, **LADDER)
    with pytest.raises(RuntimeError):
        tsat.run_hot_curve(True, STEPS, **LADDER, skew=1.2)
    with pytest.raises(RuntimeError):
        tsat.main(["--steps", "20", "--keys", "50", "--out", str(tmp_path / "s.json")])
    assert not (tmp_path / "s.json").exists()
