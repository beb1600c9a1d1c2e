"""The reduction of the conflict set's `cs.*` spans (resolverbench/spans.py):
a synthetic trace, where each device event is owned through its
correlation by the innermost span around its launch, idle time goes to the
innermost span open over it, and self time is the duration less the child
spans; and one tiny cell traced on the CPU through the harness, whose
spans and counters the reduction reads."""

import pytest
import torch

from resolverbench import spans
from resolverbench.tests.conftest import small_tree, TINY


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 2, corr=corr)


def _kernel(ts, dur, corr):
    return _x("kernel", "k", ts, dur, tid=7, corr=corr)


SYNTHETIC = [
    _x("user_annotation", "rb.dispatch", 0, 400),
    _x("user_annotation", "cs.resolve", 10, 300),
    _x("user_annotation", "cs.stage", 12, 20),
    _launch(14, 1),
    _x("user_annotation", "cs.search", 40, 40),
    _launch(45, 2), _launch(50, 3),
    _x("user_annotation", "cs.compact", 100, 150),
    _launch(105, 4),
    _x("user_annotation", "cs.compact.fold", 120, 100),
    _launch(125, 5),
    _x("user_annotation", "cs.read.fold_count", 200, 20),
    _launch(201, 6),
    _launch(260, 7),                  # in cs.resolve, outside its children
    _x("user_annotation", "cs.read.verdicts", 280, 25),
    _launch(350, 8),                  # in no cs span
    _kernel(20, 10, 1),               # cs.stage
    _kernel(60, 30, 2), _kernel(90, 5, 3),   # cs.search
    _kernel(110, 40, 4),              # cs.compact
    _kernel(150, 50, 5),              # cs.compact.fold
    _x("gpu_memcpy", "Memcpy DtoH", 215, 4, tid=7, corr=6),  # cs.read.fold_count
    _kernel(265, 10, 7),              # cs.resolve
    _kernel(360, 20, 8),              # nobody's
    _kernel(380, 5, 99),              # no launch in the trace
]


def test_a_synthetic_trace_reduces_by_innermost_span():
    red = spans.reduce(SYNTHETIC)
    t = red["spans"]
    assert set(t) == {"cs.resolve", "cs.stage", "cs.search", "cs.compact",
                      "cs.compact.fold", "cs.read.fold_count", "cs.read.verdicts"}
    us = pytest.approx

    def row(name):
        return {k: (v * 1e6 if k != "count" else v) for k, v in t[name].items()}

    # device time by correlation, to the innermost span around the launch
    assert row("cs.stage")["device_s"] == us(10)
    assert row("cs.search")["device_s"] == us(35)
    assert row("cs.compact")["device_s"] == us(40)
    assert row("cs.compact")["device_incl_s"] == us(40 + 50 + 4)
    assert row("cs.compact.fold")["device_incl_s"] == us(54)
    assert row("cs.read.fold_count")["device_s"] == us(4)
    assert row("cs.resolve")["device_s"] == us(10)
    assert row("cs.resolve")["device_incl_s"] == us(10 + 35 + 94 + 10)
    assert red["device_s"] * 1e6 == us(10 + 35 + 94 + 10 + 20 + 5)
    assert red["owned_s"] * 1e6 == us(149)
    # self time: less the direct children
    assert row("cs.resolve")["self_s"] == us(300 - 20 - 40 - 150 - 25)
    assert row("cs.compact")["self_s"] == us(50)
    assert row("cs.compact.fold")["self_s"] == us(80)
    # idle over [0, 400): the device is busy [20, 30), [60, 95), [110, 200),
    # [215, 219), [265, 275), [360, 385)
    assert red["window_s"] * 1e6 == us(400)
    assert red["idle_s"] * 1e6 == us(400 - 10 - 35 - 90 - 4 - 10 - 25)
    assert row("cs.resolve")["idle_s"] == us(2 + 8 + 5 + 15 + 5 + 5)
    assert row("cs.stage")["idle_s"] == us(8 + 2)
    assert row("cs.search")["idle_s"] == us(20)
    assert row("cs.compact")["idle_s"] == us(10 + 30)
    assert row("cs.compact.fold")["idle_s"] == us(0)
    assert row("cs.read.fold_count")["idle_s"] == us(15 + 1)
    assert row("cs.read.verdicts")["idle_s"] == us(25)
    assert row("cs.resolve")["idle_incl_s"] == us(40 + 10 + 20 + 40 + 16 + 25)
    # the dispatch's enqueue: cs.resolve less cs.compact and its reads
    assert red["enqueue_s"] * 1e6 == us(300 - 150 - 25)
    n = spans.layer_numbers(red, {"host_wait_s": 0.02, "compact_bytes": 3.35e9,
                                  "compact_s": 0.5}, 1, 4)
    assert n["dispatch.enqueue_ms"] == us(0.125)
    assert n["dispatch.idle_ms"] == us((40 + 10 + 20 + 40) * 1e-3)
    assert n["check.search_ms"] == us(0.035)
    assert n["compaction.device_ms"] == us(0.094)
    assert n["check.host_wait_ms"] == us(5)
    assert n["compaction.roofline_pct"] == us(100 * 1e-3 / 0.5)
    assert "check.conflict_ms" not in n and "check.append_ms" not in n


def test_a_trace_without_cs_spans_reduces_to_nothing():
    assert spans.reduce([e for e in SYNTHETIC if not e["name"].startswith("cs.")]) is None
    assert spans.layer_numbers(None, {"compact_s": 1.0}, 10, 10) == {}


@pytest.mark.parametrize("cell", ["rw16.b8k", "ycsb_f.zipf099.b8k"])
def test_a_tiny_cell_traced_on_the_cpu(cell, tmp_path):
    reg = small_tree(tmp_path, TINY)
    out = spans.traced_cell(reg, cell, 2**31 + 11, 1.0, device="cpu")
    line = spans.report(reg, cell, out)
    assert line["correct"] and line["traced_batches"] == TINY["traffic.loop"]["trace_batches"]
    t = line["spans"]
    batches = line["traced_batches"]
    assert t["cs.resolve"]["count"] >= batches
    for name in ("cs.stage", "cs.search", "cs.check", "cs.append"):
        assert t[name]["count"] >= batches, name
    assert t["cs.gc"]["count"] >= batches  # a recovery replays its GC calls
    assert t["cs.read.verdicts"]["count"] >= batches
    c = line["counters"]
    reads = sum(v for k, v in c.items() if k.startswith("host_reads."))
    assert reads == c["host_syncs"] > 0
    assert c["compact_bytes"] > 0 and c["host_wait_s"] > 0
    n = line["layer_numbers"]
    assert {"dispatch.enqueue_ms", "dispatch.idle_ms", "check.search_ms",
            "check.conflict_ms", "check.append_ms", "check.host_wait_ms",
            "compaction.roofline_pct"} <= set(n)
    assert n["check.search_ms"] == 0  # no device events on the CPU
    assert 0 < n["dispatch.enqueue_ms"]
    assert torch.get_num_threads() == 1
