"""The reduction of a profiler trace to the conflict set's own spans, the
`cs.*` spans of `foundationdb_tpu_torch/conflict/api.py::span`.

For each span name: how many, their host time, their self time (duration
less the `cs.*` spans nested directly in them), the device time of the
kernels, copies and sets launched while the span was the innermost `cs.*`
span on the launching thread (`device_s`), the same with every span nested
in it (`device_incl_s`), and the device's idle time while the span was the
innermost `cs.*` span open on the host (`idle_s`, and `idle_incl_s`).

A device event is tied to the runtime call that enqueued it by the
profiler's `args.correlation`.  Idle time is the part of the traced window
(the extent of the harness's `rb.*` spans) that the union of the device's
intervals leaves, cut where a `cs.*` span starts or ends, each piece put
down to the innermost span open over it.

    python3 -m resolverbench.spans --workload rw16.b8k --seed 7 --seconds 51

runs one cell as `resolverbench.run --trace 1` does and prints one JSON
line: the result, the per-layer metrics the benchmark reads, the span table,
the layer numbers the spans and the set's counters give
(`layer_numbers`), and the set's host reads by site.  A program without
the spans or counters gives an empty table and leaves those numbers out.

`reduce` and `layer_numbers` are the part for the benchmark's readers.
`traced_cell`, `report`, `main` and `_stats_counters` are a side runner:
they wrap `trace.load_events` and `harness.counters` because the harness
hands its readers neither the events nor these counters.  They go once the
harness does.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

import numpy as np  # noqa: E402

from . import harness, trace  # noqa: E402

PREFIX = "cs."
READ = "cs.read"
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's HBM3, NVIDIA's data sheet


def is_read(name: str) -> bool:
    return name == READ or name.startswith(READ + ".")


class _Spans:
    """The `cs.*` spans of a trace as one forest per host thread: sorted by
    start, each with its parent (the innermost span around it)."""

    def __init__(self, events: list[dict]) -> None:
        spans = [e for e in events if e.get("cat", "").lower() == "user_annotation"
                 and e["name"].startswith(PREFIX)]
        spans.sort(key=lambda e: (e.get("pid"), e.get("tid"), e["ts"], -e["dur"]))
        self.name = [e["name"] for e in spans]
        self.start = np.array([e["ts"] for e in spans], dtype=np.float64)
        self.end = np.array([e["ts"] + e["dur"] for e in spans], dtype=np.float64)
        self.parent = np.full(len(spans), -1, dtype=np.int64)
        self.threads: dict = {}  # (pid, tid) -> index range
        stack: list[int] = []
        for i, e in enumerate(spans):
            key = (e.get("pid"), e.get("tid"))
            if key not in self.threads:
                self.threads[key] = [i, i]
                stack = []
            self.threads[key][1] = i + 1
            while stack and self.end[stack[-1]] <= self.start[i]:
                stack.pop()
            if stack:
                self.parent[i] = stack[-1]
            stack.append(i)

    def __len__(self) -> int:
        return len(self.name)

    def innermost(self, key, t: float) -> int:
        """The innermost span open at `t` on thread `key`, or -1."""
        if key not in self.threads:
            return -1
        lo, hi = self.threads[key]
        i = lo + int(np.searchsorted(self.start[lo:hi], t, side="right")) - 1
        while i >= lo and self.end[i] <= t:
            i = int(self.parent[i])
        return i if i >= lo else -1

    def innermost_any(self, t: float) -> int:
        """The innermost span open at `t` on any thread: of the threads'
        innermost spans, the one that started last."""
        best = -1
        for key in self.threads:
            i = self.innermost(key, t)
            if i >= 0 and (best < 0 or self.start[i] > self.start[best]):
                best = i
        return best

    def outermost_of_name(self, i: int) -> bool:
        """No span around span i has its name."""
        p = int(self.parent[i])
        while p >= 0:
            if self.name[p] == self.name[i]:
                return False
            p = int(self.parent[p])
        return True


def reduce(events: list[dict]) -> dict | None:
    """The span table of a trace, with the window's device time, the part
    of it the spans own, its idle time and the dispatch's enqueue time.
    None when the trace holds no `cs.*` span."""
    sp = _Spans(events)
    if not len(sp):
        return None
    n = len(sp)
    device = [e for e in events if e.get("cat", "").lower()
              in trace._KERNEL_CATS | trace._COPY_CATS | trace._SET_CATS]
    calls = {}
    for e in events:
        if e.get("cat", "").lower() in trace._RUNTIME_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                calls[corr] = ((e.get("pid"), e.get("tid")), e["ts"])
    owned = np.zeros(n)
    device_s = 0.0
    for e in device:
        dur = e["dur"] * 1e-6
        device_s += dur
        call = calls.get((e.get("args") or {}).get("correlation"))
        if call is not None:
            i = sp.innermost(*call)
            if i >= 0:
                owned[i] += dur

    # idle: the window's device gaps, cut at every span boundary
    rb = [e for e in events if e.get("cat", "").lower() == "user_annotation"
          and e["name"].startswith(trace.SPAN_PREFIX)]
    lo = min(e["ts"] for e in rb) if rb else float(sp.start.min())
    hi = max(e["ts"] + e["dur"] for e in rb) if rb else float(sp.end.max())
    iv = np.array([[e["ts"], e["ts"] + e["dur"]] for e in device], dtype=np.float64)
    merged = trace.union(trace.clip(iv.reshape(-1, 2), lo, hi))
    cuts = np.unique(np.concatenate([sp.start, sp.end]))
    idle = np.zeros(n)
    idle_total = 0.0
    for a, b in trace.gaps(merged, lo, hi):
        inner = cuts[np.searchsorted(cuts, a, "right"):np.searchsorted(cuts, b, "left")]
        edges = np.concatenate([[a], inner, [b]])
        for p, q in zip(edges[:-1].tolist(), edges[1:].tolist()):
            idle_total += (q - p) * 1e-6
            i = sp.innermost_any(0.5 * (p + q))
            if i >= 0:
                idle[i] += (q - p) * 1e-6

    # inclusive sums and self times: children follow their parents in the
    # sorted order, so a reverse pass sees every child before its parent
    dur = (sp.end - sp.start) * 1e-6
    owned_incl, idle_incl, child_s = owned.copy(), idle.copy(), np.zeros(n)
    for i in range(n - 1, -1, -1):
        p = int(sp.parent[i])
        if p >= 0:
            owned_incl[p] += owned_incl[i]
            idle_incl[p] += idle_incl[i]
            child_s[p] += dur[i]
    table: dict = defaultdict(lambda: dict(count=0, host_s=0.0, self_s=0.0, device_s=0.0,
                                           device_incl_s=0.0, idle_s=0.0, idle_incl_s=0.0))
    for i in range(n):
        row = table[sp.name[i]]
        row["count"] += 1
        row["host_s"] += dur[i]
        row["self_s"] += dur[i] - child_s[i]
        row["device_s"] += owned[i]
        row["idle_s"] += idle[i]
        if sp.outermost_of_name(i):
            row["device_incl_s"] += owned_incl[i]
            row["idle_incl_s"] += idle_incl[i]
    return dict(spans=dict(sorted(table.items())), device_s=device_s,
                owned_s=float(owned.sum()), idle_s=idle_total,
                window_s=(hi - lo) * 1e-6, enqueue_s=_enqueue_s(sp, dur))


def _enqueue_s(sp: _Spans, dur: np.ndarray) -> float:
    """Host time in the outermost `cs.resolve` spans less the `cs.compact`
    and `cs.read.*` spans inside them (each counted once, at the outermost
    of them)."""
    total = 0.0
    for i in range(len(sp)):
        top, p = -1, i
        while p >= 0:  # the outermost cs.resolve around (or at) span i
            if sp.name[p] == "cs.resolve":
                top = p
            p = int(sp.parent[p])
        if top < 0:
            continue
        if i == top:
            total += dur[i]
        elif sp.name[i] == "cs.compact" or is_read(sp.name[i]):
            p, nested = int(sp.parent[i]), False
            while p != top:
                nested |= sp.name[p] == "cs.compact" or is_read(sp.name[p])
                p = int(sp.parent[p])
            if not nested:
                total -= dur[i]
    return total


def layer_numbers(red: dict | None, counters: dict, batches: int, window: int) -> dict:
    """The layer numbers of a traced run: from the span table over the
    traced `batches` (ms a batch; the compaction's device ms a compaction),
    and from the set's counters over the measured `window`'s batches.  A
    number whose spans or counters the program lacks is left out."""
    out = {}
    if red is not None and batches:
        t = red["spans"]

        def per_batch(name, key="device_incl_s"):
            return 1e3 * t[name][key] / batches if name in t else None

        out["dispatch.enqueue_ms"] = 1e3 * red["enqueue_s"] / batches
        out["dispatch.idle_ms"] = 1e3 * sum(
            r["idle_s"] for k, r in t.items() if not is_read(k)) / batches
        out["check.search_ms"] = per_batch("cs.search")
        out["check.conflict_ms"] = per_batch("cs.check")
        out["check.append_ms"] = per_batch("cs.append")
        if "cs.compact" in t:
            c = t["cs.compact"]
            out["compaction.device_ms"] = 1e3 * c["device_incl_s"] / c["count"]
    if window and "host_wait_s" in counters:
        out["check.host_wait_ms"] = 1e3 * counters["host_wait_s"] / window
    if counters.get("compact_s") and "compact_bytes" in counters:
        out["compaction.roofline_pct"] = (100.0 * counters["compact_bytes"]
                                          / HBM_BYTES_PER_S / counters["compact_s"])
    return {k: v for k, v in out.items() if v is not None}


def _stats_counters(cs) -> dict:
    """The set's reads by site, their wait and the compactions' bytes, as
    scalars; empty where the set has none of them."""
    s = cs.stats
    if not hasattr(s, "host_reads"):
        return {}
    out = {f"host_reads.{k}": v for k, v in s.host_reads.items()}
    out.update(host_wait_s=s.host_wait_s, compact_bytes=s.compact_bytes)
    return out


def traced_cell(registry, workload: str, seed: int, seconds: float,
                device="cuda", t_start: float | None = None) -> dict:
    """One traced run of a cell (harness.run_cell), keeping the profiler's
    events ("events") and the set's reads by site, their wait and the
    compactions' bytes among the window's counters (the counters' own
    fixpoint read left out, as `harness.delta` leaves it out of
    `host_syncs`)."""
    seen: dict = {}
    load_events, counters = trace.load_events, harness.counters

    def keep(path):
        seen["events"] = load_events(path)
        return seen["events"]

    def with_stats(cs):
        # the set's own numbers first: the fixpoint read that counters()
        # makes then falls in the window's delta once, and its wait not
        out = _stats_counters(cs)
        out.update(counters(cs))
        return out

    trace.load_events, harness.counters = keep, with_stats
    try:
        out = harness.run_cell(registry, workload, seed, seconds, True, device=device,
                               t_start=t_start)
    finally:
        trace.load_events, harness.counters = load_events, counters
    c = out["run"].counters
    if "host_reads.fixpoint" in c:
        c["host_reads.fixpoint"] -= 1
    return dict(out, events=seen.get("events", []))


def report(registry, workload: str, out: dict) -> dict:
    """The JSON line of a traced run: the result, the benchmark's per-layer
    metrics, the layer numbers, the reads a window batch by site, the
    window's counters, and the span table."""
    run = out["run"]
    metrics = {}
    for m in registry.metrics(workload, "per_layer"):
        value = registry.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = value
    red = reduce(out["events"])
    window = len(run.window)
    reads = {k.split(".", 1)[1]: v / window for k, v in run.counters.items()
             if k.startswith("host_reads.")} if window else {}
    return dict(
        out["result"], device=out["device"], metrics=metrics,
        layer_numbers=layer_numbers(red, run.counters, run.traced_batches, window),
        reads_per_batch=reads, counters=run.counters, traced_batches=run.traced_batches,
        trace=None if red is None else {k: v for k, v in red.items() if k != "spans"},
        spans=None if red is None else red["spans"], checks=out["checks"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from .registry import ROOT, Registry

    harness.cache_env(ROOT)
    import torch

    if not torch.cuda.is_available():
        harness.log("no CUDA device: no result")
        return 2
    torch.set_num_threads(1)
    registry = Registry()
    out = traced_cell(registry, args.workload, args.seed & (2**64 - 1), args.seconds,
                      t_start=T_START)
    print(json.dumps(report(registry, args.workload, out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
