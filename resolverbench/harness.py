"""One run of one cell: set-up, the measured window, an optional traced
span, and the comparison with the plain reference.

The entry the window drives is the resolver's packed, pipelined check, in
the order the resolver role's pipelined path gives it
(`roles/resolver.py::_resolve_pipelined`, `conflict/pipeline.py`'s
`resolve_deferred` and `_drain_deferred`), on packed arrays in place of
TxInfo lists.  For batch i, in a closed loop:
  1. the cell's generator (`traffic/<generator>.py`) makes the batch from
     the seed and packs it into host arrays (`gen.pack`, in layout.py's
     layout);
  2. where no batch is in flight, the set's recovery snapshot is taken;
     ``cs.resolve_arrays(v_i, *arrays, sync=False)``, keeping the verdicts
     and the set's folded validity flag as they stand at this dispatch;
  3. ``cs.remove_before(v_i - window)``, the role's MVCC GC, noted on the
     newest batch in flight;
  4. batch i - 1 is drained: its verdicts and its flag are read to the
     host, so two batches are in flight at each dispatch.  A batch whose
     flag holds is answered.  Once the program's replay window of drained
     batches fills and the stream's flag read then holds, every batch in
     flight is answered and the window closes (``check_pipelined``).  On
     the first flag that does not hold, the snapshot is put back and every
     batch of the open window is resolved again through the synchronous
     path, with its GC calls between, as ``_recover_inflight`` does.
A batch's latency runs from its call in step 2 to its answered verdicts
on the host.  When the measured time is up, the batches in flight are
drained as above.

Set-up brings the set to the state at the start of the window through the
same loop: an MVCC window's worth of write-only batches of the cell's keys
at their own versions (what the batches before the window leave), then
`warmup_batches` full batches of the cell's traffic, with the MVCC GC and
TOO_OLD answers running: every shape and step the window uses,
compactions included.
"""

from __future__ import annotations

import contextlib
import gc
import os
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import trace

FORBIDDEN = ("jax", "jaxlib", "flax", "foundationdb_tpu")


def log(msg: str) -> None:
    print(f"[resolverbench] {msg}", file=sys.stderr, flush=True)


@dataclass
class Batch:
    index: int
    version: int
    txns: int
    t_call: float = 0.0
    t_disp: float = 0.0
    t_done: float | None = None
    verdicts: np.ndarray | None = None
    replayed: bool = False
    # while the batch can still be replayed: its arrays, its device
    # verdicts and flag, the GC calls made after it
    arrays: tuple | None = None
    verdict_dev: object = None
    ok_dev: object = None
    gc_after: list = field(default_factory=list)


@dataclass
class Run:
    """What the metric readers read (metrics/<name>.py)."""
    setup_s: float = 0.0
    window: list = field(default_factory=list)
    window_s: float = 0.0
    counters: dict = field(default_factory=dict)
    trace: dict | None = None
    traced_batches: int = 0


class Stream:
    """The closed loop of the module docstring over one set."""

    def __init__(self, torch, cs, gen, device, replay_window: int) -> None:
        self.torch, self.cs, self.gen = torch, cs, gen
        self.width = gen.max_key_bytes // 4 + 1  # lanes a key row
        self.replay_window = replay_window
        self.cuda = device.type == "cuda"
        self.spans = False
        self.recoveries = 0
        self.inflight: list[Batch] = []    # dispatched, not drained
        self.replayable: list[Batch] = []  # drained, the window still open
        self.snap: dict | None = None

    def span(self, name: str):
        if self.spans:
            return self.torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def dispatch(self, rec: Batch, arrays: tuple) -> None:
        """Step 2."""
        if not self.inflight:
            self.snap = self.cs._take_snapshot()
        rec.t_call = time.perf_counter()
        rec.verdict_dev = self.cs.resolve_arrays(rec.version, *arrays, sync=False)
        rec.t_disp = time.perf_counter()
        rec.ok_dev = self.cs._dev_ok
        rec.arrays = arrays
        self.inflight.append(rec)

    def advance(self, version: int) -> None:
        """Step 3, the role's `_advance_window`."""
        if version > self.gen.window:
            self.cs.remove_before(version - self.gen.window)
            if self.inflight:
                self.inflight[-1].gc_after.append(version - self.gen.window)

    def answer(self, rec: Batch, verdicts) -> None:
        rec.verdicts = np.asarray(verdicts)[:rec.txns].astype(np.int8)
        rec.t_done = time.perf_counter()
        rec.verdict_dev = rec.ok_dev = None

    def drain(self, upto: Batch) -> None:
        """Step 4: the batches in flight through `upto`, in order."""
        if upto.verdicts is not None:
            return
        cs = self.cs
        while self.inflight:
            h = self.inflight[0]
            verdicts = cs._host_numpy(h.verdict_dev)
            if not cs._host_bool(h.ok_dev):
                self.recover()
                return
            self.inflight.pop(0)
            self.answer(h, verdicts)
            if self.inflight:
                self.replayable.append(h)
                if len(self.replayable) >= self.replay_window and cs._host_bool(cs._dev_ok):
                    for hh in self.inflight:
                        self.answer(hh, cs._host_numpy(hh.verdict_dev))
                        hh.arrays = None
                    self.inflight.clear()
            if not self.inflight:
                for hh in self.replayable + [h]:
                    hh.arrays = None
                self.replayable.clear()
                self.snap = None
                cs.check_pipelined()
            if h is upto:
                return

    def recover(self) -> None:
        """The snapshot put back, the open window resolved again."""
        done, pending, snap = self.replayable, self.inflight, self.snap
        self.replayable, self.inflight, self.snap = [], [], None
        with self.span("rb.recover"):
            for name, value in snap.items():
                setattr(self.cs, name, value)
            for h in done + pending:
                v = self.cs.resolve_arrays(h.version, *h.arrays)
                if h.verdicts is None:
                    self.answer(h, v)
                    h.replayed = True
                for gv in h.gc_after:
                    self.cs.remove_before(gv)
                h.arrays = None
        self.recoveries += 1

    def run(self, first: int, count: int | None = None, until: float | None = None,
            write_only: bool = False) -> list[Batch]:
        done: list[Batch] = []
        i = first
        while (count is None or i < first + count) and (
                until is None or time.perf_counter() < until):
            with self.span("rb.generate"):
                b = self.gen.batch(i, write_only)
                arrays = self.gen.pack(b, self.width)
            if self.cs.oldest_version != b["oldest"]:
                raise RuntimeError(f"the set's oldest version {self.cs.oldest_version}"
                                   f" is not the stream's {b['oldest']}")
            rec = Batch(i, b["version"], b["snaps"].shape[0])
            with self.span("rb.dispatch"):
                self.dispatch(rec, arrays)
            with self.span("rb.gc"):
                self.advance(rec.version)
            if done:
                with self.span("rb.read"):
                    self.drain(done[-1])
            done.append(rec)
            i += 1
        if self.inflight:
            with self.span("rb.read"):
                self.drain(self.inflight[-1])
        return done


def counters(cs) -> dict:
    iters = cs.fixpoint_iterations()
    s = cs.stats
    return dict(fixpoint_iters=iters, host_syncs=cs.host_syncs,
                search_fallbacks=s.search_fallbacks, compactions=s.compactions,
                compact_s=s.compact_s)


def delta(a: dict, b: dict) -> dict:
    d = {k: b[k] - a[k] for k in a}
    d["host_syncs"] -= 1  # the read of the iteration count itself
    return d


def _profiled(torch, stream: Stream, first: int, count: int) -> tuple[list, dict | None]:
    """`count` more batches under torch.profiler, each loop step in a span."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if stream.cuda else [])
    stream.spans = True
    try:
        with profile(activities=acts) as prof:
            recs = stream.run(first, count=count)
            if stream.cuda:
                torch.cuda.synchronize()
    finally:
        stream.spans = False
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = trace.load_events(path)
    import foundationdb_tpu_torch

    hand = trace.hand_symbols(Path(foundationdb_tpu_torch.__file__).parent)
    return recs, trace.summarize(events, hand)


def run_cell(registry, workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", t_start: float | None = None) -> dict:
    """One run.  Returns the parts of the result line: "result" (correct,
    attempted, failed), "device", "breakdown" (None untraced) and "checks",
    with "run" (what the metric readers read) and the set-up split."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    config, traffic = load_cell(registry, workload)
    setup: dict = {}
    dev = torch.device(device)

    t = time.perf_counter()
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    setup["cuda_init_s"] = time.perf_counter() - t

    t = time.perf_counter()
    from foundationdb_tpu_torch.bench import BEST_KNOWN
    from foundationdb_tpu_torch.conflict import pipeline
    from foundationdb_tpu_torch.conflict.device import DeviceConflictSet
    if dev.type == "cuda":
        from foundationdb_tpu_torch.conflict import _build
        _build.load()
    setup["build_s"] = time.perf_counter() - t

    t = time.perf_counter()
    gen = registry.generator(traffic["generator"]).Generator(config, traffic["traffic"], seed)
    setup["key_tables_s"] = time.perf_counter() - t

    loop = traffic["loop"]
    live = gen.window // gen.step  # batches the MVCC window holds
    warm = int(loop["warmup_batches"])
    t = time.perf_counter()
    cs = DeviceConflictSet(device=dev, max_key_bytes=gen.max_key_bytes, **BEST_KNOWN)
    stream = Stream(torch, cs, gen, dev, pipeline._REPLAY_WINDOW)
    recs = stream.run(0, count=live, write_only=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup["prefill_s"] = time.perf_counter() - t

    t = time.perf_counter()
    recs += stream.run(live, count=warm)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup["warmup_s"] = time.perf_counter() - t
    before = counters(cs)
    recoveries0 = stream.recoveries

    run = Run()
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    setup["setup_s"] = run.setup_s
    window = stream.run(live + warm, until=t0 + seconds)
    run.window_s = time.perf_counter() - t0
    run.window = window
    run.counters = delta(before, counters(cs))
    run.counters["recoveries"] = stream.recoveries - recoveries0
    recs += window
    nxt = live + warm + len(window)
    if traced:
        traced_recs, run.trace = _profiled(torch, stream, nxt, int(loop["trace_batches"]))
        run.traced_batches = len(traced_recs)
        recs += traced_recs
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        kind = torch.cuda.get_device_name(dev)
    else:
        peak, kind = 0, "cpu"
    stats = dict(boundaries=cs.boundary_count, capacity=cs.capacity,
                 recoveries=stream.recoveries)
    del cs, stream
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    checks, tally = compare(gen, recs, live)
    ref_s = time.perf_counter() - t
    lat = [r.t_done - r.t_call for r in window if r.t_done is not None]
    log(f"window: {len(window)} batches, {sum(r.txns for r in window)} txns in "
        f"{run.window_s:.3f} s; latency median {1e3 * statistics.median(lat):.3f} ms "
        f"max {1e3 * max(lat):.3f} ms; counters {run.counters}")
    log(f"set: {stats}; verdicts {tally}; reference {ref_s:.3f} s for {len(recs)} "
        f"batches; memory peak {peak} B")
    unanswered = sum(r.txns for r in window if r.verdicts is None)
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": sum(r.txns for r in window),
        "failed": unanswered + checks["mismatched_verdicts"]["value"],
    }
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
              "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if run.trace is not None:
        device.update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
        breakdown = {"device_ops": run.trace["device_ops"],
                     "idle_gaps": run.trace["idle_gaps"]}
    return dict(run=run, result=result, device=device, breakdown=breakdown,
                checks=checks, setup=setup)


def load_cell(registry, workload: str) -> tuple[dict, dict]:
    """The cell's configuration and traffic mix."""
    cell = registry.cell(workload)
    return registry.config(cell["config"]), registry.traffic(cell["traffic"])


def compare(gen, recs: list[Batch], write_only_below: int) -> tuple[dict, dict]:
    """Every batch's verdicts against the reference's, which the cell's
    generator works out again from the seed.  Returns the checks (each
    number with its limit) and a tally of the reference's verdicts."""
    by_index = {r.index: r for r in recs}
    mismatched = unanswered = 0
    tally = np.zeros(3, dtype=np.int64)
    for i, want in enumerate(gen.reference(max(by_index), write_only_below)):
        tally += np.bincount(want, minlength=3)
        rec = by_index.get(i)
        if rec is None or rec.verdicts is None:
            unanswered += 1
            continue
        mismatched += int((rec.verdicts != want).sum())
    checks = {
        "mismatched_verdicts": {"value": mismatched, "limit": 0},
        "unanswered_batches": {"value": unanswered, "limit": 0},
    }
    names = ("conflict", "too_old", "committed")
    return checks, dict(zip(names, tally.tolist()))


def forbidden_modules() -> list[str]:
    """Top-level module names loaded in this process that the benchmark
    must not load, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_env(root: Path) -> None:
    """Build and kernel caches inside the checkout, at fixed paths."""
    cache = root / ".resolverbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
