"""The port's host runtime (foundationdb_tpu_torch/runtime/) against the
reference's, same seed for same seed, compared exactly: DeterministicRandom
draws, the EventLoop's schedule (the order and virtual time of every task
completion under delays, priorities, cancellation and streams), the
combinators, the metric snapshots (LatencyTracker, LatencyBands, Smoother,
ContinuousSample), CoreKnobs/ClientKnobs defaults and randomized values,
the trace plane's event streams (TraceCollector, CounterCollection rates,
spawn_role_metrics, spawn_wire_metrics, TraceBatch, TraceFileSink files)
and buggify's snapshot/restore/emit_coverage/maybe_delay.

Each scenario is one function over a namespace of modules, run once on the
port's and once on the reference's; both results must be equal."""

from types import SimpleNamespace

import pytest

from foundationdb_tpu.runtime import buggify as jbuggify
from foundationdb_tpu.runtime import combinators as jcombinators
from foundationdb_tpu.runtime import core as jcore
from foundationdb_tpu.runtime import coverage as jcoverage
from foundationdb_tpu.runtime import knobs as jknobs
from foundationdb_tpu.runtime import metrics as jmetrics
from foundationdb_tpu.runtime import trace as jtrace
from foundationdb_tpu_torch.runtime import (
    buggify, combinators, core, coverage, knobs, metrics, trace)

PORT = SimpleNamespace(core=core, combinators=combinators, metrics=metrics,
                       knobs=knobs, trace=trace, buggify=buggify, coverage=coverage)
REF = SimpleNamespace(core=jcore, combinators=jcombinators, metrics=jmetrics,
                      knobs=jknobs, trace=jtrace, buggify=jbuggify, coverage=jcoverage)


@pytest.fixture(autouse=True)
def _both_censuses_isolated():
    """Both packages' buggify and coverage are module globals: each test
    starts with both disabled and leaves them as it found them."""
    snaps = [(m.coverage.snapshot(), m.buggify.snapshot()) for m in (PORT, REF)]
    for m in (PORT, REF):
        m.buggify.disable()
    yield
    for m, (cov, bug) in zip((PORT, REF), snaps):
        m.buggify.disable()
        m.coverage.restore(cov)
        m.buggify.restore(bug)


def both(fn, *args):
    """Run `fn(namespace, *args)` on the port and on the reference; the
    results must be equal.  Returns the port's."""
    got, want = fn(PORT, *args), fn(REF, *args)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# DeterministicRandom


def _draws(m, seed):
    r = m.core.DeterministicRandom(seed)
    out = []
    for i in range(120):
        k = i % 8
        if k == 0:
            out.append(r.random())
        elif k == 1:
            out.append(r.random_int(-5, 1000 + i))
        elif k == 2:
            out.append(r.random_choice("abcdefgh"))
        elif k == 3:
            out.append(r.random_bytes(i % 13))
        elif k == 4:
            seq = list(range(i % 11))
            r.shuffle(seq)
            out.append(seq)
        elif k == 5:
            out.append(r.coinflip((i % 10) / 10))
        elif k == 6:
            out.append(r.random_unique_id())
        else:
            child = r.split()
            out.append((child.seed, child.random(), child.random_unique_id()))
    return out


@pytest.mark.parametrize("seed", [0, 3, 20260729, 2**63 - 1])
def test_deterministic_random_draws_match(seed):
    both(_draws, seed)


# ---------------------------------------------------------------------------
# EventLoop schedules


def _schedule(m, seed):
    """Tasks at seeded priorities that delay, yield, wait on each other,
    cancel one another and pass values through a FutureStream; returns
    every step as (virtual time, task, event) and the loop's step count."""
    core = m.core
    loop = core.EventLoop()
    r = core.DeterministicRandom(seed)
    log = []
    stream = core.FutureStream()
    pris = [core.TaskPriority.LOW, core.TaskPriority.DEFAULT_DELAY,
            core.TaskPriority.RESOLVER, core.TaskPriority.MAX]

    async def worker(i):
        for step in range(4):
            d = r.random_int(0, 4) * 0.001
            if d:
                await loop.delay(d, r.random_choice(pris))
            else:
                await loop.yield_(r.random_choice(pris))
            log.append((loop.now(), f"w{i}", step))
        stream.send(i)
        return i * 10

    async def consumer(n):
        got = []
        for _ in range(n):
            got.append(await stream.pop())
            log.append((loop.now(), "consumer", got[-1]))
        return got

    async def sleeper():
        try:
            await loop.delay(10.0)
        except core.ActorCancelled:
            log.append((loop.now(), "sleeper", "cancelled"))
            raise

    async def waiter(tasks):
        out = []
        for t in tasks:
            out.append(await t)
            log.append((loop.now(), "waiter", out[-1]))
        return out

    async def breaker():
        p = core.Promise()
        fut = p.future
        del p  # a dropped promise breaks its future
        try:
            await fut
        except core.BrokenPromise:
            log.append((loop.now(), "breaker", "broken"))

    workers = [loop.spawn(worker(i), r.random_choice(pris), f"w{i}") for i in range(6)]
    cons = loop.spawn(consumer(6), core.TaskPriority.DEFAULT_ENDPOINT)
    sl = loop.spawn(sleeper(), core.TaskPriority.LOW)
    never = loop.spawn(sleeper(), core.TaskPriority.LOW)
    never.cancel()  # cancelled before its first step: never runs
    loop.spawn(breaker())
    w = loop.spawn(waiter(workers[::-1]))

    async def stopper():
        await loop.delay(0.0025)
        sl.cancel()

    loop.spawn(stopper(), core.TaskPriority.MAX)
    got = loop.run_until(w)
    loop.drain()
    with pytest.raises(core.ActorCancelled):
        sl.result()
    with pytest.raises(core.TimedOut):
        loop.run_until(loop.delay(5.0), deadline=loop.now())
    return log, got, cons.result(), loop.tasks_run, loop.now()


@pytest.mark.parametrize("seed", [1, 2, 99])
def test_event_loop_schedule_matches(seed):
    log, got, consumed, _n, _t = both(_schedule, seed)
    assert got == [50, 40, 30, 20, 10, 0] and sorted(consumed) == list(range(6))
    assert [e[1:] for e in log].count(("sleeper", "cancelled")) == 1


def test_real_clock_driver_runs_the_loop_on_the_wall():
    loop = core.EventLoop()
    drv = core.RealClockDriver(loop)
    loop.spawn(_ticker(loop, []))
    assert drv.run_until(loop.delay(0.01), wall_timeout=10.0) is None
    with pytest.raises(core.TimedOut):
        drv.run_until(loop.delay(60.0), wall_timeout=0.02)


async def _ticker(loop, out):
    for i in range(3):
        await loop.delay(0.001)
        out.append(i)


# ---------------------------------------------------------------------------
# combinators


def _combinators(m, seed):
    core, comb = m.core, m.combinators
    loop = core.EventLoop()
    r = core.DeterministicRandom(seed)
    out = []

    async def after(v, fail=False):
        await loop.delay(r.random_int(1, 50) * 0.001)
        if fail:
            raise ValueError(v)
        return v

    def spawn_all(vals, fail_at=()):
        return [loop.spawn(after(v, i in fail_at)) for i, v in enumerate(vals)]

    async def main():
        out.append(("all", await comb.wait_all(spawn_all(range(5))), loop.now()))
        out.append(("all[]", await comb.wait_all([]), loop.now()))
        try:
            await comb.wait_all(spawn_all(range(5), fail_at=(2,)))
        except ValueError as e:
            out.append(("all-err", e.args, loop.now()))
        out.append(("any", await comb.wait_any(spawn_all("abcde")), loop.now()))
        out.append(("quorum", await comb.quorum(spawn_all(range(5), (0, 1)), 3), loop.now()))
        try:
            await comb.quorum(spawn_all(range(4), (0, 1, 2)), 2)
        except ValueError as e:
            out.append(("quorum-err", e.args, loop.now()))
        out.append(("timeout-ok", await comb.timeout_error(loop, loop.spawn(after(7)), 1.0),
                    loop.now()))
        try:
            await comb.timeout_error(loop, loop.delay(5.0), 0.01)
        except core.TimedOut:
            out.append(("timed-out", loop.now()))
        var, trig = comb.AsyncVar(1), comb.AsyncTrigger()
        ch, tg = var.on_change(), trig.on_trigger()
        var.set(1)
        var.set(2)
        trig.trigger()
        out.append(("var", await ch, await tg, var.get()))
        ticks = []
        rec = loop.spawn(comb.recurring(loop, lambda: ticks.append(loop.now()), 0.01))
        await loop.delay(0.035)
        rec.cancel()
        out.append(("recurring", ticks))
        return loop.now()

    end = loop.run_until(loop.spawn(main()))
    with pytest.raises(ValueError):
        comb.quorum([], 1)
    return out, end


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_combinators_match(seed):
    out, _end = both(_combinators, seed)
    assert [o[0] for o in out] == ["all", "all[]", "all-err", "any", "quorum",
                                   "quorum-err", "timeout-ok", "timed-out", "var",
                                   "recurring"]


# ---------------------------------------------------------------------------
# metrics


def _metrics(m, seed):
    met = m.metrics
    r = m.core.DeterministicRandom(seed)
    trackers = [met.LatencyTracker(sample_size=32) for _ in range(3)]
    for i in range(400):
        trackers[i % 3 if i % 7 else 0].observe(r.random() ** 3 * 3.0)
    bands = met.LatencyBands((0.01, 0.1, 1.0))
    for i in range(50):
        bands.add(r.random() * 2)
    now = [0.0]
    sm = met.Smoother(2.0, lambda: now[0])
    series = []
    for i in range(40):
        now[0] += r.random() * 0.5
        sm.add_delta(r.random_int(0, 100))
        if i == 20:
            sm.reset(5.0)
        if i == 30:
            sm.set_total(1000.0)
        series.append((sm.smooth_total(), sm.smooth_rate()))
    seeded = met.ContinuousSample(16, rng=m.core.DeterministicRandom(seed))
    plain = met.ContinuousSample(16)
    for i in range(300):
        seeded.add(i * 1.5)
        plain.add(float(i))
    return ([t.snapshot() for t in trackers], met.LatencyTracker.merged(trackers),
            bands.snapshot(), series,
            [(s.count, s.median(), s.percentile(0.99)) for s in (seeded, plain)])


@pytest.mark.parametrize("seed", [7, 8])
def test_metric_snapshots_match(seed):
    snaps, merged, _b, _s, _c = both(_metrics, seed)
    assert merged["count"] == sum(s["count"] for s in snaps) == 400


def test_wire_stats_snapshot_matches():
    def fill(w):
        w.frames_encoded, w.bytes_encoded, w.flushes, w.frames_flushed = 3, 99, 2, 5
        w.note_fallback(1.5)
        w.note_fallback(object())
        snap = w.snapshot()
        del snap["encode_ms"], snap["decode_ms"]
        return snap

    assert fill(metrics.WireStats()) == fill(jmetrics.WireStats())


# ---------------------------------------------------------------------------
# knobs


def _knobs(m, seed):
    rng = None if seed is None else m.core.DeterministicRandom(seed)
    core_k = m.knobs.CoreKnobs(randomize=rng)
    client_k = m.knobs.ClientKnobs(randomize=rng)
    vals = [(k.names(), {n: getattr(k, n) for n in k.names()}) for k in (core_k, client_k)]
    core_k.set_knob("VERSIONS_PER_SECOND", "3")
    core_k.set_knob("MAX_WRITE_TRANSACTION_LIFE", "2.5")
    core_k.set_knob("WIRE_COALESCE", "false")
    with pytest.raises(KeyError):
        core_k.set_knob("NO_SUCH_KNOB", "1")
    return vals, core_k.mvcc_window_versions, core_k.WIRE_COALESCE


@pytest.mark.parametrize("seed", [None, 0, 1, 2, 17, 4242])
def test_knob_defaults_and_randomized_values_match(seed):
    vals, window, coalesce = both(_knobs, seed)
    assert window == 7 and coalesce is False
    assert vals[0][1]["DEVICE_WATCHDOG_S"] == 30.0


# ---------------------------------------------------------------------------
# the trace plane


def _trace_plane(m, tmp):
    core, tr = m.core, m.trace
    loop = core.EventLoop()
    sink = tr.TraceFileSink(str(tmp / "trace"), roll_size=600, max_logs=3)
    col = tr.TraceCollector(clock=loop.now, sink=sink, keep=8,
                            min_severity=tr.SEV_INFO, machine="m1",
                            wall_clock=lambda: 1234.5)
    col.trace("Dropped", severity=tr.SEV_DEBUG)
    for i in range(12):
        col.trace("Ev", severity=tr.SEV_INFO + i % 3, track_latest="ev", N=i)
    counters = tr.CounterCollection("Role")
    c_a, c_b = counters.counter("a"), counters.counter("b")
    proc = SimpleNamespace(alive=True, name="p1")

    def fields():
        rates = counters.rates(loop.now())
        return {"A": rates.get("a", 0.0), "B": rates.get("b", 0.0)}

    wire = m.metrics.WireStats()
    em = tr.spawn_role_metrics(loop, proc, col, "RoleMetrics", fields, 0.5)
    wm = tr.spawn_wire_metrics(loop, col, wire, 0.5, "net")

    async def work():
        for i in range(8):
            await loop.delay(0.2)
            c_a.add(i)
            c_b.add(1)
            wire.frames_encoded += i
            wire.bytes_encoded += 10 * i
        proc.alive = False
        await loop.delay(1.0)
        wm.cancel()

    loop.run_until(loop.spawn(work()))
    batch = tr.TraceBatch()
    batch.attach_clock(loop.now, col)
    batch.add("Proxy.start", "d1")
    batch.add("Proxy.start", None)
    batch.add("Resolver.end", "d1")
    sink.close()
    files = [(p.rsplit("/", 1)[-1], open(p).read()) for p in sink.files()]
    return (list(col.events), col.latest, col.count("Ev"), col.count("RoleMetrics"),
            col.find("WireMetrics"), batch.timeline("d1"), files, em.done())


def test_trace_plane_event_streams_match(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    got = _trace_plane(PORT, tmp_path / "port")
    want = _trace_plane(REF, tmp_path / "ref")
    assert got == want
    events, latest, n_ev, n_role, wire_events, timeline, files, done = got
    assert n_ev == 12 and len(events) == 8 and n_role >= 3 and wire_events
    assert [e["Location"] for e in timeline] == ["Proxy.start", "Resolver.end"]
    assert len(files) == 3 and done


def test_slow_task_trace_lands_in_the_port_collector():
    loop = core.EventLoop()
    col = trace.TraceCollector(clock=loop.now)
    loop.slow_task_trace, loop.slow_task_trace_threshold = col, 0.0
    loop.profile = True
    loop.run_until(loop.delay(0.5))
    assert col.count("SlowTask") >= 1 and loop.busy_s_by_priority


# ---------------------------------------------------------------------------
# buggify and coverage


def _buggify_plane(m, seed):
    bg, cov = m.buggify, m.coverage
    loop = m.core.EventLoop()
    bg.enable(m.core.DeterministicRandom(seed), enable_prob=0.6, fire_prob=0.4)
    base = cov.snapshot()
    fired = [bg.buggify(f"site{i % 5}") for i in range(40)]
    snap = bg.snapshot()
    after = [bg.buggify(f"site{i % 5}") for i in range(20)]
    bg.restore(snap)
    again = [bg.buggify(f"site{i % 5}") for i in range(20)]

    async def delays():
        times = []
        bg.force("slow", 2)
        for _ in range(3):
            await bg.maybe_delay(loop, "slow", 0.25)
            times.append(loop.now())
        return times

    times = loop.run_until(loop.spawn(delays()))
    col = m.trace.TraceCollector(clock=loop.now)
    bg.emit_coverage(col)
    cov.emit_coverage(col, base)
    # restore() puts back the sites' state and the same (advanced) rng
    out = fired, after, again, times, bg.is_enabled(), list(col.events)
    bg.disable()
    return out


@pytest.mark.parametrize("seed", [1, 31])
def test_buggify_snapshot_restore_and_emission_match(seed):
    fired, _after, _again, times, enabled, events = both(_buggify_plane, seed)
    assert enabled and times == [0.25, 0.5, 0.5] and any(fired)
    kinds = {e["Kind"] for e in events}
    assert kinds == {"buggify", "testcov"}
