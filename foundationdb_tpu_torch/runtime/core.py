"""Deterministic cooperative runtime — the framework's flow/ analog.

The reference is written in Flow: futures/promises + actors compiled to
callback state machines, all scheduled by a single-threaded priority run
loop (flow/flow.h:595,709; flow/Net2.actor.cpp:548).  Its deepest property
is *substitutability of the world*: the same role code runs under the real
event loop or under a seeded simulator, making whole-cluster runs
deterministic and replayable (flow/network.h:192 INetwork; fdbrpc/sim2).

This runtime keeps that property with idiomatic Python instead of a Flow
port: native coroutines (`async def`) are the actors, `Future`/`Promise`
the single-assignment channels, and `EventLoop` a virtual-clock priority
scheduler.  Everything is deterministic by construction: the loop is
single-threaded, timers fire in (time, priority, seq) order, and all
randomness flows from `DeterministicRandom` seeds.  Python-level control
flow is *not* the data path — the data path is the device kernel and the
native backends; this loop only sequences batches, RPCs and role logic,
mirroring how the reference's run loop sequences single-threaded actors
around its hot C++ cores (SURVEY §2.6.6).

The real-time twin (`RealClockDriver`) drives the same loop off the wall
clock; roles cannot observe which world they run in — the Net2/Sim2 seam.

Copy of the reference package's module: the same seed and the same program
give the same draws, the same (time, priority, seq) order of callbacks and
the same virtual times in both packages.  The port's roles (roles/) run on
this loop; its slow-task trace goes to the port's runtime/trace.py.
"""

from __future__ import annotations

import heapq
import random as _pyrandom
import time as _time
from collections import deque
from typing import Any, Awaitable, Callable, Coroutine, Iterable


class TaskPriority:
    """Fixed task priorities ordering everything in the run loop (the
    reference's 40-step enum, flow/network.h:30-74; higher runs first)."""

    MAX = 1000000
    RUN_LOOP = 30000
    WRITE_SOCKET = 10000
    COORDINATION = 8800
    PROXY_COMMIT = 8540
    RESOLVER = 8700
    TLOG_COMMIT = 8510
    GET_LIVE_VERSION = 8500
    DEFAULT_DELAY = 7010
    DISK_IO = 5010  # reference TaskDiskIOComplete
    DEFAULT_ENDPOINT = 5000
    UNKNOWN_ENDPOINT = 4000
    RATEKEEPER = 3110
    STORAGE_SERVER = 3100
    DATA_DISTRIBUTION = 3500
    LOW = 2000
    MIN = 1000
    ZERO = 0


class ActorCancelled(Exception):
    """Raised inside a coroutine when its Task is cancelled (the reference's
    actor_cancelled, thrown by actor destruction — flow/Error.h)."""


class BrokenPromise(Exception):
    """The promise side was dropped without a value (flow/flow.h SAV)."""


class TimedOut(Exception):
    pass


_PENDING = object()


class Future:
    """Single-assignment async value (flow/flow.h:595).

    Not thread-safe by design: the whole runtime is single-threaded, like
    the reference's per-process run loop.
    """

    __slots__ = ("_value", "_error", "_callbacks")

    def __init__(self) -> None:
        self._value: Any = _PENDING
        self._error: BaseException | None = None
        self._callbacks: list[Callable[[Future], None]] = []

    # -- inspection --------------------------------------------------------
    def done(self) -> bool:
        return self._value is not _PENDING or self._error is not None

    def result(self) -> Any:
        if self._error is not None:
            raise self._error
        if self._value is _PENDING:
            raise RuntimeError("future not ready")
        return self._value

    def exception(self) -> BaseException | None:
        return self._error

    # -- completion (used by Promise / Task) -------------------------------
    def _set(self, value: Any) -> None:
        if self.done():
            raise RuntimeError("future already set")
        self._value = value
        self._fire()

    def _set_error(self, err: BaseException) -> None:
        if self.done():
            raise RuntimeError("future already set")
        self._error = err
        self._fire()

    def _fire(self) -> None:
        cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def add_done_callback(self, cb: Callable[[Future], None]) -> None:
        if self.done():
            cb(self)
        else:
            self._callbacks.append(cb)

    def remove_done_callback(self, cb: Callable[[Future], None]) -> None:
        try:
            self._callbacks.remove(cb)
        except ValueError:
            pass

    def __await__(self):
        if not self.done():
            yield self
        return self.result()


class Promise:
    """Write side of a Future (flow/flow.h:709).  Dropping a pending promise
    breaks it: awaiters see BrokenPromise, exactly like the reference."""

    __slots__ = ("future", "_sent")

    def __init__(self) -> None:
        self.future = Future()
        self._sent = False

    def send(self, value: Any = None) -> None:
        self._sent = True
        self.future._set(value)

    def fail(self, err: BaseException) -> None:
        self._sent = True
        self.future._set_error(err)

    def is_set(self) -> bool:
        return self.future.done()

    def __del__(self) -> None:
        if not self._sent and not self.future.done():
            try:
                self.future._set_error(BrokenPromise())
            except Exception:
                pass


class FutureStream:
    """Multi-value channel (flow/flow.h:760 FutureStream): awaiting pops the
    next queued value; values queue if nobody is waiting."""

    __slots__ = ("_queue", "_waiters", "_closed_err")

    def __init__(self) -> None:
        self._queue: deque[Any] = deque()
        self._waiters: deque[Promise] = deque()
        self._closed_err: BaseException | None = None

    def send(self, value: Any) -> None:
        if self._waiters:
            self._waiters.popleft().send(value)
        else:
            self._queue.append(value)

    def close(self, err: BaseException | None = None) -> None:
        self._closed_err = err or BrokenPromise()
        for w in self._waiters:
            w.fail(self._closed_err)
        self._waiters.clear()

    def pop(self) -> Future:
        p = Promise()
        if self._queue:
            p.send(self._queue.popleft())
        elif self._closed_err is not None:
            p.fail(self._closed_err)
        else:
            self._waiters.append(p)
        return p.future

    def __len__(self) -> int:
        return len(self._queue)


class Task(Future):
    """A running coroutine; also a Future of its result.  Cancellation
    throws ActorCancelled at the coroutine's current await point — the
    Python rendering of "actor destroyed ⇒ wait() throws actor_cancelled"
    (flow/flow.h:914 Actor)."""

    __slots__ = (
        "_coro", "_loop", "_priority", "_waiting_on", "name", "_resume_cb",
        "_cancelled", "_started",
    )

    def __init__(self, coro: Coroutine, loop: "EventLoop", priority: int, name: str) -> None:
        super().__init__()
        self._coro = coro
        self._loop = loop
        self._priority = priority
        self._waiting_on: Future | None = None
        self._resume_cb: Callable | None = None
        self._cancelled = False
        self._started = False
        self.name = name

    def _step(self, send_value: Any = None, throw_err: BaseException | None = None) -> None:
        if self.done():
            return
        if self._cancelled and throw_err is None:
            # cancelled before this step ran: like the reference, a destroyed
            # actor's body never executes past the cancellation point
            if not self._started:
                # never ran at all: close instead of throwing into it so the
                # interpreter doesn't warn about an un-awaited coroutine
                self._coro.close()
                self._set_error(ActorCancelled())
                return
            throw_err = ActorCancelled()
        self._waiting_on = None
        self._started = True
        try:
            if throw_err is not None:
                awaited = self._coro.throw(throw_err)
            else:
                awaited = self._coro.send(send_value)
        except StopIteration as stop:
            self._set(stop.value)
            return
        except ActorCancelled as e:
            self._set_error(e)
            return
        except BaseException as e:  # noqa: BLE001 — error propagates to awaiters
            self._set_error(e)
            return
        if not isinstance(awaited, Future):
            raise TypeError(f"task {self.name} awaited non-Future {awaited!r}")
        self._waiting_on = awaited

        def resume(fut: Future, task=self) -> None:
            # resumption goes through the loop queue at the task's priority:
            # completion order alone never determines execution order
            if fut.exception() is not None:
                task._loop._ready(task._priority, lambda: task._step(throw_err=fut.exception()))
            else:
                task._loop._ready(task._priority, lambda: task._step(send_value=fut.result()))

        self._resume_cb = resume
        awaited.add_done_callback(resume)

    def cancel(self) -> None:
        if self.done():
            return
        self._cancelled = True  # any already-queued _step now throws instead
        if not self._started:
            # never ran: finish it synchronously (no loop turn needed) so the
            # coroutine object is closed, not leaked to the GC
            self._coro.close()
            self._set_error(ActorCancelled())
            return
        if self._waiting_on is not None:
            if self._resume_cb is not None:
                self._waiting_on.remove_done_callback(self._resume_cb)
            self._waiting_on = None
            self._loop._ready(
                self._priority, lambda: self._step(throw_err=ActorCancelled())
            )
        # else: the spawn- or resume-queued _step is already in the heap and
        # will observe _cancelled before running any coroutine code

    def __del__(self) -> None:
        # a task whose loop was discarded before its first step (a cluster
        # handed out a Database — which spawns its metrics emitter — and the
        # test ended without running the loop again) holds a never-started
        # coroutine; close it like cancel-before-start does, instead of
        # leaking a "coroutine was never awaited" warning at GC
        try:
            if not self._started and not self.done():
                self._coro.close()
        except AttributeError:
            pass  # partially-constructed task


class EventLoop:
    """Virtual-clock, priority-ordered, deterministic run loop.

    Event order is a pure function of (seed, program): the ready heap is
    keyed (time, -priority, seq) with seq breaking ties FIFO.  Time is
    virtual; in simulation it jumps instantly to the next timer (Sim2's
    time model), while RealClockDriver (below) maps it onto the wall clock
    for production use — the same seam as INetwork (flow/network.h:192).
    """

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, int, Callable[[], None]]] = []
        self._now = 0.0
        self._seq = 0
        self._stopped = False
        self.tasks_run = 0
        # flow-profiler analog (the reference's --profiler / slow-task
        # sampler): when enabled, wall-clock busy time accumulates per task
        # priority and steps slower than slow_task_threshold are recorded
        self.profile = False
        self.slow_task_threshold = 0.05
        self.busy_s_by_priority: dict[int, float] = {}
        self.slow_tasks: list[tuple[float, int, float]] = []  # (t, pri, dur)
        # Net2 slow-task watch (Net2.actor.cpp checkForSlowTask): when a
        # TraceCollector is bound here, any single callback whose host wall
        # time exceeds slow_task_trace_threshold traces a SEV_WARN SlowTask
        # event — a run-loop stall is invisible to virtual time, so only
        # the wall clock can see it.  Observability only: the measurement
        # never feeds back into scheduling, so determinism holds.
        self.slow_task_trace = None
        self.slow_task_trace_threshold = 0.5

    # -- time --------------------------------------------------------------
    def now(self) -> float:
        return self._now

    def delay(self, seconds: float, priority: int = TaskPriority.DEFAULT_DELAY) -> Future:
        """Future firing `seconds` of virtual time from now (flow delay())."""
        if seconds < 0:
            seconds = 0
        p = Promise()
        self._at(self._now + seconds, priority, lambda: p.send(None) if not p.future.done() else None)
        return p.future

    def yield_(self, priority: int = TaskPriority.DEFAULT_DELAY) -> Future:
        """Reschedule behind same-or-higher-priority ready work (flow yield())."""
        return self.delay(0, priority)

    # -- scheduling --------------------------------------------------------
    def _at(self, when: float, priority: int, fn: Callable[[], None]) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (when, -priority, self._seq, fn))

    def _ready(self, priority: int, fn: Callable[[], None]) -> None:
        self._at(self._now, priority, fn)

    def spawn(
        self,
        coro: Coroutine,
        priority: int = TaskPriority.DEFAULT_ENDPOINT,
        name: str = "",
    ) -> Task:
        task = Task(coro, self, priority, name or getattr(coro, "__name__", "task"))
        self._ready(priority, task._step)
        return task

    # -- running -----------------------------------------------------------
    def run_one(self) -> bool:
        if not self._heap:
            return False
        when, negpri, _seq, fn = heapq.heappop(self._heap)
        if when > self._now:
            self._now = when
        self.tasks_run += 1
        watch = self.slow_task_trace
        if not self.profile and watch is None:
            fn()
            return True
        t0 = _time.perf_counter()
        fn()
        dur = _time.perf_counter() - t0
        pri = -negpri
        if self.profile:
            self.busy_s_by_priority[pri] = self.busy_s_by_priority.get(pri, 0.0) + dur
            if dur >= self.slow_task_threshold and len(self.slow_tasks) < 10_000:
                self.slow_tasks.append((self._now, pri, dur))
        if watch is not None and dur >= self.slow_task_trace_threshold:
            from .trace import SEV_WARN

            watch.trace(
                "SlowTask", severity=SEV_WARN,
                Priority=pri, DurationS=dur,
            )
        return True

    def run_until(self, fut: Future, deadline: float | None = None) -> Any:
        """Drive the loop until `fut` resolves (or virtual deadline)."""
        while not fut.done():
            if deadline is not None and self._now >= deadline:
                raise TimedOut(f"virtual deadline {deadline} reached at {self._now}")
            if not self.run_one():
                raise RuntimeError("deadlock: no runnable tasks but future pending")
        return fut.result()

    def drain(self, max_steps: int = 10_000_000) -> None:
        steps = 0
        while self._heap and steps < max_steps:
            self.run_one()
            steps += 1


class RealClockDriver:
    """Drives an EventLoop against the wall clock — the production twin of
    simulation's instant time jumps (the Net2 side of the Net2/Sim2 seam).

    Virtual time is anchored to a wall-clock origin; the driver sleeps until
    the next timer is due, then lets the loop run everything that is ready.
    Role code awaits the same loop API either way and cannot tell the worlds
    apart.
    """

    def __init__(self, loop: EventLoop) -> None:
        self.loop = loop
        self._origin = _time.monotonic() - loop.now()  # flowlint: ok wall-clock (the real-clock driver IS the wall)

    def run_until(self, fut: Future, wall_timeout: float | None = None) -> Any:
        start = _time.monotonic()  # flowlint: ok wall-clock (wall_timeout is a host bound by contract)
        while not fut.done():
            if wall_timeout is not None and _time.monotonic() - start > wall_timeout:  # flowlint: ok wall-clock (wall_timeout is a host bound by contract)
                raise TimedOut(f"wall timeout {wall_timeout}s")
            if not self.loop._heap:
                raise RuntimeError("deadlock: no runnable tasks but future pending")
            due = self.loop._heap[0][0]
            wall_due = self._origin + due
            delta = wall_due - _time.monotonic()  # flowlint: ok wall-clock (mapping virtual timers onto the wall)
            if delta > 0:
                _time.sleep(min(delta, 0.05))  # flowlint: ok wall-clock (the production sleep-until-due loop)
                continue
            self.loop.run_one()
        return fut.result()


class DeterministicRandom:
    """Seeded RNG behind every random decision (flow/DeterministicRandom.h):
    identical seed ⇒ identical simulation.  Thin, explicit wrapper so call
    sites can't accidentally reach the global `random` module."""

    def __init__(self, seed: int) -> None:
        self._r = _pyrandom.Random(seed)
        self.seed = seed

    def random(self) -> float:
        return self._r.random()

    def random_int(self, lo: int, hi: int) -> int:
        """Uniform in [lo, hi) — half-open like the reference randomInt."""
        return self._r.randrange(lo, hi)

    def random_choice(self, seq):
        return seq[self._r.randrange(len(seq))]

    def random_bytes(self, n: int) -> bytes:
        return self._r.randbytes(n)

    def shuffle(self, seq) -> None:
        self._r.shuffle(seq)

    def coinflip(self, p: float = 0.5) -> bool:
        return self._r.random() < p

    def random_unique_id(self) -> str:
        return f"{self._r.getrandbits(64):016x}"

    def split(self) -> "DeterministicRandom":
        """Child RNG with a derived seed (keeps streams independent)."""
        return DeterministicRandom(self._r.getrandbits(63))
