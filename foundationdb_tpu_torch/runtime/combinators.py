"""Future combinators — the genericactors.actor.h analog.

wait_all/wait_any/timeout/AsyncVar/AsyncTrigger/quorum/recurring cover the
combinator vocabulary the reference roles are written in
(flow/genericactors.actor.h: waitForAll, quorum, AsyncVar :660,
AsyncTrigger :694, recurring, timeoutError).

Copy of the reference package's module, on the port's event loop.
"""

from __future__ import annotations

from typing import Any, Awaitable, Callable, Iterable, Sequence

from .core import ActorCancelled, EventLoop, Future, Promise, TaskPriority, TimedOut


def wait_all(futures: Sequence[Future]) -> Future:
    """Resolves with a list of results once every input resolves; fails fast
    on the first error (waitForAll)."""
    out = Promise()
    n = len(futures)
    if n == 0:
        out.send([])
        return out.future
    remaining = [n]

    def on_done(f: Future) -> None:
        if out.future.done():
            return
        if f.exception() is not None:
            out.fail(f.exception())
            return
        remaining[0] -= 1
        if remaining[0] == 0:
            out.send([f.result() for f in futures])

    for f in futures:
        f.add_done_callback(on_done)
    return out.future


def wait_any(futures: Sequence[Future]) -> Future:
    """Resolves with (index, result) of the first to resolve (choose/when)."""
    out = Promise()

    def make_cb(i: int):
        def cb(f: Future) -> None:
            if out.future.done():
                return
            if f.exception() is not None:
                out.fail(f.exception())
            else:
                out.send((i, f.result()))

        return cb

    for i, f in enumerate(futures):
        f.add_done_callback(make_cb(i))
    return out.future


def quorum(futures: Sequence[Future], count: int) -> Future:
    """Resolves once `count` inputs succeed; fails when success becomes
    impossible (flow quorum / smartQuorum)."""
    out = Promise()
    state = {"ok": 0, "err": 0}
    n = len(futures)
    if count > n:
        raise ValueError(f"quorum of {count} impossible with {n} futures")
    if count == 0:
        out.send(None)
        return out.future

    def cb(f: Future) -> None:
        if out.future.done():
            return
        if f.exception() is None:
            state["ok"] += 1
            if state["ok"] >= count:
                out.send(None)
        else:
            state["err"] += 1
            if n - state["err"] < count:
                out.fail(f.exception())

    for f in futures:
        f.add_done_callback(cb)
    return out.future


def timeout_error(loop: EventLoop, fut: Future, seconds: float) -> Future:
    """`fut` or TimedOut after virtual `seconds` (timeoutError)."""
    out = Promise()
    timer = loop.delay(seconds)

    def on_fut(f: Future) -> None:
        if out.future.done():
            return
        if f.exception() is not None:
            out.fail(f.exception())
        else:
            out.send(f.result())

    def on_timer(_f: Future) -> None:
        if not out.future.done():
            out.fail(TimedOut(f"timed out after {seconds}s"))

    fut.add_done_callback(on_fut)
    timer.add_done_callback(on_timer)
    return out.future


class AsyncVar:
    """Observable value: onChange() resolves when set() changes it
    (flow/genericactors.actor.h:660)."""

    def __init__(self, value: Any = None) -> None:
        self._value = value
        self._waiters: list[Promise] = []

    def get(self) -> Any:
        return self._value

    def set(self, value: Any) -> None:
        if value == self._value:
            return
        self._value = value
        waiters, self._waiters = self._waiters, []
        for w in waiters:
            w.send(value)

    def on_change(self) -> Future:
        p = Promise()
        self._waiters.append(p)
        return p.future


class AsyncTrigger:
    """Edge trigger: every waiter outstanding at trigger() time resumes
    (flow/genericactors.actor.h:694)."""

    def __init__(self) -> None:
        self._waiters: list[Promise] = []

    def trigger(self) -> None:
        waiters, self._waiters = self._waiters, []
        for w in waiters:
            w.send(None)

    def on_trigger(self) -> Future:
        p = Promise()
        self._waiters.append(p)
        return p.future


async def recurring(loop: EventLoop, fn: Callable[[], Any], interval: float,
                    priority: int = TaskPriority.DEFAULT_DELAY) -> None:
    """Call fn every `interval` of virtual time forever (flow recurring)."""
    while True:
        await loop.delay(interval, priority)
        fn()


async def broadcast(loop: EventLoop, refs: Sequence, payload: Any,
                    timeout: float = 1.0) -> list:
    """Fire the same request at every ref, gather replies best-effort
    (genericactors broadcast): unreachable peers yield None instead of
    failing the whole fan-out — the pattern behind pings, confirms, and
    registration sweeps."""

    async def one(ref):
        try:
            return await ref.get_reply(payload, timeout=timeout)
        except ActorCancelled:
            raise  # cancellation is not an unreachable peer
        except Exception:  # noqa: BLE001 — best-effort by contract
            return None

    return await wait_all(
        [loop.spawn(one(r), TaskPriority.DEFAULT_ENDPOINT) for r in refs]
    )
