"""Fault-injection hooks — BUGGIFY (flow/flow.h:65, flow/FaultInjection.h).

In simulation, `buggify()` fires rare branches at random so seldom-taken
paths get exercised; in production it is always False.  Each call site is
independently enabled per run (the reference's per-SBVar state,
flow/flow.cpp:189-214): an enabled site fires with `fire_prob` each time.

Every query also feeds a per-site census — armed vs fired counts for the
run — which `emit_coverage(trace)` lands in the trace plane as
`CodeCoverage` events at sim teardown.  The reference's soak driver
(tools/soak.py there) merges those across seeds: a site that ARMS across a campaign but never
FIRES is exactly the "fault injection silently stopped injecting" failure
the reference's coveragetool discipline exists to catch.

Copy of the reference package's module, on the port's
`DeterministicRandom`: the same `enable` seed and the same queries give
the same armed and fired census in both packages.  The state is this
module's own; a simulation of the reference package arms the reference's
module, not this one."""

from __future__ import annotations

from .core import DeterministicRandom, TaskPriority

_state: dict[str, bool] = {}
_forced: dict[str, int] = {}
_fires: dict[str, int] = {}
_rng: DeterministicRandom | None = None
_enable_prob = 0.25
_fire_prob = 0.05


def enable(rng: DeterministicRandom, enable_prob: float = 0.25, fire_prob: float = 0.05) -> None:
    global _rng, _enable_prob, _fire_prob
    _rng = rng.split()
    _enable_prob = enable_prob
    _fire_prob = fire_prob
    _state.clear()
    _forced.clear()
    _fires.clear()


def disable() -> None:
    global _rng
    _rng = None
    _state.clear()
    _forced.clear()
    _fires.clear()


def force(site: str, times: int = 1) -> None:
    """Arm `site` to fire deterministically on its next `times` queries —
    the campaign/test hook that makes a rare site's firing *required*
    rather than probabilistic (the reference's per-SBVar forcing used by
    targeted simulation tests).  Only honored in simulation (enable()d);
    draws no randomness, so forcing never perturbs the seeded RNG stream."""
    _forced[site] = _forced.get(site, 0) + times


def is_enabled() -> bool:
    return _rng is not None


def buggify(site: str) -> bool:
    fired = _buggify(site)
    if fired:
        from .coverage import testcov

        testcov(f"buggify.{site}")
    return fired


def _buggify(site: str) -> bool:
    """True rarely, only in simulation.  `site` identifies the call site."""
    if _rng is None:
        return False
    n = _forced.get(site, 0)
    if n > 0:
        if n == 1:
            del _forced[site]
        else:
            _forced[site] = n - 1
        _fires[site] = _fires.get(site, 0) + 1
        return True
    if site not in _state:
        _state[site] = _rng.coinflip(_enable_prob)
    if _state[site] and _rng.coinflip(_fire_prob):
        _fires[site] = _fires.get(site, 0) + 1
        return True
    return False


def census() -> dict[str, dict]:
    """Per-site `{"armed": bool, "fires": int}` for every site queried,
    fired, OR force()d this run.  A forced site counts as armed even when
    its guard was never reached (pending `_forced` budget): something
    deliberately pointed the campaign at it, and armed-with-zero-fires is
    exactly the silently-stopped-injecting row the census exists to
    surface."""
    out: dict[str, dict] = {
        site: {"armed": armed, "fires": _fires.get(site, 0)}
        for site, armed in _state.items()
    }
    for site, n in _fires.items():
        if site not in out:
            out[site] = {"armed": True, "fires": n}
    for site in _forced:
        if site in out:
            out[site]["armed"] = True
        else:
            out[site] = {"armed": True, "fires": _fires.get(site, 0)}
    return out


def snapshot() -> dict:
    """Full module state, for save/restore around a test (conftest pairs
    this with coverage.snapshot so census numbers are per-test)."""
    return {
        "state": dict(_state),
        "forced": dict(_forced),
        "fires": dict(_fires),
        "rng": _rng,
        "enable_prob": _enable_prob,
        "fire_prob": _fire_prob,
    }


def restore(snap: dict) -> None:
    global _rng, _enable_prob, _fire_prob
    _state.clear()
    _state.update(snap["state"])
    _forced.clear()
    _forced.update(snap["forced"])
    _fires.clear()
    _fires.update(snap["fires"])
    _rng = snap["rng"]
    _enable_prob = snap["enable_prob"]
    _fire_prob = snap["fire_prob"]


def emit_coverage(trace) -> None:
    """One `CodeCoverage` trace event per queried site — the sim-teardown
    emission (CODE_COVERAGE_SCHEMA in control/status.py) the soak driver
    merges across seeds.  Emit BEFORE disable(): disabling clears the
    census."""
    for site, row in sorted(census().items()):
        trace.trace("CodeCoverage", Name=site, Kind="buggify",
                    Hits=row["fires"], Armed=row["armed"])


async def maybe_delay(loop, site: str, seconds: float = 0.02) -> None:
    """Rare injected delay at `site` (no-op outside simulation chaos mode).
    The classic BUGGIFY(delay(...)) pattern the reference sprinkles through
    every role (e.g. TLogServer.actor.cpp, MasterProxyServer.actor.cpp)."""
    if buggify(site):
        await loop.delay(seconds, TaskPriority.DEFAULT_ENDPOINT)
