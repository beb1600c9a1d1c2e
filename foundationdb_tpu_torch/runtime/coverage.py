"""Rare-path coverage accounting — the coveragetool / TEST() macro analog
(flow/UnitTest.h TEST(); the reference's coveragetool scrapes TEST("...")
sites and simulation asserts they were all hit across a test campaign).

Code marks a rare-but-important path with `testcov("name")`.  Counters are
process-global and cheap (a dict increment); tests assert that the paths a
run is supposed to exercise actually fired — the defense against
fault-injection code that silently stops injecting.  `emit_coverage(trace)`
lands the census in the trace plane as one `CodeCoverage` event per hit
name, as the reference does at sim teardown.

Copy of the reference package's module; the counters are this module's
own, apart from the reference's."""

from __future__ import annotations

_hits: dict[str, int] = {}


def testcov(name: str) -> None:
    """Mark a rare-path execution (the TEST("name") macro)."""
    _hits[name] = _hits.get(name, 0) + 1


def hits(name: str) -> int:
    return _hits.get(name, 0)


def all_hits() -> dict[str, int]:
    return dict(_hits)


def reset() -> None:
    _hits.clear()


def snapshot() -> dict[str, int]:
    """The current counters, for save/restore around a test."""
    return dict(_hits)


def restore(snap: dict[str, int]) -> None:
    _hits.clear()
    _hits.update(snap)


def census(baseline: dict[str, int] | None = None) -> dict[str, int]:
    """Hit counts, optionally as the DELTA over a `snapshot()` baseline —
    how one spec run / one campaign seed reports only its own hits when
    the process-global counters carry earlier runs' too."""
    if not baseline:
        return dict(_hits)
    out: dict[str, int] = {}
    for name, n in _hits.items():
        d = n - baseline.get(name, 0)
        if d > 0:
            out[name] = d
    return out


def emit_coverage(trace, baseline: dict[str, int] | None = None) -> None:
    """One `CodeCoverage` trace event per hit name (delta over `baseline`
    when given) — the sim-teardown emission the soak driver's census is
    built from in the reference.  A testcov site is 'armed' by definition: it has no
    per-run enable draw, so Armed is always True here (contrast
    buggify.emit_coverage, where armed-but-never-fired is the interesting
    row)."""
    for name, n in sorted(census(baseline).items()):
        trace.trace("CodeCoverage", Name=name, Kind="testcov",
                    Hits=n, Armed=True)
