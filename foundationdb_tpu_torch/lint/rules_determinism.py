"""Determinism rules: what a sim-reachable module may never touch.

Deterministic simulation's contract is that event order is a pure function
of (seed, program).  Anything that reads the host — wall clocks, the
global RNG, hash-ordered set iteration, threads — breaks seed
replayability for every soak campaign and chaos sweep.  These rules apply
to package scope only (tests drive the sim from outside and may use wall
time freely); genuinely-wall call sites (the real-network drivers, the
watchdog) annotate with a reasoned `# flowlint: ok <rule> (...)`.
"""

from __future__ import annotations

import ast
from typing import Iterable

from . import Finding, LintContext, Rule, SourceFile, from_imports, module_aliases

# time.* the bound clock replaces (loop.now() / loop.delay()); perf_counter
# is deliberately absent — phase-wall observability timers are host-measured
# by design and never feed back into scheduling (conflict/api.py)
_TIME_BANNED = {"time", "monotonic", "sleep", "time_ns", "monotonic_ns"}
_DATETIME_BANNED = {"now", "utcnow", "today"}


class WallClockRule(Rule):
    id = "wall-clock"
    hint = ("route through the bound clock (loop.now() / loop.delay() / the "
            "driver's wall_timeout) or suppress with the reason it is "
            "genuinely wall-clock")

    def check_file(self, sf: SourceFile, ctx: LintContext) -> Iterable[Finding]:
        if sf.scope != "package":
            return
        time_mods = module_aliases(sf.tree, "time")
        dt_mods = module_aliases(sf.tree, "datetime")
        dt_classes = {
            alias for _ln, name, alias in from_imports(sf.tree, "datetime")
            if name == "datetime"
        }
        for ln, name, _alias in from_imports(sf.tree, "time"):
            if name in _TIME_BANNED:
                yield self.finding(
                    sf, ln, f"`from time import {name}` in sim-reachable code")
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Attribute):
                continue
            v = node.value
            if isinstance(v, ast.Name) and v.id in time_mods \
                    and node.attr in _TIME_BANNED:
                yield self.finding(
                    sf, node.lineno,
                    f"wall clock `{v.id}.{node.attr}` in sim-reachable code")
            if node.attr in _DATETIME_BANNED and (
                (isinstance(v, ast.Name) and v.id in dt_classes)
                or (isinstance(v, ast.Attribute) and v.attr == "datetime"
                    and isinstance(v.value, ast.Name) and v.value.id in dt_mods)
            ):
                yield self.finding(
                    sf, node.lineno,
                    f"wall clock `datetime.{node.attr}` in sim-reachable code")


class UnseededRandomRule(Rule):
    id = "unseeded-random"
    hint = ("draw from the cluster's DeterministicRandom (rng.split() for "
            "an independent stream); iterate sets via sorted(...)")

    # random-module attrs that are fine: seeded generator CLASS construction
    _RANDOM_OK = {"Random", "SystemRandom"}  # SystemRandom would be flagged
    # by name below; Random(seed) is the one legitimate surface

    def check_file(self, sf: SourceFile, ctx: LintContext) -> Iterable[Finding]:
        if sf.scope != "package":
            return
        rand_mods = module_aliases(sf.tree, "random")
        os_mods = module_aliases(sf.tree, "os")
        uuid_mods = module_aliases(sf.tree, "uuid")
        for ln, name, _alias in from_imports(sf.tree, "random"):
            if name != "Random":
                yield self.finding(
                    sf, ln,
                    f"`from random import {name}` draws from the global "
                    f"(unseeded) RNG stream")
        for ln, name, _alias in from_imports(sf.tree, "secrets"):
            yield self.finding(sf, ln, "`secrets` is entropy-seeded by design")
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "secrets":
                        yield self.finding(
                            sf, node.lineno,
                            "`secrets` is entropy-seeded by design")
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
                mod = node.value.id
                if mod in rand_mods and node.attr not in ("Random",):
                    yield self.finding(
                        sf, node.lineno,
                        f"global-RNG call `{mod}.{node.attr}` "
                        f"(unseeded, process-global state)")
                if mod in os_mods and node.attr == "urandom":
                    yield self.finding(
                        sf, node.lineno, "`os.urandom` is entropy, not a seed")
                if mod in uuid_mods and node.attr in ("uuid1", "uuid4"):
                    yield self.finding(
                        sf, node.lineno,
                        f"`uuid.{node.attr}` derives from host entropy/clock")
            # hash-ordered iteration: `for x in {..}` / `for x in set(...)`
            # feeds PYTHONHASHSEED-dependent order into whatever consumes it
            iters = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters = [node.iter]
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                iters = [g.iter for g in node.generators]
            for it in iters:
                if isinstance(it, ast.Set) or (
                    isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                    and it.func.id in ("set", "frozenset")
                ):
                    yield self.finding(
                        sf, it.lineno,
                        "iteration over a set literal/constructor is "
                        "hash-ordered (varies per process)",
                        hint="wrap in sorted(...) before iterating")


# Modules allowed to touch threads: the device watchdog (bounded host-wall
# timeouts around PJRT calls), the input-pipeline packer (never runs under
# sim), the key encoder's thread-local scratch buffers (the packer calls
# encode_concat from its feeder thread, so the reuse pool must not be
# shared across threads), the native build lock, the soak campaign driver,
# and the rolling-bounce campaign driver (its load generator runs blocking
# gateway clients against real OS processes from worker threads — never
# sim-reachable).  Everything else must stay on the single-threaded run
# loop.
THREADING_ALLOWLIST = frozenset({
    "foundationdb_tpu_torch/conflict/supervisor.py",
    "foundationdb_tpu_torch/conflict/pipeline.py",
    "foundationdb_tpu_torch/conflict/native.py",
    "foundationdb_tpu_torch/keys.py",
    "foundationdb_tpu_torch/tools/soak.py",
    "foundationdb_tpu_torch/tools/bounce.py",
})

_THREAD_MODULES = {"threading", "_thread", "concurrent.futures", "multiprocessing"}


class ThreadingRule(Rule):
    id = "threading"
    hint = ("the runtime is single-threaded by contract; move the work onto "
            "the run loop, or extend the allowlist in "
            "lint/rules_determinism.py with the reason")

    def check_file(self, sf: SourceFile, ctx: LintContext) -> Iterable[Finding]:
        if sf.scope != "package" or sf.path in THREADING_ALLOWLIST:
            return
        for node in ast.walk(sf.tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                if m in _THREAD_MODULES or m.split(".")[0] in _THREAD_MODULES:
                    yield self.finding(
                        sf, node.lineno,
                        f"thread machinery (`{m}`) outside the allowlist")
