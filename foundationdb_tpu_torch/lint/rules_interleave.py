"""Interleaving-hazard rules: what may change across a `wait()`.

Every `await` is a scheduling point where ANY other actor may run — the
reference re-validates versions, epochs, and shard ownership after every
resumption (storageserver.actor.cpp's wait_version/shard-move guards,
MasterProxyServer.actor.cpp's epoch/lock re-checks), and the actor
compiler makes those suspension points explicit precisely so this hazard
class is auditable.  These rules run the same audit over the Python tree
using the CFG + dataflow layer (lint/cfg.py, lint/dataflow.py):

stale-read-across-await         a local caching shared mutable state
                                (`v = self.attr`) is used after a
                                suspension without a re-read or a
                                token-compare guard
check-then-act-across-await     a conditional on shared state whose
                                guarded body suspends before mutating the
                                very state it tested (TOCTOU across the
                                scheduler)
epoch-guard-missing             an RPC handler that read a generation/
                                lock/epoch token replies after a
                                suspension without re-validating it
await-under-lock                suspending while holding a thread lock
                                (`with self._lock:`), re-acquiring a
                                non-reentrant async lock through a callee,
                                or writing lock-protected state outside
                                the lock
mutate-while-iterating-across-await   iterating shared mutable state
                                directly with a suspension in the loop
                                body (another actor can reshape the
                                collection mid-iteration)

Recognized guard idioms (rules stay silent):
  * re-read after the await (`v = self.attr` again — reaching defs see it)
  * token compare (`if v != self.attr:` / `if gen is not self.generation:`
    anywhere in the function exempts that cached variable)
  * pre-await ownership (check-then-SET before the first suspension — the
    `_moving`-flag mutex idiom — exempts that attr's later writes)
  * snapshot iteration (`for x in list(self.attr):` — the Call shape is
    naturally not a direct attr load)
"""

from __future__ import annotations

import ast
from typing import Iterable

from . import Finding, LintContext, Rule, SourceFile
from .cfg import CFG, async_functions
from .dataflow import (
    EffectCensus,
    _walk_no_defs_body,
    SharedStateCensus,
    attr_loads,
    attr_writes,
    expr_text,
    forward_analysis,
    name_loads,
    name_stores,
    reaching_defs,
    stmt_walk,
)

# attr names treated as generation/lock/epoch guard tokens (the epoch rule)
_GUARD_EXACT = frozenset({"locked", "_recovering", "lock_version"})
_GUARD_SUBSTR = ("epoch", "generation")


def is_guard_attr(name: str) -> bool:
    return name in _GUARD_EXACT or any(s in name for s in _GUARD_SUBSTR)


def _ctx_for(ctx: LintContext) -> tuple[EffectCensus, SharedStateCensus]:
    """The two censuses, cached on the LintContext (built once per run)."""
    eff = getattr(ctx, "_effect_census", None)
    if eff is None:
        eff = ctx._effect_census = EffectCensus(ctx)
    shared = getattr(ctx, "_shared_census", None)
    if shared is None:
        shared = ctx._shared_census = SharedStateCensus(ctx)
    return eff, shared


def _build_cfg(ctx: LintContext, fn: ast.AsyncFunctionDef, cls: str | None,
               eff: EffectCensus) -> CFG:
    cache = getattr(ctx, "_cfg_cache", None)
    if cache is None:
        cache = ctx._cfg_cache = {}
    cfg = cache.get(id(fn))
    if cfg is None:
        cfg = cache[id(fn)] = CFG(
            fn, suspends=lambda stmt: eff.stmt_suspends(stmt, cls)
        )
    return cfg


def first_suspension_line(body, cls, eff) -> int | None:
    """Line of the first suspending statement in a (recursively flattened)
    statement list, or None.  Nested def/class bodies are excluded — a
    nested coroutine's awaits suspend ITS frame, not the enclosing one
    (review pin: `with lock:` wrapping only a nested `async def` holds the
    lock across no suspension at all)."""
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if eff.stmt_suspends(stmt, cls):
            return stmt.lineno
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, attr, None)
            if sub:
                line = first_suspension_line(sub, cls, eff)
                if line is not None:
                    return line
        for h in getattr(stmt, "handlers", []):
            line = first_suspension_line(h.body, cls, eff)
            if line is not None:
                return line
    return None


def _compare_operands(fn: ast.AST) -> Iterable[tuple[set[str], set[str]]]:
    """(names, attr-texts) per comparison in the function — including
    `is`/`is not` identity checks — for token-compare guard detection."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Compare):
            continue
        operands = [node.left] + list(node.comparators)
        names = {o.id for o in operands if isinstance(o, ast.Name)}
        attrs = {
            expr_text(o) for o in operands if isinstance(o, ast.Attribute)
        }
        yield names, attrs


class StaleReadAcrossAwaitRule(Rule):
    id = "stale-read-across-await"
    hint = ("re-read the attribute after the await, or guard the use with "
            "a token compare (`if cached is not self.attr: bail`)")

    def check_file(self, sf: SourceFile, ctx: LintContext) -> Iterable[Finding]:
        if sf.scope != "package":
            return
        eff, shared = _ctx_for(ctx)
        mod_globals = shared.module_globals.get(sf.path, set())
        for fn, cls in async_functions(sf.tree):
            yield from self._check_fn(ctx, sf, fn, cls, eff, shared, mod_globals)

    def _check_fn(self, ctx, sf, fn, cls, eff, shared, mod_globals):
        # candidate defs: `v = self.attr` / `v = obj.attr` where attr is
        # REBOUND shared state (an in-place-only attr stays current through
        # the alias), or `v = MODULE_GLOBAL`
        sources: dict[int, tuple[str, str]] = {}  # lineno -> (var, source text)
        cand_vars: set[str] = set()
        for node in ast.walk(fn):
            if not (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
            ):
                continue
            val = node.value
            var = node.targets[0].id
            if isinstance(val, ast.Attribute) and isinstance(val.ctx, ast.Load):
                if val.attr in shared.rebound:
                    sources[node.lineno] = (var, expr_text(val))
                    cand_vars.add(var)
            elif isinstance(val, ast.Name) and val.id in mod_globals:
                sources[node.lineno] = (var, val.id)
                cand_vars.add(var)
        if not cand_vars:
            return
        # token-compare guard: a var compared against ANY attr expression
        # (or any name, for global tokens) is a consciously-managed cache
        guarded: set[str] = set()
        for names, attrs in _compare_operands(fn):
            for var in cand_vars & names:
                if attrs or (names - {var}) & mod_globals:
                    guarded.add(var)
        cand_vars -= guarded
        if not cand_vars:
            return
        cfg = _build_cfg(ctx, fn, cls, eff)
        ins = reaching_defs(cfg, cand_vars)
        line_info = {}  # (node_idx) -> (var, source)
        for n in cfg.nodes:
            info = sources.get(n.line)
            if info is not None and info[0] in name_stores(n.stmt):
                line_info[n.idx] = info
        # one finding per cached definition (its FIRST stale use): a
        # deliberate snapshot used ten times is one decision, not ten
        hits: dict[tuple[str, int], tuple[int, str]] = {}
        for n in cfg.nodes:
            state = ins[n.idx]
            if state is None:
                continue
            for var in name_loads(n.stmt) & cand_vars:
                for d in state.get(var, ()):  # frozenset[Def]
                    if not d.crossed or d.node_idx not in line_info:
                        continue
                    _v, src = line_info[d.node_idx]
                    key = (var, d.node_idx)
                    if key not in hits or n.line < hits[key][0]:
                        hits[key] = (n.line, src)
        # anchored at the DEFINITION: that is where the caching decision
        # lives, where the fix (re-read / guard) applies, and where a
        # deliberate-snapshot suppression reads naturally
        for (var, def_idx), (line, src) in sorted(
            hits.items(), key=lambda kv: cfg.nodes[kv[0][1]].line
        ):
            yield self.finding(
                sf, cfg.nodes[def_idx].line,
                f"{var!r} caches shared state `{src}` across an await "
                f"(first stale use: line {line}) — re-read or guard it")


class CheckThenActAcrossAwaitRule(Rule):
    id = "check-then-act-across-await"
    hint = ("re-check the condition after the await (the state may have "
            "changed while suspended), or take ownership before suspending")

    def check_file(self, sf: SourceFile, ctx: LintContext) -> Iterable[Finding]:
        if sf.scope != "package":
            return
        eff, shared = _ctx_for(ctx)
        for fn, cls in async_functions(sf.tree):
            # own body only: a nested async def is ITS OWN entry in
            # async_functions — re-walking it here would double-report
            for node in _walk_no_defs_body(fn):
                if isinstance(node, ast.If):
                    yield from self._check_branch(
                        sf, node, node.body, cls, eff, shared)

    def _flatten(self, body):
        """Body statements in source order, descending into nested
        compounds (an approximation of execution order good enough for
        the in-body scan); nested defs excluded."""
        for stmt in body:
            yield stmt
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr, None)
                if sub and not isinstance(stmt, (ast.FunctionDef,
                                                 ast.AsyncFunctionDef)):
                    yield from self._flatten(sub)
            for h in getattr(stmt, "handlers", []):
                yield from self._flatten(h.body)

    def _check_branch(self, sf, if_node, body, cls, eff, shared):
        tested = {
            r for r in attr_loads(if_node) if r.attr in shared.mutable
        }
        if not tested:
            return
        tested_attrs = {r.attr for r in tested}
        seen_suspend = False
        owned: set[str] = set()       # written before the first suspension
        fresh: set[str] = set()       # attrs read since the last suspension
        reported = False
        for stmt in self._flatten(body):
            reads = {r.attr for r in attr_loads(stmt)}
            writes = {
                w.attr for w in attr_writes(stmt)
            }
            # census-known self-method calls mutate their summary's attrs
            for node in stmt_walk(stmt):
                if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute
                ) and isinstance(node.func.value, ast.Name) \
                        and node.func.value.id == "self":
                    writes |= eff.method_mutates(cls, node.func.attr) & tested_attrs
            suspends_here = eff.stmt_suspends(stmt, cls)
            if not seen_suspend:
                owned |= writes
            elif not reported:
                hit = sorted((writes & tested_attrs) - owned - fresh - reads)
                if hit:
                    reported = True
                    yield self.finding(
                        sf, stmt.lineno,
                        f"`{hit[0]}` was tested (line {if_node.lineno}) and "
                        f"is mutated here after an await without re-checking "
                        f"— the tested condition may no longer hold")
            fresh |= reads
            if suspends_here:
                seen_suspend = True
                fresh = set()


class EpochGuardMissingRule(Rule):
    id = "epoch-guard-missing"
    hint = ("re-read the generation/lock/epoch token after the last await "
            "before replying (the epoch may have ended while suspended)")

    def check_file(self, sf: SourceFile, ctx: LintContext) -> Iterable[Finding]:
        if sf.scope != "package":
            return
        eff, _shared = _ctx_for(ctx)
        for fn, cls in async_functions(sf.tree):
            yield from self._check_fn(ctx, sf, fn, cls, eff)

    def _guard_attrs(self, stmt) -> set[str]:
        # only `self.X` tokens: a guard is the HANDLER'S OWN epoch/lock
        # state — request-payload fields named `epoch` are data, not guards
        out = set()
        for r in attr_loads(stmt):
            if r.recv == "self" and is_guard_attr(r.attr):
                out.add(r.attr)
        return out

    def _check_fn(self, ctx, sf, fn, cls, eff):
        # only RPC-handler-shaped functions: they call <req>.reply(...)
        reply_lines = {
            n.lineno for n in ast.walk(fn)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr in ("reply", "reply_error")
        }
        if not reply_lines:
            return
        uses_guards = any(
            True for node in ast.walk(fn)
            if isinstance(node, ast.Attribute) and is_guard_attr(node.attr)
            and isinstance(node.value, ast.Name) and node.value.id == "self"
        )
        if not uses_guards:
            return
        cfg = _build_cfg(ctx, fn, cls, eff)
        # freshness lattice per guard attr: set of states drawn from
        # {"fresh", "stale"}; absence = never read.  Reads/writes make an
        # attr fresh; a suspension turns fresh -> stale.
        def transfer(node, in_state):
            state = dict(in_state)
            touched = self._guard_attrs(node.stmt) | {
                w.attr for w in attr_writes(node.stmt)
                if w.recv == "self" and is_guard_attr(w.attr)
            }
            # reads in this statement happen before its own suspension
            # completes... conservatively: a suspending statement leaves
            # every guard stale AFTER it, then its own writes re-freshen
            if node.suspends:
                state = {
                    a: frozenset(
                        {"stale" if s == "fresh" else s for s in states}
                    )
                    for a, states in state.items()
                }
                for a in {w.attr for w in attr_writes(node.stmt)
                          if w.recv == "self" and is_guard_attr(w.attr)}:
                    state[a] = frozenset({"fresh"})
            else:
                for a in touched:
                    state[a] = frozenset({"fresh"})
            return state

        def merge(a, b):
            out = dict(a)
            for k, v in b.items():
                out[k] = out.get(k, frozenset()) | v
            return out

        ins = forward_analysis(cfg, {}, transfer, merge)
        # one finding per guard attr per handler (its first stale reply):
        # the fix — re-validating after resumption — is one edit
        hits: dict[str, int] = {}
        for n in cfg.nodes:
            if n.line not in reply_lines or ins[n.idx] is None:
                continue
            has_reply_call = any(
                isinstance(x, ast.Call) and isinstance(x.func, ast.Attribute)
                and x.func.attr in ("reply", "reply_error")
                for x in stmt_walk(n.stmt)
            )
            if not has_reply_call:
                continue
            # guards read in the SAME statement as the reply are fresh
            same_stmt = self._guard_attrs(n.stmt)
            for attr, states in sorted(ins[n.idx].items()):
                if attr in same_stmt:
                    continue
                if "stale" in states and (
                    attr not in hits or n.line < hits[attr]
                ):
                    hits[attr] = n.line
        for attr, line in sorted(hits.items(), key=lambda kv: kv[1]):
            yield self.finding(
                sf, line,
                f"handler replies with guard `{attr}` last read "
                f"before an await — re-validate it after resumption")


# lock-ish receiver names for the thread-lock shape
def _lockish(text: str) -> bool:
    low = text.lower()
    return any(s in low for s in ("lock", "mutex", "sem"))


class AwaitUnderLockRule(Rule):
    id = "await-under-lock"
    hint = ("never suspend while holding a non-reentrant lock: narrow the "
            "lock scope to the synchronous section, or use the run loop's "
            "single-threaded atomicity between awaits instead of a lock")

    def check_file(self, sf: SourceFile, ctx: LintContext) -> Iterable[Finding]:
        if sf.scope != "package":
            return
        eff, _shared = _ctx_for(ctx)
        for fn, cls in async_functions(sf.tree):
            yield from self._check_fn(sf, fn, cls, eff)
        # lock-protected-state discipline is per class, sync methods included
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_discipline(sf, node, eff)

    def _check_fn(self, sf, fn, cls, eff):
        for node in _walk_no_defs_body(fn):
            # (a) sync `with` over a lock-like context containing a
            # suspension: the whole single-threaded loop parks while a
            # REAL thread lock is held — a deadlock with any worker thread
            if isinstance(node, ast.With):
                holds = [
                    i.context_expr for i in node.items
                    if _lockish(expr_text(i.context_expr))
                ]
                if holds:
                    line = first_suspension_line(node.body, cls, eff)
                    if line is not None:
                        yield self.finding(
                            sf, line,
                            f"await while holding thread lock "
                            f"`{expr_text(holds[0])}` (line {node.lineno}) — "
                            f"the run loop parks with the lock held")
            # (b) `async with self.L:` awaiting a callee that re-acquires L
            if isinstance(node, ast.AsyncWith):
                held = {
                    i.context_expr.attr
                    for i in node.items
                    if isinstance(i.context_expr, ast.Attribute)
                    and isinstance(i.context_expr.value, ast.Name)
                    and i.context_expr.value.id == "self"
                }
                if not held:
                    continue
                for inner in ast.walk(node):
                    if isinstance(inner, ast.Await) and isinstance(
                        inner.value, ast.Call
                    ):
                        f = inner.value.func
                        if isinstance(f, ast.Attribute) and isinstance(
                            f.value, ast.Name
                        ) and f.value.id == "self":
                            re_acq = eff.method_acquires(cls, f.attr) & held
                            if re_acq:
                                yield self.finding(
                                    sf, inner.value.lineno,
                                    f"awaiting `self.{f.attr}()` which "
                                    f"re-acquires non-reentrant lock "
                                    f"`self.{sorted(re_acq)[0]}` already held "
                                    f"here — self-deadlock")

    def _check_discipline(self, sf, cls_node, eff):
        """(c) attrs consistently written under `async with self.L:` in
        some methods must not be written bare in an async method that also
        suspends — the lock protocol exists, this write skips it."""
        locked_writes: dict[str, set[str]] = {}  # attr -> lock names
        bare: list[tuple[ast.stmt, str, ast.AST]] = []
        for fn in cls_node.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            in_ctor = fn.name in ("__init__", "__post_init__")
            lock_regions: list[tuple[ast.AsyncWith, set[str]]] = []
            for node in ast.walk(fn):
                if isinstance(node, ast.AsyncWith):
                    names = {
                        i.context_expr.attr for i in node.items
                        if isinstance(i.context_expr, ast.Attribute)
                        and isinstance(i.context_expr.value, ast.Name)
                        and i.context_expr.value.id == "self"
                    }
                    if names:
                        lock_regions.append((node, names))

            def locks_holding(stmt) -> set[str]:
                out: set[str] = set()
                for region, names in lock_regions:
                    if any(s is stmt for s in ast.walk(region)):
                        out |= names
                return out

            # a bare write only matters in a method that can actually
            # SUSPEND: a never-suspending method runs atomically on the
            # single-threaded loop (exactly what the rule's hint
            # recommends over a lock), so its writes cannot interleave
            # with a lock holder
            fn_suspends = (
                isinstance(fn, ast.AsyncFunctionDef)
                and first_suspension_line(fn.body, cls_node.name, eff)
                is not None
            )
            for stmt in _walk_no_defs_body(fn):
                if not isinstance(stmt, ast.stmt):
                    continue
                for w in attr_writes(stmt):
                    if w.recv != "self":
                        continue
                    held = locks_holding(stmt)
                    if held:
                        locked_writes.setdefault(w.attr, set()).update(held)
                    elif not in_ctor and fn_suspends:
                        bare.append((stmt, w.attr, fn))
        for stmt, attr, fn in bare:
            locks = locked_writes.get(attr)
            if locks:
                yield self.finding(
                    sf, stmt.lineno,
                    f"`self.{attr}` is written under `async with "
                    f"self.{sorted(locks)[0]}` elsewhere but mutated here "
                    f"without the lock")


class MutateWhileIteratingRule(Rule):
    id = "mutate-while-iterating-across-await"
    hint = ("iterate a snapshot (`for x in list(self.attr):`) or re-resolve "
            "each element from the live map after every await")

    def check_file(self, sf: SourceFile, ctx: LintContext) -> Iterable[Finding]:
        if sf.scope != "package":
            return
        eff, shared = _ctx_for(ctx)
        for fn, cls in async_functions(sf.tree):
            for node in _walk_no_defs_body(fn):
                if not isinstance(node, (ast.For, ast.AsyncFor)):
                    continue
                ref = self._direct_shared_iter(node.iter, shared)
                if ref is None:
                    continue
                line = first_suspension_line(node.body, cls, eff)
                if line is not None:
                    yield self.finding(
                        sf, node.lineno,
                        f"iterating shared state `{ref}` directly with an "
                        f"await in the loop body (line {line}) — another "
                        f"actor can mutate it mid-iteration")

    def _direct_shared_iter(self, it: ast.expr, shared) -> str | None:
        """`self.attr` / `obj.attr` (optionally `.items()/.values()/
        .keys()`) where attr is mutable shared state; Call-wrapped
        snapshots (`list(...)`, `sorted(...)`) are naturally exempt."""
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute) \
                and it.func.attr in ("items", "values", "keys") and not it.args:
            it = it.func.value
        if isinstance(it, ast.Attribute) and isinstance(it.ctx, ast.Load):
            if it.attr in (shared.rebound | shared.inplace):
                return expr_text(it)
        return None
