"""Dataflow over the await-segmented CFG: effect census + def-use engine.

Three layers the interleaving rules (lint/rules_interleave.py) share:

  EffectCensus       per-callable summaries computed lazily across the
                     package: does a coroutine (transitively) reach a real
                     suspension point?  which `self.*` attrs does a method
                     mutate?  which locks does it take (`async with
                     self.X`)?  Name-based and conservative: an
                     unresolvable callee is assumed to suspend.  Async
                     callables bound through `functools.partial`, a
                     trivial lambda, or a method-alias assignment are
                     resolved to their underlying coroutine (a former
                     blind spot: a partial-wrapped coroutine must not read
                     as a plain call).

  SharedStateCensus  which attribute NAMES the package treats as mutable
                     shared state: rebound (assigned/deleted) outside a
                     constructor, or mutated in place (`.append(...)`,
                     `x.attr[i] = ...`) anywhere.  Attr names only
                     written in `__init__` are configuration, not shared
                     state — reading them across an await is fine.

  forward_analysis   a small worklist fixpoint runner over a CFG; the
                     rules instantiate it with their own lattices
                     (reaching definitions with a crossed-a-suspension
                     bit; guard-token freshness).

Everything is deliberately name-based (no type inference): the matching
is exact enough for this codebase's idioms, and both false directions are
bounded — a missed resolution degrades to "assume it suspends", and the
audited tree pins every rule's live behavior through fixtures.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator

from . import LintContext, SourceFile
from .cfg import CFG, _walk_no_defs, _header_exprs, iter_own_awaits

# method names that mutate their receiver in place (list/set/dict/deque
# surface) — used to decide an attr is shared MUTABLE state
_MUTATING_METHODS = frozenset({
    "append", "extend", "insert", "remove", "pop", "popleft", "appendleft",
    "clear", "update", "add", "discard", "setdefault", "sort", "reverse",
})

_CTOR_NAMES = frozenset({"__init__", "__post_init__", "__new__"})

# attr names exempt from the shared-mutable census: rebound only as
# construction-time WIRING (never while a cluster runs), so a local alias
# can never go stale across an await.  Each entry names its one writer.
_CENSUS_EXEMPT = frozenset({
    "loop",  # SimFilesystem.reattach rebinds it while REBUILDING a cluster
             # from a power-killed filesystem — before any actor runs
})


def expr_text(node: ast.expr) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - malformed nodes
        return ""


# -- per-statement read/write extraction --------------------------------------


def _own_exprs(stmt: ast.AST) -> list[ast.AST]:
    headers = _header_exprs(stmt)
    return [stmt] if headers is None else list(headers)


def stmt_walk(stmt: ast.AST) -> Iterator[ast.AST]:
    """Walk the statement's OWN expressions (compound headers only; no
    nested statements, no nested def/lambda bodies)."""
    for h in _own_exprs(stmt):
        yield from _walk_no_defs(h)


def name_loads(stmt: ast.AST) -> set[str]:
    return {
        n.id for n in stmt_walk(stmt)
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
    }


def name_stores(stmt: ast.AST) -> set[str]:
    out = set()
    for n in stmt_walk(stmt):
        if isinstance(n, ast.Name) and isinstance(n.ctx, (ast.Store, ast.Del)):
            out.add(n.id)
    return out


@dataclass(frozen=True)
class AttrRef:
    recv: str   # source text of the receiver ("self", "cc", "fs.inner")
    attr: str

    @property
    def text(self) -> str:
        return f"{self.recv}.{self.attr}"


def attr_loads(stmt: ast.AST) -> set[AttrRef]:
    return {
        AttrRef(expr_text(n.value), n.attr)
        for n in stmt_walk(stmt)
        if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load)
    }


def attr_writes(stmt: ast.AST) -> set[AttrRef]:
    """Attribute mutations this statement performs: rebinding stores
    (`x.a = / del x.a / x.a += ...`), subscript stores through an attr
    (`x.a[i] = ...`), and in-place mutating calls (`x.a.append(...)`)."""
    out: set[AttrRef] = set()
    for n in stmt_walk(stmt):
        if isinstance(n, ast.Attribute) and isinstance(n.ctx, (ast.Store, ast.Del)):
            out.add(AttrRef(expr_text(n.value), n.attr))
        elif isinstance(n, ast.Subscript) and isinstance(n.ctx, (ast.Store, ast.Del)):
            if isinstance(n.value, ast.Attribute):
                out.add(AttrRef(expr_text(n.value.value), n.value.attr))
        elif isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
            if n.func.attr in _MUTATING_METHODS and isinstance(
                n.func.value, ast.Attribute
            ):
                inner = n.func.value
                out.add(AttrRef(expr_text(inner.value), inner.attr))
    return out


# -- shared-state census -------------------------------------------------------


class SharedStateCensus:
    """Which attr NAMES count as mutable shared state, package-wide."""

    def __init__(self, ctx: LintContext) -> None:
        self.rebound: set[str] = set()    # assigned/deleted outside a ctor
        self.inplace: set[str] = set()    # mutated in place anywhere
        self.module_globals: dict[str, set[str]] = {}  # path -> names
        for sf in ctx.files:
            if sf.scope != "package":
                continue
            self._scan(sf)

    def _scan(self, sf: SourceFile) -> None:
        # module globals rebound via `global` somewhere in the same file
        toplevel = {
            t.id
            for node in sf.tree.body
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign))
            for t in (node.targets if isinstance(node, ast.Assign) else [node.target])
            if isinstance(t, ast.Name)
        }
        global_decls = {
            name
            for node in ast.walk(sf.tree)
            if isinstance(node, ast.Global)
            for name in node.names
        }
        self.module_globals[sf.path] = toplevel & global_decls

        def scan_func(fn: ast.AST, in_ctor: bool) -> None:
            def is_ctor_self(recv: ast.expr) -> bool:
                # building your own state inside __init__ is initialization,
                # not shared mutation
                return in_ctor and isinstance(recv, ast.Name) \
                    and recv.id in ("self", "cls")

            for node in ast.walk(fn):
                if isinstance(node, ast.Attribute) and isinstance(
                    node.ctx, (ast.Store, ast.Del)
                ):
                    if not is_ctor_self(node.value) \
                            and node.attr not in _CENSUS_EXEMPT:
                        self.rebound.add(node.attr)
                elif isinstance(node, ast.Subscript) and isinstance(
                    node.ctx, (ast.Store, ast.Del)
                ):
                    if isinstance(node.value, ast.Attribute) \
                            and not is_ctor_self(node.value.value):
                        self.inplace.add(node.value.attr)
                elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                    if node.func.attr in _MUTATING_METHODS and isinstance(
                        node.func.value, ast.Attribute
                    ) and not is_ctor_self(node.func.value.value):
                        self.inplace.add(node.func.value.attr)

        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan_func(node, node.name in _CTOR_NAMES)

    @property
    def mutable(self) -> set[str]:
        return self.rebound | self.inplace


# -- effect census -------------------------------------------------------------


@dataclass
class EffectSummary:
    key: str                    # "Class.method" or "function"
    is_async: bool
    direct_suspend: bool        # awaits something unresolvable
    await_deps: set[str] = field(default_factory=set)
    call_deps: set[str] = field(default_factory=set)  # sync calls (suspend
    # cannot propagate through them — a sync call cannot await — but lock
    # acquisition summaries do)
    mutates_self: set[str] = field(default_factory=set)
    acquires: set[str] = field(default_factory=set)   # `async with self.X`
    suspends: bool = True       # resolved by the fixpoint


def _async_binding_targets(fn: ast.AST, async_names: set[str],
                           class_async: set[str]) -> set[str]:
    """Local names bound (once, unambiguously) to an async callable:
    `f = self.m` / `f = g` / `f = functools.partial(self.m, ...)` /
    `f = lambda: self.m(...)` — the alias/partial/lambda shapes the
    effect census must see through."""

    def is_async_expr(e: ast.expr) -> bool:
        if isinstance(e, ast.Name):
            return e.id in async_names
        if isinstance(e, ast.Attribute):
            return (
                isinstance(e.value, ast.Name)
                and e.value.id == "self"
                and e.attr in class_async
            )
        return False

    def wraps_async(e: ast.expr) -> bool:
        if is_async_expr(e):
            return True
        if isinstance(e, ast.Call):
            fn_ = e.func
            is_partial = (
                (isinstance(fn_, ast.Name) and fn_.id == "partial")
                or (isinstance(fn_, ast.Attribute) and fn_.attr == "partial")
            )
            if is_partial and e.args and is_async_expr(e.args[0]):
                return True
        if isinstance(e, ast.Lambda):
            b = e.body
            return isinstance(b, ast.Call) and is_async_expr(b.func)
        return False

    bound: dict[str, bool] = {}
    # own body only: a nested def's bindings are ITS scope, and leaking
    # them outward would mislabel an unrelated outer name (review pin)
    for node in _walk_no_defs_body(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
            node.targets[0], ast.Name
        ):
            name = node.targets[0].id
            w = wraps_async(node.value)
            # a name also bound to something non-async is ambiguous: drop it
            bound[name] = w if name not in bound else (bound[name] and w)
    return {n for n, ok in bound.items() if ok}


class EffectCensus:
    """Per-callable effect summaries with a transitive `suspends` bit."""

    def __init__(self, ctx: LintContext) -> None:
        self.summaries: dict[str, EffectSummary] = {}
        self._class_async: dict[str, set[str]] = {}  # class -> async methods
        for sf in ctx.files:
            if sf.scope != "package":
                continue
            self._scan_module(sf)
        self._fixpoint()

    # -- scanning -----------------------------------------------------------
    def _scan_module(self, sf: SourceFile) -> None:
        module_async = {
            n.name for n in ast.walk(sf.tree)
            if isinstance(n, ast.AsyncFunctionDef)
        }

        def handle(fn, cls: str | None) -> None:
            key = f"{cls}.{fn.name}" if cls else fn.name
            class_async = self._class_async.get(cls or "", set())
            s = EffectSummary(
                key=key, is_async=isinstance(fn, ast.AsyncFunctionDef),
                direct_suspend=False,
            )
            aliases = _async_binding_targets(fn, module_async, class_async)
            for node in _walk_no_defs_body(fn):
                if isinstance(node, ast.Await):
                    dep = self._resolve_callee(node.value, cls, module_async, aliases)
                    if dep is None:
                        s.direct_suspend = True
                    else:
                        s.await_deps.add(dep)
                elif isinstance(node, (ast.AsyncFor, ast.AsyncWith)):
                    s.direct_suspend = True
                elif isinstance(node, ast.Call):
                    dep = self._resolve_callee(node, cls, module_async, aliases)
                    if dep is not None:
                        s.call_deps.add(dep)
                if isinstance(node, ast.AsyncWith):
                    for item in node.items:
                        ce = item.context_expr
                        if isinstance(ce, ast.Attribute) and isinstance(
                            ce.value, ast.Name
                        ) and ce.value.id == "self":
                            s.acquires.add(ce.attr)
            for stmt in ast.walk(fn):
                if isinstance(stmt, ast.stmt):
                    for w in attr_writes(stmt):
                        if w.recv == "self":
                            s.mutates_self.add(w.attr)
            # duplicate keys (same-named classes/functions across modules):
            # merge conservatively — suspension and effects OR together
            prev = self.summaries.get(key)
            if prev is not None:
                prev.direct_suspend |= s.direct_suspend
                prev.await_deps |= s.await_deps
                prev.call_deps |= s.call_deps
                prev.mutates_self |= s.mutates_self
                prev.acquires |= s.acquires
                prev.is_async |= s.is_async
            else:
                self.summaries[key] = s

        def rec(node: ast.AST, cls: str | None) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    self._class_async.setdefault(child.name, set()).update(
                        n.name for n in child.body
                        if isinstance(n, ast.AsyncFunctionDef)
                    )
                    rec(child, child.name)
                elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    handle(child, cls)
                    rec(child, cls)
                else:
                    rec(child, cls)

        # two passes so self-method resolution sees every class's methods
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                self._class_async.setdefault(node.name, set()).update(
                    n.name for n in node.body
                    if isinstance(n, ast.AsyncFunctionDef)
                )
        rec(sf.tree, None)

    def _resolve_callee(self, expr: ast.expr, cls: str | None,
                        module_async: set[str], aliases: set[str]) -> str | None:
        """A summary key for the called/awaited expression, or None when it
        cannot be resolved (→ assume it suspends)."""
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Name):
                if f.id in aliases:
                    return None  # alias to async: runs it → suspends unknown
                return f.id  # plain name: resolved iff a summary exists
            if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
                if f.value.id == "self" and cls is not None:
                    return f"{cls}.{f.attr}"
        return None

    # -- fixpoint -----------------------------------------------------------
    def _fixpoint(self) -> None:
        # suspends: seeded pessimistically for direct suspenders, then
        # propagated through await deps; unknown dep → suspends.
        for s in self.summaries.values():
            s.suspends = s.direct_suspend
        changed = True
        while changed:
            changed = False
            for s in self.summaries.values():
                if s.suspends:
                    continue
                for dep in s.await_deps:
                    d = self.summaries.get(dep)
                    # a dep that is not an async def was awaited for the
                    # FUTURE it returns (wait_all, loop.delay wrappers) —
                    # that is a genuine suspension
                    if d is None or not d.is_async or d.suspends:
                        s.suspends = True
                        changed = True
                        break
        # acquires propagates through awaited AND sync calls (a helper that
        # takes the lock still takes it when called synchronously)
        changed = True
        while changed:
            changed = False
            for s in self.summaries.values():
                for dep in s.await_deps | s.call_deps:
                    d = self.summaries.get(dep)
                    if d is not None and not d.acquires <= s.acquires:
                        s.acquires |= d.acquires
                        changed = True

    # -- queries ------------------------------------------------------------
    def awaited_suspends(self, awaited: ast.expr, cls: str | None) -> bool:
        """Does awaiting this expression reach a real suspension point?
        Conservative: anything unresolvable suspends."""
        if isinstance(awaited, ast.Call):
            f = awaited.func
            key = None
            if isinstance(f, ast.Name):
                key = f.id
            elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                    and f.value.id == "self" and cls is not None:
                key = f"{cls}.{f.attr}"
            if key is not None:
                s = self.summaries.get(key)
                if s is not None and s.is_async:
                    return s.suspends
        return True

    def stmt_suspends(self, stmt: ast.stmt, cls: str | None) -> bool:
        """Suspension predicate for CFG construction: a statement suspends
        if any of its own awaits can reach the scheduler."""
        if isinstance(stmt, (ast.AsyncFor, ast.AsyncWith)):
            return True
        return any(
            self.awaited_suspends(a.value, cls) for a in iter_own_awaits(stmt)
        )

    def method_mutates(self, cls: str | None, method: str) -> set[str]:
        s = self.summaries.get(f"{cls}.{method}" if cls else method)
        return s.mutates_self if s is not None else set()

    def method_acquires(self, cls: str | None, method: str) -> set[str]:
        s = self.summaries.get(f"{cls}.{method}" if cls else method)
        return s.acquires if s is not None else set()


def _walk_no_defs_body(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function's body without entering nested defs/lambdas."""
    for child in ast.iter_child_nodes(fn):
        yield from _walk_no_defs(child)


# -- generic forward dataflow --------------------------------------------------


def forward_analysis(cfg: CFG, init, transfer: Callable, merge: Callable):
    """Worklist fixpoint.  Returns per-node IN states.

    `init` is the entry IN state; `transfer(node, in_state) -> out_state`;
    `merge(a, b) -> joined`.  States must support ==.
    """
    n = len(cfg.nodes)
    ins: list = [None] * n
    if cfg.entry is None:
        return ins
    ins[cfg.entry] = init
    work = [cfg.entry]
    # also seed unreachable-from-entry nodes? no: unreachable code keeps
    # IN=None and the rules skip it
    guard = 0
    while work:
        guard += 1
        if guard > 40 * n + 400:
            break  # pathological graph: bail, rules treat None as unknown
        idx = work.pop()
        node = cfg.nodes[idx]
        out = transfer(node, ins[idx])
        for s in node.succs:
            joined = out if ins[s] is None else merge(ins[s], out)
            if joined != ins[s]:
                ins[s] = joined
                if s not in work:
                    work.append(s)
    return ins


# -- reaching definitions with a crossed-suspension bit ------------------------


@dataclass(frozen=True)
class Def:
    node_idx: int     # CFG node of the definition
    crossed: bool     # some path from the def here crosses a suspension


def reaching_defs(cfg: CFG, tracked: set[str]):
    """For each CFG node: IN map var -> frozenset[Def] for the tracked
    variable names.  A Def's `crossed` bit is True when a suspension point
    lies on some path between the definition and this node."""

    def transfer(node, in_state):
        state = dict(in_state)
        if node.suspends:
            state = {
                v: frozenset(Def(d.node_idx, True) for d in defs)
                for v, defs in state.items()
            }
        stores = name_stores(node.stmt) & tracked
        for v in stores:
            state[v] = frozenset({Def(node.idx, False)})
        return state

    def merge(a, b):
        out = dict(a)
        for v, defs in b.items():
            out[v] = out.get(v, frozenset()) | defs
        return out

    return forward_analysis(cfg, {}, transfer, merge)
