"""Actor-discipline rules: the Flow actor compiler's checks.

dropped-future    a statement-level call to a known-async callable whose
                  coroutine is neither awaited, spawned, stored, nor
                  returned — Flow's "discarded Future" compile error
                  (flow/actorcompiler/ActorCompiler.cs).  The coroutine
                  object would silently never run.
swallowed-cancel  an `except:` / `except Exception:` / `except
                  BaseException:` inside a coroutine, around an await,
                  that can eat ActorCancelled without re-raising.  This
                  runtime's ActorCancelled inherits Exception (the
                  reference's actor_cancelled is a plain Error too), so a
                  broad handler turns a cancelled actor into a zombie that
                  keeps running past its cancellation point.
"""

from __future__ import annotations

import ast
from typing import Iterable

from . import Finding, LintContext, Rule, SourceFile, contains_await, walk_with_async


class DroppedFutureRule(Rule):
    id = "dropped-future"
    hint = ("await it, loop.spawn(...) it, or bind it — a bare call to an "
            "async def builds a coroutine that never runs")

    def check_file(self, sf: SourceFile, ctx: LintContext) -> Iterable[Finding]:
        # Matching is deliberately conservative — three resolvable shapes
        # (no cross-file attribute guessing, so `items.remove(x)` can never
        # collide with an unrelated `async def remove` elsewhere):
        #   1. `self.m()` where the enclosing class defines `async def m`
        #   2. `name()` where `name` is an async def in THIS file (and not
        #      also a sync def — a test's dropped `async def go` is dead too)
        #   3. `name()` where `name` was imported from a package module and
        #      is async-only package-wide
        # plus, per function, names bound to an async callable through
        # `functools.partial` / a trivial lambda / a method-alias
        # assignment (a former blind spot: the effect census sees through
        # those wrappers, so the dropped-future check must too).
        local_async = {
            n.name for n in ast.walk(sf.tree)
            if isinstance(n, ast.AsyncFunctionDef)
        }
        local_sync = {
            n.name for n in ast.walk(sf.tree)
            if isinstance(n, ast.FunctionDef)
        }
        imported = set()
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ImportFrom) and (
                node.level > 0 or (node.module or "").startswith("foundationdb_tpu_torch")
            ):
                for a in node.names:
                    if a.name in ctx.async_only_defs:
                        imported.add(a.asname or a.name)
        bare_known = (local_async - local_sync) | (imported - local_sync)

        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Expr) or not isinstance(node.value, ast.Call):
                continue
            fn = node.value.func
            if isinstance(fn, ast.Name) and fn.id in bare_known:
                yield self.finding(
                    sf, node.lineno,
                    f"result of async callable {fn.id!r} is dropped "
                    f"(coroutine constructed but never awaited/spawned)")

        for cls in ast.walk(sf.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            methods = {
                n.name for n in cls.body if isinstance(n, ast.AsyncFunctionDef)
            }
            if not methods:
                continue
            for node in ast.walk(cls):
                if (
                    isinstance(node, ast.Expr)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)
                    and isinstance(node.value.func.value, ast.Name)
                    and node.value.func.value.id == "self"
                    and node.value.func.attr in methods
                ):
                    yield self.finding(
                        sf, node.lineno,
                        f"result of async method "
                        f"'self.{node.value.func.attr}' is dropped "
                        f"(coroutine constructed but never awaited/spawned)")

        yield from self._check_wrapped(sf, bare_known)

    def _check_wrapped(self, sf: SourceFile, bare_known: set[str]
                       ) -> Iterable[Finding]:
        """Partial/lambda/alias shapes, per enclosing function scope.  Each
        function is scanned over its OWN body only (nested defs get their
        own iteration), so one dropped call reports exactly once."""
        from .dataflow import _async_binding_targets, _walk_no_defs_body

        for fn in ast.walk(sf.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            cls_async = self._enclosing_class_async(sf, fn)
            wrapped = _async_binding_targets(fn, bare_known, cls_async)
            for node in _walk_no_defs_body(fn):
                # bare statement call of a wrapped async: the coroutine the
                # wrapper builds is constructed and dropped
                if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
                    f = node.value.func
                    if isinstance(f, ast.Name) and f.id in wrapped:
                        yield self.finding(
                            sf, node.lineno,
                            f"result of async callable {f.id!r} (bound via "
                            f"partial/lambda/alias) is dropped")
                    # `functools.partial(async_f, ...)()` called and dropped
                    # in one statement
                    if isinstance(f, ast.Call) and self._is_partial_of(
                        f, bare_known, cls_async
                    ):
                        yield self.finding(
                            sf, node.lineno,
                            "result of partial-wrapped async callable is "
                            "dropped")
                # spawn(partial(...)) / spawn(async_f): spawn needs a
                # coroutine OBJECT; handing it the factory builds nothing —
                # the role's background work silently never starts
                if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute
                ) and node.func.attr == "spawn" and node.args:
                    a = node.args[0]
                    bad = None
                    if isinstance(a, ast.Call) and self._is_partial_of(
                        a, bare_known, cls_async
                    ):
                        bad = "a partial of an async callable"
                    elif isinstance(a, ast.Name) and (
                        a.id in bare_known or a.id in wrapped
                    ):
                        bad = f"the async callable {a.id!r} itself"
                    elif isinstance(a, ast.Attribute) and isinstance(
                        a.value, ast.Name
                    ) and a.value.id == "self" and a.attr in cls_async:
                        bad = f"the async method 'self.{a.attr}' itself"
                    if bad is not None:
                        yield self.finding(
                            sf, node.lineno,
                            f"spawn() received {bad}, not a coroutine — "
                            f"call it: spawn(f(...))",
                            hint="spawn takes the coroutine object; invoke "
                                 "the callable (or the partial) first")

    @staticmethod
    def _is_partial_of(call: ast.Call, bare_known: set[str],
                       cls_async: set[str]) -> bool:
        f = call.func
        is_partial = (
            (isinstance(f, ast.Name) and f.id == "partial")
            or (isinstance(f, ast.Attribute) and f.attr == "partial")
        )
        if not is_partial or not call.args:
            return False
        a0 = call.args[0]
        if isinstance(a0, ast.Name) and a0.id in bare_known:
            return True
        return (
            isinstance(a0, ast.Attribute)
            and isinstance(a0.value, ast.Name)
            and a0.value.id == "self"
            and a0.attr in cls_async
        )

    @staticmethod
    def _enclosing_class_async(sf: SourceFile, fn: ast.AST) -> set[str]:
        for cls in ast.walk(sf.tree):
            if isinstance(cls, ast.ClassDef) and any(
                n is fn for n in ast.walk(cls)
            ):
                return {
                    n.name for n in cls.body
                    if isinstance(n, ast.AsyncFunctionDef)
                }
        return set()


_BROAD = {"Exception", "BaseException"}


def _catches_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except
    names = []
    if isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    elif isinstance(t, ast.Name):
        names = [t.id]
    return bool(set(names) & _BROAD)


def _handles_cancel(handler: ast.ExceptHandler) -> bool:
    """A handler is fine if it re-raises (any `raise`) or visibly deals
    with ActorCancelled (isinstance check / re-wrap / mention)."""
    for n in ast.walk(handler):
        if isinstance(n, ast.Raise):
            return True
        if isinstance(n, ast.Name) and n.id == "ActorCancelled":
            return True
        if isinstance(n, ast.Attribute) and n.attr == "ActorCancelled":
            return True
    return False


def _body_exits(handler: ast.ExceptHandler) -> bool:
    """Does the handler BODY re-raise or return?  (For a dedicated
    `except ActorCancelled:` handler, mentioning the name is not enough —
    its own type node mentions it — the body must actually stop the
    actor: `raise` propagates the cancel, `return` ends the coroutine.)"""
    for stmt in handler.body:
        for n in ast.walk(stmt):
            if isinstance(n, (ast.Raise, ast.Return)):
                return True
    return False


class SwallowedCancelRule(Rule):
    id = "swallowed-cancel"
    hint = ("add `except ActorCancelled: raise` above the broad handler, "
            "or re-raise inside it")

    def check_file(self, sf: SourceFile, ctx: LintContext) -> Iterable[Finding]:
        if sf.scope != "package":
            return  # tests drive the loop from outside; their broad
            # handlers assert on failures rather than hiding a cancel
        for node, in_async in walk_with_async(sf.tree):
            if not isinstance(node, ast.Try) or not in_async:
                continue
            if not contains_await(
                ast.Module(body=node.body, type_ignores=[])
            ):
                continue  # no await point in the try body: cannot see cancel
            for h in node.handlers:
                if isinstance(h.type, ast.Name) and h.type.id == "ActorCancelled":
                    if not _body_exits(h):
                        yield self.finding(
                            sf, h.lineno,
                            "dedicated `except ActorCancelled:` neither "
                            "re-raises nor returns (cancelled actor keeps "
                            "running)",
                            hint="re-raise (or return) inside the handler")
                    break  # a dedicated handler shields later broad ones
                if _catches_broad(h) and not _handles_cancel(h):
                    yield self.finding(
                        sf, h.lineno,
                        "broad except around an await can swallow "
                        "ActorCancelled (cancelled actor keeps running)")
