"""Per-function control-flow graphs with await-point segmentation.

The Flow actor compiler turns every `wait()` into an explicit state-machine
suspension (flow/actorcompiler/ActorCompiler.cs), which is what makes the
reference's interleaving discipline *auditable*: between two suspension
points an actor runs atomically, and any shared state it read before a
suspension may be stale after it.  This module gives the Python port the
same vantage: a statement-level CFG per (async) function, with each node
marked for whether executing it can SUSPEND the coroutine (yield to the
run loop), so the dataflow layer (lint/dataflow.py) can answer "does a
path from this definition to this use cross a scheduling point?".

Deliberate approximations (all on the safe, over-approximating side for
path existence — a path that cannot happen may exist in the graph, a path
that can happen always does):

  * nodes are whole statements; compound headers (`if`/`while`/`for`) are
    nodes representing their test/iterable evaluation,
  * every statement inside a `try` body gets an edge to every handler
    (an exception can arise anywhere),
  * `finally` bodies are placed on the fall-through path,
  * nested function/lambda bodies are NOT part of the enclosing graph
    (they run atomically relative to the enclosing coroutine).

Whether an `await` truly suspends is a question about the *awaited*
callee (awaiting a coroutine that never reaches a real suspension point
runs synchronously under this runtime, like calling it inline), so node
construction takes a `suspends` predicate — the effect census in
lint/dataflow.py supplies the real one, and `lambda node: True` is the
conservative default.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Callable, Iterator


@dataclass
class CFGNode:
    idx: int
    stmt: ast.stmt
    succs: list[int] = field(default_factory=list)
    # executing this statement can yield to the run loop (contains an
    # `await`/`async for`/`async with` the suspends-predicate confirms)
    suspends: bool = False

    @property
    def line(self) -> int:
        return self.stmt.lineno


def iter_own_awaits(stmt: ast.AST) -> Iterator[ast.expr]:
    """Await expressions belonging to `stmt` itself: not those inside
    nested statements with their own CFG nodes, and not those inside
    nested function/lambda bodies (which run as separate actors)."""
    headers = _header_exprs(stmt)
    if headers is None:  # simple statement: the whole subtree is "own"
        headers = [stmt]
    for h in headers:
        yield from (
            n for n in _walk_no_defs(h) if isinstance(n, ast.Await)
        )


def _walk_no_defs(node: ast.AST) -> Iterator[ast.AST]:
    """ast.walk that does not descend into nested defs/lambdas."""
    yield node
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield from _walk_no_defs(child)


def _header_exprs(stmt: ast.AST) -> list[ast.AST] | None:
    """The expression parts a compound statement's CFG node evaluates
    (its test/iterable/context), or None for a simple statement."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter, stmt.target]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [i.context_expr for i in stmt.items] + [
            i.optional_vars for i in stmt.items if i.optional_vars is not None
        ]
    if isinstance(stmt, ast.Try):
        return []  # the try keyword itself evaluates nothing
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return []  # a nested def/class STATEMENT runs no body code itself
    return None


class CFG:
    """Statement-level control-flow graph of one function body."""

    def __init__(self, func: ast.FunctionDef | ast.AsyncFunctionDef,
                 suspends: Callable[[ast.stmt], bool] | None = None) -> None:
        self.func = func
        self.nodes: list[CFGNode] = []
        self.entry: int | None = None
        self._suspends_pred = suspends or (lambda stmt: True)
        frag = self._build_seq(func.body, loop_ctx=None, try_ctx=())
        self.entry = frag[0][0] if frag[0] else None

    # -- construction -------------------------------------------------------
    def _new(self, stmt: ast.stmt, try_ctx: tuple) -> int:
        node = CFGNode(len(self.nodes), stmt)
        # a statement with its own awaits (or an async-for/async-with
        # header, which awaits by construction) is a candidate suspension
        # point; the predicate decides whether the awaited thing can
        # actually reach the scheduler
        own = any(True for _ in iter_own_awaits(stmt))
        if isinstance(stmt, (ast.AsyncFor, ast.AsyncWith)):
            own = True
        node.suspends = bool(own and self._suspends_pred(stmt))
        self.nodes.append(node)
        # an exception inside a try body can transfer to any handler
        for handler_entry in try_ctx:
            node.succs.append(handler_entry)
        return node.idx

    def _link(self, frm: list[int], to: int) -> None:
        for i in frm:
            if to not in self.nodes[i].succs:
                self.nodes[i].succs.append(to)

    def _build_seq(self, body: list[ast.stmt], loop_ctx, try_ctx
                   ) -> tuple[list[int], list[int]]:
        """Returns (entry_ids, open_exits).  loop_ctx is (head_idx,
        break_exits_list) of the innermost loop, for continue/break."""
        entries: list[int] = []
        exits: list[int] = []
        prev_exits: list[int] | None = None
        for stmt in body:
            e, x = self._build_stmt(stmt, loop_ctx, try_ctx)
            if not e:
                continue
            if prev_exits is None:
                entries = e
            else:
                for t in e:
                    self._link(prev_exits, t)
            prev_exits = x
            if not x:
                # terminal statement (return/raise/break/continue): the
                # rest of the suite is unreachable but still gets nodes
                prev_exits = []
        exits = prev_exits if prev_exits is not None else []
        return entries, exits

    def _build_stmt(self, stmt: ast.stmt, loop_ctx, try_ctx
                    ) -> tuple[list[int], list[int]]:
        if isinstance(stmt, ast.If):
            head = self._new(stmt, try_ctx)
            be, bx = self._build_seq(stmt.body, loop_ctx, try_ctx)
            oe, ox = self._build_seq(stmt.orelse, loop_ctx, try_ctx)
            exits: list[int] = []
            if be:
                self._link([head], be[0])
                exits += bx
            else:
                exits.append(head)
            if oe:
                self._link([head], oe[0])
                exits += ox
            else:
                exits.append(head)
            return [head], exits
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            head = self._new(stmt, try_ctx)
            breaks: list[int] = []
            be, bx = self._build_seq(stmt.body, (head, breaks), try_ctx)
            if be:
                self._link([head], be[0])
                self._link(bx, head)  # loop back edge
            else:
                self._link([head], head)
            oe, ox = self._build_seq(stmt.orelse, loop_ctx, try_ctx)
            exits = list(breaks)
            # `while True:` only leaves through breaks — a head→after edge
            # would fabricate a path that skips the body entirely (and with
            # it every redefinition the body performs), so it exists only
            # when the test can actually fail
            test_never_fails = (
                isinstance(stmt, ast.While)
                and isinstance(stmt.test, ast.Constant)
                and bool(stmt.test.value)
            )
            if oe:
                self._link([head], oe[0])
                exits += ox
            elif not test_never_fails:
                exits.append(head)
            return [head], exits
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            head = self._new(stmt, try_ctx)
            be, bx = self._build_seq(stmt.body, loop_ctx, try_ctx)
            if be:
                self._link([head], be[0])
                return [head], bx
            return [head], [head]
        if isinstance(stmt, ast.Try):
            # build handlers first so body nodes can point at them
            handler_frags = []
            for h in stmt.handlers:
                handler_frags.append(self._build_seq(h.body, loop_ctx, try_ctx))
            handler_entries = tuple(
                e[0] for e, _x in handler_frags if e
            )
            be, bx = self._build_seq(
                stmt.body, loop_ctx, try_ctx + handler_entries
            )
            ee, ex = self._build_seq(stmt.orelse, loop_ctx, try_ctx)
            exits = []
            if ee:
                self._link(bx, ee[0])
                exits += ex
            else:
                exits += bx
            for _e, x in handler_frags:
                exits += x
            fe, fx = self._build_seq(stmt.finalbody, loop_ctx, try_ctx)
            if fe:
                self._link(exits, fe[0])
                exits = fx
            entry = be[0] if be else (
                handler_entries[0] if handler_entries else (fe[0] if fe else None)
            )
            if entry is None:
                return [], []
            return [entry], exits
        # simple statement
        idx = self._new(stmt, try_ctx)
        if isinstance(stmt, (ast.Return, ast.Raise)):
            return [idx], []
        if isinstance(stmt, ast.Break):
            if loop_ctx is not None:
                loop_ctx[1].append(idx)
            return [idx], []
        if isinstance(stmt, ast.Continue):
            if loop_ctx is not None:
                self._link([idx], loop_ctx[0])
            return [idx], []
        return [idx], [idx]

    # -- queries ------------------------------------------------------------
    def suspension_lines(self) -> list[int]:
        return sorted({n.line for n in self.nodes if n.suspends})


def async_functions(tree: ast.Module) -> Iterator[tuple[ast.AsyncFunctionDef, str | None]]:
    """Every async def in a module with its enclosing class name (None for
    module-level functions).  Nested defs are visited too; their enclosing
    class is the lexical one."""

    def rec(node: ast.AST, cls: str | None) -> Iterator:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from rec(child, child.name)
            elif isinstance(child, ast.AsyncFunctionDef):
                yield (child, cls)
                yield from rec(child, cls)
            elif isinstance(child, (ast.FunctionDef, ast.Lambda)):
                yield from rec(child, cls)
            else:
                yield from rec(child, cls)

    return rec(tree, None)
