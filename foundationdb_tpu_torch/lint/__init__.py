"""flowlint — actor-discipline static analysis for the whole tree.

The reference enforces its concurrency discipline at COMPILE time: the Flow
actor compiler (flow/actorcompiler/) rejects dropped futures, and the
codebase bans wall clocks / unseeded randomness / threads from anything
simulation can reach, because one stray `now()` breaks seed-replayability
for every chaos campaign.  This package is the Python port's analog: a
pluggable AST pass (one parse per file; every rule visits the shared trees)
with rules modeled on the actor compiler's checks and this repo's own
invariants (docs/LINT.md is the rule catalog).

Framework pieces:

  SourceFile    one parsed file: tree, lines, suppressions, scope
  LintContext   the shared cross-file view rules query (async-def census,
                enclosing-async map, spec dir, lazily computed)
  Rule          base class; per-file `check_file` and/or cross-file
                `check_project` hooks
  run_lint      discovery + parse + rule dispatch + suppression filtering
  Baseline      committed grandfather list: zero-unbaselined-or-fail, and
                a stale entry (file no longer trips the rule) ALSO fails —
                the ratchet can only tighten

Flow-sensitive layer ("flowcheck" — docs/LINT.md "Interleaving
hazards"): cfg.py builds per-function CFGs segmented at await points,
dataflow.py runs reaching-definitions across segments plus the lazy
cross-file effect/shared-state censuses, and rules_interleave.py hosts
the five interleaving-hazard rules on top.

Suppression syntax (a required reason keeps every escape hatch auditable):

  x = time.time()   # flowlint: ok wall-clock (probe budget is host wall)
  # flowlint: file ok wall-clock (campaign driver is wall-clock by design)

A reasonless or unknown-rule suppression is itself a finding (rule
`suppression`).  Files under a `lint_fixtures` directory are skipped by
discovery but treated as package-scope code when linted explicitly — the
fixture pairs in tests/lint_fixtures/ prove every rule fires.

Copy of the reference package's lint/, anchored on this package: a file
under `foundationdb_tpu_torch/` is package scope (`_scope_for`), and the
rules' path lists and import checks name this package's modules.  The
fixture pairs and the coverage manifests under tests/specs/ are shared
with the reference; discovery also skips `_build` (build outputs);
knob-env-sync checks a tree without an `ENV_KNOBS`
registry (this package has none) for any `FDBTPU_*` string at all
(lint/rules_registry.py).
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str
    hint: str = ""

    def key(self) -> tuple[str, str, int]:
        return (self.rule, self.path, self.line)

    def render(self) -> str:
        s = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            s += f"  (fix: {self.hint})"
        return s


_SUPPRESS_RE = re.compile(
    r"#\s*flowlint:\s*(?P<file>file\s+)?ok\s+"
    r"(?P<rules>[a-z0-9_\-]+(?:\s*,\s*[a-z0-9_\-]+)*)"
    r"\s*(?:\((?P<reason>[^)]*)\))?"
)


class SourceFile:
    """One file, parsed once; every rule visits the same tree."""

    def __init__(self, abspath: str, relpath: str, scope: str) -> None:
        self.abspath = abspath
        self.path = relpath.replace(os.sep, "/")
        self.scope = scope  # "package" | "tests" | "other"
        self.text = open(abspath, encoding="utf-8").read()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=relpath)
        # line -> set of rule ids; file-level set; plus malformed pragmas
        self.line_ok: dict[int, set[str]] = {}
        self.file_ok: set[str] = set()
        self.pragmas: list[tuple[int, set[str], str]] = []  # (line, rules, reason)
        self._scan_pragmas()

    def _scan_pragmas(self) -> None:
        pending: set[str] | None = None  # comment-only-line pragma covers next line
        for i, raw in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(raw)
            if m is None:
                if pending is not None and raw.strip() and not raw.lstrip().startswith("#"):
                    self.line_ok.setdefault(i, set()).update(pending)
                    pending = None
                continue
            rules = {r.strip() for r in m.group("rules").split(",")}
            reason = (m.group("reason") or "").strip()
            self.pragmas.append((i, rules, reason))
            if m.group("file"):
                self.file_ok.update(rules)
            elif raw.lstrip().startswith("#"):
                pending = rules  # standalone comment: suppresses the next code line
            else:
                self.line_ok.setdefault(i, set()).update(rules)

    def suppressed(self, rule: str, line: int) -> bool:
        return rule in self.file_ok or rule in self.line_ok.get(line, set())


class LintContext:
    """Cross-file view shared by every rule; expensive censuses are lazy."""

    def __init__(self, files: list[SourceFile], root: str,
                 spec_dir: str | None = None) -> None:
        self.files = files
        self.root = root
        self.spec_dir = spec_dir
        self._async_defs: set[str] | None = None
        self._sync_defs: set[str] | None = None

    def by_suffix(self, suffix: str) -> SourceFile | None:
        for sf in self.files:
            if sf.path.endswith(suffix):
                return sf
        return None

    def _census_defs(self) -> None:
        self._async_defs, self._sync_defs = set(), set()
        for sf in self.files:
            if sf.scope != "package":
                continue
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.AsyncFunctionDef):
                    self._async_defs.add(node.name)
                elif isinstance(node, ast.FunctionDef):
                    self._sync_defs.add(node.name)

    @property
    def async_only_defs(self) -> set[str]:
        """Names defined by `async def` in the package and NEVER by a sync
        def — the unambiguous targets of the dropped-future rule."""
        if self._async_defs is None:
            self._census_defs()
        return self._async_defs - self._sync_defs


class Rule:
    """One check.  `id` is the suppression/baseline key; `hint` is the
    one-line fix guidance findings carry."""

    id: str = ""
    hint: str = ""

    def check_file(self, sf: SourceFile, ctx: LintContext) -> Iterable[Finding]:
        return ()

    def check_project(self, ctx: LintContext) -> Iterable[Finding]:
        return ()

    def finding(self, sf: SourceFile, line: int, message: str,
                hint: str | None = None) -> Finding:
        return Finding(self.id, sf.path, line, message,
                       self.hint if hint is None else hint)


def module_aliases(tree: ast.Module, module: str) -> set[str]:
    """Local names bound to `module` by any import statement in the file."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module:
                    out.add(a.asname or a.name.split(".")[0])
    return out


def from_imports(tree: ast.Module, module: str) -> list[tuple[int, str, str]]:
    """(line, imported name, local alias) for `from module import ...`."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == module:
            for a in node.names:
                out.append((node.lineno, a.name, a.asname or a.name))
    return out


def walk_with_async(tree: ast.Module) -> Iterator[tuple[ast.AST, bool]]:
    """Yield (node, nearest-enclosing-function-is-async).  A sync def nested
    inside a coroutine runs atomically (no await points), so its body is
    NOT async context."""

    def rec(node: ast.AST, in_async: bool) -> Iterator[tuple[ast.AST, bool]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.AsyncFunctionDef):
                yield (child, in_async)
                yield from rec(child, True)
            elif isinstance(child, (ast.FunctionDef, ast.Lambda)):
                yield (child, in_async)
                yield from rec(child, False)
            else:
                yield (child, in_async)
                yield from rec(child, in_async)

    return rec(tree, False)


def contains_await(node: ast.AST) -> bool:
    """Does this subtree await, without descending into nested functions?
    (Cancellation is delivered at await points only.)"""

    def rec(n: ast.AST) -> bool:
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(child, (ast.Await, ast.AsyncFor, ast.AsyncWith)):
                return True
            if rec(child):
                return True
        return False

    return rec(node)


# -- discovery ----------------------------------------------------------------


def _scope_for(rel: str) -> str:
    parts = rel.replace(os.sep, "/").split("/")
    if "lint_fixtures" in parts:
        return "package"  # fixtures emulate package code (see module doc)
    if "foundationdb_tpu_torch" in parts:
        return "package"
    if "tests" in parts:
        return "tests"
    return "other"


def discover(paths: list[str], root: str) -> list[SourceFile]:
    seen: dict[str, SourceFile] = {}
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            cands = [p]
        else:
            cands = []
            for dirpath, dirnames, filenames in os.walk(p):
                # _build: the package's build outputs (gitignored), which
                # may hold a whole copy of the tree
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d not in ("__pycache__", "lint_fixtures", "_build")
                    and not d.startswith(".")
                )
                cands.extend(
                    os.path.join(dirpath, f)
                    for f in sorted(filenames) if f.endswith(".py")
                )
        for f in cands:
            if f.endswith(".py") and f not in seen:
                rel = os.path.relpath(f, root)
                seen[f] = SourceFile(f, rel, _scope_for(rel))
    return [seen[k] for k in sorted(seen)]


# -- the run ------------------------------------------------------------------


def default_rules() -> list[Rule]:
    from . import rules_async, rules_determinism, rules_interleave, rules_registry

    return [
        rules_async.DroppedFutureRule(),
        rules_async.SwallowedCancelRule(),
        rules_interleave.StaleReadAcrossAwaitRule(),
        rules_interleave.CheckThenActAcrossAwaitRule(),
        rules_interleave.EpochGuardMissingRule(),
        rules_interleave.AwaitUnderLockRule(),
        rules_interleave.MutateWhileIteratingRule(),
        rules_determinism.WallClockRule(),
        rules_determinism.UnseededRandomRule(),
        rules_determinism.ThreadingRule(),
        rules_registry.KnobEnvSyncRule(),
        rules_registry.CodecFuzzCoverageRule(),
        rules_registry.CoverageSiteRule(),
        rules_registry.WarnEventRegistryRule(),
        rules_registry.MetricsSchemaSyncRule(),
    ]


def run_lint(paths: list[str], root: str | None = None,
             rules: list[Rule] | None = None,
             spec_dir: str | None = "auto") -> list[Finding]:
    """Lint `paths`; returns UNSUPPRESSED findings, sorted.  Suppression
    pragmas are validated here (reason required, rule ids must exist) so a
    dead escape hatch can't silently hide anything."""
    root = root or os.getcwd()
    rules = default_rules() if rules is None else rules
    if spec_dir == "auto":
        cand = os.path.join(root, "tests", "specs")
        spec_dir = cand if os.path.isdir(cand) else None
    files = discover(paths, root)
    ctx = LintContext(files, root, spec_dir)
    known = {r.id for r in rules} | {"suppression"}

    findings: list[Finding] = []
    for rule in rules:
        for sf in files:
            findings.extend(rule.check_file(sf, ctx))
        findings.extend(rule.check_project(ctx))
    for sf in files:
        for line, prules, reason in sf.pragmas:
            if not reason:
                findings.append(Finding(
                    "suppression", sf.path, line,
                    "flowlint suppression without a reason",
                    "write `# flowlint: ok <rule> (<why this is safe>)`"))
            for r in prules - known:
                findings.append(Finding(
                    "suppression", sf.path, line,
                    f"flowlint suppression names unknown rule {r!r}",
                    "rule ids are listed by `flowlint --list-rules`"))

    by_path = {sf.path: sf for sf in files}
    out = []
    for f in findings:
        sf = by_path.get(f.path)  # manifest findings point at non-.py files
        if f.rule != "suppression" and sf is not None and sf.suppressed(f.rule, f.line):
            continue
        out.append(f)
    return sorted(set(out), key=lambda f: (f.path, f.line, f.rule, f.message))


# -- baseline -----------------------------------------------------------------


def load_baseline(path: str) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    return doc.get("findings", [])


def save_baseline(path: str, findings: list[Finding]) -> None:
    doc = {
        "comment": "flowlint grandfathered findings — shrink, never grow "
                   "(docs/LINT.md 'Baseline workflow')",
        "findings": [
            {"rule": f.rule, "path": f.path, "line": f.line}
            for f in findings
        ],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def apply_baseline(findings: list[Finding], baseline: list[dict],
                   ) -> tuple[list[Finding], list[Finding], list[dict]]:
    """(new, grandfathered, stale-entries).  Stale = a baseline entry whose
    (rule, path, line) no longer fires — the file was fixed, so the entry
    must be deleted (zero-or-fail in BOTH directions)."""
    keys = {f.key(): f for f in findings}
    bkeys = {(b["rule"], b["path"], int(b["line"])) for b in baseline}
    new = [f for k, f in sorted(keys.items()) if k not in bkeys]
    old = [f for k, f in sorted(keys.items()) if k in bkeys]
    stale = [
        {"rule": r, "path": p, "line": ln}
        for (r, p, ln) in sorted(bkeys - set(keys))
    ]
    return new, old, stale
