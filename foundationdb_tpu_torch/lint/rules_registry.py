"""Registry-sync rules: every name-keyed surface stays two-way honest.

The reference regenerates option enums from one spec (vexillographer) and
diffs status docs against Schemas.cpp so surfaces can never drift.  These
rules apply that discipline statically:

knob-env-sync   every `FDBTPU_*` env string used anywhere exists in
                the ENV_KNOBS registry, and vice versa; where the linted
                tree has no registry (this package: it reads no
                environment), no package file names a `FDBTPU_*` string
codec-fuzz      every type registered with the wire codec registry
                (runtime/serialize.py register_codec) has a randomized
                builder in tests/test_codecs.py's BUILDERS, and no builder
                is stale
coverage-sites  literal testcov/buggify/maybe_delay site strings are
                unique per call site, never shadow the `buggify.` mirror
                namespace, and required-coverage manifests name real sites
                (migrated from an AST guard test)
warn-events     SEV_WARN+ trace event types are unique per call site and
                two-way synced with runtime/trace.py WARN_EVENT_TYPES
                (migrated from an AST guard test)
metrics-schema  `*Metrics` types emitted by spawn_role_metrics /
                spawn_wire_metrics are two-way synced with
                control/status.py ROLE_METRICS_SCHEMA (migrated)

Each rule anchors on the registry ASSIGNMENT (`ENV_KNOBS = {...}`,
`WARN_EVENT_TYPES = frozenset(...)`, ...) wherever it lives among the
linted files, so the fixture trees under tests/lint_fixtures/ can carry
their own miniature registries.  A rule whose anchor is absent from the
linted set skips silently (a partial-tree run must not misfire), but
knob-env-sync: without ENV_KNOBS it holds the package-scope files to no
env knob at all.  (Tests may name the reference package's switches: they
drive it.)
"""

from __future__ import annotations

import ast
import glob
import os
import re
from typing import Iterable

from . import Finding, LintContext, Rule, SourceFile

_ENV_RE = re.compile(r"^FDBTPU_[A-Z0-9_]+$")


def _find_assign(ctx: LintContext, name: str):
    """(SourceFile, assignment node) of the registry assignment — plain
    (`X = {...}`) or annotated (`X: dict = {...}`; the real registries are
    AnnAssign nodes) — or None."""
    for sf in ctx.files:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == name:
                        return sf, node
            elif (
                isinstance(node, ast.AnnAssign)
                and node.value is not None
                and isinstance(node.target, ast.Name)
                and node.target.id == name
            ):
                return sf, node
    return None


def _str_constants(node: ast.AST) -> list[tuple[str, int]]:
    return [
        (n.value, n.lineno) for n in ast.walk(node)
        if isinstance(n, ast.Constant) and isinstance(n.value, str)
    ]


class KnobEnvSyncRule(Rule):
    id = "knob-env-sync"
    hint = ("this package reads no environment: make the switch a keyword "
            "of the class it configures; where the tree carries an "
            "ENV_KNOBS registry, register the env var there or delete the "
            "dead entry")

    def check_project(self, ctx: LintContext) -> Iterable[Finding]:
        anchor = _find_assign(ctx, "ENV_KNOBS")
        if anchor is None:
            for sf in ctx.files:
                if sf.scope != "package":
                    continue
                for val, ln in _str_constants(sf.tree):
                    if _ENV_RE.match(val):
                        yield self.finding(
                            sf, ln, f"env knob {val!r} in a package that "
                                    f"reads no environment")
            return
        asf, anode = anchor
        registered = {}
        if isinstance(anode.value, ast.Dict):
            for k in anode.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    registered[k.value] = k.lineno
        span = range(anode.lineno, (anode.end_lineno or anode.lineno) + 1)
        used: dict[str, tuple[SourceFile, int]] = {}
        for sf in ctx.files:
            for val, ln in _str_constants(sf.tree):
                if sf is asf and ln in span:
                    continue  # the registry's own keys
                if _ENV_RE.match(val) and val not in used:
                    used[val] = (sf, ln)
        for name in sorted(set(used) - set(registered)):
            sf, ln = used[name]
            yield self.finding(
                sf, ln, f"env knob {name!r} is not in the ENV_KNOBS registry")
        for name in sorted(set(registered) - set(used)):
            yield self.finding(
                asf, registered[name],
                f"ENV_KNOBS entry {name!r} is used nowhere in the tree")


class CodecFuzzCoverageRule(Rule):
    id = "codec-fuzz"
    hint = ("add a randomized builder to the BUILDERS table (keyed by the "
            "class or by its name) "
            "(every registered wire type gets fuzzed), or drop the stale "
            "builder")

    def check_project(self, ctx: LintContext) -> Iterable[Finding]:
        anchor = _find_assign(ctx, "BUILDERS")
        if anchor is None:
            return
        bsf, bnode = anchor
        builders: dict[str, int] = {}
        if isinstance(bnode.value, ast.Dict):
            for k in bnode.value.keys:
                if isinstance(k, ast.Name):
                    builders[k.id] = k.lineno
                elif isinstance(k, ast.Constant) and isinstance(k.value, str):
                    builders[k.value] = k.lineno  # keyed by the type's name
        registered: dict[str, tuple[SourceFile, int]] = {}
        reg_names = {"register_codec", "register_empty_codec"}
        for sf in ctx.files:
            # local aliases: `reg = _wire.register_codec` (roles/types.py
            # registers through exactly this shape)
            aliases = set(reg_names)
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    v = node.value
                    vname = v.attr if isinstance(v, ast.Attribute) \
                        else getattr(v, "id", None)
                    if vname in reg_names:
                        aliases.add(node.targets[0].id)
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
                if name in aliases and len(node.args) >= 2 \
                        and isinstance(node.args[1], ast.Name) \
                        and node.args[1].id[:1].isupper():
                    registered.setdefault(node.args[1].id, (sf, node.lineno))
        if not registered:
            return
        for cls in sorted(set(registered) - set(builders)):
            sf, ln = registered[cls]
            yield self.finding(
                sf, ln, f"wire type {cls!r} registered but has no fuzz "
                        f"builder in BUILDERS")
        for cls in sorted(set(builders) - set(registered)):
            yield self.finding(
                bsf, builders[cls],
                f"BUILDERS entry {cls!r} matches no registered wire type")


def _site_call_sites(ctx: LintContext):
    """Every (kind, name, file, line) with a LITERAL coverage-site string;
    `maybe_delay(loop, site)` delegates to buggify (site in arg 1)."""
    out = []
    for sf in ctx.files:
        if sf.scope != "package":
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
            if name == "maybe_delay":
                arg = node.args[1] if len(node.args) > 1 else None
                kind = "buggify"
            elif name in ("testcov", "buggify"):
                arg = node.args[0] if node.args else None
                kind = name
            else:
                continue
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                out.append((kind, arg.value, sf, node.lineno))
    return out


class CoverageSiteRule(Rule):
    id = "coverage-sites"
    hint = ("one site name, one call site — a duplicated name merges two "
            "code paths into one census row; rename the newer site")

    @staticmethod
    def _is_pair_stem(stem: str) -> bool:
        """workloads/spec.py is_restarting_pair, re-stated as a text scan
        so the linter never imports the runtime: both halves on disk and
        a SaveAndKill stanza in the -1 half."""
        if not (os.path.exists(stem + "-1.txt")
                and os.path.exists(stem + "-2.txt")):
            return False
        try:
            with open(stem + "-1.txt", encoding="utf-8") as f:
                return any(
                    line.split(";")[0].strip().replace(" ", "")
                    == "testName=SaveAndKill"
                    for line in f)
        except OSError:
            return False

    def check_project(self, ctx: LintContext) -> Iterable[Finding]:
        sites = _site_call_sites(ctx)
        seen: dict[tuple[str, str], str] = {}
        for kind, name, sf, ln in sites:
            key = (kind, name)
            if key in seen:
                yield self.finding(
                    sf, ln,
                    f"duplicate {kind} site {name!r} (first at {seen[key]})")
            else:
                seen[key] = f"{sf.path}:{ln}"
            if kind == "testcov" and name.startswith("buggify."):
                yield self.finding(
                    sf, ln,
                    f"testcov site {name!r} shadows the `buggify.` mirror "
                    f"namespace (runtime/buggify.py fires mirror there)",
                    hint="rename the testcov site out of `buggify.`")
        # required-coverage manifests: every line names a real site, every
        # manifest pairs with its spec (tools/soak.py resolves the pairing)
        if ctx.spec_dir is None:
            return
        buggify_sites = {n for k, n, _sf, _ln in sites if k == "buggify"}
        testcov_sites = {n for k, n, _sf, _ln in sites if k == "testcov"}
        for mpath in sorted(glob.glob(
                os.path.join(ctx.spec_dir, "**", "*.coverage"),
                recursive=True)):
            rel = os.path.relpath(mpath, ctx.root).replace(os.sep, "/")
            stem = mpath[: -len(".coverage")]
            # a restarting pair (`<stem>-1.txt`/`<stem>-2.txt`) shares one
            # manifest at `<stem>.coverage` — tools/soak.py merges both
            # halves' census.  Mirror soak's predicate without importing
            # the runtime (this is a static tool): BOTH halves must exist
            # and the -1 half must actually carry a SaveAndKill stanza,
            # or the stem manifest is orphaned at runtime (soak maps
            # non-pairs to their own `<name>.coverage` files)
            if not os.path.exists(stem + ".txt") \
                    and not self._is_pair_stem(stem):
                yield Finding(
                    self.id, rel, 1,
                    f"{os.path.basename(mpath)} has no matching spec file",
                    "the convention is `<stem>.coverage` next to "
                    "`<stem>.txt` (or the full `<stem>-1.txt`/`-2.txt` "
                    "restarting pair)")
            with open(mpath, encoding="utf-8") as f:
                for i, line in enumerate(f, start=1):
                    name = line.strip()
                    if not name or name.startswith("#"):
                        continue
                    pool = buggify_sites if name.startswith("buggify.") else testcov_sites
                    bare = name[len("buggify."):] if name.startswith("buggify.") else name
                    if bare not in pool:
                        yield Finding(
                            self.id, rel, i,
                            f"manifest requires {name!r} but no such call "
                            f"site exists",
                            "a renamed site leaves an unsatisfiable "
                            "requirement; update the manifest")


def _warn_trace_sites(ctx: LintContext):
    """(event type, can-warn, SourceFile, line) for every literal-typed
    trace()/_trace_wire_error() call; conditional severities count (the
    event CAN warn), _trace_wire_error hardwires SEV_WARN."""
    sites = []
    for sf in ctx.files:
        if sf.scope != "package":
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
            if name not in ("trace", "_trace_wire_error"):
                continue
            if not node.args or not isinstance(node.args[0], ast.Constant) \
                    or not isinstance(node.args[0].value, str):
                continue
            warn = name == "_trace_wire_error"
            for kw in node.keywords:
                if kw.arg == "severity":
                    warn = warn or bool({
                        n.id for n in ast.walk(kw.value)
                        if isinstance(n, ast.Name)
                    } & {"SEV_WARN", "SEV_WARN_ALWAYS", "SEV_ERROR"})
            sites.append((node.args[0].value, warn, sf, node.lineno))
    return sites


class WarnEventRegistryRule(Rule):
    id = "warn-events"
    hint = ("register the event type in runtime/trace.py WARN_EVENT_TYPES "
            "(one call site per type), or delete the stale registry entry")

    def check_project(self, ctx: LintContext) -> Iterable[Finding]:
        anchor = _find_assign(ctx, "WARN_EVENT_TYPES")
        if anchor is None:
            return
        asf, anode = anchor
        registered = dict(_str_constants(anode.value))
        warn_sites = [(n, sf, ln) for n, w, sf, ln in _warn_trace_sites(ctx) if w]
        first: dict[str, str] = {}
        for n, sf, ln in warn_sites:
            if n in first:
                yield self.finding(
                    sf, ln,
                    f"WARN+ event type {n!r} has multiple call sites "
                    f"(first at {first[n]}) — silent shadowing in "
                    f"track_latest/cluster.messages")
            else:
                first[n] = f"{sf.path}:{ln}"
            if n not in registered:
                yield self.finding(
                    sf, ln,
                    f"WARN+ event type {n!r} not in WARN_EVENT_TYPES")
        for n in sorted(set(registered) - set(first)):
            yield self.finding(
                asf, registered[n],
                f"WARN_EVENT_TYPES entry {n!r} has no call site")


class MetricsSchemaSyncRule(Rule):
    id = "metrics-schema"
    hint = ("add the event type to control/status.py ROLE_METRICS_SCHEMA "
            "with its field specs, or drop the stale schema entry")

    def check_project(self, ctx: LintContext) -> Iterable[Finding]:
        anchor = _find_assign(ctx, "ROLE_METRICS_SCHEMA")
        if anchor is None:
            return
        asf, anode = anchor
        schema: dict[str, int] = {}
        if isinstance(anode.value, ast.Dict):
            for k in anode.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    schema[k.value] = k.lineno
        emitted: dict[str, tuple[SourceFile, int]] = {}
        for sf in ctx.files:
            if sf.scope != "package":
                continue
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
                if name not in ("spawn_role_metrics", "spawn_wire_metrics"):
                    continue
                for arg in node.args:
                    if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                            and arg.value.endswith("Metrics"):
                        emitted.setdefault(arg.value, (sf, node.lineno))
                if name == "spawn_wire_metrics":
                    emitted.setdefault("WireMetrics", (sf, node.lineno))
        if not emitted:
            # a single-file run over the anchor module alone is a partial
            # tree — skip; but a populated schema with NO emitters found
            # across other package files means the spawn_role_metrics /
            # spawn_wire_metrics scan anchor broke (or the schema is fully
            # stale), the exact silent-no-op the old AST-guard test failed
            # loudly on
            if schema and any(
                sf.scope == "package" and sf is not asf for sf in ctx.files
            ):
                yield self.finding(
                    asf, anode.lineno,
                    f"ROLE_METRICS_SCHEMA has {len(schema)} entries but no "
                    f"spawn_role_metrics/spawn_wire_metrics emitter was "
                    f"found anywhere in the linted tree",
                    hint="the emitter scan anchor broke (renamed spawn "
                         "helpers?) or the whole schema is stale")
            return
        for n in sorted(set(emitted) - set(schema)):
            sf, ln = emitted[n]
            yield self.finding(
                sf, ln, f"emitted metrics event {n!r} not in "
                        f"ROLE_METRICS_SCHEMA")
        for n in sorted(set(schema) - set(emitted)):
            yield self.finding(
                asf, schema[n],
                f"ROLE_METRICS_SCHEMA entry {n!r} is emitted nowhere")
