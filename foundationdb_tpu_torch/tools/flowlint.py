"""flowlint CLI — the actor-discipline static analyzer (docs/LINT.md).

    python -m foundationdb_tpu_torch.tools.flowlint
    python -m foundationdb_tpu_torch.tools.flowlint foundationdb_tpu_torch
    python -m foundationdb_tpu_torch.tools.flowlint --diff HEAD~1   # pre-commit

Exit 0 only when every finding is fixed, suppressed with a reasoned
`# flowlint: ok <rule> (...)`, or grandfathered in the committed baseline
AND no baseline entry has gone stale (zero-or-fail in both directions —
the ratchet can only tighten).  Also reachable as `cli lint`.

`--diff <rev>` is the fast pre-commit spelling: the ANALYSIS still runs
over the full tree (the cross-file censuses — effect summaries, shared
state, registries — are only correct with everything in view), but only
findings in files changed vs `rev` (plus untracked files) are REPORTED
and gate the exit code.

Copy of the reference package's tool on this package's lint/.  With no
paths it lints this package and its own tests, `tests/test_torch_*.py`.
Its baseline is its own, `foundationdb_tpu_torch/lint/baseline.json`, read
when it exists and written by `--write-baseline`; the reference's
`.flowlint-baseline.json` is never read or written here.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

from ..lint import (
    apply_baseline,
    default_rules,
    load_baseline,
    run_lint,
    save_baseline,
)

# repo root: tools/ -> foundationdb_tpu_torch/ -> the checkout
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_BASELINE = os.path.join(REPO_ROOT, "foundationdb_tpu_torch", "lint",
                                "baseline.json")


def default_paths() -> list[str]:
    """The package and its own tests (tests/test_torch_*.py)."""
    return [os.path.join(REPO_ROOT, "foundationdb_tpu_torch"),
            *sorted(glob.glob(os.path.join(REPO_ROOT, "tests", "test_torch_*.py")))]


def changed_files(rev: str, root: str) -> set[str] | None:
    """Repo-relative (forward-slash) paths changed vs `rev`, plus
    untracked files — the report filter behind `--diff`.  None when git
    cannot answer (not a repo, bad rev): the caller falls back to a full
    report rather than silently reporting nothing."""
    try:
        # --relative: findings carry --root-relative paths, and git must
        # speak the same dialect even when root is a subdir of the repo —
        # a toplevel-relative name would silently filter EVERYTHING out
        diff = subprocess.run(
            ["git", "diff", "--relative", "--name-only", rev, "--"],
            cwd=root, capture_output=True, text=True, timeout=30,
        )
        if diff.returncode != 0:
            return None
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=root, capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    out = {
        line.strip().replace(os.sep, "/")
        for line in diff.stdout.splitlines() if line.strip()
    }
    if untracked.returncode == 0:
        out |= {
            line.strip().replace(os.sep, "/")
            for line in untracked.stdout.splitlines() if line.strip()
        }
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="flowlint", description="actor-discipline static analyzer")
    ap.add_argument("paths", nargs="*", help="files/directories to lint")
    ap.add_argument("--root", default=REPO_ROOT,
                    help="paths in findings/baseline are relative to this")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline JSON (default: {DEFAULT_BASELINE} "
                         f"when it exists)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="grandfather the current findings and exit 0")
    ap.add_argument("--json", dest="as_json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("--diff", metavar="REV", default=None,
                    help="analyze the full tree but only REPORT (and gate "
                         "on) findings in files changed vs REV + untracked "
                         "files — the fast pre-commit run")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    rules = default_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.id:18s} {r.hint}")
        return 0
    if not args.paths:
        # the documented default surface — also what a bare `cli lint`
        # means, whatever flags ride along
        args.paths = default_paths()

    findings = run_lint(args.paths, root=args.root, rules=rules)

    baseline_path = args.baseline
    if baseline_path is None and os.path.exists(DEFAULT_BASELINE):
        baseline_path = DEFAULT_BASELINE
    if args.write_baseline:
        save_baseline(baseline_path or DEFAULT_BASELINE, findings)
        print(f"flowlint: baselined {len(findings)} findings into "
              f"{baseline_path or DEFAULT_BASELINE}")
        return 0
    baseline = load_baseline(baseline_path) if baseline_path else []
    new, old, stale = apply_baseline(findings, baseline)

    scope = ""
    if args.diff is not None:
        changed = changed_files(args.diff, args.root)
        if changed is None:
            print(f"flowlint: --diff {args.diff}: git could not resolve the "
                  f"rev; reporting the full tree", file=sys.stderr)
        else:
            new = [f for f in new if f.path in changed]
            stale = [b for b in stale if b["path"] in changed]
            scope = f" in {len(changed)} changed file(s) vs {args.diff}"

    if args.as_json:
        print(json.dumps({
            "new": [f.__dict__ for f in new],
            "baselined": [f.__dict__ for f in old],
            "stale_baseline": stale,
        }, indent=2))
    else:
        for f in new:
            print(f.render())
        for b in stale:
            print(f"{b['path']}:{b['line']}: [{b['rule']}] STALE baseline "
                  f"entry — the site no longer trips the rule; delete it "
                  f"from {baseline_path}")
        print(f"flowlint: {len(new)} new finding(s){scope}, {len(old)} baselined, "
              f"{len(stale)} stale baseline entr{'y' if len(stale) == 1 else 'ies'} "
              f"({len(rules)} rules)")
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
