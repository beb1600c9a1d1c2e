"""Soak-campaign harness — the contrib/TestHarness + coveragetool analog.

The reference's test methodology is not one simulation but a CAMPAIGN:
thousands of seeds, each run in its own process with its own trace files,
aggregated into a report that (a) records every seed's verdict with a
one-line repro, and (b) asserts the rare paths the campaign exists to
exercise actually fired (`TEST()` / coveragetool: fault injection that
silently stops injecting must fail the campaign, not pass it quietly).

This driver runs a tests/specs/*.txt spec across N seeds in parallel
worker subprocesses.  Each seed gets its own artifact directory with
rolling trace files (`TraceFileSink`), a wall-clock deadline, and a
`result.json`; the per-run buggify/testcov census leaves each process as
`CodeCoverage` trace events (runtime/{buggify,coverage}.py emit them at
sim teardown), which is what this driver scrapes — coverage rides the
same trace plane as every other signal.  The campaign report (JSON +
rendered markdown) carries:

  - per-seed verdict (pass / fail / timeout / crash) with wall time,
  - the merged buggify + testcov coverage census (sites armed vs hit,
    per-seed and campaign-wide) checked against a required-coverage
    manifest (`<spec stem>.coverage` next to the spec, or
    --require-file),
  - for every non-passing seed an automatic triage block: the first
    SEV_ERROR/SEV_WARN events, the slowest sampled transaction via the
    trace_tool cross-process join, the SlowTask count, and the exact
    one-line repro command (the "unseed").

    python -m foundationdb_tpu_torch.tools.soak tests/specs/Spec.txt \
        --seeds 100 [--first-seed 3000] [--jobs 8] [--out DIR] \
        [--seed-deadline 300] [--sample-rate 1.0] [--keep-traces] \
        [--device cuda|cpu] [--force-fail-seed SEED]

Copy of the reference package's module, on the port's own modules, with
the reference's two environment switches as keywords (the port reads no
environment variable): `device=` (`--device`, default cuda) is the device
every worker passes to `workloads.spec.run_spec_file`, where a spec's
`backend=supervised` sets live, and a campaign on cuda raises before it
starts a worker when there is no card; `force_fail_seed=`
(`--force-fail-seed`) fails that seed after its run, the triage demo.  A
worker imports this package from its root whatever its working directory
holds, and inherits the parent's environment as it is.

Two more differences, so that a seed's census and metrics do not depend
on its process: a seed runs with the garbage collector off (after a
collection), since a collected process or transaction fires kill hooks
and frees cache bytes at moments the collector picks, and those differ
between a worker on the card and one on the CPU; and `result.json` also
carries the conflict-kernel launches the worker made (0 on the CPU).
"""

# flowlint: file ok wall-clock (campaign driver: seed deadlines and wall_s are host wall by design; determinism lives inside each seed subprocess)
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from typing import Any

from ..runtime.trace import SEV_ERROR, SEV_WARN

DEFAULT_FIRST_SEED = 3000


# ---------------------------------------------------------------------------
# census: per-seed collection + campaign merge + manifest check


def seed_census(testcov_baseline: dict[str, int] | None = None) -> dict:
    """THIS process's census (the in-process flavor, for tests that drive
    several sim runs in one interpreter): buggify per-site armed/fires +
    testcov hit counts, the latter optionally as a delta over a
    `coverage.snapshot()` baseline."""
    from ..runtime import buggify, coverage

    return {
        "buggify": buggify.census(),
        "testcov": coverage.census(testcov_baseline),
    }


def census_from_events(events: list[dict[str, Any]]) -> dict:
    """The same per-seed census shape rebuilt from `CodeCoverage` trace
    events — how a seed's census crosses its process boundary."""
    out: dict = {"buggify": {}, "testcov": {}}
    for ev in events:
        if ev.get("Type") != "CodeCoverage":
            continue
        if ev.get("Kind") == "buggify":
            row = out["buggify"].setdefault(
                ev["Name"], {"armed": False, "fires": 0}
            )
            row["armed"] = row["armed"] or bool(ev.get("Armed"))
            row["fires"] += int(ev.get("Hits", 0))
        else:
            out["testcov"][ev["Name"]] = (
                out["testcov"].get(ev["Name"], 0) + int(ev.get("Hits", 0))
            )
    return out


def merge_census(per_seed: dict[Any, dict]) -> dict:
    """Campaign-wide census over `{seed: seed_census()}`: for every
    buggify site, in how many seeds it ARMED vs actually FIRED (the
    armed-but-never-hit gap is the silently-stopped-injecting signal);
    for every testcov name, hit seeds + total hits."""
    merged: dict = {"buggify": {}, "testcov": {}}
    for _seed, c in per_seed.items():
        for site, row in c.get("buggify", {}).items():
            m = merged["buggify"].setdefault(
                site, {"armed_seeds": 0, "hit_seeds": 0, "fires": 0}
            )
            if row.get("armed"):
                m["armed_seeds"] += 1
            if row.get("fires"):
                m["hit_seeds"] += 1
            m["fires"] += row.get("fires", 0)
        for name, hits in c.get("testcov", {}).items():
            m = merged["testcov"].setdefault(name, {"hit_seeds": 0, "hits": 0})
            if hits:
                m["hit_seeds"] += 1
            m["hits"] += hits
    return merged


def check_required(merged: dict, required: list[str]) -> list[str]:
    """Manifest names never hit across the campaign.  `buggify.<site>`
    requires the buggify site to have FIRED somewhere (its firing is also
    mirrored into testcov under the same name); bare names are testcov."""
    missing = []
    for name in required:
        ok = merged["testcov"].get(name, {}).get("hits", 0) > 0
        if not ok and name.startswith("buggify."):
            row = merged["buggify"].get(name[len("buggify."):])
            ok = row is not None and row["fires"] > 0
        if not ok:
            missing.append(name)
    return missing


def load_manifest(path: str) -> list[str]:
    """One required site per line; '#' comments and blanks skipped."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                out.append(line)
    return out


def manifest_for_spec(spec_path: str) -> str | None:
    """The convention: `<spec stem>.coverage` next to the spec file.  A
    restarting pair (`<stem>-1.txt`/`<stem>-2.txt`, or the bare stem)
    shares ONE manifest at `<stem>.coverage` — the campaign census merges
    both halves' trace events, so required sites may live in either."""
    from ..workloads import spec as _spec

    base, _ = os.path.splitext(spec_path)
    if base.endswith(("-1", "-2")) and _spec.is_restarting_pair(spec_path):
        # only an ACTUAL pair shares the stem manifest — a standalone spec
        # whose name merely ends in -1/-2 keeps its own `<name>.coverage`
        base = _spec.pair_stem(spec_path)
    path = base + ".coverage"
    return path if os.path.exists(path) else None


# ---------------------------------------------------------------------------
# one seed, in its own process


def run_one_seed(spec_path: str, seed: int, artifacts: str,
                 sim_deadline: float = 900.0,
                 sample_rate: float = 1.0, *, device="cuda",
                 force_fail_seed: int | None = None) -> dict:
    """The child body: run the spec under `seed` with rolling trace files
    in `artifacts`, write result.json, return the result dict.  Verdict
    here is pass/fail; timeout and crash are the PARENT's calls (a hung or
    dying child cannot classify itself).  `device` is the spec run's;
    `force_fail_seed == seed` fails the seed after its run."""
    import gc

    from ..conflict import kernels
    from ..runtime.trace import TraceCollector, TraceFileSink
    from ..workloads import spec as _spec

    os.makedirs(artifacts, exist_ok=True)
    sink = TraceFileSink(os.path.join(artifacts, "trace"),
                         roll_size=4 << 20, max_logs=4)
    result: dict[str, Any] = {"seed": seed, "verdict": "pass",
                              "error": None, "wall_s": 0.0}
    t0 = time.time()
    gc.collect()
    gc.disable()
    try:
        if _spec.should_run_pair(spec_path):
            # a restarting pair is ONE seeded unit: part 1 and part 2 run
            # in this same worker, the image lands in this seed's artifact
            # dir, and both lifetimes share the trace sink so triage joins
            # their timelines (docs/OPERATIONS.md restarting-pair runbook)
            metrics = _spec.run_restarting_pair(
                spec_path, deadline=sim_deadline, seed=seed,
                trace_sink=sink, sample_rate=sample_rate,
                image_dir=os.path.join(artifacts, "image"), device=device,
            )
        else:
            metrics = _spec.run_spec_file(
                spec_path, deadline=sim_deadline, seed=seed,
                trace_sink=sink, sample_rate=sample_rate, device=device,
            )
        result["metrics"] = metrics
        # the triage-demo hook: fail one named seed AFTER its run so the
        # failing seed still carries a full trace/census to triage
        if force_fail_seed == seed:
            raise AssertionError("forced failure (force_fail_seed)")
    except BaseException as e:  # noqa: BLE001 — the verdict IS the catch
        result["verdict"] = "fail"
        result["error"] = f"{type(e).__name__}: {e}"
        import traceback

        with open(os.path.join(artifacts, "traceback.txt"), "w") as f:
            traceback.print_exc(file=f)
        # the failure lands in the seed's OWN trace stream too, so triage
        # reads one surface; the spec-run collector is gone, so a small
        # teardown collector shares the sink
        tc = TraceCollector(sink=sink, machine=f"soak-seed-{seed}")
        tc.trace("SoakSeedFailed", severity=SEV_ERROR, Seed=seed,
                 Error=result["error"])
    finally:
        gc.enable()
    result["wall_s"] = time.time() - t0
    result["launches"] = kernels.launch_counts()
    with open(os.path.join(artifacts, "result.json"), "w") as f:
        json.dump(result, f, indent=2, default=str)
    sink.close()
    return result


# ---------------------------------------------------------------------------
# triage


def repro_command(spec_path: str, seed: int, device="cuda",
                  force_fail_seed: int | None = None) -> str:
    """The one-line "unseed": rerun exactly this seed on `device`,
    artifacts under ./repro-<seed>; a seed the campaign forced to fail is
    forced again."""
    forced = f" --force-fail-seed {seed}" if force_fail_seed == seed else ""
    return (
        f"python -m foundationdb_tpu_torch.tools.soak {spec_path} "
        f"--seeds 1 --first-seed {seed} --out repro-{seed} --keep-traces "
        f"--device {device}{forced}"
    )


def triage_seed(events: list[dict[str, Any]], spec_path: str,
                seed: int, max_events: int = 5, device="cuda",
                force_fail_seed: int | None = None) -> dict:
    """The automatic why-did-it-die block for a non-passing seed: first
    SEV_ERROR/SEV_WARN events in wall order, the slowest sampled
    transaction via the trace_tool cross-process join, the SlowTask
    count, and the repro command."""
    from . import trace_tool

    warns = [
        e for e in events
        if e.get("Severity", 0) >= SEV_WARN and e.get("Type") != "CodeCoverage"
    ]
    warns.sort(key=lambda e: (e.get("WallTime", 0.0), e.get("Time", 0.0)))
    # errors lead: a chaos-heavy seed can emit dozens of legitimate
    # SEV_WARN fault events (disk refusals, ratekeeper transitions) before
    # the one SEV_ERROR that says why it DIED — the why must never be
    # crowded out of the block
    errors = [e for e in warns if e.get("Severity", 0) >= SEV_ERROR]
    lead = errors[:max_events]
    lead += [e for e in warns if e not in lead][: max_events - len(lead)]
    first = [
        {
            "Type": e.get("Type"),
            "Severity": e.get("Severity"),
            "Time": e.get("Time"),
            "Machine": e.get("Machine"),
            "detail": {
                k: v for k, v in e.items()
                if k not in ("Type", "Severity", "Time", "Machine",
                             "WallTime", "File")
            },
        }
        for e in lead
    ]
    slow = trace_tool.top_slow(events, 1)
    return {
        "first_events": first,
        "error_count": sum(
            1 for e in warns if e.get("Severity", 0) >= SEV_ERROR
        ),
        "warn_count": len(warns),
        "slow_task_count": sum(
            1 for e in events if e.get("Type") == "SlowTask"
        ),
        "blob_retry_count": blob_retry_count(events),
        "hottest_shards": hottest_shards(events),
        "process_deaths": process_deaths(events),
        "slowest_transaction": slow[0] if slow else None,
        "repro": repro_command(spec_path, seed, device, force_fail_seed),
    }


def process_deaths(events: list[dict[str, Any]]) -> list[dict]:
    """Supervisor-attributed process deaths (tools/fdbmonitor.py
    `ProcessDied` events, folded in when a run's artifact dir includes the
    supervisor's own trace files): which conf SECTION died how many times
    and how it last exited — a crash loop or a restart-disabled section
    reads straight off this table.  The raw events also land in
    first_events (they are SEV_WARN), so the per-death timeline keeps its
    wall-order position among the cluster's other warnings."""
    by_section: dict = {}
    for e in events:
        if e.get("Type") != "ProcessDied":
            continue
        sec = e.get("Section") or "?"
        row = by_section.setdefault(sec, {
            "section": sec, "deaths": 0, "last_exit_code": None,
            "restart_disabled": False,
        })
        row["deaths"] += 1
        row["last_exit_code"] = e.get("ExitCode")
        if float(e.get("RestartInS") or 0.0) < 0:
            row["restart_disabled"] = True
    return sorted(
        by_section.values(), key=lambda r: (-r["deaths"], r["section"])
    )


def hottest_shards(events: list[dict[str, Any]], k: int = 3) -> list[dict]:
    """Per-seed hottest-shard table out of the trace stream (the
    load-metric plane's triage view): `DDHotShard` events carry the
    sampled per-range bandwidth at each detection, aggregated here per
    range (detections + peak).  When none fired, fall back to the busiest
    storage INSTANCES by their `StorageMetrics` bandwidth gauges, so a
    loaded seed always gets a table — just range-attributed only when
    detection actually crossed the knob."""
    by_range: dict = {}
    for e in events:
        if e.get("Type") != "DDHotShard":
            continue
        key = (e.get("Begin"), e.get("End"))
        row = by_range.setdefault(key, {
            "begin": e.get("Begin"), "end": e.get("End"),
            "detections": 0, "peak_bytes_per_ksec": 0.0,
            "team": e.get("Team"),
        })
        row["detections"] += 1
        row["peak_bytes_per_ksec"] = max(
            row["peak_bytes_per_ksec"], float(e.get("BytesPerKSec") or 0.0)
        )
    ranked = sorted(
        by_range.values(), key=lambda r: -r["peak_bytes_per_ksec"]
    )[:k]
    if ranked:
        return ranked
    by_inst: dict = {}
    for e in events:
        if e.get("Type") != "StorageMetrics":
            continue
        inst = e.get("Instance") or e.get("Tag")
        bw = (float(e.get("BytesReadPerKSec") or 0.0)
              + float(e.get("BytesWrittenPerKSec") or 0.0))
        row = by_inst.setdefault(
            inst, {"instance": inst, "peak_bytes_per_ksec": 0.0}
        )
        row["peak_bytes_per_ksec"] = max(row["peak_bytes_per_ksec"], bw)
    return sorted(
        by_inst.values(), key=lambda r: -r["peak_bytes_per_ksec"]
    )[:k]


def blob_retry_count(events: list[dict[str, Any]]) -> int:
    """SEV_WARN BlobRequestRetried events in a seed's trace stream — the
    blob-store backoff in flight.  A storm here (far above the forced
    fault budget) means the object store was effectively unreachable for
    stretches of the run, which reshapes backup timing even on passing
    seeds, so the campaign summarizes it per seed."""
    return sum(1 for e in events if e.get("Type") == "BlobRequestRetried")


# ---------------------------------------------------------------------------
# the campaign driver


# a worker's program: this package imported from its root, whatever the
# worker's working directory holds, then `main` on the arguments that follow
_CHILD = (
    "import sys; sys.path.insert(0, {root!r}); "
    "from foundationdb_tpu_torch.tools.soak import main; sys.exit(main())"
).format(root=os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def _prune_artifacts(adir: str) -> None:
    """Drop a PASSING seed's bulky artifacts (trace files, restart
    images) but keep `result.json` — it now carries the seed's census,
    which is everything a `--resume` of the campaign needs to count this
    seed as done without re-running it."""
    for entry in os.listdir(adir):
        if entry == "result.json":
            continue
        p = os.path.join(adir, entry)
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
        else:
            try:
                os.unlink(p)
            except OSError:
                pass


def run_campaign(spec_path: str, seeds: list[int], outdir: str,
                 jobs: int = 0, seed_deadline: float = 300.0,
                 sim_deadline: float = 900.0, sample_rate: float = 1.0,
                 required: list[str] | None = None,
                 keep_traces: bool = False,
                 resume: bool = False,
                 progress=None, *, device="cuda",
                 force_fail_seed: int | None = None) -> dict:
    """Run the campaign, aggregate, write campaign.json + campaign.md
    under `outdir`, return the report dict.  Every worker runs its seed on
    `device` (a campaign on cuda raises here, before any worker, when
    there is no card); `force_fail_seed` fails that seed after its run.

    `resume=True` is the checkpoint/restart path for big campaigns: any
    seed whose artifact dir already holds a parseable `result.json` with
    a completed verdict (pass/fail — a run that finished and said so) is
    adopted instead of re-run; only seeds with no verdict (never ran,
    timed out, crashed, or died mid-write) are launched.  A 1000-seed
    campaign killed at seed 700 restarts from 700, not 0."""
    from ..conflict.device import resolve_device
    from . import trace_tool

    if not seeds:
        raise ValueError("campaign needs at least one seed")
    resolve_device(device)
    jobs = jobs or min(8, os.cpu_count() or 1)
    os.makedirs(outdir, exist_ok=True)
    if required is None:
        mpath = manifest_for_spec(spec_path)
        required = load_manifest(mpath) if mpath else []

    def say(msg: str) -> None:
        if progress is not None:
            progress(msg)

    pending = list(seeds)
    running: dict[int, tuple[subprocess.Popen, float, Any]] = {}
    results: dict[int, dict] = {}
    t_campaign = time.time()

    if resume:
        still: list[int] = []
        for seed in pending:
            res_path = os.path.join(outdir, f"seed-{seed}", "result.json")
            prior = None
            try:
                with open(res_path) as f:
                    prior = json.load(f)
            except (OSError, ValueError):
                pass
            if (
                prior is not None
                and prior.get("seed") == seed
                and prior.get("verdict") in ("pass", "fail")
            ):
                # a completed verdict: adopt it.  timeout/crash rows never
                # wrote one (the PARENT classifies those), so they re-run.
                results[seed] = prior
                say(f"seed {seed}: resumed ({prior['verdict']})")
            else:
                still.append(seed)
        pending = still

    def launch(seed: int) -> None:
        adir = os.path.join(outdir, f"seed-{seed}")
        # a reused outdir must not leak a previous campaign's artifacts
        # into this one's census/verdicts
        shutil.rmtree(adir, ignore_errors=True)
        log = open(os.path.join(outdir, f"seed-{seed}.log"), "w")
        forced = [] if force_fail_seed is None else [
            "--force-fail-seed", str(force_fail_seed)]
        p = subprocess.Popen(
            [sys.executable, "-c", _CHILD,
             "--run-one", spec_path, "--seed", str(seed),
             "--artifacts", adir, "--sim-deadline", str(sim_deadline),
             "--sample-rate", str(sample_rate), "--device", str(device),
             *forced],
            stdout=log, stderr=subprocess.STDOUT,
        )
        running[seed] = (p, time.time(), log)

    def reap(seed: int, p: subprocess.Popen, t0: float, log) -> None:
        log.close()
        adir = os.path.join(outdir, f"seed-{seed}")
        res_path = os.path.join(adir, "result.json")
        result = None
        try:
            with open(res_path) as f:
                result = json.load(f)
        except (OSError, ValueError):
            pass
        if result is None:
            # died before writing its verdict: the harness classifies
            result = {"seed": seed, "verdict": "crash",
                      "error": f"exit status {p.returncode}, no result.json",
                      "wall_s": time.time() - t0}
        results[seed] = result
        say(f"seed {seed}: {result['verdict']} ({result['wall_s']:.1f}s)")

    while pending or running:
        while pending and len(running) < jobs:
            launch(pending.pop(0))
        time.sleep(0.1)
        for seed in list(running):
            p, t0, log = running[seed]
            if p.poll() is not None:
                del running[seed]
                reap(seed, p, t0, log)
            elif time.time() - t0 > seed_deadline:
                p.kill()
                p.wait()
                log.close()
                del running[seed]
                results[seed] = {
                    "seed": seed, "verdict": "timeout",
                    "error": f"seed deadline {seed_deadline}s exceeded",
                    "wall_s": time.time() - t0,
                }
                say(f"seed {seed}: timeout ({seed_deadline:.0f}s)")

    # -- aggregate: census + triage out of each seed's trace files ----------
    per_seed_census: dict[int, dict] = {}
    for seed in seeds:
        adir = os.path.join(outdir, f"seed-{seed}")
        events = trace_tool.load_events([adir]) if os.path.isdir(adir) else []
        r = results[seed]
        if events:
            census = census_from_events(events)
        else:
            # a resumed seed whose traces were already scraped-and-pruned:
            # its census rode result.json (written below on first pass)
            census = r.get("census") or {"buggify": {}, "testcov": {}}
        per_seed_census[seed] = census
        n_retries = blob_retry_count(events) if events else r.get(
            "blob_retries", 0
        )
        if n_retries:
            r["blob_retries"] = n_retries  # per-seed storm summary
        if r["verdict"] != "pass":
            if events or "triage" not in r:
                r["triage"] = triage_seed(events, spec_path, seed,
                                          device=device,
                                          force_fail_seed=force_fail_seed)
        elif not keep_traces and os.path.isdir(adir):
            # passing seeds' traces are scraped-and-pruned to bound disk
            # over 1000-seed campaigns; the census is folded into
            # result.json FIRST so a later --resume still counts the seed,
            # and failing seeds keep their traces for the repro/triage
            # loop.  An already-folded result (a resumed seed) is left
            # byte-identical — adoption must not touch it.
            if r.get("census") != census:
                r["census"] = census
                try:
                    with open(os.path.join(adir, "result.json"), "w") as f:
                        json.dump(r, f, indent=2, default=str)
                except OSError:
                    pass
            _prune_artifacts(adir)

    merged = merge_census(per_seed_census)
    missing = check_required(merged, required)
    verdicts = {v: sum(1 for r in results.values() if r["verdict"] == v)
                for v in ("pass", "fail", "timeout", "crash")}
    report = {
        "spec": spec_path,
        "seeds": seeds,
        "device": str(device),
        "jobs": jobs,
        "wall_s": time.time() - t_campaign,
        "verdicts": verdicts,
        "ok": verdicts["pass"] == len(seeds) and not missing,
        "per_seed": [results[s] for s in seeds],
        "coverage": {
            "required": required,
            "missing_required": missing,
            "merged": merged,
            "per_seed": {str(s): per_seed_census[s] for s in seeds},
        },
    }
    with open(os.path.join(outdir, "campaign.json"), "w") as f:
        json.dump(report, f, indent=2, default=str)
    with open(os.path.join(outdir, "campaign.md"), "w") as f:
        f.write(render_markdown(report))
    return report


# ---------------------------------------------------------------------------
# rendering


def render_markdown(report: dict) -> str:
    """The human half of the campaign report (campaign.md)."""
    v = report["verdicts"]
    cov = report["coverage"]
    lines = [
        f"# Soak campaign: `{report['spec']}`",
        "",
        f"- seeds: **{len(report['seeds'])}** "
        f"({report['seeds'][0]}..{report['seeds'][-1]}), "
        f"jobs {report['jobs']}, wall {report['wall_s']:.1f}s",
        f"- verdicts: **{v['pass']} pass**, {v['fail']} fail, "
        f"{v['timeout']} timeout, {v['crash']} crash",
        f"- required coverage: {len(cov['required'])} sites, "
        + ("**all hit**" if not cov["missing_required"]
           else f"**MISSING {len(cov['missing_required'])}**: "
                f"{', '.join(cov['missing_required'])}"),
        f"- campaign verdict: {'**OK**' if report['ok'] else '**FAILED**'}",
        "",
        "## Per-seed verdicts",
        "",
        "| seed | verdict | wall s | error |",
        "|---|---|---|---|",
    ]
    for r in report["per_seed"]:
        err = (r.get("error") or "").replace("|", "\\|")
        if len(err) > 80:
            err = err[:77] + "..."
        lines.append(
            f"| {r['seed']} | {r['verdict']} | {r['wall_s']:.1f} | {err} |"
        )
    merged = cov["merged"]
    lines += [
        "",
        "## Coverage census (campaign-wide)",
        "",
        f"Buggify sites seen: {len(merged['buggify'])}; "
        f"testcov names seen: {len(merged['testcov'])}.",
        "",
        "| buggify site | armed seeds | hit seeds | fires |",
        "|---|---|---|---|",
    ]
    for site, m in sorted(merged["buggify"].items()):
        mark = " ⚠" if m["armed_seeds"] and not m["hit_seeds"] else ""
        lines.append(
            f"| {site}{mark} | {m['armed_seeds']} | {m['hit_seeds']} "
            f"| {m['fires']} |"
        )
    silent = [
        s for s, m in sorted(merged["buggify"].items())
        if m["armed_seeds"] and not m["hit_seeds"]
    ]
    if silent:
        lines += ["", f"⚠ armed but never fired: {', '.join(silent)} — "
                      "fault injection may have silently stopped injecting."]
    lines += [
        "",
        "| testcov name | hit seeds | hits |",
        "|---|---|---|",
    ]
    for name, m in sorted(merged["testcov"].items()):
        lines.append(f"| {name} | {m['hit_seeds']} | {m['hits']} |")
    storms = [r for r in report["per_seed"] if r.get("blob_retries")]
    if storms:
        lines += [
            "",
            "## Blob retry storms (SEV_WARN `BlobRequestRetried` per seed)",
            "",
            "| seed | retries |",
            "|---|---|",
        ]
        for r in sorted(storms, key=lambda r: -r["blob_retries"]):
            lines.append(f"| {r['seed']} | {r['blob_retries']} |")
    failing = [r for r in report["per_seed"] if r["verdict"] != "pass"]
    if failing:
        lines += ["", "## Triage"]
        for r in failing:
            t = r.get("triage", {})
            lines += [
                "",
                f"### seed {r['seed']} — {r['verdict']}",
                "",
                f"- error: `{r.get('error')}`",
                f"- repro: `{t.get('repro', repro_command(report['spec'], r['seed'], report['device']))}`",
                f"- SEV_ERROR events: {t.get('error_count', 0)}, "
                f"SEV_WARN+: {t.get('warn_count', 0)}, "
                f"SlowTask: {t.get('slow_task_count', 0)}, "
                f"blob retries: {t.get('blob_retry_count', 0)}",
            ]
            deaths = t.get("process_deaths", [])
            if deaths:
                lines.append("- supervised process deaths (fdbmonitor):")
                for d in deaths:
                    note = (" — restart disabled, stayed dead"
                            if d.get("restart_disabled") else "")
                    lines.append(
                        f"  - `[{d['section']}]`: {d['deaths']} death(s), "
                        f"last exit {d['last_exit_code']}{note}"
                    )
            hot = t.get("hottest_shards", [])
            if hot:
                lines.append("- hottest shards (load-metric plane):")
                for h in hot:
                    if "instance" in h:
                        lines.append(
                            f"  - busiest storage `{h['instance']}`: peak "
                            f"{h['peak_bytes_per_ksec']:.0f} B/ksec "
                            "(StorageMetrics)"
                        )
                    else:
                        lines.append(
                            f"  - `{h['begin']}`..`{h['end']}`: peak "
                            f"{h['peak_bytes_per_ksec']:.0f} B/ksec, "
                            f"{h['detections']} detection(s), "
                            f"team {','.join(h.get('team') or [])}"
                        )
            for ev in t.get("first_events", []):
                lines.append(
                    f"  - `{ev['Type']}` sev {ev['Severity']} "
                    f"t={ev.get('Time')}: {ev.get('detail')}"
                )
            st = t.get("slowest_transaction")
            if st:
                lines.append(
                    f"- slowest sampled transaction `{st['id']}`: "
                    f"{st['station_count']} stations, "
                    f"{st['total_s'] * 1e3:.3f} ms across "
                    f"{'/'.join(st['roles'])}"
                )
    lines.append("")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="soak", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("spec", help="spec file (tests/specs/*.txt shape)")
    ap.add_argument("--seeds", type=int, default=25,
                    help="number of seeds (default 25)")
    ap.add_argument("--first-seed", type=int, default=DEFAULT_FIRST_SEED,
                    help=f"seed matrix base (default {DEFAULT_FIRST_SEED})")
    ap.add_argument("--jobs", type=int, default=0,
                    help="parallel workers (default min(8, cores))")
    ap.add_argument("--out", default=None,
                    help="campaign directory (default soak-<spec stem>)")
    ap.add_argument("--seed-deadline", type=float, default=300.0,
                    help="wall-clock seconds per seed before it is killed "
                         "and recorded as timeout (default 300)")
    ap.add_argument("--sim-deadline", type=float, default=900.0,
                    help="virtual-clock deadline inside each run")
    ap.add_argument("--sample-rate", type=float, default=1.0,
                    help="transaction timeline sampling per seed")
    ap.add_argument("--require-file", default=None,
                    help="required-coverage manifest (default: "
                         "<spec stem>.coverage next to the spec)")
    ap.add_argument("--keep-traces", action="store_true",
                    help="keep passing seeds' trace files too")
    ap.add_argument("--device", default="cuda",
                    help="device of each run's supervised conflict sets "
                         "(cuda or cpu; default cuda)")
    ap.add_argument("--force-fail-seed", type=int, default=None,
                    help="fail this seed after its run (the triage demo)")
    ap.add_argument("--resume", action="store_true",
                    help="adopt seeds whose result.json already carries a "
                         "completed verdict instead of re-running them (a "
                         "killed campaign restarts where it died)")
    # internal: the child body for one seed
    ap.add_argument("--run-one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--artifacts", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.seeds < 1:
        ap.error("--seeds must be >= 1")
    if args.run_one:
        result = run_one_seed(
            args.spec, args.seed, args.artifacts,
            sim_deadline=args.sim_deadline, sample_rate=args.sample_rate,
            device=args.device, force_fail_seed=args.force_fail_seed,
        )
        print(json.dumps(result, default=str))
        return 0 if result["verdict"] == "pass" else 1

    outdir = args.out or f"soak-{os.path.splitext(os.path.basename(args.spec))[0]}"
    required = (
        load_manifest(args.require_file) if args.require_file else None
    )
    seeds = [args.first_seed + i for i in range(args.seeds)]
    report = run_campaign(
        args.spec, seeds, outdir, jobs=args.jobs,
        seed_deadline=args.seed_deadline, sim_deadline=args.sim_deadline,
        sample_rate=args.sample_rate, required=required,
        keep_traces=args.keep_traces, resume=args.resume, progress=print,
        device=args.device, force_fail_seed=args.force_fail_seed,
    )
    print(f"\ncampaign {'OK' if report['ok'] else 'FAILED'}: "
          f"{report['verdicts']} — report in {outdir}/campaign.md")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
