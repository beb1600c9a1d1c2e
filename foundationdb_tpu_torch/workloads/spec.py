"""Spec-file-driven simulation runs — the tests/fast/*.txt analog
(fdbserver/tester.actor.cpp:848 readTests; the reference composes
workloads from key=value stanzas and runs them against a simulated
cluster, e.g. tests/fast/CycleTest.txt = Cycle + RandomClogging +
Attrition concurrently).

Format (one file = one simulation):

    testTitle=CycleWithChaos
    ; cluster parameters (optional, defaults in brackets)
    seed=7
    shards=2
    replication=2
    machines=4
    chaos=true

    testName=Cycle
    nodes=8
    clients=2
    txnsPerClient=6

    testName=Attrition
    kills=1
    interval=2.0

`testName` opens a workload stanza; parameters until the next `testName`
are constructor kwargs (camelCase -> snake_case), except `runSetup=false`
which skips the workload's setup phase (the restarting-pair part-2
convention: the data under test rode the reboot).  Everything before the
first `testName` configures the cluster — including `backend=supervised`
(the DeviceSupervisor-wrapped device conflict set), `sampleRate=R`
(transaction-timeline sampling into the trace files), and
`knob.NAME=value` lines (the reference's per-test --knob_ overrides:
applied via set_knob after knob construction, so they compose with chaos
randomization and unknown names fail loudly — e.g. the PageCacheChaos
spec shrinks PAGE_CACHE_BYTES / BTREE_CACHE_BYTES to stress the cache).
`run_spec` builds the cluster, composes the workloads, runs them, and
returns the metrics dict; its seed/trace_sink/sample_rate keywords are
the per-seed artifact hooks the soak harness (tools/soak.py) drives, and
teardown emits the run's buggify/testcov census as `CodeCoverage` trace
events.

Restarting pairs (tests/restarting/CycleTestRestart-{1,2}.txt in the
reference): `<stem>-1.txt` composes a `SaveAndKill` stanza that
power-kills the whole sim and saves its disk image + manifest;
`<stem>-2.txt` boots a second process-lifetime from that image
(`run_spec(..., restart_image=dir)`) and re-runs the invariant checks.
`run_restarting_pair` drives both halves as one seeded unit and
`resolve_pair` finds the pair from either half or the bare stem.  Part 2
REFUSES to boot when its declared seed or disk-shaping cluster config
mismatches part 1's manifest, or when a same-named workload declares
different invariant state (`Workload.restart_state`).

Port of the reference package's module, on the port's own modules, with
three differences.  `backend=oracle` (the default) names the port's
OracleConflictSet, so a spec runs the reference's simulation: the port's
clusters otherwise default to the card's DeviceConflictSet.
`backend=supervised` puts the supervised set on the device that the
`device=` keyword of `run_spec`, `run_spec_file` and `run_restarting_pair`
names ("cuda" unless the caller asks for "cpu"; without a card it raises);
an oracle spec ignores the keyword.  No environment is read: a restart
image lands in `save_dir` / `image_dir`, or in a fresh temp dir."""

from __future__ import annotations

import functools
import inspect
import json
import os
import re
import tempfile

from .attrition import AttritionWorkload
from .bank import BankWorkload
from ..conflict.oracle import OracleConflictSet
from .base import run_workloads
from .blob_backup import BlobBackupWorkload
from .configure_db import ConfigureDatabaseWorkload
from .conflict_range import ConflictRangeWorkload
from .consistency import ConsistencyCheckWorkload
from .cycle import CycleWorkload
from .device_fault import DeviceFaultWorkload
from .disk_swizzle import DiskSwizzleWorkload
from .low_space import LowSpaceWorkload
from .fuzzapi import FuzzApiWorkload
from .increment import IncrementWorkload
from .kill_region import KillRegionWorkload
from .random_move import RandomMoveKeysWorkload
from .readwrite import ReadWriteWorkload
from .rollback import RollbackWorkload
from .save_and_kill import RestartKill, SaveAndKillWorkload, invariant_states
from .selector_oracle import SelectorOracleWorkload
from .serializability import SerializabilityWorkload
from .swizzle import SwizzleWorkload
from .write_during_read import WriteDuringReadWorkload

# WorkloadFactory (workloads.h:55 registration): spec testName -> class
WORKLOAD_FACTORY = {
    "Cycle": CycleWorkload,
    "Bank": BankWorkload,
    "Increment": IncrementWorkload,
    "Attrition": AttritionWorkload,
    "ConsistencyCheck": ConsistencyCheckWorkload,
    "ConflictRange": ConflictRangeWorkload,
    "Serializability": SerializabilityWorkload,
    "FuzzApi": FuzzApiWorkload,
    "ConfigureDatabase": ConfigureDatabaseWorkload,
    "ReadWrite": ReadWriteWorkload,
    "RandomMoveKeys": RandomMoveKeysWorkload,
    "Swizzle": SwizzleWorkload,
    "WriteDuringRead": WriteDuringReadWorkload,
    "DeviceFault": DeviceFaultWorkload,
    "DiskSwizzle": DiskSwizzleWorkload,
    "LowSpace": LowSpaceWorkload,
    "SelectorOracle": SelectorOracleWorkload,
    "SaveAndKill": SaveAndKillWorkload,
    "Rollback": RollbackWorkload,
    "KillRegion": KillRegionWorkload,
    "BlobBackup": BlobBackupWorkload,
}

# spec key -> RecoverableCluster kwarg
_CLUSTER_KEYS = {
    "seed": ("seed", int),
    "shards": ("n_storage_shards", int),
    "replication": ("storage_replication", int),
    "machines": ("n_machines", int),
    "dcs": ("n_dcs", int),
    "workers": ("n_workers", int),
    "tlogs": ("n_tlogs", int),
    "proxies": ("n_proxies", int),
    "resolvers": ("n_resolvers", int),
    "engine": ("storage_engine", str),
    "redundancy": ("redundancy", str),
    "chaos": ("chaos", "bool"),
    # region-configuration bootstrap (control/region.py): 2 builds the
    # remote plane (log router + remote replicas) from birth
    "usableRegions": ("usable_regions", int),
    # fraction of transactions given a pipeline-timeline debug ID — the
    # per-seed trace-artifact hook (soak campaigns override per run)
    "sampleRate": ("debug_sample_rate", float),
    # conflict backend by name: "oracle" (default) or "supervised" (the
    # DeviceSupervisor-wrapped device set — required for device.*
    # buggify sites to mean anything); resolved in run_spec
    "backend": ("backend", str),
}

# cluster kwargs that SHAPE THE DISK IMAGE (file names, shard layout,
# replica placement, recovery seeding): part 2 of a restarting pair must
# match part 1's manifest on these or refuse to boot — booting different
# values against the saved disks checks the wrong cluster's invariants
_IMAGE_KEYS = (
    "seed", "n_storage_shards", "storage_replication", "n_tlogs",
    "n_machines", "n_dcs", "storage_engine", "redundancy",
    # shapes the disks (remote<i>.kv files + which serving set the saved
    # keyServers map can name), so a pair must agree on it
    "usable_regions",
)

# spec `backend=` values -> conflict-backend factories
_BACKENDS = {
    "oracle": OracleConflictSet,
}


def _supervised_backend(oldest: int = 0, *, device="cuda"):
    from ..conflict.device import DeviceConflictSet
    from ..conflict.supervisor import DeviceSupervisor

    return DeviceSupervisor(
        lambda o=0: DeviceConflictSet(o, capacity=1 << 10, device=device),
        oldest_version=oldest,
    )


_BACKENDS["supervised"] = _supervised_backend


def _backend_factory(backend: str, device):
    """The conflict-backend factory a spec's `backend=` names; the
    supervised set's on `device`, checked here so that a missing card
    raises before the cluster boots (the supervisor would serve it from
    the CPU instead)."""
    if backend != "supervised":
        return _BACKENDS[backend]
    from ..conflict.device import resolve_device

    return functools.partial(_BACKENDS[backend], device=resolve_device(device))


def _parse_bool(v: str) -> bool:
    if v.lower() not in ("true", "false"):
        raise ValueError(f"expected true/false, got {v!r}")
    return v.lower() == "true"


def _snake(name: str) -> str:
    return re.sub(r"(?<=[a-z0-9])([A-Z])", r"_\1", name).lower()


def _coerce(v: str):
    for conv in (int, float):
        try:
            return conv(v)
        except ValueError:
            continue
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def parse_spec(text: str) -> tuple[str, dict, list[tuple[str, dict]]]:
    """-> (title, cluster_kwargs, [(workload_name, kwargs), ...])"""
    title = "untitled"
    cluster_kwargs: dict = {}
    stanzas: list[tuple[str, dict]] = []
    current: dict | None = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith((";", "#")):
            continue
        if "=" not in line:
            raise ValueError(f"line {lineno}: expected key=value, got {line!r}")
        key, _, val = line.partition("=")
        key, val = key.strip(), val.strip()
        if key == "testTitle":
            title = val
        elif key == "testName":
            if val not in WORKLOAD_FACTORY:
                raise ValueError(
                    f"line {lineno}: unknown workload {val!r}; "
                    f"registered: {sorted(WORKLOAD_FACTORY)}"
                )
            current = {}
            stanzas.append((val, current))
        elif current is not None:
            current[_snake(key)] = _coerce(val)
        elif key in _CLUSTER_KEYS:
            kw, conv = _CLUSTER_KEYS[key]
            try:
                cluster_kwargs[kw] = (
                    _parse_bool(val) if conv == "bool" else conv(val)
                )
            except ValueError as e:
                raise ValueError(f"line {lineno}: {key}: {e}") from None
        elif key.startswith("knob."):
            # the reference's per-test knob override lines (--knob_ path):
            # applied via set_knob after knob construction, so they compose
            # with chaos randomization and unknown names fail loudly
            cluster_kwargs.setdefault("knob_overrides", {})[key[5:]] = val
        else:
            raise ValueError(
                f"line {lineno}: unknown cluster key {key!r} "
                f"(known: {sorted(_CLUSTER_KEYS)})"
            )
    if not stanzas:
        raise ValueError("spec has no testName stanza")
    return title, cluster_kwargs, stanzas


def _cluster_default(kwarg: str):
    """RecoverableCluster's own signature default for `kwarg` — the value
    a spec that omits the key effectively ran with (mismatch checks must
    compare EFFECTIVE config, not declared-key sets)."""
    from ..control.recoverable import RecoverableCluster

    return inspect.signature(RecoverableCluster.__init__).parameters[kwarg].default


def _check_part2_config(cluster_kwargs: dict, manifest: dict) -> dict:
    """Validate part 2's declared config against part 1's manifest and
    return the merged cluster kwargs part 2 boots with: image-shaping
    keys come from the manifest (declared part-2 values must MATCH),
    everything else is part 1's value unless part 2 overrides it."""
    part1 = dict(manifest.get("cluster", {}))
    part1.pop("backend", None)
    for key in _IMAGE_KEYS:
        if key not in cluster_kwargs:
            continue
        effective1 = part1.get(key, _cluster_default(key))
        if cluster_kwargs[key] != effective1:
            raise ValueError(
                f"restarting-pair mismatch: part 2 declares {key}="
                f"{cluster_kwargs[key]!r} but part 1 ran with "
                f"{effective1!r} (the saved disks belong to part 1's "
                f"config; fix the -2 spec or re-save the image)"
            )
    merged = dict(part1)
    merged.update(
        {k: v for k, v in cluster_kwargs.items() if k not in _IMAGE_KEYS}
    )
    return merged


def _check_restart_states(workloads, saved_states: dict) -> None:
    """Part 2's same-named-workload drift check.  Saved shape: name ->
    ORDERED list of states, one per part-1 stanza (save_and_kill.py
    invariant_states); compare positionally among same-named stanzas so
    duplicates don't collapse.  Every saved stanza must be covered — a
    part-2 spec that DROPS a workload whose data rode the reboot would
    pass while checking nothing.  Extra part-2 stanzas (new checks) are
    fine.  Live states go through the same JSON round-trip the manifest
    did, so JSON-equivalent values (tuples vs lists) never refuse a
    matching pair."""

    def canon(state):
        return json.loads(json.dumps(state, default=str))

    declared = {name: [canon(s) for s in states]
                for name, states in invariant_states(workloads).items()}
    for name, saved in sorted(saved_states.items()):
        got = declared.get(name, [])
        if len(got) < len(saved):
            raise ValueError(
                f"restarting-pair mismatch: part 1 saved invariant state "
                f"for {len(saved)} {name} stanza(s) but part 2 declares "
                f"{len(got)} — every ring/ledger that rode the reboot "
                f"must be re-checked"
            )
        for i, s in enumerate(saved):
            if got[i] != s:
                raise ValueError(
                    f"restarting-pair mismatch: {name} declares invariant "
                    f"state {got[i]} but part 1 saved {s}"
                )


def run_spec(text: str, deadline: float = 900.0, *, seed: int | None = None,
             trace_sink=None, sample_rate: float | None = None,
             save_dir: str | None = None,
             restart_image: str | None = None, device="cuda") -> dict:
    """Parse, build the cluster, compose the workloads, run, check.

    The keyword hooks are the per-seed artifact surface soak campaigns
    drive (tools/soak.py): `seed` overrides the spec's cluster seed (the
    campaign's seed matrix beats the file's fixed value), `trace_sink`
    streams the run's trace events into rolling files, and `sample_rate`
    overrides the spec's `sampleRate` so every seed carries joinable
    transaction timelines.  At teardown — pass OR fail — the run's
    buggify/testcov census is emitted into the trace stream as
    `CodeCoverage` events (runtime/{buggify,coverage}.py), which is how
    coverage crosses the process boundary to the campaign driver.

    Restarting-pair hooks: `save_dir` is where a SaveAndKill stanza lands
    its disk image + manifest (part 1 returns phase-1 metrics with
    `restart_image` set instead of running checks); `restart_image` boots
    THIS run from a saved image (part 2) after refusing seed/config/
    invariant-state mismatches against its manifest."""
    from ..control.recoverable import RecoverableCluster
    from ..runtime import buggify, coverage
    from ..runtime.coverage import testcov
    from ..storage.image import load_image, restore_filesystem

    title, cluster_kwargs, stanzas = parse_spec(text)
    backend_declared = "backend" in cluster_kwargs
    backend = cluster_kwargs.pop("backend", "oracle")
    if backend not in _BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r} (known: {sorted(_BACKENDS)})"
        )
    if seed is not None:
        cluster_kwargs["seed"] = seed
    if sample_rate is not None:
        cluster_kwargs["debug_sample_rate"] = sample_rate

    # the census baseline must predate load_image: part 2's
    # restart.image_loaded hit belongs to THIS run's coverage delta
    cov_base = coverage.snapshot()
    restart_manifest = None
    restored_fs = None
    if restart_image is not None:
        files, restart_manifest = load_image(restart_image)
        if not backend_declared:
            backend = restart_manifest.get("cluster", {}).get("backend", "oracle")
            if backend not in _BACKENDS:
                # a version-skewed manifest must fail with the same
                # diagnostic a bad spec gets, not a KeyError later
                raise ValueError(
                    f"unknown backend {backend!r} in restart manifest "
                    f"(known: {sorted(_BACKENDS)})"
                )
        cluster_kwargs = _check_part2_config(cluster_kwargs, restart_manifest)
        restored_fs = restore_filesystem(files)

    # what the restart manifest records (serializable names, not factories)
    manifest_cluster = dict(cluster_kwargs, backend=backend)

    c_kwargs = dict(cluster_kwargs)
    c_kwargs["conflict_backend"] = _backend_factory(backend, device)
    if restored_fs is not None:
        c_kwargs["fs"] = restored_fs
        c_kwargs["restart"] = True
    c = RecoverableCluster(trace_sink=trace_sink, **c_kwargs)
    try:
        workloads = []
        for name, kw in stanzas:
            kw = dict(kw)
            run_setup = kw.pop("run_setup", True)
            if not isinstance(run_setup, bool):
                # a typo'd runSetup=no would bool() truthy and re-fill the
                # ring part 2 exists to check — refuse, don't guess
                raise ValueError(
                    f"{name}: runSetup expects true/false, "
                    f"got {run_setup!r}"
                )
            w = WORKLOAD_FACTORY[name](**kw)
            w.run_setup = run_setup
            workloads.append(w)
        if restart_manifest is not None:
            _check_restart_states(workloads,
                                  restart_manifest.get("workloads", {}))
            for w in workloads:
                w.load_restart_manifest(restart_manifest)
            testcov("restart.booted_from_image")
            c.trace.trace("RestartFromImage", Image=restart_image,
                          Seed=cluster_kwargs.get("seed", 0),
                          KilledAt=restart_manifest.get("killed_at"))
        for w in workloads:
            if isinstance(w, SaveAndKillWorkload):
                if save_dir is None:
                    save_dir = _default_image_dir()
                w.bind(
                    save_dir=save_dir,
                    manifest={
                        "title": title,
                        "seed": cluster_kwargs.get("seed", 0),
                        "cluster": manifest_cluster,
                        "stanzas": [[n, kw] for n, kw in stanzas],
                    },
                    co_workloads=workloads,
                )
        try:
            metrics = run_workloads(c, workloads, deadline=deadline)
        except RestartKill as rk:
            # part 1 of a restarting pair: the sim power-killed itself on
            # purpose; checks belong to part 2's process lifetime
            metrics = {
                w.description: w.metrics() for w in workloads
            }
            metrics["phase"] = 1
            metrics["restart_image"] = rk.image_dir
        metrics["testTitle"] = title
        metrics["seed"] = cluster_kwargs.get("seed", 0)
        return metrics
    finally:
        # census emission must precede stop()/disable(): disabling clears
        # the buggify census, and the collector's sink is what carries
        # coverage to a cross-process campaign driver
        buggify.emit_coverage(c.trace)
        coverage.emit_coverage(c.trace, baseline=cov_base)
        c.stop()
        buggify.disable()


def run_spec_file(path: str, deadline: float = 900.0, *,
                  seed: int | None = None, trace_sink=None,
                  sample_rate: float | None = None,
                  save_dir: str | None = None,
                  restart_image: str | None = None, device="cuda") -> dict:
    """Run one spec file — or a whole restarting pair, auto-discovered
    when `path` is a bare pair stem or either half (`Name-1.txt` /
    `Name-2.txt`) and the caller passed no save_dir/restart_image (those
    kwargs mean a driver like run_restarting_pair is running the halves
    itself)."""
    if save_dir is None and restart_image is None and should_run_pair(path):
        return run_restarting_pair(
            path, deadline=deadline, seed=seed, trace_sink=trace_sink,
            sample_rate=sample_rate, device=device,
        )
    with open(path) as f:
        return run_spec(f.read(), deadline=deadline, seed=seed,
                        trace_sink=trace_sink, sample_rate=sample_rate,
                        save_dir=save_dir, restart_image=restart_image,
                        device=device)


# ---------------------------------------------------------------------------
# restarting pairs


def _default_image_dir() -> str:
    """Where a restart image lands when the caller named no directory: a
    fresh temp dir — never a CWD-relative path derived from the spec title
    (titles are arbitrary text)."""
    return tempfile.mkdtemp(prefix="restart-image-")


def pair_stem(path: str) -> str:
    """The ONE encoding of the pairing convention: strip `.txt` and a
    trailing `-1`/`-2` to get the stem shared by both halves (and by the
    pair's `<stem>.coverage` manifest)."""
    base = path[:-4] if path.endswith(".txt") else path
    if base.endswith(("-1", "-2")):
        base = base[:-2]
    return base


def should_run_pair(path: str) -> bool:
    """Whether a runner given `path` should substitute the whole pair:
    only when the path does not name an existing standalone spec, or is
    itself a pair half — an explicitly named, existing spec always runs
    as itself even if a same-stem pair coexists."""
    return (not os.path.exists(path)
            or path.endswith(("-1.txt", "-2.txt"))) and is_restarting_pair(path)


def resolve_pair(path: str) -> tuple[str, str]:
    """Find a restarting pair from either half or the bare stem:
    `Name-1.txt`, `Name-2.txt`, `Name.txt`, or `Name` all resolve to
    (`Name-1.txt`, `Name-2.txt`).  Raises FileNotFoundError when either
    half is missing — half a restarting test is not a test."""
    base = pair_stem(path)
    p1, p2 = base + "-1.txt", base + "-2.txt"
    missing = [p for p in (p1, p2) if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"restarting pair incomplete for {path!r}: missing "
            f"{', '.join(missing)}"
        )
    return p1, p2


def is_restarting_pair(path: str) -> bool:
    """A restarting pair is two same-stem halves whose -1 half actually
    contains a SaveAndKill stanza — filename shape alone is not enough,
    or two unrelated standalone specs that happen to be named Foo-1.txt
    and Foo-2.txt would be hijacked into a bogus pair run (and their own
    coverage manifests silently dropped)."""
    try:
        p1, _p2 = resolve_pair(path)
    except FileNotFoundError:
        return False
    try:
        with open(p1) as f:
            _title, _ck, stanzas = parse_spec(f.read())
    except (OSError, ValueError, KeyError):
        return False  # a half that does not parse is not half a pair
    return any(name == "SaveAndKill" for name, _kw in stanzas)


def run_restarting_pair(path: str, deadline: float = 900.0, *,
                        seed: int | None = None, trace_sink=None,
                        sample_rate: float | None = None,
                        image_dir: str | None = None, device="cuda") -> dict:
    """Both halves of a restarting pair as ONE seeded unit (how the soak
    harness runs them: same worker, shared artifact dir, one trace sink so
    triage joins part-1/part-2 timelines).  Part 1 runs to its SaveAndKill
    power-kill and saves the image under `image_dir`; part 2 boots from it
    and runs the invariant checks.  `seed` overrides BOTH halves (so the
    manifest seed check still passes) — the campaign seed matrix never
    forks the pair.  `device` is run_spec's, for both halves."""
    p1, p2 = resolve_pair(path)
    # a temp dir WE made is ours to delete once part 2 consumed it; a
    # directory the caller named is theirs, and a FAILED pair keeps its
    # image either way — it is the triage artifact
    ephemeral = image_dir is None
    if image_dir is None:
        image_dir = _default_image_dir()

    def discard_ephemeral() -> None:
        if ephemeral:
            import shutil

            shutil.rmtree(image_dir, ignore_errors=True)

    try:
        m1 = run_spec_file(p1, deadline=deadline, seed=seed,
                           trace_sink=trace_sink, sample_rate=sample_rate,
                           save_dir=image_dir, device=device)
    except BaseException:
        from ..storage.image import MANIFEST

        if not os.path.exists(os.path.join(image_dir, MANIFEST)):
            # part 1 died before SaveAndKill completed a save: the temp
            # dir holds no image, so there is nothing to keep for triage
            discard_ephemeral()
        raise
    if "restart_image" not in m1:
        discard_ephemeral()  # nothing saved
        raise ValueError(
            f"{p1} ran to completion without a SaveAndKill power-kill — "
            f"not a part-1 restarting spec"
        )
    image = m1["restart_image"]
    m2 = run_spec_file(p2, deadline=deadline, seed=seed,
                       trace_sink=trace_sink, sample_rate=sample_rate,
                       restart_image=image, device=device)
    if "restart_image" in m2:
        # part 2 power-killed ITSELF (a SaveAndKill stanza copied into
        # the -2 spec): every check was skipped, so this is not a green
        # pair — it is a part-2 spec that never checked anything
        raise ValueError(
            f"{p2} ended in a SaveAndKill power-kill of its own — part 2 "
            f"of a restarting pair must run checks, not kill again"
        )
    # a FAILED pair (either half raising after the save) keeps its image
    # for triage; a passing one has no consumer left, so delete a temp
    # dir and report no path rather than one that no longer exists
    discard_ephemeral()
    if ephemeral:
        image = None
    return {
        "testTitle": m2.get("testTitle", m1.get("testTitle")),
        "seed": m1.get("seed", 0),
        "restart_image": image,
        "part1": m1,
        "part2": m2,
    }
