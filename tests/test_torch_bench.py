"""The port's headline bench (foundationdb_tpu_torch/bench.py) on the CPU:
its stream and packers give arrays equal to the reference's root bench.py,
its run at a small size on "cpu" passes abort-set parity against the
native set (the timed batches and the resolver e2e run's) and yields a
well-formed result document, and without a card
it raises and prints nothing.  Also: every module of the port imports
with jax made unimportable and loads nothing of the reference package,
and no module of the port reads an environment variable."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as ref_bench
from foundationdb_tpu_torch import bench
from foundationdb_tpu_torch.control.status import check_phase_profile
from tests.torch_threads import one_torch_thread  # noqa: F401  (the probes' cluster)

REPO_ROOT = Path(__file__).resolve().parent.parent
PORT = REPO_ROOT / "foundationdb_tpu_torch"


def test_constants_match_the_reference():
    for name in ("TXNS_PER_BATCH", "READS_PER_TXN", "TIMED_BATCHES",
                 "PREFILL_BATCHES", "KEY_BYTES", "MAX_KEY_BYTES", "KEY_POOL",
                 "WINDOW", "CAP", "REC_CAP", "SEED"):
        assert getattr(bench, name) == getattr(ref_bench, name), name
    search, merge, lsm, incremental = ref_bench.BEST_KNOWN
    assert (bench.BEST_KNOWN["search_impl"], bench.BEST_KNOWN["lsm"]) == (search, lsm)
    assert (merge, incremental) == ("scatter", True)  # the port's only ones


def test_packers_match_the_reference():
    """One seeded batch at the bench's full shape: the pool, its lane
    words, the batch, device_pack's eight arrays and native_pack's five
    equal the reference bench's."""
    rng, jrng = np.random.default_rng(bench.SEED), np.random.default_rng(bench.SEED)
    pool, jpool = bench.gen_pool(rng), ref_bench.gen_pool(jrng)
    np.testing.assert_array_equal(pool, jpool)
    words = bench.pool_to_words(pool)
    np.testing.assert_array_equal(words, ref_bench.pool_to_words(jpool))
    batch, jbatch = bench.gen_batch(rng, pool, 9), ref_bench.gen_batch(jrng, jpool, 9)
    for k in ("reads", "writes", "snaps"):
        np.testing.assert_array_equal(batch[k], jbatch[k])
    got = bench.device_pack(words, batch, bench.tdev._bucket)
    want = ref_bench.device_pack(words, jbatch, ref_bench._bucket)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    got = bench.native_pack(pool, batch)
    want = ref_bench.native_pack(jpool, jbatch)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_run_small_on_cpu_passes_parity():
    """The whole bench at a small size on the CPU: the native set and the
    port's best-known set agree on all 16 timed batches (a mismatch would
    be a SystemExit), and the document is one well-formed JSON object,
    with the reference's phase blocks: the post batches' phase split and
    the embedded phase profile, which conforms to its schema."""
    doc = bench.run("cpu", txns=64, key_pool=1 << 10, cap=1 << 11, run_capacity=128,
                    phase_profile="small")
    line = json.dumps(doc)
    assert json.loads(line) == doc and "\n" not in line
    assert doc["metric"] == "occ_conflict_checks_per_sec_cpu_64k_live_ranges"
    assert doc["unit"] == "checks/s" and doc["device"] == "cpu"
    assert doc["value"] > 0 and doc["vs_baseline"] > 0
    k = doc["kernel"]
    assert k["parity_batches"] == bench.TIMED_BATCHES
    assert k["native_checks_per_sec"] > 0 and k["resolver_e2e_checks_per_sec"] > 0
    assert k["e2e_parity_batches"] == bench.E2E_BATCHES + 2
    assert k["full_merges"] == 0 and k["compactions"] >= 1 and k["runs_appended"] > 0
    assert k["resolve_ms_p50"] <= k["resolve_ms_p99"]
    assert 0 < k["abort_rate"] < 1
    assert k["probe_impl"] == "plain" and k["merge_impl"] == "scatter"
    assert k["phase_backend"] == "cpu"
    assert list(k["phase"]) == ["sort_ms", "scan_ms", "merge_ms", "compact_ms"]
    assert min(k["phase"]["sort_ms"], k["phase"]["scan_ms"], k["phase"]["merge_ms"]) > 0
    profile = k["phase_profile"]
    assert check_phase_profile(profile) == []
    assert (profile["backend"], profile["small"]) == ("cpu", True)
    assert profile["shapes"]["n_txn"] == 64 and profile["cap"] == 1 << 15


def test_phase_profile_off_and_unknown(monkeypatch):
    """--phase-profile off leaves the block out; another word raises."""
    monkeypatch.setattr(bench, "page_cache_probe", dict)
    monkeypatch.setattr(bench, "commit_wire_probe", dict)
    monkeypatch.setattr(bench, "metrics_series_probe", lambda _dev: {})
    small = dict(txns=16, key_pool=1 << 8, cap=1 << 10, run_capacity=64)
    doc = bench.run("cpu", phase_profile="off", **small)
    assert "phase_profile" not in doc["kernel"] and "phase" in doc["kernel"]
    with pytest.raises(ValueError, match="small, full or off"):
        bench.run("cpu", phase_profile="tiny", **small)


def test_parity_mismatch_exits_nonzero(monkeypatch):
    """A device verdict that differs from the native set's ends the run
    with a SystemExit carrying the count, before any result."""
    real = bench.tdev.DeviceConflictSet.resolve_arrays

    def lying(self, *args, sync=True):
        out = real(self, *args, sync=sync)
        return out if sync else 2 - out  # COMMITTED <-> CONFLICT

    monkeypatch.setattr(bench.tdev.DeviceConflictSet, "resolve_arrays", lying)
    with pytest.raises(SystemExit, match="parity FAILED in 16 batches"):
        bench.run("cpu", txns=16, key_pool=1 << 8, cap=1 << 10, run_capacity=64)


def test_e2e_parity_mismatch_exits_nonzero(monkeypatch):
    """The resolver e2e run's verdicts (PipelinedPacker + BatchStager into
    resolve_arrays(sync=False)) are held against a native set on the same
    transactions: a wrong one ends the run with a SystemExit."""
    real = bench.tdev.DeviceConflictSet.resolve_arrays

    def lying(self, *args, sync=True):
        out = real(self, *args, sync=sync)
        return out if sync else 2 - out  # COMMITTED <-> CONFLICT

    monkeypatch.setattr(bench.tdev.DeviceConflictSet, "resolve_arrays", lying)
    set_args = dict(bench.BEST_KNOWN, max_key_bytes=bench.MAX_KEY_BYTES,
                    capacity=1 << 10, run_capacity=64)
    with pytest.raises(SystemExit, match="e2e abort-set parity FAILED in 6 batches"):
        bench._resolver_e2e(torch.device("cpu"), 6, 16, set_args)


def test_main_without_a_card_raises_and_prints_nothing(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
    assert capsys.readouterr().out == ""


def test_module_entry_point_without_a_card_exits_nonzero():
    """`python -m foundationdb_tpu_torch.bench` with every card hidden:
    a non-zero exit and nothing on stdout — no native-only line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "foundationdb_tpu_torch.bench"],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO_ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def _port_modules():
    return sorted(
        ".".join(p.relative_to(REPO_ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py") if "_build" not in p.parts
    )


def test_every_module_imports_without_jax_or_the_reference():
    """With jax made unimportable, every module of the port imports (the
    ones this slice added among them) and no module of the reference
    package gets loaded."""
    mods = _port_modules()
    for new in ("runtime.core", "runtime.knobs", "runtime.buggify",
                "conflict.supervisor", "conflict.plugin", "conflict.native", "bench",
                "parallel.sharded", "profile_kernel", "runtime.combinators",
                "runtime.trace", "runtime.serialize", "rpc.network", "rpc.stream",
                "rpc.transport", "roles.types", "roles.sequencer", "roles.resolver",
                "keys", "utils.rangemap", "roles.errors", "roles.storage_metrics",
                "roles.tlog", "roles.storage", "roles.proxy", "client.snapshot_cache",
                "client.transaction", "client.ryw", "cluster", "workloads.base",
                "workloads.cycle", "workloads.bank", "workloads.increment",
                "workloads.conflict_range", "workloads.readwrite",
                "rpc.failmon", "rpc.policy", "storage.files", "storage.pagecache",
                "storage.diskqueue", "storage.kvstore", "storage.btree",
                "roles.logrouter", "roles.backup", "roles.worker", "client.management",
                "control.coordination", "control.region", "control.logsystem",
                "control.ratekeeper", "control.distribution", "control.controller",
                "control.recoverable", "control.status", "tools.trace_tool",
                "tools.timeline", "workloads.attrition", "client.tuple_layer",
                "client.directory_layer", "client.taskbucket", "client.multiversion",
                "client.backup", "client.dr", "storage.blobstore", "storage.image",
                "control.election", "workloads.consistency", "workloads.blob_backup",
                "workloads.save_and_kill", "phase_timings", "profile2", "bench_debug",
                "graft_entry"):
        assert f"foundationdb_tpu_torch.{new}" in mods
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in set(sys.modules) - before\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'foundationdb_tpu'))\n"
        "assert not bad, bad\n"
        f"print('imported', {len(mods)})\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO_ROOT)
    assert out.returncode == 0, out.stderr
    assert f"imported {len(mods)}" in out.stdout


def test_no_module_reads_the_environment():
    """No module of the port reads (or writes) an environment variable:
    no `environ`, `getenv`, `putenv` or `unsetenv` in any of them."""
    for path in PORT.rglob("*.py"):
        if "_build" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            name = (node.attr if isinstance(node, ast.Attribute)
                    else node.id if isinstance(node, ast.Name) else
                    node.name if isinstance(node, ast.alias) else None)
            assert name not in ("environ", "getenv", "putenv", "unsetenv"), \
                f"{path.relative_to(REPO_ROOT)}:{node.lineno} reads the environment"


# ---- the reference bench's probes ------------------------------------------


def test_page_cache_probe_matches_the_reference():
    """The same B-tree, the same cold and warm scans: every pread and page
    cache counter equals the reference probe's."""
    got = bench.page_cache_probe()
    assert got == ref_bench._page_cache_probe()
    assert got["cold_preads_saved"] > 0 and got["cache_on"]["cold_scan_preads"] > 0


def test_metrics_series_probe_matches_the_reference():
    """Both resolvers on the port's default set on the CPU against the
    reference's oracle: every ResolverMetrics sample's time, instance,
    rates and version are equal (the wall-ms delta is the host's), and the
    plain path counts no kernel launch."""
    from foundationdb_tpu_torch.runtime import buggify

    got = bench.metrics_series_probe("cpu")
    want = ref_bench._metrics_series_probe()
    buggify.disable()

    def cut(doc):
        return [{k: v for k, v in s.items() if k != "kernel_resolve_ms_delta"}
                for s in doc["ResolverMetrics"]]

    assert cut(got) == cut(want) and len(cut(got)) > 4
    assert {s["instance"] for s in cut(got)} == {s["instance"] for s in cut(want)}
    assert (got["interval_s"], got["workload_commits"]) == (0.25, 200)
    assert set(got["kernel_launches"].values()) == {0}


def test_commit_wire_probe_matches_the_reference():
    """The same batch and push: the codec's bytes, fallbacks and the
    burst's frames per flush equal the reference probe's (times left out).
    Protocol-4 pickle's bytes name each class's module, and the port's
    module paths are longer: only the codec's bytes compare."""
    got, want = bench.commit_wire_probe(reps=1), ref_bench._commit_wire_probe(reps=1)
    keys = ("bytes", "pickle_fallbacks", "txns", "frames_per_flush", "flushes")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["pickle_fallbacks"] == 0 and got["encode_ms"] > 0


def test_a_failing_probe_fails_the_bench(monkeypatch):
    """No probe's failure is swallowed: the run raises, and no document."""
    def broken(*_a, **_k):
        raise RuntimeError("probe broke")

    monkeypatch.setattr(bench, "page_cache_probe", broken)
    with pytest.raises(RuntimeError, match="probe broke"):
        bench.run("cpu", txns=16, key_pool=1 << 8, cap=1 << 10, run_capacity=64)
