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

REPO_ROOT = Path(__file__).resolve().parent.parent
PORT = REPO_ROOT / "foundationdb_tpu_torch"


def test_constants_match_the_reference():
    for name in ("TXNS_PER_BATCH", "READS_PER_TXN", "TIMED_BATCHES",
                 "PREFILL_BATCHES", "KEY_BYTES", "MAX_KEY_BYTES", "KEY_POOL",
                 "WINDOW", "CAP", "SEED"):
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
    be a SystemExit), and the document is one well-formed JSON object."""
    doc = bench.run("cpu", txns=64, key_pool=1 << 10, cap=1 << 11, run_capacity=128)
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
                "tools.timeline", "workloads.attrition"):
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
