"""Phase timing (`phase_timing=True`) in the port's DeviceConflictSet and
`profile_kernel --phase`, on the CPU: with timing on, the
verdicts, the state and every counter but the *_s wall times equal the
untimed set's and the reference set's with its phase timing on (set on the
instance), a search that does not converge replays on the timed path too,
and profile_kernel's stream and printout match the reference's."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import profile_kernel as jprofile
from foundationdb_tpu.conflict import device as jdev
from foundationdb_tpu_torch import profile_kernel as tprofile
from foundationdb_tpu_torch.conflict import device as tdev
from foundationdb_tpu_torch.runtime import coverage
from tests.test_torch_device import _stream, assert_state_equal, jax_state
from tests.test_torch_lsm import _deep_bucket_stream

REPO_ROOT = Path(__file__).resolve().parents[1]
LAYOUTS = {"flat": {}, "best_known": dict(lsm=True, search_impl="bucket")}
COUNTERS = ("batches", "txns", "aborted", "search_fallbacks", "compactions",
            "gc_calls", "rows_reclaimed", "runs_appended", "full_merges",
            "rows_real", "rows_padded", "node_count")


def _run(stream, **args):
    s = tdev.DeviceConflictSet(device="cpu", **args)
    out = []
    for version, txns, floor in stream:
        out.append(s.resolve_batch(version, txns))
        if floor is not None:
            s.remove_before(floor)
    return s, out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_timed_equals_untimed(layout):
    """The same stream with and without phase timing: verdicts, state,
    counters, host syncs and fixpoint iterations equal; only the timed set
    fills sort/scan/append wall times."""
    args = dict(LAYOUTS[layout], capacity=1 << 8, run_slots=3, run_capacity=64)
    stream = list(_stream(2, 14))
    plain, want = _run(stream, **args)
    timed, got = _run(stream, phase_timing=True, **args)
    assert got == want
    assert_state_equal(plain.export_state(), timed.export_state(), layout)
    a, b = plain.kernel_stats(), timed.kernel_stats()
    for k in COUNTERS:
        assert a[k] == b[k], k
    assert (timed.host_syncs, timed.fixpoint_iterations()) == (
        plain.host_syncs, plain.fixpoint_iterations())
    assert b["compactions"] >= 2
    assert a["phase"]["sort_ms"] == a["phase"]["scan_ms"] == a["phase"]["merge_ms"] == 0
    assert min(b["phase"]["sort_ms"], b["phase"]["scan_ms"], b["phase"]["merge_ms"]) > 0


def test_timed_search_fallback_replays():
    """A deep bucket after a compaction: the timed path replays the search
    at full depth on the same batches as the untimed one, and counts its
    own coverage site."""
    args = dict(LAYOUTS["best_known"], capacity=1 << 11, run_slots=2, run_capacity=64)
    before = coverage.hits("kernel.search_fallback.inc_timed")
    plain, want = _run(_deep_bucket_stream(), **args)
    timed, got = _run(_deep_bucket_stream(), phase_timing=True, **args)
    assert got == want
    assert timed.search_fallbacks == plain.search_fallbacks == 2
    assert coverage.hits("kernel.search_fallback.inc_timed") == before + 2
    assert_state_equal(plain.export_state(), timed.export_state(), "fallback")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_timed_matches_reference_timed(layout):
    """The reference set with its phase timing on (set on the instance):
    the same verdicts and state as the port's timed set, batch by batch,
    and both fill the three phase times."""
    args = dict(LAYOUTS[layout], capacity=1 << 8, run_slots=3, run_capacity=64)
    ref = jdev.DeviceConflictSet(incremental=True, **args)
    ref._phase_timing = True
    port = tdev.DeviceConflictSet(device="cpu", phase_timing=True, **args)
    for version, txns, floor in _stream(5, 10):
        assert port.resolve_batch(version, txns) == ref.resolve_batch(version, txns)
        assert_state_equal(jax_state(ref), port.export_state(), version)
        assert port.node_count == ref.node_count
        if floor is not None:
            ref.remove_before(floor)
            port.remove_before(floor)
    for s in (ref, port):
        phase = s.kernel_stats()["phase"]
        assert min(phase["sort_ms"], phase["scan_ms"], phase["merge_ms"]) > 0


def test_drive_phase_stream_matches_the_reference(monkeypatch):
    """The port's drive_phase_stream draws the reference's batches: both
    sets end in the same state with the same counters.  (The reference
    turns its phase timing on through the environment: it writes into a
    copy here, dropped after the test.)"""
    monkeypatch.setattr(os, "environ", dict(os.environ))
    ref, ref_snap = jprofile.drive_phase_stream(5, 24, 1 << 9)
    assert ref._phase_timing
    port, snap = tprofile.drive_phase_stream(5, 24, 1 << 9, device="cpu")
    assert port._phase_timing
    assert_state_equal(jax_state(ref), port.export_state(), "profile stream")
    for k in ("batches", "txns", "aborted", "compactions", "runs_appended",
              "node_count"):
        assert snap[k] == ref_snap[k], k
    assert snap["compactions"] == 1 and snap["phase"]["scan_ms"] > 0


def test_profile_kernel_phase_cli():
    """`python -m foundationdb_tpu_torch.profile_kernel --phase` prints the
    device line first, then the four phases; without --phase it refuses."""
    cmd = [sys.executable, "-m", "foundationdb_tpu_torch.profile_kernel"]
    out = subprocess.run(cmd + ["--phase", "--device", "cpu", "--batches", "3",
                                "--txns", "16", "--cap", "1024"],
                         capture_output=True, text=True, timeout=240, cwd=REPO_ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "card: cpu"
    for name in ("sort_ms", "scan_ms", "merge_ms", "compact_ms", "pack_ms"):
        assert any(line.strip().startswith(name) for line in lines), name
    bad = subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                         cwd=REPO_ROOT)
    assert bad.returncode != 0 and not bad.stdout


def test_profile_kernel_lex_less_cli():
    """`profile_kernel --lex-less --device cpu` prints the device line,
    then one row a width with both forms' times (the forms agree, or it
    exits non-zero)."""
    cmd = [sys.executable, "-m", "foundationdb_tpu_torch.profile_kernel",
           "--lex-less", "--device", "cpu", "--rows", "32"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=240, cwd=REPO_ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "card: cpu"
    rows = [json.loads(line) for line in lines[1:]]
    assert [r["W"] for r in rows] == list(tprofile.LEX_WIDTHS)
    assert all(r["rows"] == 32 and r["by_lane_ms"] > 0 and r["first_lane_ms"] > 0
               for r in rows)


@pytest.mark.parametrize("W", [1, 5, 9, 17])
def test_lex_less_forms_agree_with_the_search(W):
    """The probe's two forms and ops/search.lex_less give the same bits,
    broadcasting included, on rows that tie, differ early and differ late."""
    from foundationdb_tpu_torch.ops.search import lex_less

    g = torch.Generator().manual_seed(W)
    a = torch.randint(-3, 3, (64, W), generator=g, dtype=torch.int32)
    b = a.clone()
    b[16:48, W - 1] += torch.randint(-1, 2, (32,), generator=g, dtype=torch.int32)
    b[48:, 0] += 1
    want = tprofile.lex_less_by_lane(a, b)
    assert torch.equal(tprofile.lex_less_first_lane(a, b), want)
    assert torch.equal(lex_less(a, b), want)
    assert torch.equal(lex_less(a[:, None], b[None]),
                       tprofile.lex_less_by_lane(a[:, None], b[None]))
