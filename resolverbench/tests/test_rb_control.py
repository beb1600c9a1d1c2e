"""The comparison fails what it must: each control (the reference with a
guarantee broken, in the program's place) on three seeds, and the program
on the CPU with its timed path broken underneath."""

import numpy as np
import pytest

from foundationdb_tpu_torch.conflict.device import DeviceConflictSet
from resolverbench.control import CONTROLS, run_control
from resolverbench.harness import run_cell


@pytest.mark.parametrize("cell", ["rw16.b8k", "ycsb_f.zipf099.b8k"])
@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_each_control_is_not_correct_on_three_seeds(cell, control, tiny):
    for seed in (1, 2, 2**31 + 9):
        out = run_control(tiny, cell, seed, 24, control)
        assert not out["correct"]
        assert out["checks"]["mismatched_verdicts"]["value"] > 0


def _state_unchanged(orig):
    """A resolve that answers and leaves the set's runs as they were."""
    def resolve(self, *args, **kw):
        keep = {n: getattr(self, n) for n in ("_runs_b", "_runs_e", "_runs_ver", "_n_runs",
                                              "_run_rows_ub")}
        out = orig(self, *args, **kw)
        for n, v in keep.items():
            setattr(self, n, v)
        return out
    return resolve


def _half_left_out(orig):
    """The second half of each batch's transactions never checked: their
    rows dropped before the set sees them (they come back COMMITTED)."""
    def resolve(self, version, rbv, rev, rtv, wbv, wev, wtv, snap, active, **kw):
        half = int(np.asarray(active).sum()) // 2
        arrays = [np.array(a) for a in (rbv, rev, rtv, wbv, wev, wtv)]
        for b, e, t in (arrays[:3], arrays[3:]):
            cut = t >= half
            b[cut], e[cut], t[cut] = 0xFFFFFFFF, 0xFFFFFFFF, -1
        return orig(self, version, *arrays, snap, active, **kw)
    return resolve


def _answer_altered(orig):
    """The first transaction's verdict flipped where it is produced."""
    def resolve(self, *args, **kw):
        out = orig(self, *args, **kw)
        flip = out.clone() if hasattr(out, "clone") else out.copy()
        flip[0] = 2 if int(out[0]) == 0 else 0
        return flip
    return resolve


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _answer_altered])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch, tiny):
    monkeypatch.setattr(DeviceConflictSet, "resolve_arrays",
                        fault(DeviceConflictSet.resolve_arrays))
    out = run_cell(tiny, "rw16.b8k", 77, 0.5, False, device="cpu")
    assert not out["result"]["correct"]
    assert out["checks"]["mismatched_verdicts"]["value"] > 0
