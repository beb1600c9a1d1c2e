"""The port's graft entry (foundationdb_tpu_torch/graft_entry.py) on the
CPU: entry() gives the reference __graft_entry__.entry()'s verdicts, new
state, count and fixpoint iterations on the same crafted batch, and the
multi-resolver dry run passes over 4 partitions, its checks catching a
wrong verdict; with no card, both raise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jgraft
from foundationdb_tpu.conflict import device as jdev
from foundationdb_tpu_torch import graft_entry
from foundationdb_tpu_torch.conflict.api import Verdict
from foundationdb_tpu_torch.keys import from_lanes
from foundationdb_tpu_torch.parallel.sharded import ShardedDeviceConflictSet
from tests.torch_threads import one_torch_thread  # noqa: F401


def _reference_iterations(args, n_txn: int) -> int:
    """The fixpoint iterations resolve_core runs on the reference's
    example (it does not return them): its search, history and intra."""
    ks, vs, bidx, count, rb, re_, r_tx, wb, we, w_tx, snap, active, _off = map(
        jnp.asarray, args)
    r_ok, r_idx = r_tx >= 0, jnp.clip(r_tx, 0, n_txn - 1)
    w_ok, w_idx = (w_tx >= 0) & ~jdev._is_sentinel(wb), jnp.clip(w_tx, 0, n_txn - 1)
    g_lo, g_hi, _wr, _we, _c = jdev.phase_search(ks, bidx, count, rb, re_, wb, we, r_ok,
                                                 w_ok, jdev.FAST_SEARCH_ITERS)
    hist = jdev.phase_history(vs, g_lo, g_hi, snap, r_idx, r_ok, n_txn)
    return int(jdev.phase_intra(rb, re_, wb, we, r_ok, w_ok, r_idx, w_idx, w_tx, active,
                                hist, n_txn)[1])


def test_entry_equals_the_reference():
    fn, args = graft_entry.entry(device="cpu")
    verdict, new_ks, new_vs, new_count, new_bidx, conv, n_iters = fn(*args)
    jfn, jargs = jgraft.entry()
    want = jax.jit(jfn)(*jargs)
    np.testing.assert_array_equal(verdict.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(from_lanes(new_ks), np.asarray(want[1]))
    np.testing.assert_array_equal(new_vs.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(new_bidx.numpy(), np.asarray(want[4]))
    assert int(new_count) == int(want[3]) and bool(conv) == bool(want[5])
    assert int(n_iters) == _reference_iterations(jargs, verdict.shape[0]) >= 1
    # the crafted transactions: two history conflicts, a commit, an
    # intra-batch conflict (the reference's comments)
    assert verdict[:4].tolist() == [Verdict.CONFLICT, Verdict.CONFLICT,
                                    Verdict.COMMITTED, Verdict.CONFLICT]


def test_dryrun_multichip_passes_on_four_partitions(capsys):
    graft_entry.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert "[multichip] bench-class dryrun: devices=4 cap=65536 rec_cap=131072" in out
    assert "[multichip] bench-class dryrun OK: compactions=1" in out


def test_dryrun_catches_a_wrong_verdict(monkeypatch):
    real = ShardedDeviceConflictSet.resolve_batch

    def all_commit(self, version, txns):
        return [Verdict.COMMITTED for _ in real(self, version, txns)]

    monkeypatch.setattr(ShardedDeviceConflictSet, "resolve_batch", all_commit)
    with pytest.raises(AssertionError):
        graft_entry.dryrun_multichip(4, device="cpu")


def test_the_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(4)
