"""The harness's loop on packed arrays against the resolver role's own
pipelined path on TxInfo lists (`resolve_deferred`, the role's GC, the
previous batch's handle waited on): the same verdicts, and the same
resolves, fallbacks, host reads and compactions, so the same schedule of
drains, window checks and recoveries."""

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.bench import BEST_KNOWN
from foundationdb_tpu_torch.conflict import pipeline
from foundationdb_tpu_torch.conflict.api import TxInfo
from foundationdb_tpu_torch.conflict.device import DeviceConflictSet
from resolverbench.harness import Stream, counters
from resolverbench.tests.conftest import DEEP_BUCKET, TINY, small_tree
from resolverbench.tests.test_rb_traffic import make


def _role_path(g, n):
    """Batches 0..n-1 through `resolve_deferred` in the role's order."""
    cs = DeviceConflictSet(device="cpu", max_key_bytes=g.max_key_bytes, **BEST_KNOWN)
    kb, kl = g.key_bytes(np.arange(g.n_keys))
    key = [bytes(kb[j, :kl[j]]) for j in range(g.n_keys)]
    handles, prev = [], None
    for i in range(n):
        b = g.batch(i)
        txns = [TxInfo(int(s), [(key[r], key[r] + b"\x00") for r in rr],
                       [(key[w], key[w] + b"\x00") for w in ww])
                for s, rr, ww in zip(b["snaps"], b["reads"], b["writes"])]
        h = cs.resolve_deferred(b["version"], txns)
        if b["version"] > g.window:
            cs.remove_before(b["version"] - g.window)
        if prev is not None:
            prev.wait()
        handles.append(h)
        prev = h
    prev.wait()
    return cs, [np.array([int(v) for v in h.wait()], dtype=np.int8) for h in handles]


@pytest.mark.parametrize("cell,sizes", [("rw16.b8k", "tiny"),
                                        ("ycsb_f.zipf099.b8k", "deep_bucket")])
def test_the_loop_is_the_roles_pipelined_path(cell, sizes, tmp_path):
    reg = small_tree(tmp_path, {"tiny": TINY, "deep_bucket": DEEP_BUCKET}[sizes])
    g = make(reg, cell, 2**31 + 3)
    n = g.window // g.step + 24
    cs_role, want = _role_path(g, n)
    cs = DeviceConflictSet(device="cpu", max_key_bytes=g.max_key_bytes, **BEST_KNOWN)
    stream = Stream(torch, cs, g, torch.device("cpu"), pipeline._REPLAY_WINDOW)
    got = stream.run(0, count=n)
    assert [r.index for r in got] == list(range(n))
    for r, v in zip(got, want):
        assert np.array_equal(r.verdicts, v)
    a, b = counters(cs_role), counters(cs)
    a.pop("compact_s"), b.pop("compact_s")
    assert a == b and a["compactions"] > 0
    assert cs_role.stats.batches == cs.stats.batches
    assert (stream.recoveries > 0) == (sizes == "deep_bucket")
