"""The plain reference against a transaction-by-transaction model, and the
program on the CPU against the reference through the harness's own loop."""

import numpy as np
import pytest

from resolverbench.harness import run_cell
from resolverbench.reference import COMMITTED, CONFLICT, TOO_OLD, Keys, Reference
from resolverbench.tests.conftest import DEEP_BUCKET, TINY, small_tree


def model(batches, n_keys):
    """Each transaction in order, with Python sets."""
    last = {}
    out = []
    for version, oldest, reads, writes, snaps in batches:
        written = set()
        verdicts = []
        for rr, ww, s in zip(reads.tolist(), writes.tolist(), snaps.tolist()):
            if s < oldest:
                verdicts.append(TOO_OLD)
            elif any(last.get(k, 0) > s for k in rr) or any(k in written for k in rr):
                verdicts.append(CONFLICT)
            else:
                verdicts.append(COMMITTED)
                written.update(ww)
        for k in written:
            last[k] = version
        out.append(verdicts)
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shape", [(2, 1, False), (1, 1, True), (3, 2, False)])
def test_reference_is_the_in_order_model(seed, shape):
    r, w, rmw = shape
    rng = np.random.default_rng(seed)
    n_keys, B = 40, 50
    batches = []
    for i in range(30):
        version, oldest = (i + 1) * 10, max(0, i * 10 - 60)
        reads = rng.integers(0, n_keys, (B, r))
        writes = reads if rmw else rng.integers(0, n_keys, (B, w))
        snaps = np.maximum(version - 10 * rng.integers(1, 9, B), 0)
        batches.append((version, oldest, reads, writes, snaps))
    ref = Reference(n_keys)
    got = [ref.resolve(*b).tolist() for b in batches]
    want = model(batches, n_keys)
    assert got == want
    flat = np.concatenate(got)
    assert {CONFLICT, TOO_OLD, COMMITTED} <= set(flat.tolist())


def test_keys_are_compared_by_their_bytes():
    table = {0: b"a", 1: b"b", 2: b"a", 3: b"a\x00", 5: b"b"}

    def key_bytes(ids):
        rows = np.zeros((len(ids), 4), dtype=np.uint8)
        for j, i in enumerate(ids.tolist()):
            rows[j, :len(table[i])] = np.frombuffer(table[i], dtype=np.uint8)
        return rows, np.array([len(table[i]) for i in ids.tolist()])

    keys = Keys(np.array([5, 0, 1, 2, 3, 0]), key_bytes)
    d = keys(np.array([0, 1, 2, 3, 5]))
    assert keys.count == 3
    assert d[0] == d[2] and d[1] == d[4] and len({d[0], d[1], d[3]}) == 3
    with pytest.raises(KeyError):
        keys(np.array([4]))


@pytest.mark.parametrize("cell,sizes", [("rw16.b8k", "tiny"),
                                        ("ycsb_f.zipf099.b8k", "tiny"),
                                        ("ycsb_f.zipf099.b8k", "deep_bucket")])
def test_the_program_on_the_cpu_agrees_with_the_reference(cell, sizes, tmp_path):
    reg = small_tree(tmp_path, {"tiny": TINY, "deep_bucket": DEEP_BUCKET}[sizes])
    out = run_cell(reg, cell, 2**31 + 5, 1.0, False, device="cpu")
    assert out["checks"]["mismatched_verdicts"]["value"] == 0
    assert out["checks"]["unanswered_batches"]["value"] == 0
    assert out["result"]["correct"] and out["result"]["failed"] == 0
    run = out["run"]
    assert run.window and all(b.verdicts is not None for b in run.window)
    assert run.counters["compactions"] > 0 and run.counters["fixpoint_iters"] > 0
    replayed = sum(b.replayed for b in run.window)
    if sizes == "deep_bucket":  # every batch's flag fails: each recovered
        assert run.counters["recoveries"] > 0 and replayed == len(run.window)
        assert run.counters["search_fallbacks"] >= len(run.window)
    elif cell == "rw16.b8k":  # random keys: every search converges
        assert replayed == 0 and run.counters["search_fallbacks"] == 0
        assert run.counters["recoveries"] == 0
    else:  # a recovery replays the batches of its window
        assert (replayed > 0) == (run.counters["recoveries"] > 0)
