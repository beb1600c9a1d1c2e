"""The plain reference against a transaction-by-transaction model, and the
program on the CPU against the reference through the harness's own loop."""

import numpy as np
import pytest

from resolverbench.harness import run_cell
from resolverbench.reference import (COMMITTED, CONFLICT, TOO_OLD, Keys, RangeReference,
                                     Reference)
from resolverbench.tests.conftest import DEEP_BUCKET, TINY, small_tree
from resolverbench.tests.test_rb_traffic import make


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


def range_model(batches):
    """Each transaction in order, each read range against every write
    range of the history and of the batch's earlier committed ones; empty
    ranges (begin >= end) dropped."""
    history, out = [], []
    for version, oldest, rb, re, rt, wb, we, wt, snaps in batches:
        mine, verdicts = [], []
        for t, s in enumerate(snaps.tolist()):
            if s < oldest:
                verdicts.append(TOO_OLD)
                continue
            reads = [(b, e) for b, e, x in zip(rb.tolist(), re.tolist(), rt.tolist())
                     if x == t and b < e]
            if (any(c < e and b < d and v > s for c, d, v in history for b, e in reads)
                    or any(c < e and b < d for c, d in mine for b, e in reads)):
                verdicts.append(CONFLICT)
                continue
            verdicts.append(COMMITTED)
            mine += [(b, e) for b, e, x in zip(wb.tolist(), we.tolist(), wt.tolist())
                     if x == t and b < e]
        history += [(c, d, version) for c, d in mine]
        out.append(verdicts)
    return out


def range_batches(seed, n_keys=200, B=40, n=30):
    """Ragged ranges, 0-3 reads and 0-2 writes a transaction, of spans
    -2 to 11 and -2 to 3 keys (a span under 1 is empty)."""
    rng = np.random.default_rng(seed)

    def ranges(most, span):
        tx = np.repeat(np.arange(B), rng.integers(0, most + 1, B))
        b = rng.integers(0, n_keys, tx.size)
        return b, np.minimum(b + rng.integers(-2, span, tx.size), n_keys - 1), tx

    out = []
    for i in range(n):
        version, oldest = (i + 1) * 10, max(0, i * 10 - 60)
        snaps = np.maximum(version - 10 * rng.integers(1, 9, B), 0)
        out.append((version, oldest, *ranges(3, 12), *ranges(2, 4), snaps))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_range_reference_is_the_double_loop(seed):
    batches = range_batches(seed)
    ref = RangeReference(200)
    got = [ref.resolve(*b).tolist() for b in batches]
    assert got == range_model(batches)
    assert {CONFLICT, TOO_OLD, COMMITTED} <= set(np.concatenate(got).tolist())
    # the overlaps are mostly not key equality
    pairs = equal = 0
    for _, _, rb, re, _, wb, we, _, _ in batches:
        meet = (wb[None, :] < re[:, None]) & (rb[:, None] < we[None, :])
        pairs += int(meet.sum())
        equal += int((meet & (rb[:, None] == wb[None, :])).sum())
    assert equal < 0.2 * pairs


@pytest.mark.parametrize("switch", ["intra", "history", "too_old"])
def test_each_range_reference_switch_changes_verdicts(switch):
    batches = range_batches(7)
    ref, off = RangeReference(200), RangeReference(200, **{switch: False})
    assert any(ref.resolve(*b).tolist() != off.resolve(*b).tolist() for b in batches)


@pytest.mark.parametrize("cell", ["rw16.b8k", "ycsb_f.zipf099.b8k"])
def test_range_reference_on_point_ranges_is_the_reference(cell, tiny):
    """Each cell's tiny stream with its keys written as ranges [k, k + 0x00):
    the verdicts of the generator's reference, batch for batch."""
    g = make(tiny, cell, 2**31 + 29)
    live, last = g.window // g.step, g.window // g.step + 30

    def end_key_bytes(ids):  # id 2j: key j; 2j + 1: key j + b"\x00"
        rows, lens = g.key_bytes(ids // 2)
        wide = np.zeros((rows.shape[0], rows.shape[1] + 1), dtype=np.uint8)
        wide[:, :-1] = rows
        return wide, lens + ids % 2

    batches = [g.batch(i, i < live) for i in range(last + 1)]
    keys = Keys(np.concatenate([2 * b[k].ravel() + e for b in batches
                                for k in ("reads", "writes") for e in (0, 1)]),
                end_key_bytes)
    ref = RangeReference(keys.count)
    tally = np.zeros(3, dtype=np.int64)
    for b, want in zip(batches, g.reference(last, live)):
        B = b["snaps"].shape[0]
        ends = [(keys(2 * b[k].ravel()), keys(2 * b[k].ravel() + 1),
                 np.repeat(np.arange(B), b[k].shape[1])) for k in ("reads", "writes")]
        got = ref.resolve(b["version"], b["oldest"], *ends[0], *ends[1], b["snaps"])
        assert np.array_equal(got, want)
        tally += np.bincount(want, minlength=3)
    assert (tally > 0).all()


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
