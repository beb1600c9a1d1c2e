"""The port's key helpers (keys.key_after, keys.strinc), KeyRangeMap
(utils/rangemap.py), the proxy's KeyPartitionMap, the error registry
(roles/errors.py) and the storage load-metric plane
(roles/storage_metrics.py) against the reference's, on seeded random keys
over a small alphabet with the \\x00 and \\xff edges: every result, every
raised error and the maps' internal boundaries must be identical.  Also
the oracle's step function, whose assignment splices one slice: its
boundaries equal the reference oracle's after every write and GC."""

import random

import pytest

from foundationdb_tpu import keys as jkeys
from foundationdb_tpu.conflict import oracle as joracle
from foundationdb_tpu.roles import errors as jerrors
from foundationdb_tpu.roles import proxy as jproxy
from foundationdb_tpu.roles import storage_metrics as jstorage_metrics
from foundationdb_tpu.roles import types as jtypes
from foundationdb_tpu.runtime import core as jcore
from foundationdb_tpu.runtime import knobs as jknobs
from foundationdb_tpu.utils import rangemap as jrangemap
from foundationdb_tpu_torch import keys
from foundationdb_tpu_torch.conflict import oracle
from foundationdb_tpu_torch.roles import errors, proxy, storage_metrics, types
from foundationdb_tpu_torch.runtime import core, knobs
from foundationdb_tpu_torch.utils import rangemap

ALPHABET = b"\x00\x01ab\xfe\xff"


def rkey(rng, n=4):
    return bytes(rng.choice(ALPHABET) for _ in range(rng.randrange(n + 1)))


def outcome(fn, *args):
    """fn(*args), or the raised error's class name and message."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # compared across packages, never swallowed
        return ("raised", type(e).__name__, str(e))


@pytest.mark.parametrize("seed", range(4))
def test_key_after_and_strinc(seed):
    rng = random.Random(seed)
    cases = [b"", b"\xff", b"\xff\xff", b"a\xff", b"\x00", b"a\x00\xff"]
    cases += [rkey(rng, 6) for _ in range(300)]
    for k in cases:
        assert keys.key_after(k) == jkeys.key_after(k)
        assert outcome(keys.strinc, k) == outcome(jkeys.strinc, k), k
        if k.rstrip(b"\xff"):
            assert keys.strinc(k) > k and not keys.strinc(k).startswith(k)


def _range_map_ops(mod, seed):
    rng = random.Random(seed)
    m = mod.KeyRangeMap(default=0)
    seen = []
    for i in range(200):
        b, e = sorted((rkey(rng), rkey(rng)))
        if rng.random() < 0.2:
            e = None
        op = rng.randrange(4)
        if op == 0:
            m.assign(b, e, rng.randrange(5))
        elif op == 1:
            m.merge(b, e, rng.randrange(5), max)
        elif op == 2:
            m.map_values(lambda v, f=rng.randrange(3): 0 if v < f else v)
        else:
            seen.append(list(m.ranges(b, e)))
        seen.append((m[rkey(rng)], m.get(rkey(rng)), m.boundary_count,
                     list(m._keys), list(m._vals)))
    return seen


@pytest.mark.parametrize("seed", range(6))
def test_key_range_map(seed):
    assert _range_map_ops(rangemap, seed) == _range_map_ops(jrangemap, seed)


def _partition_map_ops(mod, seed):
    rng = random.Random(seed)
    splits = sorted({rkey(rng, 2) for _ in range(3)} - {b""})
    pm = mod.KeyPartitionMap(splits, [f"m{i}" for i in range(len(splits) + 1)])
    out = []
    for _ in range(150):
        k = rkey(rng)
        b, e = sorted((rkey(rng), rkey(rng)))
        idx = rng.randrange(len(splits) + 1)
        out.append((pm.position_for_key(k), pm.member_for_key(k),
                    outcome(pm.span_for_range, b, e), outcome(pm.members_for_range, b, e),
                    pm.clip_to_member(idx, b, e)))
        ranges = [tuple(sorted((rkey(rng), rkey(rng)))) for _ in range(rng.randrange(4))]
        out.append(outcome(pm.split_ranges, ranges))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_key_partition_map(seed):
    assert _partition_map_ops(proxy, seed) == _partition_map_ops(jproxy, seed)


def test_error_registry():
    port = [(types.TransactionTooOld, jtypes.TransactionTooOld),
            (types.FutureVersion, jtypes.FutureVersion),
            (types.NotCommitted, jtypes.NotCommitted),
            (types.CommitUnknownResult, jtypes.CommitUnknownResult),
            (types.DatabaseLocked, jtypes.DatabaseLocked),
            (core.TimedOut, jcore.TimedOut), (core.BrokenPromise, jcore.BrokenPromise),
            (core.ActorCancelled, jcore.ActorCancelled), (ValueError, ValueError)]
    for mine, ref in port:
        assert errors.error_code(mine()) == jerrors.error_code(ref())
    # every registered class is the port's own, keyed by the same codes
    assert {c: n for c, (_t, n) in errors._BY_CODE.items()} == \
        {c: n for c, (_t, n) in jerrors._BY_CODE.items()}
    for ty in errors.ERROR_REGISTRY:
        assert not ty.__module__.startswith("foundationdb_tpu."), ty
    for code in [*errors._BY_CODE, 4100, 9999]:
        assert errors.error_name(code) == jerrors.error_name(code)
        mine, ref = errors.error_for_code(code), jerrors.error_for_code(code)
        assert type(mine).__name__ == type(ref).__name__ and str(mine) == str(ref)
        if code in errors._BY_CODE:
            assert type(mine).__module__.startswith("foundationdb_tpu_torch.")


def _metrics_run(mod, knobs_mod, seed):
    rng = random.Random(seed)
    k = knobs_mod.CoreKnobs()
    k.BYTE_SAMPLE_UNIT = 64  # sample a good share of small writes
    sm = mod.StorageServerMetrics(k)
    out, now = [], 0.0
    for i in range(400):
        now += rng.random() * 0.05
        key = b"k%03d" % rng.randrange(200)
        op = rng.random()
        if op < 0.6:
            sm.on_set(key, rng.randrange(1, 300), now)
        elif op < 0.7:
            b, e = sorted((b"k%03d" % rng.randrange(200), b"k%03d" % rng.randrange(200)))
            sm.on_clear_range(b, e, now)
        elif op < 0.9:
            sm.on_read(key, rng.randrange(1, 300), now)
        elif op < 0.95:
            sm.on_fetch_rows([(b"k%03d" % rng.randrange(200), b"v" * rng.randrange(50))])
        else:
            b, e = sorted((b"k%03d" % rng.randrange(200), b"k%03d" % rng.randrange(200)))
            sm.drop_range(b, e)
        if i % 20 == 0:
            out.append((sm.metrics(b"", b"\xff", now), sm.metrics(b"k050", b"k150", now),
                        sm.split_point(b"", b"\xff"), sm.split_point(b"k100", b"k200"),
                        sm.busiest_range(now), list(sm.byte_sample._keys),
                        sm.byte_sample.total))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_storage_metrics_sample_the_same_keys(seed):
    got = _metrics_run(storage_metrics, knobs, seed)
    assert got == _metrics_run(jstorage_metrics, jknobs, seed)
    assert any(s[5] for s in got), "nothing sampled"


def _oracle_run(mod, seed):
    rng = random.Random(seed)
    cs, out, version = mod.OracleConflictSet(), [], 0
    TxInfo = mod.TxInfo
    for _ in range(40):
        version += rng.randrange(1, 4)
        txns = []
        for _ in range(rng.randrange(1, 8)):
            rr = [tuple(sorted((rkey(rng), rkey(rng)))) for _ in range(rng.randrange(3))]
            wr = [tuple(sorted((rkey(rng), rkey(rng)))) for _ in range(rng.randrange(3))]
            txns.append(TxInfo(rng.randrange(max(cs.oldest_version, version - 6), version),
                               rr, wr))
        out.append([int(v) for v in cs.resolve_batch(version, txns)])
        if rng.random() < 0.2:
            cs.remove_before(version - 3)
        out.append((list(cs._history._keys), list(cs._history._vals), cs.node_count))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_oracle_step_function_matches_the_reference(seed):
    assert _oracle_run(oracle, seed) == _oracle_run(joracle, seed)
