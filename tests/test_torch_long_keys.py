"""Long keys in the port's default conflict set (foundationdb_tpu_torch/
conflict/device.py, keys.py): a set built at 32-byte keys widens its lanes
in place when a batch brings a longer endpoint, and its verdicts and state
stay those of the reference's DeviceConflictSet built wide from the start.

- The widened set against the reference's `DeviceConflictSet(
  max_key_bytes=256)`: endpoints of 20, 31, 32, 33, 43 and 204 bytes, then
  short keys again, in the flat default layout and the best-known
  `lsm=True, search_impl="bucket"` layout, synchronous, deferred and fed by
  a PipelinedPacker: verdicts identical on every batch, `export_state()`
  identical once the port's lanes are widened to 256 bytes by the same
  insert, abort sets equal to the oracle's.
- `keys.widen_lanes` on real keys, sentinel rows and the rows `lane_inc`
  grew from the sentinel.
- Whole clusters: the port's SimCluster and RecoverableCluster on their
  default backend (device="cpu") against the reference's defaults, same
  seed, keys of 20 to 203 bytes and a 10-byte key after them: every commit
  lands, at the same versions and virtual times.
- Keys of up to 10,000 bytes (FoundationDB's KEY_SIZE_LIMIT): a small
  set widened to 16384 bytes (W = 4097) equals the oracle verdict for
  verdict and a set built at 16384 bytes state for state, and both
  clusters, on a small device set given through `conflict_backend=`,
  commit keys of 600 and 10,000 bytes and short keys after them at the
  reference's versions and virtual times.
- Past keys.WIDEST_KEY_BYTES (16384) the set raises KeyTooLongError and
  its state is unchanged."""

import gc
import random

import numpy as np
import pytest
import torch

from foundationdb_tpu import cluster as jcluster
from foundationdb_tpu.conflict import device as jdev
from foundationdb_tpu.conflict.api import TxInfo
from foundationdb_tpu.conflict.oracle import OracleConflictSet
from foundationdb_tpu.control import recoverable as jrecoverable
from foundationdb_tpu.runtime import buggify as jbuggify
from foundationdb_tpu_torch import cluster as tcluster
from foundationdb_tpu_torch import keys as tkeys
from foundationdb_tpu_torch.conflict import device as tdev
from foundationdb_tpu_torch.conflict import kernels
from foundationdb_tpu_torch.conflict.api import Verdict
from foundationdb_tpu_torch.conflict.pipeline import PipelinedPacker
from foundationdb_tpu_torch.control import recoverable as trecoverable
from foundationdb_tpu_torch.runtime import buggify
from tests.test_torch_device import _rand_key, assert_state_equal, jax_state
from tests.torch_threads import one_torch_thread  # noqa: F401

WIDE = 256  # the reference set's width: FuzzApi's 204-byte ends fit
SMALL = dict(capacity=1 << 8, run_slots=3, run_capacity=32)
LAYOUTS = {"flat": {}, "best": dict(lsm=True, search_impl="bucket")}
# the endpoint lengths of each batch's long keys, in stream order
LENGTHS = [20, 31, 32, 33, 43, 204, None, None]
LANE_KEYS = ("ks", "runs_b", "runs_e", "rec_ks")


@pytest.fixture(autouse=True)
def _buggify_off():
    yield
    jbuggify.disable()
    buggify.disable()


def _padded(rng, n: int) -> bytes:
    """A key of exactly n bytes: a short random head, then filler."""
    head = _rand_key(rng, max_len=min(4, n))
    return head + b"~" * (n - len(head))


def _range(rng, L):
    """A range whose longer endpoint has L bytes (a short one when None)."""
    if L is None:
        k = _rand_key(rng)
        return (k, k + b"\x00") if rng.random() < 0.6 else tuple(
            sorted((k, _rand_key(rng) + b"\x00")))
    if rng.random() < 0.5:  # a point range: its end is the key plus \x00
        k = _padded(rng, L - 1)
        return k, k + b"\x00"
    a, b = sorted((_padded(rng, L), _padded(rng, L)))
    return (a, b) if a < b else (a, b + b"\x00")


def _long_stream(seed: int):
    """(version, txns, gc floor or None): each batch mixes short ranges and
    ranges of the batch's endpoint length (LENGTHS), so long and short keys
    interleave in the state."""
    rng = random.Random(seed)
    version, oldest = 0, 0
    for i, L in enumerate(LENGTHS):
        version += rng.randrange(1, 6)
        txns = []
        for _ in range(rng.randrange(4, 12)):
            snap = rng.randrange(max(oldest - 2, 0), version)
            pick = lambda: _range(rng, L if rng.random() < 0.5 else None)  # noqa: E731
            txns.append(TxInfo(snap, [pick() for _ in range(rng.randrange(3))],
                               [pick() for _ in range(rng.randrange(1, 3))]))
        floor = None
        if i == 5:
            floor = oldest = max(0, version - 6)
        yield version, txns, floor


def widened(state: dict, W: int) -> dict:
    """An exported state with every lane array widened to W lanes."""
    out = dict(state)
    for k in LANE_KEYS:
        if k in out:
            out[k] = tkeys.from_lanes(tkeys.widen_lanes(tkeys.to_lanes(out[k]), W))
    return out


def _reference(layout: str):
    if layout == "best":
        return jdev.DeviceConflictSet(max_key_bytes=WIDE, **LAYOUTS["best"],
                                      incremental=True, pallas="interpret", **SMALL)
    return jdev.DeviceConflictSet(max_key_bytes=WIDE, **SMALL)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_widened_set_matches_the_reference_built_wide(layout):
    """Sync: verdicts and state after every batch equal the reference set
    built at 256 bytes; the abort sets are the oracle's; the set widened
    32 -> 64 -> 256 and counted it."""
    W = tkeys.num_words(WIDE)
    oracle, ref = OracleConflictSet(), _reference(layout)
    port = tdev.DeviceConflictSet(**LAYOUTS[layout], **SMALL, device="cpu")
    assert port.stats.key_bytes == 32
    widths = []
    for version, txns, floor in _long_stream(3):
        want = oracle.resolve_batch(version, txns)
        assert ref.resolve_batch(version, txns) == want, version
        assert port.resolve_batch(version, txns) == want, version
        assert_state_equal(jax_state(ref), widened(port.export_state(), W), version)
        widths.append(port.stats.key_bytes)
        if floor is not None:
            for s in (oracle, ref, port):
                s.remove_before(floor)
    assert widths == [32, 32, 32, 64, 64, 256, 256, 256]
    assert port.stats.widenings == 2
    assert port.kernel_stats()["key_bytes"] == 256
    assert port.stats.compactions >= 2  # folds ran at both widened widths


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_deferred_and_packer_modes_equal_the_sync_set(layout):
    """resolve_deferred (handles waited one behind) and a PipelinedPacker
    that packs each batch at the width the set had when it was packed,
    consumed by resolve_arrays(sync=False): verdicts equal the sync set's
    on every batch, and the final states are equal."""
    stream = list(_long_stream(5))
    sync = tdev.DeviceConflictSet(**LAYOUTS[layout], **SMALL, device="cpu")
    wants = [sync.resolve_batch(v, txns) for v, txns, _f in stream]
    deferred = tdev.DeviceConflictSet(**LAYOUTS[layout], **SMALL, device="cpu")
    handles = [deferred.resolve_deferred(v, txns) for v, txns, _f in stream]
    assert [h.wait() for h in reversed(handles)][::-1] == wants
    assert_state_equal(sync.export_state(), deferred.export_state(), "deferred")

    packed_set = tdev.DeviceConflictSet(**LAYOUTS[layout], **SMALL, device="cpu")

    def pack(item):
        return tdev.pack_batch(item[1], packed_set.oldest_version,
                               packed_set._offset, packed_set._max_key_bytes,
                               grow=True)[:8]

    packer = PipelinedPacker(pack, stage=tdev.BatchStager("cpu"))
    widths = set()
    try:
        packer.submit(stream[0])  # the packer runs one batch ahead
        for i, (version, txns, _f) in enumerate(stream):
            if i + 1 < len(stream):
                packer.submit(stream[i + 1])
            staged = packer.get()
            widths.add(staged.take()[0].shape[1])
            v = packed_set.resolve_arrays(version, *staged.take(), sync=False)
            assert [int(c) for c in v[: len(txns)]] == [int(x) for x in wants.pop(0)]
    finally:
        packer.close()
    packed_set.check_pipelined()
    assert_state_equal(sync.export_state(), packed_set.export_state(), "packer")
    assert max(widths) == tkeys.num_words(WIDE)


def test_widen_lanes_inserts_zero_words_and_keeps_sentinel_rows():
    """Real keys gain flip(0) words (the encoding at the wider width), the
    sentinel and the rows lane_inc grew from it gain SENT_LANE words, and a
    real key whose data words are all 0xFF keeps its zero words."""
    keys = [b"", b"a", b"\xff" * 32, b"\xff" * 31, b"q" * 32, b"ab\x00"]
    for wide in (64, 256):
        W = tkeys.num_words(wide)
        got = tkeys.widen_lanes(tkeys.to_lanes(tkeys.encode_keys(keys, 32)), W)
        assert np.array_equal(tkeys.from_lanes(got), tkeys.encode_keys(keys, wide))
        sent = tkeys.to_lanes(np.stack([tkeys.sentinel(32)] * 3))
        sent_w = tkeys.to_lanes(np.stack([tkeys.sentinel(wide)] * 3))
        assert torch.equal(tkeys.widen_lanes(sent, W), sent_w)
        assert torch.equal(tkeys.widen_lanes(tkeys.with_last_lane_inc(sent), W),
                           tkeys.with_last_lane_inc(sent_w))
        # the run slots' layout: [K, rows, W]
        runs = torch.stack([sent, tkeys.to_lanes(tkeys.encode_keys(keys[:3], 32))])
        assert tkeys.widen_lanes(runs, W).shape == (2, 3, W)
    assert [tkeys.grown_key_bytes(n) for n in (20, 32, 33, 43, 204, 512)] == [
        32, 32, 64, 64, 256, 512]


def test_kernels_plan_every_grown_width():
    """K1's and K3's launch planners take every width a set can grow to,
    up to 16384 bytes, at the stream's shapes and at the default set's;
    past W = 4097 K1 runs without a summary, and both refuse a width
    where one read's or one query's rows exceed a block."""
    assert tkeys.WIDEST_KEY_BYTES == 16384
    wide = 32
    while wide <= tkeys.WIDEST_KEY_BYTES:
        W = tkeys.num_words(wide)
        for run_cap in (1 << 14, 1 << 12):
            p = kernels.plan_probe(8, run_cap, W)
            assert p.smem <= kernels.SMEM_MAX and p.threads >= 32
        r = kernels.plan_ranks(W)
        assert r.smem <= kernels.SMEM_MAX and r.queries >= 1
        wide *= 2
    W = tkeys.num_words(tkeys.WIDEST_KEY_BYTES)
    assert kernels.plan_probe(8, 1 << 12, W).n_sum == 0
    assert kernels.plan_ranks(W).queries == 8
    assert kernels.plan_ranks(W).span_rows == 0
    with pytest.raises(ValueError):
        kernels.plan_probe(8, 1 << 12, 30000)
    with pytest.raises(ValueError):
        kernels.plan_ranks(20000)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_a_key_past_the_widest_width_raises_and_changes_nothing(layout):
    port = tdev.DeviceConflictSet(**LAYOUTS[layout], **SMALL, device="cpu")
    port.resolve_batch(5, [TxInfo(0, [], [(b"a" * 40, b"b")])])
    before = port.export_state()
    too_long = b"k" * (tkeys.WIDEST_KEY_BYTES + 1)
    for txn in (TxInfo(4, [(b"a", too_long)], []),
                TxInfo(4, [], [(too_long, too_long + b"\x00")])):
        with pytest.raises(tkeys.KeyTooLongError):
            port.resolve_batch(9, [txn])
        with pytest.raises(tkeys.KeyTooLongError):
            port.resolve_deferred(9, [txn])
        assert_state_equal(before, port.export_state(), "after the raise")
    # an empty range and a TOO_OLD transaction encode nothing: no raise
    port.remove_before(2)
    assert port.resolve_batch(9, [TxInfo(4, [(too_long, b"a")], []),
                                  TxInfo(1, [(b"a", too_long)], [])]) == [
        Verdict.COMMITTED, Verdict.TOO_OLD]
    assert port.stats.key_bytes == 64


CLUSTER_KEYS = [20, 31, 32, 43, 203, 10]


def _commit_keys(c, lengths):
    """One transaction a key: read it, write it, commit.  Returns (key
    length, commit version or the error's class name, virtual time) each,
    and the keys read back."""
    db = c.database()
    keys = [b"fz/" + b"k" * (n - 3) for n in lengths]

    async def body():
        out = []
        for k in keys:
            tr = db.create_transaction()
            try:
                await tr.get(k)
                tr.set(k, b"v%d" % len(k))
                out.append((len(k), await tr.commit(), c.loop.now()))
            except Exception as e:  # noqa: BLE001 - compared by name
                out.append((len(k), type(e).__name__, c.loop.now()))
        tr = db.create_transaction()
        back = [await tr.get(k) for k in keys]
        return out, back

    return c.run_until(c.loop.spawn(body()), 120.0)


@pytest.mark.parametrize("kind", ["sim", "recoverable"])
def test_default_clusters_commit_long_keys_as_the_reference(kind):
    """C.1's regression: on the port's default backend every key of 20 to
    203 bytes commits, and so does a 10-byte key after them, at the
    reference's versions and virtual times."""
    results = {}
    for name, mod, kw in (
        ("ref", jrecoverable if kind == "recoverable" else jcluster, {}),
        ("port", trecoverable if kind == "recoverable" else tcluster,
         dict(device="cpu")),
    ):
        gc.collect()
        gc.disable()
        try:
            cls = mod.RecoverableCluster if kind == "recoverable" else mod.SimCluster
            c = cls(seed=1, **kw)
            try:
                results[name] = _commit_keys(c, CLUSTER_KEYS)
                if name == "port":
                    ks = c.resolvers[0].cs.kernel_stats() if kind == "sim" else None
            finally:
                c.stop()
        finally:
            gc.enable()
    assert results["port"] == results["ref"]
    commits, back = results["port"]
    assert all(isinstance(v, int) for _n, v, _t in commits), commits
    assert back == [b"v%d" % n for n in CLUSTER_KEYS]
    if ks is not None:
        assert ks["key_bytes"] == 256 and ks["widenings"] == 2


# the reference's default clusters commit every key of the C.1 repro
HUGE_KEYS = [600, 10, 10000, 12]
TINY_SET = dict(capacity=1 << 8, run_slots=3, run_capacity=32)


@pytest.mark.parametrize("kind", ["sim", "recoverable"])
def test_default_clusters_commit_keys_of_10000_bytes(kind):
    """C.1 at FoundationDB's key limit: keys of 600 and 10,000 bytes, and
    short keys after each, commit at the reference's versions and virtual
    times and read back.  The port's resolvers host its device set (the
    default backend's class and widening code) at a small capacity, so
    the widening to 16384 bytes stays fast on the CPU."""
    def tiny(oldest=0):
        return tdev.DeviceConflictSet(oldest, **TINY_SET, device="cpu")

    results, sets = {}, []
    for name, mod, kw in (
        ("ref", jrecoverable if kind == "recoverable" else jcluster, {}),
        ("port", trecoverable if kind == "recoverable" else tcluster,
         dict(conflict_backend=lambda oldest=0: sets.append(tiny(oldest)) or sets[-1])),
    ):
        gc.collect()
        gc.disable()
        try:
            cls = mod.RecoverableCluster if kind == "recoverable" else mod.SimCluster
            c = cls(seed=1, **kw)
            try:
                results[name] = _commit_keys(c, HUGE_KEYS)
            finally:
                c.stop()
        finally:
            gc.enable()
    assert results["port"] == results["ref"]
    commits, back = results["port"]
    assert all(isinstance(v, int) for _n, v, _t in commits), commits
    assert back == [b"v%d" % n for n in HUGE_KEYS]
    assert max(s.stats.key_bytes for s in sets) == tkeys.WIDEST_KEY_BYTES


# endpoint lengths of the widest stream: 600 -> 1024 bytes, then 10,000
# and its 10,001-byte key_after end -> 16384
HUGE_LENGTHS = [20, 600, 10001, None, 9000]


def _huge_stream(seed: int):
    rng = random.Random(seed)
    version = 0
    for L in HUGE_LENGTHS:
        version += rng.randrange(1, 6)
        txns = []
        for _ in range(rng.randrange(3, 7)):
            snap = rng.randrange(max(version - 8, 0), version)
            pick = lambda: _range(rng, L if rng.random() < 0.5 else None)  # noqa: E731
            txns.append(TxInfo(snap, [pick() for _ in range(rng.randrange(3))],
                               [pick() for _ in range(rng.randrange(1, 3))]))
        yield version, txns


def test_set_widened_to_16384_bytes_equals_the_oracle_and_a_set_built_wide():
    """A set from 32 bytes widens to 1024 and then 16384 bytes (W = 4097):
    every batch's verdicts equal the oracle's and a set built at 16384
    bytes; its state, widened by the same insert, equals that set's."""
    W = tkeys.num_words(tkeys.WIDEST_KEY_BYTES)
    oracle = OracleConflictSet()
    port = tdev.DeviceConflictSet(**TINY_SET, device="cpu")
    built = tdev.DeviceConflictSet(max_key_bytes=tkeys.WIDEST_KEY_BYTES, **TINY_SET,
                                   device="cpu")
    widths, verdicts = [], set()
    for version, txns in _huge_stream(8):
        want = oracle.resolve_batch(version, txns)
        assert port.resolve_batch(version, txns) == want, version
        assert built.resolve_batch(version, txns) == want, version
        assert_state_equal(widened(built.export_state(), W),
                           widened(port.export_state(), W), version)
        widths.append(port.stats.key_bytes)
        verdicts.update(want)
    assert verdicts == {Verdict.COMMITTED, Verdict.CONFLICT}
    assert widths == [32, 1024, 16384, 16384, 16384]
    assert port.stats.widenings == 2
