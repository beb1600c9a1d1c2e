"""The port's native C++ skip-list backend (foundationdb_tpu_torch/
conflict/native.py building native/conflictset.cpp, loaded through
conflict/plugin.py): tests/test_native.py's parity vs the oracle, GC and
plugin ABI against the port's build; the plugin seam's refusals; and the
reference's native set and the port's giving equal verdicts on one seeded
stream, packed and unpacked."""

import ctypes.util
import random

import numpy as np
import pytest

from foundationdb_tpu.conflict.api import TxInfo as JTxInfo
from foundationdb_tpu.conflict.native import NativeConflictSet as JNativeConflictSet
from foundationdb_tpu_torch.conflict import native
from foundationdb_tpu_torch.conflict.api import TxInfo, Verdict
from foundationdb_tpu_torch.conflict.native import NativeConflictSet, native_plugin
from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
from foundationdb_tpu_torch.conflict.plugin import ConflictPlugin


def test_plugin_loads():
    assert native_plugin().backend_name == "skiplist-cpp"


def test_built_from_the_ports_copy():
    """The library is the port's own build, in the port's _build/, never
    the reference's."""
    lib = native.build_native()
    assert lib.parent.parent == native.BUILD_ROOT
    assert lib.parent.name.startswith("native-")
    assert native_plugin().path == str(lib)


def test_basic_semantics():
    cs = NativeConflictSet()
    assert cs.resolve_batch(10, [TxInfo(5, [], [(b"a", b"b")])]) == [Verdict.COMMITTED]
    got = cs.resolve_batch(
        20,
        [
            TxInfo(5, [(b"a", b"a\x00")], []),          # sees write @10 -> conflict
            TxInfo(10, [(b"a", b"a\x00")], [(b"c", b"d")]),  # commits
            TxInfo(10, [(b"c", b"c\x00")], []),          # intra-batch conflict
            TxInfo(10, [(b"x", b"y")], []),              # commits
        ],
    )
    assert got == [Verdict.CONFLICT, Verdict.COMMITTED, Verdict.CONFLICT, Verdict.COMMITTED]
    cs.remove_before(15)
    got = cs.resolve_batch(30, [TxInfo(12, [], []), TxInfo(16, [(b"zz", b"zzz")], [])])
    assert got == [Verdict.TOO_OLD, Verdict.COMMITTED]
    cs.close()


def test_version_monotonicity_enforced():
    cs = NativeConflictSet()
    cs.resolve_batch(10, [TxInfo(0, [], [])])
    with pytest.raises(ValueError):
        cs.resolve_batch(10, [TxInfo(0, [], [])])
    cs.close()


def test_closed_handle_and_bad_library_refused():
    """A closed handle fails loudly instead of passing NULL to the C ABI,
    and a library without the ABI's symbols does not load."""
    cs = NativeConflictSet()
    cs.close()
    with pytest.raises(RuntimeError, match="closed"):
        cs.resolve_packed(1, np.zeros(0, np.int64), np.zeros(0, np.int32),
                          np.zeros(0, np.int32), np.zeros(0, np.uint8),
                          np.zeros(1, np.int64))
    with pytest.raises(RuntimeError, match="closed"):
        cs.remove_before(5)
    with pytest.raises(OSError, match="lacks symbol"):
        ConflictPlugin(ctypes.util.find_library("c"))


def _random_key(rng, alpha=5, maxlen=5):
    return bytes(rng.randrange(alpha) for _ in range(rng.randrange(1, maxlen)))


def _random_range(rng):
    a, b = _random_key(rng), _random_key(rng)
    return (a, a + b"\x00") if a == b else (min(a, b), max(a, b))


def _raw_batches(seed: int, n: int):
    rng = random.Random(seed)
    version = 0
    for i in range(n):
        version += rng.randrange(1, 4)
        txns = [
            (
                rng.randrange(max(version - 8, 0), version),
                [_random_range(rng) for _ in range(rng.randrange(0, 4))],
                [_random_range(rng) for _ in range(rng.randrange(0, 4))],
            )
            for _ in range(rng.randrange(1, 10))
        ]
        yield i, version, txns


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_randomized_parity_vs_oracle(seed):
    nat, orc = NativeConflictSet(), OracleConflictSet()
    for i, version, raw in _raw_batches(seed, 120):
        txns = [TxInfo(*t) for t in raw]
        vn = nat.resolve_batch(version, txns)
        vo = orc.resolve_batch(version, txns)
        assert vn == vo, f"seed {seed} batch {i} @v{version}: {vn} != {vo}"
        if i % 9 == 8:
            floor = max(version - 6, 0)
            nat.remove_before(floor)
            orc.remove_before(floor)
    nat.close()


def test_gc_keeps_node_count_bounded():
    rng = random.Random(9)
    cs = NativeConflictSet()
    version = 0
    peaks = []
    for i in range(200):
        version += 1
        txns = [TxInfo(version - 1, [], [_random_range(rng)]) for _ in range(8)]
        cs.resolve_batch(version, txns)
        cs.remove_before(max(version - 5, 0))
        peaks.append(cs.node_count)
    # the whole key alphabet is tiny; after GC the step function must stay
    # near the alphabet size rather than growing with batches
    assert max(peaks[100:]) < 2000
    cs.close()


def test_equal_to_the_reference_native_set():
    """One seeded stream through the reference's native set and the
    port's: equal verdicts, node counts and oldest versions batch by batch,
    and equal packed-path verdicts on the same arrays.  The port builds
    its own copy of the skip list with its own build and loader, so this
    is what keeps that copy from drifting from the reference unseen."""
    port, ref = NativeConflictSet(), JNativeConflictSet()
    for i, version, raw in _raw_batches(17, 200):
        got = port.resolve_batch(version, [TxInfo(*t) for t in raw])
        want = ref.resolve_batch(version, [JTxInfo(*t) for t in raw])
        assert [int(v) for v in got] == [int(v) for v in want], (i, version)
        if i % 7 == 6:
            port.remove_before(version - 5)
            ref.remove_before(version - 5)
        assert port.node_count == ref.node_count
        assert port.oldest_version == ref.oldest_version
    # the packed fast path, fed the same arrays
    keys = [b"k%03d" % i for i in range(64)]
    rng = np.random.default_rng(3)
    for version in range(1000, 1020):
        n = 50
        idx = rng.integers(0, len(keys), size=(n, 3))
        flat = [k for a, b, c in idx for k in (keys[a], keys[a] + b"\x00", keys[b],
                                               keys[b] + b"\x00", keys[c], keys[c] + b"\x00")]
        offsets = np.zeros(len(flat) + 1, np.int64)
        np.cumsum([len(k) for k in flat], out=offsets[1:])
        args = (np.full(n, version - 3, np.int64), np.full(n, 2, np.int32),
                np.ones(n, np.int32), np.frombuffer(b"".join(flat), np.uint8), offsets)
        np.testing.assert_array_equal(port.resolve_packed(version, *args),
                                      ref.resolve_packed(version, *args))
    assert port.stats.batches == ref.stats.batches
    port.close()
    ref.close()
