"""The port's DeviceConflictSet (foundationdb_tpu_torch) held against the
reference package on the CPU: verdicts and exported state bit-identical to
the JAX DeviceConflictSet batch by batch, abort sets equal to the oracle's,
the state carried across in both directions, the packers byte-identical,
the set inside the reference SimCluster, and the package's import
hygiene."""

import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from foundationdb_tpu.cluster import SimCluster
from foundationdb_tpu.conflict import device as jdev
from foundationdb_tpu.conflict.api import TxInfo
from foundationdb_tpu.conflict.oracle import OracleConflictSet
from foundationdb_tpu.workloads.base import run_workloads
from foundationdb_tpu.workloads.conflict_range import ConflictRangeWorkload
from foundationdb_tpu.workloads.cycle import CycleWorkload
from foundationdb_tpu_torch.conflict import device as tdev
from foundationdb_tpu_torch.conflict import oracle as toracle
from foundationdb_tpu_torch.conflict.api import TxInfo as TTxInfo
from foundationdb_tpu_torch.conflict.api import Verdict as TVerdict

REPO_ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(capacity=1 << 6, run_slots=3, run_capacity=64)
STATE_KEYS = ("ks", "vs", "bidx", "runs_b", "runs_e", "runs_ver", "count",
              "n_runs", "cap", "run_cap", "K", "base", "oldest", "last_commit",
              "run_rows_ub")


def _rand_key(rng, alphabet=b"abcdefgh", max_len=6):
    return bytes(rng.choice(alphabet) for _ in range(rng.randrange(max_len + 1)))


def _rand_range(rng):
    if rng.random() < 0.5:  # point range [k, k+\0)
        k = _rand_key(rng)
        return k, k + b"\x00"
    if rng.random() < 0.95:  # a narrow range sharing its begin as prefix
        a = _rand_key(rng)
        return a, a + _rand_key(rng, max_len=2) + b"\x00"
    a, b = sorted((_rand_key(rng), _rand_key(rng)))
    return a, b + b"\x00"


def _rand_batch(rng, version, oldest, n):
    txns = []
    for _ in range(n):
        snap = rng.randrange(max(oldest - 3, 0), version)
        txns.append(
            TxInfo(
                read_snapshot=snap,
                read_ranges=[_rand_range(rng) for _ in range(rng.randrange(4))],
                write_ranges=[_rand_range(rng) for _ in range(rng.randrange(3))],
            )
        )
    return txns


def jax_state(d) -> dict:
    """The reference set's state in the port's export_state() layout: the
    runs only on the incremental path, the cached history table `tab` and
    the recent level only for the LSM layout."""
    out = dict(
        ks=np.asarray(d._ks), vs=np.asarray(d._vs), bidx=np.asarray(d._bidx),
        count=int(d._dev_count) if d._count is None else d._count,
        cap=d._cap, base=d._base, oldest=d._oldest,
        last_commit=d._last_commit, merge_impl=d._merge_impl,
    )
    if d._incremental:
        out.update(
            runs_b=np.asarray(d._runs_b), runs_e=np.asarray(d._runs_e),
            runs_ver=np.asarray(d._runs_ver), n_runs=d._n_runs,
            run_cap=d._run_cap, K=d._K, run_rows_ub=d._run_rows_ub,
        )
    if d._lsm:
        out.update(
            tab=np.asarray(d._tab), rec_ks=np.asarray(d._rec_ks),
            rec_vs=np.asarray(d._rec_vs), rec_bidx=np.asarray(d._rec_bidx),
            rec_count=int(d._rec_dev_count), rec_cap=d._rec_cap,
        )
    return out


def assert_state_equal(want: dict, got: dict, where) -> None:
    assert set(got) == set(want) >= set(STATE_KEYS)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert w.dtype.kind == g.dtype.kind or w.ndim == 0, (where, k)
        assert np.array_equal(w, g), (where, k)


def _stream(seed, n_batches=20):
    """(version, txns, gc_floor or None) per batch: mostly small batches,
    some wide enough (up to 3 writes x 45 txns) to regrow the runs."""
    rng = random.Random(seed)
    oldest, version = 0, 0
    for _ in range(n_batches):
        version += rng.randrange(1, 8)
        n = rng.randrange(1, 12) if rng.random() < 0.75 else rng.randrange(30, 46)
        txns = _rand_batch(rng, version, oldest, n)
        floor = None
        if rng.random() < 0.3:  # GC a trailing window, as a resolver does
            floor = max(0, version - rng.randrange(8, 40))
            oldest = max(oldest, floor)
        yield version, txns, floor


# seeds whose streams regrow both main and the runs (within 8 batches for
# 4 and 7, which the slow interpret-mode reference runs only that far)
@pytest.mark.parametrize("pallas", [None, "interpret"], ids=["xla", "interpret"])
@pytest.mark.parametrize("seed", [0, 4, 7])
def test_stream_parity_vs_jax_and_oracle(seed, pallas):
    """Randomized batches with mid-stream GC through the oracle, the JAX
    set (XLA probe, or the Pallas bodies in interpret mode) and the port
    on the CPU: identical verdicts and identical state after every batch;
    compaction, main regrow and run regrow all fire."""
    n_batches = 8 if (pallas == "interpret" and seed) else 20
    oracle = OracleConflictSet()
    ref = jdev.DeviceConflictSet(**SMALL, pallas=pallas)
    port = tdev.DeviceConflictSet(**SMALL, device="cpu")
    for version, txns, floor in _stream(seed, n_batches):
        want = oracle.resolve_batch(version, txns)
        assert ref.resolve_batch(version, txns) == want
        got = port.resolve_batch(version, txns)
        assert got == want, (seed, version)
        assert_state_equal(jax_state(ref), port.export_state(), (seed, version))
        if floor is not None:
            for s in (oracle, ref, port):
                s.remove_before(floor)
    assert port.stats.compactions >= 2
    assert port.capacity > SMALL["capacity"], "main never regrew"
    assert port._run_cap > SMALL["run_capacity"], "runs never regrew"
    assert port.stats.runs_appended == n_batches
    assert port.stats.backend == "cpu"


def test_port_oracle_matches_reference_oracle():
    """The port's copy of the oracle referee gives the reference's
    verdicts on the same stream."""
    a, b = OracleConflictSet(), toracle.OracleConflictSet()
    for version, txns, floor in _stream(7, 25):
        assert a.resolve_batch(version, txns) == b.resolve_batch(version, txns)
        if floor is not None:
            a.remove_before(floor)
            b.remove_before(floor)
    assert a.node_count == b.node_count


def test_state_carry_both_directions():
    """State built by the JAX set loads into the port; both continue on the
    same batches with identical verdicts and state.  The port's own export
    loads into a fresh port set just as well."""
    batches = list(_stream(11, 16))
    ref = jdev.DeviceConflictSet(**SMALL)
    for version, txns, floor in batches[:9]:
        ref.resolve_batch(version, txns)
        if floor is not None:
            ref.remove_before(floor)
    port = tdev.DeviceConflictSet(**SMALL, device="cpu")
    port.load_state(jax_state(ref))
    assert_state_equal(jax_state(ref), port.export_state(), "loaded")
    for version, txns, floor in batches[9:]:
        assert port.resolve_batch(version, txns) == ref.resolve_batch(version, txns)
        assert_state_equal(jax_state(ref), port.export_state(), version)
        if floor is not None:
            ref.remove_before(floor)
            port.remove_before(floor)
    again = tdev.DeviceConflictSet(**SMALL, device="cpu")
    exported = port.export_state()
    again.load_state(exported)
    exported["vs"][:] = 12345  # the export is a copy, not a view
    assert_state_equal(port.export_state(), again.export_state(), "round trip")


def test_load_state_rejects_mismatched_width():
    ref = jdev.DeviceConflictSet(**SMALL, max_key_bytes=16)
    port = tdev.DeviceConflictSet(**SMALL, device="cpu")  # 32-byte keys
    with pytest.raises(ValueError):
        port.load_state(jax_state(ref))


def _pack_args(oldest=5, base=2):
    def offset(v):
        return max(v - base, 0)

    def offset_array(vs):
        return np.maximum(np.asarray(vs, np.int64) - base, 0)

    return oldest, offset, offset_array


@pytest.mark.parametrize("seed", range(4))
def test_pack_batch_bit_identity(seed):
    """Port pack_batch == port pack_batch_loop == the reference's pack_batch,
    all nine outputs, incl. TOO_OLD txns, empty and inverted ranges."""
    rng = random.Random(100 + seed)
    txns = []
    for _ in range(rng.randrange(1, 40)):
        ranges = [_rand_range(rng) for _ in range(rng.randrange(4))]
        if rng.random() < 0.3:  # empty / inverted ranges are dropped
            ranges.append((b"b", b"a" if rng.random() < 0.5 else b"b"))
        txns.append(TxInfo(read_snapshot=rng.randrange(0, 12),
                           read_ranges=ranges,
                           write_ranges=[_rand_range(rng)
                                         for _ in range(rng.randrange(3))]))
    oldest, offset, offset_array = _pack_args()
    for mkb in (12, 32):
        want = jdev.pack_batch(txns, oldest, offset, mkb)
        bulk = tdev.pack_batch(txns, oldest, offset, mkb,
                               offset_array=offset_array)
        loop = tdev.pack_batch_loop(txns, oldest, offset, mkb)
        for w, b, lo in zip(want, bulk, loop):
            assert np.array_equal(np.asarray(w), np.asarray(b))
            assert np.array_equal(np.asarray(w), np.asarray(lo))
            assert np.asarray(w).dtype == np.asarray(b).dtype


def test_pack_batch_overlong_keys_follow_the_loop_path():
    """A key longer than max_key_bytes sends the batch to the loop packer:
    an empty over-length range drops, a live one raises KeyTooLongError,
    exactly as in the reference."""
    from foundationdb_tpu import keys as jkeys
    from foundationdb_tpu_torch import keys as tkeys

    oldest, offset, _ = _pack_args(oldest=0, base=0)
    long_key = b"x" * 12
    dropped = [TxInfo(1, [(long_key, long_key)], [(b"a", b"b")])]
    want = jdev.pack_batch(dropped, oldest, offset, 8)
    got = tdev.pack_batch(dropped, oldest, offset, 8)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), np.asarray(g))
    live = [TxInfo(1, [(b"a", long_key)], [])]
    with pytest.raises(jkeys.KeyTooLongError):
        jdev.pack_batch(live, oldest, offset, 8)
    with pytest.raises(tkeys.KeyTooLongError):
        tdev.pack_batch(live, oldest, offset, 8)


def test_resolve_arrays_packed_path_and_kernel_stats():
    """The packed entry point gives the verdict codes resolve_batch does,
    and kernel_stats() reports the port's backend and counters."""
    batches = list(_stream(3, 6))
    a = tdev.DeviceConflictSet(**SMALL, device="cpu")
    b = tdev.DeviceConflictSet(**SMALL, device="cpu")
    for version, txns, _floor in batches:
        want = a.resolve_batch(version, txns)
        packed = tdev.pack_batch(txns, b.oldest_version, b._offset, 32)
        codes = b.resolve_arrays(version, *packed[:8])
        assert codes.dtype == np.int32
        assert [TVerdict(int(c)) for c in codes[: len(txns)]] == want
    # the pipelined dispatch: verdicts as a tensor, read without a check
    version, txns, _floor = next(_stream(4, 1))
    version += batches[-1][0]
    want = a.resolve_batch(version, txns)
    packed = tdev.pack_batch(txns, b.oldest_version, b._offset, 32)
    dev_codes = b.resolve_arrays(version, *packed[:8], sync=False)
    assert isinstance(dev_codes, torch.Tensor) and dev_codes.dtype == torch.int32
    assert [TVerdict(int(c)) for c in dev_codes[: len(txns)]] == want
    b.check_pipelined()
    assert b.export_state()["runs_ver"].tolist() == a.export_state()["runs_ver"].tolist()
    with pytest.raises(ValueError):
        b.resolve_batch(version, [])  # not after the last batch
    ks = b.kernel_stats()
    assert ks["backend"] == "cpu"
    assert ks["batches"] == len(batches) + 1
    assert ks["runs_appended"] == len(batches) + 1
    assert ks["node_count"] == b.node_count > 0
    assert b.healthcheck()


def test_fixpoint_iterations_cost_no_host_sync(monkeypatch):
    """The fixpoint's iterations stay on the device: host_syncs counts one
    read a synchronous batch (its verdicts) and none a pipelined one,
    however many iterations ran; the set's total equals the sum of what
    phase_intra returned for the same batches; reading it is one read."""
    counts = []
    phase_intra = tdev.phase_intra

    def recording(*args):
        intra, n_iters = phase_intra(*args)
        counts.append(int(n_iters))
        return intra, n_iters

    monkeypatch.setattr(tdev, "phase_intra", recording)
    s = tdev.DeviceConflictSet(run_slots=8, device="cpu")  # no compaction
    chain = [TTxInfo(0, [(b"k%02d" % (t - 1), b"k%02d\x00" % (t - 1))] if t else [],
                     [(b"k%02d" % t, b"k%02d\x00" % t)]) for t in range(12)]
    s.resolve_batch(1, chain)
    for version, txns, _floor in _stream(9, 3):
        s.resolve_batch(version + 1, txns)
    assert s.host_syncs == 4 and counts[0] >= 12
    version += 1
    for txns in (chain, chain[:5]):
        version += 1
        packed = tdev.pack_batch(txns, s.oldest_version, s._offset, 32)
        s.resolve_arrays(version, *packed[:8], sync=False)
    assert s.host_syncs == 4 and len(counts) == 6
    assert s.fixpoint_iterations() == sum(counts)
    assert s.host_syncs == 5


def test_resolve_deferred_is_synchronous():
    s = tdev.DeviceConflictSet(**SMALL, device="cpu")
    t = TTxInfo(0, [(b"a", b"b")], [(b"a", b"b")])
    assert s.resolve_deferred(1, [t]).wait() == [TVerdict.COMMITTED]
    assert s.resolve_deferred(2, [TTxInfo(0, [(b"a", b"b")], [])]).wait() == [
        TVerdict.CONFLICT
    ]


def test_default_device_is_cuda_and_raises_without_one(monkeypatch):
    """DeviceConflictSet() means CUDA; with no CUDA device it raises and
    never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.DeviceConflictSet()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.DeviceConflictSet(device="cuda")
    assert tdev.DeviceConflictSet(device="cpu").device.type == "cpu"


def test_port_set_as_reference_cluster_backend():
    """The port's set as the conflict backend of the reference SimCluster:
    the Cycle ring holds and every ConflictRange round checks out."""
    c = SimCluster(
        seed=24,
        n_resolvers=2,
        conflict_backend=lambda: tdev.DeviceConflictSet(
            capacity=1 << 12, device="cpu"
        ),
    )
    w = CycleWorkload(nodes=8, clients=2, txns_per_client=5)
    cr = ConflictRangeWorkload(rounds=10)
    metrics = run_workloads(c, [w, cr])
    assert metrics["Cycle"]["committed"] == 10
    assert metrics["ConflictRange"]["checked"] == 10
    c.stop()


def test_import_needs_neither_jax_nor_the_reference_package():
    """With jax made unimportable, every module of the port imports and no
    module of the reference package gets loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "before = set(sys.modules)\n"
        "import foundationdb_tpu_torch\n"
        "from foundationdb_tpu_torch import keys\n"
        "from foundationdb_tpu_torch.ops import rmq, search\n"
        "from foundationdb_tpu_torch.conflict import api, oracle, kernels, device, _build\n"
        "from foundationdb_tpu_torch.conflict import pipeline\n"
        "from foundationdb_tpu_torch import profile_kernel\n"
        "from foundationdb_tpu_torch.parallel import sharded\n"
        "from foundationdb_tpu_torch.runtime import coverage, metrics\n"
        "bad = sorted(m for m in set(sys.modules) - before\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'foundationdb_tpu'))\n"
        "assert not bad, bad\n"
        "s = device.DeviceConflictSet(device='cpu')\n"
        "print(s.resolve_batch(1, [api.TxInfo(0, [(b'a', b'b')], [(b'a', b'b')])]))\n"
        "m = sharded.ShardedDeviceConflictSet([b'm'], devices=['cpu'])\n"
        "print(m.resolve_batch(1, [api.TxInfo(0, [(b'a', b'z')], [(b'a', b'z')])]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO_ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("COMMITTED") == 2
