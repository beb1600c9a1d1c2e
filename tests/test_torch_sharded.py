"""The port's multi-resolver set (foundationdb_tpu_torch.parallel.sharded)
held against the reference ShardedDeviceConflictSet on the virtual CPU mesh
of tests/conftest.py (4 and 8 devices): verdicts and every partition's
state, stacked in the reference's [n, ...] layout, batch by batch, on
tests/test_sharded.py's shapes, incremental (the legacy modes and
test_merge_impl_sharded_parity's shapes are in
test_torch_sharded_merges.py); the verdicts also against N partition
oracles merged with min.  Then the state carried from the reference into
the port, partitions placed by a device list, the pipelined modes, the
regrows, the host reads, and the constructor's checks."""

import random

import numpy as np
import pytest
import torch

from foundationdb_tpu.parallel.sharded import ShardedDeviceConflictSet as JSharded
from foundationdb_tpu.parallel.sharded import make_resolver_mesh
from foundationdb_tpu_torch.conflict import device as tdev
from foundationdb_tpu_torch.parallel import sharded as tsh
from tests.test_sharded import SPLITS, SPLITS8, MultiOracle, random_tx

CPU = ["cpu"]


@pytest.fixture(scope="module")
def mesh():
    return make_resolver_mesh(4)


@pytest.fixture(scope="module")
def mesh8():
    return make_resolver_mesh(8)


def ref_state(d) -> dict:
    """The reference set's arrays in the port's export_state() layout."""
    out = dict(
        ks=np.asarray(d._ks), vs=np.asarray(d._vs), bidx=np.asarray(d._bidx),
        counts=(np.asarray(d._dev_counts).astype(np.int64) if d._counts is None
                else np.asarray(d._counts)),
        cap=d._cap, base=d._base, oldest=d._oldest, last_commit=d._last_commit,
        merge_impl=d._merge_impl,
    )
    if d._incremental:
        out.update(runs_b=np.asarray(d._runs_b), runs_e=np.asarray(d._runs_e),
                   runs_ver=np.asarray(d._runs_ver), n_runs=d._n_runs,
                   run_cap=d._run_cap, K=d._K)
    if d._lsm:
        out.update(tab=np.asarray(d._tab), rec_ks=np.asarray(d._rec_ks),
                   rec_vs=np.asarray(d._rec_vs), rec_bidx=np.asarray(d._rec_bidx),
                   rec_counts=np.asarray(d._rec_dev_counts).astype(np.int64),
                   rec_cap=d._rec_cap)
    return out


def assert_same(want: dict, got: dict, where) -> None:
    assert set(got) == set(want), (where, set(got) ^ set(want))
    for k in want:
        assert np.array_equal(np.asarray(want[k]), np.asarray(got[k])), (where, k)


def sharded_stream(seed, n_batches, n_txns=9, window=8, gc_every=None):
    """tests/test_sharded.py's batches: (version, txns, GC floor or None)."""
    rng = random.Random(seed)
    version = 0
    for i in range(n_batches):
        version += rng.randrange(1, 5)
        txns = [random_tx(rng, max(version - window, 0), version - 1)
                for _ in range(rng.randrange(1, n_txns))]
        floor = None
        if gc_every and i % gc_every == gc_every - 1:
            floor = max(version - 6, 0)
        yield version, txns, floor


def held_against_jax(mesh, splits, stream, **args):
    """The stream through the reference set, the port (on the CPU) and
    the multi-oracle: identical verdicts and per-partition state after
    every batch.  Returns (reference, port)."""
    ref = JSharded(mesh, splits, **args)
    port = tsh.ShardedDeviceConflictSet(splits, devices=CPU, **args)
    oracle = MultiOracle(splits)
    assert_same(ref_state(ref), port.export_state(), "fresh")
    for version, txns, floor in stream:
        want = oracle.resolve_batch(version, txns)
        assert ref.resolve_batch(version, txns) == want
        assert port.resolve_batch(version, txns) == want, version
        assert_same(ref_state(ref), port.export_state(), version)
        for name in ("compactions", "search_fallbacks", "regrows"):
            assert getattr(port, name) == getattr(ref, name), (name, version)
        if floor is not None:
            for s in (ref, port, oracle):
                s.remove_before(floor)
    return ref, port


MODES = {
    "inc-flat": dict(incremental=True),
    "inc-lsm-bucket": dict(incremental=True, lsm=True, search_impl="bucket"),
    "legacy-flat": dict(incremental=False, search_impl="bucket"),
    "legacy-lsm": dict(incremental=False, lsm=True),
}


def on_4_partitions(mesh, mode):
    """test_sharded.py's stream with GC on the 4-device mesh, at capacities
    that make the runs grow and compact and the fold regrow main
    (incremental), main regrow (flat legacy) and the recent level compact
    (LSM legacy).  Returns the port's set."""
    args = dict(MODES[mode], capacity=4, run_slots=2, run_capacity=16,
                recent_capacity=33)
    _ref, port = held_against_jax(mesh, SPLITS, sharded_stream(7, 7, 17, gc_every=3),
                                  **args)
    assert port.regrows >= 1 and port.capacity > 4
    return port


@pytest.mark.parametrize("mode", ["inc-flat", "inc-lsm-bucket"])
def test_sharded_matches_reference_on_4_partitions(mesh, mode):
    """The incremental modes (the legacy ones: test_torch_sharded_merges.py)."""
    port = on_4_partitions(mesh, mode)
    assert port.compactions >= 2 and port._run_cap > 16


def test_sharded_matches_reference_on_8_partitions(mesh8):
    """The 8-device mesh (the dry run's scale), the constructor default."""
    _ref, port = held_against_jax(mesh8, SPLITS8, sharded_stream(23, 8, gc_every=3),
                                  capacity=1 << 6, run_slots=3)
    assert port.compactions >= 1
    assert port.export_state()["ks"].shape[0] == 8


def test_state_carry_from_reference(mesh):
    """A best-known-layout state built by the reference loads into the
    port, and both go on identically."""
    args = dict(capacity=32, lsm=True, search_impl="bucket", run_slots=2,
                run_capacity=16)
    batches = list(sharded_stream(41, 10, gc_every=3))
    ref = JSharded(mesh, SPLITS, **args)
    for version, txns, floor in batches[:5]:
        ref.resolve_batch(version, txns)
        if floor is not None:
            ref.remove_before(floor)
    port = tsh.ShardedDeviceConflictSet(SPLITS, devices=CPU, **args)
    port.load_state(ref_state(ref))
    assert_same(ref_state(ref), port.export_state(), "loaded")
    for version, txns, floor in batches[5:]:
        assert port.resolve_batch(version, txns) == ref.resolve_batch(version, txns)
        assert_same(ref_state(ref), port.export_state(), version)
        if floor is not None:
            ref.remove_before(floor)
            port.remove_before(floor)
    with pytest.raises(ValueError, match="partitions"):
        tsh.ShardedDeviceConflictSet(SPLITS[:2], devices=CPU, **args).load_state(
            ref_state(ref))


@pytest.mark.parametrize("incremental", [True, False], ids=["inc", "legacy"])
def test_device_list_places_partitions(incremental):
    """devices=["cpu", "cpu"]: partition p on devices[p % 2]; the same
    verdicts and state as with one device."""
    args = dict(capacity=16, lsm=True, incremental=incremental, run_slots=2,
                run_capacity=16, recent_capacity=33)
    one = tsh.ShardedDeviceConflictSet(SPLITS, devices=CPU, **args)
    two = tsh.ShardedDeviceConflictSet(SPLITS, devices=["cpu", "cpu"], **args)
    assert len(two._devs) == 4 and all(d.type == "cpu" for d in two._devs)
    for version, txns, floor in sharded_stream(5, 8, gc_every=3):
        assert one.resolve_batch(version, txns) == two.resolve_batch(version, txns)
        assert_same(one.export_state(), two.export_state(), version)
        if floor is not None:
            one.remove_before(floor)
            two.remove_before(floor)
    assert one.fixpoint_iterations() == two.fixpoint_iterations() > 0


@pytest.mark.parametrize("mode", list(MODES))
def test_pipelined_modes_match_sync(mode):
    """resolve_arrays(sync=False) two batches in flight and resolve_deferred
    equal the synchronous set; the verdicts come back as device tensors,
    the fixpoint's iterations summed across partitions without a host read
    per partition."""
    args = dict(MODES[mode], capacity=16, run_slots=2, run_capacity=16,
                recent_capacity=33)
    sync = tsh.ShardedDeviceConflictSet(SPLITS, devices=CPU, **args)
    arrays = tsh.ShardedDeviceConflictSet(SPLITS, devices=CPU, **args)
    deferred = tsh.ShardedDeviceConflictSet(SPLITS, devices=CPU, **args)
    pending, handles = [], []
    for version, txns, floor in sharded_stream(9, 10, gc_every=4):
        want = sync.resolve_batch(version, txns)
        packed = tdev.pack_batch(txns, arrays.oldest_version, arrays._offset, 32)
        pending.append((arrays.resolve_arrays(version, *packed[:8], sync=False),
                        want))
        if len(pending) > 2:
            got, w = pending.pop(0)
            assert isinstance(got, torch.Tensor)
            assert [int(c) for c in got[: len(w)]] == [int(v) for v in w]
        handles.append((deferred.resolve_deferred(version, txns), want))
        if floor is not None:
            for s in (sync, arrays, deferred):
                s.remove_before(floor)
    for got, w in pending:
        assert [int(c) for c in got[: len(w)]] == [int(v) for v in w]
    arrays.check_pipelined()
    for h, w in handles:
        assert h.wait() == w
    assert arrays.fixpoint_iterations() == sync.fixpoint_iterations()
    if not mode.startswith("legacy-lsm"):  # (LSM compacts on count bounds)
        assert_same(sync.export_state(), arrays.export_state(), mode)
        assert_same(sync.export_state(), deferred.export_state(), mode)


def test_constructor_checks_and_backend(monkeypatch):
    with pytest.raises(ValueError, match="strictly increasing"):
        tsh.ShardedDeviceConflictSet([b"\x02", b"\x01"], devices=CPU)
    with pytest.raises(ValueError, match="strictly increasing"):
        tsh.ShardedDeviceConflictSet([b"\x01", b"\x01"], devices=CPU)
    with pytest.raises(ValueError, match="merge_impl"):
        tsh.ShardedDeviceConflictSet(SPLITS, merge_impl="heap", devices=CPU)
    s = tsh.ShardedDeviceConflictSet(SPLITS, devices=CPU)
    assert s.kernel_stats()["backend"] == "sharded-cpu"
    assert (s._incremental, s._lsm, s._search_impl, s.capacity) == (True, False, "sort", 1 << 14)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsh.ShardedDeviceConflictSet(SPLITS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsh.ShardedDeviceConflictSet(SPLITS, devices=["cpu", "cuda"])


def test_fixpoint_iterations_cost_no_host_read_per_partition(monkeypatch):
    """The partitions' verdicts, flags and fixpoint iterations fold on the
    first device: a synchronous sort-search batch reads one value on the
    host (its verdicts) whatever the number of partitions, and the set's
    iteration total (one more read) sums every partition's fixpoint."""
    counts = []
    phase_intra = tdev.phase_intra

    def recording(*args):
        intra, n_iters = phase_intra(*args)
        counts.append(int(n_iters))
        return intra, n_iters

    monkeypatch.setattr(tdev, "phase_intra", recording)
    s = tsh.ShardedDeviceConflictSet(SPLITS, devices=CPU, run_slots=8)
    batches = list(sharded_stream(13, 5))
    for version, txns, _floor in batches:
        s.resolve_batch(version, txns)
    assert s.host_syncs == len(batches) and len(counts) == 4 * len(batches)
    assert s.fixpoint_iterations() == sum(counts) > 0
    assert s.host_syncs == len(batches) + 1
