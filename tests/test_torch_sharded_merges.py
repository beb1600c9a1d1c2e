"""The port's sharded set against the reference ShardedDeviceConflictSet
on the virtual CPU mesh, continued from test_torch_sharded.py: the legacy
modes (the flat full merge and the LSM recent level) on 4 partitions, and
each merge_impl's folds on test_merge_impl_sharded_parity's shapes
(tests/test_pallas.py): verdicts and every partition's state batch by
batch, and the multi-oracle's verdicts."""

import random

import pytest

from foundationdb_tpu.conflict.api import TxInfo
from foundationdb_tpu.parallel.sharded import make_resolver_mesh
from tests.test_pallas import _rand_key, _rand_range
from tests.test_torch_sharded import held_against_jax, on_4_partitions


@pytest.fixture(scope="module")
def mesh():
    return make_resolver_mesh(4)


@pytest.mark.parametrize("mode", ["legacy-flat", "legacy-lsm"])
def test_sharded_legacy_matches_reference_on_4_partitions(mesh, mode):
    port = on_4_partitions(mesh, mode)
    assert "runs_b" not in port.export_state()
    if mode == "legacy-lsm":
        assert port.compactions >= 2


@pytest.mark.parametrize("impl", ["scatter", "sort", "gather"])
def test_merge_impls_match_reference(impl):
    """test_merge_impl_sharded_parity's duplicate-heavy stream on 2
    partitions, per merge_impl, with a forced deferred fold."""
    mesh = make_resolver_mesh(2)
    rng = random.Random(17)
    stream, version = [], 0
    for _ in range(8):
        version += rng.randrange(1, 4)
        stream.append((version, [
            TxInfo(read_snapshot=max(version - 2, 0),
                   read_ranges=[_rand_range(rng)],
                   write_ranges=[(k := _rand_key(rng, b"abc", 3), k + b"\x00")])
            for _ in range(rng.randrange(1, 6))
        ], None))
    _ref, port = held_against_jax(mesh, [b"b"], stream, capacity=1 << 8,
                                  incremental=True, run_slots=2, run_capacity=32,
                                  merge_impl=impl)
    assert port.compactions >= 1
    assert port.kernel_stats()["merge_impl"] == impl
