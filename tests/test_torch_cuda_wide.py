"""K1, K3 and K4 at the wider keys a conflict set widens to, on the card:
each held against its plain torch version on the same CUDA tensors (exact),
at W = 17, 65 and 129 lanes (64-, 256- and 512-byte keys), at small shapes
and at the stream's (K = 8 runs of 16384 rows, main at 2**19 rows); at W =
513 and 4097 (2048- and 16384-byte keys: fewer reads and queries a block,
K1 without a run summary) at small shapes, with one run (K1's block a
partial warp), and at the default set's (K = 8 runs of 4096 rows, main at
2**16 rows); and the
port's default set fed keys of 20 to 204 bytes on "cuda" against the same
set on "cpu": identical verdicts and state after every batch, widening
32 -> 64 -> 256 on both.

Marked `gpu`: every test asks the `cuda` fixture, which skips when no CUDA
device is present.  On a machine with the card:

    python -m pytest --noconftest tests/test_torch_cuda_wide.py -m gpu
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch import keys
from foundationdb_tpu_torch.conflict import device as tdev
from foundationdb_tpu_torch.conflict import kernels
from foundationdb_tpu_torch.conflict.api import TxInfo

pytestmark = pytest.mark.gpu

WIDE_W = (17, 65, 129)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sorted_rows(rng, n: int, W: int, live: int) -> np.ndarray:
    """n rows of W lanes: `live` sorted distinct keys of 4 * (W - 1) bytes
    that share all but their last word (so compares run to the end), the
    rest sentinel."""
    tail = np.unique(rng.integers(0, 1 << 30, size=live).astype(np.uint32))
    rows = np.full((n, W), 0xFFFFFFFF, np.uint32)
    rows[: len(tail), : W - 2] = 0x61616161
    rows[: len(tail), W - 2] = tail
    rows[: len(tail), W - 1] = 4 * (W - 1)
    return rows


def _runs(rng, K: int, run_cap: int, W: int):
    """K sorted, disjoint runs: begins and ends alternate over one sorted
    key list, each run sentinel-padded."""
    b = np.full((K, run_cap, W), 0xFFFFFFFF, np.uint32)
    e = b.copy()
    for k in range(K):
        rows = _sorted_rows(rng, 2 * run_cap, W, int(rng.integers(0, 2 * run_cap)))
        live = rows[rows[:, -1] != 0xFFFFFFFF]
        m = len(live) // 2
        b[k, :m], e[k, :m] = live[0 : 2 * m : 2], live[1 : 2 * m : 2]
    return b, e


@pytest.mark.parametrize("W", WIDE_W)
@pytest.mark.parametrize("shape", ["small", "stream"])
def test_wide_kernels_equal_their_plain_versions(cuda, W, shape):
    rng = np.random.default_rng(W)
    K, run_cap, cap, R = (3, 64, 1 << 10, 200) if shape == "small" else (
        8, 1 << 14, 1 << 19, 1 << 14)
    lanes = lambda a: keys.to_lanes(a, cuda)  # noqa: E731
    runs_b_np, runs_e_np = _runs(rng, K, run_cap, W)
    runs_b, runs_e = lanes(runs_b_np), lanes(runs_e_np)
    runs_ver = torch.from_numpy(rng.integers(0, 12, K).astype(np.int32)).to(cuda)
    reads = _sorted_rows(rng, R, W, R - 8)
    rng.shuffle(reads)
    rb, re_ = lanes(reads), keys.with_last_lane_inc(lanes(reads))
    snap = torch.from_numpy(rng.integers(0, 12, R).astype(np.int32)).to(cuda)
    r_ok = torch.from_numpy(rng.random(R) < 0.9).to(cuda)
    hist = torch.from_numpy(rng.random(R) < 0.05).to(cuda)
    k1 = (rb, re_, snap, r_ok, runs_b, runs_e, runs_ver, hist)
    assert torch.equal(kernels.probe_fused(*k1), kernels.probe_fused_plain(*k1))
    ks = lanes(_sorted_rows(rng, cap, W, cap // 2))
    rec, _ = kernels.run_to_step_plain(runs_b[0], runs_e[0], runs_ver[:1])
    assert torch.equal(kernels.compact_ranks(ks, rec), kernels.compact_ranks_plain(ks, rec))
    got = kernels.run_to_step_runs(runs_b, runs_e, runs_ver)
    want = kernels.run_to_step_runs_plain(runs_b, runs_e, runs_ver)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("W", (513, 4097))
@pytest.mark.parametrize("shape", ["small", "one_run", "default"])
def test_widest_kernels_equal_their_plain_versions(cuda, W, shape):
    rng = np.random.default_rng(W + 1)
    K, run_cap, cap, R = {"small": (3, 64, 1 << 10, 200),
                          "one_run": (1, 64, 1 << 10, 100),
                          "default": (8, 1 << 12, 1 << 16, 2048)}[shape]
    lanes = lambda a: keys.to_lanes(a, cuda)  # noqa: E731
    runs_b_np, runs_e_np = _runs(rng, K, run_cap, W)
    runs_b, runs_e = lanes(runs_b_np), lanes(runs_e_np)
    runs_ver = torch.from_numpy(rng.integers(0, 12, K).astype(np.int32)).to(cuda)
    reads = _sorted_rows(rng, R, W, R - 8)
    rng.shuffle(reads)
    rb, re_ = lanes(reads), keys.with_last_lane_inc(lanes(reads))
    snap = torch.from_numpy(rng.integers(0, 12, R).astype(np.int32)).to(cuda)
    r_ok = torch.from_numpy(rng.random(R) < 0.9).to(cuda)
    hist = torch.from_numpy(rng.random(R) < 0.05).to(cuda)
    k1 = (rb, re_, snap, r_ok, runs_b, runs_e, runs_ver, hist)
    assert torch.equal(kernels.probe_fused(*k1), kernels.probe_fused_plain(*k1))
    ks = lanes(_sorted_rows(rng, cap, W, cap // 2))
    rec, _ = kernels.run_to_step_plain(runs_b[0], runs_e[0], runs_ver[:1])
    assert torch.equal(kernels.compact_ranks(ks, rec), kernels.compact_ranks_plain(ks, rec))
    got = kernels.run_to_step_runs(runs_b, runs_e, runs_ver)
    want = kernels.run_to_step_runs_plain(runs_b, runs_e, runs_ver)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _long_stream(seed: int, lengths=(20, 31, 32, 33, 43, 204, None, None)):
    """(version, txns, gc floor or None): each batch's ranges have short
    endpoints or endpoints of the batch's length, mixed."""
    rng = np.random.default_rng(seed)

    def key(n):
        head = bytes(rng.choice(list(b"abcdefgh"), size=int(rng.integers(0, 4))))
        return head + b"~" * max(n - len(head), 0)

    def rng_range(L):
        if L is None or rng.random() < 0.5:
            k = key(int(rng.integers(0, 6)))
            return k, k + b"\x00"
        k = key(L - 1)
        return k, k + b"\x00"

    version = 0
    for i, L in enumerate(lengths):
        version += int(rng.integers(1, 6))
        txns = [TxInfo(int(rng.integers(max(version - 8, 0), version)),
                       [rng_range(L) for _ in range(int(rng.integers(0, 3)))],
                       [rng_range(L) for _ in range(int(rng.integers(1, 3)))])
                for _ in range(int(rng.integers(4, 12)))]
        yield version, txns, (max(0, version - 6) if i == 5 else None)


def test_default_set_widens_on_the_card_as_on_the_cpu(cuda):
    """A long-key stream through the default set and the best-known layout
    on "cuda" and on "cpu"."""
    small = dict(capacity=1 << 8, run_slots=3, run_capacity=32)
    for layout in ({}, dict(lsm=True, search_impl="bucket")):
        sets = [tdev.DeviceConflictSet(**layout, **small, device=d) for d in (cuda, "cpu")]
        for version, txns, floor in _long_stream(3):
            got, want = (s.resolve_batch(version, txns) for s in sets)
            assert got == want, version
            a, b = (s.export_state() for s in sets)
            assert a.keys() == b.keys()
            assert all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a), version
            if floor is not None:
                for s in sets:
                    s.remove_before(floor)
        assert [s.stats.key_bytes for s in sets] == [256, 256]
        assert sets[0].stats.widenings == sets[1].stats.widenings == 2
