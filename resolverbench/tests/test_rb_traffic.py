"""The generator: deterministic by seed, the same sizes for every seed,
YCSB's keys and request distribution."""

import numpy as np
import pytest

from resolverbench.harness import load_cell
from resolverbench.tests.conftest import TINY, small_tree
from resolverbench.traffic import point_txns

CELLS = ("rw16.b8k", "ycsb_f.zipf099.b8k")


def make(reg, cell, seed):
    config, traffic = load_cell(reg, cell)
    return reg.generator(traffic["generator"]).Generator(config, traffic["traffic"], seed)


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_batches_in_any_order(cell, tiny):
    a, b = make(tiny, cell, 2**31 + 17), make(tiny, cell, 2**31 + 17)
    order = [45, 3, 60, 3]
    for i in order:
        x, y = a.batch(i), b.batch(i)
        for k in ("reads", "writes", "snaps"):
            assert np.array_equal(x[k], y[k])
        assert (x["version"], x["oldest"]) == (y["version"], y["oldest"])
    assert np.array_equal(a.batch(5, True)["writes"], b.batch(5, True)["writes"])
    ka, kb = a.key_bytes(np.arange(50)), b.key_bytes(np.arange(50))
    assert np.array_equal(ka[0], kb[0]) and np.array_equal(ka[1], kb[1])


@pytest.mark.parametrize("cell", CELLS)
def test_other_seeds_other_batches_of_the_same_sizes(cell, tiny):
    a, b = make(tiny, cell, 1), make(tiny, cell, 2)
    x, y = a.batch(50), b.batch(50)
    assert not np.array_equal(x["reads"], y["reads"])
    for k in ("reads", "writes", "snaps"):
        assert x[k].shape == y[k].shape


@pytest.mark.parametrize("cell", CELLS)
def test_snapshots_lag_one_to_four_batches_or_fall_below_the_floor(cell, tiny):
    g = make(tiny, cell, 9)
    for i in (0, 3, 39, 41, 60):
        b = g.batch(i)
        assert b["version"] == (i + 1) * g.step
        assert b["oldest"] == max(0, i * g.step - g.window)
        lag = (b["version"] - b["snaps"]) // g.step
        fresh = b["snaps"] >= b["oldest"]
        assert ((lag[fresh] >= 1) & (lag[fresh] <= 4) | (b["snaps"][fresh] == 0)).all()
        if b["oldest"] == 0:
            assert fresh.all()
    stale = sum(int((g.batch(i)["snaps"] < g.oldest(i)).sum()) for i in range(41, 140))
    assert stale > 0
    w = g.batch(10, write_only=True)
    assert w["reads"].shape[1] == 0 and (w["snaps"] == w["version"] - g.step).all()


def _java_abs_fnv(i: int) -> int:
    h = point_txns.FNV_OFFSET_64
    for _ in range(8):
        h ^= i & 0xFF
        h = (h * point_txns.FNV_PRIME_64) % 2**64
        i >>= 8
    s = h - 2**64 if h >= 2**63 else h
    return s if s == -2**63 else abs(s)


def test_ycsb_keys_are_user_and_the_fnv_hash_in_decimal():
    ids = np.array([0, 1, 2, 255, 256, 2**31, 9_999_999] +
                   list(np.random.default_rng(3).integers(0, 10**7, 40)), dtype=np.int64)
    rows, lens = point_txns.ycsb_key_bytes(point_txns.fnv_hash64(ids), 32)
    for i, row, n in zip(ids.tolist(), rows, lens):
        want = b"user" + str(_java_abs_fnv(i)).encode()
        assert bytes(row[:n]) == want and not row[n:].any()
    mn, _ = point_txns.ycsb_key_bytes(np.array([-2**63], dtype=np.int64), 32)
    assert bytes(mn[0][:24]) == b"user-9223372036854775808"


def _ycsb_scrambled_zipfian(u: float, records: int) -> int:
    """ScrambledZipfianGenerator.nextValue at theta 0.99 for one draw u,
    line by line after YCSB's Java (ZipfianGenerator.nextLong)."""
    items, zetan, theta = 10**10 + 1, 26.46902820178302, 0.99
    zeta2theta = 1 + 0.5**theta
    alpha = 1 / (1 - theta)
    eta = (1 - (2 / items) ** (1 - theta)) / (1 - zeta2theta / zetan)
    uz = u * zetan
    if uz < 1.0:
        ret = 0
    elif uz < 1.0 + 0.5**theta:
        ret = 1
    else:
        ret = int(items * (eta * u - eta + 1) ** alpha)
    h = _java_abs_fnv(ret)
    return h % records if h >= 0 else -(-h % records)


def test_scrambled_zipfian_is_ycsbs(tmp_path):
    g = make(small_tree(tmp_path, dict(TINY, config={"key_count": 10**7})),
             "ycsb_f.zipf099.b8k", 4)
    u = np.concatenate([[0.0, 0.01, 0.03, 0.0378, 0.0379, 0.05, 0.5, 0.999999],
                        np.random.default_rng(1).random(200)])
    got = g.scrambled_zipfian(u)
    assert got.tolist() == [_ycsb_scrambled_zipfian(x, 10**7) for x in u.tolist()]
    draws = g._draw(np.random.default_rng(0), 400_000)
    assert draws.min() >= 0 and draws.max() < 10**7
    hot = _java_abs_fnv(0) % 10**7
    assert abs(float((draws == hot).mean()) - 1 / 26.46902820178302) < 0.002
