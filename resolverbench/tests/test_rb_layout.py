"""The frozen packed-layout encoder against the program's own: the key
lanes of keys.py, the TxInfo packer and the bench's vectorised packer."""

import numpy as np
import pytest

from foundationdb_tpu_torch import bench, keys
from foundationdb_tpu_torch.conflict import device as tdev
from foundationdb_tpu_torch.conflict.api import TxInfo
from resolverbench import layout
from resolverbench.tests.test_rb_traffic import make


def test_key_lanes_are_keys_py_lanes_at_every_length():
    rng = np.random.default_rng(1)
    ks = [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in range(0, 33)]
    ks += [b"", b"\x00", b"a", b"a\x00", b"\xff" * 32]
    rows = np.zeros((len(ks), 32), dtype=np.uint8)
    for i, k in enumerate(ks):
        rows[i, :len(k)] = np.frombuffer(k, dtype=np.uint8)
    lens = np.array([len(k) for k in ks])
    assert np.array_equal(layout.key_lanes(rows, lens, 32), keys.encode_keys(ks, 32))
    fixed = rng.integers(0, 256, (100, 16), dtype=np.uint8)
    assert np.array_equal(layout.key_lanes(fixed, np.full(100, 16), 16),
                          keys.encode_fixed(fixed, 16))
    with pytest.raises(ValueError):
        layout.key_lanes(fixed, np.full(100, 16), 12)


@pytest.mark.parametrize("i", [5, 45, 77])
def test_pack_is_the_txinfo_packers_layout(i, tiny):
    """YCSB keys (at most 23 bytes, so [k, k + 0x00) fits 32), snapshots
    past the floor included."""
    g = make(tiny, "ycsb_f.zipf099.b8k", 11)
    b = g.batch(i)
    oldest = b["oldest"]
    kb, kl = g.key_bytes(np.arange(g.n_keys))
    key = [bytes(kb[j, :kl[j]]) for j in range(g.n_keys)]
    txns = [TxInfo(int(s), [(key[r], key[r] + b"\x00") for r in rr],
                   [(key[w], key[w] + b"\x00") for w in ww])
            for s, rr, ww in zip(b["snaps"], b["reads"], b["writes"])]
    want = tdev.pack_batch(txns, oldest, lambda v: max(v - oldest, 0), 32)[:8]

    def lanes_of(ids):
        return layout.key_lanes(*g.key_bytes(ids), 32)

    got = layout.pack(b["reads"], b["writes"], b["snaps"], oldest, lanes_of, 9)
    if i > 41:
        assert not got[7][: len(txns)].all()  # some TOO_OLD in the batch
    for w, x in zip(want, got):
        assert w.dtype == x.dtype and np.array_equal(w, x)


def test_pack_is_the_bench_packers_layout_at_16_byte_keys(tiny):
    g = make(tiny, "rw16.b8k", 12)
    b = g.batch(20)
    assert (b["snaps"] >= b["oldest"]).all()
    pool_words = bench.pool_to_words(g.pool)
    want = bench.device_pack(pool_words, dict(reads=b["reads"], writes=b["writes"][:, 0],
                                              snaps=b["snaps"]), tdev._bucket)

    def lanes_of(ids):
        return layout.key_lanes(*g.key_bytes(ids), 16)

    got = layout.pack(b["reads"], b["writes"], b["snaps"], 0, lanes_of, 5)
    for w, x in zip(want, got):
        assert np.array_equal(w, x)


def test_bucket_is_the_programs():
    for n in (0, 1, 15, 16, 17, 1000, 8192, 8193, 16384):
        assert layout.bucket(n) == tdev._bucket(n)


def _lanes(keys_, max_key_bytes):
    rows = np.zeros((len(keys_), max_key_bytes), dtype=np.uint8)
    for i, k in enumerate(keys_):
        rows[i, :len(k)] = np.frombuffer(k, dtype=np.uint8)
    return layout.key_lanes(rows, np.array([len(k) for k in keys_], dtype=np.int64),
                            max_key_bytes).reshape(len(keys_), max_key_bytes // 4 + 1)


def _flat(txns, side, max_key_bytes):
    """A TxInfo batch's read or write ranges as pack_ranges takes them."""
    ranges = [(b, e, t) for t, tx in enumerate(txns) for b, e in getattr(tx, side)]
    return (_lanes([r[0] for r in ranges], max_key_bytes),
            _lanes([r[1] for r in ranges], max_key_bytes),
            np.array([r[2] for r in ranges], dtype=np.int64))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_key_bytes", [8, 16, 32])
def test_pack_ranges_is_the_txinfo_packers_layout(seed, max_key_bytes):
    """Ragged ranges (0-15 a transaction) of keys of every length, b"" and
    all-0xff ends, empty ranges and TOO_OLD transactions."""
    rng = np.random.default_rng([seed, max_key_bytes])
    # few byte values, so keys share prefixes and ranges nest and touch
    lens = np.concatenate([np.arange(max_key_bytes + 1), rng.integers(0, max_key_bytes + 1, 30)])
    pool = [bytes(rng.integers(0xfd, 0x100, n, dtype=np.uint8)) for n in lens]
    pool += [b"", b"\xff" * max_key_bytes, b"\x00"] + [b"\xff" * n for n in range(1, 4)]

    def ranges():
        out = []
        for _ in range(rng.integers(0, 16)):
            a, b = (pool[j] for j in rng.integers(0, len(pool), 2))
            out.append((min(a, b), max(a, b)) if rng.random() < 0.8 else (a, b))
        return out

    B, oldest = int(rng.integers(1, 70)), 1000
    snaps = rng.integers(oldest - 50, oldest + 500, B)
    txns = [TxInfo(int(s), ranges(), ranges()) for s in snaps]
    want = tdev.pack_batch(txns, oldest, lambda v: max(v - oldest, 0), max_key_bytes)[:8]
    got = layout.pack_ranges(*_flat(txns, "read_ranges", max_key_bytes),
                             *_flat(txns, "write_ranges", max_key_bytes),
                             snaps, oldest, max_key_bytes // 4 + 1)
    for w, x in zip(want, got):
        assert w.dtype == x.dtype and np.array_equal(w, x)
    n_ranges = sum(len(t.read_ranges) + len(t.write_ranges) for t in txns)
    assert (got[2] >= 0).sum() + (got[5] >= 0).sum() < n_ranges  # some dropped


def test_pack_ranges_rejects_ranges_out_of_transaction_order():
    lanes = np.zeros((2, 5), dtype=np.uint32)
    none = np.zeros((0, 5), dtype=np.uint32)
    with pytest.raises(ValueError):
        layout.pack_ranges(lanes, lanes + 1, np.array([1, 0]), none, none, np.zeros(0, int),
                           np.zeros(2, int), 0, 5)
    with pytest.raises(ValueError):
        layout.pack_ranges(lanes, lanes + 1, np.array([0, 2]), none, none, np.zeros(0, int),
                           np.zeros(2, int), 0, 5)


@pytest.mark.parametrize("cell", ["rw16.b8k", "ycsb_f.zipf099.b8k"])
def test_pack_ranges_on_point_ranges_is_pack(cell, tiny):
    g = make(tiny, cell, 2**31 + 21)
    width = g.max_key_bytes // 4 + 1
    for i in (3, 44, 60):
        b = g.batch(i, i < g.window // g.step)
        B, r, w = b["snaps"].shape[0], b["reads"].shape[1], b["writes"].shape[1]
        rl, wl = g.lanes_of(b["reads"].ravel()), g.lanes_of(b["writes"].ravel())
        rl_end, wl_end = rl.copy(), wl.copy()
        rl_end[:, -1] += 1
        wl_end[:, -1] += 1
        got = layout.pack_ranges(rl, rl_end, np.repeat(np.arange(B), r), wl, wl_end,
                                 np.repeat(np.arange(B), w), b["snaps"], b["oldest"], width)
        for x, y in zip(layout.pack(b["reads"], b["writes"], b["snaps"], b["oldest"],
                                    g.lanes_of, width), got):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("cell", ["rw16.b8k", "ycsb_f.zipf099.b8k"])
def test_the_generators_pack_is_the_harness_call_it_replaced(cell, tiny):
    """`gen.pack` gives the bytes of the call the harness made itself
    before the generator owned it, TOO_OLD and write-only batches too."""
    g = make(tiny, cell, 2**31 + 23)
    width = g.max_key_bytes // 4 + 1

    def lanes_of(ids):
        rows, lens = g.key_bytes(ids)
        return layout.key_lanes(rows, lens, g.max_key_bytes)

    for i in (0, 39, 40, 48, 70):
        b = g.batch(i, i < g.window // g.step)
        want = layout.pack(b["reads"], b["writes"], b["snaps"], b["oldest"], lanes_of, width)
        for x, y in zip(want, g.pack(b, width)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
