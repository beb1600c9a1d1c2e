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
