"""The port's key lanes and ops (foundationdb_tpu_torch.keys / ops) held
against the reference package's numpy encoder and JAX ops on the CPU, on
seeded numpy inputs.  All integer: equality is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from foundationdb_tpu import keys as jkeys
from foundationdb_tpu.ops import rmq as jrmq
from foundationdb_tpu.ops import search as jsearch
from foundationdb_tpu_torch import keys as tkeys
from foundationdb_tpu_torch.ops import rmq as trmq
from foundationdb_tpu_torch.ops import search as tsearch


def _keys(rng, n, max_len=9):
    """Random byte keys with shared prefixes and trailing-NUL/0xFF edges."""
    alphabet = np.array([0, 1, 0x61, 0x62, 0xFE, 0xFF], dtype=np.uint8)
    out = []
    for _ in range(n):
        k = bytes(rng.choice(alphabet, size=int(rng.integers(0, max_len + 1))))
        out.append(k)
    return out


def _rows(rng, n, mkb=12, sentinels=0):
    """uint32 lane rows of random keys, plus `sentinels` sentinel rows."""
    enc = jkeys.encode_keys(_keys(rng, n, mkb), mkb)
    sent = np.full((sentinels, enc.shape[1]), 0xFFFFFFFF, dtype=np.uint32)
    return np.concatenate([enc, sent])


def _sorted_unique(rows):
    order = np.lexsort(rows.T[::-1])
    rows = rows[order]
    keep = np.ones(len(rows), bool)
    keep[1:] = np.any(rows[1:] != rows[:-1], axis=1)
    return rows[keep]


def test_encoders_byte_identical():
    rng = np.random.default_rng(1)
    ks = _keys(rng, 300)
    for mkb in (12, 32):
        assert np.array_equal(jkeys.encode_keys(ks, mkb), tkeys.encode_keys(ks, mkb))
        lens = np.array([len(k) for k in ks])
        assert np.array_equal(
            jkeys.encode_concat(b"".join(ks), lens, mkb),
            tkeys.encode_concat(b"".join(ks), lens, mkb),
        )
    fixed = rng.integers(0, 256, size=(50, 16), dtype=np.uint8)
    assert np.array_equal(jkeys.encode_fixed(fixed, 16), tkeys.encode_fixed(fixed, 16))
    enc = tkeys.encode_keys(ks, 12)
    assert [tkeys.decode_key(r) for r in enc] == ks
    with pytest.raises(tkeys.KeyTooLongError):
        tkeys.encode_keys([b"x" * 13], 12)


def test_lanes_preserve_order_and_round_trip():
    """Signed order of the flipped int32 lanes == byte-string order, and
    from_lanes inverts to_lanes without aliasing."""
    rng = np.random.default_rng(2)
    ks = _keys(rng, 400) + [b"", b"\x00", b"\xff" * 9]
    rows = np.concatenate([tkeys.encode_keys(ks, 12), tkeys.sentinel(12)[None]])
    lanes = tkeys.to_lanes(rows)
    assert lanes.dtype == torch.int32
    perm = tsearch.lexsort([lanes[:, w] for w in range(lanes.shape[1])])
    by_lanes = [bytes(ks[i]) if i < len(ks) else None for i in perm.tolist()]
    assert by_lanes[-1] is None  # the sentinel sorts last
    assert by_lanes[:-1] == sorted(ks)
    back = tkeys.from_lanes(lanes)
    assert back.dtype == np.uint32 and np.array_equal(back, rows)
    back[0, 0] ^= 1
    assert np.array_equal(tkeys.from_lanes(lanes), rows)


def test_length_lane_increment_wraps_like_uint32():
    """flip(0xFFFFFFFF) + 1 == flip(0) and flip(5) + 1 == flip(6): the
    upper-bound trick ranks sentinel rows as the uint32 reference does."""
    u = np.array([0xFFFFFFFF, 5, 0, 0x7FFFFFFF, 0x80000000], dtype=np.uint32)
    got = tkeys.from_lanes(tkeys.lane_inc(tkeys.to_lanes(u)))
    assert np.array_equal(got, u + np.uint32(1))
    rows = _rows(np.random.default_rng(3), 20, sentinels=3)
    want = rows.copy()
    want[:, -1] += np.uint32(1)
    got = tkeys.from_lanes(tkeys.with_last_lane_inc(tkeys.to_lanes(rows)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_lex_less_and_bounds_match_jax(seed):
    rng = np.random.default_rng(10 + seed)
    srt = _sorted_unique(_rows(rng, 200, sentinels=0))
    srt = np.concatenate([srt, _rows(rng, 0, sentinels=5)])  # sentinel pad
    q = _rows(rng, 80, sentinels=4)
    q = np.concatenate([q, srt[rng.integers(0, len(srt), 20)]])  # exact hits
    a = _rows(rng, 100, sentinels=2)
    b = np.concatenate([a[:30], _rows(rng, 72)])
    assert np.array_equal(
        np.asarray(jsearch.lex_less(jnp.asarray(a), jnp.asarray(b))),
        tsearch.lex_less(tkeys.to_lanes(a), tkeys.to_lanes(b)).numpy(),
    )
    for fn in ("lower_bound", "upper_bound"):
        want = np.asarray(getattr(jsearch, fn)(jnp.asarray(srt), jnp.asarray(q)))
        got = getattr(tsearch, fn)(tkeys.to_lanes(srt), tkeys.to_lanes(q))
        assert got.dtype == torch.int32
        assert np.array_equal(want, got.numpy()), fn


@pytest.mark.parametrize("W", [9, 17, 65, 257])
def test_wide_lex_less_and_bounds_match_jax(W):
    """lex_less decides at the first differing lane: the same rows behind
    a common prefix of W - 5 lanes (compares run to the end) and with a
    differing lane inside the prefix."""
    rng = np.random.default_rng(W)

    def wide(rows, fill=0x66666666):
        pad = np.full((len(rows), W - rows.shape[1]), fill, np.uint32)
        return np.concatenate([pad, rows], axis=1)

    srt = wide(_sorted_unique(_rows(rng, 120, sentinels=0)))
    q = wide(_rows(rng, 60, sentinels=3))
    q[:10, 3] = 0x66666665  # decided inside the prefix
    a = wide(_rows(rng, 80, sentinels=2))
    b = np.concatenate([a[:30], wide(_rows(rng, 52))])
    b[30:40, 1] = 0x66666667
    assert np.array_equal(
        np.asarray(jsearch.lex_less(jnp.asarray(a), jnp.asarray(b))),
        tsearch.lex_less(tkeys.to_lanes(a), tkeys.to_lanes(b)).numpy(),
    )
    for fn in ("lower_bound", "upper_bound"):
        want = np.asarray(getattr(jsearch, fn)(jnp.asarray(srt), jnp.asarray(q)))
        got = getattr(tsearch, fn)(tkeys.to_lanes(srt), tkeys.to_lanes(q))
        assert np.array_equal(want, got.numpy()), fn


def test_lexsort_matches_numpy():
    rng = np.random.default_rng(4)
    cols = [rng.integers(-3, 3, 500).astype(np.int32) for _ in range(5)]
    cols[1] = rng.integers(-(2**31), 2**31 - 1, 500, dtype=np.int64).astype(np.int32)
    want = np.lexsort(cols[::-1], axis=0)  # stable, first column primary
    got = tsearch.lexsort([torch.from_numpy(c) for c in cols])
    assert np.array_equal(want, got.numpy())


def test_floor_log2_exact():
    xs = [1, 2, 3, 4, 5, 7, 8, 1023, 1024, 1025]
    xs += [(1 << k) - 1 for k in range(2, 32)] + [1 << k for k in range(31)]
    xs += list(np.random.default_rng(5).integers(1, 2**31 - 1, 1000))
    x = np.array(xs, dtype=np.int64)
    got = trmq.floor_log2(torch.from_numpy(x.astype(np.int32))).numpy()
    want = np.array([int(v).bit_length() - 1 for v in x])
    assert np.array_equal(got, want)
    assert np.array_equal(
        got, np.asarray(jrmq.floor_log2(jnp.asarray(x.astype(np.int32))))
    )


@pytest.mark.parametrize("n", [1, 2, 37, 256])
def test_sparse_table_matches_jax(n):
    rng = np.random.default_rng(n)
    vals = rng.integers(0, 1000, n).astype(np.int32)
    lo = rng.integers(-2, n + 2, 200).astype(np.int32)
    hi = rng.integers(-2, n + 2, 200).astype(np.int32)
    for jop, top, ident in ((jnp.maximum, torch.maximum, 0),
                            (jnp.minimum, torch.minimum, jrmq.I32_MAX)):
        jt = jrmq.build_sparse_table(jnp.asarray(vals), jop, ident)
        tt = trmq.build_sparse_table(torch.from_numpy(vals), top, ident)
        assert np.array_equal(np.asarray(jt), tt.numpy())
        want = jrmq.query_sparse_table(jt, jnp.asarray(lo), jnp.asarray(hi), jop, ident)
        got = trmq.query_sparse_table(tt, torch.from_numpy(lo), torch.from_numpy(hi),
                                      top, ident)
        assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("op_name", ["min", "max"])
def test_range_update_point_query_matches_jax(op_name):
    rng = np.random.default_rng(7)
    n = 300
    lo = rng.integers(0, n, 120).astype(np.int32)
    hi = (lo + rng.integers(1, 60, 120)).clip(max=n).astype(np.int32)
    val = rng.integers(0, 500, 120).astype(np.int32)
    mask = rng.random(120) < 0.8
    ident = jrmq.I32_MAX if op_name == "min" else 0
    want = jrmq.range_update_point_query(
        n, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(val),
        jnp.asarray(mask), op_name, ident,
    )
    got = trmq.range_update_point_query(
        n, torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(val),
        torch.from_numpy(mask), op_name, ident,
    )
    assert np.array_equal(np.asarray(want), got.numpy())
