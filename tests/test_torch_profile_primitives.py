"""The primitive table of the port's profile_kernel on the CPU: its rows are
the reference's (root profile_kernel.py `main`, :160-301), in its order and
with its labels, and at small shapes each row's output on the reference
table's seeded inputs equals the reference's expression on the same inputs
(the JAX package's functions, its jnp one-liners restated here): key rows
compare in the uint32 layout, everything else as integers, exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.conflict.device import _bucketed_lower_bound, resolve_core
from foundationdb_tpu.ops.rmq import build_sparse_table, query_sparse_table
from foundationdb_tpu_torch import profile_kernel as P
from foundationdb_tpu_torch.keys import from_lanes

SMALL = P.Shapes(cap=1 << 12, R=256, Wn=128, W=5, B=128)
SENT = 0xFFFFFFFF

# profile_kernel.py:160-301, in order
REFERENCE_LABELS = [
    "search: bucketed_lower_bound 49K q, 11 it",
    "p1: build_sparse_table over CAP",
    "p1: query_sparse_table 16K ranges",
    "p2: one R x Wn masked-min iteration",
    "p3: row scatter 16K rows into M",
    "p3: row scatter CAP rows into M (pos_old)",
    "p3: BOTH merge scatters (old+new)",
    "p3: scalar scatter-add 16K into M",
    "p3: scalar scatter CAP vals into M",
    "p3: cumsum over M",
    "p3: gather M rows from CAP",
    "p3: compaction scatter M rows -> CAP",
    "alt: argsort 16K int32",
    "alt: lexsort M rows (W keys)",
    "alt: sort M int32 + payload",
    "bucket: histogram scatter-add CAP -> 65K + cumsum",
    "WHOLE resolve_core kernel",
]


def _reference_rows(a: dict, s: P.Shapes) -> dict:
    """Each row's expression as the reference writes it, on the arrays."""
    j = {k: jnp.asarray(v) for k, v in a.items()}
    CAP, M, W, R, Wn, B = s.cap, s.M, s.W, s.R, s.Wn, s.B
    ks_rows, vs, q_rows = j["ks_rows"], j["vs"], j["q_rows"]
    tbl = build_sparse_table(vs, jnp.maximum, 0)

    def p2_iter(rb_r, re_r, wb_r, we_r, w_cand):
        ov = (wb_r[None, :] < re_r[:, None]) & (rb_r[:, None] < we_r[None, :])
        return jnp.min(jnp.where(ov, w_cand[None, :], 2**31 - 1), axis=1)

    def rows_into(n, idx, rows):
        return jnp.full((n, W), SENT, jnp.uint32).at[idx].set(rows, mode="drop")

    keep = j["keep"]
    pos = jnp.where(keep, jnp.cumsum(keep.astype(jnp.int32)) - 1, M)
    h_all = (ks_rows[:, 0] >> 16).astype(jnp.int32)
    return {
        REFERENCE_LABELS[0]: _bucketed_lower_bound(ks_rows, j["bidx"], jnp.int32(CAP),
                                                   q_rows, 11)[0],
        REFERENCE_LABELS[1]: tbl,
        REFERENCE_LABELS[2]: query_sparse_table(tbl, j["g_lo"], j["g_hi"], jnp.maximum, 0),
        REFERENCE_LABELS[3]: p2_iter(j["rb_r"], j["re_r"], j["wb_r"], j["we_r"],
                                     j["w_cand"]),
        REFERENCE_LABELS[4]: rows_into(M, j["scat_idx"], j["scat_rows"]),
        REFERENCE_LABELS[5]: rows_into(M, j["pos_old"], ks_rows),
        REFERENCE_LABELS[6]: rows_into(M, j["pos_old"], ks_rows)
        .at[j["scat_idx"]].set(j["scat_rows"], mode="drop"),
        REFERENCE_LABELS[7]: jnp.zeros(M, jnp.int32).at[j["scat_idx"]].add(1, mode="drop"),
        REFERENCE_LABELS[8]: jnp.zeros(M, jnp.int32).at[j["pos_old"]].set(vs, mode="drop"),
        REFERENCE_LABELS[9]: jnp.cumsum(jnp.zeros(M, jnp.int32)),
        REFERENCE_LABELS[10]: jnp.take(ks_rows, j["gidx"], axis=0),
        REFERENCE_LABELS[11]: rows_into(CAP, pos, j["mrows"]),
        REFERENCE_LABELS[12]: jnp.argsort(j["argsort_x"]),
        REFERENCE_LABELS[13]: jnp.lexsort(tuple(j["mrows"][:, w] for w in range(W - 1, -1, -1))),
        REFERENCE_LABELS[14]: jax.lax.sort((j["sort_k"], j["sort_p"]), num_keys=1),
        REFERENCE_LABELS[15]: jnp.cumsum(jnp.zeros(65537, jnp.int32).at[h_all + 1].add(1)),
        REFERENCE_LABELS[16]: resolve_core(
            ks_rows, vs, j["bidx"], jnp.int32(CAP // 2), q_rows[:R], q_rows[R:2 * R],
            j["r_tx"], q_rows[2 * R:2 * R + Wn], q_rows[2 * R + Wn:], j["w_tx"], j["snap"],
            j["active"], jnp.int32(1 << 20), cap=CAP, n_txn=B, n_read=R, n_write=Wn)[:6],
    }


def _as_numpy(x, key_rows: bool):
    if isinstance(x, tuple):
        return tuple(_as_numpy(v, key_rows and i == 1) for i, v in enumerate(x))
    return from_lanes(x) if key_rows else x.numpy()


# rows whose output is key rows (for the whole resolve: its new_ks, item 1)
KEY_ROW_OUTPUTS = {REFERENCE_LABELS[i] for i in (4, 5, 6, 10, 11)}


def test_the_rows_are_the_reference_rows():
    assert [label for label, _fn, _args in P.PRIMITIVES] == REFERENCE_LABELS
    assert P.TABLE_SHAPES == P.Shapes(cap=1 << 19, R=16384, Wn=8192, W=5, B=8192)
    assert P.TABLE_SHAPES.M == (1 << 19) + 2 * 8192


@pytest.fixture(scope="module")
def outputs():
    a = P.primitive_arrays(SMALL)
    x = P.primitive_inputs(a, SMALL, torch.device("cpu"))
    want = _reference_rows(a, SMALL)
    return {label: (fn(*args(x)), want[label]) for label, fn, args in P.PRIMITIVES}


@pytest.mark.parametrize("label", REFERENCE_LABELS)
def test_each_row_computes_the_reference_expression(outputs, label):
    got, want = outputs[label]
    if label == P.WHOLE:
        got = _as_numpy(got[:6], key_rows=True)
        names = ("verdict", "new_ks", "new_vs", "new_count", "new_bidx", "converged")
        for name, g, w in zip(names, got, want):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
        assert len(set(got[0].tolist())) > 1  # both commits and conflicts
        return
    got = _as_numpy(got, label in KEY_ROW_OUTPUTS)
    if isinstance(want, tuple):
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, np.asarray(w))
    else:
        np.testing.assert_array_equal(got, np.asarray(want))


def test_the_table_runs_small_and_prints_every_row(capsys):
    timed = P.primitive_table("cpu", SMALL)
    assert [label for label, _ms in timed] == REFERENCE_LABELS
    out = capsys.readouterr().out
    assert all(label in out for label in REFERENCE_LABELS)
    assert "shapes: CAP=4096 R=256 Wn=128 M=4352 W=5" in out
