"""The port's profile2 on the CPU: its rows are the reference's (root
profile2.py), in order and with its labels, and its four sparse-table
builds agree: the stacked, concatenated and rolled tables equal each other
and the JAX package's build_sparse_table, and the disjoint pyramid equals
the reference's pyramid expression."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops.rmq import build_sparse_table as ref_build
from foundationdb_tpu_torch import profile2
from foundationdb_tpu_torch.ops.rmq import build_sparse_table


def _reference_labels():
    """The labels root profile2.py prints, in its order (:35-153)."""
    out = [f"gather rows k={k:>7}" for k in (1 << 14, 1 << 16, 1 << 17, 1 << 18, 1 << 19)]
    out += [f"gather scalars k={k:>7}" for k in (1 << 16, 1 << 19)]
    for m in (1 << 16, 1 << 18, 1 << 19):
        for k in (1 << 14, 1 << 16, 1 << 18):
            if k <= m:
                out.append(f"scat-set scalars k={k:>7} m={m:>7}")
    out += ["scat-set scalars drop-mode", "scat-set scalars sorted idx",
            "scat-set scalars sorted+hints", "scat-set rows k=65K m=524K",
            "scat-add scalars k=65K m=524K", "hist via sort+searchsorted k=65K m=524K"]
    out += [f"sort i32+payload k={k:>7}" for k in (1 << 16, 1 << 18, (1 << 19) + (1 << 14))]
    out += ["sort 2-key+1payload k=524K", "table build (current, stack of L)",
            "table build (concat out)", "table build (fori dyn-update)",
            "disjoint pyramid build (total 2N)", "elementwise max CAP x20",
            "concat shift + max, one level", "cumsum CAP", "searchsorted 49K into CAP"]
    return out


def test_the_rows_are_the_reference_rows():
    rows = profile2.rows("cpu")
    assert [label for label, _fn, _args in rows] == _reference_labels()
    table, idx = dict((r[0], r[2]) for r in rows)["gather rows k=  16384"]
    assert table.shape == (profile2.CAP, profile2.W) and idx.shape == (1 << 14,)


@pytest.mark.parametrize("n", [1, 2, 5, 64, 1000, 1 << 12])
def test_the_table_builds_agree(n):
    v = np.random.default_rng(n).integers(0, 1 << 20, size=n).astype(np.int32)
    t = torch.from_numpy(v)
    want = np.asarray(ref_build(jnp.asarray(v), jnp.maximum, 0))
    stacked = build_sparse_table(t, torch.maximum, 0).numpy()
    np.testing.assert_array_equal(stacked, want)
    np.testing.assert_array_equal(profile2.build_rolled(t).numpy(), want)
    np.testing.assert_array_equal(profile2.build_concat(t).numpy(), want.ravel())
    # the reference's pyramid: each level the pairwise max of the last
    prev, levels = jnp.asarray(v), [jnp.asarray(v)]
    while prev.shape[0] > 1:
        h = prev.shape[0] // 2
        prev = jnp.maximum(prev[0:2 * h:2], prev[1:2 * h:2])
        levels.append(prev)
    got = profile2.build_pyramid(t)
    assert len(got) == len(levels)
    for g, w in zip(got, levels):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_the_table_runs_on_the_cpu(capsys):
    timed = profile2.run("cpu")
    assert [label for label, _ms in timed] == _reference_labels()
    assert "cumsum CAP" in capsys.readouterr().out
