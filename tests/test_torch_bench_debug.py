"""The port's bench_debug on the CPU: at a small size, each timed batch's
verdict sum equals the reference DeviceConflictSet's on the same stream
(the bench's prefill, one compaction, four batches dispatched with
sync=False), and with no card it raises."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.conflict.device import DeviceConflictSet
from foundationdb_tpu_torch import bench, bench_debug
from foundationdb_tpu_torch.conflict import device as tdev

TXNS, CAP = 96, 1 << 12


def _reference_sums() -> list:
    rng = np.random.default_rng(bench.SEED)
    pool = bench.gen_pool(rng)
    words = bench.pool_to_words(pool)
    batches = [bench.gen_batch(rng, pool, v, TXNS)
               for v in range(1, bench.PREFILL_BATCHES + bench_debug.TIMED + 1)]
    port_words, pre, timed = bench_debug.stream(TXNS)
    np.testing.assert_array_equal(port_words, words)
    for b, want in zip(pre + timed, batches, strict=True):
        assert b["version"] == want["version"]
        for k in ("reads", "writes", "snaps"):
            np.testing.assert_array_equal(b[k], want[k])
    dev = DeviceConflictSet(max_key_bytes=bench.MAX_KEY_BYTES, capacity=CAP)
    sums = []
    for i, b in enumerate(batches):
        args = bench.device_pack(words, b, tdev._bucket)
        if i < bench.PREFILL_BATCHES:
            dev.resolve_arrays(b["version"], *args)
        else:
            verdict = dev.resolve_arrays(b["version"], *args, sync=False)
            sums.append(int(jnp.sum(verdict.astype(jnp.int32))))
    dev.check_pipelined()
    assert dev.compactions >= 1
    return sums


def test_verdict_sums_equal_the_reference(capsys):
    got = bench_debug.run("cpu", txns=TXNS, cap=CAP)
    assert [r["verdict_sum"] for r in got] == _reference_sums()
    assert [r["version"] for r in got] == list(range(bench.PREFILL_BATCHES + 1,
                                                     bench.PREFILL_BATCHES + 5))
    out = capsys.readouterr().out
    assert out.count("execute+scalar-fetch") == 4 and "count after:" in out


def test_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_debug.run()
