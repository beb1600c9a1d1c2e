"""The bench's timed region, batch by batch, on the card.

    python -m foundationdb_tpu_torch.bench_debug              # the card
    python -m foundationdb_tpu_torch.bench_debug --device cpu

Port of the repository root's bench_debug.py.  The bench's default set
(incremental, flat main of 2**19 rows) is prefilled with the bench's 8
batches; 4 more are staged on the device with stage_batch and
synchronized first.  Then each goes through resolve_arrays(sync=False):
its dispatch is timed on the host clock, and its execution with the read
of one scalar of its verdicts (the padded verdicts' sum, which waits for
the batch).  check_pipelined() closes the stream.  Prints the reference's
lines: the prefill, each batch's times and verdict sum, the count after.
The device is CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import bench as B
from .conflict import device as D

TIMED = 4


def stream(txns: int = B.TXNS_PER_BATCH, prefill: int = B.PREFILL_BATCHES,
           timed: int = TIMED):
    """The bench's stream: (the pool's lane words, the prefill batches, the
    timed batches), each batch as gen_batch's index arrays."""
    rng = np.random.default_rng(B.SEED)
    pool = B.gen_pool(rng)
    versions = iter(range(1, 10_000))
    pre = [B.gen_batch(rng, pool, next(versions), txns) for _ in range(prefill)]
    batches = [B.gen_batch(rng, pool, next(versions), txns) for _ in range(timed)]
    return B.pool_to_words(pool), pre, batches


def run(device=None, *, txns: int = B.TXNS_PER_BATCH, cap: int = B.CAP,
        prefill: int = B.PREFILL_BATCHES, timed: int = TIMED) -> list:
    """The prefill, then `timed` staged batches one by one.  Returns one
    dict a batch: version, dispatch_ms, execute_ms (execution and the
    scalar's read) and verdict_sum."""
    dev = D.resolve_device(device)
    words, pre, batches = stream(txns, prefill, timed)

    cs = D.DeviceConflictSet(max_key_bytes=B.MAX_KEY_BYTES, capacity=cap, device=dev)
    print("prefilling...", flush=True)
    t0 = time.perf_counter()
    for b in pre:
        cs.resolve_arrays(b["version"], *B.device_pack(words, b, D._bucket))
    print(f"prefill done in {time.perf_counter() - t0:.1f}s, count={cs.boundary_count}",
          flush=True)

    staged = [(b["version"], D.stage_batch(dev, *B.device_pack(words, b, D._bucket)))
              for b in batches]
    B._synchronize(dev)  # staging forced: the batches are on the device
    out = []
    for v, tensors in staged:
        t0 = time.perf_counter()
        verdict = cs.resolve_arrays(v, *tensors, sync=False)
        t1 = time.perf_counter()
        s = int(verdict.sum())  # the scalar's read waits for the batch
        t2 = time.perf_counter()
        out.append(dict(version=v, dispatch_ms=1e3 * (t1 - t0),
                        execute_ms=1e3 * (t2 - t1), verdict_sum=s))
        print(f"batch v={v}: dispatch {1e3 * (t1 - t0):.1f} ms, "
              f"execute+scalar-fetch {1e3 * (t2 - t1):.1f} ms (verdict sum {s})",
              flush=True)
    cs.check_pipelined()
    print("count after:", cs.boundary_count, flush=True)
    return out


def main(argv=None) -> int:
    from .profile_kernel import card_line

    ap = argparse.ArgumentParser(prog="python -m foundationdb_tpu_torch.bench_debug",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(f"card: {card_line(D.resolve_device(args.device))}", flush=True)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
