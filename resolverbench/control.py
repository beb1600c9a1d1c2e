"""The controls of the comparison that decides `correct`: the plain
reference (the cell generator's `reference`) put in the program's place
with one guarantee of the configuration broken, read by the same
comparison a run makes.  Each has to come out as not correct.

    python3 -m resolverbench.control --workload rw16.b8k --seeds 1,2,3 --batches 400

  no_intra     the intra-batch check left out: a transaction that reads
               what an earlier committed one of its batch writes commits
               (the control: the step a faster check would be tempted to
               drop);
  no_history   the check against earlier batches left out;
  no_too_old   read versions below the MVCC floor checked as if live.

`--batches` is the number of window batches a run compares; the history
before the window is made as a run makes it.  The benchmark's own runs do
not run this.  Prints one JSON line a seed and control.
"""

from __future__ import annotations

import argparse
import json
import sys

from .harness import Batch, compare, load_cell
from .registry import Registry

CONTROLS = {
    "no_intra": dict(intra=False),
    "no_history": dict(history=False),
    "no_too_old": dict(too_old=False),
}


def control_verdicts(gen, last: int, write_only_below: int, broken: dict) -> list[Batch]:
    """Batches 0..last as the broken reference answers them."""
    return [Batch(i, gen.version(i), v.shape[0], verdicts=v)
            for i, v in enumerate(gen.reference(last, write_only_below, **broken))]


def run_control(registry, workload: str, seed: int, batches: int, control: str) -> dict:
    config, traffic = load_cell(registry, workload)
    gen = registry.generator(traffic["generator"]).Generator(config, traffic["traffic"], seed)
    live = gen.window // gen.step
    last = live + int(traffic["loop"]["warmup_batches"]) + batches - 1
    recs = control_verdicts(gen, last, live, CONTROLS[control])
    checks, _ = compare(gen, recs, live)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return dict(workload=workload, seed=seed, control=control, batches=batches,
                correct=correct, checks=checks)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--batches", type=int, required=True)
    p.add_argument("--controls", default=",".join(CONTROLS))
    args = p.parse_args(argv)
    registry = Registry()
    for seed in (int(s) for s in args.seeds.split(",")):
        for control in args.controls.split(","):
            out = run_control(registry, args.workload, seed & (2**64 - 1), args.batches,
                              control)
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
