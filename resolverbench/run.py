"""Run one cell of the resolver benchmark once, on one CUDA card.

    python3 -m resolverbench.run --workload rw16.b8k --seed 7 --seconds 10 --trace 0

From the root of a checkout.  Prints the set-up split as an earlier line,
then as its last line one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`checks`, each number compared with the reference beside its limit; the
same numbers are the last lines on standard error.  Exits 2 without a
result where there is no card or fewer than the cell asks for, and 3 where
a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from .harness import cache_env, forbidden_modules, log, run_cell  # noqa: E402
from .registry import ROOT, Registry  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env(ROOT)
    import torch

    registry = Registry()
    cell = registry.cell(args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: no result")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"{torch.cuda.device_count()} CUDA devices, the cell asks {cell['chips']}")
        return 2
    torch.set_num_threads(1)
    seed = args.seed & (2**64 - 1)
    out = run_cell(registry, args.workload, seed, args.seconds, bool(args.trace),
                   t_start=T_START)
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in registry.metrics(args.workload, kind):
        value = registry.reader(m["name"])(out["run"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        log(f"modules that must not load were loaded: {found}")
        return 3
    result = dict(out["result"], metrics=metrics, device=out["device"])
    if out["breakdown"] is not None:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    print(json.dumps({"setup": out["setup"]}), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
