"""The benchmark of the PyTorch and CUDA port (`foundationdb_tpu_torch`): the
resolver's conflict check on one card, fed a pipelined stream of commit
batches over a full MVCC window.

    python3 -m resolverbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json at the repository's root names the cells.  Everything that
belongs to one configuration, traffic mix or metric is a file of its own,
found by name (registry.py): `configs/<config>.json`,
`workloads/<traffic>.json`, the generator a mix names
(`traffic/<generator>.py`) and one reader a metric (`metrics/<metric>.py`).
The yardstick lives here too: the packed batch layout (layout.py), the
plain reference (reference.py), the trace reduction (trace.py) and the
controls of the comparison (control.py).  Nothing here imports JAX or the
JAX package; the reference imports nothing of the program.
"""
