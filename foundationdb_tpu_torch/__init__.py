"""PyTorch/CUDA port of foundationdb_tpu's resolver conflict check.

The JAX package `foundationdb_tpu` stays the reference; this package mirrors
its module names (keys, ops/search, ops/rmq, conflict/api, conflict/oracle,
conflict/device, conflict/pipeline, runtime/coverage, runtime/metrics) so
each counterpart is easy to find, and replaces the Pallas kernels of
`foundationdb_tpu/conflict/pallas_kernel.py` with hand-written CUDA for
Hopper (`csrc/conflict_kernels.cu`, bound by `conflict/kernels.py`).

It imports torch and numpy only: never jax, never `foundationdb_tpu`.
Entry points run on the CUDA device unless the caller passes
`device="cpu"`, where every kernel wrapper takes its plain torch version.
"""
