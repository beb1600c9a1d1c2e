"""PyTorch/CUDA port of foundationdb_tpu's resolver conflict check.

The JAX package `foundationdb_tpu` stays the reference; this package mirrors
its module names (keys, ops/, conflict/, parallel/sharded, runtime/ — the
event loop, knobs, metrics, trace plane and wire codec —, rpc/network,
rpc/stream, rpc/transport, roles/types, roles/sequencer, roles/resolver) so
each counterpart is easy to find, and replaces the Pallas kernels of
`foundationdb_tpu/conflict/pallas_kernel.py` with hand-written CUDA for
Hopper (`csrc/conflict_kernels.cu`, bound by `conflict/kernels.py`).

It imports torch and numpy only: never jax, never `foundationdb_tpu`.
Entry points run on the CUDA device unless the caller passes
`device="cpu"`, where every kernel wrapper takes its plain torch version.
"""
