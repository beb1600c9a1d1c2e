"""PyTorch/CUDA port of foundationdb_tpu: the commit path with the resolver's
conflict check on the card.

The JAX package `foundationdb_tpu` stays the reference; this package mirrors
its module names so each counterpart is easy to find: keys, ops/,
conflict/, parallel/sharded, runtime/ (the event loop, knobs, metrics,
trace plane and wire codec), rpc/network, rpc/stream, rpc/transport,
roles/ (types, sequencer, resolver, proxy, tlog, storage, storage_metrics,
errors), client/ (transaction, ryw, snapshot_cache), utils/ (rangemap),
cluster.py (SimCluster) and workloads/ (base, cycle, bank, increment,
conflict_range, readwrite).  It replaces the Pallas kernels of
`foundationdb_tpu/conflict/pallas_kernel.py` with hand-written CUDA for
Hopper (`csrc/conflict_kernels.cu`, bound by `conflict/kernels.py`).

It imports torch and numpy only: never jax, never `foundationdb_tpu`.
Entry points run on the CUDA device unless the caller passes
`device="cpu"`, where every kernel wrapper takes its plain torch version.
"""
