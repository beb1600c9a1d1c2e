#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Drives the port (foundationdb_tpu_torch) and nothing of the JAX package:

  1. device   the card's name, device count, name and power limit;
  2. build    nvcc builds the conflict kernels from csrc/, and the
              compiler's -Xptxas -v lines are printed, K1's and K3's with
              the dynamic shared memory a block takes at phase 3's
              shapes, and the warp plans' blocks an SM at each wide W
              (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
  3. kernels  each kernel (K1-K5, K2's per-query referee) on seeded inputs
              at the resolver's full-width shapes, held against its plain
              torch version on the same CUDA tensors (exact: integer
              functions), timed with L2 cold and warm, and set against the
              least time the bytes and operations its inputs need would
              take the card (a search's bytes: each compare from the lanes
              both bounds of its interval share with the key, trace_search);
              K5 also against K1 with no history bit set,
              and K5 | history against K1; K5's plan
              (kernels.plan_probe_tree: staged levels, reads a tile,
              cluster size) is printed with its cold time, bound and
              x bound, beside K1's time; the per-query referee's warm
              time beside the event pair's floor.  K2, the whole intra fixpoint in one
              launch, on the first stream batch and on a 1024-txn chain
              (a trajectory as long as the batch), under its plan
              (kernels.plan_intra: one thread-block cluster, printed with
              its size, shared bytes and time an iteration), also against
              the loop it replaced (the per-query kernel in a host loop)
              and its grid plan (same bits, same iteration count), whose
              times are printed beside it; K4
              over the 8 runs of a compaction at once; then K1, K3 and K4
              again at W = 17, 65, 129, 513, 4097, 8193, 16385 and 32769
              lanes (64- to 131072-byte keys, the widths a set widens to;
              from W = 257 K1 and K3 take their warp plans, a warp a
              (read, run) pair or a query), K1 and K3 on two inputs:
              `prefixed`, the same keys behind a common prefix filling the
              width, and `widened`, the stream's 16-byte keys as a widened
              set holds them with every range [k, key_after(k)) (a key and
              its end differ only in the last lane); K4 on `prefixed`;
              from W = 4097 at the default set's
              shapes, 8 runs of 4096 rows, main at 2**16 rows, 4096
              reads; each against its plain version, with its plan, and
              the profiler's record of the CUDA kernel that plan launches
              (the phase fails without one);
  4. stream   the full-width resolver stream (8192 txns per batch, 2 point
              reads + 1 point write each, uniform 16-byte keys, 8 prefill
              + 16 timed batches, GC from the 10th batch) through
              DeviceConflictSet.resolve_batch on "cuda" and on "cpu":
              identical verdicts every batch and identical final state,
              the same fixpoint iterations, every kernel of the path
              launched by the cuda run (K2 once a batch, K4 once a
              compaction), host syncs and iterations per batch.  Then a
              few more batches, timed plain and profiled on a twin set
              (device busy share, launches, the ops that take the time);
  6. best-known  the same stream through bench.py's BEST_KNOWN layout
              (lsm=True, search_impl="bucket") on "cpu" once and on
              "cuda" in three modes (`drive`): synchronous resolve_batch,
              resolve_deferred waited one behind, and a PipelinedPacker
              with BatchStager feeding resolve_arrays(sync=False).  Every
              mode's verdicts equal phase 4's and the cpu run's batch by
              batch, its final state the cpu run's; checks/s, latency,
              pack/h2d time, host syncs, fixpoint iterations (equal to the
              cpu run's) and (profiled) device-busy share and launches
              per mode.  On one batch of the live state K5 referees K1,
              and the per-query loop referees K2;
  7. recovery a deep 16-bit-prefix bucket through resolve_deferred on the
              card: the deferred check fails, the window recovers, and the
              verdicts equal the oracle's;
  8. oracle   a reduced stream (variable-length keys with shared prefixes,
              main capacity small enough to regrow) on "cuda" against the
              port's OracleConflictSet: identical verdicts;
  9. supervised  the best-known set on "cuda" inside the port's
              DeviceSupervisor, the port's native skip list as its CPU
              fallback: (a) phase 4's stream through resolve_batch and
              then resolve_deferred (one behind), in turns with the bare
              best-known set (bare, supervised, supervised, bare), verdicts
              equal phase 4's, healthy with 0 trips and 1 promotion, the
              native set serving the first batch's parity check only, and
              the supervised / bare checks/s; (b) the drill: the
              port's buggify loses the device 3 times mid-stream, the
              breaker trips once, the native set serves, force_promote()
              rebuilds the set on the card from the committed-write record
              and a parity batch re-promotes it (healthy, 1 trip, 2
              promotions; the times to degrade and to re-promote printed);
              (c) four batches with the wall watchdog on, and a
              BatchStager batch resolved on the watchdog's worker thread;
 10. bench    the port's headline bench (foundationdb_tpu_torch/bench.py)
              at its full shape in this process: its JSON line (abort-set
              parity against the native set on the timed batches and on
              the resolver e2e run's), then native and card checks/s,
              vs_baseline, p50/p99 and the resolver e2e rate; its
              page_cache (preads saved), metrics_series (ResolverMetrics
              samples of 2 resolvers on the card, their launches) and
              commit_wire (bytes, frames a flush) blocks present; its
              kernel.phase (the post batches' sort / scan / merge /
              compact ms, backend cuda) and kernel.phase_profile
              (phase_timings at its small shapes, conforming to
              PHASE_PROFILE_SCHEMA) blocks;
 11. legacy   phase 4's stream through the legacy layouts
              (incremental=False): the flat full merge once per merge_impl
              (scatter, sort, gather) and the LSM recent level (scatter).
              Verdicts equal phase 4's, the three merges' final states are
              identical, K2 once a batch, K3 once a fold (and against its
              plain version on the live levels); a reduced stream of the
              flat and LSM layouts identical on "cpu", state included.
              Prints ms a batch, compactions, launches and node_count;
 12. timing   phase 4's stream through the flat and best-known sets with
              phase_timing=True: verdicts equal phase 4's, the per-batch
              sort / scan / merge / compact ms; then `python -m
              foundationdb_tpu_torch.profile_kernel --phase` must exit 0;
 13. sharded  BASELINE.json config 5 (4 resolvers, key-space split): 4
              partitions on the card, split at the key pool's quartiles,
              2**17 rows each, through (a) the constructor default, (b)
              the best-known layout, (c) (b) through
              resolve_arrays(sync=False) two batches in flight, (d) the
              legacy flat merge on 8 batches.  The modes agree batch by
              batch; each equals the same set on "cpu" over 4 batches,
              per-partition state included; K1 and K2 once a partition a
              batch, K4 once a partition a compaction, K3 at least 8 times
              as often; checks/s, p50/p99 and (profiled) launches a batch
              beside phase 6's single set; then phase 8's stream against 4
              partition oracles merged with min.
 14. role     the port's resolver role (roles/resolver.py) serving phase
              4's stream as a proxy sends it (ResolveTransactionBatchRequests
              chained prev_version -> version) over the best-known set, its
              MVCC window set through CoreKnobs to the stream's GC lag:
              (a) on a seeded SimNetwork, every batch in flight at once,
              sync and pipelined, on "cuda" and on "cpu": the replies equal
              the set driven directly in the role's order (resolve_batch,
              then remove_before(version - window)), the cuda and cpu runs
              reply at identical virtual times and end in the same state,
              K1/K2 once a batch, K4 once a compaction; (b) over loopback
              TCP (two RealNetworks pumped by one WallDriver), the role
              hosting the DeviceSupervisor with its wall watchdog armed,
              16 batches one at a time: replies equal (a)'s, healthy, 0
              trips, every batch served by the card.  Prints checks/s and
              receipt->reply p50/p99 (host clock) beside phase 6's bare
              set, the codec's encode/decode ms and bytes a batch
              (WireStats), and (a) sync's launches and device-busy share
              over 3 profiled batches.
 15. cluster  the commit path: the port's SimCluster (client -> commit
              proxy -> resolver -> TLog -> storage server) driven by the
              ReadWrite workload (2 point reads + 1 point write a
              transaction, uniform over 65536 rw/ keys filled by its
              setup).  (a) BASELINE.json config 1: 8192 clients, one
              resolver hosting the best-known set (capacity 2**19, keys up
              to 24 bytes: the client's self-conflict keys are 22), 1 TLog,
              1 storage server, 0.15 virtual s, at least 4 x 8192
              commits; (b) config 5:
              2048 clients, 4 resolvers (the best-known set, 2**17 each)
              split at the key pool's quartiles, 4 storage shards split
              there too, 2 TLogs; (c) 512 clients on the cluster's default
              backend (DeviceConflictSet(device=...), 2**16) on "cuda" and
              on "cpu".  Every resolver batch goes through the card (K1/K2
              once a resolve pass: a batch, plus its full-depth replay when
              the bucketed search falls back; K4 once a compaction), every
              batch's verdicts equal the port's OracleConflictSet fed the
              same log, every key an acknowledged commit wrote reads back
              its newest acknowledged value, and (c)'s two runs are
              identical (ReadWrite metrics, end virtual time, storage
              contents, verdict stream).  Prints commits, retries, host
              wall and txn/s, batch sizes, resolve_batch p50/p99, the
              ReadWrite metrics, launches, and (a)'s device-busy share
              over a profiled window of 4 full batches.
 16. durable  the durable, recoverable cluster: the port's RecoverableCluster
              in FoundationDB's `configure new double ssd` deployment (one
              shard on a team of two storage servers on the B-tree engine,
              3 coordinators, 2 TLogs on disk queues, 2 commit proxies, 1
              resolver hosting phase 15's best-known set at 2**19), driven
              by phase 15's ReadWrite at 2048 clients over 65536 keys while
              an AttritionWorkload kills 2 pipeline processes: each recovery
              builds a new set on the card at its recovery version.  Then a
              power-off and a restart from the same SimFilesystem (another
              new set).  Every batch of every generation equals the port's
              OracleConflictSet fed the same log from that generation's
              version; K1/K2 once a resolve pass and K4 once a compaction in
              every generation; every key an acknowledged commit wrote reads
              back from the restarted cluster through the client; its
              \xff\xff/status/json validates with kernel.backend "cuda"; the
              card's requested bytes after the second recovery are no higher
              than after the first.  (c) a reduced twin (512 clients, 1 kill)
              on the default backend, "cuda" against "cpu": identical metrics,
              end virtual time, recoveries, storage, verdict stream and every
              file byte for byte.  Prints commits, retries, recoveries and
              the virtual time each took, host wall and txn/s, resolve_batch
              p50/p99 and launches per generation, bytes on the simulated
              disks, the card's requested bytes after each recovery, and the device's
              busy share over a profiled window of 4 full batches.
 17. backup   fdbbackup, fdbrestore and fdbdr (client/backup.py, client/dr.py)
              in phase 16's deployment, phase 15's ReadWrite at 1024 clients
              over 65536 keys and one pipeline kill.  (a) a BackupAgent
              captures the source into a blob:// container (SimBlobTransport
              over its SimFilesystem): start and a snapshot in 500-row
              chunks once the keys are filled, then the traffic with the
              kill landing while the log streams, then the log to the final
              read version; restore() into a destination of the same deployment
              on the same loop (300 writes a transaction): its user keyspace
              equals the source's final one and the container's fold
              (apply_backup), holds every acknowledged write, and passes
              ConsistencyCheck.  (d) the source powered off, its disks saved
              as a restart image in a temporary directory, loaded, restored
              and restarted on the card: it serves the same keyspace, commits
              once through a new set, and a container reopened there reads
              the same chunks and log.  (b) DR from a primary to a secondary
              on one loop: DRAgent.start once the keys are filled (the
              initial copy in 500-row transactions), a direct write to the
              locked secondary raises DatabaseLocked, the traffic with the
              kill on the primary while the stream applies, then failover(): the
              secondary's keyspace equals the primary's, holds every
              acknowledged write and commits once unlocked; the card's
              requested bytes with both clusters up, and after both stop no
              higher than before.  (c) (a) at 512 clients on the default
              backend, "cuda" against "cpu": identical metrics, end virtual
              time, recoveries, verdict stream, restored keyspace and every
              file of both clusters byte for byte (the blob objects among
              them), its cpu run in a spawned process beside (b) and the
              cuda run (phases 15 and 16 run their (c) cpu twins so too).
              Every set of every cluster equals the port's
              OracleConflictSet fed its log, with K1/K2 once a resolve pass
              and K4 once a compaction, counted per set.  Prints commits,
              retries, the backup's lag, blob objects and bytes, the
              restore's and DR's transactions, batch sizes and resolve_batch
              p50/p99 per cluster, host wall and txn/s.
 18. corpus   the simulation-spec corpus (workloads/spec.py) and long keys.
              (a) tests/specs/DeviceFaultSwizzle.txt through run_spec_file
              and the RestartAttritionSwizzle pair through
              run_restarting_pair, as written, their backend=supervised
              sets on the card, each beside the same run on "cpu" in a
              spawned process: the specs' checks pass, both runs' metrics,
              traced census, end virtual time and verdict streams are
              identical, every set the supervisors built equals the port's
              OracleConflictSet fed its log, with K1/K2 once a resolve pass
              and K4 once a compaction, each forced device.* class fired
              unless every supervisor's breaker was open when it was forced,
              and a supervisor re-promoted to the card.  The spec forces
              device.readback_corrupt behind open breakers, so a drill then
              forces it once on the spec's supervised backend on the card:
              it fires, the corrupt readback is served from the CPU, the
              set re-promotes, and every verdict equals the oracle's.
              (b) phase 16's deployment with the best-known set
              at 2**19 starting at the default 32-byte width, ReadWrite at
              2048 clients over 65536 keys for 0.25 virtual s beside
              tests/specs/FuzzAndClog.txt's FuzzApi stanza (keys of up to
              203 bytes), each the class spec.WORKLOAD_FACTORY names: 0 oracle
              mismatches, every acknowledged rw/ write read back, the set
              widened (to 256 bytes for FuzzApi's ends), K1, K3 and K4
              launched at that width, the card's requested bytes before the
              widening, after it and after the cluster stopped, and a
              10-byte key committed after the longest.  (c) is phase 10's
              bench line: its page_cache, metrics_series (its resolvers'
              launches counted on the card, a path of their own) and
              commit_wire blocks.
 19. served   the served cluster, the saturation ladder and a soak
              campaign.  (a) ROADMAP C.1's repro in this process: keys of
              600, 10, 10,000 and 12 bytes, one transaction each, on a
              RecoverableCluster whose resolvers host the default set on
              the card, against the same cluster on the port's
              OracleConflictSet: the same versions, virtual times and
              values; then keys of 16385 and 12 bytes; the set widened to
              1024, 16384 and then 32768 bytes (W = 8193), K1, K3 and K4
              launched at W = 8193, the card's
              requested bytes before each widening, after it and after the
              stop.  Then as OS processes: three coordinators
              (tools/coordserver.py), a cluster file and the server
              (tools/server.py --cluster-file --device cuda); the C ABI
              built with g++ from bindings/c into foundationdb_tpu_torch/
              _build/c_abi, its ctest printing C-OK; the bindingtester
              digests of three seeds through the C ABI and the gateway
              client, each equal to the port's in-process client's on a
              "cpu" cluster; keys of 600 and 10,000 bytes and a 10-byte key
              committed through the gateway and read back; the status
              document through the gateway (backend cuda, key_bytes
              16384); a coordinator killed and the gateway rediscovered;
              the server's K1-K4 launches from its status document.  (b)
              tools/saturate.run_hot_curve in r02's deployment (ssd, 2
              shards x 2 replicas, 4000 keys, 128-byte values, zipf 1.2,
              seed 11, data distribution on) at 50, 100 and 200 offered tps
              for 1 virtual s each on the card: every row equal to a
              spawned "cpu" twin's.  (c) tools/soak.run_campaign of
              tests/specs/DeviceFaultSwizzle.txt over 4 seeds in 2 workers
              on the card (started first, in a thread): every seed passes,
              no required site is missing, and the census and metrics equal
              the same campaign's on "cpu".
 20. supervised  the supervised cluster.  (a) tools/bounce.Campaign with
              the server on the card: 3 coordservers and 1 fdbserver
              (--device cuda) as OS processes under the port's fdbmonitor,
              load from 2 client threads (a watermark counter, a cycle
              ring), through its three stories: a rolling SIGTERM bounce
              of every process, one coordinator hot-reload-bounced onto the
              old wire version (--protocol-version) and back, a coordinator
              added, the server bounced onto the new quorum and the old
              coordinator retired.  Every campaign check passes (zero
              acked-commit loss, the ring a permutation, each gap under 30
              s, one TransportProtocolMismatch per old/new pair, a fresh
              client finding the gateway through the new quorum); after
              each start of a server process (three: the boot and two
              bounces, each a new CUDA context and a new conflict set
              booted from the restart image) its status through the
              gateway shows backend cuda and K1-K4 launched, K1 rising.
              (b) one `fdbtop --once` frame from that cluster.  (c)
              tests/test_cli.py's sessions (commands and a kill recovery,
              the REPL, move/backup/configure/errorcode, the DR verbs)
              through the port's Cli on "cuda", K1-K4 launched, every
              printed line equal to a spawned "cpu" twin's.  (d) `python -m
              foundationdb_tpu_torch.tools.flowlint` exits 0 on the tree.
 21. root scripts  the ports of the repository root's scripts.  (a)
              phase_timings.collect() at the reference's full shapes on the
              card: the report conforms (backend cuda), K1/K2 once a
              prefill batch of its two sets, K2 once a call of every
              truncation from +intra on, K3 once a compaction call; the
              ladder, the LSM amortisation and the merge shootout printed;
              then every truncation's and merge's digest at the small
              shapes, runs pending and folded, equal on cuda and on "cpu"
              (a spawned twin, started after the timed run).  (b) profile_kernel's primitive table at
              its shapes (CAP = 2**19, R = 16384, Wn = 8192), every row
              and the WHOLE resolve_core row printed, K2 once a call of
              the latter.  (c) the profile2 table.  (d) graft_entry:
              entry() on cuda equals entry(device="cpu") output for output
              (verdicts, state, count, buckets, convergence, iterations),
              and dryrun_multichip(4) passes with its [multichip] lines,
              the partitions on the card(s), K1-K4 launched.  (e)
              bench_debug at the bench's shapes: K1/K2 once a batch, K4
              once and K3 once a run at the compaction, each batch's
              verdict sum equal to a synchronous run's on the same batches.

Each path is driven with the launch counts set to 0 just before it and read
just after.  Prints each phase's seconds, the kernels' JSON line
(`launches`: K1-K4 on phase 4's stream, K5 and the per-query intra kernel
in their referee roles; `launches_by_path` for every path, phases 11-15's
included: phase 15's as `cluster_a`, `cluster_b`, `cluster_c_cuda`, phase
16's as `durable_a`, `durable_restart`, `durable_c_cuda`, phase 17's as
`backup_src`, `backup_dst`, `backup_restart`, `dr_primary`, `dr_secondary`,
`backup_c_cuda`, phase 18's as `spec_device_fault`, `spec_restart_pair`,
`readback_drill`, `long_keys`, phase 19's as `long_keys_16k`, `served` (the
server process's own counts), `saturate`, `soak` (the workers' summed), phase
20's as `bounce` (the server processes' counts summed, each read just before
its process was bounced or stopped) and `cli`, phase 21's as
`phase_timings`, `primitives`, `graft_entry`, `graft_dryrun` and
`bench_debug`, and phase 10's bench probe as `bench_metrics_series`; K1, K3
and K4 carry phase 3's wide checks under `wide`, by W and, for K1 and K3,
by input, each with the CUDA kernel its plan launched; K2 carries its
plan at the stream's batch, its time an iteration and the grid plan's ms,
and `launches_by_plan`, every path's K2 launches by plan, which phase 4
requires to be the cluster plan's on every stream batch), then
the card's name and power limit, then as its last line
{"ok": true, "device": {...}}.  Any failure raises and
exits non-zero; without a CUDA device, or without the package beside this
script, it exits non-zero before printing any result.

    python3 chip_smoke.py --sweep OUT.json [--only k2,k5,referee,wide,paths]

times only K2 (warm) on stream batches of 64 to 32768 txns under its grid
plan and kernels.plan_intra's in turns (grid, planned, planned, grid) and
each other cluster size that holds the batch, then K5 (cold) at the
stream's shapes and on `prefixed` at W = 17 and 65 under every plan of
kernels.probe_tree_plans (held against its plain version and K1; an
older package's own kernel as "before"), and the per-query referee
(warm) at R = 16384 and 49152, then K1 and K3 (cold) at W =
17 to 32769 on both of phase 3's wide
inputs under every plan the package beside the script offers (its warp and
staged plans, and the warp plans' choices; a package from before the warp
plans, its own), each bit-exact with its plain version, then phase 18
(b)'s and phase 19 (a)'s runs with K1's and K3's device ms (an event pair
around each launch), and writes the numbers to OUT.json; `--only` runs
the parts named, in that order.  Copied beside an older checkout of the
package, it times that checkout's kernels on the same inputs.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 20260729

# the deployment bench.py models (BASELINE.json config 1): one resolver,
# 8192-transaction batches of 2 point reads + 1 point write, keys uniform
# over 2**20 random 16-byte keys, snapshots within 13 versions
TXNS = 8192
READS_PER_TXN = 2
KEY_BYTES = 16
KEY_POOL = 1 << 20
SNAP_WINDOW = 13
PREFILL_BATCHES = 8
TIMED_BATCHES = 16
PROFILED_BATCHES = 3    # after the stream, under torch.profiler
GC_FROM_BATCH = 10      # remove_before(commit - GC_LAG) from this batch on
GC_LAG = 8
SET_ARGS = dict(max_key_bytes=16, capacity=1 << 19, run_slots=8,
                run_capacity=1 << 14)

# the card's published peaks (H100 SXM data sheet): memory bandwidth, and
# the 32-bit non-tensor rate used for the kernels' integer compares
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
SECTOR = 32              # bytes: the unit in which memory serves a gather
FLUSH_BYTES = 256 << 20  # written before a cold launch: 5x the 50 MB L2
SPIN_CYCLES = 200_000    # ~0.1 ms of device spin ahead of a timed launch

SOURCE = "foundationdb_tpu_torch/csrc/conflict_kernels.cu"
KERNELS = (  # (counter name, TPU kernel it replaces, CUDA symbol)
    ("probe_fused", "foundationdb_tpu/conflict/pallas_kernel.py:189",
     "probe_fused_kernel"),
    ("intra_query", "foundationdb_tpu/conflict/pallas_kernel.py:353",
     "intra_query_kernel"),
    ("compact_ranks", "foundationdb_tpu/conflict/pallas_kernel.py:474",
     "compact_ranks_narrowed_kernel"),
    ("run_to_step", "foundationdb_tpu/conflict/pallas_kernel.py:416",
     "run_to_step_kernel"),
    ("probe", "foundationdb_tpu/conflict/pallas_kernel.py:165",
     "probe_tree_kernel"),
    ("intra_fixpoint", "foundationdb_tpu/conflict/pallas_kernel.py:353",
     "intra_fixpoint_kernel"),
)
SYMBOLS = {name: symbol for name, _where, symbol in KERNELS}
# the kernels of K1's and K3's warp plans (from kernels.WARP_FROM_W)
WIDE_SYMBOLS = {"probe_fused": "probe_fused_warp_kernel",
                "compact_ranks": "compact_ranks_warp_kernel"}
# K2's cluster plan's kernel (kernels.plan_intra; its grid plan's is SYMBOLS')
CLUSTER_SYMBOL = "intra_cluster_kernel"
MAIN_PATH = ("probe_fused", "intra_fixpoint", "compact_ranks", "run_to_step")
# phase 3's wider lanes: 64- to 131072-byte keys; from W = 257 (1024-byte
# keys, kernels.WARP_FROM_W) K1 and K3 take their warp plans
WIDE_W = (17, 65, 129, 513, 4097, 8193, 16385, 32769)
# from W = 4097 (16 KB keys) phase 3 takes the default set's shapes
# (DeviceConflictSet(): K = 8 runs of 4096 rows, main at 2**16 rows) and
# WIDEST_READS reads: at the stream's, main alone would be ~8.6 GB at W =
# 4097; at W = 32769 the default set's main is ~8.6 GB, its runs as much
WIDEST_FROM = 4097
WIDE_FEW_REPS = 8193  # from this W K1, K3 and K4 take 0.5-11 ms a launch
DEFAULT_SET = dict(capacity=1 << 16, run_slots=8, run_capacity=1 << 12)
WIDEST_READS = 4096
WIDE_KERNELS = ("probe_fused", "compact_ranks", "run_to_step")
WIDE_TIMED = ("ms", "cold_ms", "warm_ms", "device_ms", "call_ms", "plain_ms",
              "bound_ms", "bound_by", "library_ms")
CHAIN_TXNS = 1024  # the chain batch of phase 3: txn t reads what t - 1 writes
# cudaLaunchKernel and, for K2, cudaLaunchCooperativeKernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel")
# bench.py's BEST_KNOWN layout, run in three modes over the same stream
BEST_KNOWN = dict(lsm=True, search_impl="bucket")
MODES = ("sync", "deferred", "packer")
# each mode twice, in turns, so that drift over the call (the shared host's
# load) falls on every mode alike
TURNS = MODES + MODES[::-1]


def log(*parts) -> None:
    print(*parts, flush=True)


def card_power_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


# ---------------------------------------------------------------------------
# timing


def call_ms(torch, fn, reps: int, warm: int = 3) -> float:
    """Time per call made back to back: CUDA events around `reps` calls,
    over `reps`.  A kernel shorter than its host-side launch leaves the
    stream idle between calls, so this is the cost of a call on the path,
    host launch included."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def planned_symbol(name: str, plan) -> str:
    """The CUDA kernel K1's or K3's wrapper launches under `plan` (its warp
    or staged plan), or K2's (its cluster or grid plan)."""
    if name == "intra_fixpoint":
        return CLUSTER_SYMBOL if plan.cluster else SYMBOLS[name]
    return WIDE_SYMBOLS[name] if plan.warp else SYMBOLS[name]


def k2_plans(launches: dict) -> dict:
    """K2's launches in a path's counts (kernels.launch_counts), by plan."""
    head = "intra_fixpoint."
    return {k[len(head):]: n for k, n in launches.items() if k.startswith(head) and n}


def launch_ms(torch, fn, reps: int, flush=None) -> float:
    """Median time of one launch between its own pair of CUDA events.
    Before each launch the stream first writes `flush` (when given: the
    L2 holds none of the inputs then, as on the main path where the
    kernel's inputs were written batches or a large sort earlier) and then
    spins ~0.1 ms, so the host has enqueued the launch before the start
    event fires: the pair times the device's work, not the host's."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.fill_(1)
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def _is_kernel(key: str, symbol: str) -> bool:
    """Whether a profiler record names the CUDA kernel `symbol` (no
    kernel's name is a part of another's)."""
    return symbol in key


def device_ms(torch, fn, symbol: str, reps: int) -> float | None:
    """The kernel's own duration per launch, from the profiler's device
    records (CUPTI) of `reps` launches, over the launches it recorded.  It
    may miss launches of long kernels (K1 at W = 32769, ~11 ms); None when
    it recorded none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    mine = [e for e in prof.key_averages() if _is_kernel(e.key, symbol)]
    recorded = sum(e.count for e in mine)
    if not recorded:
        log(f"the profiler recorded none of {reps} launches of {symbol}")
        return None
    return sum(_device_us(e) for e in mine) / 1e3 / recorded


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# the work each kernel's inputs need: its searches replayed on the same
# tensors, every lane they read collected, and the reads counted in the
# 32-byte sectors memory serves them in (each sector once).  Operations:
# one compare per lane read plus four integer operations per search step.
# Each replay also returns the kernel's function, which the caller holds
# against the kernel, so a replay that went astray cannot pass.


def _sectors(torch, elems, elem_bytes: int = 4) -> int:
    """Distinct sectors holding the given elements of one buffer: element
    indices, or [n, 2] inclusive ranges of them (a row's lanes 0..first),
    counted as the union of the ranges' sector spans, so wide rows need no
    element list."""
    if elems.numel() == 0:
        return 0
    if elems.dim() == 1:
        elems = _points(torch, elems)
    span = elems.long() * elem_bytes // SECTOR  # inclusive sector ranges
    lo, order = torch.sort(span[:, 0])
    hi = span[order, 1]
    # each range adds the sectors past every range that starts before it
    reach = torch.cummax(hi, 0).values
    before = torch.cat([lo[:1] - 1, reach[:-1]])
    return int(torch.clamp(hi - torch.maximum(lo - 1, before), min=0).sum())


def _points(torch, elems):
    """Element indices as one-element ranges."""
    return torch.stack([elems.long(), elems.long()], 1)


def _share(torch, a, b):
    """Per row pair: how many leading lanes a and b share (W when equal)
    and whether a < b."""
    W = a.shape[1]
    diff = a != b
    share = torch.where(diff.any(1), diff.to(torch.int32).argmax(1), W)
    at = torch.clamp(share, max=W - 1)[:, None]
    return share, a.gather(1, at)[:, 0] < b.gather(1, at)[:, 0]


def _lanes(torch, rows, start, end, W: int):
    """Lanes start[j]..end[j] of row rows[j], as an inclusive element
    range."""
    base = rows.long() * W
    return torch.stack([base + start.long(), base + end.long()], 1)


def trace_search(torch, table, qq, qid):
    """Replays the least reading of a binary search of the sorted rows
    `table` for #rows < qq[j]: each compare reads the mid row and the query
    from the lanes that both bounds of the interval share with the query,
    min(lcp(table[lo - 1], q), lcp(table[hi], q)) (0 for a bound not yet
    narrowed), which every row between shares too, to the first lane that
    differs (the last when none does).  qid[j] is query j's row in its own
    buffer.  Returns the ranks, the lanes the searches read of the table
    and of the query buffer (inclusive element ranges, one a compare), the
    search steps and the lanes compared."""
    n, W = table.shape
    lo = torch.zeros(qq.shape[0], dtype=torch.long, device=qq.device)
    hi = torch.full_like(lo, n)
    l_lo, l_hi = torch.zeros_like(lo), torch.zeros_like(lo)
    t_el, q_el = [lo.new_zeros((0, 2))], [lo.new_zeros((0, 2))]
    steps = lanes = 0
    while True:
        a = (lo < hi).nonzero()[:, 0]
        if a.numel() == 0:
            return lo, torch.cat(t_el), torch.cat(q_el), steps, lanes
        mid = lo[a] + (hi[a] - lo[a]) // 2
        start = torch.minimum(l_lo[a], l_hi[a])
        share, less = _share(torch, table[mid], qq[a])
        end = torch.clamp(share, max=W - 1)
        t_el.append(_lanes(torch, mid, start, end, W))
        q_el.append(_lanes(torch, qid[a], start, end, W))
        steps += a.numel()
        lanes += int((end - start + 1).sum())
        lo[a] = torch.where(less, mid + 1, lo[a])
        l_lo[a] = torch.where(less, share, l_lo[a])
        hi[a] = torch.where(less, hi[a], mid)
        l_hi[a] = torch.where(less, l_hi[a], share)


def probe_fused_work(torch, rb, re_, snap, r_ok, runs_b, runs_e, runs_ver,
                     hist=None):
    """K1: a thread reads hist; when clear, r_ok; when set, snap, and for
    each run newer than snap (until its first conflict) searches the run's
    begins with its read end and, on rank > 0, compares its read begin with
    ends[rank - 1].  With hist None, K5: the same without the history
    input (every thread reads r_ok).  Returns (bytes, operations, the
    kernel's output)."""
    R, W = rb.shape
    K, cap, _ = runs_b.shape
    fused = hist is not None
    if not fused:
        hist = torch.zeros_like(r_ok)
    live = ~hist & r_ok
    conflict = torch.zeros_like(hist)
    el = {"rb": [], "re": [], "runs_b": [], "runs_e": []}
    steps = lanes = 0
    for k in range(K):
        a = (live & ~conflict & (runs_ver[k] > snap)).nonzero()[:, 0]
        if a.numel() == 0:
            continue
        rank, t, q, s, n_lanes = trace_search(torch, runs_b[k], re_[a], a)
        el["runs_b"].append(t + k * cap * W)
        el["re"] += [q, _points(torch, a * W + W - 1)]  # and the end's last lane
        steps, lanes = steps + s, lanes + n_lanes
        hit = rank > 0
        a, rank = a[hit], rank[hit]
        share, less = _share(torch, rb[a], runs_e[k][rank - 1])
        end, zero = torch.clamp(share, max=W - 1), torch.zeros_like(share)
        el["rb"].append(_lanes(torch, a, zero, end, W))
        el["runs_e"].append(_lanes(torch, k * cap + rank - 1, zero, end, W))
        lanes += int((end + 1).sum())
        conflict[a] = less
    n_bytes = ((2 if fused else 1) * R + SECTOR  # hist, out; runs_ver
               + SECTOR * _sectors(torch, (~hist).nonzero()[:, 0], 1)
               + SECTOR * _sectors(torch, live.nonzero()[:, 0])
               + SECTOR * sum(_sectors(torch, torch.cat(v)) for v in el.values() if v))
    return n_bytes, lanes + 4 * steps, hist | conflict


def intra_query_work(torch, rmq, beg_tab, stab, rb_r, re_r):
    """K2: per read, the rank bounds, two table lookups when its rank range
    is not empty, one stab lookup, one output."""
    L, n = beg_tab.shape
    R = rb_r.shape[0]
    lo, hi = rb_r.long() + 1, re_r.long()
    nonempty = hi > lo
    k = torch.clamp(rmq.floor_log2(torch.clamp(hi - lo, min=1).to(torch.int32)),
                    max=L - 1).long()
    i1 = torch.clamp(lo, 0, n - 1)
    i2 = torch.clamp(hi - torch.bitwise_left_shift(torch.ones_like(k), k), 0, n - 1)
    tab = beg_tab.reshape(-1)
    s_idx = torch.clamp(rb_r.long(), 0, n - 1)
    out = torch.minimum(
        torch.where(nonempty, torch.minimum(tab[k * n + i1], tab[k * n + i2]),
                    rmq.I32_MAX),
        stab[s_idx])
    t_el = torch.cat([(k * n + i1)[nonempty], (k * n + i2)[nonempty]])
    n_bytes = 3 * R * 4 + SECTOR * (_sectors(torch, t_el) + _sectors(torch, s_idx))
    return n_bytes, 12 * R, out


def intra_fixpoint_work(fx, n_iters: int):
    """K2's fixpoint: each input read once (a kernel could hold them on
    chip across iterations: ~0.45 MB at the stream's shapes) and the bits
    and the count written once; one operation a read, write and txn an
    iteration."""
    *tensors, B = fx
    n_bytes = sum(t.numel() * t.element_size() for t in tensors) + B + 4
    return n_bytes, n_iters * (fx[0].shape[0] + fx[2].shape[0] + B), None


def run_to_step_work(K: int, rcap: int, W: int):
    """K4: a pure copy, so it reads every input byte whatever the data:
    the runs' rows and versions in, the step rows and values out."""
    return 2 * K * rcap * W * 4 * 2 + 2 * K * rcap * 4 + 4 * K, 0, None


def run_to_step_library(torch, runs_b, runs_e):
    """K4's rows in one PyTorch call, its yardstick: [K, rcap, 2, W], which
    is rows[K, 2 rcap, W] in memory.  The port never calls it."""
    return torch.stack((runs_b, runs_e), dim=2)


def compact_ranks_work(torch, keys_mod, ks, rec):
    """K3: per recent row, its last lane (+1) and one search of main."""
    n_rec, W = rec.shape
    rid = torch.arange(n_rec, device=rec.device)
    rank, t, q, steps, lanes = trace_search(torch, ks, keys_mod.with_last_lane_inc(rec), rid)
    q = torch.cat([q, _points(torch, rid * W + W - 1)])
    n_bytes = SECTOR * (_sectors(torch, t) + _sectors(torch, q)) + n_rec * 4
    return n_bytes, lanes + 4 * steps + n_rec, rank.to(torch.int32)


# ---------------------------------------------------------------------------
# seeded inputs in the stream's key layout


PREFIX_WORD = 0x66666666  # each word of the common prefix: b"ffff"


def prefixed_lanes(torch, keys_mod, rows, W: int, dev):
    """uint32 lane rows of 16-byte keys as lanes of W on `dev`: each key
    behind a common prefix of 4 * (W - 5) bytes (the encoding of prefix +
    key, its length lane grown by the prefix's); sentinel rows stay
    sentinel.  Built on `dev` from the narrow rows: from W = 8193 the wide
    rows are gigabytes, which the host would take tens of seconds over."""
    narrow = keys_mod.to_lanes(np.ascontiguousarray(rows), dev)
    w0 = narrow.shape[-1]
    out = torch.empty(narrow.shape[:-1] + (W,), dtype=torch.int32, device=dev)
    out[..., : W - w0] = int(np.array(PREFIX_WORD ^ 0x80000000, np.uint32).view(np.int32))
    out[..., W - w0:] = narrow
    out[..., -1] += 4 * (W - w0)
    out.masked_fill_((narrow == keys_mod.SENT_LANE).all(-1, keepdim=True), keys_mod.SENT_LANE)
    return out


def widened_lanes(torch, keys_mod, rows, W: int, dev, after: bool = False):
    """uint32 lane rows of 16-byte keys as lanes of W on `dev`, as a
    widened set holds them (keys.widen_lanes: the data words, INT32_MIN
    words, the length lane); with `after`, each live row is its key_after
    (k + b"\\0": the length lane + 1, the one lane in which the two
    differ).  Sentinel rows stay sentinel."""
    out = keys_mod.widen_lanes(keys_mod.to_lanes(np.ascontiguousarray(rows), dev), W)
    if after:
        out[..., -1] += (out[..., -1] != keys_mod.SENT_LANE).to(out.dtype)
    return out


WIDE_INPUTS = ("widened", "prefixed")  # phase 3's two inputs at each wide W


def wide_inputs(torch, keys_mod, kernels, kind: str, W: int, dev, base: dict, cut):
    """Phase 3's K1 and K3 inputs at width W: (K1's arguments, main, the
    recent rows).  `prefixed`: every key behind a common prefix that fills
    the width, each range as at W = 5.  `widened`: the same 16-byte keys
    as a widened set holds them, every range a point range [k,
    key_after(k)) (in main too: each key beside its key_after), so a key
    and its end differ only in the last lane; sentinel tails kept.  `base`
    holds phase 3's narrow rows, `cut` is wide_cut's (rows of each run,
    the reads' slice, the step over main's keys)."""
    rows, reads, step = cut
    k1 = base["k1"]
    if kind == "prefixed":
        wide = lambda a: prefixed_lanes(torch, keys_mod, a, W, dev)  # noqa: E731
        runs_b, runs_e = wide(base["runs_b"][:, :rows]), wide(base["runs_e"][:, :rows])
        rb, re_ = wide(base["rb"][reads]), wide(base["re"][reads])
        ks = wide(base["main"][::step])
    else:
        wide = lambda a, after=False: widened_lanes(torch, keys_mod, a, W, dev, after)  # noqa: E731
        runs_b, runs_e = wide(base["runs_b"][:, :rows]), wide(base["runs_b"][:, :rows], True)
        rb, re_ = wide(base["rb"][reads]), wide(base["rb"][reads], True)
        keys = base["main_keys"][::step]
        n_live = 2 * len(keys)
        cap = base["main"][::step].shape[0]
        ks = torch.full((cap, W), keys_mod.SENT_LANE, dtype=torch.int32, device=dev)
        ks[:n_live] = torch.stack([wide(keys), wide(keys, True)], 1).reshape(n_live, W)
    rec, _ = kernels.run_to_step_plain(runs_b[1], runs_e[1], k1[6][1])
    return ((rb, re_, k1[2][reads], k1[3][reads], runs_b, runs_e, k1[6], k1[7][reads]),
            ks, rec)


def wide_cut(W: int, run_cap: int, cap: int, R: int):
    """Phase 3's inputs at width W: (rows of each run, the reads' slice,
    the step over main's rows): the stream's below WIDEST_FROM, the default
    set's shapes from it."""
    if W < WIDEST_FROM:
        return run_cap, slice(0, R), 1
    return (DEFAULT_SET["run_capacity"], slice(R - WIDEST_READS, R),
            cap // DEFAULT_SET["capacity"])


def key_pool(rng, n=KEY_POOL):
    """n random 16-byte keys, and each key's successor as a 128-bit
    big-endian integer: [k, succ(k)) holds exactly the key k among 16-byte
    keys, the point range of this key space."""
    pool = rng.integers(0, 256, size=(n, KEY_BYTES), dtype=np.uint8)
    succ = pool.copy()
    carry = np.ones(n, dtype=bool)
    for j in range(KEY_BYTES - 1, -1, -1):
        v = succ[:, j].astype(np.uint16) + carry
        succ[:, j] = v & 0xFF
        carry = v > 0xFF
    require(not carry.any(), "an all-0xFF key has no successor")
    return pool, succ


def point_rows(keys_mod, pool, succ, idx):
    """Lane rows of the point ranges [k, succ(k)) for pool indices idx."""
    return (keys_mod.encode_fixed(pool[idx], KEY_BYTES),
            keys_mod.encode_fixed(succ[idx], KEY_BYTES))


def sorted_run(keys_mod, rng, pool, succ, n_live, run_cap):
    """A run as the append builds it: sorted, disjoint point intervals of
    distinct pool keys, sentinel-padded to run_cap."""
    idx = np.unique(rng.integers(0, len(pool), n_live))
    b, e = point_rows(keys_mod, pool, succ, idx)
    order = np.lexsort(b.T[::-1])
    out_b = np.full((run_cap, b.shape[1]), 0xFFFFFFFF, np.uint32)
    out_e = out_b.copy()
    out_b[: len(idx)] = b[order]
    out_e[: len(idx)] = e[order]
    return out_b, out_e


def chain_inputs(torch, keys_mod, tdev, dev, pool, succ, B):
    """K2's arguments for a chain batch of B txns: txn t writes pool key t
    and reads pool key t - 1 (txn 0 reads key B, which nobody writes), so
    the fixpoint settles about one txn an iteration."""
    t = np.arange(B)
    rb, re_ = (keys_mod.to_lanes(a, dev) for a in point_rows(
        keys_mod, pool, succ, np.where(t > 0, t - 1, B)))
    wb, we = (keys_mod.to_lanes(a, dev) for a in point_rows(keys_mod, pool, succ, t))
    tx = torch.arange(B, device=dev)
    ones = torch.ones(B, dtype=torch.bool, device=dev)
    return (*tdev._intra_setup(rb, re_, wb, we), ones, ones, tx, tx,
            tx.to(torch.int32), ones, ~ones, B)


def k2_stream_inputs(torch, tdev, dev, packed) -> tuple:
    """K2's arguments for a packed stream batch with no history yet, as
    inc_check hands them over: the ranks of its staged rows, live reads
    and writes, txn indices clamped into the batch."""
    rb, re_, r_tx, wb, we, w_tx, _snap, active = tdev.stage_batch(dev, *packed[:8])
    B = active.shape[0]
    w_ok = (w_tx >= 0) & ~tdev._is_sentinel(wb)
    return (*tdev._intra_setup(rb, re_, wb, we), r_tx >= 0, w_ok,
            torch.clamp(r_tx, 0, B - 1).long(), torch.clamp(w_tx, 0, B - 1).long(),
            w_tx, active, torch.zeros(B, dtype=torch.bool, device=dev), B)


def fixpoint_check(check, results, torch, kernels, fx, key, reps):
    """K2 on `fx` under kernels.plan_intra's plan against its plain version
    (`check`), the loop it replaced (the per-query kernel in a host loop)
    and the grid plan (the cooperative kernel over device memory, where the
    plan is a cluster): the same bits and iteration count; logs the plan, its
    cluster and shared bytes, the time an iteration, and the loop's and
    the grid plan's times beside the kernel's."""
    R, Wn, B = fx[0].shape[0], fx[2].shape[0], fx[-1]
    plan = kernels.plan_intra(R, Wn, B)
    got = kernels.intra_fixpoint(*fx)
    n_iters = int(got[1])
    loop = lambda: kernels.intra_fixpoint_plain(*fx, query=kernels.intra_query)  # noqa: E731
    grid = lambda: kernels.intra_fixpoint(*fx, plan=kernels.INTRA_GRID_PLAN)  # noqa: E731
    before = kernels.launches["intra_query"]
    k2_loop = loop()
    require(kernels.launches["intra_query"] - before == n_iters,
            f"{key}: the per-query loop launched K2 once an iteration")
    require(torch.equal(k2_loop[0], got[0]) and int(k2_loop[1]) == n_iters,
            f"{key}: the fixpoint kernel disagrees with the per-query loop")
    by_grid = grid()
    require(torch.equal(by_grid[0], got[0]) and int(by_grid[1]) == n_iters,
            f"{key}: the {kernels.plan_name(plan)} plan disagrees with the grid plan")
    check("intra_fixpoint", list(got), list(kernels.intra_fixpoint_plain(*fx)),
          intra_fixpoint_work(fx, n_iters), fn=lambda: kernels.intra_fixpoint(*fx),
          plain_fn=lambda: kernels.intra_fixpoint_plain(*fx), reps=reps, cold=False,
          key=key, symbol=planned_symbol("intra_fixpoint", plan))
    loop_ms = launch_ms(torch, loop, 3)
    grid_ms = launch_ms(torch, grid, reps)
    r = results[key]
    r.update(iterations=n_iters, k2_loop_ms=loop_ms, grid_ms=grid_ms,
             plan=kernels.plan_name(plan), cluster=plan.cluster, smem=plan.smem,
             us_per_iteration=r["ms"] * 1e3 / n_iters)
    log(f"kernel {key}: R={R} Wn={Wn} B={B}: {n_iters} iterations, "
        f"{int(got[0].sum())} of {B} txns intra-conflicted; plan {r['plan']} "
        f"(cluster {plan.cluster}, {plan.smem} B shared a block); same bits and "
        f"count as the plain version, the per-query loop and the grid plan; "
        f"{r['ms']:.6f} ms warm = {r['us_per_iteration']:.3f} us an iteration, "
        f"bound {r['bound_ms'] * 1e3:.3f} us, {r['ms'] / r['bound_ms']:.1f}x; "
        f"grid plan {grid_ms:.6f} ms ({grid_ms * 1e3 / n_iters:.3f} us an iteration, "
        f"grid / plan = {grid_ms / r['ms']:.2f}); the loop {loop_ms:.6f} ms "
        f"(loop / kernel = {loop_ms / r['ms']:.1f})")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version


def kernel_inputs(torch, keys_mod, dev, rng, pool, succ) -> dict:
    """Phase 3's seeded inputs at the stream's shapes: K1's arguments
    (`k1`), the narrow rows they were made of (`runs_b`, `runs_e`, `rb`,
    `re`: uint32), and K3's main (`main`, its keys alone `main_keys`)."""
    run_cap = SET_ARGS["run_capacity"]
    W = keys_mod.num_words(SET_ARGS["max_key_bytes"])
    R = TXNS * READS_PER_TXN
    lanes = lambda a: keys_mod.to_lanes(a, dev)  # noqa: E731
    # K1: 8 runs of ~8K point intervals (one dead, one empty), 16384
    # reads with padding (sentinel) rows and TOO_OLD (r_ok False) rows
    half = run_cap // 2  # a batch's 8192 point writes, before coalescing
    runs = [sorted_run(keys_mod, rng, pool, succ, int(f * half), run_cap)
            for f in (1, 0.98, 0.96, 0.99, 1, 0.85, 0.01, 0)]
    runs_b = lanes(np.stack([r[0] for r in runs]))
    runs_e = lanes(np.stack([r[1] for r in runs]))
    runs_ver_np = np.array([0, 3, 5, 6, 8, 9, 11, 12], dtype=np.int32)
    runs_ver = torch.from_numpy(runs_ver_np).to(dev)
    n_live = R - 64
    rb_np = np.full((R, W), 0xFFFFFFFF, np.uint32)
    re_np = rb_np.copy()
    live_idx = rng.integers(0, len(pool), n_live)
    # half the reads hit keys of the runs, so the probe finds conflicts
    hit = rng.random(n_live) < 0.5
    run_keys = keys_mod.from_lanes(runs_b.reshape(-1, W))
    run_keys = run_keys[run_keys[:, -1] != 0xFFFFFFFF]
    rb_np[:n_live], re_np[:n_live] = point_rows(keys_mod, pool, succ, live_idx)
    pick = run_keys[rng.integers(0, len(run_keys), int(hit.sum()))]
    rb_np[:n_live][hit] = pick
    re_np[:n_live][hit] = pick
    re_np[:n_live][hit, -1] += 1  # [k, k + b"\0") in the lane encoding
    snap_np = rng.integers(0, 13, R).astype(np.int32)
    r_ok_np = (np.arange(R) < n_live) & (rng.random(R) < 0.9)
    hist_np = r_ok_np & (rng.random(R) < 0.05)
    k1 = (lanes(rb_np), lanes(re_np), torch.from_numpy(snap_np).to(dev),
          torch.from_numpy(r_ok_np).to(dev), runs_b, runs_e, runs_ver,
          torch.from_numpy(hist_np).to(dev))
    # K3: ~447K live boundaries of main at cap 2**19 (the stream's size
    # after 24 batches) against one run's step rows (2 * run_cap,
    # sentinels included)
    cap = SET_ARGS["capacity"]
    idx = np.unique(rng.integers(0, len(pool), int(0.48 * cap)))
    b, e = point_rows(keys_mod, pool, succ, idx)
    main_keys = np.concatenate([keys_mod.encode_keys([b""], KEY_BYTES), b])
    main_keys = main_keys[np.lexsort(main_keys.T[::-1])]
    main = np.concatenate([main_keys, e])
    main = main[np.lexsort(main.T[::-1])]
    ks_np = np.full((cap, W), 0xFFFFFFFF, np.uint32)
    ks_np[: len(main)] = main
    return dict(k1=k1, runs=runs, runs_b=np.stack([r[0] for r in runs]),
                runs_e=np.stack([r[1] for r in runs]), rb=rb_np, re=re_np, main=ks_np,
                main_keys=main_keys)


def referee_inputs(torch, fdb, dev, packed) -> tuple:
    """The per-query referee's arguments on the first fixpoint iteration of
    a packed stream batch (no history yet): the writers' begins' min-sparse
    table, the spans' range-update point-query array and the reads' rank
    bounds."""
    tdev, rmq = fdb["device"], fdb["rmq"]
    rb, re_, _r_tx, wb, we, w_tx, _snap, _active = tdev.stage_batch(dev, *packed[:8])
    rb_r, re_r, wb_r, we_r = tdev._intra_setup(rb, re_, wb, we)
    n = 2 * (rb.shape[0] + wb.shape[0])
    w_ok = w_tx >= 0
    w_cand = torch.where(w_ok, w_tx, rmq.I32_MAX)
    begs = torch.full((n,), rmq.I32_MAX, dtype=torch.int32, device=dev)
    begs.scatter_reduce_(0, wb_r.long(), w_cand, "amin")
    beg_tab = rmq.build_sparse_table(begs, torch.minimum, rmq.I32_MAX)
    stab = rmq.range_update_point_query(n, wb_r, we_r, w_cand, w_ok & (wb_r < we_r),
                                        "min", rmq.I32_MAX)
    return beg_tab, stab, rb_r, re_r


def kernel_check(torch, kernels, results: dict, flush, name, got, want, work, fn,
                 plain_fn, reps, cold, key=None, symbol=None, library_fn=None):
    """Phase 3's check of one kernel: `got` (the kernel's outputs) must
    equal `want` (its plain version's); times `fn` (the kernel) warm, cold
    (after writing `flush`), by the profiler and back to back, `plain_fn`
    and `library_fn`, and records them with the bound of `work` in
    results[key].  `cold`: the main path finds the kernel's inputs out of L2, so
    its `ms` (and the plain version's) is timed after a flush.  `key`:
    where the results go (the kernel's name by default).  `symbol`: the
    CUDA kernel the wrapper's plan launches (planned_symbol), which the
    profiler must record; SYMBOLS[name] by default.  `library_fn`: one
    PyTorch call computing the kernel's first output, timed as the
    yardstick `library_ms` (None without one); the port never calls it."""
    torch.cuda.synchronize()
    n_bytes, n_ops, replay = work
    # compared in their own dtype (K4's outputs at W = 32769 are 8.6 GB:
    # an int64 copy of both would not fit beside the inputs)
    mismatches = sum(int((g != w).sum()) for g, w in zip(got, want))
    err = max((int((g[g != w].long() - w[g != w].long()).abs().max())
               if bool((g != w).any()) else 0) for g, w in zip(got, want))
    require(replay is None or torch.equal(replay.long(), got[0].long()),
            f"{name}: the replay that counts its work disagrees with it")
    warm_ms = launch_ms(torch, fn, reps)
    cold_ms = launch_ms(torch, fn, reps, flush)
    symbol = symbol or SYMBOLS[name]
    own_ms = device_ms(torch, fn, symbol, reps)
    require(own_ms is not None, f"{key or name}: the profiler recorded no launch of "
                                f"{symbol}, the planned kernel")
    back_to_back = call_ms(torch, fn, reps)
    plain_ms = launch_ms(torch, plain_fn, max(3, reps // 10), flush if cold else None)
    library_ms = None
    if library_fn is not None:
        lib = library_fn()
        require(torch.equal(lib.reshape(got[0].shape), got[0]),
                f"{key or name}: the library call's yardstick disagrees with the kernel")
        del lib
        library_ms = launch_ms(torch, library_fn, reps, flush if cold else None)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    ms = cold_ms if cold else warm_ms
    results[key or name] = dict(symbol=symbol, mismatches=mismatches,
                                max_abs_err=err, ms=ms,
                                cold_ms=cold_ms, warm_ms=warm_ms, device_ms=own_ms,
                                call_ms=back_to_back, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=library_ms)
    log(f"kernel {key or name}: {symbol} mismatches={mismatches} ms={ms:.6f} "
        f"({'cold' if cold else 'warm'} L2, as on the main path) "
        f"cold_ms={cold_ms:.6f} warm_ms={warm_ms:.6f} "
        f"device_ms={own_ms if own_ms is None else f'{own_ms:.6f}'} (profiler, warm) "
        f"call_ms={back_to_back:.6f} (back to back, host launch included) "
        f"plain_ms={plain_ms:.6f} "
        f"library_ms={library_ms if library_ms is None else f'{library_ms:.6f}'} "
        f"bound_us={bound_ms * 1e3:.3f} ({bound_by}: "
        f"{n_bytes} B, {n_ops} ops) ms/bound={ms / bound_ms:.2f} "
        f"launches={kernels.launches[name]} (this phase)")
    require(mismatches == 0, f"kernel {name} disagrees with its plain version")


def kernel_phase(torch, fdb, dev, rng, pool, succ, first_batch):
    keys_mod, kernels, tdev, rmq = fdb["keys"], fdb["kernels"], fdb["device"], fdb["rmq"]
    run_cap = SET_ARGS["run_capacity"]
    R = TXNS * READS_PER_TXN
    lanes = lambda a: keys_mod.to_lanes(a, dev)  # noqa: E731
    results = {}
    kernels.reset_launches()
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    floor_ms = launch_ms(torch, lambda: None, 100)
    log(f"kernels: an event pair with no launch between reads {floor_ms:.6f} ms (the "
        f"floor under each per-launch time below)")
    check = functools.partial(kernel_check, torch, kernels, results, flush)

    # K1: 8 runs of ~8K point intervals (one dead, one empty), 16384
    # reads with padding (sentinel) rows and TOO_OLD (r_ok False) rows
    base = kernel_inputs(torch, keys_mod, dev, rng, pool, succ)
    k1, runs, ks_np = base["k1"], base["runs"], base["main"]
    runs_b, runs_e, runs_ver = k1[4:7]
    check("probe_fused", [kernels.probe_fused(*k1)],
          [kernels.probe_fused_plain(*k1)], probe_fused_work(torch, *k1),
          fn=lambda: kernels.probe_fused(*k1),
          plain_fn=lambda: kernels.probe_fused_plain(*k1), reps=50, cold=True)

    # K5: K1's inputs without the history bits; it must also equal K1 run
    # with no history bit set, and ORed with the history bits equal K1
    k5 = k1[:7]
    no_hist = torch.zeros_like(k1[7])
    k5_out = kernels.run_conflicts(*k5)
    require(torch.equal(k5_out, kernels.probe_fused(*k5, no_hist)),
            "K5 disagrees with K1 run without history bits")
    require(torch.equal(k5_out | k1[7], kernels.probe_fused(*k1)),
            "K5 | history disagrees with K1")
    check("probe", [k5_out], [kernels.run_conflicts_plain(*k5)],
          probe_fused_work(torch, *k5),
          fn=lambda: kernels.run_conflicts(*k5),
          plain_fn=lambda: kernels.run_conflicts_plain(*k5), reps=50, cold=True)
    plan_k5 = kernels.plan_probe_tree(*runs_b.shape)
    results["probe"]["plan"] = plan_k5._asdict()
    k1_ms, k5 = results["probe_fused"]["cold_ms"], results["probe"]
    log(f"kernel probe: plan {plan_k5._asdict()} "
        f"({kernels.probe_tree_bytes(plan_k5.levels, runs_b.shape[2])} B of staged tree "
        f"a block), cold {k5['cold_ms']:.6f} ms, bound {k5['bound_ms'] * 1e3:.3f} us, "
        f"ms/bound {k5['cold_ms'] / k5['bound_ms']:.2f}; K1 (probe_fused, same inputs "
        f"with history bits) {k1_ms:.6f} ms, K5 / K1 = {k5['cold_ms'] / k1_ms:.2f}")

    # K2's per-query referee: the first fixpoint iteration's tables of a
    # real stream batch; warm: the fixpoint builds both tables just before
    # each query
    k2 = referee_inputs(torch, fdb, dev, first_batch)
    check("intra_query", [kernels.intra_query(*k2)], [kernels.intra_query_plain(*k2)],
          intra_query_work(torch, rmq, *k2),
          fn=lambda: kernels.intra_query(*k2),
          plain_fn=lambda: kernels.intra_query_plain(*k2), reps=100, cold=False)
    ref = results["intra_query"]
    ref["floor_ms"] = floor_ms
    log(f"kernel intra_query: {-(-k2[2].shape[0] // kernels.QUERY_THREADS)} blocks of "
        f"{kernels.QUERY_THREADS} threads, warm {ref['warm_ms']:.6f} ms beside the event "
        f"pair's floor {floor_ms:.6f} ms (+{ref['warm_ms'] - floor_ms:.6f}), bound "
        f"{ref['bound_ms'] * 1e3:.3f} us")

    # K2 redesigned: the whole fixpoint of the first stream batch (no
    # history yet), then of a chain batch, held against its plain version,
    # the loop it replaced (the per-query kernel above in a host loop) and
    # the grid plan; warm, as on the main path, where the ranks were just made
    fixpoint_check(check, results, torch, kernels,
                   k2_stream_inputs(torch, tdev, dev, first_batch), "intra_fixpoint",
                   reps=50)
    fixpoint_check(check, results, torch, kernels,
                   chain_inputs(torch, keys_mod, tdev, dev, pool, succ, CHAIN_TXNS),
                   "intra_fixpoint_chain", reps=10)

    # K3: ~447K live boundaries of main at cap 2**19 (the stream's size
    # after 24 batches) against one run's step rows (2 * run_cap,
    # sentinels included)
    ks = lanes(ks_np)
    u_b, u_e = lanes(runs[1][0]), lanes(runs[1][1])
    rec, _ = kernels.run_to_step_plain(u_b, u_e, runs_ver[1])
    check("compact_ranks", [kernels.compact_ranks(ks, rec)],
          [kernels.compact_ranks_plain(ks, rec)],
          compact_ranks_work(torch, keys_mod, ks, rec),
          fn=lambda: kernels.compact_ranks(ks, rec),
          plain_fn=lambda: kernels.compact_ranks_plain(ks, rec), reps=50, cold=True)

    # K4: the 8 runs of a compaction (of the stream's shape) as step
    # functions, in one launch; its yardstick is the rows' torch.stack
    # (vals, under 10% of the bytes at W = 5 and 1% from W = 65, left out)
    k4 = (runs_b, runs_e, runs_ver)
    check("run_to_step", list(kernels.run_to_step_runs(*k4)),
          list(kernels.run_to_step_runs_plain(*k4)),
          run_to_step_work(*runs_b.shape),
          fn=lambda: kernels.run_to_step_runs(*k4),
          plain_fn=lambda: kernels.run_to_step_runs_plain(*k4), reps=100, cold=True,
          library_fn=lambda: run_to_step_library(torch, runs_b, runs_e))
    # K1, K3 and K4 at the wider keys a set widens to (64 to 131072 bytes),
    # at the stream's K, run_cap and cap up to W = 513 and at the default
    # set's from WIDEST_FROM (the first 4096 rows of each run, every 8th
    # main row, the last WIDEST_READS reads there); K1 and K3 on both of
    # wide_inputs' inputs, K4 (a copy, whatever the keys) on `prefixed`
    for W_wide in WIDE_W:
        cut = wide_cut(W_wide, run_cap, SET_ARGS["capacity"], R)
        # K1 and K3 take 0.1-11 ms a launch from W = 257, K4 0.7-5.7 ms from 4097
        reps = 50 if W_wide < WIDEST_FROM else 20 if W_wide < WIDE_FEW_REPS else 10
        plan_k1 = kernels.plan_probe(SET_ARGS["run_slots"], cut[0], W_wide)
        plan_k3 = kernels.plan_ranks(W_wide)
        log(f"kernels at W={W_wide}: K1 plan {plan_k1._asdict()}; K3 plan "
            f"{plan_k3._asdict()}")
        for kind in WIDE_INPUTS:
            torch.cuda.empty_cache()  # the last input's blocks: gigabytes at W >= 8193
            k1w, ks_w, rec_w = wide_inputs(torch, keys_mod, kernels, kind, W_wide, dev,
                                           base, cut)
            suffix = f"_w{W_wide}" + ("" if kind == "prefixed" else f"_{kind}")
            check("probe_fused", [kernels.probe_fused(*k1w)],
                  [kernels.probe_fused_plain(*k1w)], probe_fused_work(torch, *k1w),
                  fn=lambda: kernels.probe_fused(*k1w),
                  plain_fn=lambda: kernels.probe_fused_plain(*k1w), reps=reps, cold=True,
                  key="probe_fused" + suffix, symbol=planned_symbol("probe_fused", plan_k1))
            check("compact_ranks", [kernels.compact_ranks(ks_w, rec_w)],
                  [kernels.compact_ranks_plain(ks_w, rec_w)],
                  compact_ranks_work(torch, keys_mod, ks_w, rec_w),
                  fn=lambda: kernels.compact_ranks(ks_w, rec_w),
                  plain_fn=lambda: kernels.compact_ranks_plain(ks_w, rec_w), reps=reps,
                  cold=True, key="compact_ranks" + suffix,
                  symbol=planned_symbol("compact_ranks", plan_k3))
            for name, plan in (("probe_fused", plan_k1), ("compact_ranks", plan_k3)):
                results[name + suffix]["plan"] = "warp" if plan.warp else "staged"
            del k1w, ks_w, rec_w  # K4's outputs and its plain version's take their room
        runs_bw = prefixed_lanes(torch, keys_mod, base["runs_b"][:, :cut[0]], W_wide, dev)
        runs_ew = prefixed_lanes(torch, keys_mod, base["runs_e"][:, :cut[0]], W_wide, dev)
        k4w = (runs_bw, runs_ew, runs_ver)
        check("run_to_step", list(kernels.run_to_step_runs(*k4w)),
              list(kernels.run_to_step_runs_plain(*k4w)),
              run_to_step_work(*runs_bw.shape),
              fn=lambda: kernels.run_to_step_runs(*k4w),
              plain_fn=lambda: kernels.run_to_step_runs_plain(*k4w), reps=reps,
              cold=True, key=f"run_to_step_w{W_wide}",
              library_fn=lambda: run_to_step_library(torch, runs_bw, runs_ew))
        del runs_bw, runs_ew, k4w
    log("kernels " + json.dumps({k: v["mismatches"] for k, v in results.items()}))
    return results


# ---------------------------------------------------------------------------
# phases 4 and 5: the resolver's conflict check end to end


def stream_batches(TxInfo, rng, pool, succ, n_batches, txns=TXNS):
    """(commit_version, [TxInfo]) per batch, as bench.py draws them."""
    kb, sb = pool.tobytes(), succ.tobytes()
    key = lambda i: kb[i * KEY_BYTES:(i + 1) * KEY_BYTES]  # noqa: E731
    nxt = lambda i: sb[i * KEY_BYTES:(i + 1) * KEY_BYTES]  # noqa: E731
    out = []
    for version in range(1, n_batches + 1):
        reads = rng.integers(0, len(pool), size=(txns, READS_PER_TXN)).tolist()
        writes = rng.integers(0, len(pool), size=txns).tolist()
        snaps = np.maximum(version - 1 - rng.integers(0, SNAP_WINDOW, txns), 0).tolist()
        out.append((version, [
            TxInfo(s, [(key(i), nxt(i)) for i in r], [(key(w), nxt(w))])
            for s, r, w in zip(snaps, reads, writes)
        ]))
    return out


def stream_phase(torch, fdb, batches, power):
    """Phase 4: the flat layout (the reference constructor's default)
    through resolve_batch on "cuda" and on "cpu".  Returns (launches, the
    cuda set, the verdicts per batch, the fixpoint's iterations)."""
    tdev, kernels, Verdict = fdb["device"], fdb["kernels"], fdb["Verdict"]
    on_gpu = tdev.DeviceConflictSet(**SET_ARGS, device="cuda")
    on_cpu = tdev.DeviceConflictSet(**SET_ARGS, device="cpu")
    kernels.reset_launches()
    gpu_ms, verdicts = [], []
    for i, (version, txns) in enumerate(batches, start=1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = on_gpu.resolve_batch(version, txns)
        torch.cuda.synchronize()
        gpu_ms.append((time.perf_counter() - t0) * 1e3)
        verdicts.append(got)
        if i >= GC_FROM_BATCH:
            on_gpu.remove_before(version - GC_LAG)
    launches = kernels.launch_counts()
    syncs = on_gpu.host_syncs / len(batches)
    iters = on_gpu.fixpoint_iterations()
    t_cpu = time.perf_counter()
    for i, ((version, txns), got) in enumerate(zip(batches, verdicts), start=1):
        want = on_cpu.resolve_batch(version, txns)
        require(got == want, f"batch {i}: cuda and cpu verdicts differ")
        if i >= GC_FROM_BATCH:
            on_cpu.remove_before(version - GC_LAG)
    cpu_s = time.perf_counter() - t_cpu
    same_state(on_gpu, on_cpu, "flat stream")
    require(iters == on_cpu.fixpoint_iterations(),
            "flat stream: the fixpoint's iterations differ from the cpu run's")
    counts = {v: sum(1 for vs in verdicts for x in vs if x == v) for v in Verdict}
    timed = gpu_ms[PREFILL_BATCHES:]
    checks = TIMED_BATCHES * TXNS * (READS_PER_TXN + 1)
    stats = on_gpu.kernel_stats()
    log(f"stream: {len(batches)} batches x {TXNS} txns identical on cuda and "
        f"cpu; verdicts {({k.name: n for k, n in counts.items()})}; "
        f"compactions={on_gpu.stats.compactions} node_count={on_gpu.node_count} "
        f"cap={on_gpu.capacity}")
    log(f"stream: resolve_batch ms on cuda ({power}), timed batches: "
        f"p50={float(np.percentile(timed, 50)):.3f} "
        f"p99={float(np.percentile(timed, 99)):.3f} max={max(timed):.3f} "
        f"(n={len(timed)}); checks/s={checks / (sum(timed) / 1e3):.1f}")
    log(f"stream: all batches: pack_ms={stats['pack_ms']:.3f} "
        f"h2d_ms={stats['h2d_ms']:.3f} resolve_ms={stats['resolve_ms']:.3f} "
        f"compact_ms={stats['phase']['compact_ms']:.3f} "
        f"resolve_arrays p50={stats['resolve_ms_p50']:.3f} "
        f"p99={stats['resolve_ms_p99']:.3f}; host syncs per batch "
        f"{syncs:.2f}; fixpoint iterations per batch {iters / len(batches):.3f} "
        f"(= the cpu run's)")
    log(f"stream: per-batch ms on cuda: {[round(x, 3) for x in gpu_ms]}")
    log(f"stream: cpu cross-check took {cpu_s:.1f} s")
    log(f"stream: launches {json.dumps(launches)}")
    check_path_launches(launches, len(batches), on_gpu.stats.compactions, "flat stream")
    plans = k2_plans(launches)
    require("grid" not in plans and sum(plans.values()) == len(batches),
            f"flat stream: K2 took the cluster plan on every batch, not {plans}")
    require(syncs <= 2.0, f"flat stream: {syncs:.2f} host syncs a batch, more than 2")
    require(counts[Verdict.TOO_OLD] > 0, "the GC clamp never made a txn TOO_OLD")
    return launches, on_gpu, verdicts, iters


def check_path_launches(launches, n_batches: int, compactions: int, where: str,
                        expected_compactions: int = 2) -> None:
    """The main path's kernels: K1 and K2 once a batch, K4 once a
    compaction, K3 once a run it folds (8 a compaction, more on a regrow);
    the referees never."""
    require(compactions == expected_compactions,
            f"{where}: {compactions} compactions, expected {expected_compactions}")
    need = {"probe_fused": n_batches, "intra_fixpoint": n_batches,
            "run_to_step": compactions, "intra_query": 0, "probe": 0}
    for name, n in need.items():
        require(launches[name] == n, f"{where}: {name} launched {launches[name]} times, not {n}")
    require(launches["compact_ranks"] >= 8 * compactions,
            f"{where}: compact_ranks launched {launches['compact_ranks']} times")


def same_state(a, b, where: str) -> None:
    """The two sets' exported states are equal, key by key."""
    same_export(a.export_state(), b.export_state(), where)


def same_export(a: dict, b: dict, where: str) -> None:
    require(a.keys() == b.keys(), f"{where}: the state keys differ")
    for k in a:
        require(np.array_equal(np.asarray(a[k]), np.asarray(b[k])),
                f"{where}: state {k!r} differs")


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def launch_calls(events) -> int:
    return sum(e.count for e in events if e.key in LAUNCH_CALLS)


def sync_calls(events) -> int:
    return sum(e.count for e in events if "Synchronize" in e.key)


def busy_ms(torch, events) -> float:
    """Device time of a profile: the device-side records (the kernels)
    only, since an op's own record repeats the time of its kernels."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(_device_us(e) for e in events if e.device_type == cuda) / 1e3


def profile_phase(torch, fdb, on_gpu, batches, power):
    """A few more batches past the stream, twice from the same state: on
    the stream's cuda set with nothing attached (the wall time), and on a
    twin loaded from its exported state under torch.profiler (device time
    per op; the profiler's own start-up would swamp its wall clock).
    Gives the device's busy share of the wall time and the ops that take
    the most device and host time — the where-the-time-goes breakdown."""
    from torch.profiler import ProfilerActivity, profile

    twin = fdb["device"].DeviceConflictSet(**SET_ARGS, device="cuda")
    twin.load_state(on_gpu.export_state())
    walls, plain = [], []
    for version, txns in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain.append(on_gpu.resolve_batch(version, txns))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = [twin.resolve_batch(version, txns) for version, txns in batches]
        torch.cuda.synchronize()
    require(traced == plain, "the profiled twin's verdicts differ")
    events = prof.key_averages()
    busy = busy_ms(torch, events)
    wall_ms = sum(walls)
    log(f"profile: {len(batches)} batches (the first compacts 8 runs), wall "
        f"{[round(w, 3) for w in walls]} ms, device busy {busy:.3f} ms = "
        f"{100 * busy / wall_ms:.1f}% of {wall_ms:.3f} ms on {power}; "
        f"{launch_calls(events) / len(batches):.1f} launches and "
        f"{sync_calls(events) / len(batches):.2f} synchronize calls a batch")
    ours = {name: sum(_device_us(e) for e in events if _is_kernel(e.key, symbol)) / 1e3
            for name, _where, symbol in KERNELS}
    log(f"profile: the hand kernels' device ms {json.dumps(ours)} = "
        f"{100 * sum(ours.values()) / max(busy, 1e-9):.1f}% of device busy")
    for e in sorted(events, key=_device_us, reverse=True)[:12]:
        log(f"  device {_device_us(e) / 1e3:9.3f} ms  calls={e.count:6d}  {e.key[:70]}")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]:
        log(f"  host   {e.self_cpu_time_total / 1e3:9.3f} ms  calls={e.count:6d}  {e.key[:70]}")


# ---------------------------------------------------------------------------
# phase 6: the best-known layout (bench.py's BEST_KNOWN) in three modes


def gc_floor(index: int, version: int):
    """The stream's GC schedule: after batch `index` (1-based) the set
    drops versions below commit - GC_LAG, from GC_FROM_BATCH on."""
    return version - GC_LAG if index >= GC_FROM_BATCH else None


def drive(torch, fdb, mode: str, cs, batches, first: int):
    """Runs `batches` (numbered from `first` for the GC schedule) through
    `cs` in one mode and returns (verdicts per batch, wall ms per batch):

      sync      resolve_batch, the wall of each call ending in the verdicts;
      deferred  resolve_deferred, each handle waited one batch behind, as
                the resolver role's split-phase path does; a batch's wall
                is its iteration (dispatch it, wait the one before, GC);
      packer    a PipelinedPacker packs and stages (BatchStager, pinned
                memory, a side stream) up to two batches ahead on its
                thread, as bench.py's resolver-e2e stream does; each
                staged batch goes to resolve_arrays(sync=False), verdicts
                are read two batches behind, and one check_pipelined()
                ends the stream.  Packing needs the MVCC floor the set
                will have at dispatch, which the GC schedule gives.
    The last wait (and the check) is added to the last batch's wall."""
    tdev, pipeline, Verdict = fdb["device"], fdb["pipeline"], fdb["Verdict"]
    walls, out = [], []
    torch.cuda.synchronize()
    if mode == "sync":
        for i, (version, txns) in enumerate(batches, start=first):
            t0 = time.perf_counter()
            out.append(cs.resolve_batch(version, txns))
            walls.append((time.perf_counter() - t0) * 1e3)
            floor = gc_floor(i, version)
            if floor is not None:
                cs.remove_before(floor)
        return out, walls
    if mode == "deferred":
        prev = None
        for i, (version, txns) in enumerate(batches, start=first):
            t0 = time.perf_counter()
            h = cs.resolve_deferred(version, txns)
            if prev is not None:
                out.append(prev.wait())
            floor = gc_floor(i, version)
            if floor is not None:
                cs.remove_before(floor)
            prev = h
            walls.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        out.append(prev.wait())
        walls[-1] += (time.perf_counter() - t0) * 1e3
        return out, walls
    require(mode == "packer", f"unknown mode {mode}")
    floors, floor = [], cs.oldest_version
    for i, (version, _txns) in enumerate(batches, start=first):
        floors.append(floor)
        nxt = gc_floor(i, version)
        floor = floor if nxt is None else nxt
    arena = pipeline.PackArena(depth=6)

    def pack(item):
        txns, floor = item
        return tdev.pack_batch(txns, floor, lambda v: max(v - floor, 0),
                               SET_ARGS["max_key_bytes"], arena=arena,
                               stats=cs.stats)

    packer = pipeline.PipelinedPacker(pack, depth=2, stage=tdev.BatchStager("cuda"),
                                      stats=cs.stats)
    pending, submitted = [], 0

    def read(entry):
        verdict, n = entry
        codes = verdict[:n].cpu().numpy()
        out.append([Verdict(int(c)) for c in codes])

    try:
        for i, (version, txns) in enumerate(batches, start=first):
            t0 = time.perf_counter()
            while submitted < len(batches) and submitted <= i - first + 1:
                packer.submit((batches[submitted][1], floors[submitted]))
                submitted += 1
            staged = packer.get()
            require(cs._base == floors[i - first], "packed against a stale floor")
            pending.append((cs.resolve_arrays(version, *staged.take(), sync=False),
                            len(txns)))
            if len(pending) > 2:
                read(pending.pop(0))
            floor = gc_floor(i, version)
            if floor is not None:
                cs.remove_before(floor)
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        packer.close()
    t0 = time.perf_counter()
    for entry in pending:
        read(entry)
    cs.check_pipelined()
    walls[-1] += (time.perf_counter() - t0) * 1e3
    return out, walls


def best_known_phase(torch, fdb, batches, flat_verdicts, flat_iters, power):
    """Phase 6: the stream through DeviceConflictSet(lsm=True,
    search_impl="bucket") on "cpu" once, then on "cuda" in each mode of
    `drive`, twice, in TURNS, each turn on a fresh set: verdicts equal the
    flat run's and the cpu run's batch by batch, the final state (ks, vs,
    tab, bidx, runs) equals the cpu run's, no search fell back, and every
    kernel of the path launched.  Returns {mode: (the first turn's set,
    its launches, {"turns": [metrics per turn]})}."""
    tdev, kernels = fdb["device"], fdb["kernels"]
    t = time.perf_counter()
    on_cpu = tdev.DeviceConflictSet(**SET_ARGS, **BEST_KNOWN, device="cpu")
    cpu_verdicts = []
    for i, (version, txns) in enumerate(batches, start=1):
        cpu_verdicts.append(on_cpu.resolve_batch(version, txns))
        floor = gc_floor(i, version)
        if floor is not None:
            on_cpu.remove_before(floor)
    require(cpu_verdicts == flat_verdicts, "best-known cpu run differs from the flat run")
    require(on_cpu.fixpoint_iterations() == flat_iters,
            "best-known cpu run: the fixpoint's iterations differ from the flat run's")
    log(f"best-known: cpu reference run took {time.perf_counter() - t:.1f} s")
    checks = TIMED_BATCHES * TXNS * (READS_PER_TXN + 1)
    runs = {}
    for turn, mode in enumerate(TURNS, start=1):
        cs = tdev.DeviceConflictSet(**SET_ARGS, **BEST_KNOWN, device="cuda")
        kernels.reset_launches()
        got, walls = drive(torch, fdb, mode, cs, batches, 1)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        for i, (a, b) in enumerate(zip(got, flat_verdicts), start=1):
            require(a == b, f"best-known {mode}: batch {i} differs from the flat run")
        require(len(got) == len(batches), f"best-known {mode}: verdicts missing")
        same_state(cs, on_cpu, f"best-known {mode}")
        require(cs.search_fallbacks == 0, f"best-known {mode}: a search fell back")
        check_path_launches(launches, len(batches), cs.stats.compactions,
                            f"best-known {mode}")
        timed = walls[PREFILL_BATCHES:]
        stats = cs.kernel_stats()
        reads = len(batches) if mode == "packer" else 0  # the caller's own
        syncs = cs.host_syncs + reads
        iters = cs.fixpoint_iterations()
        require(iters == flat_iters,
                f"best-known {mode}: the fixpoint's iterations differ from the cpu run's")
        m = dict(checks_per_s=checks / (sum(timed) / 1e3),
                 p50_ms=float(np.percentile(timed, 50)),
                 p99_ms=float(np.percentile(timed, 99)), n=len(timed),
                 pack_ms=stats["pack_ms"],
                 encode_pad_ms=stats["encode_ms"] + stats["pad_ms"],
                 h2d_ms=stats["h2d_ms"],
                 syncs_per_batch=syncs / len(batches),
                 iters_per_batch=iters / len(batches))
        runs.setdefault(mode, (cs, launches, {"turns": []}))[2]["turns"].append(m)
        log(f"best-known {mode} (turn {turn}): {len(batches)} batches identical to the flat "
            f"run and the cpu run, final state equal; checks/s="
            f"{m['checks_per_s']:.1f} timed-batch ms p50={m['p50_ms']:.3f} "
            f"p99={m['p99_ms']:.3f} (n={m['n']}); all batches: pack_ms="
            f"{m['pack_ms']:.3f} encode+pad_ms={m['encode_pad_ms']:.3f} "
            f"h2d_ms={m['h2d_ms']:.3f} host syncs per batch="
            f"{m['syncs_per_batch']:.2f} fixpoint iterations per batch="
            f"{m['iters_per_batch']:.3f} (= the cpu run's); "
            f"compactions={cs.stats.compactions} on {power}")
        log(f"best-known {mode} (turn {turn}): per-batch ms {[round(w, 3) for w in walls]}")
        log(f"best-known {mode} (turn {turn}): launches {json.dumps(launches)}")
    return runs


def best_known_profile(torch, fdb, runs, batches, first: int, power):
    """Each mode's device-busy share: the few batches past the stream run
    in that mode on the mode's set with nothing attached (the wall), and
    on a twin loaded from its state under torch.profiler (device time)."""
    from torch.profiler import ProfilerActivity, profile

    for mode, (cs, _launches, m) in runs.items():
        twin = fdb["device"].DeviceConflictSet(**SET_ARGS, **BEST_KNOWN, device="cuda")
        twin.load_state(cs.export_state())
        plain, walls = drive(torch, fdb, mode, cs, batches, first)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced, _ = drive(torch, fdb, mode, twin, batches, first)
            torch.cuda.synchronize()
        require(traced == plain, f"best-known {mode}: the profiled twin differs")
        events = prof.key_averages()
        busy = busy_ms(torch, events)
        m["busy_share"] = busy / sum(walls)
        syncs, launches = sync_calls(events), launch_calls(events)
        m["launches_per_batch"] = launches / len(batches)
        log(f"best-known {mode} profile: {len(batches)} batches, wall "
            f"{[round(w, 3) for w in walls]} ms, device busy {busy:.3f} ms = "
            f"{100 * m['busy_share']:.1f}% on {power}; the profiler saw "
            f"{syncs} synchronize calls and {launches} kernel launches")


def referee_phase(torch, fdb, cs, version, txns):
    """The referees in their roles, on one batch against the live state of
    a best-known set (its runs, its cached table): K5, K1's unfused
    referee, and the per-query intra kernel in the host loop K2 replaced,
    held against K2 on the batch's history bits.  Nothing is written to
    the set.  Returns the referees' launches in this phase."""
    tdev, kernels = fdb["device"], fdb["kernels"]
    packed = tdev.pack_batch(txns, cs.oldest_version, cs._offset,
                             SET_ARGS["max_key_bytes"])
    rb, re_, r_tx, wb, we, w_tx, snap, active = tdev.stage_batch(cs.device, *packed[:8])
    kernels.reset_launches()
    g_lo, g_hi, conv = tdev.inc_search(cs._ks, cs._bidx, cs._count, rb, re_, r_tx)
    require(bool(conv), "referee batch: the bucketed search did not converge")
    r_ok = r_tx >= 0
    snap_r = snap[torch.clamp(r_tx, 0, snap.shape[0] - 1).long()]
    read_max = fdb["rmq"].query_sparse_table(cs._tab, g_lo, g_hi, torch.maximum, 0)
    hist_r = r_ok & (read_max > snap_r)
    runs = (cs._runs_b, cs._runs_e, cs._runs_ver)
    fused = kernels.probe_fused(rb, re_, snap_r, r_ok, *runs, hist_r)
    unfused = kernels.run_conflicts(rb, re_, snap_r, r_ok, *runs) | hist_r
    torch.cuda.synchronize()
    launches = kernels.launches["probe"]
    require(torch.equal(fused, unfused), "K5 | history disagrees with K1 on live state")
    require(launches > 0, "the referee never launched K5")
    log(f"referee: K5 | history == K1 on a live batch ({int(fused.sum())} of "
        f"{int(r_ok.sum())} live reads conflict; {cs._n_runs} live runs); "
        f"K5 launches {launches}")
    B = active.shape[0]
    r_idx = torch.clamp(r_tx, 0, B - 1).long()
    hist = torch.zeros(B, dtype=torch.int32, device=cs.device).index_add_(
        0, r_idx, (r_ok & fused).to(torch.int32)) > 0
    fx = (*tdev._intra_setup(rb, re_, wb, we), r_ok,
          (w_tx >= 0) & ~tdev._is_sentinel(wb), r_idx,
          torch.clamp(w_tx, 0, B - 1).long(), w_tx, active, hist, B)
    intra, n_iters = kernels.intra_fixpoint(*fx)
    loop_intra, loop_iters = kernels.intra_fixpoint_plain(*fx, query=kernels.intra_query)
    torch.cuda.synchronize()
    k2 = kernels.launches["intra_query"]
    require(torch.equal(intra, loop_intra) and int(n_iters) == int(loop_iters),
            "the per-query loop disagrees with K2 on a live batch")
    require(k2 == int(n_iters), "the referee loop did not launch the query once an iteration")
    log(f"referee: the per-query loop == K2 on the live batch ({int(hist.sum())} "
        f"history-conflicted, {int(intra.sum())} intra-conflicted txns, "
        f"{int(n_iters)} iterations); per-query launches {k2}")
    return {"probe": launches, "intra_query": k2}


def recovery_drill(fdb):
    """A deep 16-bit-prefix bucket on the card: 3000 point writes under
    "ZZ", benign batches until a compaction folds them into main, then
    probes whose bucketed search cannot converge — all through
    resolve_deferred.  The window must recover (the coverage site
    kernel.pipeline_recover) and match OracleConflictSet."""
    tdev, TxInfo = fdb["device"], fdb["TxInfo"]
    zz = [b"ZZ%04d" % i for i in range(3000)]
    stream = [(10, [TxInfo(0, [], [(k, k + b"\x00")]) for k in zz])]
    for v in (20, 30, 40):
        stream.append((v, [TxInfo(v - 5, [(b"b%d" % v, b"c")], [(b"d%d" % v, b"e")])]))
    probes = [(b"ZZ%04d" % i, b"ZZ%04d" % (i + 1)) for i in range(7, 3000, 97)]
    stream.append((50, [TxInfo(45, probes, [(b"q", b"q\x00")]),
                        TxInfo(45, [(b"ZZ0001", b"ZZ2999")], [])]))
    oracle = fdb["oracle"].OracleConflictSet()
    cs = tdev.DeviceConflictSet(**BEST_KNOWN, max_key_bytes=16, capacity=1 << 14,
                                run_slots=2, device="cuda")
    before = fdb["coverage"].hits("kernel.pipeline_recover")
    handles = [cs.resolve_deferred(v, t) for v, t in stream]
    for (v, t), h in zip(stream, handles):
        require(h.wait() == oracle.resolve_batch(v, t), f"recovery drill: batch {v} differs")
    recovered = fdb["coverage"].hits("kernel.pipeline_recover") - before
    require(recovered == 1, f"recovery drill: {recovered} recoveries, expected 1")
    require(cs.search_fallbacks >= 1, "recovery drill: the replay never fell back")
    log(f"recovery: deep bucket (3000 keys under one prefix) recovered once, "
        f"search_fallbacks={cs.search_fallbacks}, verdicts equal to the oracle")


def oracle_batches(TxInfo, rng, n_batches=24, txns=512):
    """Variable-length keys sharing prefixes, point and short ranges."""
    def raw(lo, hi, n):
        return rng.integers(lo, hi, size=n, dtype=np.uint8).tobytes()

    stems = [raw(97, 101, int(rng.integers(1, 9))) for _ in range(64)]

    def key():
        stem = stems[int(rng.integers(0, len(stems)))]
        return stem + raw(0, 256, int(rng.integers(0, 9)))

    def rng_range():
        k = key()
        if rng.random() < 0.7:
            return k, k + b"\x00"
        return k, k + raw(0, 256, int(rng.integers(1, 4)))

    out = []
    for version in range(1, n_batches + 1):
        out.append((version, [
            TxInfo(int(max(version - 1 - rng.integers(0, 6), 0)),
                   [rng_range() for _ in range(int(rng.integers(0, 4)))],
                   [rng_range() for _ in range(int(rng.integers(0, 3)))])
            for _ in range(txns)
        ]))
    return out


def oracle_phase(fdb, batches):
    cs = fdb["device"].DeviceConflictSet(capacity=1 << 10, device="cuda")
    oracle = fdb["oracle"].OracleConflictSet()
    for i, (version, txns) in enumerate(batches, start=1):
        require(cs.resolve_batch(version, txns) == oracle.resolve_batch(version, txns),
                f"oracle batch {i}: verdicts differ")
        if i % 5 == 0:
            cs.remove_before(version - 3)
            oracle.remove_before(version - 3)
    require(cs.capacity > 1 << 10, "main never regrew in the oracle stream")
    log(f"oracle: {len(batches)} batches x {len(batches[0][1])} txns identical "
        f"to OracleConflictSet; compactions={cs.stats.compactions} cap={cs.capacity}")


# ---------------------------------------------------------------------------
# phase 9: the supervised set (DeviceSupervisor over the best-known set)


class StepClock:
    """The supervisor's clock in the drill: `step` seconds a batch, so the
    retry backoff (0.05 s, then 0.1 s) elapses between batches and the
    re-probe interval (5 s) does not before the drill promotes by hand."""

    def __init__(self, step: float) -> None:
        self.t, self.step = 0.0, step

    def __call__(self) -> float:
        return self.t

    def tick(self) -> None:
        self.t += self.step


def supervised_set(fdb, natives: list, **kw):
    """DeviceSupervisor over the best-known set on "cuda", the port's native
    skip list as its CPU fallback; every native set it builds goes into
    `natives`."""
    def fallback(oldest=0):
        natives.append(fdb["native"].NativeConflictSet(oldest))
        return natives[-1]

    return fdb["supervisor"].DeviceSupervisor(
        lambda oldest=0: fdb["device"].DeviceConflictSet(
            oldest, **SET_ARGS, **BEST_KNOWN, device="cuda"),
        fallback_factory=fallback, **kw)


def served(natives: list) -> int:
    """Batches the native fallback sets resolved (record replays included)."""
    return sum(n.stats.batches for n in natives)


# bare and supervised in turns, so that drift over the call falls on both
SUPERVISED_TURNS = ("bare", "supervised", "supervised", "bare")


def supervised_phase(torch, fdb, batches, flat_verdicts, power):
    """Phase 9 (a): the stream through the supervised set, synchronous and
    then deferred (waited one behind), in SUPERVISED_TURNS with the bare
    best-known set, each turn on a fresh set: verdicts equal phase 4's
    batch by batch; every supervised turn healthy, 0 trips, 1 promotion,
    0 s degraded, the native set resolving the first batch only (the
    promotion's parity check) and every batch after it served from the
    card.  Returns {path: launches} (each mode's first supervised turn)."""
    kernels = fdb["kernels"]
    checks = TIMED_BATCHES * TXNS * (READS_PER_TXN + 1)
    out = {}
    for mode in ("sync", "deferred"):
        rates = {"bare": [], "supervised": []}
        for turn, kind in enumerate(SUPERVISED_TURNS, start=1):
            natives: list = []
            cs = (supervised_set(fdb, natives) if kind == "supervised" else
                  fdb["device"].DeviceConflictSet(**SET_ARGS, **BEST_KNOWN, device="cuda"))
            kernels.reset_launches()
            got, walls = drive(torch, fdb, mode, cs, batches, 1)
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            where = f"{kind} {mode} (turn {turn})"
            for i, (a, b) in enumerate(zip(got, flat_verdicts), start=1):
                require(a == b, f"{where}: batch {i} differs from the flat run")
            require(len(got) == len(batches), f"{where}: verdicts missing")
            dev_set = cs
            if kind == "supervised":
                h = cs.health()
                require(h["state"] == "healthy" and h["serving"] == "device"
                        and h["trips"] == 0 and h["promotions"] == 1
                        and h["time_degraded_s"] == 0 and h["consecutive_failures"] == 0,
                        f"{where}: a degrade or a failure on the healthy run: {h}")
                require(served(natives) == 1 and cs._cpu is None,
                        f"{where}: the native set served {served(natives)} batches, "
                        f"not only the first batch's parity check")
                dev_set = cs._dev
                out.setdefault("supervised" if mode == "sync" else f"supervised_{mode}",
                               launches)
            check_path_launches(launches, len(batches), dev_set.stats.compactions, where)
            timed = walls[PREFILL_BATCHES:]
            rates[kind].append(checks / (sum(timed) / 1e3))
            log(f"{where}: {len(batches)} batches identical to the flat run"
                + (f"; health {json.dumps(h)}; the native set served 1 batch (the "
                   f"parity check)" if kind == "supervised" else "")
                + f"; checks/s={rates[kind][-1]:.1f} timed-batch ms "
                f"p50={float(np.percentile(timed, 50)):.3f} "
                f"p99={float(np.percentile(timed, 99)):.3f} on {power}")
            log(f"{where}: launches {json.dumps(launches)}")
            cs.close()
        bare, sup = (float(np.median(rates[k])) for k in ("bare", "supervised"))
        log(f"supervised {mode}: checks/s supervised {[round(r, 1) for r in rates['supervised']]}"
            f" bare {[round(r, 1) for r in rates['bare']]} (turns "
            f"{' '.join(SUPERVISED_TURNS)}); supervised / bare medians = {sup / bare:.3f}")
    return out


DRILL_LOST_AT = 10     # device.lost forced 3 times from this batch on
DRILL_PROMOTE_AT = 16  # force_promote() before this batch


def drill_phase(torch, fdb, batches, flat_verdicts, power):
    """Phase 9 (b): the port's buggify (seeded, only forced sites fire)
    loses the device 3 times from batch DRILL_LOST_AT on: one failed
    dispatch and two failed re-probes trip the breaker once, and the
    native set serves those batches and the ones after; force_promote()
    before batch DRILL_PROMOTE_AT rebuilds the set on the card from the
    committed-write record, the parity batch checks it, and the rest is
    served from the card.  Verdicts equal phase 4's throughout; the end
    state is healthy, 1 trip, 2 promotions.  Returns the path's launches."""
    kernels, buggify = fdb["kernels"], fdb["buggify"]
    natives: list = []
    clock = StepClock(0.5)
    sup = supervised_set(fdb, natives, clock=clock)
    buggify.enable(fdb["DeterministicRandom"](SEED), enable_prob=0.0)
    kernels.reset_launches()
    walls, replayed = {}, None
    try:
        for i, (version, txns) in enumerate(batches, start=1):
            clock.tick()
            if i == DRILL_LOST_AT:
                buggify.force("device.lost", 3)
            if i == DRILL_PROMOTE_AT:
                replayed = sup.health()["recorded_batches"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sup.force_promote()
                torch.cuda.synchronize()
                walls["force_promote"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            got = sup.resolve_batch(version, txns)
            torch.cuda.synchronize()
            walls[i] = (time.perf_counter() - t0) * 1e3
            require(got == flat_verdicts[i - 1], f"drill: batch {i} differs from the flat run")
            floor = gc_floor(i, version)
            if floor is not None:
                sup.remove_before(floor)
            h = sup.health()
            on_cpu = DRILL_LOST_AT <= i < DRILL_PROMOTE_AT
            require(h["serving"] == ("cpu" if on_cpu else "device"),
                    f"drill: batch {i} served from {h['serving']}")
            if i == DRILL_LOST_AT + 2:
                require(h["state"] == "degraded" and h["trips"] == 1,
                        f"drill: the breaker did not trip at batch {i}: {h}")
        census = buggify.census()
    finally:
        buggify.disable()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    h = sup.health()
    require(h["state"] == "healthy" and h["trips"] == 1 and h["promotions"] == 2,
            f"drill: end state {h}")
    require(census["device.lost"]["fires"] == 3, f"drill: the buggify census {census}")
    on_card = (DRILL_LOST_AT - 1) + replayed + (len(batches) - DRILL_PROMOTE_AT + 1)
    require(launches["probe_fused"] == on_card,
            f"drill: K1 launched {launches['probe_fused']} times, not the "
            f"{on_card} batches resolved on the card (replay included)")
    n_cpu = DRILL_PROMOTE_AT - DRILL_LOST_AT
    log(f"drill: device.lost x3 from batch {DRILL_LOST_AT}: degraded at batch "
        f"{DRILL_LOST_AT + 2} (1 trip), the native set served batches "
        f"{DRILL_LOST_AT}-{DRILL_PROMOTE_AT - 1} and the parity batch "
        f"({served(natives)} native batches with its rebuild replays), "
        f"force_promote() replayed {replayed} recorded batches onto the card; "
        f"all {len(batches)} batches identical to the flat run; end health "
        f"{json.dumps(h)}")
    log(f"drill: time to degrade (the call that lost the device: CPU rebuild "
        f"from the record + the native resolve) {walls[DRILL_LOST_AT]:.3f} ms; "
        f"time to re-promote: force_promote() {walls['force_promote']:.3f} ms "
        f"(new set, record replay on the card) + the parity batch "
        f"{walls[DRILL_PROMOTE_AT]:.3f} ms (card and native); degraded batches "
        f"{[round(walls[i], 3) for i in range(DRILL_LOST_AT, DRILL_PROMOTE_AT)]} ms "
        f"({n_cpu} on the native set) on {power}")
    log(f"drill: launches {json.dumps(launches)}")
    sup.close()
    return launches


def watchdog_phase(torch, fdb, batches, flat_verdicts):
    """Phase 9 (c): four batches through a supervised set with the wall
    watchdog on (every device call on its worker thread): two through
    resolve_batch, two through resolve_deferred; and one batch staged by
    BatchStager on its side stream, taken and resolved on a watchdog's
    worker thread.  Verdicts equal phase 4's.  Returns the launches."""
    tdev, kernels, sup_mod = fdb["device"], fdb["kernels"], fdb["supervisor"]
    natives: list = []
    sup = supervised_set(fdb, natives)
    sup.enable_wall_watchdog()
    kernels.reset_launches()
    got, _ = drive(torch, fdb, "sync", sup, batches[:2], 1)
    more, _ = drive(torch, fdb, "deferred", sup, batches[2:4], 3)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    require(got + more == flat_verdicts[:4], "watchdog: verdicts differ from the flat run")
    worker = sup._watchdog._worker
    require(sup._watchdog.wall and worker is not None and worker.is_alive(),
            "watchdog: the wall watchdog's worker never ran")
    h = sup.health()
    require(h["state"] == "healthy" and h["serving"] == "device" and h["trips"] == 0,
            f"watchdog: {h}")
    require(launches["probe_fused"] == 4 and launches["intra_fixpoint"] == 4,
            f"watchdog: {launches}")
    sup.close()

    cs = tdev.DeviceConflictSet(**SET_ARGS, **BEST_KNOWN, device="cuda")
    version, txns = batches[0]
    packed = tdev.pack_batch(txns, 0, cs._offset, SET_ARGS["max_key_bytes"])
    staged = tdev.BatchStager("cuda")(packed)
    wd = sup_mod.Watchdog(60.0, wall=True)
    codes = wd.run(lambda: cs.resolve_arrays(version, *staged.take()))
    wd.close()
    require([fdb["Verdict"](int(c)) for c in codes[:len(txns)]] == flat_verdicts[0],
            "watchdog: a staged batch resolved on the worker thread differs")
    log(f"watchdog: 4 batches (2 sync, 2 deferred) on the wall watchdog's worker "
        f"thread and a BatchStager batch taken there, identical to the flat run; "
        f"health {json.dumps(h)}; launches {json.dumps(launches)}")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the port's headline bench


def bench_phase(fdb, power):
    """The port's bench at its full shape in this process: its JSON line
    (abort-set parity against the port's native set inside), then its
    numbers beside the card.  Returns the path's launches."""
    kernels, bench = fdb["kernels"], fdb["bench"]
    kernels.reset_launches()
    doc = bench.run_headline("cuda")
    launches = kernels.launch_counts()
    # the phase profile block, as bench.run adds it (its launches on no path)
    doc["kernel"]["phase_profile"] = bench.phase_profile_probe("cuda", "small")
    # the bench's probes, as bench.run adds them; the metrics_series
    # probe's cluster launches on its own resolvers' sets, counted alone
    doc["page_cache"] = bench.page_cache_probe()
    doc["commit_wire"] = bench.commit_wire_probe()
    kernels.reset_launches()
    series = doc["metrics_series"] = bench.metrics_series_probe("cuda")
    probe_launches = kernels.launch_counts()
    print(json.dumps(doc), flush=True)
    k = doc["kernel"]
    require(k["parity_batches"] == bench.TIMED_BATCHES
            and k["e2e_parity_batches"] == bench.E2E_BATCHES + 2 and doc["value"] > 0,
            f"bench: {doc}")
    phase, profile = k["phase"], k["phase_profile"]
    require(k["phase_backend"] == CARD and min(phase.values()) >= 0
            and min(phase["sort_ms"], phase["scan_ms"], phase["merge_ms"]) > 0
            and not fdb["status"].check_phase_profile(profile)
            and profile["backend"] == CARD and profile["small"],
            f"bench: phase {phase}, phase_profile {profile}")
    pc, wire = doc["page_cache"], doc["commit_wire"]
    require(series["ResolverMetrics"] and probe_launches["probe_fused"] > 0
            and probe_launches["intra_fixpoint"] > 0
            and series["kernel_launches"] == probe_launches,
            f"bench: metrics_series {len(series['ResolverMetrics'])} samples, its "
            f"resolvers' launches {probe_launches}")
    require(pc["cold_preads_saved"] > 0 and wire["bytes"] > 0
            and wire["frames_per_flush"] > 0 and wire["pickle_fallbacks"] == 0,
            f"bench: page_cache {pc}, commit_wire {wire}")
    n_batches = (bench.PREFILL_BATCHES + bench.TIMED_BATCHES + bench.POST_BATCHES
                 + bench.E2E_BATCHES + 2)
    require(launches["probe_fused"] == n_batches and launches["intra_fixpoint"] == n_batches
            and launches["run_to_step"] >= 1 and launches["compact_ranks"] >= 8
            and launches["probe"] == 0 and launches["intra_query"] == 0,
            f"bench: launches {launches}")
    log(f"bench: native {k['native_checks_per_sec']:.1f} checks/s, card "
        f"{doc['value']:.1f} checks/s, vs_baseline {doc['vs_baseline']}, sync "
        f"p50 {k['resolve_ms_p50']} ms p99 {k['resolve_ms_p99']} ms, resolver e2e "
        f"{k['resolver_e2e_checks_per_sec']:.1f} checks/s; abort-set parity on "
        f"{k['parity_batches']} timed and {k['e2e_parity_batches']} e2e batches; "
        f"on {power}")
    log(f"bench: page_cache cold preads {pc['cache_on']['cold_scan_preads']} (cache on) "
        f"vs {pc['cache_off']['cold_scan_preads']} (off); metrics_series "
        f"{len(series['ResolverMetrics'])} ResolverMetrics samples from 2 resolvers on the "
        f"card (launches {json.dumps(probe_launches)}); commit_wire {wire['bytes']} B, "
        f"encode {wire['encode_ms']} ms, decode {wire['decode_ms']} ms, "
        f"{wire['frames_per_flush']} frames a flush")
    log(f"bench: phase (the post batches) {json.dumps(phase)}; phase_profile (small) "
        f"cumulative_ms {json.dumps(profile['cumulative_ms'])}, lsm "
        f"{json.dumps(profile['lsm'])}, merge shootout "
        f"{json.dumps(profile['merge_shootout_ms'])}")
    log(f"bench: launches {json.dumps(launches)}")
    return launches, probe_launches


# ---------------------------------------------------------------------------
# phase 11: the legacy layouts (incremental=False): a full merge a batch

LEGACY_RUNS = (  # (name, the set's keywords)
    ("flat-scatter", dict(incremental=False, merge_impl="scatter")),
    ("flat-sort", dict(incremental=False, merge_impl="sort")),
    ("flat-gather", dict(incremental=False, merge_impl="gather")),
    ("lsm-scatter", dict(incremental=False, lsm=True)),
)
LEGACY_CPU_BATCHES = 4  # the reduced stream the cpu twins run


def stream_ms(walls) -> str:
    timed = walls[PREFILL_BATCHES:] or walls
    return (f"ms a batch mean={float(np.mean(timed)):.3f} "
            f"p50={float(np.percentile(timed, 50)):.3f} "
            f"p99={float(np.percentile(timed, 99)):.3f} (n={len(timed)})")


def sum_launches(kernels, counts) -> dict:
    """Launch counts summed key by key: every wrapper's, and K2's by plan
    (kernels.launch_counts' "intra_fixpoint.<plan>") where any has one."""
    out = dict.fromkeys(kernels.launches, 0)
    for one in counts:
        for name, n in one.items():
            out[name] = out.get(name, 0) + n
    return out


def require_launches(launches, need: dict, where: str) -> None:
    for name, n in need.items():
        require(launches[name] == n,
                f"{where}: {name} launched {launches[name]} times, not {n}")


def state_without_impl(cs) -> dict:
    """The exported state but the merge_impl name."""
    return {k: v for k, v in cs.export_state().items() if k != "merge_impl"}


def legacy_phase(torch, fdb, batches, flat_verdicts, power):
    """Phase 11: phase 4's stream through the legacy layouts on "cuda":
    the flat full merge once per merge_impl and the LSM recent level
    (scatter).  Verdicts equal phase 4's batch by batch (the layout does
    not change them), the three merges end in identical states, K2 runs
    once a batch and K3 once a recent-level fold; K3 also against its
    plain version on the LSM set's live levels.  Then the reduced stream
    on "cuda" and "cpu" through the flat and LSM layouts: identical state.
    Returns {path: launches}."""
    tdev, kernels = fdb["device"], fdb["kernels"]
    out, states = {}, {}
    for name, kw in LEGACY_RUNS:
        cs = tdev.DeviceConflictSet(**SET_ARGS, **kw, device="cuda")
        kernels.reset_launches()
        got, walls = drive(torch, fdb, "sync", cs, batches, 1)
        torch.cuda.synchronize()
        launches = out[f"legacy_{name}"] = kernels.launch_counts()
        for i, (a, b) in enumerate(zip(got, flat_verdicts), start=1):
            require(a == b, f"legacy {name}: batch {i} differs from phase 4")
        folds = cs.stats.compactions
        require_launches(launches, {"intra_fixpoint": len(batches), "probe_fused": 0,
                                    "run_to_step": 0, "probe": 0, "intra_query": 0},
                         f"legacy {name}")
        if kw.get("lsm"):
            require(folds >= 1 and launches["compact_ranks"] >= folds,
                    f"legacy {name}: {folds} folds, K3 {launches['compact_ranks']}")
            ub = kernels.compact_ranks(cs._ks, cs._rec_ks)
            require(torch.equal(ub, kernels.compact_ranks_plain(cs._ks, cs._rec_ks)),
                    f"legacy {name}: K3 disagrees with its plain version on live levels")
        else:
            require(launches["compact_ranks"] == 0, f"legacy {name}: K3 launched")
            states[name] = state_without_impl(cs)
        log(f"legacy {name}: {len(batches)} batches identical to phase 4; "
            f"{stream_ms(walls)} on {power}; compactions={folds} "
            f"full_merges={cs.stats.full_merges} cap={cs.capacity} "
            f"node_count={cs.node_count} host syncs per batch "
            f"{cs.host_syncs / len(batches):.2f}; launches {json.dumps(launches)}")
    for name in ("flat-sort", "flat-gather"):
        same_export(states["flat-scatter"], states[name], f"legacy {name} against scatter")
    log("legacy: the scatter, sort and gather merges end in identical states")
    t = time.perf_counter()
    reduced = batches[:LEGACY_CPU_BATCHES]
    for name, kw in (LEGACY_RUNS[0], LEGACY_RUNS[3]):
        twins = [tdev.DeviceConflictSet(**SET_ARGS, **kw, device=d) for d in ("cuda", "cpu")]
        runs = [drive(torch, fdb, "sync", s, reduced, 1)[0] for s in twins]
        require(runs[0] == runs[1], f"legacy {name}: cuda and cpu verdicts differ")
        same_state(*twins, f"legacy {name} (reduced)")
    log(f"legacy: {LEGACY_CPU_BATCHES} batches of flat-scatter and lsm-scatter "
        f"identical on cuda and cpu, state included ({time.perf_counter() - t:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# phase 12: phase timing (phase_timing=True) and profile_kernel --phase

PHASE_NAMES = ("sort_s", "scan_s", "append_s", "compact_s")


def timing_phase(torch, fdb, batches, flat_verdicts, power):
    """Phase 12: phase 4's stream through the flat and best-known sets with
    phase_timing=True: verdicts equal phase 4's, the main path's launches
    as phase 4's; each batch's sort / scan / merge (the append) / compact
    ms printed.  Then `python -m foundationdb_tpu_torch.profile_kernel
    --phase` as a subprocess, which must exit 0.  Returns {path:
    launches}."""
    tdev, kernels = fdb["device"], fdb["kernels"]
    out = {}
    for name, kw in (("flat", {}), ("best-known", BEST_KNOWN)):
        cs = tdev.DeviceConflictSet(**SET_ARGS, **kw, phase_timing=True, device="cuda")
        kernels.reset_launches()
        per_batch = []
        for i, ((version, txns), want) in enumerate(zip(batches, flat_verdicts), start=1):
            before = [getattr(cs.stats, k) for k in PHASE_NAMES]
            require(cs.resolve_batch(version, txns) == want,
                    f"timed {name}: batch {i} differs from phase 4")
            per_batch.append([round((getattr(cs.stats, k) - b) * 1e3, 3)
                              for k, b in zip(PHASE_NAMES, before)])
            floor = gc_floor(i, version)
            if floor is not None:
                cs.remove_before(floor)
        torch.cuda.synchronize()
        launches = out[f"timed_{name}"] = kernels.launch_counts()
        check_path_launches(launches, len(batches), cs.stats.compactions, f"timed {name}")
        phase = cs.kernel_stats()["phase"]
        log(f"timed {name}: {len(batches)} batches identical to phase 4; totals "
            f"sort_ms={phase['sort_ms']:.3f} scan_ms={phase['scan_ms']:.3f} "
            f"merge_ms={phase['merge_ms']:.3f} compact_ms={phase['compact_ms']:.3f} "
            f"on {power}")
        log(f"timed {name}: per batch [sort, scan, merge, compact] ms {per_batch}")
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "foundationdb_tpu_torch.profile_kernel",
                           "--phase"], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    for line in proc.stdout.splitlines():
        log("  profile_kernel | " + line)
    require(proc.returncode == 0,
            f"profile_kernel --phase exited {proc.returncode}: {proc.stderr[-2000:]}")
    log(f"timed: profile_kernel --phase exited 0 ({time.perf_counter() - t:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# phase 13: the multi-resolver set (BASELINE.json config 5: 4 resolvers)

SHARDS = 4
# per partition: 4 x 2**17 = the single set's 2**19
SHARD_ARGS = dict(max_key_bytes=16, capacity=1 << 17, run_slots=8,
                  run_capacity=1 << 14)
SHARD_MODES = (  # (mode, the set's keywords)
    ("a", {}),                          # the constructor default
    ("b", BEST_KNOWN),                  # resolve_batch
    ("c", BEST_KNOWN),                  # resolve_arrays(sync=False), 2 in flight
    ("d", dict(incremental=False)),     # the legacy flat merge
)
SHARD_CPU_BATCHES = 4
SHARD_LEGACY_BATCHES = 8
ORACLE_SPLITS = [b"b", b"c", b"d"]  # phase 8's stems start with a-d


def quartile_splits(pool):
    """The pool's keys at its quartiles, in byte order: 4 partitions of
    equal share of the uniform stream."""
    order = np.lexsort(pool.T[::-1])
    n = len(pool)
    return [pool[order[q * n // SHARDS]].tobytes() for q in range(1, SHARDS)]


def drive_in_flight(torch, fdb, cs, batches, snap_at: int):
    """resolve_arrays(sync=False) with two batches in flight (the verdicts
    read two behind, one check_pipelined() at the end) and the stream's
    GC; returns (verdicts, wall ms a batch, the state after batch
    snap_at)."""
    tdev, Verdict = fdb["device"], fdb["Verdict"]
    out, walls, pending, snap = [], [], [], None

    def read(entry):
        verdict, n = entry
        out.append([Verdict(int(c)) for c in verdict[:n].cpu().numpy()])

    torch.cuda.synchronize()
    for i, (version, txns) in enumerate(batches, start=1):
        t0 = time.perf_counter()
        packed = tdev.pack_batch(txns, cs.oldest_version, cs._offset,
                                 SHARD_ARGS["max_key_bytes"], stats=cs.stats)
        pending.append((cs.resolve_arrays(version, *packed[:8], sync=False), len(txns)))
        if len(pending) > 2:
            read(pending.pop(0))
        floor = gc_floor(i, version)
        if floor is not None:
            cs.remove_before(floor)
        walls.append((time.perf_counter() - t0) * 1e3)
        if i == snap_at:
            snap = cs.export_state()
    t0 = time.perf_counter()
    for entry in pending:
        read(entry)
    cs.check_pipelined()
    walls[-1] += (time.perf_counter() - t0) * 1e3
    return out, walls, snap


def drive_sync(torch, fdb, cs, batches, snap_at: int):
    """resolve_batch with the stream's GC; returns (verdicts, wall ms a
    batch, the state after batch snap_at)."""
    out, walls, snap = [], [], None
    for i, (version, txns) in enumerate(batches, start=1):
        o, w = drive(torch, fdb, "sync", cs, [(version, txns)], i)
        out += o
        walls += w
        if i == snap_at:
            snap = cs.export_state()
    return out, walls, snap


class MultiOracle:
    """N partition oracles, each on the ranges clipped to its partition,
    verdicts merged with min: the reference's multi-resolver semantics."""

    def __init__(self, oracle_mod, Verdict, splits):
        self._bounds = [b""] + list(splits) + [None]
        self._parts = [oracle_mod.OracleConflictSet() for _ in self._bounds[1:]]
        self._Verdict = Verdict

    @staticmethod
    def _clip(r, lo, hi):
        b, e = max(r[0], lo), r[1] if hi is None else min(r[1], hi)
        return (b, e) if b < e else None

    def resolve_batch(self, TxInfo, version, txns):
        per = []
        for part, lo, hi in zip(self._parts, self._bounds, self._bounds[1:]):
            clip = lambda rs: [c for r in rs if (c := self._clip(r, lo, hi))]  # noqa: E731
            per.append(part.resolve_batch(version, [
                TxInfo(t.read_snapshot, clip(t.read_ranges), clip(t.write_ranges))
                for t in txns]))
        return [self._Verdict(min(int(v[i]) for v in per)) for i in range(len(txns))]

    def remove_before(self, version):
        for p in self._parts:
            p.remove_before(version)


def sharded_profile(torch, fdb, cs, make, batches, first: int, power):
    """The few batches past the stream on a twin of `cs` (its exported
    state loaded) under torch.profiler: launches a batch and the device's
    busy share of the same batches' wall on `cs` itself."""
    from torch.profiler import ProfilerActivity, profile

    twin = make()
    twin.load_state(cs.export_state())
    plain, walls = drive(torch, fdb, "sync", cs, batches, first)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced, _ = drive(torch, fdb, "sync", twin, batches, first)
        torch.cuda.synchronize()
    require(traced == plain, "sharded: the profiled twin differs")
    events = prof.key_averages()
    busy = busy_ms(torch, events)
    return launch_calls(events) / len(batches), busy / sum(walls)


def sharded_phase(torch, fdb, batches, extra, pool, oracle_stream, single, power):
    """Phase 13: 4 partitions on the one card, split at the key pool's
    quartiles, through (a) the constructor default, (b) the best-known
    layout, (c) (b) through resolve_arrays(sync=False) two in flight, and
    (d) the legacy flat merge on 8 batches.  The modes' verdicts agree
    over all batches; each mode equals the same set on "cpu" over the
    first 4 batches, verdicts and per-partition state; K1 and K2 launch
    once a partition a batch, K4 once a partition a compaction, K3 at
    least as often; (a)'s verdicts equal N partition oracles on phase 8's
    stream.  Checks/s, p50/p99 and (profiled) launches a batch beside
    phase 6's single set (`single`: its sync turn).  Returns {path:
    launches}."""
    Sharded = fdb["sharded"].ShardedDeviceConflictSet
    kernels, TxInfo = fdb["kernels"], fdb["TxInfo"]
    splits = quartile_splits(pool)
    log(f"sharded: split keys {[s.hex() for s in splits]}")
    checks = TIMED_BATCHES * TXNS * (READS_PER_TXN + 1)
    out, verdicts, snaps, sets = {}, {}, {}, {}
    for mode, kw in SHARD_MODES:
        n = SHARD_LEGACY_BATCHES if mode == "d" else len(batches)
        cs = sets[mode] = Sharded(splits, **SHARD_ARGS, **kw)
        kernels.reset_launches()
        drive_mode = drive_in_flight if mode == "c" else drive_sync
        got, walls, snaps[mode] = drive_mode(torch, fdb, cs, batches[:n], SHARD_CPU_BATCHES)
        torch.cuda.synchronize()
        launches = out[f"sharded_{mode}"] = kernels.launch_counts()
        verdicts[mode] = got
        folds = cs.compactions
        if mode == "d":
            require_launches(launches, {"intra_fixpoint": SHARDS * n, "probe_fused": 0,
                                        "run_to_step": 0, "compact_ranks": 0},
                             f"sharded {mode}")
        else:
            require(folds == 2, f"sharded {mode}: {folds} compactions, expected 2")
            require_launches(launches, {"probe_fused": SHARDS * n,
                                        "intra_fixpoint": SHARDS * n,
                                        "run_to_step": SHARDS * folds},
                             f"sharded {mode}")
            require(launches["compact_ranks"] >= SHARDS * 8 * folds,
                    f"sharded {mode}: K3 launched {launches['compact_ranks']} times")
        require(cs.search_fallbacks == 0 and cs.regrows == 0,
                f"sharded {mode}: fallbacks {cs.search_fallbacks}, regrows {cs.regrows}")
        timed = walls[PREFILL_BATCHES:] or walls
        rate = (len(timed) * TXNS * (READS_PER_TXN + 1)) / (sum(timed) / 1e3)
        log(f"sharded {mode}: {n} batches; checks/s={rate:.1f} {stream_ms(walls)} on "
            f"{power}; compactions={folds} counts={cs.export_state()['counts'].tolist()} "
            f"host syncs per batch {cs.host_syncs / n:.2f}; launches "
            f"{json.dumps(launches)} = {launches['probe_fused'] / n:.1f} K1 and "
            f"{launches['intra_fixpoint'] / n:.1f} K2 a batch")
    for mode in ("b", "c", "d"):
        require(verdicts[mode] == verdicts["a"][:len(verdicts[mode])],
                f"sharded {mode}: verdicts differ from mode a")
    single_rate = single["checks_per_s"]
    log(f"sharded: modes a-d agree on every batch; the single best-known set "
        f"(phase 6, sync, turn 1): checks/s={single_rate:.1f} p50={single['p50_ms']:.3f} "
        f"p99={single['p99_ms']:.3f} ms; launches a batch {single.get('launches_per_batch')}")
    for mode, make in (("a", lambda: Sharded(splits, **SHARD_ARGS)),
                       ("b", lambda: Sharded(splits, **SHARD_ARGS, **BEST_KNOWN))):
        per_batch, share = sharded_profile(torch, fdb, sets[mode], make, extra,
                                           len(batches) + 1, power)
        log(f"sharded {mode} profile: {per_batch:.1f} launches a batch, device busy "
            f"{100 * share:.1f}% of wall on {power}")
    # K3 on a partition's live main level against its plain version
    cs = sets["b"]
    ks = cs._ks[0]
    rows, _vals = kernels.run_to_step_plain(cs._runs_b[0][0], cs._runs_e[0][0],
                                            cs._runs_ver[0][:1])
    require(torch.equal(kernels.compact_ranks(ks, rows),
                        kernels.compact_ranks_plain(ks, rows)),
            "sharded: K3 disagrees with its plain version on a live partition")
    t = time.perf_counter()
    reduced = batches[:SHARD_CPU_BATCHES]
    for mode, kw in (("a", {}), ("b", BEST_KNOWN), ("d", dict(incremental=False))):
        cpu = Sharded(splits, **SHARD_ARGS, **kw, devices=["cpu"])
        got, _w, state = drive_sync(torch, fdb, cpu, reduced, SHARD_CPU_BATCHES)
        for m in (mode, "c") if mode == "b" else (mode,):
            require(got == verdicts[m][:SHARD_CPU_BATCHES],
                    f"sharded {m}: cuda and cpu verdicts differ")
            same_export(snaps[m], state, f"sharded {m} (cpu, batch {SHARD_CPU_BATCHES})")
    log(f"sharded: modes a-d equal the cpu set over {SHARD_CPU_BATCHES} batches, "
        f"per-partition state included ({time.perf_counter() - t:.1f} s)")
    oracle = MultiOracle(fdb["oracle"], fdb["Verdict"], ORACLE_SPLITS)
    cs = Sharded(ORACLE_SPLITS, capacity=1 << 8, run_slots=4)
    kernels.reset_launches()
    for i, (version, txns) in enumerate(oracle_stream, start=1):
        require(cs.resolve_batch(version, txns) == oracle.resolve_batch(TxInfo, version, txns),
                f"sharded oracle batch {i}: verdicts differ from the multi-oracle")
        if i % 5 == 0:
            cs.remove_before(version - 3)
            oracle.remove_before(version - 3)
    torch.cuda.synchronize()
    out["sharded_oracle"] = kernels.launch_counts()
    require(cs.regrows >= 1, "sharded oracle stream: main never regrew")
    log(f"sharded: {len(oracle_stream)} batches of phase 8's stream identical to "
        f"{len(ORACLE_SPLITS) + 1} partition oracles merged with min; "
        f"compactions={cs.compactions} regrows={cs.regrows} cap={cs.capacity}")
    return out


# ---------------------------------------------------------------------------
# phase 14: the resolver role (roles/resolver.py) serving the stream

ROLE_TCP_BATCHES = PREFILL_BATCHES + 8  # (b): 8 timed batches, one in flight
ROLE_WALL_S = 300.0                      # (b): the host bound on one call


def role_knobs(knobs_mod):
    """CoreKnobs whose MVCC window is the stream's GC lag: 1 version a
    second over a write lifetime of GC_LAG seconds."""
    k = knobs_mod.CoreKnobs()
    k.set_knob("VERSIONS_PER_SECOND", "1")
    k.set_knob("MAX_WRITE_TRANSACTION_LIFE", str(GC_LAG))
    require(k.mvcc_window_versions == GC_LAG, "the role's MVCC window is not the GC lag")
    return k


def role_requests(types_mod, batches, prev: int = 0):
    """The stream as a proxy sends it: each batch a
    ResolveTransactionBatchRequest chained to the one before
    (prev_version → version), the first to `prev`."""
    out = []
    for version, txns in batches:
        out.append(types_mod.ResolveTransactionBatchRequest(prev, version, txns))
        prev = version
    return out


def role_order_verdicts(cs, batches, window: int):
    """The role's order on a bare set, its referee: resolve_batch, then
    remove_before(version - window) once the version passes the window;
    the verdicts as the role replies them (ints)."""
    out = []
    for version, txns in batches:
        out.append([int(v) for v in cs.resolve_batch(version, txns)])
        if version > window:
            cs.remove_before(version - window)
    return out


class RoleClock:
    """Host-clock times of each batch a Resolver serves: receipt when its
    `_resolve_one` task starts, reply when the reply leaves through the
    network's `send`.  Wraps the two on the instances; nothing else."""

    def __init__(self, role, net) -> None:
        self.t_in: dict = {}
        self.t_out: dict = {}
        self._tokens: dict = {}
        resolve_one, send = role._resolve_one, net.send

        async def timed_resolve(req):
            version = req.payload.version
            self.t_in.setdefault(version, time.perf_counter())
            self._tokens[req._reply_to.token] = version
            await resolve_one(req)

        def timed_send(src, endpoint, payload):
            version = self._tokens.pop(endpoint.token, None)
            if version is not None:
                self.t_out[version] = time.perf_counter()
            send(src, endpoint, payload)

        role._resolve_one, net.send = timed_resolve, timed_send

    def receipt_to_reply_ms(self, versions) -> list:
        return [(self.t_out[v] - self.t_in[v]) * 1e3 for v in versions]

    def service_ms(self, versions) -> list:
        """Each batch's share of the host: from its receipt, or from its
        predecessor's reply if that came later, to its reply."""
        out, prev = [], None
        for v in versions:
            start = self.t_in[v] if prev is None else max(self.t_in[v], self.t_out[prev])
            out.append((self.t_out[v] - start) * 1e3)
            prev = v
        return out


def role_rates(clock, versions) -> dict:
    """checks/s over the timed batches' service times, and their
    receipt→reply p50/p99 (host clock)."""
    timed = versions[PREFILL_BATCHES:]
    service = clock.service_ms(timed)
    lat = clock.receipt_to_reply_ms(timed)
    return dict(checks_per_s=len(timed) * TXNS * (READS_PER_TXN + 1) / (sum(service) / 1e3),
                p50_ms=float(np.percentile(lat, 50)), p99_ms=float(np.percentile(lat, 99)),
                service_p50_ms=float(np.percentile(service, 50)), n=len(timed))


def codec_share(n_batches: int, *wire_stats) -> dict:
    """The wire codec's host time a batch (encode and decode, the replies'
    included) and its bytes a batch, summed over the networks' WireStats."""
    return dict(encode_ms=sum(w.encode_s for w in wire_stats) * 1e3 / n_batches,
                decode_ms=sum(w.decode_s for w in wire_stats) * 1e3 / n_batches,
                bytes_per_batch=sum(w.bytes_encoded for w in wire_stats) / n_batches)


def sim_role_run(fdb, cs, requests, pipeline: bool, start_version: int = 0):
    """A port EventLoop and SimNetwork (seeded), the port's Resolver on one
    process over `cs`, and a client RequestStreamRef on another sending
    every request at once.  Returns (role, net, clock, [(committed,
    virtual reply time)] per request)."""
    core, rpc = fdb["core"], fdb["rpc"]
    loop = core.EventLoop()
    net = rpc["network"].SimNetwork(loop, core.DeterministicRandom(SEED))
    role = fdb["resolver"].Resolver(net.create_process("resolver"), loop,
                                    role_knobs(fdb["knobs"]), cs,
                                    start_version=start_version, pipeline=pipeline)
    clock = RoleClock(role, net)
    ref = rpc["stream"].RequestStreamRef(net, net.create_process("proxy"),
                                         role.stream.endpoint)

    async def one(req):
        reply = await ref.get_reply(req)
        return reply.committed, loop.now()

    async def all_in_flight():
        return await fdb["combinators"].wait_all([loop.spawn(one(r)) for r in requests])

    replies = loop.run_until(loop.spawn(all_in_flight()))
    return role, net, clock, replies


def role_profile(torch, fdb, role_cs, requests, power) -> dict:
    """(a) sync's device-busy share: the batches past the stream through a
    fresh sync role over the run's set (wall: the role's service time),
    and through a twin role over a twin set loaded from its state under
    torch.profiler (device time, launches)."""
    from torch.profiler import ProfilerActivity, profile

    start = requests[0].prev_version
    twin_cs = fdb["device"].DeviceConflictSet(**SET_ARGS, **BEST_KNOWN, device="cuda")
    twin_cs.load_state(role_cs.export_state())
    role, _net, clock, plain = sim_role_run(fdb, role_cs, requests, False, start)
    walls = clock.service_ms([r.version for r in requests])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        twin, _n, _c, traced = sim_role_run(fdb, twin_cs, requests, False, start)
        torch.cuda.synchronize()
    role.stop()
    twin.stop()
    require([c for c, _t in traced] == [c for c, _t in plain],
            "role profile: the profiled twin role's replies differ")
    events = prof.key_averages()
    busy = busy_ms(torch, events)
    out = dict(busy_share=busy / sum(walls),
               launches_per_batch=launch_calls(events) / len(requests),
               syncs_per_batch=sync_calls(events) / len(requests))
    log(f"role profile (a) sync: {len(requests)} batches past the stream, service "
        f"{[round(w, 3) for w in walls]} ms, device busy {busy:.3f} ms = "
        f"{100 * out['busy_share']:.1f}% on {power}; {out['launches_per_batch']:.1f} "
        f"launches and {out['syncs_per_batch']:.2f} synchronize calls a batch")
    return out


def role_sim_phase(torch, fdb, batches, extra, power):
    """Phase 14 (a): the stream through the port's Resolver on a
    SimNetwork, all batches in flight, sync and pipelined, over the
    best-known set on "cuda" and on "cpu".  Every run's replies equal the
    set driven directly in the role's order on "cuda"; the cuda and cpu
    runs of a mode reply at identical virtual times and end in the same
    state; so the two modes agree.  Returns ({path: launches}, {mode:
    metrics}, the verdicts)."""
    tdev, kernels, types = fdb["device"], fdb["kernels"], fdb["types"]
    requests = role_requests(types, batches)
    versions = [r.version for r in requests]
    want = role_order_verdicts(
        tdev.DeviceConflictSet(**SET_ARGS, **BEST_KNOWN, device="cuda"), batches, GC_LAG)
    request_bytes = len(fdb["serialize"].encode_payload(requests[0]))
    out, metrics, sync_cs = {}, {}, None
    for mode, pipeline in (("sync", False), ("pipelined", True)):
        cs = tdev.DeviceConflictSet(**SET_ARGS, **BEST_KNOWN, device="cuda")
        kernels.reset_launches()
        role, net, clock, replies = sim_role_run(fdb, cs, requests, pipeline)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        role.stop()
        where = f"role sim {mode}"
        require([c for c, _t in replies] == want,
                f"{where}: replies differ from the set driven in the role's order")
        check_path_launches(launches, len(batches), cs.stats.compactions, where)
        t = time.perf_counter()
        cpu_cs = tdev.DeviceConflictSet(**SET_ARGS, **BEST_KNOWN, device="cpu")
        cpu_role, _n, _c, cpu_replies = sim_role_run(fdb, cpu_cs, requests, pipeline)
        cpu_role.stop()
        cpu_s = time.perf_counter() - t
        require(cpu_replies == replies,
                f"{where}: the cpu role's replies or virtual reply times differ")
        same_state(cs, cpu_cs, where)
        m = dict(role_rates(clock, versions), **codec_share(len(requests), net.wire),
                 request_bytes=request_bytes)
        metrics[mode] = m
        out[f"role_sim_{mode}"] = launches
        if not pipeline:
            sync_cs = cs
        log(f"{where}: {len(batches)} batches x {TXNS} txns in flight at once, replies "
            f"equal to the set driven in the role's order and to the cpu role's, at the "
            f"same virtual times (last at {replies[-1][1]:.6f} s; cpu run {cpu_s:.1f} s), "
            f"final state equal; checks/s={m['checks_per_s']:.1f} receipt->reply ms "
            f"p50={m['p50_ms']:.3f} p99={m['p99_ms']:.3f} service p50="
            f"{m['service_p50_ms']:.3f} (n={m['n']}, host clock) on {power}")
        log(f"{where}: codec encode_ms={m['encode_ms']:.3f} decode_ms={m['decode_ms']:.3f} "
            f"a batch (WireStats, request and reply); request {request_bytes} bytes; role "
            f"counters {json.dumps(role.counters.snapshot())}; launches {json.dumps(launches)}")
    metrics["sync"].update(role_profile(
        torch, fdb, sync_cs, role_requests(types, extra, versions[-1]), power))
    return out, metrics, want


def role_tcp_phase(torch, fdb, batches, want, power):
    """Phase 14 (b): two RealNetworks in this process on loopback, a
    resolver side and a proxy side, pumped by one WallDriver; the port's
    Resolver on the resolver side hosts the DeviceSupervisor over the
    best-known set on "cuda" (the role arms its wall watchdog, since its
    process is a RealProcess).  ROLE_TCP_BATCHES batches, one in flight at
    a time: replies equal (a)'s, the supervisor ends healthy with 0 trips,
    and every batch is served by the card (the native set resolves only
    the first batch's parity check).  Returns (launches, metrics)."""
    core, rpc, kernels = fdb["core"], fdb["rpc"], fdb["kernels"]
    batches = batches[:ROLE_TCP_BATCHES]
    requests = role_requests(fdb["types"], batches)
    loop = core.EventLoop()
    server = rpc["transport"].RealNetwork(loop, "resolver")
    client = rpc["transport"].RealNetwork(loop, "proxy")
    role, natives = None, []
    try:
        driver = rpc["transport"].WallDriver(loop, [server.pump, client.pump])
        sup = supervised_set(fdb, natives)
        kernels.reset_launches()
        role = fdb["resolver"].Resolver(server.process, loop, role_knobs(fdb["knobs"]), sup)
        require(sup._watchdog.wall, "role tcp: the role did not arm the wall watchdog")
        clock = RoleClock(role, server)
        ref = rpc["stream"].RequestStreamRef(client, client.process, role.stream.endpoint)

        async def one(req):
            return (await ref.get_reply(req)).committed

        got, walls = [], []
        for req in requests:
            t0 = time.perf_counter()
            got.append(driver.run_until(loop.spawn(one(req)), wall_timeout=ROLE_WALL_S))
            walls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        require(got == want[:len(batches)], "role tcp: replies differ from (a)'s")
        h = sup.health()
        require(h["state"] == "healthy" and h["serving"] == "device" and h["trips"] == 0
                and h["consecutive_failures"] == 0,
                f"role tcp: the supervisor degraded or failed: {h}")
        require(served(natives) == 1 and sup._cpu is None,
                f"role tcp: the native set served {served(natives)} batches, not only "
                f"the first batch's parity check")
        check_path_launches(launches, len(batches), sup._dev.stats.compactions,
                            "role tcp", expected_compactions=1)
        n = len(requests)
        m = dict(role_rates(clock, [r.version for r in requests]),
                 **codec_share(n, server.wire, client.wire),
                 call_p50_ms=float(np.percentile(walls[PREFILL_BATCHES:], 50)),
                 frames_per_flush=client.wire.snapshot()["frames_per_flush"])
        log(f"role tcp supervised: {n} batches over loopback TCP one at a time, replies "
            f"equal to (a)'s; health {json.dumps(h)}; the native set served the parity "
            f"check only; checks/s={m['checks_per_s']:.1f} receipt->reply ms "
            f"p50={m['p50_ms']:.3f} p99={m['p99_ms']:.3f} (n={m['n']}), the proxy's call "
            f"p50 {m['call_p50_ms']:.3f} ms (host clock) on {power}")
        log(f"role tcp supervised: codec encode_ms={m['encode_ms']:.3f} "
            f"decode_ms={m['decode_ms']:.3f} a batch (both networks' WireStats), "
            f"{m['bytes_per_batch']:.0f} bytes a batch; launches {json.dumps(launches)}")
        return launches, m
    finally:
        if role is not None:
            role.stop()  # flushes a parked batch, closes the supervised set
        server.close()
        client.close()


def role_phase(torch, fdb, batches, extra, single, power):
    """Phase 14: (a) and (b), then the role's numbers beside phase 6's bare
    best-known set.  Returns {path: launches}."""
    paths, metrics, want = role_sim_phase(torch, fdb, batches, extra, power)
    paths["role_tcp_supervised"], metrics["tcp_supervised"] = role_tcp_phase(
        torch, fdb, batches, want, power)
    log(f"role: checks/s sim sync {metrics['sync']['checks_per_s']:.1f}, sim pipelined "
        f"{metrics['pipelined']['checks_per_s']:.1f}, tcp supervised "
        f"{metrics['tcp_supervised']['checks_per_s']:.1f}; phase 6's bare set (sync, turn "
        f"1) {single['checks_per_s']:.1f} p50={single['p50_ms']:.3f} "
        f"p99={single['p99_ms']:.3f} on {power}")
    log("role summary " + json.dumps(metrics))
    return paths


# ---------------------------------------------------------------------------
# phases 15-17's (c): a run on "cuda" against the same run on "cpu"


def twin_pool():
    """A pool of one process for a (c) run on "cpu", spawned (it inherits
    no CUDA state) so that it runs beside the same run on "cuda": both are
    host-bound, and the card's host has cores to spare."""
    import concurrent.futures
    import multiprocessing

    return concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))


def cpu_twin(run: str, keys: tuple, *args) -> dict:
    """One of phases 15-17's (c) runs (`run`: "cluster", "durable" or
    "backup") on the default backend on "cpu", its backend checked; phase
    18's (a) spec run ("spec") with its supervised sets on "cpu"; or phase
    19's ladder ("saturate") or campaign ("soak") on "cpu"; or phase 20's
    cli sessions ("cli") on "cpu"; in the pool's
    process.  Returns what the cuda run is held to (`keys`) and the host
    walls."""
    import torch

    torch.set_num_threads(1)
    fn = dict(cluster=cluster_run, durable=durable_run, backup=backup_run,
              spec=spec_run, saturate=saturate_run, soak=soak_run, cli=cli_run)[run]
    rec = fn(torch, port_modules(), *args, device="cpu")
    if run in ("cluster", "durable", "backup"):  # the others record no sets
        check_backend_device(rec, "cpu")
    return dict({key: rec[key] for key in keys}, walls=rec["walls"])


# ---------------------------------------------------------------------------
# phase 15: the commit path (cluster.py): ReadWrite through the port's SimCluster

RW_KEYS = 65536          # rw/%06d, filled by the workload's own setup
RW_SPLITS = [b"rw/%06d" % (q * RW_KEYS // 4) for q in (1, 2, 3)]  # the pool's quartiles
# the keys the client puts in conflict ranges: rw/ keys and their key_after
# (9-10 bytes), and each transaction's self-conflict key \xff/SC/ + 16 hex
# digits and its key_after (21-22 bytes)
CLUSTER_KEY_BYTES = 24
CLUSTER_SET = dict(SET_ARGS, **BEST_KNOWN, max_key_bytes=CLUSTER_KEY_BYTES)
CLUSTER_PARTS = (  # (name, clients, virtual seconds, cluster keywords, set capacity)
    ("a", 8192, 0.15, dict(n_resolvers=1, n_storage_shards=1, n_tlogs=1), 1 << 19),
    ("b", 2048, 0.1, dict(n_resolvers=4, n_storage_shards=4, n_tlogs=2,
                          resolver_splits=RW_SPLITS, storage_splits=RW_SPLITS), 1 << 17),
)
CLUSTER_MIN_COMMITS = 4 * 8192   # (a): ~41K at 0.15 virtual s (70598 at 0.28)
CLUSTER_DET_CLIENTS = 512        # (c): the default backend, cuda against cpu
CLUSTER_DET_SECONDS = 0.25
CLUSTER_PROFILE = (3, 4)  # the window: from the 3rd batch of >= clients/8 txns, 4 batches
READBACK_CHUNK = 8192


class RecordedSet:
    """A resolver's conflict set on the cluster path, unchanged: each call
    passes to the inner set, and is logged in order (the batch, its
    transactions, verdicts and host time; each GC floor) for the oracle
    referee, the verdict stream and the batch statistics; the kernel
    launches its batches made are summed beside it."""

    def __init__(self, kernels, inner, index: int, log: list, window=None,
                 on_first=None) -> None:
        self.kernels, self.inner = kernels, inner
        self.index, self.log, self.window = index, log, window
        self.launches = dict.fromkeys(kernels.launches, 0)  # K2 by plan as it comes
        self.batches = 0
        self.on_first, self.retired = on_first, None  # on_first(index): before batch 1

    def facts(self) -> dict:
        """What the checks read of the set: its compactions, the batches
        its bucketed search replayed at full depth, its run slots, its
        class and device (kept when the set is retired)."""
        if self.retired is not None:
            return self.retired
        cs = self.inner
        return dict(compactions=cs.stats.compactions, fallbacks=cs.search_fallbacks,
                    K=cs._K, kind=type(cs).__name__, device=cs.device.type)

    def retire(self) -> None:
        """The set's generation is over: keep its facts, and let the set go
        (a recovery must leave the deposed generation's set to the
        collector; this record must not be what holds it)."""
        if self.retired is None:
            self.retired, self.inner = self.facts(), None

    def resolve_batch(self, version, txns):
        if self.on_first is not None and txns:
            self.on_first(self.index)
            self.on_first = None
        if self.window is not None:
            self.window.before(len(txns))
        before = self.kernels.launch_counts()
        t0 = time.perf_counter()
        out = self.inner.resolve_batch(version, txns)
        ms = (time.perf_counter() - t0) * 1e3
        for name, n in self.kernels.launch_counts().items():
            self.launches[name] = self.launches.get(name, 0) + n - before.get(name, 0)
        if txns:
            self.batches += 1
        self.log.append(("batch", self.index, version, txns, [int(v) for v in out], ms))
        if self.window is not None:
            self.window.after(len(txns))
        return out

    def remove_before(self, version):
        self.inner.remove_before(version)
        self.log.append(("gc", self.index, version))

    def __getattr__(self, name):
        return getattr(self.inner, name)


class ProfileWindow:
    """torch.profiler over a few full batches of a running cluster: starts
    before the `first`-th batch of at least `size` transactions and stops
    after `n` such batches; the device's busy share of that stretch of the
    cluster's host time."""

    def __init__(self, torch, size: int, first: int, n: int) -> None:
        self.torch, self.size, self.first, self.n = torch, size, first, n
        self.seen, self.prof, self.events, self.wall_ms = 0, None, None, None

    def before(self, n_txns: int) -> None:
        if n_txns < self.size:
            return
        self.seen += 1
        if self.seen == self.first:
            from torch.profiler import ProfilerActivity, profile

            self.torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = time.perf_counter()

    def after(self, n_txns: int) -> None:
        if self.prof is None or self.events is not None or n_txns < self.size:
            return
        if self.seen == self.first + self.n - 1:
            self.torch.cuda.synchronize()
            self.wall_ms = (time.perf_counter() - self.t0) * 1e3
            self.prof.stop()
            self.events = self.prof.key_averages()

    def share(self) -> dict:
        require(self.events is not None, "cluster profile: the window never closed")
        busy = busy_ms(self.torch, self.events)
        return dict(busy_ms=busy, wall_ms=self.wall_ms, busy_share=busy / self.wall_ms,
                    launches_per_batch=launch_calls(self.events) / self.n)


def acked_writes(db, acked: list, unknown: list | None = None) -> None:
    """Every transaction this Database creates records, when its commit is
    acknowledged, its commit version and its mutations; and into `unknown`
    the mutations of each commit whose outcome the cluster could not tell
    (CommitUnknownResult: a pipeline process died with it in flight, so
    it may or may not have landed)."""
    create = db.create_transaction

    def create_recorded():
        tr = create()
        commit = tr.commit

        async def recorded_commit():
            try:
                version = await commit()
            finally:
                err = sys.exc_info()[1]
                if (unknown is not None and tr._mutations and
                        type(err).__name__ == "CommitUnknownResult"):
                    unknown.append(list(tr._mutations))
            if tr._mutations:
                acked.append((version, list(tr._mutations)))
            return version

        tr.commit = recorded_commit
        return tr

    db.create_transaction = create_recorded


def expected_values(types_mod, acked: list) -> dict:
    """Each key's value after the acknowledged writes (ReadWrite's only
    mutation is a set): the newest version's write.  Two acknowledged
    writes of one key at one version (one batch) must agree."""
    out, at = {}, {}
    for version, muts in sorted(acked, key=lambda e: e[0]):
        for m in muts:
            require(m.type == types_mod.MutationType.SET_VALUE,
                    f"cluster: an acknowledged {m.type!r}, not a set")
            require(at.get(m.key) != version or out[m.key] == m.value,
                    f"cluster: two writes of {m.key!r} at version {version} disagree")
            out[m.key], at[m.key] = m.value, version
    return out


def timed_readwrite(fdb, c, clients: int, seconds: float, log: list, walls: dict,
                    acked: list, unknown: list | None = None):
    """Phase 15's ReadWrite (2 point reads + 1 point write a transaction,
    uniform over RW_KEYS keys) for cluster `c`.  Every Database the
    cluster hands out records its acknowledged writes (and, given
    `unknown`, its commits of unknown result); the workload's start is
    timed into `walls`, with `first_entry` the log's length when the
    setup's fill is done."""
    cluster_db = c.database

    def database(*args):
        db = cluster_db(*args)
        acked_writes(db, acked, unknown)
        return db

    c.database = database
    w = fdb["readwrite"].ReadWriteWorkload(
        keys=RW_KEYS, clients=clients, duration=seconds, reads_per_tx=READS_PER_TXN,
        writes_per_tx=1)
    start = w.start

    async def timed_start(cluster, rng):
        walls["first_entry"] = len(log)  # the setup's batches come before
        t0 = time.perf_counter()
        await start(cluster, rng)
        walls["start"] = time.perf_counter() - t0

    w.start = timed_start
    return w


def read_back(fdb, c, db) -> dict:
    """Every rw/ key and its value, read through one fresh transaction."""
    keys_mod = fdb["keys"]

    async def scan():
        tr = db.create_transaction()
        out, begin = {}, b"rw/"
        while True:
            rows = await tr.get_range(begin, b"rw0", limit=READBACK_CHUNK)
            out.update(rows)
            if len(rows) < READBACK_CHUNK:
                return out
            begin = keys_mod.key_after(rows[-1][0])

    return c.run_until(c.loop.spawn(scan()))


def storage_dump(ss) -> tuple:
    """A storage server's tag, versions and every key/value live at its
    newest version (the base store merged with the MVCC overlay)."""
    v = ss.version.get()
    live = ss._live_keys(v, b"", b"\xff\xff", 1 << 30)
    return (ss.tag, v, ss.durable_version,
            [(k, ss.overlay.get(k, v, ss.store.get)) for k in live])


def oracle_referee(fdb, log: list, n_resolvers: int) -> int:
    """The log replayed into one port OracleConflictSet a resolver (or a
    set, each from the version its ("new", index, oldest) entry names), in
    the order the resolvers saw it; returns the batches whose verdicts
    differ."""
    oracles = [fdb["oracle"].OracleConflictSet() for _ in range(n_resolvers)]
    bad = 0
    for entry in log:
        if entry[0] == "new":  # a set built at a recovery version
            oracles[entry[1]] = fdb["oracle"].OracleConflictSet(entry[2])
            continue
        if entry[0] == "gc":
            oracles[entry[1]].remove_before(entry[2])
            continue
        _kind, i, version, txns, got, _ms = entry
        want = [int(v) for v in oracles[i].resolve_batch(version, txns)]
        bad += want != got
    return bad


def cluster_run(torch, fdb, part: str, clients: int, seconds: float, make_set=None,
                window=None, device="cuda", **cluster_kw):
    """One seeded ReadWrite run (2 point reads + 1 point write a
    transaction, uniform over RW_KEYS keys) through the port's SimCluster.
    `make_set(index)` builds each resolver's set; without it the cluster's
    default backend on `device` serves.  Returns the run's record."""
    cl, base, kernels = fdb["cluster"], fdb["workloads_base"], fdb["kernels"]
    log, sets = [], []

    def backend():
        sets.append(RecordedSet(kernels, make_set(len(sets)), len(sets), log, window))
        return sets[-1]

    c = cl.SimCluster(seed=SEED, conflict_backend=backend if make_set else None,
                      device=device, **cluster_kw)
    if make_set is None:
        for r in c.resolvers:
            sets.append(RecordedSet(kernels, r.cs, len(sets), log))
            r.cs = sets[-1]
    acked, walls = [], {}
    w = timed_readwrite(fdb, c, clients, seconds, log, walls, acked)
    if device == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    metrics = base.run_workloads(c, [w], deadline=1e6)["ReadWrite"]
    walls["run"] = time.perf_counter() - t0
    if device == "cuda":
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    end = c.loop.now()
    dump = [storage_dump(ss) for ss in c.storage]
    t0 = time.perf_counter()
    got = read_back(fdb, c, c.database())
    walls["read_back"] = time.perf_counter() - t0
    counters = [r.counters.snapshot() for r in c.resolvers]
    c.stop()
    want = expected_values(fdb["types"], acked)
    require(len(want) == RW_KEYS and got == want,
            f"cluster {part}: {sum(got.get(k) != v for k, v in want.items())} of "
            f"{len(want)} acknowledged keys read back wrong ({len(got)} read)")
    t0 = time.perf_counter()
    mismatches = oracle_referee(fdb, log, len(sets))
    walls["referee"] = time.perf_counter() - t0
    require(mismatches == 0,
            f"cluster {part}: {mismatches} resolver batches differ from the oracle")
    batches = [e for e in log if e[0] == "batch"]
    return dict(metrics=metrics, end=end, dump=dump, sets=sets, launches=launches,
                walls=walls, acked=len(acked), counters=counters,
                verdicts=[(i, v, got) for _k, i, v, _t, got, _ms in batches],
                batch_ms=[(len(t), ms) for _k, _i, _v, t, _g, ms in batches],
                workload_batch_ms=[(len(e[3]), e[5]) for e in log[walls["first_entry"]:]
                                   if e[0] == "batch"])


def check_cluster_launches(rec: dict, where: str, idle_ok: bool = False) -> None:
    """K1 and K2 once a resolve pass on every resolver: once a non-empty
    batch, and once more for each batch whose bucketed search is replayed
    at full depth (`search_fallbacks`: a 16-bit key prefix shared by more
    boundaries than the fast search reaches, as the rw/ keys are); K4 once
    a compaction, K3 at least once a run it folds, the referees never.
    Every set must have served a batch, or with `idle_ok` one of them (a
    supervisor builds sets that a fault retires before any batch)."""
    total = dict.fromkeys(rec["launches"], 0)
    for i, cs in enumerate(rec["sets"]):
        facts = cs.facts()
        comp = facts["compactions"]
        passes = cs.batches + facts["fallbacks"]
        need = {"probe_fused": passes, "intra_fixpoint": passes,
                "run_to_step": comp, "intra_query": 0, "probe": 0}
        for name, n in need.items():
            require(cs.launches[name] == n, f"{where} resolver {i}: {name} launched "
                    f"{cs.launches[name]} times in {cs.batches} batches "
                    f"({facts['fallbacks']} replayed), not {n}")
        require(cs.launches["compact_ranks"] >= facts["K"] * comp,
                f"{where} resolver {i}: compact_ranks launched {cs.launches['compact_ranks']}")
        require(idle_ok or cs.batches > 0, f"{where} resolver {i}: no batch reached the card")
        for name, n in cs.launches.items():
            total[name] = total.get(name, 0) + n
    require(any(cs.batches for cs in rec["sets"]), f"{where}: no batch reached the card")
    require(total == rec["launches"], f"{where}: launches outside the resolvers' batches")


def check_backend_device(rec: dict, dev: str) -> None:
    """The cluster's default backend is the port's DeviceConflictSet on
    the device the caller asked for."""
    for cs in rec["sets"]:
        facts = cs.facts()
        require(facts["kind"] == "DeviceConflictSet" and facts["device"] == dev,
                f"a resolver's default backend is {facts['kind']} on {facts['device']}, "
                f"not DeviceConflictSet on {dev}")


def cluster_summary(rec: dict, power: str) -> dict:
    """(a)'s and (b)'s printed numbers: the workload's, and the card's
    batches (the non-empty ones: an empty batch launches nothing), all of
    them and the workload's own (after its setup's fill)."""
    sizes = [n for n, _ms in rec["batch_ms"] if n]
    ms = [t for n, t in rec["batch_ms"] if n]
    work = [n for n, _ms in rec["workload_batch_ms"] if n]
    work_ms = [t for n, t in rec["workload_batch_ms"] if n]
    m = rec["metrics"]
    return dict(
        committed=m["committed"], retries=m["retries"], acked=rec["acked"],
        wall_s=rec["walls"]["run"], start_wall_s=rec["walls"]["start"],
        tx_per_s_host=m["committed"] / rec["walls"]["start"],
        batches=len(sizes), batch_min=min(sizes), batch_median=float(np.median(sizes)),
        batch_max=max(sizes), service_p50_ms=float(np.percentile(ms, 50)),
        service_p99_ms=float(np.percentile(ms, 99)),
        workload_batches=len(work), workload_batch_min=min(work),
        workload_batch_median=float(np.median(work)), workload_batch_max=max(work),
        workload_service_p50_ms=float(np.percentile(work_ms, 50)),
        workload_service_p99_ms=float(np.percentile(work_ms, 99)),
        compactions=sum(cs.facts()["compactions"] for cs in rec["sets"]),
        search_fallbacks=sum(cs.facts()["fallbacks"] for cs in rec["sets"]),
        readwrite=m, read_back_s=rec["walls"]["read_back"],
        referee_s=rec["walls"]["referee"], end_virtual_s=rec["end"], power=power)


def cluster_phase(torch, fdb, power):
    """Phase 15: (a) BASELINE config 1 and (b) config 5 through the port's
    SimCluster on the card, then (c) the default backend on "cuda" against
    "cpu".  Returns {path: launches}."""
    tdev = fdb["device"]
    paths, summary = {}, {}
    for part, clients, seconds, kw, cap in CLUSTER_PARTS:
        window = ProfileWindow(torch, clients // 8, *CLUSTER_PROFILE) if part == "a" else None
        rec = cluster_run(
            torch, fdb, part, clients, seconds, window=window,
            make_set=lambda _i, cap=cap: tdev.DeviceConflictSet(
                **dict(CLUSTER_SET, capacity=cap), device="cuda"), **kw)
        where = f"cluster {part}"
        check_cluster_launches(rec, where)
        out = cluster_summary(rec, power)
        if window is not None:
            out.update(window.share())
            require(out["committed"] >= CLUSTER_MIN_COMMITS,
                    f"{where}: {out['committed']} transactions committed, fewer than "
                    f"{CLUSTER_MIN_COMMITS}")
        summary[part] = out
        paths[f"cluster_{part}"] = rec["launches"]
        log(f"{where}: {clients} clients, {len(rec['sets'])} resolver(s) on the card, "
            f"{out['committed']} committed + {out['retries']} retries in "
            f"{out['wall_s']:.1f} s host wall ({out['start_wall_s']:.1f} s of workload: "
            f"{out['tx_per_s_host']:.1f} txn/s host clock); {out['batches']} resolver "
            f"batches of {out['batch_min']}/{out['batch_median']:.0f}/{out['batch_max']} "
            f"txns (min/median/max), service p50={out['service_p50_ms']:.3f} "
            f"p99={out['service_p99_ms']:.3f} ms (resolve_batch, host clock); of them "
            f"the workload's {out['workload_batches']} batches of "
            f"{out['workload_batch_min']}/{out['workload_batch_median']:.0f}/"
            f"{out['workload_batch_max']} txns, service p50="
            f"{out['workload_service_p50_ms']:.3f} p99="
            f"{out['workload_service_p99_ms']:.3f} ms; "
            f"{out['compactions']} compactions, {out['search_fallbacks']} batches replayed "
            f"at full search depth; 0 verdict mismatches against the oracle "
            f"({out['referee_s']:.1f} s), all {RW_KEYS} keys read back as the "
            f"{out['acked']} acknowledged commits wrote them; on {power}")
        log(f"{where}: ReadWrite (virtual time) {json.dumps(out['readwrite'])}; "
            f"launches {json.dumps(rec['launches'])}; resolver counters "
            f"{json.dumps(rec['counters'])}")
        if window is not None:
            log(f"{where}: profiled window of {CLUSTER_PROFILE[1]} full batches: device "
                f"busy {out['busy_ms']:.3f} ms of {out['wall_ms']:.3f} ms host = "
                f"{100 * out['busy_share']:.2f}%, {out['launches_per_batch']:.1f} "
                f"launches a batch, on {power}")
    keys = ("metrics", "end", "dump", "verdicts")
    with twin_pool() as pool:  # the cpu run beside the cuda run, in a process of its own
        pending = pool.submit(cpu_twin, "cluster", keys, "c cpu", CLUSTER_DET_CLIENTS,
                              CLUSTER_DET_SECONDS)
        gpu = cluster_run(torch, fdb, "c cuda", CLUSTER_DET_CLIENTS, CLUSTER_DET_SECONDS,
                          device="cuda")
        check_backend_device(gpu, "cuda")
        cpu = pending.result()
    check_cluster_launches(gpu, "cluster c cuda")
    for key in keys:
        require(gpu[key] == cpu[key], f"cluster c: the cuda and cpu runs' {key} differ")
    paths["cluster_c_cuda"] = gpu["launches"]
    summary["c"] = dict(committed=gpu["metrics"]["committed"], end_virtual_s=gpu["end"],
                        batches=len(gpu["verdicts"]), cuda_wall_s=gpu["walls"]["run"],
                        cpu_wall_s=cpu["walls"]["run"])
    log(f"cluster c: {CLUSTER_DET_CLIENTS} clients on the default backend "
        f"(DeviceConflictSet(device=...)), cuda and cpu: identical ReadWrite metrics, end "
        f"virtual time {gpu['end']:.6f} s, storage dump ({len(gpu['dump'][0][3])} keys) and "
        f"verdict stream ({len(gpu['verdicts'])} batches); wall {gpu['walls']['run']:.1f} s "
        f"cuda, {cpu['walls']['run']:.1f} s cpu")
    log("cluster summary " + json.dumps(summary))
    return paths


# ---------------------------------------------------------------------------
# phase 16: the durable, recoverable cluster (control/recoverable.py)

# FoundationDB's `configure new double ssd`: every shard on a team of two
# storage servers, each on the B-tree engine; 3 coordinators, 2 TLogs on disk
# queues, 2 commit proxies, 1 resolver
DURABLE = dict(redundancy="double", storage_engine="ssd", n_coordinators=3, n_tlogs=2,
               n_proxies=2, n_resolvers=1, n_storage_shards=1)
# (clients, virtual seconds of ReadWrite, (kills, first kill, interval)).  A
# kill stalls every client: each has a commit in flight by the time the
# recovery ends, and waits out the client's COMMIT_TIMEOUT (5 virtual s)
# before it retries on the new generation.  So the kills are 5.25 s apart
# and the run lasts 5.2 s past the last one: every generation serves
# traffic, ~0.1-0.4 virtual s of it each
DURABLE_RUN = (2048, 10.45, (2, 0.05, 5.25))
DURABLE_DET = (512, 5.3, (1, 0.05, 5.0))  # (c): the reduced twin, cuda against cpu
DURABLE_PROFILE = (2, 4)  # the window: from the 2nd batch of >= clients/8 txns, 4 batches
DURABLE_PROBE = b"durable/restarted"     # one commit after the restart's read-back
STATUS_KEY = b"\xff\xff/status/json"


def fs_files(fs) -> dict:
    """Every file of a SimFilesystem: its contents as a reader sees them
    and its crash-surviving (synced) prefix."""
    out = {}
    for path in fs.list():
        f = fs.open(path, None)
        out[path] = (f.read_all(), f.read_durable())
    return out


def recovery_spans(states: list) -> list:
    """(start, end) virtual times of each recovery the controller ran:
    from its reading_cstate to its fully_recovered."""
    spans, start = [], None
    for t, state in states:
        if state == "reading_cstate":
            start = t
        elif state == "fully_recovered" and start is not None:
            spans.append((start, t))
            start = None
    return spans


def generation_stats(log: list, sets: list) -> list:
    """Each set (a generation's resolver set): the version it was built
    at, its batches, transactions and resolve_batch p50/p99 (host clock)."""
    oldest = {e[1]: e[2] for e in log if e[0] == "new"}
    out = []
    for cs in sets:
        ms = [e[5] for e in log if e[0] == "batch" and e[1] == cs.index and e[3]]
        out.append(dict(index=cs.index, oldest=oldest[cs.index], batches=cs.batches,
                        txns=sum(len(e[3]) for e in log if e[0] == "batch" and e[1] == cs.index),
                        p50_ms=float(np.percentile(ms, 50)) if ms else None,
                        p99_ms=float(np.percentile(ms, 99)) if ms else None,
                        launches=dict(cs.launches)))
    return out


def check_read_back(got: dict, want: dict, unknown: list, where: str) -> None:
    """Every key an acknowledged commit wrote holds its newest acknowledged
    value, or the value of a commit whose outcome the cluster could not
    tell (it may have landed after it); no other key is there."""
    maybe: dict = {}
    for muts in unknown:
        for m in muts:
            maybe.setdefault(m.key, set()).add(m.value)
    wrong = [k for k, v in want.items() if got.get(k) != v and got.get(k) not in maybe.get(k, ())]
    require(len(want) == RW_KEYS and set(got) == set(want) and not wrong,
            f"{where}: {len(wrong)} of {len(want)} acknowledged keys read back wrong "
            f"({len(got)} read)")


def durable_run(torch, fdb, part: str, clients: int, seconds: float, kills: tuple,
                device="cuda", make_set=None, window=None, restart=False):
    """One seeded ReadWrite run (phase 15's traffic over RW_KEYS keys) with
    an AttritionWorkload killing pipeline processes, through the port's
    RecoverableCluster in the DURABLE deployment.  `make_set(oldest)`
    builds each generation's resolver set (conflict_backend=); without it
    the cluster's default backend on `device` serves.  Each set is recorded
    as it is built, with the version it starts at, and retired when the
    next generation's is built.  With `restart`, the cluster is then powered
    off and restarted from its SimFilesystem (a new set on the card), every
    key is read back through the client, one more transaction commits, and
    the status document is read through its special key; otherwise the keys
    are read back from the running cluster.  Returns the run's record."""
    rc, att_mod, base, kernels = (fdb["recoverable"], fdb["attrition"],
                                  fdb["workloads_base"], fdb["kernels"])
    log, sets, memory = [], [], []

    def on_first(index: int) -> None:
        if index and device == "cuda":  # a recovered generation's first batch
            gc.collect()
            torch.cuda.synchronize()
            memory.append((index, card_bytes(torch)))

    def build(inner, oldest: int):
        for old in sets:
            old.retire()
        rec = RecordedSet(kernels, inner, len(sets), log, window, on_first)
        log.append(("new", rec.index, oldest))
        sets.append(rec)
        return rec

    real_set = rc.DeviceConflictSet
    if make_set is not None:
        cluster_kw = dict(conflict_backend=lambda oldest=0: build(make_set(oldest), oldest))
    else:  # the default backend, each set it builds recorded
        cluster_kw = dict(device=device)
        rc.DeviceConflictSet = lambda oldest=0, **kw: build(real_set(oldest, **kw), oldest)
    try:
        c = rc.RecoverableCluster(seed=SEED, **DURABLE, **cluster_kw)
        states, kills_at = [], []
        set_state, trace = c.controller._set_state, c.trace.trace

        def traced_state(state):
            states.append((c.loop.now(), state))
            set_state(state)

        def traced(event_type, *a, **kw):
            if event_type == "AttritionKill":
                kills_at.append((c.loop.now(), kw.get("Process")))
            return trace(event_type, *a, **kw)

        c.controller._set_state, c.trace.trace = traced_state, traced
        acked, unknown, walls = [], [], {}
        w = timed_readwrite(fdb, c, clients, seconds, log, walls, acked, unknown)
        n_kills, first_kill, interval = kills
        attrition = att_mod.AttritionWorkload(kills=n_kills, start_delay=first_kill,
                                              interval=interval)
        if device == "cuda":
            torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        metrics = base.run_workloads(c, [w, attrition], deadline=1e6)["ReadWrite"]
        walls["run"] = time.perf_counter() - t0
        if device == "cuda":
            torch.cuda.synchronize()
        launches = kernels.launch_counts()
        rec = dict(metrics=metrics, end=c.loop.now(), recoveries=c.controller.recoveries,
                   epoch=c.controller.epoch, dump=[storage_dump(ss) for ss in c.storage],
                   files=fs_files(c.fs), states=states, kills=kills_at, memory=memory,
                   launches=launches, walls=walls, acked=len(acked), unknown=len(unknown))
        n_run_sets = len(sets)
        t0 = time.perf_counter()
        if restart:
            fs = c.power_off()
            rec["disk"] = {p: len(durable) for p, (_all, durable) in fs_files(fs).items()}
            c = None  # the powered-off cluster and its set go
            for old in sets:
                old.retire()
            if device == "cuda":
                torch.cuda.synchronize()
            kernels.reset_launches()
            c = rc.RecoverableCluster(seed=SEED + 1, fs=fs, restart=True, **DURABLE,
                                      **cluster_kw)
            got = read_back(fdb, c, c.database())
            db = c.database()

            async def probe_and_status():
                tr = db.create_transaction()
                tr.set(DURABLE_PROBE, b"1")
                await tr.commit()
                return await db.create_transaction().get(STATUS_KEY)

            status = json.loads(c.run_until(c.loop.spawn(probe_and_status())))
            if device == "cuda":
                torch.cuda.synchronize()
            rec.update(restart_launches=kernels.launch_counts(), status=status,
                       restart_epoch=c.controller.epoch, restart_end=c.loop.now())
        else:
            got = read_back(fdb, c, c.database())
        walls["read_back"] = time.perf_counter() - t0
        c.stop()
    finally:
        rc.DeviceConflictSet = real_set
    for cs in sets:
        cs.retire()
    check_read_back(got, expected_values(fdb["types"], acked), unknown, f"durable {part}")
    t0 = time.perf_counter()
    mismatches = oracle_referee(fdb, log, len(sets))
    walls["referee"] = time.perf_counter() - t0
    require(mismatches == 0,
            f"durable {part}: {mismatches} resolver batches differ from the oracle")
    batches = [e for e in log if e[0] == "batch"]
    rec.update(sets=sets[:n_run_sets], restart_sets=sets[n_run_sets:],
               generations=generation_stats(log, sets),
               verdicts=[(i, v, got_) for _k, i, v, _t, got_, _ms in batches],
               news=[e for e in log if e[0] == "new"],
               batch_ms=[(len(t), ms) for _k, i, _v, t, _g, ms in batches if i < n_run_sets],
               workload_batch_ms=[(len(e[3]), e[5]) for e in log[walls["first_entry"]:]
                                  if e[0] == "batch" and e[1] < n_run_sets])
    return rec


def durable_phase(torch, fdb, power):
    """Phase 16: (a) the DURABLE deployment under ReadWrite with two
    pipeline kills, every generation's set on the card, then a power-off
    and a restart from the files; (c) the reduced twin on the default
    backend, "cuda" against "cpu".  Returns {path: launches}."""
    tdev = fdb["device"]
    clients, seconds, kills = DURABLE_RUN
    window = ProfileWindow(torch, clients // 8, *DURABLE_PROFILE)
    rec = durable_run(torch, fdb, "a", clients, seconds, kills, window=window, restart=True,
                      make_set=lambda oldest: tdev.DeviceConflictSet(
                          oldest, **CLUSTER_SET, device="cuda"))
    require(rec["recoveries"] >= kills[0] and len(rec["kills"]) == kills[0],
            f"durable a: {rec['recoveries']} recoveries after {len(rec['kills'])} kills")
    news = rec["news"]
    require(len(rec["sets"]) >= kills[0] + 1 and all(o > 0 for _n, _i, o in news[1:]),
            f"durable a: sets built at {[o for _n, _i, o in news]}, not a new set at each "
            f"recovery version")
    check_cluster_launches(rec, "durable a")
    check_cluster_launches(dict(sets=rec["restart_sets"], launches=rec["restart_launches"]),
                           "durable restart")
    mem = rec["memory"]
    require(len(mem) >= 2 and mem[1][1] <= mem[0][1],
            f"durable a: card memory after the recoveries {mem}: it grew from the first "
            f"recovery to the second")
    status = rec["status"]
    fdb["status"].validate_status(status)
    require(status["kernel"]["backend"] == "cuda",
            f"durable restart: status kernel.backend is {status['kernel']['backend']!r}")
    out = cluster_summary(rec, power)
    out.update(window.share())
    spans = recovery_spans(rec["states"])
    out.update(recoveries=rec["recoveries"], kills=rec["kills"],
               recovery_s=[round(b - a, 6) for a, b in spans],
               kill_to_recovered_s=[round(spans[i][1] - t, 6) for i, (t, _p) in
                                    enumerate(rec["kills"]) if i < len(spans)],
               card_requested_bytes=mem, generations=rec["generations"],
               disk_bytes=sum(rec["disk"].values()), disk_files=len(rec["disk"]),
               unknown_results=rec["unknown"], restart_epoch=rec["restart_epoch"])
    paths = {"durable_a": rec["launches"], "durable_restart": rec["restart_launches"]}
    log(f"durable a: {DURABLE} ({clients} clients, {seconds} virtual s, "
        f"AttritionWorkload(kills={kills[0]})): {out['committed']} committed + "
        f"{out['retries']} retries in {out['wall_s']:.1f} s host wall "
        f"({out['start_wall_s']:.1f} s of workload: {out['tx_per_s_host']:.1f} txn/s host "
        f"clock); {len(rec['sets'])} generations' sets on the card, {out['batches']} "
        f"resolver batches, {out['compactions']} compactions; recoveries "
        f"{rec['recoveries']} (kills {rec['kills']}; each took {out['recovery_s']} virtual "
        f"s, {out['kill_to_recovered_s']} from its kill); the card's requested bytes after each "
        f"recovery {mem}; 0 verdict mismatches against the oracle ({out['referee_s']:.1f} s); "
        f"{out['disk_bytes']} bytes on {out['disk_files']} simulated disks after the "
        f"power-off; restart (epoch {rec['restart_epoch']}): all {RW_KEYS} keys read back "
        f"as the {out['acked']} acknowledged commits wrote them ({rec['unknown']} commits "
        f"of unknown result), status validates with kernel.backend 'cuda'; on {power}")
    for g in rec["generations"]:
        log(f"durable a: set {g['index']} (built at version {g['oldest']}): "
            f"{g['batches']} batches, {g['txns']} txns, resolve_batch p50={g['p50_ms']} "
            f"p99={g['p99_ms']} ms, launches {json.dumps(g['launches'])}")
    log(f"durable a: ReadWrite (virtual time) {json.dumps(out['readwrite'])}; profiled "
        f"window of {DURABLE_PROFILE[1]} full batches: device busy {out['busy_ms']:.3f} ms "
        f"of {out['wall_ms']:.3f} ms host = {100 * out['busy_share']:.2f}%, "
        f"{out['launches_per_batch']:.1f} launches a batch, on {power}")
    clients, seconds, kills = DURABLE_DET
    keys = ("metrics", "end", "recoveries", "epoch", "dump", "verdicts", "news", "files")
    with twin_pool() as pool:  # the cpu run beside the cuda run, in a process of its own
        pending = pool.submit(cpu_twin, "durable", keys, "c cpu", clients, seconds, kills)
        gpu = durable_run(torch, fdb, "c cuda", clients, seconds, kills, device="cuda")
        check_backend_device(gpu, "cuda")
        cpu = pending.result()
    check_cluster_launches(gpu, "durable c cuda")
    for key in keys:
        require(gpu[key] == cpu[key], f"durable c: the cuda and cpu runs' {key} differ")
    paths["durable_c_cuda"] = gpu["launches"]
    summary = dict(a=out, c=dict(
        committed=gpu["metrics"]["committed"], end_virtual_s=gpu["end"],
        recoveries=gpu["recoveries"], batches=len(gpu["verdicts"]), files=len(gpu["files"]),
        cuda_wall_s=gpu["walls"]["run"], cpu_wall_s=cpu["walls"]["run"]))
    log(f"durable c: {clients} clients, 1 kill, the default backend "
        f"(DeviceConflictSet(oldest, device=...)), cuda and cpu: identical ReadWrite "
        f"metrics, end virtual time {gpu['end']:.6f} s, {gpu['recoveries']} recoveries, "
        f"storage, verdict stream ({len(gpu['verdicts'])} batches) and all "
        f"{len(gpu['files'])} files byte for byte; wall {gpu['walls']['run']:.1f} s cuda, "
        f"{cpu['walls']['run']:.1f} s cpu")
    log("durable summary " + json.dumps(summary, default=str))
    return paths


# ---------------------------------------------------------------------------
# phase 17: backup, restore and DR (client/backup.py, client/dr.py) in the
# DURABLE deployment

# (clients, virtual seconds of ReadWrite, (kills, first kill, interval)): one
# pipeline kill on the source (the primary) 0.05 virtual s into the traffic,
# after the snapshot (DR's initial copy), while the log (the stream) runs;
# each client then waits out its 5 s COMMIT_TIMEOUT, so the run ends 0.25 s
# past that
BACKUP_RUN = (1024, 5.3, (1, 0.05, 5.0))  # (a) and (b)
BACKUP_DET = (512, 5.3, (1, 0.05, 5.0))   # (c): the reduced twin, cuda against cpu
BACKUP_CHUNK_ROWS = 500  # the snapshot's and DR's initial copy's rows a transaction
BACKUP_URL = "blob://bk"
BACKUP_PROBE = b"backup/restarted"  # one commit on the restarted source
DR_PROBE = b"dr/promoted"           # one commit on the secondary after failover
USER_END = b"\xff"                  # a backup covers the user keyspace [b"", \xff)


class SetLog:
    """Every conflict set the clusters of one path build, recorded into one
    log (RecordedSet, each under its own index), tagged with the cluster it
    serves; a cluster's older sets are retired when it builds a new one, so
    each cluster's referee and launch checks read its own sets."""

    def __init__(self, kernels, retire_on_add: bool = True) -> None:
        self.kernels, self.log, self.sets = kernels, [], []
        # False where a cluster may use an older set after it builds a new
        # one (a supervisor's sets): every set stays live until check()
        self.retire_on_add = retire_on_add

    def add(self, cluster: str, inner, oldest: int):
        for old in self.of(cluster) if self.retire_on_add else ():
            old.retire()
        rec = RecordedSet(self.kernels, inner, len(self.sets), self.log)
        rec.cluster = cluster
        self.log.append(("new", rec.index, oldest))
        self.sets.append(rec)
        return rec

    def of(self, cluster: str) -> list:
        return [s for s in self.sets if s.cluster == cluster]

    def launches(self, cluster: str) -> dict:
        return sum_launches(self.kernels, (s.launches for s in self.of(cluster)))

    def batch_stats(self, cluster: str) -> dict:
        """The cluster's non-empty resolver batches: how many, their sizes
        (min/median/max txns) and resolve_batch p50/p99 (host clock)."""
        mine = {s.index for s in self.of(cluster)}
        rows = [(len(e[3]), e[5]) for e in self.log
                if e[0] == "batch" and e[1] in mine and e[3]]
        sizes, ms = [n for n, _t in rows], [t for _n, t in rows]
        return dict(batches=len(rows), txns=sum(sizes), size_min=min(sizes),
                    size_median=float(np.median(sizes)), size_max=max(sizes),
                    p50_ms=float(np.percentile(ms, 50)), p99_ms=float(np.percentile(ms, 99)),
                    sets=len(mine), compactions=sum(s.facts()["compactions"]
                                                    for s in self.of(cluster)))

    def check(self, fdb, paths: dict, where: str, on_card: bool = True,
              idle_ok: bool = False) -> dict:
        """The oracle referee over every set of every cluster, each from the
        version it was built at; then, for sets on the card, for each
        cluster K1/K2 once a resolve pass and K4 once a compaction in every
        set, with the launches of `paths` ({cluster: the kernels' counts
        over its window}) equal to its sets' own.  Returns {cluster: its
        sets' launches}."""
        for s in self.sets:
            s.retire()
        mismatches = oracle_referee(fdb, self.log, len(self.sets))
        require(mismatches == 0,
                f"{where}: {mismatches} resolver batches differ from the oracle")
        out = {}
        for cluster, launches in paths.items():
            if on_card:
                check_cluster_launches(dict(sets=self.of(cluster), launches=launches),
                                       f"{where} {cluster}", idle_ok)
            out[cluster] = self.launches(cluster)
        return out


def read_user(fdb, c, db) -> dict:
    """The whole user keyspace [b"", \\xff), read through one transaction."""
    keys_mod = fdb["keys"]

    async def scan():
        tr = db.create_transaction()
        out, begin = {}, b""
        while True:
            rows = await tr.get_range(begin, USER_END, limit=READBACK_CHUNK)
            out.update(rows)
            if len(rows) < READBACK_CHUNK:
                return out
            begin = keys_mod.key_after(rows[-1][0])

    return c.run_until(c.loop.spawn(scan()))


def rw_writes(acked: list) -> list:
    """The acknowledged commits' writes of rw/ keys (ReadWrite's and its
    setup's; the agents' own system-key writes left out)."""
    return [(v, [m for m in muts if m.key.startswith(b"rw/")]) for v, muts in acked]


def blob_container(fdb, c):
    """A blob:// container over a SimBlobTransport on the cluster's
    SimFilesystem, as BlobBackupWorkload._container builds it (its object
    names drawn from a split of the cluster's rng)."""
    bs, task_priority = fdb["blobstore"], fdb["core"].TaskPriority
    rng = c.rng.split()
    store = bs.BlobObjectStore(bs.SimFSBacking(c.fs))
    uid_rng = rng.split()
    client = bs.BlobStoreClient(
        bs.SimBlobTransport(store, c.loop, rng.split()), knobs=c.knobs, trace=c.trace,
        sleep=lambda s: c.loop.delay(s, task_priority.DEFAULT_DELAY),
        nonce=f"c{uid_rng.random_unique_id()[:6]}")
    return fdb["backup"].backup_container(
        BACKUP_URL, blob_client=client, uid=lambda: uid_rng.random_unique_id()[:8])


def blob_objects(fs) -> tuple:
    """The completed objects of the blob store on `fs`: count and bytes."""
    files = fs_files(fs)
    sizes = [len(data) for path, (data, _d) in files.items() if path.startswith("blob/o/")]
    return len(sizes), sum(sizes)


async def commit_error(loop, tr):
    """The class name of the error `tr.commit()` ends with, None if it commits."""
    t = loop.spawn(tr.commit())
    while not t.done():
        await loop.delay(0.001)
    return None if t.exception() is None else type(t.exception()).__name__


def agent_workload(fdb, name: str, body):
    """A workload whose setup is `body(cluster)`: the backup or DR agent,
    started once ReadWrite's setup has filled its keys and before its
    traffic, so the snapshot (the initial copy) reads a quiet cluster:
    under 2048 clients of traffic it stretches over seconds of virtual
    traffic, each tens of seconds of host, and neither agent retries its
    chunk reads, so a kill during them ends it with the GRV's TimedOut."""
    class Agent(fdb["workloads_base"].Workload):
        description = name

        async def setup(self, cluster, rng):
            await body(cluster)

        async def start(self, cluster, rng):
            pass

    return Agent()


def durable_cluster(fdb, sets: SetLog, name: str, seed: int, make_set, device,
                    default_set=None, **kw):
    """The DURABLE deployment, each set recorded under `name`: built by
    `make_set(oldest)`, or by the default backend on `device` (its module
    global, `default_set`, swapped for a recording one until the next
    cluster is built: the sets built after that are the next cluster's)."""
    rc = fdb["recoverable"]
    if make_set is not None:
        return rc.RecoverableCluster(
            seed=seed, **DURABLE, conflict_backend=lambda oldest=0: sets.add(
                name, make_set(oldest), oldest), **kw)
    rc.DeviceConflictSet = lambda oldest=0, **k: sets.add(name, default_set(oldest, **k),
                                                          oldest)
    return rc.RecoverableCluster(seed=seed, **DURABLE, device=device, **kw)


def card_bytes(torch) -> int:
    """What the live tensors on the card asked for, in bytes (the caching
    allocator's `requested_bytes.all.current`).  Not `memory_allocated`:
    that also counts the slack of a cached block the allocator hands out
    whole (up to 1 MiB a block, by the layout earlier phases left), so it
    can rise with no more tensor bytes alive (NVIDIA H100 80GB HBM3,
    700.00 W: +393728 B at phase 16's second recovery with the requested
    bytes unchanged)."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def card_sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def backup_run(torch, fdb, part: str, clients: int, seconds: float, kills: tuple,
               device="cuda", make_set=None, restart=False):
    """(a): a BackupAgent captures the source into a blob:// container:
    start and a snapshot of 500-row chunks once ReadWrite's setup has
    filled the keys, then ReadWrite's traffic with one pipeline kill while
    the log streams (the worker rejoins the new generation by its tag, as
    in tests/test_backup.py), then the log to the final read version; and
    restore() into a destination of the same deployment on the same loop.
    The destination's user keyspace must equal the source's final one and the
    container's fold (apply_backup), hold every acknowledged write, and
    pass ConsistencyCheck.  With `restart`, (d): the source powered off,
    its disks saved as a restart image on the host, loaded and restarted on
    the card; it serves the same keyspace, commits once, and a container
    reopened there reads the same chunks and log.  Returns the run's record."""
    rc, kernels, backup = fdb["recoverable"], fdb["kernels"], fdb["backup"]
    sets, real_set = SetLog(kernels), rc.DeviceConflictSet
    try:
        src = durable_cluster(fdb, sets, "src", SEED, make_set, device, real_set)
        acked, unknown, walls, bk = [], [], {}, {}
        w = timed_readwrite(fdb, src, clients, seconds, sets.log, walls, acked, unknown)
        container = blob_container(fdb, src)
        agent = backup.BackupAgent(src)

        n_kills, first_kill, interval = kills
        attrition = fdb["attrition"].AttritionWorkload(kills=n_kills, start_delay=first_kill,
                                                       interval=interval)

        async def take_backup(cluster):
            bk["start_version"] = await agent.start(container)
            bk["snapshot_version"] = await agent.snapshot(container,
                                                          chunk_rows=BACKUP_CHUNK_ROWS)
            bk["snapshot_done_s"] = cluster.loop.now()
            bk["kill_s"] = cluster.loop.now() + first_kill

        work = [w, agent_workload(fdb, "Backup", take_backup), attrition]
        db = src.database()

        async def drain():
            v = await db.create_transaction().get_read_version()
            t = src.loop.now()
            await agent.wait_backed_up_to(v, timeout=120.0)
            bk["final_version"], bk["lag_s"] = v, src.loop.now() - t
            await agent.stop()

        card_sync(torch, device)
        kernels.reset_launches()
        t0 = time.perf_counter()
        metrics = fdb["workloads_base"].run_workloads(src, work, deadline=1e6)["ReadWrite"]
        src.run_until(src.loop.spawn(drain()))
        walls["run"] = time.perf_counter() - t0
        card_sync(torch, device)
        paths = {"src": kernels.launch_counts()}
        want = read_user(fdb, src, db)
        chunks, log = src.run_until(src.loop.spawn(container.read()))
        folded = backup.apply_backup(chunks, log)
        rec = dict(metrics=metrics, end=src.loop.now(), recoveries=src.controller.recoveries,
                   killed=attrition.killed, backup=bk, acked=len(acked),
                   unknown=len(unknown), walls=walls, chunks=len(chunks),
                   log_versions=len(log), objects=blob_objects(src.fs))

        dst = durable_cluster(fdb, sets, "dst", SEED + 2, make_set, device, real_set,
                              loop=src.loop)
        db2, restored = dst.database(), []
        acked_writes(db2, restored)
        card_sync(torch, device)
        kernels.reset_launches()
        t0 = time.perf_counter()
        target = dst.run_until(dst.loop.spawn(backup.restore(db2, container)))
        walls["restore"] = time.perf_counter() - t0
        card_sync(torch, device)
        paths["dst"] = kernels.launch_counts()
        got = read_user(fdb, dst, db2)
        cc = fdb["consistency"].ConsistencyCheckWorkload()
        consistent = dst.run_until(dst.loop.spawn(cc.check(dst, dst.rng.split())))
        rec.update(restore_target=target, restored=got, restore_txns=len(restored),
                   restore_writes=[len(m) for _v, m in restored], end_restore=dst.loop.now(),
                   consistency=cc.metrics(), files=(fs_files(src.fs), fs_files(dst.fs)))
        dst.stop()
        if restart:
            rec.update(restart_run(torch, fdb, sets, src, make_set, (chunks, log), want))
            paths["restart"] = rec.pop("restart_launches")
        else:
            src.stop()
    finally:
        rc.DeviceConflictSet = real_set
    require(want == got, f"backup {part}: the restored keyspace differs from the source's "
            f"final one in {len(set(want) ^ set(got))} keys "
            f"({sum(got.get(k) != v for k, v in want.items())} differ)")
    require(folded == want, f"backup {part}: apply_backup of the container differs from the "
            f"source's keyspace")
    require(consistent, f"backup {part}: ConsistencyCheck failed on the destination")
    check_read_back({k: v for k, v in got.items() if k.startswith(b"rw/")},
                    expected_values(fdb["types"], rw_writes(acked)), unknown,
                    f"backup {part} restore")
    rec.update(launches=sets.check(fdb, paths, f"backup {part}", device == "cuda"),
               sets=sets.sets,
               stats={name: sets.batch_stats(name) for name in paths},
               verdicts=[(i, v, g) for _k, i, v, _t, g, _ms in
                         (e for e in sets.log if e[0] == "batch")],
               news=[e for e in sets.log if e[0] == "new"])
    return rec


def restart_run(torch, fdb, sets: SetLog, src, make_set, read: tuple, want: dict) -> dict:
    """(d): power off the source, save its disks as a restart image on the
    host, load it back, and restart on the card from it."""
    image, kernels = fdb["image"], fdb["kernels"]
    fs = src.power_off()
    for s in sets.of("src"):
        s.retire()
    with tempfile.TemporaryDirectory() as tmp:
        saved = image.save_image(fs, str(Path(tmp) / "image"), {"seed": SEED, "phase": 17})
        files, manifest = image.load_image(saved)
    card_sync(torch, "cuda")
    kernels.reset_launches()
    c = durable_cluster(fdb, sets, "restart", SEED + 3, make_set, "cuda",
                        fs=image.restore_filesystem(files), restart=True)
    db = c.database()

    async def probe():
        tr = db.create_transaction()
        tr.set(BACKUP_PROBE, b"1")
        await tr.commit()

    c.run_until(c.loop.spawn(probe()))
    card_sync(torch, "cuda")
    launches = kernels.launch_counts()
    served = read_user(fdb, c, db)
    container = blob_container(fdb, c)
    reread = c.run_until(c.loop.spawn(container.read()))
    c.stop()
    served.pop(BACKUP_PROBE, None)
    require(served == want, "backup restart: the restarted source serves another keyspace")
    require(reread == read, "backup restart: the reopened container reads other chunks or log")
    return dict(restart_launches=launches, image_files=len(files),
                image_bytes=sum(len(d) for d in files.values()),
                image_format=manifest["format"])


def dr_run(torch, fdb, clients: int, seconds: float, kills: tuple, make_set) -> dict:
    """(b): a primary and a secondary of the DURABLE deployment on one
    loop; DRAgent.start once ReadWrite's setup has filled the primary (the
    initial copy in 500-row transactions), a direct write to the secondary
    refused with DatabaseLocked, then ReadWrite's traffic with one
    pipeline kill on the primary while the stream applies (the DR tag
    rejoins the new generation), then failover().  The secondary's
    keyspace must equal the primary's final one and hold every
    acknowledged write; it commits once it is unlocked.  Returns the run's
    record; every set it built is retired (its card memory let go) by the
    time it returns."""
    kernels, clear_range = fdb["kernels"], fdb["types"].MutationType.CLEAR_RANGE
    sets = SetLog(kernels)
    primary = durable_cluster(fdb, sets, "primary", SEED + 4, make_set, "cuda")
    secondary = durable_cluster(fdb, sets, "secondary", SEED + 5, make_set, "cuda",
                                loop=primary.loop)
    acked, unknown, walls, dr = [], [], {}, {}
    w = timed_readwrite(fdb, primary, clients, seconds, sets.log, walls, acked, unknown)
    applied = []
    sec_database = secondary.database

    def recorded_database(*args):
        db = sec_database(*args)
        acked_writes(db, applied)
        return db

    secondary.database = recorded_database
    agent = fdb["dr"].DRAgent(primary, secondary)

    n_kills, first_kill, interval = kills
    attrition = fdb["attrition"].AttritionWorkload(kills=n_kills, start_delay=first_kill,
                                                   interval=interval)

    async def start_dr(cluster):
        loop = cluster.loop
        dr["start_version"] = await agent.start(chunk_rows=BACKUP_CHUNK_ROWS)
        dr["copy_done_s"] = loop.now()
        for _ in range(100):
            gen = secondary.controller.generation
            if gen is not None and all(p.locked for p in gen.proxies):
                break
            await loop.delay(0.1)
        tr = secondary.database().create_transaction()
        tr.set(b"dr/rogue", b"x")
        dr["rogue"] = await commit_error(loop, tr)
        dr["kill_s"] = loop.now() + first_kill

    work = [w, agent_workload(fdb, "DR", start_dr), attrition]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    metrics = fdb["workloads_base"].run_workloads(primary, work, deadline=1e6)["ReadWrite"]
    dr["lag_versions"] = agent.lag_versions
    t = primary.loop.now()
    dr["final_version"] = primary.run_until(primary.loop.spawn(agent.failover(timeout=240.0)))
    dr["failover_s"] = primary.loop.now() - t
    walls["run"] = time.perf_counter() - t0
    pri = read_user(fdb, primary, primary.database())
    sec_db = secondary.database()
    sec = read_user(fdb, secondary, sec_db)

    async def probe():
        tr = sec_db.create_transaction()
        tr.set(DR_PROBE, b"1")
        await tr.commit()
        return await sec_db.create_transaction().get(DR_PROBE)

    dr["probe"] = secondary.run_until(secondary.loop.spawn(probe()))
    torch.cuda.synchronize()
    window = kernels.launch_counts()
    gc.collect()
    torch.cuda.synchronize()
    dr["memory_both_up"] = card_bytes(torch)
    rec = dict(metrics=metrics, end=primary.loop.now(),
               recoveries=primary.controller.recoveries, dr=dr, walls=walls,
               acked=len(acked), unknown=len(unknown), keys=len(sec),
               copy_rows=[len(m) - 1 for _v, m in applied if any(
                   mu.type == clear_range for mu in m)],
               apply_txns=sum(any(mu.key == fdb["dr"].APPLIED_KEY for mu in m)
                              for _v, m in applied))
    secondary.stop()
    primary.stop()
    require(dr["rogue"] == "DatabaseLocked",
            f"dr: a direct write to the locked secondary ended with {dr['rogue']!r}")
    require(sec == pri, f"dr: the secondary's keyspace differs from the primary's in "
            f"{len(set(sec) ^ set(pri))} keys ({sum(sec.get(k) != v for k, v in pri.items())} "
            f"values differ)")
    check_read_back({k: v for k, v in sec.items() if k.startswith(b"rw/")},
                    expected_values(fdb["types"], rw_writes(acked)), unknown,
                    "dr secondary")
    require(dr["probe"] == b"1", "dr: the promoted secondary did not commit")
    # both clusters' sets shared the window: each cluster's sets must sum to
    # their own launches, and together to the window's
    both = {name: sets.launches(name) for name in ("primary", "secondary")}
    require(all(window[k] == both["primary"].get(k, 0) + both["secondary"].get(k, 0)
                for k in window),
            f"dr: launches outside the two clusters' sets ({window} against {both})")
    rec.update(launches=sets.check(fdb, both, "dr"),
               stats={name: sets.batch_stats(name) for name in both})
    return rec


def dr_part(torch, fdb, make_set, power) -> tuple:
    """(b), run, checked and printed: the card's memory before the phase's
    two clusters, with both up, and after both stopped.  Returns its paths
    and summary."""
    clients, seconds, kills = BACKUP_RUN
    gc.collect()
    torch.cuda.synchronize()
    before = card_bytes(torch)
    t = time.perf_counter()
    b = dr_run(torch, fdb, clients, seconds, kills, make_set)
    gc.collect()
    torch.cuda.synchronize()
    after = card_bytes(torch)
    wall_b = time.perf_counter() - t
    dr, m, st = b["dr"], b["metrics"], b["stats"]
    require(after <= before, f"dr: card memory {after} B after both clusters stopped, above "
            f"the {before} B before the phase")
    require(b["recoveries"] >= kills[0],
            f"dr: {b['recoveries']} primary recoveries after {kills[0]} kills")
    log(f"dr b: primary and secondary {DURABLE} on one loop ({clients} clients on the "
        f"primary, {seconds} virtual s, AttritionWorkload(kills={kills[0]}) on the primary): "
        f"{m['committed']} committed + {m['retries']} retries in {b['walls']['run']:.1f} s "
        f"host wall ({b['walls']['start']:.1f} s of workload: "
        f"{m['committed'] / b['walls']['start']:.1f} txn/s host clock), {b['recoveries']} "
        f"primary recoveries; initial copy: {len(b['copy_rows'])} transactions of "
        f"{min(b['copy_rows'])}/{max(b['copy_rows'])} writes (done at "
        f"{dr['copy_done_s']:.6f} virtual s), then {b['apply_txns']} apply transactions; a "
        f"direct write to the secondary: {dr['rogue']}; lag before failover "
        f"{dr['lag_versions']} versions, failover {dr['failover_s']:.6f} virtual s to version "
        f"{dr['final_version']}; the secondary's {b['keys']} user keys equal the primary's, "
        f"every acknowledged write among them; probe commit after unlock ok; card "
        f"the card's requested bytes {before} B before, {dr['memory_both_up']} B with both up, {after} B "
        f"after both stopped; 0 verdict mismatches against the oracle; on {power}")
    for name in ("primary", "secondary"):
        s = st[name]
        log(f"dr b {name}: {s['sets']} sets, {s['batches']} batches of "
            f"{s['size_min']}/{s['size_median']:.0f}/{s['size_max']} txns, resolve_batch "
            f"p50={s['p50_ms']:.3f} p99={s['p99_ms']:.3f} ms (host clock), "
            f"{s['compactions']} compactions, launches {json.dumps(b['launches'][name])}")
    return ({"dr_primary": b["launches"]["primary"],
             "dr_secondary": b["launches"]["secondary"]},
            dict(metrics=m, dr=dr, recoveries=b["recoveries"], walls=b["walls"], stats=st,
                 memory=(before, dr["memory_both_up"], after), wall_s=wall_b))


def backup_phase(torch, fdb, power):
    """Phase 17: (a) backup into a blob:// container and restore, with (d)
    the restart image; (b) DR between two live clusters with the card's
    memory across both; (c) (a)'s reduced twin on the default backend,
    "cuda" against "cpu".  Returns {path: launches}."""
    tdev = fdb["device"]

    def make_set(oldest):
        return tdev.DeviceConflictSet(oldest, **CLUSTER_SET, device="cuda")

    clients, seconds, kills = BACKUP_RUN
    t = time.perf_counter()
    a = backup_run(torch, fdb, "a", clients, seconds, kills, make_set=make_set, restart=True)
    wall_a = time.perf_counter() - t
    require(a["recoveries"] >= kills[0],
            f"backup a: {a['recoveries']} recoveries after {kills[0]} kills")
    require(len(a["killed"]) == kills[0], f"backup a: killed {a['killed']}")
    m, bk, st = a["metrics"], a["backup"], a["stats"]
    log(f"backup a: {DURABLE} ({clients} clients, {seconds} virtual s, "
        f"AttritionWorkload(kills={kills[0]})): {m['committed']} committed + {m['retries']} "
        f"retries in {a['walls']['run']:.1f} s host wall ({a['walls']['start']:.1f} s of "
        f"workload: {m['committed'] / a['walls']['start']:.1f} txn/s host clock), "
        f"{a['recoveries']} recoveries; the backup started at version {bk['start_version']}, "
        f"snapshot of {a['chunks']} chunks at version {bk['snapshot_version']} (done at "
        f"{bk['snapshot_done_s']:.6f} virtual s; {a['killed']} killed at {bk['kill_s']:.6f}), "
        f"log of "
        f"{a['log_versions']} versions, lag {bk['lag_s']:.6f} virtual s behind the final "
        f"read version; {a['objects'][0]} blob objects, {a['objects'][1]} bytes; restore: "
        f"{a['restore_txns']} transactions of {min(a['restore_writes'])}/"
        f"{np.median(a['restore_writes']):.0f}/{max(a['restore_writes'])} writes "
        f"(min/median/max) in {a['walls']['restore']:.1f} s host wall, to version "
        f"{a['restore_target']}; all {len(a['restored'])} user keys equal the source's and "
        f"apply_backup's, ConsistencyCheck {json.dumps(a['consistency'])}; restart image: "
        f"{a['image_files']} files, {a['image_bytes']} bytes, same chunks and log read back; "
        f"0 verdict mismatches against the oracle; on {power}")
    for name in ("src", "dst", "restart"):
        s = st[name]
        log(f"backup a {name}: {s['sets']} sets, {s['batches']} batches of "
            f"{s['size_min']}/{s['size_median']:.0f}/{s['size_max']} txns, resolve_batch "
            f"p50={s['p50_ms']:.3f} p99={s['p99_ms']:.3f} ms (host clock), "
            f"{s['compactions']} compactions, launches {json.dumps(a['launches'][name])}")
    paths = {"backup_src": a["launches"]["src"], "backup_dst": a["launches"]["dst"],
             "backup_restart": a["launches"]["restart"]}
    summary = dict(a=dict(metrics=m, backup=bk, recoveries=a["recoveries"],
                          chunks=a["chunks"], log_versions=a["log_versions"],
                          objects=a["objects"], restore_txns=a["restore_txns"],
                          walls=a["walls"], stats=st, wall_s=wall_a, power=power))
    del a

    clients, seconds, kills = BACKUP_DET
    keys = ("metrics", "end", "recoveries", "verdicts", "news", "restored", "files",
            "end_restore", "backup")
    with twin_pool() as pool:
        # (c)'s cpu run, in a process of its own, beside (b) and (c)'s cuda
        # run: (b)'s host walls are taken with it busy on another core
        pending = pool.submit(cpu_twin, "backup", keys, "c cpu", clients, seconds, kills)
        dr_paths, summary["b"] = dr_part(torch, fdb, make_set, power)
        paths.update(dr_paths)
        gpu = backup_run(torch, fdb, "c cuda", clients, seconds, kills, device="cuda")
        check_backend_device(gpu, "cuda")
        cpu = pending.result()
    for key in keys:
        require(gpu[key] == cpu[key], f"backup c: the cuda and cpu runs' {key} differ")
    paths["backup_c_cuda"] = sum_launches(fdb["kernels"], (gpu["launches"]["src"],
                                                          gpu["launches"]["dst"]))
    summary["c"] = dict(committed=gpu["metrics"]["committed"], end_virtual_s=gpu["end"],
                        recoveries=gpu["recoveries"], batches=len(gpu["verdicts"]),
                        files=[len(f) for f in gpu["files"]],
                        cuda_wall_s=gpu["walls"]["run"] + gpu["walls"]["restore"],
                        cpu_wall_s=cpu["walls"]["run"] + cpu["walls"]["restore"])
    log(f"backup c: {clients} clients, 1 kill, the default backend "
        f"(DeviceConflictSet(oldest, device=...)), cuda and cpu: identical ReadWrite "
        f"metrics, end virtual time {gpu['end']:.6f} s, {gpu['recoveries']} recoveries, "
        f"verdict stream ({len(gpu['verdicts'])} batches), restored keyspace "
        f"({len(gpu['restored'])} keys) and all {sum(summary['c']['files'])} files of both "
        f"clusters byte for byte (the blob store's {gpu['objects'][0]} objects among them); "
        f"wall {summary['c']['cuda_wall_s']:.1f} s cuda, "
        f"{summary['c']['cpu_wall_s']:.1f} s cpu")
    log("backup summary " + json.dumps(summary, default=str))
    return paths


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 18: the simulation-spec corpus (workloads/spec.py) and long keys

SPEC_RUNS = (  # (launches_by_path name, spec path, a restarting pair?)
    ("spec_device_fault", "tests/specs/DeviceFaultSwizzle.txt", False),
    ("spec_restart_pair", "tests/specs/restarting/RestartAttritionSwizzle-1.txt", True),
)
DEVICE_SITES = ("device.lost", "device.dispatch_hang", "device.compile_fail",
                "device.readback_corrupt")
# (b): phase 16's deployment and set, the set starting at the default key
# width; ReadWrite at 2048 clients (virtual seconds of traffic: the cut) and
# FuzzAndClog's FuzzApi stanza as published (tests/specs/FuzzAndClog.txt)
LONG_SET = dict(CLUSTER_SET, max_key_bytes=32)
LONG_RUN = (2048, 0.25)
FUZZ_STANZA = dict(clients=2, opsPerClient=60)
SHORT_PROBE = b"short/key0"  # a 10-byte key committed after the longest one


def without_paths(metrics: dict) -> dict:
    """A spec run's metrics less the restart image's directory (a temporary
    one a run)."""
    out = {k: v for k, v in metrics.items() if k != "restart_image"}
    for part in ("part1", "part2"):
        if part in out:
            out[part] = without_paths(out[part])
    if "SaveAndKill" in out:
        out["SaveAndKill"] = {k: v for k, v in out["SaveAndKill"].items() if k != "image"}
    return out


def spec_run(torch, fdb, part: str, path: str, pair: bool, device="cuda") -> dict:
    """One spec file, or a restarting pair from its first half, through the
    port's spec runner as written, its `backend=supervised` sets on
    `device`: every DeviceConflictSet a supervisor builds is recorded
    (SetLog) for the oracle referee and the launch checks.  Returns the
    run's record: its metrics (less the image path), the census its
    teardown traced (CodeCoverage events), the end virtual time, the
    verdict stream, the launches, the sets, and for each site forced
    (buggify.force) whether every supervisor built so far had its breaker
    open at that moment."""
    import io

    spec, tdev, kernels = fdb["spec"], fdb["device"], fdb["kernels"]
    sup_mod, buggify = fdb["supervisor"], fdb["buggify"]
    sets = SetLog(kernels, retire_on_add=False)
    real, real_sup, real_force = tdev.DeviceConflictSet, sup_mod.DeviceSupervisor, buggify.force
    tdev.DeviceConflictSet = lambda oldest=0, **kw: sets.add("spec", real(oldest, **kw),
                                                             oldest)
    sups, breaker_open = [], {}

    class Supervisor(real_sup):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            sups.append(self)

    def force(site, times=1):
        opened = all(s.health()["state"] == "degraded" for s in sups)
        breaker_open[site] = breaker_open.get(site, True) and opened
        real_force(site, times)

    sup_mod.DeviceSupervisor, buggify.force = Supervisor, force
    sink, walls = io.StringIO(), {}
    # the collector off, after a collection: a collected SimProcess's death
    # promise fires its kill hook, and a collected transaction frees its
    # cache's bytes, at moments the collector picks; this process's heap
    # and its "cpu" twin's differ, so the census would too
    gc.collect()
    gc.disable()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            card_sync(torch, device)
            kernels.reset_launches()
            t0 = time.perf_counter()
            if pair:
                metrics = spec.run_restarting_pair(str(ROOT / path), trace_sink=sink,
                                                   image_dir=tmp, device=device)
            else:
                metrics = spec.run_spec_file(str(ROOT / path), trace_sink=sink,
                                             device=device)
            walls["run"] = time.perf_counter() - t0
            card_sync(torch, device)
            launches = kernels.launch_counts()
    finally:
        gc.enable()
        tdev.DeviceConflictSet = real
        sup_mod.DeviceSupervisor, buggify.force = real_sup, real_force
    events = [json.loads(line) for line in sink.getvalue().splitlines()]
    census = sorted((e["Name"], e["Kind"], e["Hits"], e["Armed"]) for e in events
                    if e["Type"] == "CodeCoverage")
    batches = [e for e in sets.log if e[0] == "batch"]
    return dict(metrics=without_paths(metrics), census=census,
                end=max(e["Time"] for e in events), launches=launches, sets=sets,
                walls=walls, verdicts=[(i, v, got) for _k, i, v, _t, got, _ms in batches],
                news=[e for e in sets.log if e[0] == "new"], breaker_open=breaker_open)


def check_forced_fired(name: str, fires: dict, breaker_open: dict) -> None:
    """Each device.* site the DeviceFault stanza forced fired, unless every
    supervisor's breaker was open when it was forced: its site, a guarded
    device call, was then out of reach, and stayed so (an unfired force
    stays pending, so a re-promoted supervisor's first device call would
    have fired it)."""
    unmet = {s: fires.get(s, 0) for s in breaker_open
             if s in DEVICE_SITES and not fires.get(s, 0) and not breaker_open[s]}
    require(not unmet, f"{name}: forced device faults that never fired while a "
            f"supervisor could reach them: {unmet} (fires {fires})")


def spec_phase(torch, fdb, power) -> dict:
    """(a): DeviceFaultSwizzle and the RestartAttritionSwizzle pair as
    written, their supervised sets on the card, each beside a "cpu" twin in
    a spawned process: the spec's checks pass (they raise otherwise), the
    cuda and cpu runs' metrics, census, end virtual time and verdict stream
    are identical, every set the supervisors built equals the oracle with
    K1/K2 once a resolve pass and K4 once a compaction, each device.* class
    the DeviceFault stanza forced fired (check_forced_fired), and a
    supervisor re-promoted to the card.  Then readback_drill, for the
    class the spec forces behind open breakers.  Returns {path: launches}."""
    keys = ("metrics", "census", "end", "verdicts", "news")
    paths = {}
    for name, path, pair in SPEC_RUNS:
        with twin_pool() as pool:
            pending = pool.submit(cpu_twin, "spec", keys, f"{name} cpu", path, pair)
            gpu = spec_run(torch, fdb, f"{name} cuda", path, pair)
            cpu = pending.result()
        for key in keys:
            require(gpu[key] == cpu[key], f"{name}: the cuda and cpu runs' {key} differ")
        sets = gpu["sets"]
        paths[name] = sets.check(fdb, {"spec": gpu["launches"]}, name, idle_ok=True)["spec"]
        check_backend_device(dict(sets=sets.sets), "cuda")
        fires = {n: h for n, kind, h, _a in gpu["census"]
                 if kind == "buggify" and n in DEVICE_SITES}
        cov = {n: h for n, kind, h, _a in gpu["census"] if kind == "testcov"}
        forced = (gpu["metrics"]["part1"] if pair else gpu["metrics"])["DeviceFault"]
        check_forced_fired(name, fires, gpu["breaker_open"])
        require(cov.get("device.promoted", 0) >= 1,
                f"{name}: no supervisor re-promoted to the card")
        stats = sets.batch_stats("spec")
        log(f"spec {name}: {path} as written (backend=supervised on the card): checks "
            f"passed; metrics {json.dumps(gpu['metrics'])}; the cpu twin identical "
            f"(metrics, census of {len(gpu['census'])} sites, end virtual time "
            f"{gpu['end']:.6f} s, verdict stream of {len(gpu['verdicts'])} batches); "
            f"{len(sets.sets)} sets built by the supervisors ({stats['batches']} batches, "
            f"{stats['compactions']} compactions, resolve_batch p50={stats['p50_ms']:.3f} "
            f"p99={stats['p99_ms']:.3f} ms), 0 oracle mismatches; DeviceFault forced "
            f"{forced['forced_sites']} classes, each breaker open at the force "
            f"{json.dumps(gpu['breaker_open'])}; device.* fires {json.dumps(fires)}, "
            f"degraded {cov.get('device.degraded', 0)}, promoted "
            f"{cov.get('device.promoted', 0)}, cpu rebuilds {cov.get('device.cpu_rebuild', 0)}; "
            f"launches {json.dumps(paths[name])}; wall {gpu['walls']['run']:.1f} s cuda, "
            f"{cpu['walls']['run']:.1f} s cpu; on {power}")
    paths["readback_drill"] = readback_drill(torch, fdb, power)["launches"]
    return paths


DRILL_TXNS = 6  # readback_drill's transactions a batch


def readback_drill(torch, fdb, power, device="cuda") -> dict:
    """(a)'s supplement: DeviceFaultSwizzle forces device.readback_corrupt
    while every breaker is open, so its site is never reached there.  Here
    it is forced once on the spec's own supervised backend on `device`:
    batch 1 is the promotion's parity batch, batch 2's readback is
    corrupted (out-of-enum verdicts) and served from the CPU rebuild,
    force_promote() re-probes, batch 3 is the parity batch and batches
    4-5 come from the card.  Every batch's verdicts equal the port's
    OracleConflictSet's.  Returns the drill's record."""
    spec, buggify, TxInfo = fdb["spec"], fdb["buggify"], fdb["TxInfo"]
    kernels = fdb["kernels"]
    oracle = fdb["oracle"].OracleConflictSet()
    kernels.reset_launches()
    sup = spec._supervised_backend(device=device)
    buggify.enable(fdb["DeterministicRandom"](SEED), enable_prob=0.0)
    served = []
    try:
        for v in range(1, 6):
            txns = [TxInfo(max(v - 1 - i % 3, 0), [(b"rd%d" % (i % 4), b"rd%d\x00" % (i % 4))],
                           [(b"rd%d" % ((i + v) % 4), b"rd%d\x00" % ((i + v) % 4))])
                    for i in range(DRILL_TXNS)]
            if v == 2:
                buggify.force("device.readback_corrupt", 1)
            if v == 3:
                sup.force_promote()
            got = sup.resolve_batch(v, txns)
            want = oracle.resolve_batch(v, txns)
            require(list(got) == list(want),
                    f"readback drill: batch {v} {got} differs from the oracle's {want}")
            served.append(sup.health()["serving"])
        census = buggify.census()
        h = sup.health()
    finally:
        buggify.disable()
        card_sync(torch, device)
        sup.close()
    launches = kernels.launch_counts()
    require(census["device.readback_corrupt"]["fires"] == 1
            and h["last_failure"] == "dispatch:readback_corrupt"
            and served == ["device", "cpu", "device", "device", "device"]
            and h["promotions"] == 2 and launches["probe_fused"] >= 4,
            f"readback drill: census {census}, served {served}, health {h}, "
            f"launches {launches}")
    log(f"readback drill: device.readback_corrupt forced once on the spec's supervised "
        f"backend ({device}): fired 1, caught as {h['last_failure']}, batches served "
        f"from {served}, {h['promotions']} promotions, verdicts equal the oracle's on "
        f"all 5; launches {json.dumps(launches)}; on {power}")
    return dict(served=served, health=h, launches=launches)


def widths_by_kernel(kernels, widths: dict) -> list:
    """Count K1's, K3's and K4's launches by the key width (lanes) of
    their inputs into `widths`, {(kernel, W): launches}; returns the
    wrapped functions to restore."""
    real = []
    for fn, name, arg in (("probe_fused", "probe_fused", 0),
                          ("compact_ranks", "compact_ranks", 0),
                          ("run_to_step_runs", "run_to_step", 0)):
        inner = getattr(kernels, fn)

        def counted(*a, _inner=inner, _name=name, _arg=arg, **k):
            before = kernels.launches[_name]
            out = _inner(*a, **k)
            n = kernels.launches[_name] - before
            if n:
                key = (_name, int(a[_arg].shape[-1]))
                widths[key] = widths.get(key, 0) + n
            return out

        real.append((fn, inner))
        setattr(kernels, fn, counted)
    return real


def long_key_run(torch, fdb, clients: int, seconds: float, device="cuda") -> dict:
    """(b): phase 16's deployment, its set at capacity 2**19 starting at
    the default 32-byte width; ReadWrite over RW_KEYS keys and FuzzApi
    (keys of up to 203 bytes), each the class the spec's WORKLOAD_FACTORY names, run by
    run_workloads; then a 10-byte key committed.  Records each widening
    (width, the card's requested bytes before and after), K1/K3/K4 launches by width,
    and the card's memory after the cluster stops.  Returns the record."""
    rc, spec, kernels, tdev = (fdb["recoverable"], fdb["spec"], fdb["kernels"],
                               fdb["device"])
    log, sets, widened, widths = [], [], [], {}
    memory = (lambda: card_bytes(torch)) if device == "cuda" else (lambda: 0)

    class Watched(tdev.DeviceConflictSet):
        def resolve_batch(self, version, txns):
            n, before = self.stats.widenings, memory()
            out = super().resolve_batch(version, txns)
            if self.stats.widenings != n:
                widened.append(dict(key_bytes=self.stats.key_bytes, version=version,
                                    memory_before=before, memory_after=memory()))
            return out

    def build(oldest=0):
        rec = RecordedSet(kernels, Watched(oldest, **LONG_SET, device=device), len(sets), log)
        log.append(("new", rec.index, oldest))
        sets.append(rec)
        return rec

    factory = spec.WORKLOAD_FACTORY
    # the spec names ReadWrite's class, which timed_readwrite builds
    require(factory["ReadWrite"] is fdb["readwrite"].ReadWriteWorkload,
            f"long keys: WORKLOAD_FACTORY['ReadWrite'] is {factory['ReadWrite']}")
    real = widths_by_kernel(kernels, widths)
    try:
        card_sync(torch, device)
        gc.collect()
        mem0 = memory()
        kernels.reset_launches()
        c = rc.RecoverableCluster(seed=SEED, **DURABLE, conflict_backend=build)
        acked, unknown, walls = [], [], {}
        rw = timed_readwrite(fdb, c, clients, seconds, log, walls, acked, unknown)
        fuzz = factory["FuzzApi"](**{spec._snake(k): v for k, v in FUZZ_STANZA.items()})
        t0 = time.perf_counter()
        metrics = fdb["workloads_base"].run_workloads(c, [rw, fuzz], deadline=1e6)
        walls["run"] = time.perf_counter() - t0
        db = c.database()

        async def short_commit():
            tr = db.create_transaction()
            tr.set(SHORT_PROBE, b"1")
            return await tr.commit()

        probe_version = c.run_until(c.loop.spawn(short_commit()))
        t0 = time.perf_counter()
        got = read_back(fdb, c, db)
        walls["read_back"] = time.perf_counter() - t0
        card_sync(torch, device)
        launches, by_width = kernels.launch_counts(), dict(widths)
        end = c.loop.now()
        c.stop()
        c = db = None
    finally:
        for fn, inner in real:
            setattr(kernels, fn, inner)
    facts = [dict(s.facts(), key_bytes=s.inner.stats.key_bytes,
                  widenings=s.inner.stats.widenings) for s in sets]
    for s in sets:
        s.retire()
    gc.collect()
    card_sync(torch, device)
    check_read_back(got, expected_values(fdb["types"], rw_writes(acked)),
                    [[m for m in muts if m.key.startswith(b"rw/")] for muts in unknown],
                    "long keys")
    t0 = time.perf_counter()
    mismatches = oracle_referee(fdb, log, len(sets))
    walls["referee"] = time.perf_counter() - t0
    require(mismatches == 0, f"long keys: {mismatches} resolver batches differ from the oracle")
    batches = [e for e in log if e[0] == "batch"]
    longest = max((max(len(b), len(e)) for entry in batches for t in entry[3]
                   for b, e in (*t.read_ranges, *t.write_ranges)), default=0)
    return dict(metrics=metrics, end=end, sets=sets, facts=facts, launches=launches,
                widths=by_width, widened=widened, walls=walls, acked=len(acked),
                probe_version=probe_version, longest=longest,
                memory=dict(start=mem0, stopped=memory()),
                verdicts=[(i, v, g) for _k, i, v, _t, g, _ms in batches],
                batch_ms=[(len(t), ms) for _k, _i, _v, t, _g, ms in batches],
                workload_batch_ms=[(len(e[3]), e[5]) for e in log[walls["first_entry"]:]
                                   if e[0] == "batch"])


def long_key_phase(torch, fdb, power) -> dict:
    """(b), checked and printed: 0 oracle mismatches, every acknowledged
    rw/ write read back (FuzzApi checks its own keys), the sets widened and
    to which width, K1, K3 and K4 launched at that width, the card's memory
    before the widening, after it and after the cluster stops, and the
    10-byte commit after the longest key.  Returns {path: launches}."""
    keys_mod = fdb["keys"]
    clients, seconds = LONG_RUN
    rec = long_key_run(torch, fdb, clients, seconds)
    check_cluster_launches(rec, "long keys")
    widest = max(f["key_bytes"] for f in rec["facts"])
    W = keys_mod.num_words(widest)
    require(rec["widened"] and widest > LONG_SET["max_key_bytes"],
            f"long keys: the sets did not widen ({rec['facts']})")
    require(widest <= keys_mod.grown_key_bytes(rec["longest"]),
            f"long keys: widened to {widest} B, the longest endpoint has {rec['longest']}")
    for name in ("probe_fused", "compact_ranks", "run_to_step"):
        require(rec["widths"].get((name, W), 0) > 0,
                f"long keys: {name} never launched at W={W} ({rec['widths']})")
    require(isinstance(rec["probe_version"], int), "long keys: the short-key commit failed")
    out = cluster_summary(dict(rec, metrics=rec["metrics"]["ReadWrite"]), power)
    mem = rec["memory"]
    log(f"long keys: {DURABLE} with the best-known set at {LONG_SET['capacity']} rows "
        f"from {LONG_SET['max_key_bytes']}-byte keys; ReadWrite at {clients} clients over "
        f"{RW_KEYS} keys for {seconds} virtual s and FuzzApi {json.dumps(FUZZ_STANZA)} "
        f"(spec.WORKLOAD_FACTORY): {out['committed']} committed + {out['retries']} "
        f"retries, FuzzApi {json.dumps(rec['metrics']['FuzzApi'])}, in "
        f"{rec['walls']['run']:.1f} s host wall; longest endpoint {rec['longest']} B; "
        f"widenings {json.dumps(rec['widened'])} (to {widest} B, W={W}); "
        f"the card's requested bytes {mem['start']} B before the cluster, "
        f"{rec['widened'][0]['memory_before']} B before the first widening, "
        f"{rec['widened'][-1]['memory_after']} B after the last, {mem['stopped']} B after "
        f"the cluster stopped; launches by width "
        f"{json.dumps({f'{n} W={w}': c for (n, w), c in sorted(rec['widths'].items())})}; "
        f"{out['batches']} resolver batches, {out['compactions']} compactions, "
        f"resolve_batch p50={out['service_p50_ms']:.3f} p99={out['service_p99_ms']:.3f} ms; "
        f"0 oracle mismatches ({rec['walls']['referee']:.1f} s), all {RW_KEYS} rw/ keys "
        f"read back as acknowledged; the 10-byte {SHORT_PROBE!r} committed at version "
        f"{rec['probe_version']} after the longest key; on {power}")
    return {"long_keys": rec["launches"]}


def corpus_phase(torch, fdb, power) -> dict:
    """Phase 18: (a) the supervised specs on the card, (b) long keys at
    deployment size.  (c), the bench's probes, is checked in phase 10.
    Returns {path: launches}."""
    t = time.perf_counter()
    paths = spec_phase(torch, fdb, power)
    log(f"corpus (a): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    paths.update(long_key_phase(torch, fdb, power))
    log(f"corpus (b): {time.perf_counter() - t:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# phase 19: the served cluster (tools/server.py with its coordinators,
# gateway and clients), the saturation ladder (tools/saturate.py) and a soak
# campaign (tools/soak.py)

SERVED_RUN_S = "900"        # each served process's own wall limit (--run-seconds)
SERVED_SEEDS = (11, 12, 13)  # the bindingtester's op streams
SERVED_KEYS = (600, 10000, 10)  # through the gateway, after the digests
# ROADMAP C.1's repro, in this process: FoundationDB's 10,000-byte keys,
# then one past the 16 KB the set once stopped at (its end widens the set
# to 32768 bytes, W = 8193)
REPRO_KEYS = (600, 10, 10000, 12, 16385, 12)
REPRO_WIDTHS = [1024, 16384, 32768]  # the widths the default set widens to
REPRO_SEED = 1
REPRO_FILL = 12  # short commits after the repro: a compaction at W = 8193
# r02's deployment (BENCH_SAT_r02.json: ssd, 2 shards x 2 replicas, 4000
# keys of 128-byte values, zipf 1.2, seed 11), data distribution on, its
# ladder cut to three 1-virtual-second steps
SAT_CURVE = dict(steps=[50.0, 100.0, 200.0], step_duration=1.0, keys=4000, seed=11,
                 skew=1.2)
SOAK_SPEC = "tests/specs/DeviceFaultSwizzle.txt"
SOAK_SEEDS = [3000, 3001, 3002, 3003]
SOAK_JOBS = 2
SOAK_SEED_DEADLINE = 600.0
CARD = "cuda"  # the device of phase 19's runs; their twins run on "cpu"
# the kernels each path must launch: the server's and the ladder's sets
# compact; the soak's spec sets see one-transaction batches between faults
SERVED_KERNELS = MAIN_PATH
SOAK_KERNELS = ("probe_fused", "intra_fixpoint")


class Served:
    """A child process of the served cluster (`python -m module args`,
    from the repository's root); a thread queues its output lines."""

    def __init__(self, module: str, *args: str) -> None:
        import queue
        import threading

        self.name = module.rsplit(".", 1)[-1]
        self.p = subprocess.Popen([sys.executable, "-m", module, *args],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True, cwd=str(ROOT))
        self.lines: queue.Queue = queue.Queue()
        self.seen: list[str] = []
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self) -> None:
        for line in self.p.stdout:
            self.lines.put(line)

    def wait_line(self, needle: str, timeout: float = 300.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.lines.empty():
                require(self.p.poll() is None,
                        f"{self.name} exited ({self.p.returncode}) before {needle!r}: "
                        f"{''.join(self.seen)[-3000:]}")
                time.sleep(0.1)
                continue
            line = self.lines.get()
            self.seen.append(line)
            if needle in line:
                return line
        raise RuntimeError(f"{self.name} never printed {needle!r} in {timeout} s: "
                           f"{''.join(self.seen)[-3000:]}")

    def kill(self) -> None:
        if self.p.poll() is None:
            self.p.kill()
        self.p.wait()


class TxnDriver:
    """The bindingtester's driver over a binding whose transactions have
    the tester's surface already (the C ABI's ctypes wrapper, the gateway
    client): `new_txn` makes one."""

    def __init__(self, new_txn) -> None:
        self.new_txn = new_txn


class InProcessDriver:
    """The bindingtester's driver over the port's in-process client: a
    read-your-writes transaction on a cluster in this process, every read
    and commit run to its end on the cluster's loop."""

    def __init__(self, fdb, cluster) -> None:
        self.c, self.db, self.types = cluster, cluster.database(), fdb["types"]

    def new_txn(self):
        c, tr, types = self.c, self.db.create_ryw_transaction(), self.types

        def wait(coro):
            return c.run_until(c.loop.spawn(coro), 300)

        class Txn:
            set = staticmethod(tr.set)
            clear_range = staticmethod(tr.clear_range)
            reset = staticmethod(tr.reset)
            set_option = staticmethod(tr.set_option)

            def get(self, k):
                return wait(tr.get(k))

            def get_range(self, b, e, limit):
                return wait(tr.get_range(b, e, limit=limit))

            def atomic_add(self, k, d):
                tr.atomic_op(types.MutationType.ADD, k, d.to_bytes(8, "little", signed=True))

            def get_key(self, k, or_equal, offset):
                return wait(tr.get_key(types.KeySelector(k, or_equal, offset)))

            def get_range_selector(self, bk, boe, boff, ek, eoe, eoff, limit):
                return wait(tr.get_range(types.KeySelector(bk, boe, boff),
                                         types.KeySelector(ek, eoe, eoff), limit=limit))

            def commit(self):
                wait(tr.commit())

        return Txn()


def clear_user(db) -> None:
    """A gateway client's user keyspace emptied, as a fresh cluster has
    it: the digests' selectors step past bt/ into whatever else it holds."""
    db.run(lambda tr: tr.clear_range(b"", b"\xff"))


def repro_keys(lengths) -> list:
    return [b"fz/" + b"k" * (n - 3) for n in lengths]


def repro_run(torch, fdb, make_set, fill: int = 0) -> tuple:
    """ROADMAP C.1's repro on a RecoverableCluster(seed=REPRO_SEED) whose
    resolvers host `make_set`'s sets: one transaction a key (read, write,
    commit; an error fails the phase), then `fill` short commits, then
    every key read back.  Returns ([(length, version, virtual time)],
    values, end)."""
    c = fdb["recoverable"].RecoverableCluster(seed=REPRO_SEED, conflict_backend=make_set)
    db = c.database()
    keys = repro_keys(REPRO_KEYS)

    async def body():
        out = []
        for k in keys:
            tr = db.create_transaction()
            await tr.get(k)
            tr.set(k, b"v%d" % len(k))
            out.append((len(k), await tr.commit(), c.loop.now()))
        for i in range(fill):
            tr = db.create_transaction()
            tr.set(b"fill/%d" % i, b"%d" % i)
            await tr.commit()
        tr = db.create_transaction()
        return out, [await tr.get(k) for k in keys]

    try:
        commits, values = c.run_until(c.loop.spawn(body()), 300.0)
        return commits, values, c.loop.now()
    finally:
        c.stop()


def repro_part(torch, fdb, power, device="cuda") -> dict:
    """(a), in this process: ROADMAP C.1's repro on the cluster's default
    set on the card (DeviceConflictSet(oldest, device="cuda"), capacity
    2**16, 8 runs of 4096), then REPRO_FILL short commits (a compaction at
    W = 8193), against the same cluster on the port's OracleConflictSet:
    the same versions, virtual times and values; the set widened to 1024
    and then 16384 and 32768 bytes (REPRO_WIDTHS); K1, K3 and K4 launched
    at the widest W, 8193; the card's
    requested bytes before each widening, after it, and after the stop.
    Returns {path: launches}."""
    tdev, kernels = fdb["device"], fdb["kernels"]
    memory = (lambda: card_bytes(torch)) if device == "cuda" else (lambda: 0)
    t0 = time.perf_counter()
    want = repro_run(torch, fdb, lambda oldest=0: fdb["oracle"].OracleConflictSet(oldest),
                     REPRO_FILL)
    wall_oracle = time.perf_counter() - t0
    widened, sets, widths, batch_log = [], [], {}, []

    class Watched(tdev.DeviceConflictSet):
        def resolve_batch(self, version, txns):
            n, before = self.stats.widenings, memory()
            out = super().resolve_batch(version, txns)
            if self.stats.widenings != n:
                widened.append((self.stats.key_bytes, before, memory()))
            return out

    def make(oldest=0):
        sets.append(RecordedSet(kernels, Watched(oldest, device=device), len(sets),
                                batch_log))
        return sets[-1]

    real = widths_by_kernel(kernels, widths)
    try:
        card_sync(torch, device)
        gc.collect()
        mem0 = memory()
        kernels.reset_launches()
        t0 = time.perf_counter()
        got = repro_run(torch, fdb, make, REPRO_FILL)
        wall = time.perf_counter() - t0
        card_sync(torch, device)
        launches = kernels.launch_counts()
    finally:
        for fn, inner in real:
            setattr(kernels, fn, inner)
    stats = [(s.inner.stats.key_bytes, s.inner.stats.widenings, s.inner.stats.compactions)
             for s in sets]
    for s in sets:  # a stopped cluster stays reachable: its sets must not
        s.retire()
    gc.collect()
    card_sync(torch, device)
    mem_stop = memory()
    require(got == want, f"served (a): C.1's repro on the card {got} differs from the "
                         f"oracle's {want}")
    require(all(isinstance(v, int) for _n, v, _t in got[0]),
            f"served (a): a repro key did not commit: {got[0]}")
    require(got[1] == [b"v%d" % n for n in REPRO_KEYS], "served (a): a repro key read back wrong")
    require([w[0] for w in widened] == REPRO_WIDTHS,
            f"served (a): the set widened {widened}, not to {REPRO_WIDTHS} bytes")
    W = fdb["keys"].num_words(REPRO_WIDTHS[-1])
    for name in WIDE_KERNELS:
        require(widths.get((name, W), 0) > 0, f"served (a): {name} never launched at W={W}")
    require(mem_stop <= mem0, f"served (a): the card's requested bytes {mem_stop} after the "
                              f"stop exceed {mem0} before the cluster")
    log(f"served (a) repro: keys {list(REPRO_KEYS)} B at seed {REPRO_SEED} committed at "
        f"(length, version, virtual s) {got[0]}, as on the oracle; end {got[2]:.6f} virtual s; "
        f"sets (key bytes, widenings, compactions) {stats}; widened (key bytes, requested B "
        f"before, after) {widened}; requested B {mem0} before the cluster, {mem_stop} after "
        f"the stop; K1/K3/K4 launches by W {json.dumps({f'{k}@{w}': n for (k, w), n in sorted(widths.items())})}; "
        f"launches {json.dumps(launches)}; wall {wall:.1f} s (oracle {wall_oracle:.1f} s) "
        f"on {power}")
    return {"long_keys_16k": launches}


def served_part(torch, fdb, tmp: str, power, device="cuda") -> dict:
    """(a), as OS processes: three coordinators, a cluster file and the
    server on the card (`python -m foundationdb_tpu_torch.tools.server
    --cluster-file F --device cuda`); the C ABI built with g++ from
    bindings/c into foundationdb_tpu_torch/_build/c_abi, its ctest printing
    C-OK; the bindingtester digests of SERVED_SEEDS through the C ABI and
    the gateway client, each equal to the port's in-process client's on a
    "cpu" cluster; keys of 600 and 10,000 bytes and a 10-byte key after
    them committed through the gateway and read back; \\xff\\xff/status/json
    through the gateway: backend cuda, key_bytes 16384 (the 10,000-byte
    key's key_after end, rounded up to the set's width); a coordinator
    killed, commits going on, and a fresh client rediscovering the gateway;
    the server's K1-K4 launches (its status document's) all > 0.  Returns
    {path: launches}."""
    gw_mod, gwc = fdb["gateway"], fdb["gateway_client"]
    sys.path.insert(0, str(ROOT / "bindings"))
    sys.path.insert(0, str(ROOT / "bindings" / "python"))
    from bindingtester import digest
    from fdbtpu_ctypes import FdbTpu

    walls = {}
    t0 = time.perf_counter()
    lib, ctest = gw_mod.build_c_bindings(ROOT / "foundationdb_tpu_torch" / "_build" / "c_abi")
    walls["c_build"] = time.perf_counter() - t0
    procs = []
    try:
        t0 = time.perf_counter()
        addrs = []
        for _ in range(3):
            procs.append(Served("foundationdb_tpu_torch.tools.coordserver",
                                "--run-seconds", SERVED_RUN_S))
            ip, _, port = procs[-1].wait_line("coordinator ready on").split()[-1].rpartition(":")
            addrs.append(fdb["rpc"]["network"].NetworkAddress(ip, int(port)))
        cf = str(Path(tmp) / "fdb.cluster")
        fdb["cluster_file"].write_cluster_file(cf, addrs)
        procs.append(Served("foundationdb_tpu_torch.tools.server", "--cluster-file", cf,
                            "--device", device, "--run-seconds", SERVED_RUN_S))
        procs[-1].wait_line("fdbtpu server ready on")
        walls["boot"] = time.perf_counter() - t0
        db = gwc.open_cluster(cf, timeout=60.0)
        host, port = db._addr
        r = subprocess.run([str(ctest), host, str(port)], capture_output=True, text=True,
                           timeout=120)
        require(r.returncode == 0 and r.stdout.startswith("C-OK "),
                f"served (a): ctest failed ({r.returncode}): {r.stdout}{r.stderr}")

        t0 = time.perf_counter()
        for seed in SERVED_SEEDS:
            clear_user(db)
            c_db = FdbTpu(str(lib), host, port)
            try:
                via_c = digest(TxnDriver(c_db.create_transaction), seed)
            finally:
                c_db.close()
            clear_user(db)
            via_gateway = digest(TxnDriver(db.transaction), seed)
            c = fdb["recoverable"].RecoverableCluster(
                seed=990 + seed, n_storage_shards=2, storage_replication=2, device="cpu")
            try:
                in_process = digest(InProcessDriver(fdb, c), seed)
            finally:
                c.stop()
            require(via_c == in_process and via_gateway == in_process,
                    f"served (a): seed {seed}'s digests differ (C ABI "
                    f"{via_c == in_process}, gateway client {via_gateway == in_process})")
        walls["digests"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        versions = []
        for k in repro_keys(SERVED_KEYS):
            tr = db.transaction()
            tr.get(k)
            tr.set(k, b"v%d" % len(k))
            versions.append(tr.commit())
            tr.destroy()
        back = db.read(lambda tr: [tr.get(k) for k in repro_keys(SERVED_KEYS)])
        walls["long_keys"] = time.perf_counter() - t0
        require(back == [b"v%d" % n for n in SERVED_KEYS] and versions == sorted(versions),
                f"served (a): the long keys read back {[len(v or b'') for v in back]}")
        doc = json.loads(db.read(lambda tr: tr.get(STATUS_KEY)))
        kernel = doc["kernel"]
        # the longest key's key_after end, rounded up to the set's width
        widest = fdb["keys"].grown_key_bytes(max(SERVED_KEYS) + 1)
        require(kernel["backend"] == device and kernel["key_bytes"] == widest,
                f"served (a): status shows backend {kernel['backend']}, key_bytes "
                f"{kernel['key_bytes']}, not {widest}")

        t0 = time.perf_counter()
        procs[0].kill()
        for i in range(3):
            db.run(lambda tr, i=i: tr.set(b"kill/%d" % i, b"%d" % i))
        db.close()
        fresh = gwc.open_cluster(cf, timeout=60.0)
        rows = fresh.read(lambda tr: tr.get_range(b"kill/", b"kill0"))
        doc = json.loads(fresh.read(lambda tr: tr.get(STATUS_KEY)))
        fresh.close()
        walls["kill"] = time.perf_counter() - t0
        require(rows == [(b"kill/%d" % i, b"%d" % i) for i in range(3)],
                f"served (a): after the coordinator kill the rediscovered gateway read {rows}")
        launches = doc["kernel"]["launches"]
        require(all(launches[k] > 0 for k in SERVED_KERNELS),
                f"served (a): the server launched {launches}")
    finally:
        for p in procs:
            p.kill()
    k = doc["kernel"]
    log(f"served (a) server: ctest {r.stdout.strip()}; digests of seeds {list(SERVED_SEEDS)} "
        f"equal through the C ABI, the gateway client and the in-process client on cpu; "
        f"keys {list(SERVED_KEYS)} B committed at versions {versions} and read back; a "
        f"coordinator killed, rediscovered; status: backend {k['backend']}, key_bytes "
        f"{k['key_bytes']}, widenings {k['widenings']}, batches {k['batches']}, txns "
        f"{k['txns']}, compactions {k['compactions']}, resolve_ms p50 "
        f"{k['resolve_ms_p50']:.3f} p99 {k['resolve_ms_p99']:.3f}; launches "
        f"{json.dumps(launches)}; walls (s) "
        f"{json.dumps({n: round(w, 1) for n, w in walls.items()})} on {power}")
    return {"served": launches}


def saturate_run(torch, fdb, part: str, device="cuda") -> dict:
    """(b): tools/saturate.run_hot_curve at SAT_CURVE on `device`, the
    collector off after a collection (as the reference's tests run it).
    Returns the curve, the launches and the host wall."""
    kernels = fdb["kernels"]
    gc.collect()
    gc.disable()
    try:
        card_sync(torch, device)
        kernels.reset_launches()
        t0 = time.perf_counter()
        curve = fdb["saturate"].run_hot_curve(True, **SAT_CURVE, device=device)
        wall = time.perf_counter() - t0
        card_sync(torch, device)
        launches = kernels.launch_counts()
    finally:
        gc.enable()
    return dict(curve=curve, launches=launches, walls=dict(run=wall))


def soak_run(torch, fdb, part: str, device="cuda") -> dict:
    """(c): a campaign of SOAK_SPEC over SOAK_SEEDS in SOAK_JOBS workers
    on `device`.  Returns the verdicts, the coverage census (per seed,
    merged, and the manifest's missing sites), each seed's metrics, the
    workers' summed launches and the host wall."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        report = fdb["soak"].run_campaign(str(ROOT / SOAK_SPEC), SOAK_SEEDS, tmp,
                                          jobs=SOAK_JOBS, seed_deadline=SOAK_SEED_DEADLINE,
                                          device=device)
        wall = time.perf_counter() - t0
    per_seed = report["per_seed"]
    return dict(verdicts=report["verdicts"], ok=report["ok"],
                missing=report["coverage"]["missing_required"],
                census=report["coverage"]["per_seed"], merged=report["coverage"]["merged"],
                metrics={r["seed"]: without_paths(r.get("metrics") or {}) for r in per_seed},
                errors={r["seed"]: r.get("error") for r in per_seed if r.get("error")},
                launches=sum_launches(fdb["kernels"],
                                      (r.get("launches", {}) for r in per_seed)),
                seed_walls={r["seed"]: round(r["wall_s"], 1) for r in per_seed},
                walls=dict(run=wall))


def served_phase(torch, fdb, power) -> dict:
    """Phase 19.  (c)'s campaign on the card runs in a thread from the
    start (its workers are processes of their own), and the cpu twins of
    (b) and (c) in spawned processes, beside (a) and (b) on the card.
    Returns {path: launches}."""
    import concurrent.futures

    keys_c = ("verdicts", "ok", "missing", "census", "merged", "metrics", "errors")
    with twin_pool() as pool_b, twin_pool() as pool_c, \
            concurrent.futures.ThreadPoolExecutor(1) as thread:
        soak_cpu = pool_c.submit(cpu_twin, "soak", keys_c, "soak cpu")
        soak_gpu = thread.submit(soak_run, torch, fdb, "soak cuda", CARD)
        sat_cpu = pool_b.submit(cpu_twin, "saturate", ("curve",), "saturate cpu")
        paths = {}
        t = time.perf_counter()
        paths.update(repro_part(torch, fdb, power, CARD))
        with tempfile.TemporaryDirectory() as tmp:
            paths.update(served_part(torch, fdb, tmp, power, CARD))
        log(f"served (a): {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        gpu = saturate_run(torch, fdb, "saturate cuda", CARD)
        cpu = sat_cpu.result()
        log(f"served (b): {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        soak_g, soak_c = soak_gpu.result(), soak_cpu.result()
        log(f"served (c): {time.perf_counter() - t:.1f} s more")

    require(gpu["curve"] == cpu["curve"], "served (b): the cuda and cpu curves differ")
    require(all(gpu["launches"][k] > 0 for k in SERVED_KERNELS),
            f"served (b): the ladder launched {gpu['launches']}")
    steps = gpu["curve"]["steps"]
    require(all(s["committed"] > 0 for s in steps), "served (b): a step committed nothing")
    log(f"served (b) saturate: run_hot_curve (r02's deployment, dd on) at "
        f"{json.dumps(SAT_CURVE)}: rows equal to the cpu twin's; per step (offered, "
        f"achieved tps, commit p50/p99 ms, grv p99 ms, limit reason, splits, hot moves) "
        f"{[(s['offered_tps'], s['achieved_tps'], s['commit_p50_ms'], s['commit_p99_ms'], s['grv_p99_ms'], s['ratekeeper']['limit_reason'], (s['data_distribution'] or {}).get('shard_splits'), (s['data_distribution'] or {}).get('hot_relocations')) for s in steps]}; "
        f"knee {json.dumps(gpu['curve']['knee'])}; final {json.dumps(gpu['curve']['final'])}; "
        f"launches {json.dumps(gpu['launches'])}; wall {gpu['walls']['run']:.1f} s cuda, "
        f"{cpu['walls']['run']:.1f} s cpu, on {power}")
    paths["saturate"] = gpu["launches"]

    require(soak_g["ok"] and soak_g["verdicts"]["pass"] == len(SOAK_SEEDS),
            f"served (c): the campaign on the card: {soak_g['verdicts']}, missing "
            f"{soak_g['missing']}, errors {soak_g['errors']}")
    for key in keys_c:
        require(soak_g[key] == soak_c[key], f"served (c): the cuda and cpu campaigns' {key} differ")
    require(all(soak_g["launches"][k] > 0 for k in SOAK_KERNELS),
            f"served (c): the workers launched {soak_g['launches']}")
    log(f"served (c) soak: {SOAK_SPEC} over seeds {SOAK_SEEDS} in {SOAK_JOBS} workers on the "
        f"card: verdicts {json.dumps(soak_g['verdicts'])}, required sites missing "
        f"{soak_g['missing']}, census of {len(soak_g['merged']['buggify'])} buggify sites and "
        f"{len(soak_g['merged']['testcov'])} testcov names equal to the cpu campaign's, per "
        f"seed and merged; metrics equal; launches {json.dumps(soak_g['launches'])}; seed "
        f"walls (s) {json.dumps(soak_g['seed_walls'])} cuda, {json.dumps(soak_c['walls'])} "
        f"cpu campaign; campaign wall {soak_g['walls']['run']:.1f} s on {power}")
    paths["soak"] = soak_g["launches"]
    return paths


# ---------------------------------------------------------------------------
# phase 20: the supervised cluster (tools/fdbmonitor.py, bounce.py,
# fdbtop.py, cli.py and flowlint.py)

BOUNCE_ARGS = dict(n_coords=3, max_gap=30.0, settle=2.0)
SERVER_LAUNCH_WAIT = 120.0  # s for a new server process to launch K1-K4
SUPERVISED_KERNELS = MAIN_PATH  # each server process launches all four


def make_card_campaign(fdb):
    """tools/bounce.Campaign that also reads the server's status through
    the gateway: after each start of a server process (the boot and every
    bounce) until its K1-K4 launches are all > 0, then once more (they
    rise under the load), and once more just before the process is
    bounced or the campaign ends (its last count)."""
    gwc = fdb["gateway_client"]

    class CardCampaign(fdb["bounce"].Campaign):
        def __init__(self, *args, **kw) -> None:
            super().__init__(*args, **kw)
            self.server_runs: list[dict] = []

        def server_kernel(self) -> dict:
            db = gwc.GatewayClient("127.0.0.1", self.gw_port, timeout=30.0,
                                   reconnect_window=60.0)
            try:  # run: a retryable error (a read too old) retries
                return json.loads(db.run(lambda tr: tr.get(STATUS_KEY)))["kernel"]
            finally:
                db.close()

        def watch_server(self, label: str) -> None:
            pid = self.mon.children[f"fdbserver.{self.gw_port}"].pid
            deadline = time.monotonic() + SERVER_LAUNCH_WAIT
            while True:
                first = self.server_kernel()
                if all(first["launches"].get(k, 0) > 0 for k in SUPERVISED_KERNELS):
                    break
                require(time.monotonic() < deadline,
                        f"supervised (a): server pid {pid} ({label}) launched "
                        f"{first['launches']} in {SERVER_LAUNCH_WAIT} s")
                self.pump(lambda: False, timeout=1.0)
            self.pump(lambda: False, timeout=1.0)
            later = self.server_kernel()
            self.server_runs.append(dict(label=label, pid=pid, backend=first["backend"],
                                         first=first["launches"], later=later["launches"]))

        def boot(self) -> None:
            super().boot()
            self.watch_server("boot")

        def bounce_section(self, section: str, label: str) -> dict:
            server = section.startswith("fdbserver.")
            if server:
                self.server_runs[-1]["last"] = self.server_kernel()["launches"]
            rec = super().bounce_section(section, label)
            if server:
                self.watch_server(label)
            return rec

    return CardCampaign


def bounce_part(torch, fdb, out: str, power, device="cuda") -> tuple:
    """(a) the campaign on `device`, then (b) one `fdbtop --once` frame
    from its cluster.  Returns ({path: launches}, the frame)."""
    import contextlib
    import io

    camp = make_card_campaign(fdb)(out, device=device, **BOUNCE_ARGS)
    t0 = time.perf_counter()
    frame = io.StringIO()
    try:
        camp.boot()
        camp.rolling_bounce()
        camp.mixed_protocol()
        camp.coordinator_change()
        report = camp.finish()
        camp.server_runs[-1]["last"] = camp.server_kernel()["launches"]
        with contextlib.redirect_stdout(frame):
            top_rc = fdb["fdbtop"].main(["--port", str(camp.gw_port), "--once"])
    finally:
        camp.shutdown()
    wall = time.perf_counter() - t0
    failed = [c for c in report["checks"] if not c["ok"]]
    require(report["ok"] and not failed, f"supervised (a): campaign checks failed: {failed}")
    runs = camp.server_runs
    require(len(runs) == 3 and len({r["pid"] for r in runs}) == 3,
            f"supervised (a): server processes {[(r['label'], r['pid']) for r in runs]}")
    for r in runs:
        require(r["backend"] == device, f"supervised (a): server pid {r['pid']} backend "
                                        f"{r['backend']}, not {device}")
        for k in SUPERVISED_KERNELS[:1]:  # K1: once a batch
            require(r["later"][k] > r["first"][k],
                    f"supervised (a): server pid {r['pid']}'s {k} launches did not "
                    f"rise: {r['first']} then {r['later']}")
    frame = frame.getvalue()
    require(top_rc == 0 and frame.startswith("fdbtpu top") and "proxy: version" in frame,
            f"supervised (b): fdbtop --once printed {frame!r}")
    launches = sum_launches(fdb["kernels"], (r["last"] for r in runs))
    mv = report["mixed_version"]
    log(f"supervised (a) bounce: 3 coordservers + 1 fdbserver (--device {device}) under "
        f"fdbmonitor, load from 2 client threads: {len(report['checks'])} checks ok; "
        f"acked commits {report['total_acks']} ({report['acked_increments']} increments, "
        f"{report['cycle_steps']} cycle steps), acked loss {report['acked_loss']}; bounces "
        f"(section, label, restart s, gap s, p50/p99 ms) "
        f"{[(b['section'], b['label'], b['restart_s'], b.get('availability_gap_s'), b.get('p50_ms'), b.get('p99_ms')) for b in report['bounces']]}; "
        f"mixed version: {mv['mismatch_events']} mismatch event(s) over {mv['peer_pairs']} "
        f"pair(s) in {mv['window_s']} s; server processes (label, pid, backend, K1-K4 first "
        f"read, later, last) {[(r['label'], r['pid'], r['backend'], r['first'], r['later'], r['last']) for r in runs]}; "
        f"client errors {report['client_error_count']}; wall {wall:.1f} s on {power}")
    log("supervised (b) fdbtop --once:\n" + frame.rstrip())
    return {"bounce": launches}, frame


def _cli_commands(Cli, kw) -> list:
    cli = Cli(seed=51, n_storage_shards=2, **kw)
    out = [cli.one_command(c) for c in (
        "set k1 v1", "get k1", "get nothing", "set k2 v2", "getrange k k3",
        "clear k1", "get k1", "status", "processes")]
    proxy = next(line.split()[0] for line in out[-1].splitlines() if line.startswith("proxy"))
    out += [cli.one_command(c) for c in (
        f"kill {proxy}", "set after-kill yes", "get after-kill", "status")]
    require("epoch now 2" in out[-4], f"supervised (c): the kill did not recover: {out[-4]}")
    cli.cluster.stop()
    return out


def _cli_repl(Cli, kw) -> list:
    import io

    cli = Cli(seed=52, **kw)
    out = io.StringIO()
    cli.repl(stdin=io.StringIO("set a 1; get a\nhelp; bogus\nexit\n"), stdout=out)
    cli.cluster.stop()
    return [out.getvalue()]


def _cli_move_backup_configure(Cli, kw) -> list:
    cli = Cli(seed=1701, n_storage_shards=2, storage_replication=2, **kw)
    out = [cli.one_command(f"set mk{i:03d} v{i}") for i in range(30)]
    out += [cli.one_command(c) for c in (
        "move mk010 mk020 1", "get mk015", "backup start bk-cli", "backup status",
        "backup stop", "configure n_tlogs=3", "errorcode 1020", "status")]
    require(out[30] == "moved", f"supervised (c): move printed {out[30]!r}")
    cli.cluster.stop()
    return out


def _cli_dr(Cli, kw) -> list:
    import io

    cli = Cli(seed=61, **kw)
    out = [cli.one_command(c) for c in (
        "set drk v1", "dr start", "set drk2 v2", "dr status", "dr switch")]
    c2 = cli._dr_secondary
    db2 = c2.database()

    async def check():
        tr = db2.create_transaction()
        return await tr.get(b"drk"), await tr.get(b"drk2")

    out.append(repr(cli.cluster.run_until(cli.cluster.loop.spawn(check()), 120)))
    refused = io.StringIO()  # the REPL prints the deposed primary's refusal
    cli.repl(stdin=io.StringIO("set stale x\nexit\n"), stdout=refused)
    out.append(refused.getvalue())
    require(out[-2] == repr((b"v1", b"v2")) and "DatabaseLocked" in out[-1],
            f"supervised (c): DR ended with {out[-2:]}")
    cli.cluster.stop()
    c2.stop()
    return out


CLI_SESSIONS = (("commands_kill", _cli_commands), ("repl", _cli_repl),
                ("move_backup_configure", _cli_move_backup_configure), ("dr", _cli_dr))


def cli_run(torch, fdb, part: str, device="cuda") -> dict:
    """(c): tests/test_cli.py's sessions through the port's Cli on
    `device`, the collector off after a collection.  Returns each
    session's printed lines, the launches and the host wall."""
    kernels = fdb["kernels"]
    gc.collect()
    gc.disable()
    try:
        card_sync(torch, device)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = {name: fn(fdb["cli"].Cli, dict(device=device)) for name, fn in CLI_SESSIONS}
        wall = time.perf_counter() - t0
        card_sync(torch, device)
        launches = kernels.launch_counts()
    finally:
        gc.enable()
    return dict(outputs=out, launches=launches, walls=dict(run=wall))


def supervised_cluster_phase(torch, fdb, power) -> dict:
    """Phase 20.  The flowlint run (d) and the cli session's cpu twin (c)
    start first, in processes of their own, beside (a) and (b) on the
    card; then (c) on the card.  Returns {path: launches}."""
    lint = subprocess.Popen([sys.executable, "-m", "foundationdb_tpu_torch.tools.flowlint"],
                            cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    paths = {}
    try:
        with twin_pool() as pool:
            cli_cpu = pool.submit(cpu_twin, "cli", ("outputs",), "cli cpu")
            t = time.perf_counter()
            with tempfile.TemporaryDirectory() as tmp:
                launches, _frame = bounce_part(torch, fdb, str(Path(tmp) / "bounce"), power,
                                               CARD)
            paths.update(launches)
            log(f"supervised (a, b): {time.perf_counter() - t:.1f} s")
            t = time.perf_counter()
            gpu = cli_run(torch, fdb, "cli cuda", CARD)
            cpu = cli_cpu.result()
            log(f"supervised (c): {time.perf_counter() - t:.1f} s")
        lint_out, _ = lint.communicate(timeout=600)
    finally:
        if lint.poll() is None:
            lint.kill()
            lint.wait()
    require(gpu["outputs"] == cpu["outputs"],
            "supervised (c): the cli sessions on cuda and on cpu printed different lines: "
            + json.dumps({k: [a for a, b in zip(v, cpu["outputs"][k]) if a != b][:2]
                          for k, v in gpu["outputs"].items()}))
    require(all(gpu["launches"][k] > 0 for k in SUPERVISED_KERNELS),
            f"supervised (c): the cli sessions launched {gpu['launches']}")
    log(f"supervised (c) cli: sessions {[n for n, _ in CLI_SESSIONS]} "
        f"({sum(len(v) for v in gpu['outputs'].values())} commands' output) equal on cuda "
        f"and cpu; launches {json.dumps(gpu['launches'])}; wall {gpu['walls']['run']:.1f} s "
        f"cuda, {cpu['walls']['run']:.1f} s cpu, on {power}")
    paths["cli"] = gpu["launches"]
    require(lint.returncode == 0 and "0 new finding(s)" in lint_out,
            f"supervised (d): flowlint exited {lint.returncode}: {lint_out[-3000:]}")
    log(f"supervised (d) flowlint: {lint_out.strip().splitlines()[-1]}")
    return paths


# ---------------------------------------------------------------------------
# phase 21: the root scripts' ports (phase_timings, profile_kernel's
# primitive table, profile2, graft_entry, bench_debug)

PHASE_REPS = 5  # phase_timings.collect()'s repetitions at its full shapes
ROOT_PATHS = ("phase_timings", "primitives", "graft_entry", "graft_dryrun", "bench_debug")


def phase_digests(device: str) -> dict:
    """phase_timings' truncation digests at its small shapes on `device`:
    on the sets as the reference profiles them (runs pending), then with
    the runs folded into main.  The "cpu" run is (a)'s twin, in the twin
    pool's process."""
    import torch

    if device == "cpu":
        torch.set_num_threads(1)
    pt = port_modules()["phase_timings"]
    p = pt.prepare(small=True, device=device)
    out = {"pending": pt.digests(p)}
    p.flat._compact_runs()
    p.lsm._compact_runs()
    out["compacted"] = pt.digests(p)
    return out


def phase_timings_part(torch, fdb, power) -> tuple:
    """(a): collect() at its full shapes on the card.  The report conforms
    to PHASE_PROFILE_SCHEMA with backend cuda; K1 and K2 once a prefill
    batch of its two sets, K2 once a call of each truncation from +intra on
    (one untimed call and PHASE_REPS timed), K3 once a compaction call.
    Returns (launches, the report)."""
    kernels, pt = fdb["kernels"], fdb["phase_timings"]
    kernels.reset_launches()
    report = pt.collect(device=CARD, reps=PHASE_REPS)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    problems = fdb["status"].check_phase_profile(report)
    require(not problems and report["backend"] == CARD and not report["small"],
            f"root (a): the phase profile does not conform: {problems}")
    prefill = fdb["bench"].PREFILL_BATCHES
    require_launches(launches, {"probe_fused": 2 * prefill,
                                "intra_fixpoint": 2 * prefill + 3 * (PHASE_REPS + 1),
                                "compact_ranks": 4, "run_to_step": 0, "probe": 0,
                                "intra_query": 0}, "root (a) phase_timings")
    log(f"root (a) phase_timings at cap {report['cap']}, {report['shapes']}: "
        f"cumulative_ms {json.dumps(report['cumulative_ms'])}; phases_ms "
        f"{json.dumps(report['phases_ms'])}; intra_iters {report['intra_iters']}; "
        f"rtt_ms {report['rtt_ms']:.4f}; lsm {json.dumps(report['lsm'])}; merge shootout "
        f"{json.dumps(report['merge_shootout_ms'])}; on {power}")
    return launches, report


def bench_debug_sync(fdb) -> list:
    """bench_debug's stream through a set of its own, every batch
    synchronous: the timed batches' padded verdict sums."""
    bd, bench, tdev = fdb["bench_debug"], fdb["bench"], fdb["device"]
    words, pre, timed = bd.stream(bench.TXNS_PER_BATCH, bench.PREFILL_BATCHES)
    cs = tdev.DeviceConflictSet(max_key_bytes=bench.MAX_KEY_BYTES, capacity=bench.CAP,
                                device=CARD)
    for b in pre:
        cs.resolve_arrays(b["version"], *bench.device_pack(words, b, tdev._bucket))
    return [int(cs.resolve_arrays(b["version"], *bench.device_pack(words, b, tdev._bucket))
                .sum()) for b in timed]


def root_scripts_phase(torch, fdb, power) -> dict:
    """Phase 21.  (a)'s cpu twin runs in a spawned process beside the cuda
    digests, after the timed run: the truncations are bound by the host's
    launches, and a process starting beside them slows them.  Returns
    {path: launches}."""
    kernels, pk, ge, bd = (fdb["kernels"], fdb["profile_kernel"], fdb["graft_entry"],
                           fdb["bench_debug"])
    paths = {}
    t = time.perf_counter()
    paths["phase_timings"], _report = phase_timings_part(torch, fdb, power)
    with twin_pool() as pool:
        twin = pool.submit(phase_digests, "cpu")
        got = phase_digests(CARD)
        want = twin.result()
    require(got == want, f"root (a): the truncation digests differ, cuda {got}, cpu {want}")
    log(f"root (a): {time.perf_counter() - t:.1f} s; the digests of every truncation and "
        f"merge at the small shapes equal on cuda and cpu, runs pending and folded: "
        f"{json.dumps(got)}")

    t = time.perf_counter()
    kernels.reset_launches()
    rows = pk.primitive_table(CARD, pk.TABLE_SHAPES)
    torch.cuda.synchronize()
    paths["primitives"] = kernels.launch_counts()
    require([label for label, _ms in rows] == [r[0] for r in pk.PRIMITIVES],
            f"root (b): rows {rows}")
    # K2 runs once a call of the WHOLE row: one untimed call and 3 timed
    require_launches(paths["primitives"], {"intra_fixpoint": 4, "probe_fused": 0,
                                           "compact_ranks": 0, "run_to_step": 0},
                     "root (b) primitives")
    log(f"root (b) primitive table: {time.perf_counter() - t:.1f} s; "
        f"{json.dumps(dict(rows))} ms on {power}")

    t = time.perf_counter()
    rows = fdb["profile2"].run(CARD)
    require(all(np.isfinite(ms) for _label, ms in rows), f"root (c): {rows}")
    log(f"root (c) profile2: {time.perf_counter() - t:.1f} s; {json.dumps(dict(rows))} ms "
        f"on {power}")

    t = time.perf_counter()
    kernels.reset_launches()
    fn, args = ge.entry(CARD)
    out = fn(*args)
    torch.cuda.synchronize()
    paths["graft_entry"] = kernels.launch_counts()
    cfn, cargs = ge.entry("cpu")
    for i, (a, b) in enumerate(zip(out, cfn(*cargs), strict=True)):
        require(torch.equal(a.cpu(), b), f"root (d): entry() output {i} differs on cuda")
    require_launches(paths["graft_entry"], {"intra_fixpoint": 1, "probe_fused": 0},
                     "root (d) entry")
    kernels.reset_launches()
    ge.dryrun_multichip(SHARDS, CARD)
    torch.cuda.synchronize()
    paths["graft_dryrun"] = kernels.launch_counts()
    require(all(paths["graft_dryrun"][k] > 0 for k in MAIN_PATH),
            f"root (d): the dry run launched {paths['graft_dryrun']}")
    log(f"root (d) graft entry: {time.perf_counter() - t:.1f} s; entry() on cuda equals "
        f"entry(device='cpu') (verdicts {out[0][:4].tolist()}, {int(out[6])} fixpoint "
        f"iterations); dryrun_multichip({SHARDS}) OK, {SHARDS} partitions on "
        f"{torch.cuda.device_count()} card(s), launches {json.dumps(paths['graft_dryrun'])}")

    t = time.perf_counter()
    bench = fdb["bench"]
    kernels.reset_launches()
    batches = bd.run(CARD, txns=bench.TXNS_PER_BATCH, cap=bench.CAP,
                     prefill=bench.PREFILL_BATCHES)
    torch.cuda.synchronize()
    paths["bench_debug"] = kernels.launch_counts()
    n = bench.PREFILL_BATCHES + bd.TIMED
    # the default set folds its 8 runs at the first timed batch: K4 once,
    # K3 once a run
    require_launches(paths["bench_debug"], {"probe_fused": n, "intra_fixpoint": n,
                                            "run_to_step": 1, "compact_ranks": 8},
                     "root (e) bench_debug")
    sync = bench_debug_sync(fdb)
    got = [b["verdict_sum"] for b in batches]
    require(got == sync, f"root (e): verdict sums {got}, synchronous {sync}")
    log(f"root (e) bench_debug: {time.perf_counter() - t:.1f} s; verdict sums {got} equal "
        f"the synchronous run's; dispatch ms {[round(b['dispatch_ms'], 3) for b in batches]}, "
        f"execute+fetch ms {[round(b['execute_ms'], 3) for b in batches]} on {power}")
    for k in MAIN_PATH:
        require(sum(p[k] for p in paths.values()) > 0,
                f"root: {k} launched on none of {ROOT_PATHS}")
    return paths


def port_modules() -> dict:
    """The port's modules the phases drive, by the names they use."""
    sys.path.insert(0, str(ROOT))
    from foundationdb_tpu_torch import (
        bench, bench_debug, cluster, graft_entry, keys, phase_timings, profile2,
        profile_kernel)
    from foundationdb_tpu_torch.conflict import (
        _build, device, kernels, native, oracle, pipeline, supervisor)
    from foundationdb_tpu_torch.conflict.api import TxInfo, Verdict
    from foundationdb_tpu_torch.client import backup, cluster_file, dr, gateway_client
    from foundationdb_tpu_torch.control import recoverable, status
    from foundationdb_tpu_torch.ops import rmq
    from foundationdb_tpu_torch.parallel import sharded
    from foundationdb_tpu_torch.roles import resolver, types
    from foundationdb_tpu_torch.rpc import network, stream, transport
    from foundationdb_tpu_torch.runtime import (
        buggify, combinators, core, coverage, knobs, serialize)
    from foundationdb_tpu_torch.runtime.core import DeterministicRandom
    from foundationdb_tpu_torch.storage import blobstore, image
    from foundationdb_tpu_torch.tools import bounce, cli, fdbtop, gateway, saturate, soak
    from foundationdb_tpu_torch.workloads import attrition, consistency, readwrite, spec
    from foundationdb_tpu_torch.workloads import base as workloads_base

    return dict(build=_build, keys=keys, device=device, kernels=kernels, oracle=oracle,
                pipeline=pipeline, rmq=rmq, coverage=coverage, TxInfo=TxInfo,
                Verdict=Verdict, supervisor=supervisor, native=native,
                buggify=buggify, DeterministicRandom=DeterministicRandom,
                bench=bench, sharded=sharded, core=core, knobs=knobs,
                combinators=combinators, serialize=serialize, types=types,
                resolver=resolver, cluster=cluster, readwrite=readwrite,
                workloads_base=workloads_base, recoverable=recoverable, status=status,
                attrition=attrition, backup=backup, dr=dr, blobstore=blobstore, image=image,
                consistency=consistency, spec=spec, gateway=gateway,
                gateway_client=gateway_client, cluster_file=cluster_file,
                saturate=saturate, soak=soak, bounce=bounce, cli=cli, fdbtop=fdbtop,
                phase_timings=phase_timings, profile_kernel=profile_kernel,
                profile2=profile2, bench_debug=bench_debug, graft_entry=graft_entry,
                rpc=dict(network=network, stream=stream, transport=transport))


# `--sweep`: the widths where K1 and K3 change plans (kernels.WARP_FROM_W),
# at which K4 is timed too
SWEEP_W = (17, 33, 65, 129, 257, 513, 1025, 2049, 4097, 8193, 16385, 32769)
SWEEP_REPS = 5
SWEEP_QUERIES = (16, 32)  # K3's warp plan at other block sizes


def sweep_variants(kernels, K: int, rows: int, W: int) -> list:
    """(plan, K1's keywords, K3's keywords) for each plan the package
    beside this script offers at width W: the warp plan everywhere, the
    staged plan below T (kernels.WARP_FROM_W: past it, the parent's run
    times the plans the warp plan replaced), and from T the warp plan's
    choices (K1's read ends staged or read from L2; K3's queries a
    block).  A package from before the warp plan offers its own plans
    only, named "before"."""
    if not hasattr(kernels, "plan_probe_warp"):
        return [("before", {}, {})]
    warp = kernels.plan_probe_warp(K, W)
    out = [("warp", {"plan": warp}, {"plan": kernels.RANKS_WARP_PLAN})]
    if W < kernels.WARP_FROM_W:
        return out + [("staged", {"plan": kernels.plan_probe_staged(K, rows, W)},
                       {"plan": kernels.plan_ranks_staged(W)})]
    for name, stage in (("staged", kernels.SMEM_MAX), ("l2", 0)):
        p1 = kernels.plan_probe_warp(K, W, stage)
        if p1 != warp:
            out.append((f"warp_ends_{name}", {"plan": p1}, None))
    for q in SWEEP_QUERIES:
        out.append((f"warp_q{q}", None, {"plan": kernels.RANKS_WARP_PLAN._replace(queries=q)}))
    return out


def sweep_k4(torch, kernels, keys_mod, base: dict, W: int, rows: int, flush) -> list:
    """K4 cold at width W on phase 3's `prefixed` runs (the first `rows`
    rows of each, built on the device of `flush`) and its yardstick
    torch.stack ("library"), each bit-exact with the plain version.  K4's
    plan is "planned" (kernels.plan_run_to_step), or "before" for a
    package from before that plan.  Returns the sweep's rows."""
    dev = flush.device
    runs_b = prefixed_lanes(torch, keys_mod, base["runs_b"][:, :rows], W, dev)
    runs_e = prefixed_lanes(torch, keys_mod, base["runs_e"][:, :rows], W, dev)
    ver = base["k1"][6]
    want = kernels.run_to_step_runs_plain(runs_b, runs_e, ver)
    k4 = "planned" if hasattr(kernels, "plan_run_to_step") else "before"
    out = []
    for plan, fn in ((k4, functools.partial(kernels.run_to_step_runs, runs_b, runs_e, ver)),
                     ("library", functools.partial(run_to_step_library, torch, runs_b,
                                                   runs_e))):
        got = fn()
        same = (torch.equal(got.reshape(want[0].shape), want[0]) if plan == "library"
                else all(torch.equal(g, w) for g, w in zip(got, want)))
        require(same, f"sweep: run_to_step ({plan}) at W={W} disagrees with its plain "
                      f"version")
        del got
        row = dict(W=W, input="prefixed", kernel="run_to_step", plan=plan,
                   cold_ms=launch_ms(torch, fn, SWEEP_REPS, flush))
        out.append(row)
        log("sweep " + json.dumps(row))
    return out


# `--sweep`'s K2 batches: txns of the stream's mix (2 point reads and 1
# point write a txn over its key pool: R = 2 B, Wn = B), from a few hundred
# (the clusters' batches) to the proxy's cap
SWEEP_K2_TXNS = (64, 512, 2048, 8192, 32768)
SWEEP_K2_REPS = 20


def sweep_k2(torch, fdb, dev, pool, succ) -> list:
    """K2 warm on a stream batch of each SWEEP_K2_TXNS size (no history,
    as phase 3's first batch): the grid plan and kernels.plan_intra's
    plan in turns (grid, planned, planned, grid), then each other cluster
    size that holds the batch once; each bit-exact with the plain
    version, with the same iteration count.  A package from before the
    cluster plan times its own kernel ("before").  Returns the rows."""
    kernels, tdev = fdb["kernels"], fdb["device"]
    rows = []
    for B in SWEEP_K2_TXNS:
        (_v, txns), = stream_batches(fdb["TxInfo"], np.random.default_rng(SEED + B), pool,
                                     succ, 1, txns=B)
        packed = tdev.pack_batch(txns, 0, lambda v: v, SET_ARGS["max_key_bytes"])
        fx = k2_stream_inputs(torch, tdev, dev, packed)
        R, Wn = fx[0].shape[0], fx[2].shape[0]
        want = kernels.intra_fixpoint_plain(*fx)
        if hasattr(kernels, "plan_intra"):
            planned = kernels.plan_intra(R, Wn, B)
            turns = [("grid", kernels.INTRA_GRID_PLAN), ("planned", planned),
                     ("planned", planned), ("grid", kernels.INTRA_GRID_PLAN)]
            turns += [(f"cluster{c}", kernels.plan_intra_cluster(R, Wn, B, c))
                      for c in kernels.INTRA_CLUSTERS if c != planned.cluster
                      and kernels.intra_cluster_bytes(R, Wn, B, c) <= kernels.SMEM_MAX]
        else:
            turns = [("before", None)]
        for name, plan in turns:
            kw = {} if plan is None else {"plan": plan}
            got = kernels.intra_fixpoint(*fx, **kw)
            require(torch.equal(got[0], want[0]) and int(got[1]) == int(want[1]),
                    f"sweep: intra_fixpoint ({name}) at B={B} disagrees with its plain "
                    f"version")
            row = dict(B=B, R=R, Wn=Wn, kernel="intra_fixpoint", plan=name,
                       iterations=int(want[1]),
                       warm_ms=launch_ms(torch, lambda: kernels.intra_fixpoint(*fx, **kw),
                                         SWEEP_K2_REPS))
            if plan is not None:
                row.update(cluster=plan.cluster, smem=plan.smem)
            rows.append(row)
            log("sweep " + json.dumps(row))
    return rows


# `--sweep`'s K5: phase 3's inputs at the stream's shapes, then `prefixed`
# at these widths (the stream's K, run_cap and R)
SWEEP_K5_W = (17, 65)
SWEEP_K5_REPS = 20
# `--sweep`'s referee: a stream batch's reads (R = 16384), and three times
# as many against the same tables (R = 49152)
SWEEP_REFEREE_REPEATS = (1, 3)
SWEEP_REFEREE_REPS = 100
# `--sweep --only`'s parts, in the order they run
SWEEP_PARTS = ("k2", "k5", "referee", "wide", "paths")


def k5_sweep_plans(kernels, K: int, run_cap: int, W: int) -> list:
    """(name, keywords) for each K5 plan the package beside this script
    offers (kernels.probe_tree_plans: "planned" first, then
    "L<levels>_r<reads>_c<cluster>"); a package from before those plans
    times its own kernel, "before"."""
    if not hasattr(kernels, "probe_tree_plans"):
        return [("before", {})]
    return [("planned" if j == 0 else "L{}_r{}_c{}".format(*p), {"plan": p})
            for j, p in enumerate(kernels.probe_tree_plans(K, run_cap, W))]


def sweep_k5(torch, kernels, keys_mod, base: dict, flush) -> list:
    """K5 cold on phase 3's inputs at the stream's shapes ("stream") and on
    `prefixed` at SWEEP_K5_W, under each of k5_sweep_plans, each bit-exact
    with its plain version and, ORed with the history bits, with K1.
    Returns the rows."""
    dev = flush.device
    R = TXNS * READS_PER_TXN
    rows = []
    for W in (None, *SWEEP_K5_W):
        if W is None:
            k1, kind = base["k1"], "stream"
        else:
            cut = wide_cut(W, SET_ARGS["run_capacity"], SET_ARGS["capacity"], R)
            k1, _ks, _rec = wide_inputs(torch, keys_mod, kernels, "prefixed", W, dev, base, cut)
            kind = "prefixed"
            del _ks, _rec
        k5 = k1[:7]
        want, fused = kernels.run_conflicts_plain(*k5), kernels.probe_fused(*k1)
        for name, kw in k5_sweep_plans(kernels, *k5[4].shape):
            got = kernels.run_conflicts(*k5, **kw)
            require(torch.equal(got, want) and torch.equal(got | k1[7], fused),
                    f"sweep: probe ({name}) at W={k5[0].shape[1]} on {kind} disagrees with "
                    f"its plain version or with K1")
            row = dict(W=k5[0].shape[1], input=kind, kernel="probe", plan=name,
                       cold_ms=launch_ms(torch, lambda: kernels.run_conflicts(*k5, **kw),
                                         SWEEP_K5_REPS, flush),
                       **(kw["plan"]._asdict() if kw else {}))
            rows.append(row)
            log("sweep " + json.dumps(row))
        del k1, k5, want, fused
    return rows


def sweep_referee(torch, fdb, dev, pool, succ) -> list:
    """The per-query referee of the package beside this script, warm, on
    the tables of a stream batch's first fixpoint iteration
    (referee_inputs), its reads repeated by each of SWEEP_REFEREE_REPEATS,
    each bit-exact with its plain version.  Returns the rows."""
    kernels, tdev = fdb["kernels"], fdb["device"]
    (_v, txns), = stream_batches(fdb["TxInfo"], np.random.default_rng(SEED + 7), pool,
                                 succ, 1)
    packed = tdev.pack_batch(txns, 0, lambda v: v, SET_ARGS["max_key_bytes"])
    beg_tab, stab, rb_r, re_r = referee_inputs(torch, fdb, dev, packed)
    rows = []
    for times in SWEEP_REFEREE_REPEATS:
        k2 = (beg_tab, stab, rb_r.repeat(times), re_r.repeat(times))
        R = k2[2].shape[0]
        require(torch.equal(kernels.intra_query(*k2), kernels.intra_query_plain(*k2)),
                f"sweep: intra_query at R={R} disagrees with its plain version")
        row = dict(R=R, kernel="intra_query",
                   warm_ms=launch_ms(torch, lambda: kernels.intra_query(*k2),
                                     SWEEP_REFEREE_REPS))
        rows.append(row)
        log("sweep " + json.dumps(row))
    return rows


def kernel_event_ms(torch, kernels, fn) -> dict:
    """Runs fn with K1's, K3's and K4's wrappers timed launch by launch: a
    CUDA event pair around each (behind a ~0.1 ms device spin, so the pair
    times the device's work, not the host's).  Returns their device ms and
    launches in fn, by wrapper.  (The profiler's trace of phase 19 (a),
    with its 2049-pass sorts, takes longer to read back than the run.)"""
    pairs = {"probe_fused": [], "compact_ranks": [], "run_to_step_runs": []}
    real = [(name, getattr(kernels, name)) for name in pairs]

    def timed(*a, _inner, _name, **k):
        torch.cuda._sleep(SPIN_CYCLES)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = _inner(*a, **k)
        stop.record()
        pairs[_name].append((start, stop))
        return out

    for name, inner in real:
        setattr(kernels, name, functools.partial(timed, _inner=inner, _name=name))
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for name, inner in real:
            setattr(kernels, name, inner)
    return {name: dict(ms=sum(a.elapsed_time(b) for a, b in got), launches=len(got))
            for name, got in pairs.items()}


def sweep(torch, fdb, dev, power, out: Path, parts=SWEEP_PARTS) -> None:
    """The parts of SWEEP_PARTS named in `parts`, in that order: "k2", K2
    warm under its plans at each SWEEP_K2_TXNS (sweep_k2); "k5", K5 cold
    under each plan (sweep_k5); "referee", the per-query referee warm
    (sweep_referee); "wide", K1, K3 and K4 cold at every SWEEP_W:
    K1 and K3 on both of phase 3's wide inputs (kernel_inputs from SEED)
    under each of sweep_variants' plans, K4 on `prefixed` beside its
    torch.stack yardstick (sweep_k4), each bit-exact with its plain version;
    "paths", phase 18 (b)'s and phase 19 (a)'s runs with K1's, K3's and
    K4's device ms (kernel_event_ms).  Writes the measurements to `out` as
    JSON."""
    keys_mod, kernels = fdb["keys"], fdb["kernels"]
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    pool, succ = key_pool(rng)
    base = kernel_inputs(torch, keys_mod, dev, rng, pool, succ)
    log(f"sweep: inputs at {time.perf_counter() - t0:.1f} s")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    rows = []
    for part, run in (("k2", lambda: sweep_k2(torch, fdb, dev, pool, succ)),
                      ("k5", lambda: sweep_k5(torch, kernels, keys_mod, base, flush)),
                      ("referee", lambda: sweep_referee(torch, fdb, dev, pool, succ))):
        if part in parts:
            rows += run()
            log(f"sweep: {part} done at {time.perf_counter() - t0:.1f} s")
    for W in SWEEP_W if "wide" in parts else ():
        cut = wide_cut(W, SET_ARGS["run_capacity"], SET_ARGS["capacity"],
                       TXNS * READS_PER_TXN)
        for kind in WIDE_INPUTS:
            torch.cuda.empty_cache()
            k1w, ks_w, rec_w = wide_inputs(torch, keys_mod, kernels, kind, W, dev, base, cut)
            want = {"probe_fused": kernels.probe_fused_plain(*k1w),
                    "compact_ranks": kernels.compact_ranks_plain(ks_w, rec_w)}
            for plan, kw1, kw3 in sweep_variants(kernels, SET_ARGS["run_slots"], cut[0], W):
                for name, kw, fn in (
                        ("probe_fused", kw1, lambda kw: kernels.probe_fused(*k1w, **kw)),
                        ("compact_ranks", kw3,
                         lambda kw: kernels.compact_ranks(ks_w, rec_w, **kw))):
                    if kw is None:
                        continue
                    require(torch.equal(fn(kw), want[name]),
                            f"sweep: {name} ({plan} plan) at W={W} on {kind} disagrees "
                            f"with its plain version")
                    row = dict(W=W, input=kind, kernel=name, plan=plan,
                               cold_ms=launch_ms(torch, lambda: fn(kw), SWEEP_REPS, flush))
                    rows.append(row)
                    log("sweep " + json.dumps(row))
            del k1w, ks_w, rec_w, want
        torch.cuda.empty_cache()
        rows += sweep_k4(torch, kernels, keys_mod, base, W, cut[0], flush)
        log(f"sweep: W={W} done at {time.perf_counter() - t0:.1f} s")
    runs = {}
    for path, run in (("long_keys", lambda: long_key_run(torch, fdb, *LONG_RUN)),
                      ("long_keys_16k", lambda: repro_part(torch, fdb, power))
                      ) if "paths" in parts else ():
        runs[path] = kernel_event_ms(torch, kernels, run)
        log(f"sweep {path}: K1, K3 and K4 device ms (event pairs) {json.dumps(runs[path])} "
            f"at {time.perf_counter() - t0:.1f} s")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(power=power, rows=rows, paths=runs), indent=1))
    log(f"sweep: written to {out}")


def wide_entries(results: dict, k: str) -> dict:
    """Phase 3's numbers of wide kernel k for the kernels line: by W, and
    for K1 and K3 by input ("W=129" the prefixed input, "W=129 widened"),
    each with the CUDA kernel its plan launched."""
    inputs = WIDE_INPUTS if k in WIDE_SYMBOLS else ("prefixed",)
    out = {}
    for w in WIDE_W:
        for kind in inputs:
            r = results[f"{k}_w{w}" + ("" if kind == "prefixed" else f"_{kind}")]
            out[f"W={w}" + ("" if kind == "prefixed" else f" {kind}")] = {
                key: r[key] for key in ("symbol", *WIDE_TIMED, "max_abs_err", "plan")
                if key in r}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sweep", metavar="OUT",
                        help="only time K2 at SWEEP_K2_TXNS, K5 and the per-query "
                             "referee, K1 and K3 at SWEEP_W under every plan the "
                             "package offers and K4 beside torch.stack, and write the "
                             "numbers to OUT (JSON)")
    parser.add_argument("--only", default=",".join(SWEEP_PARTS),
                        help="with --sweep, the parts to run, comma-separated, of "
                             + ", ".join(SWEEP_PARTS) + " (default: all)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "foundationdb_tpu_torch").is_dir():
        print("chip_smoke: the foundationdb_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    fdb = port_modules()
    _build, kernels, keys = fdb["build"], fdb["kernels"], fdb["keys"]
    device, TxInfo = fdb["device"], fdb["TxInfo"]
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    power = card_power_line()
    log(f"device: {name} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(f"nvidia-smi: {power}")

    t = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t:.1f} s")
    if args.sweep:
        parts = tuple(args.only.split(","))
        require(set(parts) <= set(SWEEP_PARTS), f"--only takes parts of {SWEEP_PARTS}")
        sweep(torch, fdb, dev, power, Path(args.sweep), parts)
        log(f"sweep: {time.perf_counter() - t_start:.1f} s on {power}")
        return 0
    W = keys.num_words(SET_ARGS["max_key_bytes"])

    def smem_at(W):
        rows = wide_cut(W, SET_ARGS["run_capacity"], SET_ARGS["capacity"], 0)[0]
        p1 = kernels.plan_probe(SET_ARGS["run_slots"], rows, W)
        p3 = kernels.plan_ranks(W)
        return {planned_symbol("probe_fused", p1): p1.smem,
                planned_symbol("compact_ranks", p3): p3.smem}

    smem = {w: smem_at(w) for w in (W, *WIDE_W)}
    k2_plan = kernels.plan_intra(TXNS * READS_PER_TXN, TXNS, TXNS)  # the stream's batch
    smem[W][planned_symbol("intra_fixpoint", k2_plan)] = k2_plan.smem
    k5_plan = kernels.plan_probe_tree(SET_ARGS["run_slots"], SET_ARGS["run_capacity"], W)
    smem[W][SYMBOLS["probe"]] = kernels.probe_tree_bytes(k5_plan.levels, W)
    symbols = (*SYMBOLS.values(), *WIDE_SYMBOLS.values(), CLUSTER_SYMBOL)
    entry = None
    for line in _build.ptxas_report().splitlines():
        if "Compiling entry function" in line:
            entry = next((s for s in symbols if s in line), None)
        if "ptxas" in line or "Used" in line or "spill" in line:
            at = {w: m[entry] for w, m in smem.items() if entry in m}
            extra = ("  [+ dynamic shared memory per block: " + ", ".join(
                f"{b} B at W={w}" for w, b in at.items()) + "]"
                if at and "Used" in line else "")
            log("  " + line.strip() + extra)
    if k2_plan.cluster:
        log(f"occupancy: {CLUSTER_SYMBOL} at the stream's batch: "
            f"{kernels.intra_cluster_occupancy(dev.index or 0, k2_plan)} clusters of "
            f"{k2_plan.cluster} blocks of {kernels.INTRA_THREADS} threads at once "
            f"({k2_plan.smem} B shared a block)")
    log(f"occupancy: {SYMBOLS['probe']} at the stream's shapes: "
        f"{kernels.probe_tree_occupancy(dev.index or 0, k5_plan, W)} clusters of "
        f"{k5_plan.cluster} blocks of {k5_plan.reads} threads at once "
        f"({kernels.probe_tree_bytes(k5_plan.levels, W)} B shared a block, plan "
        f"{k5_plan._asdict()})")
    for w in WIDE_W:
        p1 = kernels.plan_probe(SET_ARGS["run_slots"], wide_cut(
            w, SET_ARGS["run_capacity"], SET_ARGS["capacity"], 0)[0], w)
        if p1.warp:
            log(f"occupancy at W={w}: {WIDE_SYMBOLS['probe_fused']} "
                f"{kernels.warp_plan_occupancy('probe_fused', p1)} blocks of "
                f"{p1.threads} threads an SM ({p1.smem} B shared); "
                f"{WIDE_SYMBOLS['compact_ranks']} "
                f"{kernels.warp_plan_occupancy('compact_ranks', kernels.plan_ranks(w))} "
                f"blocks of {32 * kernels.WARP_BLOCK_WARPS} threads an SM")

    rng = np.random.default_rng(SEED)
    pool, succ = key_pool(rng)
    t = time.perf_counter()
    n_stream = PREFILL_BATCHES + TIMED_BATCHES
    batches = stream_batches(TxInfo, rng, pool, succ, n_stream + PROFILED_BATCHES)
    stream, extra = batches[:n_stream], batches[n_stream:]
    log(f"stream data: {time.perf_counter() - t:.1f} s")
    first = device.pack_batch(batches[0][1], 0, lambda v: v,
                              SET_ARGS["max_key_bytes"])

    t = time.perf_counter()
    results = kernel_phase(torch, fdb, dev, rng, pool, succ, first)
    log(f"kernels phase: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    launches, on_gpu, flat_verdicts, flat_iters = stream_phase(torch, fdb, stream, power)
    log(f"stream phase: {time.perf_counter() - t:.1f} s")
    profile_phase(torch, fdb, on_gpu, extra, power)

    t = time.perf_counter()
    runs = best_known_phase(torch, fdb, stream, flat_verdicts, flat_iters, power)
    referee_launches = referee_phase(torch, fdb, runs["sync"][0], *extra[0])
    best_known_profile(torch, fdb, runs, extra, n_stream + 1, power)
    log(f"best-known phase: {time.perf_counter() - t:.1f} s")
    log("best-known summary " + json.dumps(
        {mode: m for mode, (_cs, _l, m) in runs.items()}))

    t = time.perf_counter()
    recovery_drill(fdb)
    oracle_stream = oracle_batches(TxInfo, np.random.default_rng(SEED + 1))
    oracle_phase(fdb, oracle_stream)
    log(f"recovery + oracle phases: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    supervised = supervised_phase(torch, fdb, stream, flat_verdicts, power)
    supervised["drill"] = drill_phase(torch, fdb, stream, flat_verdicts, power)
    supervised["watchdog"] = watchdog_phase(torch, fdb, stream, flat_verdicts)
    log(f"supervised phase: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    bench_launches, series_launches = bench_phase(fdb, power)
    log(f"bench phase: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    new_paths = legacy_phase(torch, fdb, stream, flat_verdicts, power)
    log(f"legacy phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    new_paths.update(timing_phase(torch, fdb, stream, flat_verdicts, power))
    log(f"phase-timing phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    single = dict(runs["sync"][2]["turns"][0],
                  launches_per_batch=runs["sync"][2].get("launches_per_batch"))
    new_paths.update(sharded_phase(torch, fdb, stream, extra, pool, oracle_stream,
                                   single, power))
    log(f"sharded phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    new_paths.update(role_phase(torch, fdb, stream, extra, single, power))
    log(f"role phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    new_paths.update(cluster_phase(torch, fdb, power))
    log(f"cluster phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    new_paths.update(durable_phase(torch, fdb, power))
    log(f"durable phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    new_paths.update(backup_phase(torch, fdb, power))
    log(f"backup phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    new_paths.update(corpus_phase(torch, fdb, power))
    log(f"corpus phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    new_paths.update(served_phase(torch, fdb, power))
    log(f"served phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    new_paths.update(supervised_cluster_phase(torch, fdb, power))
    log(f"supervised cluster phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    new_paths.update(root_scripts_phase(torch, fdb, power))
    log(f"root scripts phase: {time.perf_counter() - t:.1f} s")

    log(f"total: {time.perf_counter() - t_start:.1f} s on {power}")
    by_path = {"flat": launches, "referee": referee_launches}
    by_path.update({f"best_{mode}": l for mode, (_cs, l, _m) in runs.items()})
    by_path.update(supervised, bench=bench_launches, bench_metrics_series=series_launches)
    by_path.update(new_paths)
    path_launches = dict(launches, **referee_launches)
    log("K2 launches by plan, by path: " + json.dumps(
        {p: k2_plans(n) for p, n in by_path.items()}))
    timed = WIDE_TIMED
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=SOURCE, replaces=where,
             launches=path_launches[k], max_abs_err=results[k]["max_abs_err"],
             **{key: results[k][key] for key in timed},
             launches_by_path={p: n.get(k, 0) for p, n in by_path.items()},
             **({"launches_by_plan": {p: k2_plans(n) for p, n in by_path.items()},
                 **{key: results[k][key] for key in ("plan", "cluster", "smem",
                                                     "us_per_iteration", "grid_ms")}}
                if k == "intra_fixpoint" else {}),
             **({key: results[k][key] for key in ("plan", "floor_ms") if key in results[k]}
                if k in ("probe", "intra_query") else {}),
             **({"wide": wide_entries(results, k)} if k in WIDE_KERNELS else {}))
        for k, where, _symbol in KERNELS
    ]}))
    print(power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
