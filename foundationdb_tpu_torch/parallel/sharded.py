"""Multi-resolver conflict resolution: the key space split into partitions.

Port of foundationdb_tpu/parallel/sharded.py.  FoundationDB scales OCC by
splitting the key space into contiguous partitions, one per Resolver: the
proxy sends each transaction's conflict ranges to the resolvers whose
partition they meet (MasterProxyServer.actor.cpp:280-320) and merges their
verdicts with min() (:558-569).  Each resolver decides from its own
partition alone and inserts the writes of the transactions it judged
committed, even where another resolver aborts them (a false positive the
design accepts).  So the verdicts of a sharded set may differ from a single
set's; they equal N partition oracles merged with min.

Partition p owns keys [split[p-1], split[p]) and keeps its own state (the
single set's layouts, conflict/device.py) on one device: `devices=None`
puts every partition on the default CUDA card, a list puts partition p on
devices[p % len(devices)].  One process drives them all, as the
reference's mesh is one process.  Per batch:

  - the packed batch is staged once on each device that holds a partition;
  - each partition clips every range to itself (`_clip_ranges`; a range
    that misses it becomes a sentinel row with tx = -1) and runs the port's
    own resolve_core_inc / resolve_core_inc_lsm / resolve_core /
    resolve_core_lsm on its state, so every kernel of that path launches
    once per partition;
  - the verdicts fold with torch.minimum on the first partition's device
    (CONFLICT=0 < TOO_OLD=1 < COMMITTED=2, the order the min relies on),
    and so do the search-convergence and capacity flags and the fixpoint's
    iteration counts: nothing is read on the host per partition.

Capacity is shared: when any partition outgrows its main level, its recent
level or its runs, all of them grow together, and a failed convergence on
any partition replays the whole batch at full search depth.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from .. import keys as keymod
from ..keys import SENT_LANE, from_lanes, to_lanes
from ..ops.rmq import _levels, build_sparse_table
from ..ops.search import lex_less
from ..conflict import kernels
from ..conflict.api import ConflictSet, KernelStats, TxInfo, Verdict, validate_batch
from ..conflict.device import (
    FAST_SEARCH_ITERS,
    MERGE_IMPLS,
    SEARCH_IMPLS,
    _bucket,
    _check_choice,
    _check_flag,
    _rebuild_buckets,
    compact_lsm,
    pack_batch,
    resolve_core,
    resolve_core_inc,
    resolve_core_inc_lsm,
    resolve_core_lsm,
    resolve_device,
    stage_batch,
)
from ..conflict.pipeline import PipelinedConflictMixin


def _lex_max(a, b):
    """Rowwise lexicographic max of int32[..., W] lane rows."""
    return torch.where(lex_less(a, b)[..., None], b, a)


def _lex_min(a, b):
    return torch.where(lex_less(b, a)[..., None], b, a)


def _clip_ranges(b, e, tx, lo_row, hi_row):
    """Clip ranges [b, e) to the partition [lo_row, hi_row); ranges that
    miss it become sentinel rows with tx = -1 (only intersecting ranges
    reach a resolver)."""
    cb = _lex_max(b, lo_row[None, :])
    ce = _lex_min(e, hi_row[None, :])
    live = lex_less(cb, ce) & (tx >= 0)
    return (torch.where(live[:, None], cb, SENT_LANE),
            torch.where(live[:, None], ce, SENT_LANE),
            torch.where(live, tx, -1))


class ShardedDeviceConflictSet(PipelinedConflictMixin, ConflictSet):
    """Key-partitioned ConflictSet: `len(split_keys) + 1` partitions, the
    split points fixed at construction (rebalancing means a new instance,
    as resolver state does not survive a generation change).

    The keywords and their defaults are the reference's, with no
    environment read; `devices` places the partitions (module docstring).
    Shares the single set's input pipeline (conflict/pipeline.py): one
    bulk pack a batch feeds every partition, and resolve_deferred gives
    the split-phase dispatch with the same snapshot/replay recovery.  Each
    partition's state is a tuple entry, rebound (never written in place)
    on every update, so a snapshot can be a dict of references."""

    _PIPELINE_SNAPSHOT_ATTRS = (
        "_ks", "_vs", "_bidx", "_counts", "_counts_ub", "_dev_counts",
        "_dev_ok", "_pipelined_since_check", "_last_commit", "_base",
        "_oldest", "_cap", "_tab", "_rec_ks", "_rec_vs", "_rec_bidx",
        "_rec_counts", "_rec_dev_counts", "_rec_counts_ub", "_rec_cap",
        "_runs_b", "_runs_e", "_runs_ver", "_n_runs", "_run_cap",
    )

    def __init__(
        self,
        split_keys: Sequence[bytes],
        oldest_version: int = 0,
        *,
        max_key_bytes: int = keymod.DEFAULT_MAX_KEY_BYTES,
        capacity: int = 1 << 14,
        merge_impl: str = "scatter",
        search_impl: str = "sort",
        lsm: bool = False,
        recent_capacity: int = 1 << 12,  # LSM recent level per partition
        incremental: bool = True,
        run_slots: int = 8,              # K: per-partition run slots
        run_capacity: int = 1 << 10,     # per-run interval capacity
        rec_search_iters: int = FAST_SEARCH_ITERS,
        devices=None,
    ) -> None:
        _check_choice("search_impl", search_impl, SEARCH_IMPLS)
        _check_choice("merge_impl", merge_impl, MERGE_IMPLS)
        _check_flag("lsm", lsm)
        _check_flag("incremental", incremental)
        split_keys = list(split_keys)
        if list(split_keys) != sorted(split_keys) or len(set(split_keys)) != len(split_keys):
            raise ValueError("split keys must be strictly increasing")
        n = len(split_keys) + 1
        placed = [None] if devices is None else list(devices)
        if not placed:
            raise ValueError("devices must name at least one device")
        self._devs = [resolve_device(placed[p % len(placed)]) for p in range(n)]
        self.device = self._devs[0]  # where verdicts and flags fold
        self._n = n
        self._merge_impl = merge_impl
        self._search_impl = search_impl
        self._lsm = bool(lsm)
        self._incremental = bool(incremental)
        self._rec_iters = max(1, min(int(rec_search_iters), 32))
        self._K = run_slots
        self._max_key_bytes = max_key_bytes
        self._W = keymod.num_words(max_key_bytes)
        self._base = oldest_version
        self._oldest = oldest_version
        self._last_commit = oldest_version
        self.compactions = 0
        self.search_fallbacks = 0
        self.regrows = 0
        self.host_syncs = 0
        self.stats = KernelStats(backend=f"sharded-{self.device.type}")
        self.stats.merge_impl = merge_impl
        self._intra_iters = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._dev_ok = torch.ones((), dtype=torch.bool, device=self.device)
        self._pipelined_since_check = 0
        self._pipeline_init()

        lo = keymod.encode_keys([b""] + split_keys, max_key_bytes)
        hi = np.empty_like(lo)
        hi[:-1] = lo[1:]
        hi[-1] = keymod.sentinel(max_key_bytes)
        self._np_lo = lo
        self._lo = tuple(to_lanes(lo[p:p + 1], d)[0] for p, d in enumerate(self._devs))
        self._hi = tuple(to_lanes(hi[p:p + 1], d)[0] for p, d in enumerate(self._devs))
        self._init_state(capacity)
        self._rec_cap = recent_capacity
        self._rec_ks = self._rec_vs = self._rec_bidx = self._rec_dev_counts = None
        self._rec_counts = self._rec_counts_ub = None
        if self._lsm:
            self._init_recent()
        self._runs_b = self._runs_e = self._runs_ver = None
        self._n_runs = 0
        self._run_cap = run_capacity
        if self._incremental:
            self._init_runs(run_capacity)

    # -- state ---------------------------------------------------------------
    def _floors(self, rows: int) -> tuple:
        """Per partition: `rows` sentinel rows but the first, its floor key."""
        out = []
        for p, d in enumerate(self._devs):
            k = np.full((rows, self._W), np.uint32(0xFFFFFFFF), dtype=np.uint32)
            k[0] = self._np_lo[p]
            out.append(to_lanes(k, d))
        return tuple(out)

    def _zeros(self, *shape) -> tuple:
        return tuple(torch.zeros(shape, dtype=torch.int32, device=d) for d in self._devs)

    def _init_state(self, capacity: int) -> None:
        self._cap = capacity
        self._ks = self._floors(capacity)
        self._vs = self._zeros(capacity)
        # the live counts: `_counts` on the host, or, while a legacy
        # pipelined stream is undrained, None and `_dev_counts` per partition
        self._counts = np.ones(self._n, dtype=np.int64)
        self._counts_ub = self._counts.copy()
        self._dev_counts = None
        self._bidx = tuple(_rebuild_buckets(k) for k in self._ks)
        self._tab = self._tables()

    def _tables(self):
        """The LSM layout's cached range-max table of each main level."""
        if not self._lsm:
            return None
        return tuple(build_sparse_table(v, torch.maximum, 0) for v in self._vs)

    def _init_recent(self) -> None:
        self._rec_ks = self._floors(self._rec_cap)
        self._rec_vs = self._zeros(self._rec_cap)
        self._rec_bidx = tuple(_rebuild_buckets(k) for k in self._rec_ks)
        self._rec_counts = np.ones(self._n, dtype=np.int64)
        self._rec_counts_ub = self._rec_counts.copy()
        self._rec_dev_counts = None

    def _init_runs(self, run_cap: int) -> None:
        run_cap = _bucket(run_cap)  # the kernels' stride math wants 2**k
        self._run_cap = run_cap
        shape = (self._K, run_cap, self._W)
        self._runs_b = tuple(torch.full(shape, SENT_LANE, dtype=torch.int32, device=d)
                             for d in self._devs)
        self._runs_e = tuple(torch.full(shape, SENT_LANE, dtype=torch.int32, device=d)
                             for d in self._devs)
        self._runs_ver = self._zeros(self._K)
        self._n_runs = 0

    @staticmethod
    def _padded(parts, rows: int, fill) -> tuple:
        """Each partition's tensor padded along its first axis to `rows`."""
        out = []
        for t in parts:
            g = torch.full((rows,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                           device=t.device)
            g[: t.shape[0]] = t
            out.append(g)
        return tuple(out)

    def _grow_runs(self, new_cap: int) -> None:
        """Sentinel-pad every run slot of every partition to new_cap."""
        def grow(runs):
            g = torch.full((self._K, new_cap, self._W), SENT_LANE,
                           dtype=torch.int32, device=runs.device)
            g[:, : runs.shape[1]] = runs
            return g

        self._runs_b = tuple(grow(r) for r in self._runs_b)
        self._runs_e = tuple(grow(r) for r in self._runs_e)
        self._run_cap = new_cap

    def _grow_recent(self, new_rec_cap: int) -> None:
        """Sentinel-pad every recent level (no fold, no main-level work)."""
        self._rec_cap = new_rec_cap
        self._rec_ks = self._padded(self._rec_ks, new_rec_cap, SENT_LANE)
        self._rec_vs = self._padded(self._rec_vs, new_rec_cap, 0)
        self._rec_bidx = tuple(_rebuild_buckets(k) for k in self._rec_ks)

    def _grow_main(self, new_cap: int) -> None:
        """Pad every main level to new_cap and rebuild its bucket index."""
        self.regrows += 1
        self._cap = new_cap
        self._ks = self._padded(self._ks, new_cap, SENT_LANE)
        self._vs = self._padded(self._vs, new_cap, 0)
        self._bidx = tuple(_rebuild_buckets(k) for k in self._ks)

    def export_state(self) -> dict:
        """Every partition's state stacked on a leading axis, in the
        reference's [n, ...] layout with uint32 keys: the runs only on the
        incremental path, `tab` and the recent level only for the LSM
        layout.  Fresh arrays: nothing aliases the live tensors."""
        def stack(parts, keys=False):
            return np.stack([from_lanes(t) if keys else t.cpu().numpy() for t in parts])

        out = {"ks": stack(self._ks, True), "vs": stack(self._vs),
               "bidx": stack(self._bidx), "counts": self._host_counts().copy(),
               "cap": self._cap, "base": self._base, "oldest": self._oldest,
               "last_commit": self._last_commit, "merge_impl": self._merge_impl}
        if self._incremental:
            out.update(runs_b=stack(self._runs_b, True),
                       runs_e=stack(self._runs_e, True),
                       runs_ver=stack(self._runs_ver), n_runs=self._n_runs,
                       run_cap=self._run_cap, K=self._K)
        if self._lsm:
            out.update(tab=stack(self._tab), rec_ks=stack(self._rec_ks, True),
                       rec_vs=stack(self._rec_vs), rec_bidx=stack(self._rec_bidx),
                       rec_counts=self._host_rec_counts().copy(),
                       rec_cap=self._rec_cap)
        return out

    def load_state(self, d: dict) -> None:
        """Adopt a state exported by `export_state` — or stacked from the
        reference set's arrays — and continue from it.  tab is rebuilt from
        vs; bidx and rec_bidx are adopted when given (the sort search
        leaves them as they were), else rebuilt."""
        self._drain_all()
        ks = np.asarray(d["ks"], dtype=np.uint32)
        if ks.shape != (self._n, int(d["cap"]), self._W):
            raise ValueError(f"state of shape {ks.shape} does not fit {self._n} "
                             f"partitions of key width {self._W}")
        merge_impl = d.get("merge_impl", self._merge_impl)
        _check_choice("merge_impl", merge_impl, MERGE_IMPLS)
        self._merge_impl = self.stats.merge_impl = str(merge_impl)

        def put(a, keys=False):
            a = np.asarray(a)
            return tuple(to_lanes(a[p], dv) if keys else
                         torch.from_numpy(np.array(a[p], dtype=np.int32)).to(dv)
                         for p, dv in enumerate(self._devs))

        self._cap = int(d["cap"])
        self._ks, self._vs = put(ks, True), put(d["vs"])
        self._bidx = (put(d["bidx"]) if "bidx" in d
                      else tuple(_rebuild_buckets(k) for k in self._ks))
        self._tab = self._tables()
        self._counts = np.asarray(d["counts"], dtype=np.int64).copy()
        self._counts_ub = self._counts.copy()
        self._dev_counts = None
        for key in ("base", "oldest", "last_commit"):
            setattr(self, "_" + key, int(d[key]))
        if self._incremental:
            self._K, self._run_cap = int(d["K"]), int(d["run_cap"])
            self._runs_b, self._runs_e = put(d["runs_b"], True), put(d["runs_e"], True)
            self._runs_ver = put(d["runs_ver"])
            self._n_runs = int(d["n_runs"])
        if self._lsm:
            self._rec_cap = int(d["rec_cap"])
            self._rec_ks, self._rec_vs = put(d["rec_ks"], True), put(d["rec_vs"])
            self._rec_bidx = (put(d["rec_bidx"]) if "rec_bidx" in d
                              else tuple(_rebuild_buckets(k) for k in self._rec_ks))
            self._rec_counts = np.asarray(d["rec_counts"], dtype=np.int64).copy()
            self._rec_counts_ub = self._rec_counts.copy()
            self._rec_dev_counts = None

    # -- host reads ------------------------------------------------------------
    def _host_bool(self, t: torch.Tensor) -> bool:
        self.host_syncs += 1
        return bool(t)

    def _host_numpy(self, t: torch.Tensor) -> np.ndarray:
        self.host_syncs += 1
        return t.cpu().numpy()

    def _gather(self, parts) -> torch.Tensor:
        """Per-partition device scalars as one int64[n] on the first device."""
        return torch.stack([t.to(self.device, torch.int64).reshape(()) for t in parts])

    def _host_counts(self) -> np.ndarray:
        if self._counts is None:
            self._counts = self._host_numpy(self._gather(self._dev_counts))
        return self._counts

    def _host_rec_counts(self) -> np.ndarray:
        if self._rec_counts is None:
            self._rec_counts = self._host_numpy(self._gather(self._rec_dev_counts))
        return self._rec_counts

    def _count(self, p: int):
        return self._dev_counts[p] if self._counts is None else int(self._counts[p])

    def _rec_count(self, p: int):
        return (self._rec_dev_counts[p] if self._rec_counts is None
                else int(self._rec_counts[p]))

    @property
    def oldest_version(self) -> int:
        return self._oldest

    @property
    def capacity(self) -> int:
        return self._cap

    def healthcheck(self) -> bool:
        """One tiny host<->device round trip through every partition."""
        return all(int(v[:1].sum()) >= 0 for v in self._vs)

    def fixpoint_iterations(self) -> int:
        """The intra fixpoint's iterations summed over every partition and
        resolve so far: one read on the host."""
        self.host_syncs += 1
        return int(self._intra_iters)

    def _offset(self, version: int) -> int:
        off = version - self._base
        if off >= 2**31 - 2**24:
            raise OverflowError("version offset overflow; call remove_before")
        return max(off, 0)

    def _offset_array(self, versions: np.ndarray) -> np.ndarray:
        off = np.asarray(versions, dtype=np.int64) - self._base
        if off.size and int(off.max()) >= 2**31 - 2**24:
            raise OverflowError("version offset overflow; call remove_before")
        return np.maximum(off, 0)

    # -- resolve -------------------------------------------------------------
    def resolve_batch(self, commit_version: int, txns: Sequence[TxInfo]) -> list[Verdict]:
        self._drain_all()  # settle any deferred window before sync work
        validate_batch(commit_version, txns, self._oldest)
        if commit_version <= self._last_commit:
            raise ValueError(
                f"commit_version {commit_version} not after last batch {self._last_commit}"
            )
        B = len(txns)
        if B == 0:
            self._last_commit = commit_version
            return []
        t_pack = time.perf_counter()
        packed = pack_batch(
            txns, self._oldest, self._offset, self._max_key_bytes,
            arena=self._arena, stats=self.stats,
            offset_array=self._offset_array,
        )
        self.stats.pack_s += time.perf_counter() - t_pack
        codes = self.resolve_arrays(commit_version, *packed[:8])
        return [Verdict(int(c)) for c in codes[:B]]

    def _stage(self, batch) -> list:
        """The batch on every partition's device, staged once a device: a
        numpy batch in one copy each, a tensor batch copied over."""
        staged = {}
        for d in self._devs:
            if d not in staged:
                if isinstance(batch[2], np.ndarray):
                    staged[d] = stage_batch(d, *batch)
                else:
                    staged[d] = tuple(t.to(d) for t in batch)
        return [staged[d] for d in self._devs]

    def _clipped(self, p: int, batch) -> tuple:
        rb, re_, r_tx, wb, we, w_tx, snap, active = batch
        lo, hi = self._lo[p], self._hi[p]
        return (*_clip_ranges(rb, re_, r_tx, lo, hi),
                *_clip_ranges(wb, we, w_tx, lo, hi), snap, active)

    def _fold(self, outs, conv_at: int, iters_at: int):
        """The partitions' verdicts min-combined, their convergence flags
        ANDed (None for the sort search) and their fixpoint iterations
        summed, all on the first device."""
        dev = self.device
        verdict = outs[0][0]
        for o in outs[1:]:
            verdict = torch.minimum(verdict, o[0].to(dev))
        conv = None
        if outs[0][conv_at] is not None:
            conv = outs[0][conv_at]
            for o in outs[1:]:
                conv = conv & o[conv_at].to(dev)
        self._intra_iters = self._intra_iters + sum(o[iters_at].to(dev) for o in outs)
        return verdict, conv

    def _fits(self, counts, cap: int) -> torch.Tensor:
        return torch.all(self._gather(counts) <= cap)

    def resolve_arrays(
        self, commit_version: int, rbv, rev, rtv, wbv, wev, wtv, snap_p, active_p,
        sync: bool = True,
    ):
        """Packed fast path, as DeviceConflictSet.resolve_arrays: numpy in
        pack_batch's layout, or tensors on the first partition's device.

        sync=True: returns the verdicts as numpy, after the full-depth
        replay of a search that did not converge on some partition and the
        regrow (flat) or compaction (LSM) of a merge that outgrew a level.

        sync=False: PIPELINED — dispatches and returns the verdicts as a
        device tensor; the partitions' convergence (and, legacy, capacity)
        folds into one device flag that check_pipelined() reads."""
        if sync and self._inflight:
            self._drain_all()
        if commit_version <= self._last_commit:
            raise ValueError(
                f"commit_version {commit_version} not after last batch {self._last_commit}"
            )
        Wn = wbv.shape[0]
        commit_off = self._offset(commit_version)
        if self._incremental:
            if 2 * Wn > self._run_cap:
                # every partition sees the whole batch, clipped
                self._grow_runs(_bucket(2 * Wn))
            if self._n_runs >= self._K:
                self._compact_runs()
        elif self._lsm:
            if 2 * Wn + 1 > self._rec_cap:
                self._grow_recent(_bucket(4 * Wn + 2))
            if self._rec_counts_ub.max() + 2 * Wn > self._rec_cap:
                # the bound is conservative: read the exact counts first
                self.check_pipelined()
                if self._rec_counts_ub.max() + 2 * Wn > self._rec_cap:
                    self._compact()
        elif not sync and self._counts_ub.max() + 2 * Wn > self._cap:
            self.check_pipelined()
            if self._counts_ub.max() + 2 * Wn > self._cap:
                v = self.resolve_arrays(commit_version, rbv, rev, rtv, wbv, wev,
                                        wtv, snap_p, active_p)
                return torch.from_numpy(v).to(self.device)
        batches = self._stage((rbv, rev, rtv, wbv, wev, wtv, snap_p, active_p))
        resolve = (self._resolve_inc if self._incremental
                   else self._resolve_lsm if self._lsm else self._resolve_flat)
        verdict, ok = resolve(batches, commit_off, Wn, sync)
        self._last_commit = commit_version
        if not sync:
            if ok is not None:
                self._dev_ok = self._dev_ok & ok
            self._pipelined_since_check += 1
            return verdict
        return self._host_numpy(verdict)

    def _resolve_inc(self, batches, commit_off: int, Wn: int, sync: bool):
        """Each partition appends its clipped committed union as run
        `_n_runs`.  Returns (verdict, the pipelined validity or None)."""
        core = resolve_core_inc_lsm if self._lsm else resolve_core_inc
        hist = self._tab if self._lsm else self._vs
        iters = min(FAST_SEARCH_ITERS, _levels(self._cap) + 1)
        while True:
            outs = [core(self._ks[p], hist[p], self._bidx[p], self._count(p),
                         self._runs_b[p], self._runs_e[p], self._runs_ver[p],
                         self._n_runs, *self._clipped(p, b), commit_off,
                         n_txn=b[6].shape[0], run_cap=self._run_cap,
                         search_iters=iters, search_impl=self._search_impl)
                    for p, b in enumerate(batches)]
            verdict, conv = self._fold(outs, 4, 5)
            if not sync or conv is None or self._host_bool(conv):
                break
            self.search_fallbacks += 1
            iters = _levels(self._cap) + 1
        self._runs_b, self._runs_e, self._runs_ver = (
            tuple(o[i] for o in outs) for i in (1, 2, 3))
        self._n_runs += 1
        return verdict, conv

    def _resolve_flat(self, batches, commit_off: int, Wn: int, sync: bool):
        """Each partition merges its clipped committed writes into its main
        level.  Synchronous, a partition that outgrew it regrows them all
        from the pre-batch state and the batch replays."""
        def dispatch(iters):
            outs = [resolve_core(self._ks[p], self._vs[p], self._bidx[p],
                                 self._count(p), *self._clipped(p, b), commit_off,
                                 cap=self._cap, n_txn=b[6].shape[0],
                                 search_iters=iters, merge_impl=self._merge_impl,
                                 search_impl=self._search_impl)
                    for p, b in enumerate(batches)]
            return outs, *self._fold(outs, 5, 6)

        fast = min(FAST_SEARCH_ITERS, _levels(self._cap) + 1)
        if not sync:
            outs, verdict, conv = dispatch(fast)
            fits = self._fits([o[3] for o in outs], self._cap)
            ok = fits if conv is None else conv & fits
            self._counts, self._dev_counts = None, tuple(o[3] for o in outs)
            self._counts_ub = self._counts_ub + 2 * Wn
        else:
            while True:
                iters = fast
                while True:
                    outs, verdict, conv = dispatch(iters)
                    if conv is None or self._host_bool(conv):
                        break
                    self.search_fallbacks += 1
                    iters = _levels(self._cap) + 1
                counts = self._host_numpy(self._gather([o[3] for o in outs]))
                if counts.max() <= self._cap:
                    break
                self._grow_main(self._grown(self._cap, counts.max()))
            self._counts, self._counts_ub = counts, counts.copy()
            self._dev_counts = None
            ok = None
        self._ks, self._vs, self._bidx = (tuple(o[i] for o in outs) for i in (1, 2, 4))
        return verdict, ok

    def _resolve_lsm(self, batches, commit_off: int, Wn: int, sync: bool):
        """Each partition merges its clipped committed writes into its
        recent level.  Synchronous, a level that outgrew its capacity
        compacts every partition and the batch replays."""
        def dispatch(iters, rec_iters):
            outs = [resolve_core_lsm(
                        self._ks[p], self._tab[p], self._bidx[p], self._count(p),
                        self._rec_ks[p], self._rec_vs[p], self._rec_bidx[p],
                        self._rec_count(p), *self._clipped(p, b), commit_off,
                        rec_cap=self._rec_cap, n_txn=b[6].shape[0],
                        search_iters=iters, rec_iters=rec_iters,
                        search_impl=self._search_impl, merge_impl=self._merge_impl)
                    for p, b in enumerate(batches)]
            return outs, *self._fold(outs, 5, 6)

        while True:
            iters = min(FAST_SEARCH_ITERS, _levels(self._cap) + 1)
            rec_iters = min(self._rec_iters, _levels(self._rec_cap) + 1)
            if not sync:
                outs, verdict, conv = dispatch(iters, rec_iters)
                fits = self._fits([o[4] for o in outs], self._rec_cap)
                ok = fits if conv is None else conv & fits
                self._rec_counts, self._rec_dev_counts = None, tuple(o[4] for o in outs)
                self._rec_counts_ub = self._rec_counts_ub + 2 * Wn
                break
            while True:
                outs, verdict, conv = dispatch(iters, rec_iters)
                if conv is None or self._host_bool(conv):
                    break
                self.search_fallbacks += 1
                iters = _levels(self._cap) + 1
                rec_iters = _levels(self._rec_cap) + 1
            counts = self._host_numpy(self._gather([o[4] for o in outs]))
            if counts.max() <= self._rec_cap:
                self._rec_counts, self._rec_counts_ub = counts, counts.copy()
                self._rec_dev_counts = None
                ok = None
                break
            # the coalescing estimate beaten: compact and replay
            self._compact()
        self._rec_ks, self._rec_vs, self._rec_bidx = (
            tuple(o[i] for o in outs) for i in (1, 2, 3))
        return verdict, ok

    @staticmethod
    def _grown(cap: int, need: int) -> int:
        while cap < need:
            cap *= 2
        return cap

    def check_pipelined(self) -> None:
        """Read the deferred validity of the sync=False resolves since the
        last check (ONE device flag, and on the legacy path the live
        counts).  Raises if any batch failed; the stream must then be
        replayed through sync=True resolves."""
        if self._pipelined_since_check == 0:
            return
        n = self._pipelined_since_check
        self._pipelined_since_check = 0
        if not self._host_bool(self._dev_ok):
            raise RuntimeError(
                f"a pipelined batch among the last {n} failed its deferred"
                " search-convergence/capacity check; replay through sync=True"
            )
        if self._incremental:
            return
        if self._lsm:
            self._rec_counts_ub = self._host_rec_counts().copy()
        else:
            self._counts_ub = self._host_counts().copy()

    def _fold_levels(self, steps) -> np.ndarray:
        """Fold each partition's step functions (`steps[p]`, a list of
        (rows, vals)) into its main level in turn; when any partition's
        union outgrows main, every main regrows and the folds start over.
        Then rebuild bidx (and the LSM tables).  Returns the counts."""
        while True:
            outs, worst = [], []
            for p in range(self._n):
                ks, vs, counts = self._ks[p], self._vs[p], []
                for rows, vals in steps[p]:
                    ks, vs, c = compact_lsm(ks, vs, rows, vals, cap=self._cap,
                                            merge_impl=self._merge_impl)
                    counts.append(c.to(torch.int32))
                outs.append((ks, vs, counts[-1]))
                worst.append(torch.stack(counts).max())
            seen = self._host_numpy(torch.stack([self._gather([o[2] for o in outs]),
                                                 self._gather(worst)]))
            if seen[1].max() <= self._cap:
                break
            self._grow_main(self._grown(self._cap, seen[1].max()))
        self._ks, self._vs = tuple(o[0] for o in outs), tuple(o[1] for o in outs)
        self._bidx = tuple(_rebuild_buckets(k) for k in self._ks)
        self._tab = self._tables()
        self._counts, self._counts_ub = seen[0], seen[0].copy()
        self._dev_counts = None
        self.compactions += 1
        return seen[0]

    def _note_fold(self, t0: float) -> float:
        dt = time.perf_counter() - t0
        self.stats.merge_s += dt
        self.stats.fold_wall_s[self._merge_impl] = (
            self.stats.fold_wall_s.get(self._merge_impl, 0.0) + dt
        )
        return dt

    def _compact_runs(self) -> None:
        """The deferred k-way merge of every partition: each run as a step
        function (kernel K4, one launch a partition), folded into main.
        The reference folds all K slots; the slots past `_n_runs` are
        empty, and an empty fold of a main level just folded is a no-op,
        so only the live ones fold here."""
        if self._n_runs == 0:
            return
        t0 = time.perf_counter()
        n = self._n_runs
        steps = []
        for p in range(self._n):
            rows, vals = kernels.run_to_step_runs(
                self._runs_b[p][:n], self._runs_e[p][:n], self._runs_ver[p][:n])
            steps.append(list(zip(rows, vals)))
        self._fold_levels(steps)
        self._init_runs(self._run_cap)
        self.stats.compact_s += self._note_fold(t0)

    def _compact(self) -> None:
        """Fold every partition's recent level into its main level."""
        t0 = time.perf_counter()
        self._fold_levels([[(self._rec_ks[p], self._rec_vs[p])]
                           for p in range(self._n)])
        self._init_recent()
        self._note_fold(t0)

    def remove_before(self, version: int) -> None:
        if version <= self._oldest:
            return
        self._oldest = version
        off = version - self._base
        if off > 0:
            def clamp(parts):
                return tuple(torch.clamp(t - off, min=0) for t in parts)

            self._vs = clamp(self._vs)
            if self._lsm:
                # range-max commutes with the monotone clamp
                self._tab = clamp(self._tab)
                if not self._incremental:  # idle (all 0) on the incremental path
                    self._rec_vs = clamp(self._rec_vs)
            if self._incremental:
                # dead runs clamp to version 0 and never conflict again
                self._runs_ver = clamp(self._runs_ver)
            self._base = version
            self._note_pipeline_gc(version)
