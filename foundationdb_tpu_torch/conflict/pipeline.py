"""Host-to-device input pipeline for the conflict check.

Port of foundationdb_tpu/conflict/pipeline.py.  The reference resolver
hides its host-side costs with software-pipelined skip-list cursors
(fdbserver/SkipList.cpp:524,773); the device analog is to overlap the HOST
phase of batch N+1 (TxInfo flattening, lane encoding, padding, staging)
with the DEVICE execution of batch N.  Three pieces:

  PackArena          preallocated per-bucket-shape packing buffers,
                     rotated, so pack_batch stops allocating (and
                     sentinel-filling) fresh padded arrays every batch.
  PipelinedPacker    a background thread that packs (and, with a `stage`
                     such as device.BatchStager, copies to the device)
                     batch N+1 while the caller's thread drives batch N.
  PipelinedConflictMixin
                     resolve_deferred() for the device-backed conflict set:
                     dispatch sync=False, hand back a ResolveHandle, and
                     self-heal a deferred-validity failure by restoring a
                     pre-window snapshot and replaying the recorded
                     batch/GC sequence through the sync path.

The recovery snapshot is a dict of references to the set's state.  The
reference can take it so because JAX arrays are immutable.  Torch tensors
are not, and an in-place update inside an open window (a run append, the
compaction's reset of the runs, the GC clamp) would silently change what
the snapshot restores.  The port's set therefore never updates a snapshot
attribute in place: the append writes into a copy of the runs, the
compaction allocates fresh runs, the GC builds clamped copies, and each
result is rebound.  The other way, cloning the state when the snapshot is
taken, would copy main, its history table and the runs (some 60 MB at the
stream's shapes) at the start of every window, and would leave every
future snapshot point one forgotten clone away from a silent corruption;
rebinding costs one copy of the runs per batch (two 2.6 MB tensors) and
makes any snapshot point safe.  Host values are ints, rebound as well.

Determinism: the verdict stream is bit-identical to the synchronous path:
packing is pure, dispatch order is version order, and recovery replays the
exact recorded inputs.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Sequence

import numpy as np

from ..runtime.coverage import testcov
from .api import CompletedResolve, ResolveHandle, TxInfo, Verdict, validate_batch


class _RowSlot:
    __slots__ = ("b", "e", "t", "live")

    def __init__(self, n: int, W: int, sent_word: int) -> None:
        self.b = np.full((n, W), sent_word, dtype=np.uint32)
        self.e = np.full((n, W), sent_word, dtype=np.uint32)
        self.t = np.full(n, -1, dtype=np.int32)
        self.live = 0


class _TxnSlot:
    __slots__ = ("snap", "active", "live")

    def __init__(self, n: int) -> None:
        self.snap = np.zeros(n, dtype=np.int32)
        self.active = np.zeros(n, dtype=bool)
        self.live = 0


class PackArena:
    """Preallocated per-bucket-shape staging buffers for pack_batch.

    Every distinct (bucketed rows, key width) shape owns `depth` rotating
    slot copies: slot i serves batch N, slot (i+1) % depth serves batch
    N+1, so a batch whose arrays may still be read is never overwritten by
    the next pack.  Callers bound their outstanding batches to depth-1.
    Only the previously-live pad region is re-sentinelled on reuse, so
    steady-state packing writes O(live rows), not O(bucket capacity)."""

    def __init__(self, depth: int = 2) -> None:
        if depth < 2:
            raise ValueError("PackArena depth must be >= 2 (double buffering)")
        self.depth = depth
        self._rows: dict[tuple[str, int, int], list[_RowSlot]] = {}
        self._txns: dict[int, list[_TxnSlot]] = {}
        self._turn: dict[tuple, int] = {}

    def _pick(self, pool: dict, key, make):
        slots = pool.get(key)
        if slots is None:
            slots = pool[key] = [make() for _ in range(self.depth)]
        i = self._turn.get(key, 0)
        self._turn[key] = (i + 1) % self.depth
        return slots[i]

    def rows(self, kind: str, n: int, W: int, sent_word: int) -> _RowSlot:
        """A (begin, end, txn-id) row slot for `n` bucketed rows; rows past
        the previous occupant's live count are already sentinel/-1.
        `kind` keeps the read and write pools apart: each pool rotates
        exactly once per batch, so a same-shaped read and write class never
        share a slot."""
        return self._pick(
            self._rows, (kind, n, W), lambda: _RowSlot(n, W, sent_word)
        )

    def txns(self, n: int) -> _TxnSlot:
        return self._pick(self._txns, n, lambda: _TxnSlot(n))


class DeferredResolve(ResolveHandle):
    """In-flight pipelined resolve: the device verdict tensor plus the
    stream-folded validity flag as it stood at this batch's dispatch.
    `wait()` drains through the owning set so failures recover in order.
    The handle keeps the TxInfo list, not the packed arrays: packing is
    pure, so a recovery replay re-packs the dispatch-time batch exactly."""

    __slots__ = (
        "owner", "version", "n_txn", "txns", "verdict_dev", "ok_dev",
        "gc_after", "_result",
    )

    def __init__(self, owner, version: int, txns, verdict_dev, ok_dev) -> None:
        self.owner = owner
        self.version = version
        self.n_txn = len(txns)
        self.txns = txns
        self.verdict_dev = verdict_dev
        self.ok_dev = ok_dev
        self.gc_after: list[int] = []   # remove_before calls after dispatch
        self._result: list[Verdict] | None = None

    def wait(self) -> list[Verdict]:
        if self._result is None:
            self.owner._drain_deferred(self)
        assert self._result is not None
        return self._result


# after this many drained-but-replayable batches, validate the whole stream
# once (one folded-flag read) and drop the recovery snapshot — bounds both
# the replay window and the handles kept alive by a hot stream
_REPLAY_WINDOW = 8


class PipelinedConflictMixin:
    """resolve_deferred() for the device-backed conflict set.

    Host classes provide: `_oldest`, `_offset`, `_offset_array`,
    `_max_key_bytes`, `_dev_ok`, `stats`, `resolve_arrays(...)`,
    `resolve_batch(...)`, `remove_before(...)`, `check_pipelined()`,
    `_host_numpy`/`_host_bool` (reads of a device value), and a class-level
    `_PIPELINE_SNAPSHOT_ATTRS` naming every piece of state a dispatch, GC
    or compaction can move — all of it rebound on update, never written in
    place (module docstring)."""

    _PIPELINE_SNAPSHOT_ATTRS: tuple[str, ...] = ()
    _pipeline_depth = 2

    def _pipeline_init(self) -> None:
        self._inflight: list[DeferredResolve] = []
        self._replayable: list[DeferredResolve] = []
        self._pipe_snapshot: dict | None = None
        # a slot is reused D packs later; with up to `depth` undrained
        # dispatches outstanding, D = depth + 1 keeps every in-flight
        # batch's arrays untouched
        self._arena = PackArena(depth=self._pipeline_depth + 1)

    def _take_snapshot(self) -> dict:
        return {a: getattr(self, a) for a in self._PIPELINE_SNAPSHOT_ATTRS}

    def resolve_deferred(self, commit_version: int, txns: Sequence[TxInfo]) -> ResolveHandle:
        from .device import pack_batch  # runtime import: device imports this module

        B = len(txns)
        if B == 0:
            return CompletedResolve(self.resolve_batch(commit_version, txns))
        validate_batch(commit_version, txns, self._oldest)
        # bound undrained dispatches so the arena never recycles a slot an
        # outstanding batch may still need
        while len(self._inflight) >= self._pipeline_depth:
            self._drain_deferred(self._inflight[0])
        t0 = time.perf_counter()
        packed = pack_batch(
            txns, self._oldest, self._offset, self._max_key_bytes,
            arena=self._arena, stats=self.stats,
            offset_array=self._offset_array, grow=True,
        )[:8]
        self.stats.pack_s += time.perf_counter() - t0
        if not self._inflight:
            self._pipe_snapshot = self._take_snapshot()
        verdict = self.resolve_arrays(commit_version, *packed, sync=False)
        h = DeferredResolve(self, commit_version, list(txns), verdict, self._dev_ok)
        self._inflight.append(h)
        return h

    def _drain_deferred(self, upto: DeferredResolve) -> None:
        """Drain in dispatch order through `upto`; on a deferred-validity
        failure, recover the whole window (snapshot restore + sync replay)."""
        if upto._result is not None:
            return
        while self._inflight:
            h = self._inflight[0]
            v = self._host_numpy(h.verdict_dev)
            if not self._host_bool(h.ok_dev):
                self._recover_inflight()
                return
            self._inflight.pop(0)
            h._result = [Verdict(int(c)) for c in v[: h.n_txn]]
            if self._inflight:
                # later dispatches already ride on h's state: keep h
                # replayable until the stream validates past it
                self._replayable.append(h)
                if len(self._replayable) >= _REPLAY_WINDOW and self._host_bool(
                    self._dev_ok
                ):
                    # the flag just read validated EVERY dispatched batch:
                    # drain the rest of the window in place and drop the
                    # recovery state (a mid-window snapshot would be
                    # unusable: the in-flight dispatches are baked into it)
                    for hh in self._inflight:
                        hh._result = [
                            Verdict(int(c))
                            for c in self._host_numpy(hh.verdict_dev)[: hh.n_txn]
                        ]
                    self._inflight.clear()
            if not self._inflight:
                self._replayable.clear()
                self._pipe_snapshot = None
                self.check_pipelined()  # known valid; resets the count
            if h is upto:
                return

    def _drain_all(self) -> None:
        if self._inflight:
            self._drain_deferred(self._inflight[-1])

    def _recover_inflight(self) -> None:
        """A deferred check failed somewhere in the window: restore the
        pre-window snapshot and replay every recorded batch (and the GC
        calls between them) through the sync path, which replays a search
        that does not converge at full depth.  Results of already-drained
        (replayable) batches were valid; the replay reproduces them while
        rebuilding the state."""
        pending = self._inflight
        done = self._replayable
        snap = self._pipe_snapshot
        self._inflight, self._replayable, self._pipe_snapshot = [], [], None
        assert snap is not None, "deferred failure with no recovery snapshot"
        for a, val in snap.items():
            setattr(self, a, val)
        testcov("kernel.pipeline_recover")
        for h in done + pending:
            verdicts = self.resolve_batch(h.version, h.txns)
            if h._result is None:
                h._result = list(verdicts)
            for gv in h.gc_after:
                self.remove_before(gv)

    def abandon_inflight(self) -> None:
        """Drop every in-flight handle WITHOUT touching the device (for an
        owner that discards a sick backend and recomputes the window
        elsewhere).  The set is unusable afterwards."""
        self._inflight.clear()
        self._replayable.clear()
        self._pipe_snapshot = None

    def _note_pipeline_gc(self, version: int) -> None:
        """remove_before while batches are in flight: record the call on the
        newest dispatch so a recovery replays it at the right point."""
        if self._inflight:
            self._inflight[-1].gc_after.append(version)


class PipelinedPacker:
    """Background-thread packer: packs (and optionally stages onto the
    device) batch N+1 while the caller drives batch N.

    `pack_fn(item)` runs on the worker thread and returns a tuple of numpy
    arrays; `stage(packed)` (optional, e.g. device.BatchStager) runs there
    too and its wall time lands in `stats.h2d_s`.  Results come back in
    submission order.  `depth` bounds unconsumed packed batches
    (backpressure), which bounds the arena slots pack_fn needs to depth+1.
    """

    def __init__(
        self,
        pack_fn: Callable,
        *,
        depth: int = 2,
        stage: Callable | None = None,
        stats=None,
    ) -> None:
        self._pack_fn = pack_fn
        self._stage = stage
        self._stats = stats
        self._in: queue.Queue = queue.Queue()
        self._out: queue.Queue = queue.Queue()
        self._space = threading.Semaphore(depth)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._in.get()
            if item is _STOP:
                self._out.put((False, RuntimeError("PipelinedPacker closed")))
                return
            try:
                packed = self._pack_fn(item)
                if self._stage is not None:
                    t0 = time.perf_counter()
                    packed = self._stage(packed)
                    if self._stats is not None:
                        self._stats.h2d_s += time.perf_counter() - t0
                self._out.put((True, packed))
            except BaseException as e:  # noqa: BLE001 — re-raised at get()
                self._out.put((False, e))

    def submit(self, item) -> None:
        """Enqueue a batch for packing; blocks while `depth` packed batches
        wait unconsumed."""
        self._space.acquire()
        self._in.put(item)

    def get(self):
        """Next packed batch, in submission order; re-raises pack errors."""
        ok, payload = self._out.get()
        self._space.release()
        if not ok:
            raise payload
        return payload

    def close(self) -> None:
        self._in.put(_STOP)
        self._thread.join(timeout=10)


class _Stop:
    pass


_STOP = _Stop()
