"""ConflictSet plugin API — copy of the reference package's conflict
vocabulary, so the port's sets are drop-in `conflict_backend=`s.

Semantics mirror the reference's ConflictSet interface
(fdbserver/ConflictSet.h:27-60) and its use by the Resolver
(fdbserver/Resolver.actor.cpp:140-157):

  * A *batch* of transactions arrives with one commit version for the whole
    batch (assigned by the sequencer, fdbserver/masterserver.actor.cpp:831).
  * Each transaction carries a read snapshot version, read conflict ranges,
    and write conflict ranges (fdbclient/CommitTransaction.h:89).
  * Verdicts (reference ConflictBatch::TransactionCommitted enum):
      - TOO_OLD      if read_snapshot < oldest_version (the MVCC window floor;
                     detected at add time, SkipList.cpp:985)
      - CONFLICT     if any read range intersects a write range committed at a
                     version v with read_snapshot < v  (history conflict,
                     SkipList.cpp:1210), or intersects a write range of an
                     *earlier committed* transaction in the same batch
                     (intra-batch, SkipList.cpp:1133-1152 — order matters:
                     later transactions see earlier committed writes only)
      - COMMITTED    otherwise; its write ranges are then inserted at the
                     batch's commit version (SkipList.cpp:1260).
  * remove_before(v) garbage-collects write ranges with version < v and
    raises the TOO_OLD floor (SkipList.cpp:665).

Ranges are half-open [begin, end) over byte-string keys.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
from typing import Sequence


class Verdict(enum.IntEnum):
    # Values match the reference's ConflictBatch::TransactionCommitResult
    # (fdbserver/ConflictSet.h:36-40): Conflict=0, TooOld=1, Committed=2.
    # The ordering is load-bearing: the proxy min-combines verdicts across
    # resolvers, so CONFLICT < TOO_OLD < COMMITTED means "any resolver that
    # couldn't verify (conflict or too-old) vetoes the commit".
    CONFLICT = 0
    TOO_OLD = 1
    COMMITTED = 2


@dataclasses.dataclass(frozen=True)
class TxInfo:
    """One transaction's conflict-relevant payload
    (fdbclient/CommitTransaction.h:89 CommitTransactionRef)."""

    read_snapshot: int
    read_ranges: Sequence[tuple[bytes, bytes]]
    write_ranges: Sequence[tuple[bytes, bytes]]


@dataclasses.dataclass
class KernelStats:
    """Uniform conflict-backend cost counters (the device kernel's
    profiling record, exposed by EVERY backend so parity checks can also
    compare cost, and so the status roll-up reads one shape regardless of
    which backend a resolver hosts).

    Wall times are host-measured (time.perf_counter): they are observability
    only and never feed back into simulation behavior, so determinism is
    unaffected.  `pack_s` is TxInfo→tensor/ABI marshalling, `resolve_s` the
    backend check itself, `merge_s` state maintenance outside the check
    (device GC/compaction kernels; CPU removeBefore).  `pack_s` further
    splits into `encode_s` (key flatten + lane encode), `pad_s` (bucketing
    and staging-arena fill) and `h2d_s` (explicit host→device staging, only
    where a caller stages with device_put — the input-pipeline counters of
    docs/KERNEL.md "Input pipeline").

    The per-phase splits (`sort_s`/`scan_s`/`append_s`/`compact_s`) mirror
    the device kernel's sort-scan decomposition (docs/KERNEL.md): sort =
    rank/sort-merge of the batch against the state, scan = the fused
    history + run-probe + intra-batch check, append = the incremental run
    append (the merge phase that replaced the per-batch full re-sort),
    compact = deferred run→main folds.  The port's device set fills
    `compact_s` (compactions end in a host sync anyway); the other splits
    need per-phase barriers the hot path must not pay, and only a set
    built with `phase_timing=True` fills them."""

    backend: str = "?"         # the port's device set: "cuda" or "cpu"
    batches: int = 0
    txns: int = 0
    aborted: int = 0            # CONFLICT verdicts
    pack_s: float = 0.0
    encode_s: float = 0.0       # pack phase: key flatten + lane encode
    pad_s: float = 0.0          # pack phase: bucket/pad/arena fill
    h2d_s: float = 0.0          # pack phase: explicit host->device staging
    resolve_s: float = 0.0
    merge_s: float = 0.0
    sort_s: float = 0.0         # phase: state rank / sort-merge
    scan_s: float = 0.0         # phase: history + run probe + intra-batch
    append_s: float = 0.0       # phase: incremental run append
    compact_s: float = 0.0      # phase: deferred run/recent→main folds
    real_rows: int = 0          # live read+write rows fed to the check
    padded_rows: int = 0        # rows after power-of-two bucketing
    recompiles: int = 0         # distinct static-shape combos jitted
    search_fallbacks: int = 0   # bucketed search replayed at full depth
    compactions: int = 0        # LSM recent→main + deferred run folds
    gc_calls: int = 0
    rows_reclaimed: int = 0     # boundaries freed by GC/compaction
    runs_appended: int = 0      # incremental merge: batches appended as runs
    full_merges: int = 0        # legacy path: full per-batch state rewrites
    merge_impl: str = "?"       # fold implementation (sort|scatter|gather)
    # the device set's key width (bytes) and its widenings to a batch's
    # longer endpoints (conflict/device.py; a recovery replay counts again)
    key_bytes: int = 0
    widenings: int = 0
    # the conflict kernels launched for this set, by wrapper
    # (conflict/kernels.counted; empty where none ran)
    launches: dict = dataclasses.field(default_factory=dict)
    # wall seconds spent in run/recent→main folds keyed by the merge impl
    # that executed them — lets the status plane show which impl is live
    # AND what each impl actually cost when an autotune sweep mixes them.
    fold_wall_s: dict = dataclasses.field(default_factory=dict)
    # the device sets' blocking reads of a device value on the host, by
    # site (conflict/pipeline.py READ_SITES; they sum to the set's
    # `host_syncs`), and the wall seconds the host spent in them
    host_reads: dict = dataclasses.field(default_factory=dict)
    host_wait_s: float = 0.0
    # the least bytes the compactions moved: main's live rows before and
    # after each, read once and written once, at 4 bytes a key lane and 4
    # for the version (conflict/device.py::_fold_all)
    compact_bytes: int = 0

    def __post_init__(self) -> None:
        # per-batch resolve-time reservoir for p50/p99 (deterministic
        # xorshift inside ContinuousSample — no global random use)
        from ..runtime.metrics import ContinuousSample

        self.resolve_sample = ContinuousSample(256)

    def note_batch(self, n_txn: int, n_aborted: int, resolve_dt: float) -> None:
        self.batches += 1
        self.note_answer(n_txn, n_aborted, resolve_dt)

    def note_answer(self, n_txn: int, n_aborted: int, resolve_dt: float) -> None:
        """A batch's verdicts answered: its transactions, its CONFLICTs and
        its resolve time.  A pipelined batch counts in `batches` at its
        dispatch (and at a recovery's replay) and is answered once, later
        (conflict/pipeline.py), with its time from dispatch to answer."""
        self.txns += n_txn
        self.aborted += n_aborted
        self.resolve_s += resolve_dt
        self.resolve_sample.add(resolve_dt)

    def snapshot(self, node_count: int = 0) -> dict:
        return {
            "backend": self.backend,
            "batches": self.batches,
            "txns": self.txns,
            "aborted": self.aborted,
            "abort_rate": self.aborted / self.txns if self.txns else 0.0,
            "occupancy": (
                self.real_rows / self.padded_rows if self.padded_rows else 1.0
            ),
            "rows_real": self.real_rows,
            "rows_padded": self.padded_rows,
            "recompiles": self.recompiles,
            "search_fallbacks": self.search_fallbacks,
            "compactions": self.compactions,
            "gc_calls": self.gc_calls,
            "rows_reclaimed": self.rows_reclaimed,
            "node_count": node_count,
            "runs_appended": self.runs_appended,
            "full_merges": self.full_merges,
            "merge_impl": self.merge_impl,
            "key_bytes": self.key_bytes,
            "widenings": self.widenings,
            "launches": dict(self.launches),
            "host_reads": dict(self.host_reads),
            "host_wait_ms": self.host_wait_s * 1e3,
            "compact_bytes": self.compact_bytes,
            "fold_ms": {k: v * 1e3 for k, v in sorted(self.fold_wall_s.items())},
            "pack_ms": self.pack_s * 1e3,
            "encode_ms": self.encode_s * 1e3,
            "pad_ms": self.pad_s * 1e3,
            "h2d_ms": self.h2d_s * 1e3,
            "resolve_ms": self.resolve_s * 1e3,
            "merge_ms": self.merge_s * 1e3,
            "phase": {
                "sort_ms": self.sort_s * 1e3,
                "scan_ms": self.scan_s * 1e3,
                "merge_ms": self.append_s * 1e3,
                "compact_ms": self.compact_s * 1e3,
            },
            "resolve_ms_p50": self.resolve_sample.percentile(0.5) * 1e3,
            "resolve_ms_p99": self.resolve_sample.percentile(0.99) * 1e3,
        }


_NO_SPAN = contextlib.nullcontext()


def span(name: str, version: int | None = None):
    """A span of the conflict set's own steps (`cs.*`, docs/OBSERVABILITY.md):
    `torch.profiler.record_function(name)` while a torch profiler records,
    else one shared no-op context.  The span lives in the profiler's trace,
    on the clock of the kernels and copies it launches, nested in the span
    it was entered in; `version` (a batch's commit version) goes in as the
    record's argument."""
    import torch

    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name, None if version is None else str(version))


class ResolveHandle:
    """Handle for a (possibly still in-flight) batch resolve.  `wait()`
    returns the per-txn verdicts, blocking until they are trustworthy —
    for device backends that means fetching the device verdict array AND
    draining the deferred validity checks (conflict/pipeline.py)."""

    def wait(self) -> list[Verdict]:
        raise NotImplementedError


class CompletedResolve(ResolveHandle):
    """Already-resolved handle: the synchronous backends' resolve_deferred
    result, and the pipelined backends' fallback when a batch cannot be
    deferred (empty batch, capacity fall-through)."""

    __slots__ = ("_verdicts",)

    def __init__(self, verdicts: list[Verdict]) -> None:
        self._verdicts = verdicts

    def wait(self) -> list[Verdict]:
        return self._verdicts


class ConflictSet:
    """Abstract conflict set; implementations: oracle (conflict/oracle.py),
    native C++ (conflict/native.py), TPU (conflict/tpu.py)."""

    def resolve_batch(self, commit_version: int, txns: Sequence[TxInfo]) -> list[Verdict]:
        """Check all txns against history + each other; insert committed
        txns' writes at commit_version; return per-txn verdicts."""
        raise NotImplementedError

    def resolve_deferred(self, commit_version: int, txns: Sequence[TxInfo]) -> ResolveHandle:
        """Split-phase resolve: dispatch the batch and return a handle whose
        `wait()` yields the verdicts.  The state transition happens in
        dispatch order regardless of when handles are waited, so a caller
        may dispatch batch N+1 before draining batch N's verdicts (the
        resolver role's input pipeline, FDBTPU_PIPELINE).  Backends without
        a device stream resolve synchronously here — the default makes the
        split-phase caller exactly equivalent to the sequential one."""
        return CompletedResolve(self.resolve_batch(commit_version, txns))

    def remove_before(self, version: int) -> None:
        """GC write ranges older than `version`; txns with read_snapshot <
        version become TOO_OLD."""
        raise NotImplementedError

    @property
    def oldest_version(self) -> int:
        raise NotImplementedError

    @property
    def node_count(self) -> int:
        """Live boundary/node count of the committed-write state (the
        reference's skip-list node count); 0 where a backend can't say."""
        return 0

    def healthcheck(self) -> bool:
        """Cheap liveness probe of the backend: device-backed sets force a
        tiny host<->device round trip and raise on a sick device; pure-host
        backends are trivially healthy.  Used by the DeviceSupervisor
        (conflict/supervisor.py) before trusting a freshly built backend."""
        return True

    def kernel_stats(self) -> dict:
        """One-shape profiling snapshot (see KernelStats); backends that
        never instrumented themselves report zeros rather than failing."""
        stats = getattr(self, "stats", None)
        if stats is None:
            stats = self.stats = KernelStats(backend=type(self).__name__)
        try:
            nc = int(self.node_count)
        except Exception:  # noqa: BLE001 — a closed plugin handle etc.
            nc = 0
        return stats.snapshot(node_count=nc)

    def close(self) -> None:  # destroyConflictSet analog
        pass


class VerdictValidationError(ValueError):
    """A backend returned a malformed verdict list (wrong length or codes
    outside the Verdict enum).  A dedicated type so supervisors can
    distinguish corrupted device output from caller-side ValueErrors
    without string matching."""


def validate_verdicts(verdicts: Sequence, n_txn: int) -> None:
    """Sanity-check a backend's verdict list before trusting it: exactly one
    verdict per transaction and every code inside the enum — the cheap
    shield that turns a corrupted device readback (garbage D2H bytes) into
    a classified failure instead of a silently-wrong abort set."""
    if len(verdicts) != n_txn:
        raise VerdictValidationError(
            f"backend returned {len(verdicts)} verdicts for {n_txn} txns"
        )
    for v in verdicts:
        c = int(v)
        if c < int(Verdict.CONFLICT) or c > int(Verdict.COMMITTED):
            raise VerdictValidationError(
                f"verdict code {c} outside the Verdict enum"
            )


def validate_batch(commit_version: int, txns: Sequence[TxInfo], oldest: int) -> None:
    if commit_version < oldest:
        raise ValueError(f"commit_version {commit_version} < oldest_version {oldest}")
    for t in txns:
        if t.read_snapshot >= commit_version:
            raise ValueError("read_snapshot must precede commit_version")
        for b, e in list(t.read_ranges) + list(t.write_ranges):
            if not (isinstance(b, bytes) and isinstance(e, bytes)):
                raise TypeError("range endpoints must be bytes")
