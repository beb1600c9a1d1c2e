"""Pure-Python interval-map oracle — the abort-set parity referee.

Port of the *semantics* (not the code) of the reference's SlowConflictSet
(fdbserver/SkipList.cpp:59-88): a step function over the key space mapping
each key to the newest commit version that wrote it, kept as a sorted list of
(boundary, version) pairs.  A read range [b, e) at snapshot s conflicts iff
max{version over [b, e)} > s.  Deliberately simple and obviously correct;
used by tests to referee the native and TPU implementations.
"""

from __future__ import annotations

import bisect
import time
from typing import Sequence

from .api import ConflictSet, KernelStats, TxInfo, Verdict, validate_batch


class _StepFunction:
    """Piecewise-constant int over byte-string key space."""

    def __init__(self) -> None:
        self._keys: list[bytes] = [b""]
        self._vals: list[int] = [0]

    def query_max(self, begin: bytes, end: bytes) -> int:
        if begin >= end:
            return 0
        lo = bisect.bisect_right(self._keys, begin) - 1
        hi = bisect.bisect_left(self._keys, end)
        return max(self._vals[lo:hi])

    def assign(self, begin: bytes, end: bytes, version: int) -> None:
        """Set value over [begin, end) to `version` (plain assignment with
        boundary splitting; callers guarantee monotonically increasing
        versions — enforced in resolve_batch).  The lists stay coalesced
        (no two neighbours hold the same value), so only the two new
        boundaries can be redundant, and the splice touches one slice."""
        if begin >= end:
            return
        ks, vs = self._keys, self._vals
        # value just right of `end` must be preserved: split at end
        j = bisect.bisect_right(ks, end)  # boundaries strictly after end kept
        end_val = vs[j - 1]
        lo = bisect.bisect_right(ks, begin) - 1
        # remove boundaries inside [begin, end], insert begin/end
        i0 = lo + 1 if ks[lo] < begin else lo
        new_keys, new_vals = [], []
        if i0 == 0 or vs[i0 - 1] != version:
            new_keys.append(begin)
            new_vals.append(version)
        if end_val != version:
            new_keys.append(end)
            new_vals.append(end_val)
        ks[i0:j] = new_keys
        vs[i0:j] = new_vals

    def _coalesce(self) -> None:
        ks, vs = self._keys, self._vals
        nk, nv = [ks[0]], [vs[0]]
        for k, v in zip(ks[1:], vs[1:]):
            if v != nv[-1]:
                nk.append(k)
                nv.append(v)
        self._keys, self._vals = nk, nv

    def clamp_below(self, floor: int) -> None:
        self._vals = [0 if v < floor else v for v in self._vals]
        self._coalesce()


def ranges_overlap(a: tuple[bytes, bytes], b: tuple[bytes, bytes]) -> bool:
    return a[0] < b[1] and b[0] < a[1]


class OracleConflictSet(ConflictSet):
    def __init__(self, oldest_version: int = 0) -> None:
        self._history = _StepFunction()
        self._oldest = oldest_version
        self._last_commit = oldest_version
        self.stats = KernelStats(backend="oracle")

    @property
    def oldest_version(self) -> int:
        return self._oldest

    @property
    def node_count(self) -> int:
        return len(self._history._keys)

    def resolve_batch(self, commit_version: int, txns: Sequence[TxInfo]) -> list[Verdict]:
        validate_batch(commit_version, txns, self._oldest)
        if commit_version <= self._last_commit:
            raise ValueError(
                f"commit_version {commit_version} not after last batch {self._last_commit}"
                " (versions are assigned monotonically by the sequencer,"
                " reference masterserver.actor.cpp:831)"
            )
        self._last_commit = commit_version
        t0 = time.perf_counter()
        verdicts: list[Verdict] = []
        batch_writes = _StepFunction()  # committed-so-far within this batch
        committed_writes: list[tuple[bytes, bytes]] = []
        for t in txns:
            if t.read_snapshot < self._oldest:
                verdicts.append(Verdict.TOO_OLD)
                continue
            conflict = False
            for b, e in t.read_ranges:
                if b >= e:
                    continue
                if self._history.query_max(b, e) > t.read_snapshot:
                    conflict = True
                    break
                if batch_writes.query_max(b, e) > 0:
                    conflict = True
                    break
            if conflict:
                verdicts.append(Verdict.CONFLICT)
                continue
            verdicts.append(Verdict.COMMITTED)
            for b, e in t.write_ranges:
                batch_writes.assign(b, e, 1)
                committed_writes.append((b, e))
        for b, e in committed_writes:
            self._history.assign(b, e, commit_version)
        rows = sum(len(t.read_ranges) + len(t.write_ranges) for t in txns)
        self.stats.real_rows += rows
        self.stats.padded_rows += rows  # no padding in the oracle
        self.stats.note_batch(
            len(txns),
            sum(1 for v in verdicts if v == Verdict.CONFLICT),
            time.perf_counter() - t0,
        )
        return verdicts

    def remove_before(self, version: int) -> None:
        if version > self._oldest:
            self._oldest = version
            t0 = time.perf_counter()
            before = len(self._history._keys)
            self._history.clamp_below(version)
            self.stats.gc_calls += 1
            self.stats.rows_reclaimed += max(0, before - len(self._history._keys))
            self.stats.merge_s += time.perf_counter() - t0
