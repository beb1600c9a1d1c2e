"""KeyRangeMap — range -> value map over byte-string key space with
coalescing (fdbclient/KeyRangeMap.h / KeyRangeMap.actor.cpp: the structure
behind the proxy's keyInfo/keyResolvers and the client's location cache;
CoalescedKeyRangeMap merges equal-valued neighbours on insert).

A piecewise-constant function: sorted boundary keys + the value of the gap
starting at each boundary; the last gap extends to +infinity.  `assign`
overwrites a range, `merge` combines with the existing value per
sub-range (the MoveKeys/range-metadata update shape), and both coalesce.

The step-function representation is the same mathematical object the
device conflict kernel keeps in fixed-capacity tensors (conflict/device.py
state) — this is its general host-side sibling.

Copy of the reference package's module.
"""

from __future__ import annotations

import bisect
from typing import Callable, Iterator


class KeyRangeMap:
    def __init__(self, default=None) -> None:
        self._keys: list[bytes] = [b""]
        self._vals: list = [default]

    def __getitem__(self, key: bytes):
        return self._vals[bisect.bisect_right(self._keys, key) - 1]

    get = __getitem__

    @property
    def boundary_count(self) -> int:
        return len(self._keys)

    def ranges(
        self, begin: bytes = b"", end: bytes | None = None
    ) -> Iterator[tuple[bytes, bytes | None, object]]:
        """Sub-ranges overlapping [begin, end) as (b, e, value); e is None
        for the final unbounded gap.  Clipped to the query range."""
        ks, vs = self._keys, self._vals
        lo = bisect.bisect_right(ks, begin) - 1
        for i in range(lo, len(ks)):
            b = ks[i]
            if end is not None and b >= end:
                break
            e = ks[i + 1] if i + 1 < len(ks) else None
            cb = max(b, begin)
            ce = e if end is None else (min(e, end) if e is not None else end)
            if ce is not None and cb >= ce:
                continue
            yield cb, ce, vs[i]

    def _split_at(self, key: bytes) -> None:
        """Ensure `key` is a boundary (value unchanged)."""
        i = bisect.bisect_right(self._keys, key) - 1
        if self._keys[i] != key:
            self._keys.insert(i + 1, key)
            self._vals.insert(i + 1, self._vals[i])

    def assign(self, begin: bytes, end: bytes | None, value) -> None:
        """Set [begin, end) to `value` (end None = to +infinity), replacing
        whatever was there; coalesces equal neighbours."""
        if end is not None and begin >= end:
            return
        self._split_at(begin)
        if end is not None:
            self._split_at(end)
        lo = bisect.bisect_right(self._keys, begin) - 1  # == index of begin
        hi = (
            len(self._keys)
            if end is None
            else bisect.bisect_left(self._keys, end)
        )
        self._keys[lo:hi] = [begin]
        self._vals[lo:hi] = [value]
        self._coalesce()

    def merge(self, begin: bytes, end: bytes | None, value,
              fn: Callable) -> None:
        """Combine [begin, end) with `value` per sub-range:
        new = fn(old, value).  The range-metadata update shape (e.g. a
        fetch floor merged by max over whatever floors already exist)."""
        if end is not None and begin >= end:
            return
        self._split_at(begin)
        if end is not None:
            self._split_at(end)
        lo = bisect.bisect_right(self._keys, begin) - 1
        hi = (
            len(self._keys)
            if end is None
            else bisect.bisect_left(self._keys, end)
        )
        for i in range(lo, hi):
            self._vals[i] = fn(self._vals[i], value)
        self._coalesce()

    def map_values(self, fn: Callable) -> None:
        """Apply fn to every gap's value (e.g. clamp), then coalesce."""
        self._vals = [fn(v) for v in self._vals]
        self._coalesce()

    def _coalesce(self) -> None:
        ks, vs = self._keys, self._vals
        nk, nv = [ks[0]], [vs[0]]
        for k, v in zip(ks[1:], vs[1:]):
            if v != nv[-1]:
                nk.append(k)
                nv.append(v)
        self._keys, self._vals = nk, nv
