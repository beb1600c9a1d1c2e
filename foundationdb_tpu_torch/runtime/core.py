"""The runtime's seeded random source.

Copy of the part of the reference package's `DeterministicRandom`
(flow/DeterministicRandom.h) that fault injection (runtime/buggify.py)
draws on: `coinflip` and `split`.  It wraps `random.Random` call for call
as the reference does, so the same seed gives the same sequence in both
packages.  The event loop, its task priorities and the other draws stay
with the host stack, which is not ported yet.
"""

from __future__ import annotations

import random as _pyrandom


class DeterministicRandom:
    """Seeded RNG behind every random decision (flow/DeterministicRandom.h):
    identical seed ⇒ identical simulation.  Thin, explicit wrapper so call
    sites can't accidentally reach the global `random` module."""

    def __init__(self, seed: int) -> None:
        self._r = _pyrandom.Random(seed)
        self.seed = seed

    def coinflip(self, p: float = 0.5) -> bool:
        return self._r.random() < p

    def split(self) -> "DeterministicRandom":
        """Child RNG with a derived seed (keeps streams independent)."""
        return DeterministicRandom(self._r.getrandbits(63))
