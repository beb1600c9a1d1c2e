"""Declarative replication policies — PolicyOne / PolicyAcross evaluated
against process locality (fdbrpc/ReplicationPolicy.h:101 PolicyOne, :121
PolicyAcross; fdbrpc/Locality.h LocalityData).

The reference validates every team and coordinator selection against a
policy object built from the redundancy mode ("double" = two replicas
across machines, "three_datacenter" = three across DCs, ...).  This module
is that object: `validate` judges an existing placement, `select` chooses a
satisfying subset from candidates (the team-builder path).  Policies nest —
Across(2, "dc", Across(2, "machine", One())) is "two DCs, two machines
each" — exactly the reference's composition.

Deterministic: `select` is stable in candidate order, so same seed ⇒ same
placement (the simulation's determinism contract).

Copy of the reference package's module, on the port's own modules.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Locality:
    """One process's placement attributes (LocalityData: processId,
    machineId, dcId)."""

    process: str
    machine: str | None = None
    dc: str | None = None

    @classmethod
    def of(cls, proc) -> "Locality":
        return cls(
            proc.name,
            getattr(proc, "machine", None),
            getattr(proc, "dc", None),
        )

    def get(self, attr: str):
        return getattr(self, attr)


class ReplicationPolicy:
    """Base: how many replicas, and does a placement satisfy the policy?"""

    def replicas(self) -> int:
        raise NotImplementedError

    def validate(self, locs: Sequence[Locality]) -> bool:
        raise NotImplementedError

    def select(self, candidates: Sequence[Locality]) -> list[int] | None:
        """Indices of a satisfying subset of `candidates` (stable order),
        or None if the candidates cannot satisfy the policy."""
        raise NotImplementedError


class PolicyOne(ReplicationPolicy):
    """Any single replica (ReplicationPolicy.h:101)."""

    def replicas(self) -> int:
        return 1

    def validate(self, locs: Sequence[Locality]) -> bool:
        return len(locs) >= 1

    def select(self, candidates: Sequence[Locality]) -> list[int] | None:
        return [0] if candidates else None

    def __repr__(self) -> str:
        return "One()"


class PolicyAcross(ReplicationPolicy):
    """`count` distinct values of `attr`, each satisfying `sub`
    (ReplicationPolicy.h:121 PolicyAcross).  A None attribute value is its
    own group per process (no locality info = assume distinct, matching the
    reference's treatment of unset locality keys)."""

    def __init__(self, count: int, attr: str, sub: ReplicationPolicy | None = None) -> None:
        if count < 1:
            raise ValueError("count must be >= 1")
        if attr not in ("machine", "dc", "process"):
            raise ValueError(f"unknown locality attribute {attr!r}")
        self.count = count
        self.attr = attr
        self.sub = sub or PolicyOne()

    def replicas(self) -> int:
        return self.count * self.sub.replicas()

    def _groups(self, locs: Sequence[Locality]) -> dict:
        groups: dict = {}
        for i, loc in enumerate(locs):
            v = loc.get(self.attr)
            key = v if v is not None else ("\x00unset", loc.process)
            groups.setdefault(key, []).append(i)
        return groups

    def validate(self, locs: Sequence[Locality]) -> bool:
        ok_groups = sum(
            1
            for idxs in self._groups(locs).values()
            if self.sub.validate([locs[i] for i in idxs])
        )
        return ok_groups >= self.count

    def select(self, candidates: Sequence[Locality]) -> list[int] | None:
        chosen: list[int] = []
        groups = 0
        # stable: groups visited in first-appearance order
        seen: list = []
        gmap = self._groups(candidates)
        for loc in candidates:
            v = loc.get(self.attr)
            key = v if v is not None else ("\x00unset", loc.process)
            if key not in seen:
                seen.append(key)
        for key in seen:
            if groups >= self.count:
                break
            idxs = gmap[key]
            sub_sel = self.sub.select([candidates[i] for i in idxs])
            if sub_sel is None:
                continue
            chosen.extend(idxs[j] for j in sub_sel)
            groups += 1
        return chosen if groups >= self.count else None

    def __repr__(self) -> str:
        return f"Across({self.count}, {self.attr!r}, {self.sub!r})"


# redundancy mode -> (replication factor, policy) — the `configure
# redundancy=` vocabulary (fdbclient/DatabaseConfiguration.cpp modes)
REDUNDANCY_MODES: dict[str, ReplicationPolicy] = {
    "single": PolicyOne(),
    "double": PolicyAcross(2, "machine"),
    "triple": PolicyAcross(3, "machine"),
    "three_datacenter": PolicyAcross(3, "dc"),
}


def policy_for_redundancy(mode: str) -> ReplicationPolicy:
    if mode not in REDUNDANCY_MODES:
        raise ValueError(
            f"unknown redundancy mode {mode!r}; choose from {sorted(REDUNDANCY_MODES)}"
        )
    return REDUNDANCY_MODES[mode]
