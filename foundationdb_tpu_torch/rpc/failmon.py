"""Cluster-wide failure monitor — the shared liveness map
(fdbrpc/FailureMonitor.h:65 FailureStatus, :123 SimpleFailureMonitor;
fdbclient/FailureMonitorClient.actor.cpp:34 clients polling the cluster
controller's aggregated view).

One FailureMonitor per cluster, FED by the processes that already observe
liveness — the controller's pipeline heartbeats and data distribution's
storage pings — and CONSULTED by everyone else: client load-balancing
skips replicas marked failed instead of paying a per-request timeout to
rediscover what the cluster already knows (the reference's loadBalance
checks IFailureMonitor::getState before picking alternatives).

The sim can LIE to it (`set_override`) — the partition-test hook: mark a
live address failed (or a dead one healthy) and observe how consumers
behave on bad information, exactly what the reference's simulator does to
FailureMonitor state.

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FailureStatus:
    failed: bool
    since: float  # when this status was established


class FailureMonitor:
    def __init__(self, clock) -> None:
        self._clock = clock
        self._status: dict = {}    # address -> FailureStatus
        self._override: dict = {}  # address -> bool (sim lies)
        self.transitions = 0
        # accelerator-backend health, fed by each resolver's
        # DeviceSupervisor (conflict/supervisor.py): name -> health dict
        # (state/trips/time degraded...).  Kept apart from the process map —
        # a degraded DEVICE is a performance event, not a dead process, and
        # consumers must not reroute around a resolver whose CPU fallback
        # is serving correctly.
        self._devices: dict = {}
        self.device_transitions = 0

    def set_status(self, address, failed: bool) -> None:
        """Feed an observation (heartbeat result).  Idempotent: `since`
        moves only on transitions."""
        cur = self._status.get(address)
        if cur is None or cur.failed != failed:
            self._status[address] = FailureStatus(failed, self._clock())
            self.transitions += 1

    def is_failed(self, address) -> bool:
        if address in self._override:
            return self._override[address]
        st = self._status.get(address)
        return st is not None and st.failed

    def status(self, address) -> FailureStatus | None:
        return self._status.get(address)

    def failed_addresses(self) -> list:
        return [
            a for a in self._status.keys() | self._override.keys()
            if self.is_failed(a)
        ]

    # -- device-backend health (conflict/supervisor.py feed) -----------------
    def note_device(self, name: str, health: dict) -> None:
        """Record a device supervisor's health snapshot; `since` semantics
        match set_status — transitions counted on state changes only."""
        prev = self._devices.get(name)
        entry = dict(health)
        if prev is None or prev.get("state") != entry.get("state"):
            entry["since"] = self._clock()
            self.device_transitions += 1
        else:
            entry["since"] = prev.get("since")
        self._devices[name] = entry

    def device_report(self) -> dict:
        """name -> latest health snapshot (status.py rolls this up)."""
        return {k: dict(v) for k, v in self._devices.items()}

    def degraded_devices(self) -> list[str]:
        return sorted(
            k for k, v in self._devices.items() if v.get("state") == "degraded"
        )

    # -- simulation hook -----------------------------------------------------
    def set_override(self, address, failed: bool | None) -> None:
        """Lie to consumers (partition tests): `failed=None` clears."""
        if failed is None:
            self._override.pop(address, None)
        else:
            self._override[address] = failed

    def forget(self, address) -> None:
        """An address left the cluster (process retired): drop its entry so
        the map doesn't grow with every recovery's fresh processes."""
        self._status.pop(address, None)
        self._override.pop(address, None)
