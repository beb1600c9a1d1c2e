"""Multi-version client — one stable API across cluster protocol versions
(fdbclient/MultiVersionTransaction.actor.cpp: the reference loads multiple
client libraries and routes to whichever speaks the connected cluster's
protocol, re-selecting transparently through upgrades).

`MultiVersionDatabase` holds one client FACTORY per protocol version plus a
`probe` that asks the cluster which protocol it speaks (the gateway's
GET_PROTOCOL op).  Selection is lazy; a protocol-mismatch error from the
active client (an upgraded cluster rejecting old ops) triggers a re-probe
and a transparent switch — callers never see the transition beyond the
ordinary retry.

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations


class ProtocolMismatch(Exception):
    """Raised by a client implementation when the cluster rejects its wire
    protocol (e.g. the gateway answers bad_request to an op the cluster's
    version no longer/not yet speaks)."""


class NoMatchingClient(Exception):
    def __init__(self, version: int, known) -> None:
        super().__init__(
            f"cluster speaks protocol {version}; clients available for "
            f"{sorted(known)}"
        )
        self.version = version


class MultiVersionDatabase:
    def __init__(self, factories: dict[int, object], probe) -> None:
        self._factories = dict(factories)
        self._probe = probe
        self._active_version: int | None = None
        self._db = None

    @property
    def active_version(self) -> int | None:
        return self._active_version

    def _ensure(self):
        if self._active_version is not None:
            return self._db  # lazy: re-probe only on mismatch/first use
        v = self._probe()
        if v != self._active_version:
            if v not in self._factories:
                raise NoMatchingClient(v, self._factories)
            old, self._db = self._db, self._factories[v]()
            self._active_version = v
            if old is not None and hasattr(old, "close"):
                old.close()
        return self._db

    def probe_version(self) -> int:
        return self._probe()

    def run(self, fn):
        """Run fn(db_client) against the matching client; on a protocol
        mismatch (cluster upgraded mid-flight), re-select once and retry."""
        db = self._ensure()
        try:
            return fn(db)
        except ProtocolMismatch:
            self._active_version = None  # force re-probe + switch
            db = self._ensure()
            return fn(db)

    def close(self) -> None:
        if self._db is not None and hasattr(self._db, "close"):
            self._db.close()
        self._db = None
        self._active_version = None
