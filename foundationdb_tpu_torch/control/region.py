"""Region configuration — the usableRegions / satellite machinery of the
reference's DatabaseConfiguration (fdbrpc/simulator.h:285-293 SimulationConfig
regions; fdbclient/DatabaseConfiguration.cpp parsing `usable_regions`,
`regions=` satellite policy; fdbserver/workloads/KillRegion.actor.cpp drives
exactly this surface).

A `RegionConfiguration` is ordinary replicated, durable data under
`\\xff/conf/` (client/management.py `configure_regions` writes it, the
cluster controller's conf watch reacts), so it survives restarts and rides
the TLog seeds through recoveries like every other management verb:

  usable_regions   1 = single-region (the remote plane is best-effort);
                   2 = the remote region is part of the durability story:
                   the log-router tag becomes a REQUIRED tag at recovery
                   (control/logsystem.py region_required_tags) — losing
                   every replica slot of the router's retained backlog is
                   unrecoverable data loss, not a silent proceed.
  satellite        "required" (default under usable_regions=2) keeps the
                   router's retention contract recovery-enforced; "none"
                   opts the router tag back out of the required set (the
                   reference's one-region-no-satellites shape).
  primary          which region serves writes: "primary" | "remote".
                   Flipping to "remote" IS region failover — the conf
                   watch drives RecoverableCluster.promote_remote_region()
                   (the KillRegion.actor.cpp `configure`-then-killRegion
                   contract), replacing the ad-hoc promotion call.

Copy of the reference package's module, on the port's own modules.
"""

from __future__ import annotations

import dataclasses

USABLE_REGIONS_KEY = b"\xff/conf/usable_regions"
REGION_PREFIX = b"\xff/conf/region/"
SATELLITE_KEY = REGION_PREFIX + b"satellite"
PRIMARY_KEY = REGION_PREFIX + b"primary"

REGIONS = ("primary", "remote")
SATELLITE_MODES = ("none", "required")


@dataclasses.dataclass(frozen=True)
class RegionConfiguration:
    """The decoded `\\xff/conf/` region rows (DatabaseConfiguration's
    usableRegions/regions analog).  Frozen: the conf watch compares whole
    configurations by equality to detect a change."""

    usable_regions: int = 1
    satellite: str = "required"   # router-tag recovery policy (see module doc)
    primary: str = "primary"      # which region serves writes

    def validate(self) -> None:
        if self.usable_regions not in (1, 2):
            raise ValueError(
                f"usable_regions must be 1 or 2, got {self.usable_regions}"
            )
        if self.satellite not in SATELLITE_MODES:
            raise ValueError(
                f"satellite must be one of {SATELLITE_MODES}, "
                f"got {self.satellite!r}"
            )
        if self.primary not in REGIONS:
            raise ValueError(
                f"primary must be one of {REGIONS}, got {self.primary!r}"
            )

    @property
    def router_tag_required(self) -> bool:
        """Is the log-router tag part of the recovery durability contract?
        (The satellite-style requirement: un-relayed remote data must be
        recoverable, so every replica slot of the router tag may not be
        lost.)"""
        return self.usable_regions >= 2 and self.satellite == "required"

    def rows(self) -> list[tuple[bytes, bytes]]:
        """The system-keyspace encoding `configure_regions` commits."""
        return [
            (USABLE_REGIONS_KEY, b"%d" % self.usable_regions),
            (SATELLITE_KEY, self.satellite.encode()),
            (PRIMARY_KEY, self.primary.encode()),
        ]


def teams_promoted(teams) -> bool:
    """Does a keyServers team map name the REMOTE region's replicas —
    i.e. did region failover complete before this map was recorded?  THE
    one encoding of the remote-tag naming convention the recovery paths
    consult (a promoted reboot must resolve the remote serving set, and
    fold retained router data into its seeds)."""
    return any(t.startswith("remote-") for team in teams for t in team)


def region_rows_present(rows) -> bool:
    """Does a `\\xff/conf/` range read carry ANY region row?  (A cluster
    never region-configured must not trigger the region hook at all.)"""
    return any(
        k == USABLE_REGIONS_KEY or k.startswith(REGION_PREFIX)
        for k, _v in rows
    )


def parse_region_rows(rows, base: RegionConfiguration | None = None,
                      ) -> RegionConfiguration | None:
    """Decode region rows out of a `\\xff/conf/` range read.  Returns None
    when no region row exists (region config was never written); malformed
    rows fall back to `base`'s (or the default's) field — a torn row must
    not kill the conf watch, same contract as parse_conf_rows."""
    if not region_rows_present(rows):
        return None
    cur = base or RegionConfiguration()
    usable, satellite, primary = cur.usable_regions, cur.satellite, cur.primary
    for k, v in rows:
        if k == USABLE_REGIONS_KEY:
            try:
                n = int(v)
            except ValueError:
                continue
            if n in (1, 2):
                usable = n
        elif k == SATELLITE_KEY:
            try:
                s = v.decode()
            except UnicodeDecodeError:
                continue
            if s in SATELLITE_MODES:
                satellite = s
        elif k == PRIMARY_KEY:
            try:
                p = v.decode()
            except UnicodeDecodeError:
                continue
            if p in REGIONS:
                primary = p
    return RegionConfiguration(
        usable_regions=usable, satellite=satellite, primary=primary
    )
