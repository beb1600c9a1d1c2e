"""ManagementAPI — cluster administration through the system keyspace
(fdbclient/ManagementAPI.actor.cpp: changeConfig, excludeServers,
includeServers, lockDatabase/unlockDatabase, changeQuorum;
fdbclient/SystemData.cpp configKeysPrefix `\\xff/conf/`,
excludedServersPrefix `\\xff/conf/excluded/`).

Everything here is ordinary replicated, durable data under `\\xff/conf/...`:
each verb commits a transaction, and the cluster controller polls the range
and reacts — reconfiguration recovery for role counts, data-distribution
draining for exclusions, commit-gate for the lock, a coordinator-set swap
for `coordinators` (the reference's master watches txnStateStore config
keys the same way).

Reconfigurable: n_tlogs, n_proxies, n_resolvers (write-pipeline role
counts) and redundancy (storage replication target validated by the
replication policy).  Storage topology changes belong to data distribution.

Copy of the reference package's module, on the port's own modules.
"""

from __future__ import annotations

CONF_PREFIX = b"\xff/conf/"
EXCLUDED_PREFIX = CONF_PREFIX + b"excluded/"
MAINTENANCE_PREFIX = CONF_PREFIX + b"maintenance/"
LOCK_KEY = CONF_PREFIX + b"lock"
COORDINATORS_KEY = CONF_PREFIX + b"coordinators"
_FIELDS = ("n_tlogs", "n_proxies", "n_resolvers")


async def configure(db, redundancy: str | None = None,
                    engine: str | None = None, **kwargs) -> None:
    """Commit new role counts, a redundancy mode, and/or a storage engine,
    e.g. configure(db, n_tlogs=3), configure(db, redundancy="triple"),
    configure(db, engine="ssd").  Role counts take effect at the
    controller's next conf poll via a recovery; a redundancy flip
    converges online through data distribution (one replica change per
    poll); an engine flip migrates one replica at a time through the dd
    heal path (the reference's `configure ssd` re-replication)."""
    bad = set(kwargs) - set(_FIELDS)
    if bad:
        raise ValueError(f"unknown configuration fields: {sorted(bad)}")
    for k, v in kwargs.items():
        if int(v) < 1:
            raise ValueError(f"{k} must be >= 1")
    if redundancy is not None:
        from ..rpc.policy import policy_for_redundancy

        policy_for_redundancy(redundancy)  # validate the mode name
    if engine is not None and engine not in ("memory", "ssd"):
        raise ValueError(f"unknown storage engine {engine!r}")

    async def fn(tr):
        for k, v in kwargs.items():
            tr.set(CONF_PREFIX + k.encode(), b"%d" % int(v))
        if redundancy is not None:
            tr.set(CONF_PREFIX + b"redundancy", redundancy.encode())
        if engine is not None:
            tr.set(CONF_PREFIX + b"engine", engine.encode())

    await db.run(fn)


async def get_configuration(db) -> dict:
    """The committed configuration (empty until first configure())."""

    async def fn(tr):
        rows = await tr.get_range(CONF_PREFIX, CONF_PREFIX + b"\xff")
        out = {}
        for k, v in rows:
            name = k[len(CONF_PREFIX):]
            if b"/" in name or name in (
                b"lock", b"coordinators", b"usable_regions",
            ):
                continue  # excluded/…, maintenance/…, region/…, lock,
                          # quorum size, usable_regions: not role counts
            try:
                out[name.decode()] = int(v)
            except ValueError:
                continue
        return out

    return await db.run(fn)


# -- region configuration (configure usable_regions=2 / region failover) -----


async def configure_regions(db, usable_regions: int | None = None,
                            satellite: str | None = None,
                            primary: str | None = None) -> None:
    """Commit region configuration (control/region.py): `usable_regions=2`
    makes the remote region part of the durability contract (the log-router
    tag becomes recovery-required), `satellite` tunes that requirement, and
    flipping `primary="remote"` IS region failover — the controller's conf
    watch drives the promotion (the KillRegion.actor.cpp contract: configure
    the region change, never poke the topology by hand).  Unnamed fields
    keep their committed values."""
    from ..control.region import (
        PRIMARY_KEY,
        SATELLITE_KEY,
        USABLE_REGIONS_KEY,
        RegionConfiguration,
    )

    # validate the named fields against the full vocabulary up front —
    # a typo'd mode must fail HERE, not sit unparseable in the keyspace
    RegionConfiguration(
        usable_regions=2 if usable_regions is None else usable_regions,
        satellite="required" if satellite is None else satellite,
        primary="primary" if primary is None else primary,
    ).validate()

    async def fn(tr):
        if usable_regions is not None:
            tr.set(USABLE_REGIONS_KEY, b"%d" % usable_regions)
        if satellite is not None:
            tr.set(SATELLITE_KEY, satellite.encode())
        if primary is not None:
            tr.set(PRIMARY_KEY, primary.encode())

    await db.run(fn)


async def get_region_configuration(db):
    """The committed RegionConfiguration, or None if never configured."""
    from ..control.region import REGION_PREFIX, USABLE_REGIONS_KEY, parse_region_rows

    async def fn(tr):
        rows = list(await tr.get_range(REGION_PREFIX, REGION_PREFIX + b"\xff"))
        v = await tr.get(USABLE_REGIONS_KEY)
        if v is not None:
            rows.append((USABLE_REGIONS_KEY, v))
        return parse_region_rows(rows)

    return await db.run(fn)


# -- exclusion (excludeServers, ManagementAPI.actor.cpp) ---------------------
# Targets are locality strings: a machine name ("m3"), a process name, or a
# process address.  The controller matches them against each process's
# locality (is_excluded); data distribution drains excluded storage servers
# and the next recovery re-recruits pipeline roles off excluded machines.


async def exclude(db, targets: list[str]) -> None:
    """Mark targets excluded: no role may run there, and data distribution
    drains their storage with zero data loss.  Durable until include()d."""
    if not targets:
        raise ValueError("exclude needs at least one target")

    async def fn(tr):
        for t in targets:
            tr.set(EXCLUDED_PREFIX + t.encode(), b"1")

    await db.run(fn)


async def include(db, targets: list[str] | None = None) -> None:
    """Re-admit targets (None/empty = everything — `include all`)."""

    async def fn(tr):
        if not targets:
            tr.clear_range(EXCLUDED_PREFIX, EXCLUDED_PREFIX + b"\xff")
        else:
            for t in targets:
                tr.clear(EXCLUDED_PREFIX + t.encode())

    await db.run(fn)


async def get_excluded(db) -> list[str]:
    async def fn(tr):
        rows = await tr.get_range(EXCLUDED_PREFIX, EXCLUDED_PREFIX + b"\xff")
        return [k[len(EXCLUDED_PREFIX):].decode() for k, _v in rows]

    return await db.run(fn)


def exclusion_safe(cluster, targets: list[str]) -> bool:
    """Is it safe to remove the targeted processes?  True once no LIVE
    storage assignment and no pipeline role runs on an excluded target —
    the check `exclude` in fdbcli performs before declaring servers
    removable (ManagementAPI checkSafeExclusions analog)."""
    cc = cluster.controller
    tset = set(targets)

    def hit(proc) -> bool:
        return cc.excluded_match(
            tset,
            machine=getattr(proc, "machine", None),
            name=proc.name,
            address=proc.address,
        )

    for team in cc.storage_teams_tags:
        for tag in team:
            ss = cc._tag_to_ss.get(tag)
            if ss is not None and hit(ss.process):
                return False
    gen = cc.generation
    if gen is not None and any(hit(p) for p in gen.processes):
        return False
    return True


# -- lock / unlock (lockDatabase, ManagementAPI.actor.cpp) -------------------


async def lock_database(db, uid: bytes | None = None) -> bytes:
    """Lock the database: every non-lock-aware user commit fails with
    database_locked (1038) until unlock_database(uid).  Returns the lock
    UID.  Locking an already-locked database raises."""
    uid = uid or db._rng.random_unique_id().encode()

    async def fn(tr):
        cur = await tr.get(LOCK_KEY)
        if cur is not None and cur != uid:
            from ..roles.types import DatabaseLocked

            raise DatabaseLocked(f"already locked by {cur!r}")
        tr.set(LOCK_KEY, uid)

    await db.run(fn)
    return uid


async def unlock_database(db, uid: bytes) -> None:
    """Unlock; the UID must match the lock holder's."""

    async def fn(tr):
        cur = await tr.get(LOCK_KEY)
        if cur is None:
            return
        if cur != uid:
            from ..roles.types import DatabaseLocked

            raise DatabaseLocked(f"locked by {cur!r}, not {uid!r}")
        tr.clear(LOCK_KEY)

    await db.run(fn)


async def get_lock(db) -> bytes | None:
    async def fn(tr):
        return await tr.get(LOCK_KEY)

    return await db.run(fn)


# -- coordinators (changeQuorum, ManagementAPI.actor.cpp) --------------------


async def set_coordinators(db, n: int) -> None:
    """Request a coordinator-set change to n members.  The controller swaps
    the quorum at its next conf poll (MovableCoordinatedState: read the
    current cstate, write it into the new registers, retire the old)."""
    if n < 1 or n % 2 == 0:
        raise ValueError("coordinator count must be odd and >= 1")

    async def fn(tr):
        tr.set(COORDINATORS_KEY, b"%d" % n)

    await db.run(fn)


# -- throttle (fdbcli `throttle`: an operator TPS ceiling) -------------------


async def set_throttle(db, tps: float | None) -> None:
    """Cap cluster admission at `tps` transactions/s (None = clear).
    Composes with the automatic ratekeeper model as a hard ceiling."""

    async def fn(tr):
        if tps is None:
            tr.clear(CONF_PREFIX + b"throttle_tps")
        else:
            import math

            if not math.isfinite(tps) or tps <= 0:
                raise ValueError("throttle tps must be a finite positive number")
            tr.set(CONF_PREFIX + b"throttle_tps", repr(float(tps)).encode())

    await db.run(fn)


# -- maintenance mode (fdbcli `maintenance on <zone> <seconds>`) -------------


async def set_maintenance(db, zone: str, seconds: float) -> None:
    """Suppress data-distribution healing for a zone (machine/DC) while its
    processes are deliberately bounced: until the deadline, servers there
    are treated as 'coming back', not dead."""
    deadline = db.loop.now() + seconds

    async def fn(tr):
        tr.set(MAINTENANCE_PREFIX + zone.encode(), repr(deadline).encode())

    await db.run(fn)


async def clear_maintenance(db, zone: str | None = None) -> None:
    async def fn(tr):
        if zone is None:
            tr.clear_range(MAINTENANCE_PREFIX, MAINTENANCE_PREFIX + b"\xff")
        else:
            tr.clear(MAINTENANCE_PREFIX + zone.encode())

    await db.run(fn)
