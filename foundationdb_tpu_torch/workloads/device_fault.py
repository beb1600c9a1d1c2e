"""DeviceFault workload — deterministic device-fault injection as a spec
stanza (the targeted half of the device-fault chaos campaign: the random
half is buggify's per-run arming; this workload FORCES each device.*
site so a spec/soak campaign is guaranteed to walk the supervisor's
failure paths, the way the reference's targeted simulation tests force
specific SBVars rather than waiting on the dice).

Each site is forced `times` queries, then a few driver commits push live
traffic through the resolver so the armed fault actually meets a device
interaction (a forced site only fires when the supervisor guards a real
device call).  Requires a supervised device conflict backend
(`backend=supervised` in the spec's cluster stanza) — under any other
backend nothing guards device calls and `check` fails loudly instead of
the campaign silently testing nothing.

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

from .base import Workload


class DeviceFaultWorkload(Workload):
    description = "DeviceFault"

    DEFAULT_SITES = (
        "device.lost",
        "device.dispatch_hang",
        "device.compile_fail",
        "device.readback_corrupt",
    )

    def __init__(self, sites: str = "", times: int = 2,
                 start_delay: float = 0.4, writes_per_site: int = 6,
                 interval: float = 0.3):
        self._sites = (
            tuple(s.strip() for s in sites.split(",") if s.strip())
            or self.DEFAULT_SITES
        )
        # times < DEVICE_RETRY_LIMIT by default: the streak heals on the
        # next success instead of tripping the breaker, so LATER sites
        # still meet a device-serving backend to fire against
        self.times = times
        self.start_delay = start_delay
        self.writes_per_site = writes_per_site
        self.interval = interval
        self.forced = 0

    async def start(self, cluster, rng) -> None:
        from ..runtime import buggify

        # force() is a silent no-op outside simulation chaos mode — a spec
        # composing this workload without `chaos=true` would test nothing
        # and then fail check() with no hint of why
        assert buggify.is_enabled(), (
            "DeviceFault requires chaos=true in the spec's cluster stanza "
            "(buggify must be enabled for forced device faults to fire)"
        )
        db = cluster.database()
        await cluster.loop.delay(self.start_delay)
        for n, site in enumerate(self._sites):
            buggify.force(site, self.times)
            self.forced += 1
            # drive enough commits that the forced fires are consumed even
            # if the concurrent workloads have already finished
            for i in range(self.writes_per_site):
                key = b"devfault/%d/%d" % (n, i)

                async def body(tr, k=key):
                    tr.set(k, b"x")

                await db.run(body)
            await cluster.loop.delay(self.interval)

    async def check(self, cluster, rng) -> bool:
        from ..runtime import coverage

        missing = [
            s for s in self._sites if not coverage.hits(f"buggify.{s}")
        ]
        if not missing:
            return True
        # a breaker trip mid-run parks the backend on the CPU reference and
        # stops consuming forced device faults — that's the supervisor
        # doing its job, not a coverage failure of this seed (the campaign
        # census still requires every site to fire across SOME seed).  The
        # evidence is the degrade path's own coverage marker, which is
        # process-global and so survives a recovery recruiting FRESH
        # supervisors (whose trip counters restart at zero).
        return coverage.hits("device.degraded") >= 1

    def metrics(self) -> dict:
        return {"forced_sites": self.forced}
