"""DiskSwizzle workload — cycle every data disk through the resource-
exhaustion fault plane under live traffic (the disk half of the
reference's machine swizzling: AsyncFileNonDurable + SimulatedMachine
model slow, stalled, erroring, and nearly-full disks; this workload
drives each of those states deterministically AND forces the `disk.*`
buggify sites so a campaign's census proves the faults really fired).

Each round walks the commit/storage-plane disks (TLog disk queues,
storage WAL/B-tree files) and applies one fault per disk, rotating
through the classes:

  slow    — degraded mode: fsyncs pay `slowMult`x latency for the round
  stall   — fsyncs hang for `stallSeconds` (crossing IO_TIMEOUT_S
            fail-fasts the process through kill/recovery — that is the
            io_timeout story working, not a failure)
  error   — the next ops on the disk raise injected IOErrors
  enospc  — capacity clamps to just above current usage, so appends hit
            ENOSPC until the round ends

Every fault is cleared at the end of its round, and `check` drives probe
commits until one succeeds — the cluster must come back from every round
of disk abuse with the commit plane intact.

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

from .base import Workload
from ..runtime.core import ActorCancelled

_FAULTS = ("slow", "stall", "error", "enospc")


class DiskSwizzleWorkload(Workload):
    description = "DiskSwizzle"

    def __init__(self, rounds: int = 2, interval: float = 1.0,
                 start_delay: float = 0.5, stall_seconds: float = 0.4,
                 slow_mult: float = 8.0, errors: int = 1,
                 enospc_headroom: int = 256):
        self.rounds = rounds
        self.interval = interval
        self.start_delay = start_delay
        self.stall_seconds = stall_seconds
        self.slow_mult = slow_mult
        self.errors = errors
        self.enospc_headroom = enospc_headroom
        self.faults_applied = 0
        self.probe_commits = 0

    @staticmethod
    def _data_disks(fs) -> list[str]:
        """The commit/storage-plane disks: TLog disk queues and storage
        store files — the surfaces whose exhaustion the roles must
        degrade gracefully under.  Coordinator registers and cluster
        files are deliberately out of scope (their write paths are
        control-plane rare and covered by the kill plane)."""
        return [
            p for p in fs.list()
            if p.startswith(("tlog", "ss", "remote"))
        ]

    async def start(self, cluster, rng) -> None:
        from ..runtime import buggify

        fs = getattr(cluster, "fs", None)
        assert fs is not None, (
            "DiskSwizzle needs a durable cluster (the faults live on the "
            "sim disks)"
        )
        assert buggify.is_enabled(), (
            "DiskSwizzle requires chaos=true in the spec's cluster stanza "
            "(the disk.* buggify sites must be armable)"
        )
        await cluster.loop.delay(self.start_delay)
        for rnd in range(self.rounds):
            # the seed-armed half: force each site so its firing is a
            # campaign REQUIREMENT, not a dice roll — the live traffic
            # below consumes the forced queries in the disk I/O paths
            for site in ("disk.slow", "disk.stall", "disk.error",
                         "disk.enospc", "disk.corrupt_read",
                         # the page-cache memory-pressure flush
                         # (storage/pagecache.py): queried on cache fills,
                         # so it fires only when a durable engine's read
                         # path is really caching — always safe (the pool
                         # is clean by construction)
                         "cache.evict_all"):
                buggify.force(site, 1)
            capped: list[str] = []
            for i, path in enumerate(self._data_disks(fs)):
                fault = _FAULTS[(i + rnd) % len(_FAULTS)]
                if fault == "enospc" and path.startswith("tlog"):
                    # a capacity clamp on a TLog's disk queue blanks the
                    # WHOLE commit plane for the round — that scenario has
                    # its own negative-durability tests (refuse loudly,
                    # recover); the chaos rotation gives TLogs transient
                    # errors instead, and storage disks take the sustained
                    # ENOSPC (their durability loop must retry through it)
                    fault = "error"
                if fault == "slow":
                    fs.degrade(path, self.slow_mult)
                elif fault == "stall":
                    fs.stall(path, self.stall_seconds)
                elif fault == "error":
                    fs.inject_errors(path, self.errors)
                else:
                    used, _cap = fs.usage_for(path)
                    fs.set_capacity(path, used + self.enospc_headroom)
                    capped.append(path)
                self.faults_applied += 1
            # scrub pass (read-only): pread a chunk of every data disk so
            # the corrupt-on-read site meets real read traffic even when
            # nothing in the round happens to page data in — checksummed
            # consumers heal the flip, the scrub just provides the reads.
            # The handles ride a live CLUSTER process: buggify disk faults
            # arm only for process-owned I/O (the off-cluster blob store
            # keeps its own blob.* vocabulary)
            scrub_proc = next(
                (p for p in cluster.net.processes.values() if p.alive), None
            )
            for path in self._data_disks(fs):
                f = fs.open(path, scrub_proc)
                if f.size():
                    f.pread(0, min(4096, f.size()))
                f.close()
            # capacity probe on a THROWAWAY disk: proves the ENOSPC
            # enforcement plane itself every round (the live ss disks are
            # capped above, but whether a durability flush lands inside
            # the window is seed timing) — never append into live files
            probe = fs.open("diskswizzle.probe", scrub_proc)
            fs.set_capacity("diskswizzle.probe", probe.size() + 8)
            for _ in range(3):
                # a forced/armed injected fault may preempt the capacity
                # check on any one attempt; three tries guarantees the
                # ENOSPC enforcement itself is exercised
                try:
                    probe.append(b"x" * 64)
                except IOError:
                    continue  # DiskFull expected — disk.enospc_hit recorded
            fs.set_capacity("diskswizzle.probe", None)
            probe.close()
            await cluster.loop.delay(self.interval)
            # end of round: the operator "cleared" the faults
            for path in self._data_disks(fs):
                fs.degrade(path, 1.0)
            for path in capped:
                fs.set_capacity(path, None)

    async def check(self, cluster, rng) -> bool:
        if self.faults_applied == 0:
            return False
        # the cluster must serve commits again with every fault cleared;
        # recoveries in flight (an io_timeout kill mid-round) are given
        # time to land
        db = cluster.database()
        for attempt in range(40):
            try:
                async def body(tr, n=attempt):
                    tr.set(b"diskswizzle/probe", b"%d" % n)

                await db.run(body)
                self.probe_commits += 1
                return True
            except ActorCancelled:
                raise
            except Exception:  # noqa: BLE001 — recovery window, retry
                await cluster.loop.delay(0.5)
        return False

    def metrics(self) -> dict:
        return {
            "faults_applied": self.faults_applied,
            "probe_commits": self.probe_commits,
        }
