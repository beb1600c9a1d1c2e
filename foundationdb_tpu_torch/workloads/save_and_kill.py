"""SaveAndKill workload — part 1 of a restarting test pair
(fdbserver/workloads/SaveAndKill.actor.cpp: run workloads, then power-kill
the whole simulation and copy the surviving disks + a restart manifest to
a host directory; tester.actor.cpp:1118 boots part 2 from it).

At `restart_after` virtual seconds this workload kills EVERY simulated
process at once — no clean shutdown, no draining, in-memory state
discarded, un-fsynced file buffers dropped (the SimFile crash model) —
then serializes the surviving `SimFilesystem` image plus the manifest
(seed, cluster/spec config, each co-workload's invariant state) via
`storage/image.py` and raises `RestartKill`, which `run_spec` recognizes
as the part-1 verdict: the simulation ended on purpose, checks belong to
part 2's lifetime.

Buggify sites: `restart.kill_point` jitters the kill instant (the
reference varies when in the workload's life the power dies) and
`restart.manifest_corrupt` (in image.py) plants a torn manifest temp next
to the save.  Under chaos the setup phase deterministically force()s each
with a seeded coin so restarting soak campaigns hit both without waiting
on the dice.

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

from .base import Workload
from ..runtime.buggify import buggify
from ..runtime.coverage import testcov
from ..storage.image import save_image


def invariant_states(workloads: list[Workload]) -> dict[str, list[dict]]:
    """Manifest shape for workload invariant state: name -> ORDERED list of
    `restart_state()` dicts, one per stanza.  A list, not a flat dict, so
    two same-named stanzas (e.g. two Cycle rings of different sizes) both
    survive into part 2's positional comparison instead of collapsing to
    whichever came last."""
    out: dict[str, list[dict]] = {}
    for w in workloads:
        state = w.restart_state()
        if state:
            out.setdefault(w.description, []).append(state)
    return out


class RestartKill(Exception):
    """Control-flow signal, not a failure: part 1 power-killed the sim and
    saved its image.  run_spec catches this and returns phase-1 metrics."""

    def __init__(self, image_dir: str) -> None:
        super().__init__(image_dir)
        self.image_dir = image_dir


class SaveAndKillWorkload(Workload):
    description = "SaveAndKill"

    def __init__(self, restart_after: float = 2.0, kill_jitter: float = 0.5):
        self.restart_after = restart_after
        self.kill_jitter = kill_jitter
        self.killed_at: float | None = None
        # bound by run_spec (only it knows the spec/cluster config the
        # manifest must carry): (save_dir, manifest base, co-workloads)
        self._save_dir: str | None = None
        self._manifest: dict | None = None
        self._co_workloads: list[Workload] = []

    def bind(self, save_dir: str, manifest: dict,
             co_workloads: list[Workload]) -> None:
        self._save_dir = save_dir
        self._manifest = manifest
        self._co_workloads = [w for w in co_workloads if w is not self]

    async def setup(self, cluster, rng) -> None:
        from ..runtime import buggify as _buggify

        if _buggify.is_enabled():
            # deterministic per-seed arming: roughly half of a campaign's
            # seeds walk each rare path, the other half keep the clean one
            if rng.coinflip(0.5):
                _buggify.force("restart.kill_point")
            if rng.coinflip(0.5):
                _buggify.force("restart.manifest_corrupt")

    async def start(self, cluster, rng) -> None:
        assert self._save_dir is not None and self._manifest is not None, (
            "SaveAndKill only runs under run_spec (it needs the spec's "
            "cluster config for the restart manifest)"
        )
        await cluster.loop.delay(self.restart_after)
        if buggify("restart.kill_point"):
            # power loss does not consult the test plan for a good moment
            await cluster.loop.delay(rng.random() * self.kill_jitter)
        self.killed_at = cluster.loop.now()
        # traced BEFORE the kill so the event lands in part 1's stream —
        # the marker triage uses to join part-1/part-2 trace files
        cluster.trace.trace("SaveAndKill", KilledAt=self.killed_at,
                            SaveDir=self._save_dir)
        testcov("restart.power_kill")
        fs = cluster.power_off()  # every process dies NOW, buffers dropped
        manifest = dict(self._manifest)
        manifest["killed_at"] = self.killed_at
        manifest["workloads"] = invariant_states(self._co_workloads)
        manifest["part1_metrics"] = {
            w.description: w.metrics() for w in self._co_workloads
        }
        raise RestartKill(save_image(fs, self._save_dir, manifest))

    def metrics(self) -> dict:
        return {"killed_at": self.killed_at, "image": self._save_dir}
