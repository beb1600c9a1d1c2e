"""BlobBackup workload — continuous backup into a blob-store container
under injected blob faults, with the uploader killed mid-stream
(fdbserver/workloads/BackupToDBCorrectness.actor.cpp crossed with the
BlobStore fault model: the backup is only real if it restores byte-exact
after connection failures, torn multipart uploads, corrupt reads, AND the
uploading process dying at an arbitrary offset).

The workload keeps its own committed model (every acknowledged burst) and
verifies the container by folding it back through the restore referee
(`client/backup.py apply_backup`) — the exact clip/replay a real restore
performs, compared byte-for-byte against the model.  The blob store lives
ON the simulated filesystem (`SimFSBacking`), so it has the same crash
semantics as every other disk: a restarting pair's part 2 (`action=verify`)
re-opens the container that rode the reboot and proves it still restores
to exactly what the rebooted cluster serves.

Buggify: `blob.connect_fail` / `blob.upload_torn` / `blob.read_corrupt`
(storage/blobstore.py) are force()-armed by seeded coins in setup, and
`blob.uploader_kill_point` jitters the kill offset.

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

from .base import Workload
from ..runtime.buggify import buggify
from ..runtime.core import TaskPriority
from ..runtime.coverage import testcov

_CONTAINER = "bk"
_KEY_FMT = b"bb/k%05d"
_NUDGE_KEY = b"bb/n%04d"


class BlobBackupWorkload(Workload):
    description = "BlobBackup"

    def __init__(self, keys: int = 24, burst: int = 6,
                 start_delay: float = 0.2, kill_uploader: bool = True,
                 kill_jitter: float = 0.4, action: str = "full") -> None:
        if action not in ("full", "verify"):
            raise ValueError(f"action must be full|verify, got {action!r}")
        self.keys = keys
        self.burst = burst
        self.start_delay = start_delay
        self.kill_uploader = kill_uploader
        self.kill_jitter = kill_jitter
        self.action = action
        self.model: dict[bytes, bytes] = {}
        self.verified = False
        self.part1_verified = False
        self.uploader_killed = False

    def restart_state(self) -> dict:
        return {"keys": self.keys}

    def load_restart_manifest(self, manifest: dict) -> None:
        """Part 1 recorded whether its backup verified before the power
        kill; if it did, the rebooted container must still hold a full
        restorable snapshot — losing it in the reboot is a failure, not a
        vacuous pass."""
        m = manifest.get("part1_metrics", {}).get(self.description, {})
        self.part1_verified = bool(m.get("verified"))

    async def setup(self, cluster, rng) -> None:
        from ..runtime import buggify as _buggify

        if self.action == "full" and _buggify.is_enabled():
            # seeded arming so campaigns hit every blob fault site without
            # waiting on the dice (the SaveAndKill discipline)
            if rng.coinflip(0.6):
                _buggify.force("blob.connect_fail", times=2)
            if rng.coinflip(0.6):
                _buggify.force("blob.upload_torn")
            if rng.coinflip(0.6):
                _buggify.force("blob.read_corrupt")

    def _container(self, cluster, rng):
        """The blob container over the cluster's simulated filesystem —
        rebuilt identically (same name) by part 2 of a restarting pair."""
        from ..client.backup import backup_container
        from ..storage.blobstore import (
            BlobObjectStore,
            BlobStoreClient,
            SimBlobTransport,
            SimFSBacking,
        )

        assert cluster.fs is not None, "BlobBackup needs a durable cluster"
        store = BlobObjectStore(SimFSBacking(cluster.fs))
        uid_rng = rng.split()
        client = BlobStoreClient(
            SimBlobTransport(store, cluster.loop, rng.split()),
            knobs=cluster.knobs, trace=cluster.trace,
            sleep=lambda s: cluster.loop.delay(s, TaskPriority.DEFAULT_DELAY),
            nonce=f"c{uid_rng.random_unique_id()[:6]}",
        )
        return backup_container(
            f"blob://{_CONTAINER}", blob_client=client,
            uid=lambda: uid_rng.random_unique_id()[:8],
        )

    async def _commit_burst(self, db, lo: int, hi: int) -> None:
        async def fn(tr):
            for i in range(lo, hi):
                tr.set(_KEY_FMT % i, b"b%d" % (i * 31 + 7))

        await db.run(fn)
        for i in range(lo, hi):
            self.model[_KEY_FMT % i] = b"b%d" % (i * 31 + 7)

    async def start(self, cluster, rng) -> None:
        if self.action == "verify":
            return  # part 2: verification happens in check()
        from ..client.backup import BackupAgent, apply_backup

        db = cluster.database()
        await cluster.loop.delay(self.start_delay)
        container = self._container(cluster, rng)
        agent = BackupAgent(cluster)
        await agent.start(container)

        half = max(1, self.keys // 2)
        await self._commit_burst(db, 0, half)
        if self.kill_uploader:
            # kill the uploader mid-stream at a buggify-jittered offset: a
            # multipart upload may be half-staged — it must be detected
            # (never finalized ⇒ invisible; torn ⇒ refused at complete)
            # and re-uploaded by the replacement, never restored
            if buggify("blob.uploader_kill_point"):
                await cluster.loop.delay(rng.random() * self.kill_jitter)
            agent.kill_worker()
            self.uploader_killed = True
            testcov("backup.uploader_killed")
            cluster.trace.trace("BackupUploaderKilled")
            await agent.restart_worker(container)
        await self._commit_burst(db, half, self.keys)

        snap_v = await agent.snapshot(container, chunk_rows=16)
        # the backup is restorable once the log passes the newest chunk:
        # nudge commits (append-only keys, so a mid-upload kill leaves lag,
        # never a stale overwrite) push known_committed past the boundary
        for n in range(400):
            if agent.worker.backed_up.get() >= snap_v:
                break

            async def fn(tr, n=n):
                tr.set(_NUDGE_KEY % n, b"%d" % n)

            await db.run(fn)
            self.model[_NUDGE_KEY % n] = b"%d" % n
            await cluster.loop.delay(0.05, TaskPriority.DEFAULT_DELAY)
        assert agent.worker.backed_up.get() >= snap_v, (
            "backup log never reached the snapshot boundary"
        )
        # drain: the container must cover the LAST committed version, or
        # the model comparison below would count uploader lag as loss
        vfin = [0]

        async def fv(tr):
            vfin[0] = await tr.get_read_version()

        await db.run(fv)
        await agent.wait_backed_up_to(vfin[0], timeout=120.0)
        await agent.stop()

        # restore referee: fold the container back and compare the bb/
        # range byte-for-byte against the committed model
        chunks, log = await container.read()
        state = apply_backup(chunks, log)
        got = {k: v for k, v in state.items() if k.startswith(b"bb/")}
        assert got == self.model, (
            f"blob restore diverges from the committed model: "
            f"{len(got)} restored vs {len(self.model)} committed"
        )
        self.verified = True
        testcov("backup.blob_verified")

    async def check(self, cluster, rng) -> bool:
        if self.action == "full":
            return self.verified
        # part 2: the container rode the reboot on the simulated disks —
        # it must still restore to exactly what the rebooted cluster
        # serves (both recovered independently: storage from its files +
        # TLog re-pull, the container from its synced objects)
        from ..client.backup import apply_backup

        container = self._container(cluster, rng)
        chunks, log = await container.read()
        if not chunks:
            # legal only when part 1 never finished its snapshot (the kill
            # point is buggify-jittered on purpose); a backup part 1 had
            # VERIFIED restorable must not vanish in the reboot
            return not self.part1_verified
        state = apply_backup(chunks, log)
        db = cluster.database()

        async def fn(tr):
            return await tr.get_range(b"bb/", b"bb0", limit=1 << 20)

        rows = dict(await db.run(fn))
        got = {k: v for k, v in state.items() if k.startswith(b"bb/")}
        # every byte the container restores must match the rebooted
        # cluster (a torn/phantom object surviving into a restore would
        # diverge HERE); the container may trail the cluster when the kill
        # landed mid-upload — that is lag, not loss
        for k, v in got.items():
            if rows.get(k) != v:
                return False
        if got == rows:
            # the common case: part 1 finished its backup before the kill,
            # so the reboot-surviving container restores the FULL range
            testcov("backup.blob_reverified_after_reboot")
        elif self.part1_verified:
            # part 1 proved the container byte-exact and nothing mutated
            # bb/ afterwards: anything short of full equality now means
            # the reboot lost committed data or backup objects
            return False
        return True

    def metrics(self) -> dict:
        return {
            "committed": len(self.model),
            "uploader_killed": self.uploader_killed,
            "verified": self.verified,
        }
