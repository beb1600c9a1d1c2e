"""Backup worker — streams the cluster's full mutation log to backup files
(the reference's backup workers, fdbserver/BackupWorker.actor.cpp, which
pull backup-tagged mutations from the log system; fdbclient/
FileBackupAgent.actor.cpp owns the snapshot/restore protocol around it).

The worker owns a dedicated tag ("backup-0"): with a backup enabled, every
committed mutation is ALSO tagged with it (roles/proxy.py phase 4), so the
worker pulls the total mutation order exactly like a storage server pulls
its shard — and pops as segments become durable in the backup container,
so TLog space is bounded by worker lag, not backup duration.

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

from .sequencer import NotifiedVersion
from .types import TLogPeekRequest, TLogPopRequest, Version
from ..runtime.core import BrokenPromise, EventLoop, TaskPriority, TimedOut
from ..runtime.serialize import BinaryReader, BinaryWriter, read_mutation, write_mutation

BACKUP_TAG = "backup-0"


def encode_log_frame(version: Version, muts) -> bytes:
    w = BinaryWriter().i64(version).u32(len(muts))
    for m in muts:
        write_mutation(w, m)
    return w.data()


def decode_log_frame(buf: bytes):
    r = BinaryReader(buf)
    version = r.i64()
    return version, [read_mutation(r) for _ in range(r.u32())]


class BackupWorker:
    def __init__(self, process, loop: EventLoop, dq, start_version: Version) -> None:
        self.loop = loop
        self.process = process
        self.dq = dq  # mutation-log DiskQueue in the backup container
        self.tag = BACKUP_TAG
        self.tlog = None      # RequestStreamRef, wired by the controller
        self.tlog_pops: list = []
        self._fetched = start_version
        self.backed_up = NotifiedVersion(start_version)  # durable in container
        self._task = loop.spawn(self._pull(), TaskPriority.STORAGE_SERVER, "backup-pull")

    def set_tlog_source(self, peek_ref, pop_refs: list) -> None:
        self.tlog = peek_ref
        self.tlog_pops = pop_refs  # EVERY replica holding the tag gets pops

    async def _pull(self) -> None:
        while True:
            if self.tlog is None:
                await self.loop.delay(0.05, TaskPriority.STORAGE_SERVER)
                continue
            try:
                reply = await self.tlog.get_reply(
                    TLogPeekRequest(self.tag, self._fetched + 1), timeout=1.0
                )
            except (TimedOut, BrokenPromise):
                await self.loop.delay(0.1, TaskPriority.STORAGE_SERVER)
                continue
            wrote = False
            # never persist past known_committed: a version some TLog synced
            # but not every replica acked can still be rolled back by a
            # recovery as an UNKNOWN-result phantom — backing it up would
            # make the phantom permanent.  Entries above the watermark stay
            # on the TLog and are re-peeked once it advances.
            limit_v = reply.known_committed
            for version, muts in reply.entries:
                if version <= self._fetched or version > limit_v:
                    continue
                if muts:
                    self.dq.push(encode_log_frame(version, muts))
                    wrote = True
                self._fetched = version
            tail = min(reply.end_version - 1, limit_v)
            if tail > self._fetched:
                self._fetched = tail
            if wrote:
                await self.dq.sync()  # durable in the container before pop
            for pop in self.tlog_pops:
                pop.send(TLogPopRequest(self.tag, self._fetched))
            if self._fetched > self.backed_up.get():
                self.backed_up.set(self._fetched)
            if not reply.entries:
                await self.loop.delay(0.01, TaskPriority.STORAGE_SERVER)

    def stop(self) -> None:
        self._task.cancel()
