"""Backup agent + restore — the fdbbackup / fdbrestore surface
(fdbclient/FileBackupAgent.actor.cpp; bin equivalents fdbbackup/backup.actor.cpp).

A backup is two artifacts in a container:

  log        the FULL mutation stream from the backup's start boundary,
             written continuously by the BackupWorker (roles/backup.py)
  snapshot   chunked range reads, each chunk = (begin, end, version,
             rows) taken at its own read version (a long snapshot never
             needs one giant MVCC window — same as the reference's
             chunked key-range dumps)

Containers come in two schemes (`backup_container`, the
BackupContainer.actor.cpp URL factory; the caller names the URL):
`file://<prefix>` is the original DiskQueue pair inside a (sim)
filesystem, and `blob://<name>` stores both artifacts as checksummed
immutable objects in a BlobStore (storage/blobstore.py) — the
off-cluster destination that makes backup a disaster-recovery story: the
uploader retries every request with backoff, a torn multipart upload is
refused at finalize and re-uploaded, and an uploader killed mid-stream
leaves only invisible staging, never a restorable half-object.

Restorable once every chunk's range is covered and the log reaches
max(chunk versions).  restore() applies the chunks, then replays log
mutations — clipped so a mutation only applies where its version exceeds
the covering chunk's version (the chunk already reflects older ones; the
reference restore applies the same version-range filter per range).

Copy of the reference package's module, on the port's own modules; the
container URL is an argument, never read from the environment."""

from __future__ import annotations

import bisect

from ..roles.backup import BackupWorker, decode_log_frame
from ..roles.types import Mutation, MutationType
from ..runtime.core import TaskPriority
from ..runtime.serialize import BinaryReader, BinaryWriter
from ..storage.diskqueue import DiskQueue


class BackupContainer:
    """One backup's files under `prefix` in a (sim) filesystem."""

    def __init__(self, fs, prefix: str, process=None) -> None:
        self.fs = fs
        self.prefix = prefix
        self.log_dq = DiskQueue(fs.open(f"{prefix}-log.dq", process))
        self.snap_dq = DiskQueue(fs.open(f"{prefix}-snapshot.dq", process))

    def log_writer(self):
        """The queue a (re)started backup worker streams into."""
        return self.log_dq

    async def read(self):
        """-> (chunks, log), the async read surface restore() uses (the
        file scheme has no network: this just wraps the sync path)."""
        return read_backup(self)


class BlobBackupContainer:
    """One backup's objects under `<name>/` in a blob store: each log
    sync and each snapshot chunk batch is one immutable checksummed
    object.  `uid` supplies the per-writer nonces — each call must return
    a FRESH value (pass the cluster rng's random_unique_id under
    simulation: object names must be deterministic per seed); the default
    is a process-wide counter, unique per call and deterministic per
    construction order."""

    _uid_seq = 0  # class-wide: default nonces never collide across
                  # containers or replacement writers in one process

    def __init__(self, client, name: str, uid=None) -> None:
        from ..storage.blobstore import BlobQueue

        self.client = client
        self.name = name.strip("/")
        self._uid = uid or self._next_uid
        # the log queue is writer-owned and created per (re)started worker
        # by log_writer() — a verify-only open never allocates one
        self.log_dq = None
        self.snap_dq = BlobQueue(client, f"{self.name}/snapshot", self._uid())

    @classmethod
    def _next_uid(cls) -> str:
        cls._uid_seq += 1
        return f"w{cls._uid_seq:06d}"

    def log_writer(self):
        """A FRESH log queue per (re)started worker: a replacement
        uploader must never share an upload namespace with a dead
        predecessor whose finalize may still be in flight."""
        from ..storage.blobstore import BlobQueue

        self.log_dq = BlobQueue(self.client, f"{self.name}/log", self._uid())
        return self.log_dq

    async def read(self):
        """-> (chunks, log) out of the object store: only COMPLETED
        objects are visible, every body is crc-verified by the client,
        and duplicate log versions (a worker that died between finalize
        and pop re-uploaded its frames) collapse to one."""
        from ..storage.blobstore import BlobQueue

        log_q = self.log_dq or BlobQueue(
            self.client, f"{self.name}/log", self._uid()
        )
        chunks = [_decode_chunk(b) for b in await self.snap_dq.recover()]
        log = [decode_log_frame(b) for b in await log_q.recover()]
        return chunks, _sorted_dedup_log(log)


def backup_container(url: str | None = None, *, fs=None, process=None,
                     blob_client=None, uid=None):
    """The container URL factory (BackupContainer.actor.cpp
    openContainer): `file://<prefix>` (or a bare prefix) opens the
    DiskQueue-backed container inside `fs`; `blob://<name>` opens a
    BlobBackupContainer over the caller's blob client (the simulation
    path); `http://host:port/<name>` dials a BlobStoreServer over real
    sockets.  The URL is required: no environment variable supplies a
    default (the reference falls back to FDBTPU_BLOB_URL)."""
    if not url:
        raise ValueError("no backup container URL: pass one")
    if url.startswith("blob://"):
        if blob_client is None:
            raise ValueError("blob:// container needs blob_client=")
        return BlobBackupContainer(blob_client, url[len("blob://"):], uid=uid)
    if url.startswith("http://"):
        from ..storage.blobstore import BlobStoreClient, HttpBlobTransport

        hostport, _, name = url[len("http://"):].partition("/")
        host, _, port = hostport.partition(":")
        client = blob_client or BlobStoreClient(
            HttpBlobTransport(host, int(port or 80))
        )
        return BlobBackupContainer(client, name or "backup", uid=uid)
    prefix = url[len("file://"):] if url.startswith("file://") else url
    if fs is None:
        raise ValueError("file:// container needs fs=")
    return BackupContainer(fs, prefix, process)


def _sorted_dedup_log(log):
    """Version-sorted log with duplicate versions collapsed (a backup
    worker that died between making a frame durable and popping it
    re-reads and re-writes the same frame; applying an ADD twice would
    corrupt the restore)."""
    log.sort(key=lambda e: e[0])
    out = []
    for version, muts in log:
        if out and out[-1][0] == version:
            continue
        out.append((version, muts))
    return out


def _encode_chunk(begin: bytes, end: bytes, version: int, rows) -> bytes:
    w = BinaryWriter().bytes_(begin).bytes_(end).i64(version).u32(len(rows))
    for k, v in rows:
        w.bytes_(k).bytes_(v)
    return w.data()


def _decode_chunk(buf: bytes):
    r = BinaryReader(buf)
    begin, end, version = r.bytes_(), r.bytes_(), r.i64()
    rows = [(r.bytes_(), r.bytes_()) for _ in range(r.u32())]
    return begin, end, version, rows


class BackupAgent:
    """Drives one backup of a RecoverableCluster into a container."""

    def __init__(self, cluster) -> None:
        self.cluster = cluster
        self.worker: BackupWorker | None = None
        self.start_version: int | None = None

    async def start(self, container: BackupContainer) -> int:
        """Begin continuous mutation-log capture; returns the boundary
        version (log complete above it)."""
        cc = self.cluster.controller
        proc = self.cluster.net.create_process("backup-worker")
        # starting below the boundary is safe: the backup tag has no entries
        # before it, so the first peek fast-forwards the cursor
        w = BackupWorker(
            proc, self.cluster.loop, container.log_writer(), start_version=0
        )
        while True:
            vm = await cc.enable_backup(w)
            if vm is not None:
                self.worker = w
                self.start_version = vm
                return vm
            await self.cluster.loop.delay(0.1, TaskPriority.COORDINATION)

    def kill_worker(self) -> None:
        """Power-kill the uploader mid-stream: the worker's task dies at
        its current await point — possibly inside a multipart upload,
        leaving staged parts with no finalize — and its process vanishes.
        The backup tag keeps retaining on the TLogs (pops stop with the
        dead worker), so restart_worker() loses nothing."""
        assert self.worker is not None, "no running backup worker to kill"
        self.worker.stop()
        self.worker.process.kill()
        self.worker = None

    async def restart_worker(self, container) -> None:
        """The uploader-restart path: a killed worker's replacement rejoins
        the backup tag on the current generation (the tag was never
        unregistered, only dark) and re-pulls from its own floor — frames
        the dead worker staged but never finalized are re-uploaded under a
        fresh writer nonce; frames it DID finalize but never popped are
        re-read and deduplicated by version at restore time."""
        from ..roles.backup import BACKUP_TAG
        from ..runtime.coverage import testcov

        cc = self.cluster.controller
        assert BACKUP_TAG in cc.stream_consumers, (
            "restart_worker needs a started backup (the tag registration "
            "outlives the dead worker)"
        )
        proc = self.cluster.net.create_process(
            f"backup-worker-{self.cluster.rng.random_unique_id()[:4]}"
        )
        w = BackupWorker(
            proc, self.cluster.loop, container.log_writer(), start_version=0
        )
        cc.stream_consumers[BACKUP_TAG] = w
        while True:
            gen = cc.generation
            if gen is not None and not cc._recovering:
                break
            await self.cluster.loop.delay(0.1, TaskPriority.COORDINATION)
        cc._wire_stream_consumer(gen, BACKUP_TAG)
        self.worker = w
        testcov("backup.worker_restarted")

    async def snapshot(self, container: BackupContainer, chunk_rows: int = 500) -> int:
        """Chunked full-range dump; returns the max chunk version (the
        backup is restorable once the log passes it)."""
        db = self.cluster.database()
        cursor = b""
        max_v = self.start_version or 0
        from ..keys import key_after

        while True:
            # user range only ([\x00, \xff)): the system keyspace describes
            # THIS cluster's configuration and must not be restored into
            # another (the reference's default backup range)
            tr = db.create_transaction()
            rows = await tr.get_range(cursor, b"\xff", limit=chunk_rows,
                                      snapshot=True)
            v = await tr.get_read_version()
            end = key_after(rows[-1][0]) if len(rows) == chunk_rows else b"\xff"
            container.snap_dq.push(_encode_chunk(cursor, end, v, rows))
            max_v = max(max_v, v)
            if len(rows) < chunk_rows:
                break
            cursor = end
        await container.snap_dq.sync()
        return max_v

    async def wait_backed_up_to(self, version: int, timeout: float = 60.0) -> None:
        from ..runtime.combinators import timeout_error

        await timeout_error(
            self.cluster.loop, self.worker.backed_up.when_at_least(version), timeout
        )

    async def stop(self) -> None:
        try:
            await self.cluster.controller.disable_backup()
        finally:
            if self.worker is not None:
                self.worker.stop()
                self.worker = None


def read_backup(container: BackupContainer):
    """Parse a file container → (chunks, log) for restore/inspection."""
    chunks = [_decode_chunk(b) for b in container.snap_dq.recover()]
    log = [decode_log_frame(b) for b in container.log_dq.recover()]
    return chunks, _sorted_dedup_log(log)


def _restore_plan(chunks, log, target_version: int | None):
    """The ONE clip computation restore() and apply_backup() share: sorted
    snapshot rows plus the log mutations that apply — each clipped so it
    only lands where its version exceeds the covering chunk's version —
    up to target_version.  Returns (rows, ops, target_version)."""
    if not chunks:
        raise ValueError("backup has no snapshot")
    # chunk version step function over keyspace (chunks are disjoint)
    chunks = sorted(chunks, key=lambda c: c[0])
    bounds = [c[0] for c in chunks]
    cvers = [c[2] for c in chunks]
    restorable_from = max(cvers)
    if target_version is None:
        # the log's last FRAME may sit below the newest chunk when no
        # tagged mutation landed in between (coverage advanced through
        # empty versions): the restorable floor still holds
        target_version = max(log[-1][0] if log else 0, restorable_from)
    if target_version < restorable_from:
        raise ValueError(
            f"target {target_version} below newest chunk {restorable_from}"
        )

    def chunk_version_at(key: bytes) -> int:
        i = bisect.bisect_right(bounds, key) - 1
        return cvers[i] if i >= 0 else 0

    rows: list[tuple[bytes, bytes]] = []
    for _b, _e, _v, chunk_rows in chunks:
        rows.extend(chunk_rows)

    ops: list[Mutation] = []
    for version, muts in log:
        if version > target_version:
            break
        for m in muts:
            if m.type == MutationType.CLEAR_RANGE:
                # user range only, split at chunk boundaries; keep parts
                # where the chunk predates the clear
                ce = min(m.value, b"\xff")
                if m.key >= ce:
                    continue
                pts = [m.key] + [b for b in bounds if m.key < b < ce] + [ce]
                for lo, hi in zip(pts, pts[1:]):
                    if version > chunk_version_at(lo):
                        ops.append(Mutation(MutationType.CLEAR_RANGE, lo, hi))
            elif m.key >= b"\xff":
                continue  # system keyspace: not part of the backup
            elif version > chunk_version_at(m.key):
                ops.append(m)
    return rows, ops, target_version


def apply_backup(chunks, log, target_version: int | None = None
                 ) -> dict[bytes, bytes]:
    """Fold a backup into an in-memory key→value dict — the restore
    REFEREE: exactly the state restore() would materialize, without a
    cluster.  Tests and the BlobBackup workload compare this against the
    committed model byte-for-byte."""
    from ..roles.types import apply_atomic

    rows, ops, _tv = _restore_plan(chunks, log, target_version)
    state: dict[bytes, bytes] = dict(rows)
    for m in ops:
        if m.type == MutationType.SET_VALUE:
            state[m.key] = m.value
        elif m.type == MutationType.CLEAR_RANGE:
            for k in [k for k in state if m.key <= k < m.value]:
                del state[k]
        else:
            state[m.key] = apply_atomic(m.type, state.get(m.key), m.value)
    return state


async def restore(db, container, target_version: int | None = None,
                  batch: int = 300) -> int:
    """Restore a backup into an (empty-range) database.  Applies snapshot
    chunks, then replays the mutation log where version > the covering
    chunk's version, up to target_version (default: everything captured).
    Works against either container scheme (the blob path reads only
    completed, checksum-verified objects — a torn upload is refused, so
    it can never be restored).  Returns the version the restored state
    corresponds to."""
    chunks, log = await container.read()
    rows, ops, target_version = _restore_plan(chunks, log, target_version)

    # 1. snapshot chunks, batched transactions
    for i in range(0, len(rows), batch):
        part = rows[i : i + batch]

        async def fn(tr, part=part):
            for k, v in part:
                tr.set(k, v)

        await db.run(fn)

    # 2. log replay, clipped per chunk version
    for i in range(0, len(ops), batch):
        part = ops[i : i + batch]

        async def fn(tr, part=part):
            for m in part:
                if m.type == MutationType.SET_VALUE:
                    tr.set(m.key, m.value)
                elif m.type == MutationType.CLEAR_RANGE:
                    tr.clear_range(m.key, m.value)
                else:
                    tr.atomic_op(m.type, m.key, m.value)

        await db.run(fn)
    return target_version
