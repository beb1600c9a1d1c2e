"""TaskBucket — a distributed, transactional task queue IN the keyspace
(fdbclient/TaskBucket.actor.cpp: the work-scheduling layer the reference's
backup/DR agents are built on).

Everything is ordinary transactional data, so the queue inherits the
database's guarantees: adding a task is atomic with the transaction that
decides to add it, claiming is contention-checked (two workers cannot claim
the same task), and a claimed task whose worker dies is RE-queued when its
lease — measured in database versions, the cluster's only shared clock —
expires.  Execution is therefore at-least-once; handlers must be
idempotent (exactly the reference's contract).

Layout (tuple-layer keys under the bucket prefix):
    (prefix, "a", task_id)            -> packed params     (available)
    (prefix, "c", lease_end, task_id) -> packed params     (claimed)

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

from .tuple_layer import Subspace
from ..runtime.core import ActorCancelled, TaskPriority


def _pack_params(params: dict[bytes, bytes]) -> bytes:
    from ..runtime.serialize import BinaryWriter

    w = BinaryWriter().u32(len(params))
    for k in sorted(params):
        w.bytes_(k).bytes_(params[k])
    return w.data()


def _unpack_params(blob: bytes) -> dict[bytes, bytes]:
    from ..runtime.serialize import BinaryReader

    r = BinaryReader(blob)
    return {r.bytes_(): r.bytes_() for _ in range(r.u32())}


class Task:
    def __init__(self, task_id: bytes, params: dict[bytes, bytes],
                 lease_end: int) -> None:
        self.id = task_id
        self.params = params
        self.lease_end = lease_end


class TaskBucket:
    def __init__(self, prefix: bytes = b"tb",
                 lease_versions: int = 2_000_000) -> None:
        self.space = Subspace((prefix,))
        self.avail = self.space.subspace(("a",))
        self.claimed = self.space.subspace(("c",))
        self.lease_versions = lease_versions  # ~2s of version time

    # -- producer ------------------------------------------------------------
    def add(self, tr, task_id: bytes, params: dict[bytes, bytes]) -> None:
        """Transactional add: atomic with whatever else `tr` does."""
        params = {**params, b"__type__": params.get(b"__type__", b"")}
        tr.set(self.avail.pack((task_id,)), _pack_params(params))

    # -- consumer ------------------------------------------------------------
    async def claim_one(self, tr) -> Task | None:
        """Claim the first available task: move it under (c, lease_end) —
        the write conflict on the moved key is what makes two concurrent
        claimers collide (one retries and takes the next task)."""
        rows = await tr.get_range(*self.avail.range(), limit=1)
        if not rows:
            await self._requeue_expired(tr, limit=5)
            return None
        key, blob = rows[0]
        (task_id,) = self.avail.unpack(key)
        v = await tr.get_read_version()
        lease_end = v + self.lease_versions
        tr.clear(key)
        tr.set(self.claimed.pack((lease_end, task_id)), blob)
        return Task(task_id, _unpack_params(blob), lease_end)

    def extend(self, tr, task: Task, new_lease_end: int) -> None:
        tr.clear(self.claimed.pack((task.lease_end, task.id)))
        tr.set(
            self.claimed.pack((new_lease_end, task.id)),
            _pack_params(task.params),
        )
        task.lease_end = new_lease_end

    def finish(self, tr, task: Task) -> None:
        """Done: remove the claim.  Run inside the handler's FINAL
        transaction so completion is atomic with the task's own writes."""
        tr.clear(self.claimed.pack((task.lease_end, task.id)))

    async def _requeue_expired(self, tr, limit: int = 5) -> int:
        """Leases are version-ordered keys: everything below (c, now) is an
        expired claim from a dead/stalled worker — move it back."""
        v = await tr.get_read_version()
        begin, _end = self.claimed.range()
        upto = self.claimed.pack((v,))
        rows = await tr.get_range(begin, upto, limit=limit)
        for key, blob in rows:
            _lease, task_id = self.claimed.unpack(key)
            tr.clear(key)
            tr.set(self.avail.pack((task_id,)), blob)
        return len(rows)

    async def is_empty(self, tr) -> bool:
        a = await tr.get_range(*self.avail.range(), limit=1)
        c = await tr.get_range(*self.claimed.range(), limit=1)
        return not a and not c


class TaskBucketExecutor:
    """Worker pool draining a bucket: claim → run handler → finish, with
    the at-least-once re-queue covering worker death (the reference's
    backup agents run exactly this loop)."""

    def __init__(self, db, bucket: TaskBucket, handlers: dict[bytes, callable],
                 poll_interval: float = 0.05) -> None:
        self.db = db
        self.bucket = bucket
        self.handlers = handlers
        self.poll_interval = poll_interval
        self.executed: list[bytes] = []
        self._stopped = False
        self._task = db.loop.spawn(self._run(), TaskPriority.DEFAULT_ENDPOINT,
                                   "taskbucket-worker")

    async def _run(self) -> None:
        while not self._stopped:
            claimed = None

            async def fn(tr):
                nonlocal claimed
                claimed = await self.bucket.claim_one(tr)

            try:
                await self.db.run(fn)
            except ActorCancelled:
                raise  # stop() cancelled the worker: die, don't keep polling
            except Exception:  # noqa: BLE001 — cluster transient: retry
                claimed = None
            if claimed is None:
                await self.db.loop.delay(self.poll_interval)
                continue
            handler = self.handlers.get(claimed.params.get(b"__type__", b""))
            if handler is not None:
                await handler(self.db, claimed)
            self.executed.append(claimed.id)

            async def done(tr):
                self.bucket.finish(tr, claimed)

            try:
                await self.db.run(done)
            except ActorCancelled:
                raise  # cancelled mid-finish: the lease re-queues the task
            except Exception:  # noqa: BLE001 — lease will re-queue it
                pass

    def stop(self) -> None:
        self._stopped = True
        self._task.cancel()
