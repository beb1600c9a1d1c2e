"""Coordinators: replicated generation registers — the cluster's ground truth
(fdbserver/Coordination.actor.cpp: GenerationRegVal :31, localGenerationReg
:125; CoordinatedState quorum logic fdbserver/CoordinatedState.actor.cpp).

Each coordinator holds a single versioned register (the serialized cluster
state).  Reads and writes use the Paxos-register discipline the reference
uses: a client first `read`s with a fresh read-generation from a majority
(learning the newest value and the highest write-generation seen), then
`write`s with a higher generation to a majority.  Two masters racing for
the register cannot both succeed — the loser's generation is stale and a
majority rejects it, which is exactly how split-brain is prevented during
recovery (SURVEY §3.3).

Copy of the reference package's module, on the port's own modules.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..rpc.network import SimProcess
from ..rpc.stream import RequestStream, RequestStreamRef
from ..runtime.combinators import wait_any
from ..runtime.buggify import maybe_delay
from ..runtime.core import EventLoop, Future, Promise, TaskPriority, TimedOut
from ..runtime.coverage import testcov


@dataclasses.dataclass(frozen=True, order=True)
class Generation:
    """(batch, id) ordered pair (reference UniqueGeneration)."""

    number: int
    owner: str


GEN_ZERO = Generation(0, "")


@dataclasses.dataclass
class ReadRegRequest:
    read_gen: Generation


@dataclasses.dataclass
class ReadRegReply:
    value: Any
    write_gen: Generation   # generation that wrote `value`
    read_gen: Generation    # highest read/write generation promised


@dataclasses.dataclass
class WriteRegRequest:
    value: Any
    write_gen: Generation


@dataclasses.dataclass
class WriteRegReply:
    ok: bool
    promised: Generation


class Coordinator:
    """One coordination server: a generation register, disk-backed when a
    filesystem is given (the reference's OnDemandStore-backed
    localGenerationReg — registers must survive whole-cluster restarts or
    recovery cannot find the last log-system epoch)."""

    WLT_READ = "wlt:coord_read"
    WLT_WRITE = "wlt:coord_write"

    def __init__(self, process: SimProcess, loop: EventLoop,
                 fs=None, path: str | None = None,
                 tokens: tuple[str, str] | None = None) -> None:
        """`tokens` overrides the well-known stream tokens so one process
        can host several registers (the reference's coordinators serve the
        cstate AND the leader-election register from one server)."""
        self.process = process
        self.loop = loop
        self.value: Any = None
        self.write_gen: Generation = GEN_ZERO
        self.promised: Generation = GEN_ZERO
        self._persists = 0
        self._file = None
        if fs is not None:
            self._file = fs.open(path or f"coord-{process.name}.reg", process)
            self._load()
        read_tok, write_tok = tokens or (self.WLT_READ, self.WLT_WRITE)
        self.read_stream = RequestStream(process, read_tok)
        self.write_stream = RequestStream(process, write_tok)
        self._tasks = [
            loop.spawn(self._serve_read(), TaskPriority.COORDINATION, "coord-read"),
            loop.spawn(self._serve_write(), TaskPriority.COORDINATION, "coord-write"),
        ]

    # -- durability ---------------------------------------------------------
    def _load(self) -> None:
        import json

        from ..storage.diskqueue import DiskQueue

        records = DiskQueue(self._file).recover()
        if records:
            doc = json.loads(records[-1])  # last synced write wins
            self.value = doc["value"]
            self.write_gen = Generation(*doc["write_gen"])
            self.promised = Generation(*doc["promised"])

    async def _persist(self) -> None:
        import json

        from ..storage.diskqueue import DiskQueue

        # append-only (recover() takes the last record); every ~64 writes
        # the log is compacted to one record via the JOURNALED truncate
        # (diskqueue.rewrite keeps the old synced contents recoverable until
        # the replacement syncs), so read-promise churn can't grow the file
        # unboundedly
        self._persists += 1
        dq = DiskQueue(self._file)
        if self._persists % 64 == 0:
            dq.rewrite([])
        dq.push(
            json.dumps(
                {
                    "value": self.value,
                    "write_gen": [self.write_gen.number, self.write_gen.owner],
                    "promised": [self.promised.number, self.promised.owner],
                },
                sort_keys=True,
            ).encode()
        )
        await dq.sync()

    async def _persist_retried(self) -> bool:
        """Persist the register, retrying transient disk faults (the
        injected-error plane, storage/files.py) a few times.  False —
        persistently refused — means the caller must NOT ack the request:
        a promise/write that is not durable may not be acknowledged.  It
        must equally NOT kill the serve loop, which would take this
        coordinator out of the quorum forever (found by the DiskSwizzle
        chaos: erode 2 of 3 registers and recovery wedges for good).  The
        in-memory state staying stricter/ahead of disk is the safe
        direction — the prepared-but-unacked state every quorum round
        already tolerates."""
        for attempt in range(3):
            try:
                await self._persist()
                return True
            except IOError:
                testcov("coord.persist_io_error")
                await self.loop.delay(0.02 * (attempt + 1),
                                      TaskPriority.COORDINATION)
        return False

    async def _serve_read(self) -> None:
        while True:
            req = await self.read_stream.next()
            await maybe_delay(self.loop, "coord.delay_read")
            r: ReadRegRequest = req.payload
            if r.read_gen > self.promised:
                self.promised = r.read_gen
                if self._file is not None and not await self._persist_retried():
                    continue  # refused: requester times out and retries
            req.reply(ReadRegReply(self.value, self.write_gen, self.promised))

    async def _serve_write(self) -> None:
        while True:
            req = await self.write_stream.next()
            await maybe_delay(self.loop, "coord.delay_write")
            r: WriteRegRequest = req.payload
            if r.write_gen >= self.promised:
                self.promised = r.write_gen
                self.write_gen = r.write_gen
                self.value = r.value
                if self._file is not None and not await self._persist_retried():
                    continue  # refused: no durable write, no ack
                req.reply(WriteRegReply(True, self.promised))
            else:
                req.reply(WriteRegReply(False, self.promised))

    def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        self.read_stream.close()
        self.write_stream.close()


class CoordinatedState:
    """Majority-quorum client over the coordinators (CoordinatedState.actor.cpp):
    read-then-conditional-write of the replicated cluster state."""

    def __init__(self, loop: EventLoop, read_refs: list[RequestStreamRef],
                 write_refs: list[RequestStreamRef], owner: str) -> None:
        self.loop = loop
        self._reads = read_refs
        self._writes = write_refs
        self._owner = owner
        self._gen_number = 0

    @property
    def quorum_size(self) -> int:
        return len(self._reads) // 2 + 1

    async def _majority(self, futures: list[Future]) -> list:
        """Collect replies until a majority succeeded.  Individual failures
        (dead coordinator → BrokenPromise, unreachable → TimedOut) are
        skipped; the call fails only when a majority can no longer succeed."""
        need = self.quorum_size
        got: list = []
        failures = 0
        pending: list[Future] = []
        for f in futures:
            p = Promise()

            def settle(fut: Future, p=p) -> None:
                err = fut.exception()
                p.send((False, err) if err is not None else (True, fut.result()))

            f.add_done_callback(settle)
            pending.append(p.future)
        while pending and len(got) < need:
            idx, (ok, result) = await wait_any(pending)
            pending.pop(idx)
            if ok:
                got.append(result)
            else:
                failures += 1
                if failures > len(futures) - need:
                    raise TimedOut("no coordinator quorum")
        if len(got) < need:
            raise TimedOut("no coordinator quorum")
        return got

    async def read(self) -> tuple[Any, Generation]:
        self._gen_number += 1
        rg = Generation(self._gen_number, self._owner)
        replies = await self._majority(
            [ref.get_reply(ReadRegRequest(rg), timeout=2.0) for ref in self._reads]
        )
        # newest write wins; also learn any higher promised generation
        best = max(replies, key=lambda r: r.write_gen)
        top_promise = max(r.read_gen for r in replies)
        if top_promise.number > self._gen_number:
            self._gen_number = top_promise.number
        return best.value, best.write_gen

    async def write(self, value: Any) -> bool:
        """Conditional write with a fresh higher generation; False = lost the
        race to a newer writer (caller must re-read and reconsider)."""
        self._gen_number += 1
        wg = Generation(self._gen_number, self._owner)
        replies = await self._majority(
            [
                ref.get_reply(WriteRegRequest(value, wg), timeout=2.0)
                for ref in self._writes
            ]
        )
        ok = sum(1 for r in replies if r.ok) >= self.quorum_size
        if not ok:
            top = max(r.promised for r in replies)
            if top.number > self._gen_number:
                self._gen_number = top.number
        return ok
