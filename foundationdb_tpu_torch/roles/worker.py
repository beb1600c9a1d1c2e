"""Worker — the process-bootstrap half of the reference's fdbserver
(fdbserver/worker.actor.cpp:577 workerServer; RegisterWorkerRequest in
ClusterController.actor.cpp; ProcessClass fitness, ProcessClass.h).

A worker is a registered, role-less process.  The cluster controller
recruits pipeline roles ONTO workers by RPC: the recruit request carries
only plain data and endpoint tokens, the worker constructs the role bound
to its own process (initializeTLog/initializeCommitProxy... in the
reference) and replies with the role's interface.  Killing a worker kills
every role it hosts — the failure unit the controller's monitor watches.

Process classes bias placement exactly like the reference's fitness order:
"transaction" workers prefer TLogs, "stateless" prefer
sequencer/proxy/resolver, "storage" prefer storage servers; any class can
host anything when preferred workers run out (fitness, not capability).

In this runtime the recruit reply carries the role OBJECT alongside its
endpoints — the simulation analog of the reference returning an interface
struct; a cross-OS-process deployment would return only the endpoint
tokens (rpc/transport.py serves them the same way).

Copy of the reference package's module, on the port's roles and rpc.  Its
registries (`SIM_ROLE_HANDLES`, `CONFLICT_FACTORIES`) are this module's
own, apart from the reference's.
"""

from __future__ import annotations

import dataclasses

from .proxy import CommitProxy, KeyPartitionMap
from .resolver import Resolver
from .sequencer import Sequencer
from .tlog import TLog
from ..rpc.network import Endpoint, SimProcess
from ..rpc.stream import RequestStream, RequestStreamRef
from ..runtime.core import EventLoop, TaskPriority

WLT_RECRUIT = "wlt:worker_recruit"
WLT_REGISTER = "wlt:cc_register_worker"
WLT_PING = "wlt:ping"

PREFERRED_CLASS = {
    "tlog": "transaction",
    "sequencer": "stateless",
    "proxy": "stateless",
    "resolver": "stateless",
    "storage": "storage",
}


@dataclasses.dataclass
class RecruitRoleRequest:
    kind: str
    epoch: int
    params: dict


@dataclasses.dataclass
class RecruitRoleReply:
    handle: str           # key into SIM_ROLE_HANDLES (see below)
    endpoints: dict       # name -> Endpoint (what a remote caller would get)


# The sim fabric deep-copies every payload (its serialization boundary), so
# a live role object cannot ride in a reply.  The reply carries endpoints +
# an opaque handle; the recruiting controller resolves the handle here —
# the simulation's stand-in for the interface struct a remote caller would
# deserialize.  Cross-OS-process deployments use the endpoints alone.
SIM_ROLE_HANDLES: dict[str, object] = {}

# Conflict-set construction is config in the reference (an engine choice the
# worker binary knows how to build); tests inject arbitrary factories, so
# the recruit RPC carries a plain token resolved here — same boundary
# discipline as SIM_ROLE_HANDLES, never a live callable in a payload.
CONFLICT_FACTORIES: dict[str, object] = {}


@dataclasses.dataclass
class DestroyGenerationRequest:
    epoch: int


@dataclasses.dataclass
class PruneGenerationRequest:
    """Stop this epoch's roles whose nonce is NOT in keep (orphans from a
    recruit retry whose first reply timed out in flight), and every role of
    epochs below `below_epoch` except keep_epoch (aborted recoveries)."""

    epoch: int
    keep_nonces: list
    below_epoch: int
    keep_epoch: int


@dataclasses.dataclass
class RegisterWorkerRequest:
    recruit_endpoint: Endpoint
    process_class: str
    machine: str | None
    name: str


class Worker:
    def __init__(self, process: SimProcess, loop: EventLoop, knobs,
                 register_ref: RequestStreamRef | None = None,
                 process_class: str = "unset", fs=None) -> None:
        self.process = process
        self.loop = loop
        self.knobs = knobs
        self.fs = fs
        self.pclass = process_class
        self.recruit_stream = RequestStream(process, WLT_RECRUIT)
        self._ping_stream = RequestStream(process, WLT_PING)
        self.hosted: dict[int, list] = {}  # epoch -> roles
        self._register_ref = register_ref
        self._tasks = [
            loop.spawn(self._serve(), TaskPriority.COORDINATION, "worker-recruit"),
            loop.spawn(self._pong(), TaskPriority.COORDINATION, "worker-ping"),
        ]
        if register_ref is not None:
            self._tasks.append(
                loop.spawn(self._register(), TaskPriority.COORDINATION,
                           "worker-register")
            )

    async def _pong(self) -> None:
        while True:
            req = await self._ping_stream.next()
            req.reply("pong")

    async def _register(self) -> None:
        """Periodic registration: a freshly elected controller learns the
        worker pool without any handshake ordering (the reference's workers
        re-register on every cluster-controller change)."""
        while True:
            self._register_ref.send(
                RegisterWorkerRequest(
                    recruit_endpoint=self.recruit_stream.endpoint,
                    process_class=self.pclass,
                    machine=self.process.machine,
                    name=self.process.name,
                )
            )
            await self.loop.delay(0.5, TaskPriority.COORDINATION)

    async def _serve(self) -> None:
        while True:
            req = await self.recruit_stream.next()
            r = req.payload
            if isinstance(r, DestroyGenerationRequest):
                for _nonce, role in self.hosted.pop(r.epoch, []):
                    role.stop()
                req.reply(None)
                continue
            if isinstance(r, PruneGenerationRequest):
                keep = set(r.keep_nonces)
                kept = []
                for nonce, role in self.hosted.pop(r.epoch, []):
                    if nonce in keep:
                        kept.append((nonce, role))
                    else:
                        role.stop()  # recruit-retry orphan
                if kept:
                    self.hosted[r.epoch] = kept
                for e in [
                    e for e in self.hosted
                    if e < r.below_epoch and e != r.keep_epoch
                ]:
                    for _nonce, role in self.hosted.pop(e):
                        role.stop()  # aborted recovery's leftovers
                req.reply(None)
                continue
            try:
                role, endpoints = self._build(r.kind, r.params)
            except Exception as e:  # noqa: BLE001 — recruitment failure is
                req.reply_error(e)  # the controller's signal to try another
                continue
            nonce = r.params.get("nonce", self.process.new_token())
            self.hosted.setdefault(r.epoch, []).append((nonce, role))
            handle = self.process.new_token()
            SIM_ROLE_HANDLES[handle] = role
            req.reply(RecruitRoleReply(handle=handle, endpoints=endpoints))

    # -- role factories (initializeXxx in the reference's workerServer) ------
    def _build(self, kind: str, p: dict):
        proc, loop = self.process, self.loop
        if kind == "sequencer":
            s = Sequencer(proc, loop, self.knobs, start_version=p["start_version"])
            return s, {"stream": s.stream.endpoint}
        if kind == "tlog":
            dq = None
            if self.fs is not None and p.get("path"):
                from ..storage.diskqueue import DiskQueue
                from ..storage.pagecache import maybe_cached

                # the TLog's queue file rides the shared page cache too
                # (spilled-entry re-reads are its hot read path)
                dq = DiskQueue(maybe_cached(self.fs, self.fs.open(p["path"], proc)))
            t = TLog(proc, loop, start_version=p["start_version"],
                     initial_tags=p["seeds"], known_committed=p["known_committed"],
                     disk_queue=dq, spill_bytes=self.knobs.TLOG_SPILL_BYTES,
                     hard_limit_bytes=self.knobs.TLOG_HARD_LIMIT_BYTES,
                     # the cluster assembly binds its collector to the fs
                     # (workers have no trace handle of their own)
                     trace=getattr(self.fs, "trace", None))
            return t, {
                "commit": t.commit_stream.endpoint,
                "peek": t.peek_stream.endpoint,
                "pop": t.pop_stream.endpoint,
                "lock": t.lock_stream.endpoint,
                "confirm": t.confirm_stream.endpoint,
            }
        if kind == "resolver":
            make_cs = CONFLICT_FACTORIES[p["conflict_backend"]]
            r = Resolver(proc, loop, self.knobs, make_cs(p["oldest"]),
                         start_version=p["start_version"])
            return r, {"stream": r.stream.endpoint}
        if kind == "proxy":
            def ref(ep: Endpoint) -> RequestStreamRef:
                return RequestStreamRef(proc.net, proc, ep)

            px = CommitProxy(
                proc, loop, self.knobs,
                sequencer_ref=ref(p["sequencer"]),
                resolver_refs=[ref(e) for e in p["resolvers"]],
                resolver_splits=p["resolver_splits"],
                tlog_refs=[ref(e) for e in p["tlog_commits"]],
                storage_tags=KeyPartitionMap(p["storage_splits"], p["storage_teams"]),
                tag_to_tlogs=p["tag_to_tlogs"],
                start_version=p["start_version"],
                tlog_confirm_refs=[ref(e) for e in p["tlog_confirms"]],
            )
            return px, {
                "commit": px.commit_stream.endpoint,
                "grv": px.grv_stream.endpoint,
                "raw": px.raw_version_stream.endpoint,
            }
        raise ValueError(f"unknown role kind {kind!r}")

    def stop(self) -> None:
        for roles in self.hosted.values():
            for _nonce, role in roles:
                role.stop()
        self.hosted.clear()
        for t in self._tasks:
            t.cancel()
