"""Simulated network fabric — the Sim2 analog (fdbrpc/sim2.actor.cpp:714).

The reference's deepest architectural property is that the transport is a
seam: Net2 (real TCP) and Sim2 (simulated, deterministic) implement the same
INetwork, so whole clusters run in one seeded process.  This module is that
simulated world for the Python control plane: `SimNetwork` owns simulated
processes, delivers endpoint-addressed messages with seeded latency, and
injects faults — clogging (sim2 SimClogging :108, clogPair :1477),
partitions, process kills/reboots (fdbrpc/simulator.h:148-153).

Messages cross a serialization boundary at send time: payloads with a
registered wire codec (runtime/serialize.py, docs/WIRE.md) round-trip
through the SAME binary encoders the real TCP transport uses — so every
seeded simulation, chaos sweep, and serializability test exercises the
production wire format — and anything else is deep-copied (counted as a
codec fallback in `wire`).  Either way a simulated process can never share
mutable state with a peer, the same isolation the wire gives the reference.

The RPC vocabulary (RequestStream/ReplyPromise, fdbrpc/fdbrpc.h:217) lives
in rpc/stream.py on top of this fabric; roles only see that typed layer, so
a future real-TCP fabric slots in under them unchanged.

Copy of the reference package's module: the same seed draws the same
latencies in the same order, so the same traffic is delivered at the same
virtual times in both packages.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable

from ..runtime.core import (
    BrokenPromise,
    DeterministicRandom,
    EventLoop,
    Future,
    Promise,
    TaskPriority,
)
from ..runtime.metrics import WireStats
from ..runtime.serialize import Unencodable, decode_payload, encode_payload
from ..runtime.trace import TraceCollector


@dataclasses.dataclass(frozen=True, order=True)
class NetworkAddress:
    ip: str
    port: int

    def __str__(self) -> str:
        return f"{self.ip}:{self.port}"


@dataclasses.dataclass(frozen=True)
class Endpoint:
    """(address, token): the reference's routing pair (FlowTransport.h:34)."""

    address: NetworkAddress
    token: str


class EndpointTable:
    """Token -> handler table shared by the simulated and real process
    objects (the FlowTransport endpoint map).  Delivery to a dead process or
    an unknown token is dropped, like the reference's unknown-endpoint path."""

    def __init__(self, address: NetworkAddress, name: str) -> None:
        self.address = address
        self.name = name
        self.alive = True
        self._endpoints: dict[str, Callable[[Any], None]] = {}

    def register(self, token: str, handler: Callable[[Any], None]) -> Endpoint:
        self._endpoints[token] = handler
        return Endpoint(self.address, token)

    def unregister(self, token: str) -> None:
        self._endpoints.pop(token, None)

    def _deliver(self, token: str, payload: Any) -> None:
        if not self.alive:
            return
        handler = self._endpoints.get(token)
        if handler is not None:
            handler(payload)


class SimProcess(EndpointTable):
    """A simulated process: endpoint table + lifecycle (ISimulator::ProcessInfo).
    `machine`/`dc` are locality labels (ISimulator machine/data-hall model,
    fdbrpc/sim2.actor.cpp:714): killing a machine kills every process on it."""

    def __init__(self, net: "SimNetwork", address: NetworkAddress, name: str,
                 machine: str | None = None, dc: str | None = None) -> None:
        super().__init__(address, name)
        self.net = net
        self.machine = machine
        self.dc = dc
        self.reboots = 0
        self.on_death: list[Promise] = []

    def new_token(self) -> str:
        return self.net.rng.random_unique_id()

    def kill(self) -> None:
        """Hard kill: endpoints vanish, in-flight replies break."""
        self.alive = False
        self._endpoints.clear()
        deaths, self.on_death = self.on_death, []
        for p in deaths:
            if not p.future.done():
                p.send(None)

    def reboot(self) -> None:
        """Kill then come back empty: roles must re-register (the worker
        restores its roles on reboot — fdbserver/worker.actor.cpp:577)."""
        self.kill()
        self.alive = True
        self.reboots += 1


class SimNetwork:
    """Deterministic message fabric over an EventLoop.

    Latency: seeded uniform in [min_latency, max_latency).  Faults:
      clog_pair(a, b, t)    delay a->b messages until now+t
      partition(a, b)       drop a<->b messages until healed
      kill/reboot           via SimProcess
    Delivery order between a pair is preserved (FIFO per (src, dst) like a
    TCP connection): each pair's messages are chained behind the previous
    delivery time.
    """

    def __init__(
        self,
        loop: EventLoop,
        rng: DeterministicRandom,
        trace: TraceCollector | None = None,
        min_latency: float = 0.0001,
        max_latency: float = 0.002,
    ) -> None:
        self.loop = loop
        self.rng = rng.split()
        self.trace = trace or TraceCollector(clock=loop.now)
        self.min_latency = min_latency
        self.max_latency = max_latency
        self.processes: dict[NetworkAddress, SimProcess] = {}
        self._clogged_until: dict[tuple[NetworkAddress, NetworkAddress], float] = {}
        self._partitioned: set[frozenset[NetworkAddress]] = set()
        self._pair_clock: dict[tuple[NetworkAddress, NetworkAddress], float] = {}
        self.messages_sent = 0
        self.messages_dropped = 0
        self.wire = WireStats()  # codec counters (same surface as RealNetwork)

    # -- topology ----------------------------------------------------------
    def create_process(self, name: str, ip: str | None = None, port: int = 4500,
                       machine: str | None = None, dc: str | None = None) -> SimProcess:
        if ip is None:
            ip = f"1.0.0.{len(self.processes) + 1}"
        addr = NetworkAddress(ip, port)
        if addr in self.processes:
            raise ValueError(f"address {addr} in use")
        proc = SimProcess(self, addr, name, machine=machine, dc=dc)
        self.processes[addr] = proc
        return proc

    def machine_processes(self, machine: str) -> list[SimProcess]:
        return [p for p in self.processes.values() if p.machine == machine]

    def kill_machine(self, machine: str) -> list[SimProcess]:
        """Correlated failure: every process on the machine dies at once
        (the reference's machine kills, sim2.actor.cpp killMachine)."""
        victims = [p for p in self.machine_processes(machine) if p.alive]
        for p in victims:
            p.kill()
        self.trace.trace("KillMachine", Machine=machine, Procs=len(victims))
        return victims

    def kill_dc(self, dc: str) -> list[SimProcess]:
        """Data-center loss: every process with the dc label dies."""
        victims = [p for p in self.processes.values() if p.dc == dc and p.alive]
        for p in victims:
            p.kill()
        self.trace.trace("KillDataCenter", DC=dc, Procs=len(victims))
        return victims

    # -- faults ------------------------------------------------------------
    def clog_pair(self, a: NetworkAddress, b: NetworkAddress, seconds: float) -> None:
        until = self.loop.now() + seconds
        self._clogged_until[(a, b)] = max(self._clogged_until.get((a, b), 0), until)
        self._clogged_until[(b, a)] = max(self._clogged_until.get((b, a), 0), until)
        self.trace.trace("ClogPair", A=str(a), B=str(b), Until=until)

    def partition(self, a: NetworkAddress, b: NetworkAddress) -> None:
        self._partitioned.add(frozenset((a, b)))
        self.trace.trace("Partition", A=str(a), B=str(b))

    def heal_partition(self, a: NetworkAddress, b: NetworkAddress) -> None:
        self._partitioned.discard(frozenset((a, b)))
        self.trace.trace("HealPartition", A=str(a), B=str(b))

    def heal_all(self) -> None:
        self._partitioned.clear()
        self._clogged_until.clear()

    # -- transport ---------------------------------------------------------
    def send(self, src: NetworkAddress, endpoint: Endpoint, payload: Any) -> None:
        """Fire-and-forget delivery with simulated latency; payload crosses
        the serialization boundary: wire-codec round trip when every nested
        piece has a registered codec (strict mode — the production
        encoders, exercised under every seed), deepcopy otherwise."""
        self.messages_sent += 1
        dst = endpoint.address
        if frozenset((src, dst)) in self._partitioned:
            self.messages_dropped += 1
            return
        latency = self.min_latency + self.rng.random() * (self.max_latency - self.min_latency)
        when = self.loop.now() + latency
        clog = self._clogged_until.get((src, dst), 0.0)
        if clog > when:
            when = clog + latency
        # FIFO per (src, dst): never deliver before the previous message
        prev = self._pair_clock.get((src, dst), 0.0)
        when = max(when, prev)
        self._pair_clock[(src, dst)] = when
        try:
            msg = decode_payload(
                encode_payload(payload, stats=self.wire, strict=True),
                stats=self.wire,
            )
        except Unencodable:
            # census by the INNER type for RPC envelopes: "RpcMessage" in
            # the fallback census would hide which payload actually lacks
            # a codec (the envelope itself always has one)
            self.wire.note_fallback(getattr(payload, "payload", payload))
            msg = copy.deepcopy(payload)

        def deliver() -> None:
            proc = self.processes.get(dst)
            if proc is None or not proc.alive:
                self.messages_dropped += 1
                self._break_reply(dst, msg)
                return
            if endpoint.token not in proc._endpoints:
                # closed/never-registered stream: fail the caller fast (the
                # TCP connection-reset analog) instead of leaving it to burn
                # its full timeout — the reference's clients see
                # broken_promise the moment the connection drops
                self.messages_dropped += 1
                self._break_reply(dst, msg)
                return
            proc._deliver(endpoint.token, msg)

        self.loop._at(when, TaskPriority.DEFAULT_ENDPOINT, deliver)

    def _break_reply(self, dead_dst: NetworkAddress, msg: Any) -> None:
        """If `msg` was an RPC expecting a reply, route BrokenPromise back to
        the caller (unless the caller itself is unreachable)."""
        reply_to = getattr(msg, "reply_to", None)
        if reply_to is None:
            return
        from .stream import RpcError  # local: stream.py imports this module

        self.send(dead_dst, reply_to, RpcError(BrokenPromise("endpoint gone")))
