"""Real TCP transport — the production twin of the simulated fabric
(fdbrpc/FlowTransport.actor.cpp:48-581 + flow/Net2.actor.cpp's reactor).

The INetwork seam contract (rpc/network.py): roles and the typed RPC layer
(rpc/stream.py) see only `net.send(src, endpoint, payload)` and a process
endpoint table.  This module implements that contract over non-blocking
sockets, so the SAME RequestStream/ReplyPromise code runs across OS
processes:

  * one `RealNetwork` per OS process, listening on one (ip, port) — its
    `RealProcess` is the local endpoint table (the FlowTransport singleton)
  * persistent length-prefixed connections per peer, dialed on first send
    and reused both ways (the reference keeps one Peer per address)
  * frames carry (dst_token, peer_addr, payload) in the runtime/serialize.py
    wire-codec format (docs/WIRE.md): binary framing with hand-written
    codecs for the hot commit-plane messages and a counted, length-guarded
    pickle fallback for cold control traffic — the same explicit-codec
    discipline the reference's versioned BinaryWriter wire has
  * writes COALESCE per connection (flow/Net2's packet coalescing): frames
    queue and flush once per reactor tick — or immediately past
    WIRE_FLUSH_BYTES — so a commit batch's resolver/TLog fan-out costs one
    syscall per peer, not one per message (WireStats counts frames/flush)
  * a dead/unreachable peer fails requests fast with BrokenPromise, exactly
    like the simulated fabric's connection-reset analog, so client retry
    behavior is identical in both worlds
  * `NetDriver` pumps the selector inside the event loop's idle gaps —
    the Net2 "reactor + run loop" shape

Copy of the reference package's module.  The announced protocol version
is the `protocol_version=` keyword (the reference reads an environment
override); everything else is as there.
"""

from __future__ import annotations

import selectors
import socket
import ssl
import struct
import time as _time
from typing import Any, Callable

from ..runtime.core import BrokenPromise, EventLoop, Future, TaskPriority, TimedOut
from ..runtime.knobs import CoreKnobs
from ..runtime.metrics import WireStats
from ..runtime.serialize import (
    announced_protocol_version,
    decode_frame,
    decode_payload,
    encode_frame,
    encode_payload,
)
from .network import Endpoint, EndpointTable, NetworkAddress
from .stream import RpcError

_LEN = struct.Struct("<I")
MAX_FRAME = 64 << 20
# every frame is a codec frame (runtime/serialize.py encode_frame): u32
# token length + token + addr flag [+ addr] + u16 payload tag.  The
# degenerate frame (empty token, no addr, scalar payload) is 7 bytes; a
# declared length below this floor is a corrupt/hostile header, rejected
# before any body reaches the decoder.
MIN_FRAME = 7


class FrameError(ConnectionError):
    """A length-corrupt or oversized frame header: the connection is severed
    BEFORE the body reaches the deserializer — the first containment step
    on the VERDICT 'wire uses pickle' weakness (a hostile peer must not get
    to choose how many bytes we buffer, nor feed the decoder at all)."""

    def __init__(self, reason: str, declared_len: int) -> None:
        super().__init__(f"{reason} (declared {declared_len} bytes)")
        self.reason = reason
        self.declared_len = declared_len


class TLSConfig:
    """Mutual TLS for the transport — the FDBLibTLS slot.  Every node
    presents a certificate signed by the cluster CA and REQUIRES the same
    of its peer (the reference's default verify-peers policy): a plaintext
    or wrong-CA peer never completes a handshake, so the pickled-frames
    trust boundary extends only to holders of a cluster cert."""

    def __init__(self, certfile: str, keyfile: str, cafile: str) -> None:
        self.certfile = certfile
        self.keyfile = keyfile
        self.cafile = cafile

    def _ctx(self, purpose) -> ssl.SSLContext:
        ctx = ssl.SSLContext(purpose)
        ctx.load_cert_chain(self.certfile, self.keyfile)
        ctx.load_verify_locations(self.cafile)
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.check_hostname = False  # identity = cluster CA, not hostnames
        return ctx

    def server_ctx(self) -> ssl.SSLContext:
        return self._ctx(ssl.PROTOCOL_TLS_SERVER)

    def client_ctx(self) -> ssl.SSLContext:
        return self._ctx(ssl.PROTOCOL_TLS_CLIENT)


class _Conn:
    """One peer connection: framed, buffered, non-blocking."""

    def __init__(self, sock: socket.socket, addr: NetworkAddress | None) -> None:
        self.sock = sock
        self.addr = addr  # peer's LISTENING address (None until hello)
        self.out = bytearray()
        self.inbuf = bytearray()
        self.frames_queued = 0  # since the last flush (coalescing stats)
        self.connecting = False
        self.handshaking = False  # TLS handshake in progress
        self.dead = False
        # reply tokens of requests sent over this connection and not yet
        # answered: failed with BrokenPromise if the connection dies (the
        # reference fails a Peer's outstanding replies on disconnect)
        self.pending: set[str] = set()

    def queue_frame(self, blob: bytes) -> None:
        self.out += _LEN.pack(len(blob)) + blob
        self.frames_queued += 1

    def frames(self):
        """Yield complete frames out of inbuf.  Header validation happens
        as soon as the 4 length bytes arrive — an oversized or corrupt
        declared length raises FrameError immediately, before any body
        bytes are awaited (so a hostile header cannot make us buffer up to
        4 GiB) and before anything reaches the deserializer."""
        pos = 0
        n = len(self.inbuf)
        while pos + _LEN.size <= n:
            (ln,) = _LEN.unpack_from(self.inbuf, pos)
            if ln > MAX_FRAME:
                raise FrameError("oversized frame", ln)
            if ln < MIN_FRAME:
                raise FrameError("length-corrupt frame", ln)
            if pos + _LEN.size + ln > n:
                break
            yield bytes(self.inbuf[pos + _LEN.size : pos + _LEN.size + ln])
            pos += _LEN.size + ln
        del self.inbuf[:pos]


class RealProcess(EndpointTable):
    """Endpoint table + lifecycle, shape-compatible with SimProcess."""

    def __init__(self, net: "RealNetwork", address: NetworkAddress, name: str) -> None:
        super().__init__(address, name)
        self.net = net
        self._token_seq = 0
        # SimProcess shape: death hooks (SimFilesystem.open registers one).
        # A real process's death IS the OS tearing everything down, so
        # nothing ever fires these — but holders (disk-backed coordinator
        # registers) must be able to register them.
        self.on_death: list = []

    def new_token(self) -> str:
        self._token_seq += 1
        return f"{self.name}-{self._token_seq}"


class RealNetwork:
    """TCP INetwork: one per OS process.  Surface-compatible with the slice
    of SimNetwork that rpc/stream.py and the roles actually use.

    TRUST BOUNDARY: hot commit-plane frames decode through hand-written,
    length-validated binary codecs, but cold control payloads may still
    ride the counted pickle fallback (TAG_PICKLE) — and unpickling gives a
    peer code execution, so this transport remains for loopback or a
    trusted, isolated cluster network ONLY (the reference's cleartext
    FlowTransport makes the same assumption; its TLS layer is the
    production answer, docs/WIRE.md has the full trust story).  The
    default bind is 127.0.0.1; binding wider is an explicit opt-in."""

    def __init__(self, loop: EventLoop, name: str = "proc",
                 ip: str = "127.0.0.1", port: int = 0,
                 tls: TLSConfig | None = None, trace=None,
                 knobs: CoreKnobs | None = None,
                 protocol_version: int | str | None = None) -> None:
        self.loop = loop
        self.tls = tls
        knobs = knobs or CoreKnobs()
        self.wire = WireStats()
        self._coalesce = bool(knobs.WIRE_COALESCE)
        self._flush_bytes = int(knobs.WIRE_FLUSH_BYTES)
        self._dirty: set[_Conn] = set()
        self.trace = trace  # optional TraceCollector for wire-error events
        self._server_ctx = tls.server_ctx() if tls else None
        self._client_ctx = tls.client_ctx() if tls else None
        self._sel = selectors.DefaultSelector()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((ip, port))
        self._listener.listen(64)
        self._listener.setblocking(False)
        self.address = NetworkAddress(ip, self._listener.getsockname()[1])
        self.process = RealProcess(self, self.address, name)
        self._conns: dict[NetworkAddress, _Conn] = {}
        self._sel.register(self._listener, selectors.EVENT_READ, ("accept", None))
        self.messages_sent = 0
        self.messages_dropped = 0
        self.frames_rejected = 0   # length-corrupt/oversized headers severed
        self.decode_failures = 0   # well-framed but undeserializable payloads
        # the version stamped into this network's hello frames (normally
        # the build's PROTOCOL_VERSION; `protocol_version` overrides it for
        # mixed-version upgrade tests)
        self.protocol_version = announced_protocol_version(protocol_version)
        # (peer, their version) pairs already traced as mismatched: a
        # redialing old/new pair severs on EVERY connection attempt (a
        # rolling bounce retries for seconds), but the operator-facing
        # trace gets exactly ONE TransportProtocolMismatch per pair — a
        # later MATCHING hello from the peer (it upgraded) clears its
        # entries so a genuine re-downgrade traces anew
        self._mismatch_traced: set[tuple[str, str]] = set()

    def _trace_wire_error(self, event_type: str, conn: "_Conn", **fields) -> None:
        if self.trace is not None:
            from ..runtime.trace import SEV_WARN

            self.trace.trace(
                event_type, severity=SEV_WARN,
                track_latest=event_type,
                Peer=str(conn.addr) if conn.addr else "unidentified",
                **fields,
            )

    # -- SimNetwork-compatible sending --------------------------------------
    def create_process(self, name: str) -> RealProcess:
        """The real world has ONE process per network (the OS process); the
        seam's create_process simply hands that out so role constructors and
        client factories work unchanged."""
        return self.process

    def send(self, src: NetworkAddress, endpoint: Endpoint, payload: Any) -> None:
        self.messages_sent += 1
        if endpoint.address == self.address:
            # loopback: round-trip through the wire CODEC (not pickle) so
            # co-located roles get the same serialization-boundary
            # isolation as remote peers (SimNetwork deep-copies at send
            # for exactly this reason) AND the same encoders run in every
            # deployment shape — snapshot-at-send copy semantics preserved
            msg = decode_payload(encode_payload(payload, stats=self.wire),
                                 stats=self.wire)
            self.loop._at(
                self.loop.now(), TaskPriority.DEFAULT_ENDPOINT,
                lambda: self.process._deliver(endpoint.token, msg),
            )
            return
        try:
            conn = self._conn_to(endpoint.address)
        except OSError:
            self.messages_dropped += 1
            self._break_reply(payload)
            return
        reply_to = getattr(payload, "reply_to", None)
        if reply_to is not None and reply_to.address == self.address:
            conn.pending.add(reply_to.token)
        conn.queue_frame(
            encode_frame(endpoint.token, self.address, payload, stats=self.wire)
        )
        # coalesce: queue now, flush once per reactor tick — unless the
        # queue passed the byte threshold (bound memory + burst latency)
        if not self._coalesce or len(conn.out) >= self._flush_bytes:
            self._try_flush(conn)
        else:
            self._dirty.add(conn)

    def _break_reply(self, msg: Any) -> None:
        """Connection refused/reset before delivery: fail the caller fast
        (the same broken_promise contract as the simulated fabric)."""
        reply_to = getattr(msg, "reply_to", None)
        if reply_to is None:
            return
        self.loop._at(
            self.loop.now(), TaskPriority.DEFAULT_ENDPOINT,
            lambda: self.process._deliver(
                reply_to.token, RpcError(BrokenPromise("connection failed"))
            )
            if reply_to.address == self.address
            else None,
        )

    def _conn_to(self, addr: NetworkAddress) -> _Conn:
        conn = self._conns.get(addr)
        if conn is not None and not conn.dead:
            return conn
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setblocking(False)
        conn = _Conn(s, addr)
        conn.connecting = True
        try:
            s.connect((addr.ip, addr.port))
        except BlockingIOError:
            pass
        except OSError:
            s.close()
            raise
        self._conns[addr] = conn
        self._sel.register(
            s, selectors.EVENT_READ | selectors.EVENT_WRITE, ("conn", conn)
        )
        # identify our listening address so the peer can reuse this
        # connection for traffic back to us, and stamp our protocol version
        # so a mixed-version pair severs with a NAMED reason instead of a
        # bare decode-failure loop (FlowTransport's ConnectPacket carries
        # currentProtocolVersion for the same diagnosis)
        conn.queue_frame(
            encode_frame("__hello__", self.address, self.protocol_version,
                         stats=self.wire)
        )
        return conn

    def flush_queued(self) -> None:
        """Drain the coalesced per-connection queues (one write attempt per
        dirty connection).  Called at the top of pump(), and by WallDriver
        for EVERY reactor before any of them blocks in select — a reply
        queued on net B must hit the wire before net A sleeps on its poll,
        or coalescing would add a full idle-gap to cross-net round trips."""
        if self._dirty:
            dirty, self._dirty = self._dirty, set()
            for conn in dirty:
                if not conn.dead:
                    self._try_flush(conn)

    # -- reactor -------------------------------------------------------------
    def pump(self, timeout: float) -> None:
        """Process socket readiness for up to `timeout` seconds (one poll).
        Coalesced frames queued since the last tick flush FIRST — before
        the select wait — so one reactor turn never delays its own sends."""
        self.flush_queued()
        for key, events in self._sel.select(timeout):
            kind, conn = key.data
            if kind == "accept":
                try:
                    s, _peer = self._listener.accept()
                except OSError:
                    continue
                s.setblocking(False)
                c = _Conn(s, None)
                if self._server_ctx is not None:
                    try:
                        c.sock = self._server_ctx.wrap_socket(
                            s, server_side=True, do_handshake_on_connect=False
                        )
                    except (ssl.SSLError, OSError):
                        s.close()
                        continue
                    c.handshaking = True
                self._sel.register(
                    c.sock, selectors.EVENT_READ | selectors.EVENT_WRITE,
                    ("conn", c),
                )
                continue
            if conn.connecting and (events & selectors.EVENT_WRITE):
                conn.connecting = False
                if self._client_ctx is not None:
                    # TCP is up: start the TLS handshake (the selector must
                    # track the NEW SSLSocket object wrapping the same fd)
                    try:
                        self._sel.unregister(conn.sock)
                        conn.sock = self._client_ctx.wrap_socket(
                            conn.sock, do_handshake_on_connect=False
                        )
                        self._sel.register(
                            conn.sock,
                            selectors.EVENT_READ | selectors.EVENT_WRITE,
                            ("conn", conn),
                        )
                        conn.handshaking = True
                    except (ssl.SSLError, OSError):
                        self._drop_conn(conn)
                        continue
            if conn.handshaking:
                self._pump_handshake(conn)
                continue
            if events & selectors.EVENT_WRITE:
                self._try_flush(conn)
                if not conn.out and not conn.dead:
                    self._sel.modify(conn.sock, selectors.EVENT_READ, ("conn", conn))
            if events & selectors.EVENT_READ:
                self._read(conn)

    def _pump_handshake(self, conn: _Conn) -> None:
        try:
            conn.sock.do_handshake()
        except ssl.SSLWantReadError:
            self._sel.modify(conn.sock, selectors.EVENT_READ, ("conn", conn))
            return
        except ssl.SSLWantWriteError:
            self._sel.modify(conn.sock, selectors.EVENT_WRITE, ("conn", conn))
            return
        except (ssl.SSLError, OSError):
            # wrong CA / plaintext peer / reset: sever (verify-peers policy)
            self._drop_conn(conn)
            return
        conn.handshaking = False
        self._sel.modify(
            conn.sock, selectors.EVENT_READ | selectors.EVENT_WRITE,
            ("conn", conn),
        )
        self._try_flush(conn)

    def _try_flush(self, conn: _Conn) -> None:
        if conn.connecting or conn.handshaking or conn.dead:
            return
        if conn.frames_queued and conn.out:
            # one flush event drains every frame queued since the last one
            # (frames_per_flush is the coalescing factor operators read)
            self.wire.flushes += 1
            self.wire.frames_flushed += conn.frames_queued
            conn.frames_queued = 0
        try:
            while conn.out:
                n = conn.sock.send(conn.out)
                del conn.out[:n]
        except (BlockingIOError, ssl.SSLWantWriteError, ssl.SSLWantReadError):
            self._sel.modify(
                conn.sock,
                selectors.EVENT_READ | selectors.EVENT_WRITE,
                ("conn", conn),
            )
        except OSError:
            self._drop_conn(conn)

    def _read(self, conn: _Conn) -> None:
        data = bytearray()
        try:
            while True:
                chunk = conn.sock.recv(1 << 16)
                if not chunk:
                    break
                data += chunk
                # an SSLSocket may hold decrypted bytes beyond one recv
                if not (isinstance(conn.sock, ssl.SSLSocket) and conn.sock.pending()):
                    break
        except (BlockingIOError, ssl.SSLWantReadError, ssl.SSLWantWriteError):
            # SSLWantWrite on a READ is legal (renegotiation with a full
            # send buffer) — benign, like the Want* cases in _try_flush
            if not data:
                return
        except OSError:
            self._drop_conn(conn)
            return
        if not data:
            self._drop_conn(conn)
            return
        conn.inbuf += data
        try:
            frames = list(conn.frames())
        except FrameError as e:
            # connection-level rejection: the declared length is hostile or
            # corrupt, so nothing here may reach the deserializer — sever
            # with a traced error (the reference severs on malformed
            # ConnectPacket lengths the same way)
            self.frames_rejected += 1
            self._trace_wire_error(
                "TransportFrameRejected", conn,
                Reason=e.reason, DeclaredLen=e.declared_len,
            )
            self._drop_conn(conn)
            return
        try:
            decoded = [decode_frame(b, self.wire) for b in frames]
        except Exception as e:  # noqa: BLE001 — corrupt peer: sever, don't die
            # CodecError (truncated/unknown-tag codec body) and a bad
            # pickle-fallback body land here alike: well-framed but
            # undecodable is a deserializer-level failure — severed and
            # counted, same containment as the oversized-header path
            self.decode_failures += 1
            self._trace_wire_error(
                "TransportDecodeFailed", conn, Error=repr(e)[:200]
            )
            self._drop_conn(conn)
            return
        for token, peer_addr, payload in decoded:
            if token == "__hello__":
                if payload is not None and payload != self.protocol_version:
                    # mixed-version pair: sever with a NAMED reason (a
                    # pre-codec peer never even reaches here — its pickled
                    # hello fails decode_frame above).  Deduped per
                    # (peer, their version): during a rolling bounce the
                    # old/new pair redials every retry interval and severs
                    # each time, but exactly one mismatch event per pair
                    # reaches the trace plane
                    theirs = (hex(payload) if isinstance(payload, int)
                              else repr(payload)[:40])
                    key = (str(peer_addr), theirs)
                    if key not in self._mismatch_traced:
                        self._mismatch_traced.add(key)
                        self._trace_wire_error(
                            "TransportProtocolMismatch", conn,
                            Ours=hex(self.protocol_version), Theirs=theirs,
                            PeerAddress=str(peer_addr),
                        )
                    self._drop_conn(conn)
                    return
                # a matching hello proves the peer runs OUR version now:
                # forget any mismatch we traced against its old one
                self._mismatch_traced = {
                    k for k in self._mismatch_traced
                    if k[0] != str(peer_addr)
                }
                conn.addr = peer_addr
                # reuse this connection for outbound traffic to the peer
                if peer_addr not in self._conns or self._conns[peer_addr].dead:
                    self._conns[peer_addr] = conn
                continue
            conn.pending.discard(token)
            self.loop._at(
                self.loop.now(), TaskPriority.DEFAULT_ENDPOINT,
                lambda t=token, p=payload: self._deliver_or_bounce(t, p),
            )

    def _deliver_or_bounce(self, token: str, payload: Any) -> None:
        """Deliver; a request for a closed/unknown stream bounces
        BrokenPromise to the caller — the same fast-fail the simulated
        fabric gives, so retry behavior matches across the seam."""
        if token in self.process._endpoints:
            self.process._deliver(token, payload)
            return
        reply_to = getattr(payload, "reply_to", None)
        if reply_to is not None:
            self.send(
                self.address, reply_to, RpcError(BrokenPromise("endpoint gone"))
            )

    def _drop_conn(self, conn: _Conn) -> None:
        conn.dead = True
        self._dirty.discard(conn)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        if conn.addr is not None and self._conns.get(conn.addr) is conn:
            del self._conns[conn.addr]
        # fail every request still waiting on this peer — fast, like the
        # simulated fabric's connection-reset analog
        pending, conn.pending = conn.pending, set()
        for token in pending:
            self.loop._at(
                self.loop.now(), TaskPriority.DEFAULT_ENDPOINT,
                lambda t=token: self.process._deliver(
                    t, RpcError(BrokenPromise("connection reset"))
                ),
            )

    def close(self) -> None:
        # sever every registered socket (including accepted-but-unhelloed
        # peers that never made it into _conns), then the selector itself
        for key in list(self._sel.get_map().values()):
            kind, conn = key.data
            if kind == "conn":
                self._drop_conn(conn)
        try:
            self._sel.unregister(self._listener)
        except (KeyError, ValueError):
            pass
        self._listener.close()
        self._sel.close()


class WallDriver:
    """Drives an EventLoop against the wall clock WITH reactor IO — the
    Net2 "reactor + run loop" shape.  `pumps` is one or more
    `pump(timeout)` callables (RealNetwork.pump, ClientGateway.pump, ...);
    each idle gap until the next timer is split across them.  THE single
    wall-clock driver — tools/gateway.py's GatewayDriver is a thin alias."""

    def __init__(self, loop: EventLoop, pumps: list[Callable[[float], None]]) -> None:
        self.loop = loop
        self.pumps = list(pumps)
        # reactors with coalesced write queues (bound `net.pump` methods):
        # their queues must ALL drain before any pump blocks in select
        self._flushers = [
            flush
            for p in self.pumps
            if (flush := getattr(getattr(p, "__self__", None), "flush_queued", None))
        ]
        self._origin = _time.monotonic() - loop.now()  # flowlint: ok wall-clock (the wall driver anchors virtual time to the wall)

    def _tick(self) -> None:
        """One reactor turn: drain every due timer, spend the gap until the
        next one polling the reactors, and anchor virtual time to the wall
        (run_one never moves time backwards, so the anchor is always safe —
        the single place this time model lives for the real-IO driver)."""
        now = _time.monotonic()  # flowlint: ok wall-clock (wall driver tick)
        while self.loop._heap and self._origin + self.loop._heap[0][0] <= now:
            self.loop.run_one()
            now = _time.monotonic()  # flowlint: ok wall-clock (wall driver tick)
        # cross-reactor flush barrier: frames the timer turn just queued on
        # ANY net go out before the FIRST net sleeps on its poll
        for flush in self._flushers:
            flush()
        gap = 0.02
        if self.loop._heap:
            gap = min(max((self._origin + self.loop._heap[0][0]) - now, 0.0), 0.02)
        share = gap / max(len(self.pumps), 1)
        for pump in self.pumps:
            pump(share)
        self.loop._now = max(self.loop._now, _time.monotonic() - self._origin)  # flowlint: ok wall-clock (the anchor itself)

    def run_until(self, fut: Future, wall_timeout: float | None = None) -> Any:
        start = _time.monotonic()  # flowlint: ok wall-clock (wall_timeout is a host bound by contract)
        while not fut.done():
            if wall_timeout is not None and _time.monotonic() - start > wall_timeout:  # flowlint: ok wall-clock (wall_timeout is a host bound by contract)
                raise TimedOut(f"wall timeout {wall_timeout}s")
            self._tick()
        return fut.result()

    def serve_forever(self, wall_timeout: float | None = None,
                      stop: Callable[[], bool] | None = None) -> None:
        """Pump IO + timers until the deadline, or until `stop()` is true
        at the end of a turn (server main loop).  `stop` is how a signal
        ends the loop: an exception raised from a signal handler would
        land inside whichever task was stepping, and a task keeps its
        error (Task._step), so the loop would go on serving."""
        start = _time.monotonic()  # flowlint: ok wall-clock (server main-loop deadline is host wall)
        while wall_timeout is None or _time.monotonic() - start < wall_timeout:  # flowlint: ok wall-clock (server main-loop deadline is host wall)
            self._tick()
            if stop is not None and stop():
                return


class NetDriver(WallDriver):
    """WallDriver over one RealNetwork (the common single-reactor case)."""

    def __init__(self, loop: EventLoop, net: RealNetwork) -> None:
        super().__init__(loop, [net.pump])
        self.net = net
