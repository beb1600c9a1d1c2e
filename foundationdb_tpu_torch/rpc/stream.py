"""Typed RPC: RequestStream / ReplyPromise over the network fabric.

The reference's RPC is promises that travel the wire (fdbrpc/fdbrpc.h:217):
a request carries an embedded ReplyPromise token; whoever holds the request
can fire the reply back to the caller's endpoint.  Same shape here:

  server:  rs = RequestStream(process, "wlt:commit")
           req = await rs.next()          # ReceivedRequest
           req.reply(result)              # or req.reply_error(exc)

  client:  ref = RequestStreamRef(net, my_process, rs.endpoint)
           result = await ref.get_reply(payload)

Reply routing is token-addressed back to the caller (networksender analog).
A killed/rebooted server silently drops state; callers protect themselves
with `get_reply(payload, timeout=...)` plus the failure monitor — identical
division of labor to the reference (fdbrpc/FailureMonitor.h).

Copy of the reference package's module; the RpcMessage codec (tags 60 and
61) registers into the port's runtime/serialize.py and writes the
reference's bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..runtime.combinators import timeout_error
from ..runtime.core import Future, FutureStream, Promise, TimedOut
from .network import Endpoint, NetworkAddress, SimNetwork, SimProcess


@dataclasses.dataclass
class RpcMessage:
    """Wire envelope: payload + optional reply endpoint + optional sampled
    trace context.  `spans` carries the debug IDs of sampled transactions
    riding this message (the g_traceBatch wire propagation: the receiving
    process's role code lands its stations in ITS TraceBatch under the
    originating IDs, so tools/trace_tool.py can join one transaction's
    journey across OS processes).  None on the un-sampled hot path — the
    codec keeps the spanless layout byte-identical (zero wire cost)."""

    payload: Any
    reply_to: Endpoint | None = None
    spans: tuple | None = None  # tuple[str, ...] of sampled debug IDs


@dataclasses.dataclass
class RpcError:
    """Wire form of an exception reply."""

    error: Exception


class ReplyPromise:
    """Client-side reply slot with its own endpoint token (the promise that
    'travels' — its token does, and replies route back to it)."""

    def __init__(self, process: SimProcess) -> None:
        self._process = process
        self._promise = Promise()
        self._token = "rp:" + process.new_token()
        process.register(self._token, self._on_reply)

    @property
    def endpoint(self) -> Endpoint:
        return Endpoint(self._process.address, self._token)

    @property
    def future(self) -> Future:
        return self._promise.future

    def _on_reply(self, payload: Any) -> None:
        self._process.unregister(self._token)
        if self._promise.future.done():
            return
        if isinstance(payload, RpcError):
            self._promise.fail(payload.error)
        else:
            self._promise.send(payload)

    def dispose(self) -> None:
        """Unregister without a reply (abandoned RPC)."""
        self._process.unregister(self._token)


class ReceivedRequest:
    """Server-side view of one request: payload + reply capability +
    whatever sampled trace spans rode the envelope (role code lands its
    g_trace_batch stations under them)."""

    __slots__ = ("payload", "_reply_to", "_process", "replied", "spans")

    def __init__(self, payload: Any, reply_to: Endpoint | None, process: SimProcess,
                 spans: tuple | None = None) -> None:
        self.payload = payload
        self._reply_to = reply_to
        self._process = process
        self.replied = False
        self.spans = spans

    def reply(self, value: Any = None) -> None:
        self.replied = True
        if self._reply_to is not None and self._process.alive:
            self._process.net.send(self._process.address, self._reply_to, value)

    def reply_error(self, err: Exception) -> None:
        self.replied = True
        if self._reply_to is not None and self._process.alive:
            self._process.net.send(self._process.address, self._reply_to, RpcError(err))


class RequestStream:
    """Server-side stream of typed requests at a (usually well-known) token."""

    def __init__(self, process: SimProcess, token: str | None = None,
                 unique: bool = False) -> None:
        self._process = process
        if token is None:
            self._token = "rs:" + process.new_token()
        elif unique:
            # per-INSTANCE endpoint: successive generations' roles may share
            # a worker process, and a well-known token would make a deposed
            # role's callers silently reach its successor (role interfaces
            # in the reference carry UID-based tokens for exactly this)
            self._token = f"{token}:{process.new_token()}"
        else:
            self._token = token
        self.requests = FutureStream()
        process.register(self._token, self._on_message)

    @property
    def endpoint(self) -> Endpoint:
        return Endpoint(self._process.address, self._token)

    def _on_message(self, msg: RpcMessage) -> None:
        self.requests.send(
            ReceivedRequest(
                msg.payload, msg.reply_to, self._process,
                getattr(msg, "spans", None),
            )
        )

    def next(self) -> Future:
        """Future of the next ReceivedRequest."""
        return self.requests.pop()

    def close(self) -> None:
        self._process.unregister(self._token)
        self.requests.close()


def _register_rpc_codec() -> None:
    """RpcMessage's wire codec (runtime/serialize.py registry): reply
    endpoint + nested payload through `encode_any`, so a registered hot
    payload stays binary end to end and an exotic one degrades to a
    counted pickle body — never a whole-frame pickle.

    Two layouts, one type: tag 60 is the spanless envelope (byte-identical
    to the pre-tracing wire — an un-sampled message costs ZERO extra
    bytes), tag 61 prefixes the same body with the sampled debug-ID spans
    (`u16 n + n × (u16 len + utf8)`)."""
    import struct as _struct

    from ..runtime import serialize as _wire

    _ST_I = _struct.Struct("<I")
    _ST_H = _struct.Struct("<H")

    def _enc_envelope(o: RpcMessage, stats, strict) -> bytes:
        rt = o.reply_to
        if rt is not None and rt.address is None:
            # the decoder keys the token read off the address flag, so an
            # address-less endpoint can't ride the codec — raising here
            # downgrades to the counted fallback (parity preserved) rather
            # than silently mis-framing
            raise _wire.CodecError("reply endpoint without address")
        tag, body = _wire.encode_any(o.payload, stats, strict)
        parts: list = []
        _wire.write_addr(parts, rt.address if rt is not None else None)
        if rt is not None:
            tok = rt.token.encode("utf-8")
            parts.append(_ST_I.pack(len(tok)))
            parts.append(tok)
        parts.append(_ST_H.pack(tag))
        parts.append(body)
        return b"".join(parts)

    def enc(o: RpcMessage, stats, strict):
        body = _enc_envelope(o, stats, strict)
        sp = o.spans
        if not sp:
            return body  # tag 60: the spanless wire, unchanged
        parts = [_ST_H.pack(len(sp))]
        for s in sp:
            sb = s.encode("utf-8")
            parts.append(_ST_H.pack(len(sb)))
            parts.append(sb)
        parts.append(body)
        return 61, b"".join(parts)

    def _dec_envelope(buf: bytes, pos: int, stats, spans) -> RpcMessage:
        addr, pos = _wire.read_addr(buf, pos)
        reply_to = None
        if addr is not None:
            (ntok,) = _ST_I.unpack_from(buf, pos)
            pos += 4
            token = buf[pos : pos + ntok].decode("utf-8")
            pos += ntok
            reply_to = Endpoint(addr, token)
        (tag,) = _ST_H.unpack_from(buf, pos)
        return RpcMessage(
            _wire.decode_any(tag, buf[pos + 2 :], stats), reply_to, spans
        )

    def dec(buf: bytes, stats) -> RpcMessage:
        return _dec_envelope(buf, 0, stats, None)

    def dec_spanned(buf: bytes, stats) -> RpcMessage:
        (n,) = _ST_H.unpack_from(buf, 0)
        pos = 2
        spans = []
        for _ in range(n):
            (ln,) = _ST_H.unpack_from(buf, pos)
            pos += 2
            sb = buf[pos : pos + ln]
            if len(sb) != ln:
                raise _wire.CodecError("truncated span id")
            spans.append(sb.decode("utf-8"))
            pos += ln
        return _dec_envelope(buf, pos, stats, tuple(spans))

    _wire.register_codec(60, RpcMessage, enc, dec)
    _wire.register_decoder(61, dec_spanned)


_register_rpc_codec()


class RequestStreamRef:
    """Client-side handle to a remote RequestStream."""

    def __init__(self, net: SimNetwork, process: SimProcess, endpoint: Endpoint) -> None:
        self._net = net
        self._process = process
        self.endpoint = endpoint

    def send(self, payload: Any, spans: tuple | None = None) -> None:
        """One-way, at-most-once (FlowTransport unreliable send)."""
        self._net.send(
            self._process.address, self.endpoint, RpcMessage(payload, None, spans)
        )

    def get_reply(self, payload: Any, timeout: float | None = None,
                  spans: tuple | None = None) -> Future:
        rp = ReplyPromise(self._process)
        self._net.send(
            self._process.address, self.endpoint,
            RpcMessage(payload, rp.endpoint, spans),
        )
        if timeout is None:
            return rp.future
        out = timeout_error(self._net.loop, rp.future, timeout)
        # on timeout the reply will never be consumed: drop the endpoint so
        # abandoned RPCs don't leak entries in the process endpoint table
        out.add_done_callback(lambda _f: rp.dispose())
        return out
