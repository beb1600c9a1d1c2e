"""Client gateway — the network face of the C ABI / foreign-language
bindings (the slot of bindings/c/fdb_c.cpp:85-293 in the reference).

The reference's fdb_c links the whole native client into the caller's
process.  Here the client logic lives in the cluster's runtime, so foreign
callers speak a LANGUAGE-NEUTRAL length-prefixed binary protocol to this
gateway, which owns server-side (read-your-writes) transaction objects —
the architecture of a client proxy, with the C library
(bindings/c/fdbtpu_c.cpp) as the thin blocking stub.

Wire protocol (all little-endian):
    request:  u32 frame_len | u64 req_id | u8 op | body
    reply:    u32 frame_len | u64 req_id | u8 status | body
    strings:  u32 len | bytes

Ops (body → reply body):
    1 NEW_TXN      ()                          → u64 txn_id
    2 DESTROY      u64                         → ()
    3 RESET        u64                         → ()
    4 SET          u64, key, val               → ()
    5 CLEAR_RANGE  u64, begin, end             → ()
    6 GET          u64, key                    → u8 present, val
    7 GET_RANGE    u64, begin, end, u32 limit  → u32 n, n × (key, val)
    8 COMMIT       u64                         → i64 version
    9 ON_ERROR     u64, i32 code               → ()   (backoff + reset if
                                                 retryable; else status=code)
   10 ATOMIC_ADD   u64, key, i64 delta         → ()
   11 GET_READ_VERSION u64                     → i64 version
   13 SET_OPTION   u64, option                 → ()   (transaction option by
                                                 name, e.g. lock_aware, or
                                                 name=value for valued options
                                                 like debug_transaction_identifier)
   14 WATCH        u64, key                    → i64 version (replies when
                                                 the key's value CHANGES —
                                                 fdb_transaction_watch; use a
                                                 dedicated connection, the
                                                 simple bindings are serial)
   15 GET_KEY      u64, sel                    → key (resolved; selector
                                                 semantics in docs/API.md —
                                                 offset overflow clamps to
                                                 b"" / b"\\xff")
   16 GET_RANGE_SELECTOR
                   u64, bsel, esel, u32 limit  → u32 n, n × (key, val)

    sel (a KeySelector):  key, u8 or_equal, i32 offset — the
    first_greater_or_equal family resolved through the server-side
    read-your-writes transaction, so a selector steps over keys this
    transaction cleared and lands on keys it wrote.

Status: 0 ok; 1 not_committed, 2 transaction_too_old, 3
commit_unknown_result, 4 future_version, 5 timed_out, 6 bad request,
255 internal error.  (The retryable set is 1-5, matching the client's
RETRYABLE_ERRORS.)

Copy of the reference package's module, on the port's own modules: the
protocol is the reference's byte for byte, so the shared bindings
(bindings/c, bindings/python, bindings/perl) are its clients unchanged.
The gateway serves the database it is given and runs nothing on a device
itself; the cluster behind it (tools/server.py) holds the conflict sets.
`build_c_bindings` compiles the C ABI and its smoke program from the
tracked sources in bindings/c into a directory of the caller's.
"""

from __future__ import annotations

import selectors
import socket
import struct
import subprocess
from pathlib import Path

from ..client.transaction import (
    CommitUnknownResult,
    NotCommitted,
)
from ..roles.types import FutureVersion, MutationType, TransactionTooOld
from ..rpc.transport import WallDriver
from ..runtime.core import ActorCancelled, EventLoop, TaskPriority, TimedOut

_LEN = struct.Struct("<I")
_HDR = struct.Struct("<QB")  # req_id, op

# wire-protocol version, announced via GET_PROTOCOL (op 12): the multi-
# version client (client/multiversion.py) probes it to select a matching
# client implementation, the reference's currentProtocolVersion handshake
# v2: key selectors (GET_KEY op 15, GET_RANGE_SELECTOR op 16)
PROTOCOL_VERSION = 2

# the single source of truth for ABI status codes: the ABI constants AND
# the vexillographer's generated table both derive from this dict
STATUS_CODES = {
    "ok": 0,
    "not_committed": 1,
    "transaction_too_old": 2,
    "commit_unknown_result": 3,
    "future_version": 4,
    "timed_out": 5,
    "bad_request": 6,
    "internal_error": 255,
}
OK = STATUS_CODES["ok"]
ERR_NOT_COMMITTED = STATUS_CODES["not_committed"]
ERR_TOO_OLD = STATUS_CODES["transaction_too_old"]
ERR_UNKNOWN_RESULT = STATUS_CODES["commit_unknown_result"]
ERR_FUTURE_VERSION = STATUS_CODES["future_version"]
ERR_TIMED_OUT = STATUS_CODES["timed_out"]
ERR_BAD_REQUEST = STATUS_CODES["bad_request"]
ERR_INTERNAL = STATUS_CODES["internal_error"]

_ERR_CODE = {
    NotCommitted: ERR_NOT_COMMITTED,
    TransactionTooOld: ERR_TOO_OLD,
    CommitUnknownResult: ERR_UNKNOWN_RESULT,
    FutureVersion: ERR_FUTURE_VERSION,
    TimedOut: ERR_TIMED_OUT,
}
RETRYABLE_CODES = {1, 2, 3, 4, 5}


def _u32(b: bytes, off: int) -> tuple[int, int]:
    return struct.unpack_from("<I", b, off)[0], off + 4


def _bstr(b: bytes, off: int) -> tuple[bytes, int]:
    n, off = _u32(b, off)
    return b[off : off + n], off + n


def _wstr(out: bytearray, s: bytes) -> None:
    out += struct.pack("<I", len(s))
    out += s


def _bsel(b: bytes, off: int):
    """Parse one wire KeySelector: key (length-prefixed), u8 or_equal,
    i32 offset."""
    from ..roles.types import KeySelector

    key, off = _bstr(b, off)
    or_equal, offset = struct.unpack_from("<Bi", b, off)
    return KeySelector(key, or_equal != 0, offset), off + 5


class _GwConn:
    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.inbuf = bytearray()
        self.outbuf = bytearray()
        self.txns: dict[int, object] = {}
        self.closed = False


class ClientGateway:
    """Serves the client protocol on a real socket, executing ops as tasks
    on the cluster's event loop."""

    def __init__(self, loop: EventLoop, db, host: str = "127.0.0.1",
                 port: int = 0, trace=None) -> None:
        self.loop = loop
        self.db = db
        self.trace = trace  # optional TraceCollector: connection events
        self._sel = selectors.DefaultSelector()
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(16)
        self._lsock.setblocking(False)
        self.port = self._lsock.getsockname()[1]
        self._sel.register(self._lsock, selectors.EVENT_READ, None)
        self._txn_seq = 0

    # -- socket pump (called from the driver between loop ticks) ------------
    def pump(self, timeout: float) -> None:
        for key, _ev in self._sel.select(timeout):
            if key.data is None:
                try:
                    s, _addr = self._lsock.accept()
                except OSError:
                    continue
                s.setblocking(False)
                conn = _GwConn(s)
                self._sel.register(s, selectors.EVENT_READ, conn)
                if self.trace is not None:
                    self.trace.trace(
                        "GatewayConnectionOpened",
                        Peer=str(s.getpeername()),
                    )
                continue
            conn: _GwConn = key.data
            try:
                data = conn.sock.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                data = b""
            if not data:
                self._drop(conn)
                continue
            conn.inbuf += data
            self._dispatch(conn)
        # flush pending output
        for key in list(self._sel.get_map().values()):
            conn = key.data
            if conn is None or not conn.outbuf:
                continue
            try:
                n = conn.sock.send(bytes(conn.outbuf))
                del conn.outbuf[:n]
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                self._drop(conn)

    def _drop(self, conn: _GwConn) -> None:
        if conn.closed:
            return
        conn.closed = True
        if self.trace is not None:
            self.trace.trace("GatewayConnectionClosed", Txns=len(conn.txns))
        try:
            self._sel.unregister(conn.sock)
        except KeyError:
            pass
        conn.sock.close()
        conn.txns.clear()

    def _dispatch(self, conn: _GwConn) -> None:
        while True:
            if len(conn.inbuf) < _LEN.size:
                return
            (flen,) = _LEN.unpack_from(conn.inbuf, 0)
            if len(conn.inbuf) < _LEN.size + flen:
                return
            frame = bytes(conn.inbuf[_LEN.size : _LEN.size + flen])
            del conn.inbuf[: _LEN.size + flen]
            req_id, op = _HDR.unpack_from(frame, 0)
            body = frame[_HDR.size :]
            self.loop.spawn(
                self._handle(conn, req_id, op, body), TaskPriority.DEFAULT_ENDPOINT,
                "gateway-op",
            )

    def _reply(self, conn: _GwConn, req_id: int, status: int,
               body: bytes = b"") -> None:
        if conn.closed:
            return
        payload = struct.pack("<QB", req_id, status) + body
        conn.outbuf += _LEN.pack(len(payload)) + payload

    async def _handle(self, conn: _GwConn, req_id: int, op: int, body: bytes) -> None:
        try:
            out = bytearray()
            status = OK
            if op == 12:  # GET_PROTOCOL (no txn id)
                out += struct.pack("<I", PROTOCOL_VERSION)
            elif op == 1:  # NEW_TXN
                self._txn_seq += 1
                conn.txns[self._txn_seq] = self.db.create_ryw_transaction()
                out += struct.pack("<Q", self._txn_seq)
            else:
                (tid,) = struct.unpack_from("<Q", body, 0)
                off = 8
                tr = conn.txns.get(tid)
                if tr is None and op != 2:
                    self._reply(conn, req_id, ERR_BAD_REQUEST)
                    return
                if op == 2:  # DESTROY
                    conn.txns.pop(tid, None)
                elif op == 3:  # RESET
                    tr.reset()
                elif op == 4:  # SET
                    k, off = _bstr(body, off)
                    v, off = _bstr(body, off)
                    tr.set(k, v)
                elif op == 5:  # CLEAR_RANGE
                    b, off = _bstr(body, off)
                    e, off = _bstr(body, off)
                    tr.clear_range(b, e)
                elif op == 6:  # GET
                    k, off = _bstr(body, off)
                    val = await tr.get(k)
                    out += bytes([0 if val is None else 1])
                    _wstr(out, val or b"")
                elif op == 7:  # GET_RANGE
                    b, off = _bstr(body, off)
                    e, off = _bstr(body, off)
                    limit, off = _u32(body, off)
                    rows = await tr.get_range(b, e, limit=limit)
                    out += struct.pack("<I", len(rows))
                    for k, v in rows:
                        _wstr(out, k)
                        _wstr(out, v)
                elif op == 8:  # COMMIT
                    version = await tr.commit()
                    out += struct.pack("<q", version)
                elif op == 9:  # ON_ERROR
                    (code,) = struct.unpack_from("<i", body, off)
                    if code in RETRYABLE_CODES:
                        await self.loop.delay(tr._backoff)
                        tr._backoff = min(tr._backoff * 2, 1.0)
                        tr.reset()
                    else:
                        status = ERR_BAD_REQUEST
                elif op == 10:  # ATOMIC_ADD
                    k, off = _bstr(body, off)
                    (delta,) = struct.unpack_from("<q", body, off)
                    tr.atomic_op(
                        MutationType.ADD, k,
                        delta.to_bytes(8, "little", signed=True),
                    )
                elif op == 11:  # GET_READ_VERSION
                    v = await tr.get_read_version()
                    out += struct.pack("<q", v)
                elif op == 13:  # SET_OPTION ("name" or "name=value": the
                    # valued options — debug_transaction_identifier carries
                    # the client's sampled debug ID into the trace plane)
                    name, off = _bstr(body, off)
                    opt, _, value = name.partition(b"=")
                    try:
                        tr.set_option(opt, value or None)
                    except (ValueError, TypeError):
                        status = ERR_BAD_REQUEST
                elif op == 15:  # GET_KEY (selector resolution, server-side
                    # through the RYW merge — docs/API.md)
                    sel, off = _bsel(body, off)
                    try:
                        resolved = await tr.get_key(sel)
                    except (ValueError, TypeError):
                        status = ERR_BAD_REQUEST
                        resolved = b""
                    if status == OK:
                        _wstr(out, resolved)
                elif op == 16:  # GET_RANGE_SELECTOR
                    bsel, off = _bsel(body, off)
                    esel, off = _bsel(body, off)
                    limit, off = _u32(body, off)
                    try:
                        rows = await tr.get_range(bsel, esel, limit=limit)
                    except (ValueError, TypeError):
                        status = ERR_BAD_REQUEST
                        rows = []
                    if status == OK:
                        out += struct.pack("<I", len(rows))
                        for k, v in rows:
                            _wstr(out, k)
                            _wstr(out, v)
                elif op == 14:  # WATCH (db-level: replies when key changes)
                    k, off = _bstr(body, off)
                    task = await self.db.watch(k)
                    # reap on client disconnect: an abandoned watch must not
                    # park a waiter task + storage registration forever (a
                    # never-changing key would accumulate them unboundedly)
                    while not task.done():
                        if conn.closed:
                            task.cancel()
                            return
                        from ..runtime.combinators import wait_any

                        await wait_any([task, self.loop.delay(0.5)])
                    ver = task.result()
                    out += struct.pack("<q", ver)
                else:
                    status = ERR_BAD_REQUEST
            self._reply(conn, req_id, status, bytes(out))
        except ActorCancelled:
            raise  # gateway teardown: don't answer from a dying handler
        except Exception as e:  # noqa: BLE001 — errors become status codes
            for etype, code in _ERR_CODE.items():
                if isinstance(e, etype):
                    self._reply(conn, req_id, code)
                    return
            self._reply(conn, req_id, ERR_INTERNAL)

    def close(self) -> None:
        for key in list(self._sel.get_map().values()):
            if key.data is not None:
                self._drop(key.data)
        self._sel.unregister(self._lsock)
        self._lsock.close()


class GatewayDriver(WallDriver):
    """Wall-clock driver for a sim cluster + gateway — a WallDriver over
    the gateway's reactor, optionally sharing the idle gap with a second
    `pump(timeout)` (the server's RealNetwork when remote coordinators are
    in play)."""

    def __init__(self, loop: EventLoop, gateway: ClientGateway,
                 extra_pump=None) -> None:
        pumps = [gateway.pump] + ([extra_pump] if extra_pump is not None else [])
        super().__init__(loop, pumps)
        self.gw = gateway


# bindings/c beside this package: the C ABI and its smoke program
C_SOURCES = Path(__file__).resolve().parents[2] / "bindings" / "c"


def build_c_bindings(out_dir) -> tuple[Path, Path]:
    """Compiles bindings/c/fdbtpu_c.cpp into `out_dir`/libfdbtpu_c.so and
    bindings/c/ctest.c against it into `out_dir`/ctest with g++ (bindings/c's
    Makefile, with its outputs elsewhere: nothing is written beside the
    sources).  Returns (library, ctest); raises with the compiler's
    output when a build fails."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    lib, ctest = out / "libfdbtpu_c.so", out / "ctest"
    flags = ["-O2", "-fPIC", "-Wall", "-Wextra"]
    for cmd in (
        ["g++", *flags, "-shared", "-o", str(lib), str(C_SOURCES / "fdbtpu_c.cpp")],
        ["g++", *flags, "-o", str(ctest), str(C_SOURCES / "ctest.c"), f"-L{out}",
         "-lfdbtpu_c", f"-Wl,-rpath,{out}"],
    ):
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
    return lib, ctest
