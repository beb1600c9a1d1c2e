"""Pure-Python client for the gateway wire protocol — the script-language
binding that needs no compiled library (the slot of the reference's
bindings/python/fdb/impl.py, speaking tools/gateway.py's protocol instead
of linking fdb_c).

    from foundationdb_tpu_torch.client.gateway_client import GatewayClient, open_cluster

    db = GatewayClient(host, port)                 # direct
    db = open_cluster("/etc/fdbtpu/fdb.cluster")   # via coordinator discovery
    with db.transaction() as tr:
        tr[b"k"] = b"v"       # commit on clean exit; on_error+retry loop
    print(db.read(lambda tr: tr[b"k"]))

Blocking, one request in flight per client (the simple-binding contract);
see bindings/python/fdbtpu_ctypes.py for the C-ABI twin.

Survives server bounces: a dead connection (the gateway process was
SIGTERMed by fdbmonitor, or crashed) is redialed with capped exponential
backoff.  Transaction state does NOT survive the server process, so the
client tracks a connection generation: operations on a transaction
created before the bounce surface a RETRYABLE error — reads/GRV as
transaction_too_old (2), commit as commit_unknown_result (3), exactly the
ambiguity the sim client surfaces — and `run(fn)`'s on_error respawns the
transaction on the new connection, so the standard retry loop rides
straight through a rolling bounce.  A transaction with NO prior
successful operation retries transparently (nothing observable happened
on the old connection).

Copy of the reference package's module, on the port's own modules.  A
client runs nothing on a device, so it takes no device.
"""

from __future__ import annotations

import socket
import struct
import time

_LEN = struct.Struct("<I")
_HDR = struct.Struct("<QB")

RETRYABLE_CODES = {1, 2, 3, 4, 5}
ERR_TOO_OLD = 2          # transaction_too_old: reads on a bounced txn
ERR_UNKNOWN_RESULT = 3   # commit_unknown_result: commit lost in flight


class GatewayError(Exception):
    def __init__(self, code: int) -> None:
        super().__init__(f"gateway error status {code}")
        self.code = code


def _wstr(out: bytearray, s: bytes) -> None:
    out += struct.pack("<I", len(s))
    out += s


class Transaction:
    def __init__(self, db: "GatewayClient", tid: int) -> None:
        self._db = db
        self._tid = tid
        self._gen = db._gen     # connection generation the tid lives on
        self._used = False      # any successful op yet? gates transparent retry
        self.debug_id: str | None = None  # set by set_debug_id

    def _body(self, *parts) -> bytearray:
        """bytes parts are length-prefixed strings; bytearray parts are RAW
        fixed-width fields (the gateway reads ints without a length prefix)."""
        out = bytearray(struct.pack("<Q", self._tid))
        for p in parts:
            if isinstance(p, bytearray):
                out += p
            else:
                _wstr(out, p)
        return out

    def _respawn(self) -> None:
        """Recreate the server-side transaction on the CURRENT connection:
        the old one died with its server process.  Fresh tid, fresh state —
        exactly a reset transaction, which is why on_error may substitute
        this for the wire round-trip after a bounce."""
        body = self._db._call(1)
        (self._tid,) = struct.unpack_from("<Q", body, 0)
        self._gen = self._db._gen
        self._used = False

    def _call(self, op: int, *parts, retry_code: int = ERR_TOO_OLD) -> bytes:
        """One transaction-scoped request.  A dead connection (or a tid
        minted on a previous connection generation) surfaces `retry_code`
        as a retryable GatewayError — UNLESS this transaction never
        completed an operation, in which case nothing observable was lost
        and it transparently respawns on the redialed connection."""
        db = self._db
        if self._gen != db._gen or db._sock is None:
            # a torn-down connection is the same as a bumped generation:
            # _send_recv would redial lazily and send this tid to a server
            # process that never minted it
            if self._used:
                raise GatewayError(retry_code)
            self._respawn()
        try:
            out = db._send_recv(op, self._body(*parts))
        except (ConnectionError, OSError):
            if self._used:
                raise GatewayError(retry_code) from None
            self._respawn()  # redials (capped backoff) under the hood
            out = db._send_recv(op, self._body(*parts))
        self._used = True
        return out

    def set(self, key: bytes, value: bytes) -> None:
        self._call(4, key, value)

    __setitem__ = set

    def get(self, key: bytes) -> bytes | None:
        body = self._call(6, key)
        present = body[0]
        (n,) = struct.unpack_from("<I", body, 1)
        return bytes(body[5 : 5 + n]) if present else None

    __getitem__ = get

    def clear_range(self, begin: bytes, end: bytes) -> None:
        self._call(5, begin, end)

    @staticmethod
    def _parse_rows(body: bytes):
        (n,) = struct.unpack_from("<I", body, 0)
        off = 4
        rows = []
        for _ in range(n):
            (kl,) = struct.unpack_from("<I", body, off)
            off += 4
            k = bytes(body[off : off + kl])
            off += kl
            (vl,) = struct.unpack_from("<I", body, off)
            off += 4
            rows.append((k, bytes(body[off : off + vl])))
            off += vl
        return rows

    def get_range(self, begin: bytes, end: bytes, limit: int = 10000):
        body = self._call(
            7, begin, end, bytearray(struct.pack("<I", limit))
        )
        return self._parse_rows(body)

    @staticmethod
    def _sel(key: bytes, or_equal: bool, offset: int) -> list:
        """Wire form of one KeySelector: key, u8 or_equal, i32 offset."""
        return [key, bytearray(struct.pack("<Bi", 1 if or_equal else 0, offset))]

    def get_key(self, key: bytes, or_equal: bool = False, offset: int = 1) -> bytes:
        """Resolve a KeySelector server-side (GET_KEY, op 15).  Defaults are
        first_greater_or_equal(key); selector semantics — offset stepping,
        boundary clamps — in docs/API.md."""
        body = self._call(15, *self._sel(key, or_equal, offset))
        (n,) = struct.unpack_from("<I", body, 0)
        return bytes(body[4 : 4 + n])

    def get_range_selector(self, begin_key: bytes, begin_or_equal: bool,
                           begin_offset: int, end_key: bytes,
                           end_or_equal: bool, end_offset: int,
                           limit: int = 10000):
        """Range read with KeySelector endpoints (GET_RANGE_SELECTOR, op 16):
        both endpoints resolve server-side, then the window is read."""
        body = self._call(
            16,
            *self._sel(begin_key, begin_or_equal, begin_offset),
            *self._sel(end_key, end_or_equal, end_offset),
            bytearray(struct.pack("<I", limit)),
        )
        return self._parse_rows(body)

    def atomic_add(self, key: bytes, delta: int) -> None:
        self._call(10, key, bytearray(struct.pack("<q", delta)))

    def get_read_version(self) -> int:
        body = self._call(11)
        return struct.unpack_from("<q", body, 0)[0]

    def set_option(self, option: bytes) -> None:
        self._call(13, option)

    def set_debug_id(self, debug_id: str) -> None:
        """Sample this transaction into the DISTRIBUTED trace plane: the
        id rides SET_OPTION (debug_transaction_identifier) so the server's
        pipeline stations join it, and this process's own commit stations
        land in its local g_trace_batch — which, when bound to a
        TraceCollector with a file sink, gives the CLIENT process its own
        trace file for tools/trace_tool.py to join by debug ID."""
        self.debug_id = debug_id
        self.set_option(b"debug_transaction_identifier=" + debug_id.encode())

    def watch(self, key: bytes) -> int:
        """BLOCKS this connection until `key`'s value changes; returns the
        firing version.  Use a dedicated GatewayClient for watches — the
        simple binding runs one request at a time.  The socket timeout is
        suspended for the wait: a timeout mid-watch would desync the
        request/reply stream (the late reply frame poisons the next call)."""
        db = self._db
        if db._sock is None:
            db._reconnect()
        sock = db._sock
        old = sock.gettimeout()
        sock.settimeout(None)
        try:
            body = self._call(14, key)
        finally:
            try:
                sock.settimeout(old)
            except OSError:
                pass  # the watched connection died; next op redials
        return struct.unpack_from("<q", body, 0)[0]

    def commit(self) -> int:
        if self.debug_id is not None:
            from ..runtime.trace import g_trace_batch

            g_trace_batch.add("GatewayClient.commit.Before", self.debug_id)
        # a commit whose reply is lost in flight is AMBIGUOUS — the server
        # may have made it durable before dying — so it surfaces
        # commit_unknown_result, never a silent retry (the sim client's
        # contract, client/transaction.py)
        body = self._call(8, retry_code=ERR_UNKNOWN_RESULT)
        if self.debug_id is not None:
            from ..runtime.trace import g_trace_batch

            g_trace_batch.add("GatewayClient.commit.After", self.debug_id)
        return struct.unpack_from("<q", body, 0)[0]

    def on_error(self, code: int) -> None:
        db = self._db
        if self._gen == db._gen and db._sock is not None:
            try:
                db._send_recv(9, self._body(bytearray(struct.pack("<i", code))))
                self._used = False  # server-side reset: state wiped
                return
            except (ConnectionError, OSError):
                pass
        # the server-side transaction died with its connection: a freshly
        # respawned transaction IS on_error's post-state (empty write set,
        # new snapshot), and the redial backoff already paid the delay
        self._respawn()

    def reset(self) -> None:
        db = self._db
        if self._gen == db._gen and db._sock is not None:
            try:
                db._send_recv(3, self._body())
                self._used = False
                return
            except (ConnectionError, OSError):
                pass
        self._respawn()

    def destroy(self) -> None:
        db = self._db
        if self._gen != db._gen or db._sock is None:
            return  # the server-side object died with the old connection
        try:
            db._send_recv(2, self._body())
        except (ConnectionError, OSError):
            pass  # connection died: nothing left to destroy

    # context manager: commit on clean exit.  A retryable commit failure
    # PROPAGATES — the block cannot be re-run from here, and on_error wipes
    # the write set, so a retry loop would commit an empty transaction and
    # silently drop the block's writes.  Use GatewayClient.run(fn) for the
    # retry-loop contract.
    def __enter__(self) -> "Transaction":
        return self

    def __exit__(self, et, ev, tb) -> bool:
        try:
            if et is None:
                self.commit()
        finally:
            self.destroy()
        return False


class GatewayClient:
    def __init__(self, host: str, port: int, timeout: float = 30.0, *,
                 reconnect_backoff: float = 0.05,
                 reconnect_max: float = 2.0,
                 reconnect_window: float = 20.0,
                 rediscover=None) -> None:
        """`reconnect_*`: redial policy when the connection dies (server
        bounce) — capped exponential backoff, giving up (the underlying
        OSError propagates) once an attempt would start past
        `reconnect_window` seconds.  `rediscover`: () -> (host, port),
        re-resolves the gateway address before each redial — open_cluster
        wires the coordinator-quorum lookup here so a bounce that moved
        the gateway port still reconnects."""
        self._addr = (host, port)
        self._timeout = timeout
        self._reconnect_backoff = reconnect_backoff
        self._reconnect_max = reconnect_max
        self._reconnect_window = reconnect_window
        self._rediscover = rediscover
        self._req = 0
        self._gen = 0     # bumped per (re)dial: tid validity marker
        self._closed = False
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.settimeout(timeout)

    def _reconnect(self) -> None:
        """Redial with capped exponential backoff.  On success the
        connection GENERATION bumps: server-side transaction state did not
        survive, and every Transaction holding an old-generation tid
        surfaces a retryable error on its next operation."""
        if self._closed:
            raise ConnectionError("gateway client closed")
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        delay = self._reconnect_backoff
        deadline = time.monotonic() + self._reconnect_window  # flowlint: ok wall-clock (blocking real-TCP client: redial budget is host wall by design)
        while True:
            addr = self._rediscover() if self._rediscover else self._addr
            try:
                sock = socket.create_connection(addr, timeout=self._timeout)
            except OSError:
                if time.monotonic() + delay > deadline:  # flowlint: ok wall-clock (same redial budget)
                    raise
                time.sleep(delay)  # flowlint: ok wall-clock (redial backoff between attempts at a dead server)
                delay = min(delay * 2, self._reconnect_max)
                continue
            sock.settimeout(self._timeout)
            self._sock = sock
            self._addr = addr
            self._gen += 1
            return

    def _send_recv(self, op: int, body: bytes | bytearray = b"") -> bytes:
        """One request/reply on the CURRENT connection (redialing first if
        a previous failure tore it down).  A mid-flight connection death
        propagates as ConnectionError/OSError — the caller decides whether
        the op is safe to retry (Transaction._call's generation logic)."""
        if self._sock is None:
            self._reconnect()
        self._req += 1
        payload = _HDR.pack(self._req, op) + bytes(body)
        try:
            self._sock.sendall(_LEN.pack(len(payload)) + payload)
            hdr = self._recv_exact(_LEN.size)
            (flen,) = _LEN.unpack(hdr)
            frame = self._recv_exact(flen)
        except (ConnectionError, OSError):
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None  # next op redials lazily
            raise
        req_id, status = _HDR.unpack_from(frame, 0)
        if req_id != self._req:
            raise GatewayError(255)
        if status != 0:
            raise GatewayError(status)
        return frame[_HDR.size :]

    def _call(self, op: int, body: bytes | bytearray = b"") -> bytes:
        """Connection-scoped request (no transaction state at stake):
        transparently redials and retries ONCE on a dead connection."""
        try:
            return self._send_recv(op, body)
        except (ConnectionError, OSError):
            self._reconnect()
            return self._send_recv(op, body)

    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("gateway closed")
            buf += chunk
        return bytes(buf)

    def protocol_version(self) -> int:
        return struct.unpack_from("<I", self._call(12), 0)[0]

    def transaction(self) -> Transaction:
        body = self._call(1)
        (tid,) = struct.unpack_from("<Q", body, 0)
        return Transaction(self, tid)

    def run(self, fn):
        """Retry loop (the bindings' `run` contract): ONE gateway-side
        transaction reused across retries (on_error resets it), destroyed
        on every exit path — no server-side object leaks."""
        tr = self.transaction()
        try:
            while True:
                try:
                    out = fn(tr)
                    tr.commit()
                    return out
                except GatewayError as e:
                    if e.code not in RETRYABLE_CODES:
                        raise
                    tr.on_error(e.code)
        finally:
            tr.destroy()

    def read(self, fn):
        tr = self.transaction()
        try:
            return fn(tr)
        finally:
            tr.destroy()

    def close(self) -> None:
        self._closed = True
        if self._sock is not None:
            self._sock.close()
            self._sock = None


def open_cluster(cluster_file: str, timeout: float = 15.0) -> GatewayClient:
    """Connect via the cluster file: discover the current gateway from the
    coordinator quorum (MonitorLeader), then dial it.  Reconnects after a
    server bounce re-run the discovery — the bounced server republishes
    its (possibly new) gateway address to the quorum."""
    from .cluster_file import discover_gateway

    host, port = discover_gateway(cluster_file, timeout=timeout)
    return GatewayClient(
        host, port,
        rediscover=lambda: discover_gateway(cluster_file, timeout=timeout),
    )
