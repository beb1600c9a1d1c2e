"""BlobStore — an HTTP-object-store backup destination and its
deterministic simulation twin (fdbclient/BlobStore.actor.cpp: the S3-style
blob client every off-cluster backup container speaks through;
BackupContainer.actor.cpp's `blobstore://` URL scheme).

Three layers, one object model:

  BlobObjectStore   the server-side logic over a pluggable backing —
                    immutable objects with a per-object crc32 recorded in
                    a meta record written only AFTER the payload is
                    durable (durable meta ⇒ durable payload, so a power
                    kill can never leave a listed-but-torn object), and
                    multipart uploads staged under an upload id until an
                    explicit `complete` verifies every part's claimed
                    crc32 plus the whole-object crc32.  A torn part is
                    refused at complete — the staging is discarded and the
                    client re-uploads; a half-written upload that is never
                    completed (the uploader died) is simply invisible:
                    LIST and GET only see completed objects.

  transports        SimBlobTransport runs the store in-simulation with
                    seeded latency and the buggify fault sites
                    `blob.connect_fail` / `blob.upload_torn` /
                    `blob.read_corrupt`; BlobStoreServer +
                    HttpBlobTransport speak real HTTP/1.1 over asyncio
                    sockets (PUT part / POST complete / GET / HEAD / LIST
                    / DELETE) for off-simulation use (an `http://` URL).

  BlobStoreClient   the retrying client both backup paths use: every
                    operation retries transient and checksum failures
                    with exponential backoff (BLOB_RETRY_LIMIT /
                    BLOB_BACKOFF_S knobs), tracing a SEV_WARN
                    `BlobRequestRetried` per attempt (soak triage
                    summarizes retry storms per seed), and verifies the
                    crc32 of everything it reads — a corrupt body is
                    re-fetched, and an object that NEVER passes its
                    checksum is refused loudly, not restored.

`BlobQueue` adapts an object-store prefix to the DiskQueue push/sync
surface so the backup worker and snapshot writer (client/backup.py,
roles/backup.py) stream into `blob://` containers unchanged: each sync
uploads the pending records as one immutable object, and the worker's
pop-after-sync discipline means TLog data is only released once it is
durable in the object store.

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

import asyncio
import binascii
import json

from ..runtime.buggify import buggify
from ..runtime.core import ActorCancelled, TaskPriority
from ..runtime.coverage import testcov
from ..runtime.serialize import BinaryReader, BinaryWriter
from ..runtime.trace import SEV_WARN


def blob_crc(data: bytes) -> int:
    return binascii.crc32(data) & 0xFFFFFFFF


class BlobError(Exception):
    """Permanent blob-store failure (retries exhausted, corrupt object)."""


class BlobTransientError(BlobError):
    """Retryable: connection failure, missing staging, 5xx."""


class BlobChecksumError(BlobError):
    """A body that fails its crc32 — torn upload or corrupt read."""


class BlobNotFound(BlobError):
    """No such object (NOT retried: absence is an answer)."""


# ---------------------------------------------------------------------------
# backings: where the server's bytes live


class HostBacking:
    """Plain-memory backing for the real (asyncio) server."""

    def __init__(self) -> None:
        self._files: dict[str, bytes] = {}

    async def write(self, path: str, data: bytes) -> None:
        """Replace-whole-file, durable on return."""
        self._files[path] = bytes(data)

    async def read(self, path: str) -> bytes | None:
        return self._files.get(path)

    def exists(self, path: str) -> bool:
        return path in self._files

    def list(self, prefix: str) -> list[str]:
        return sorted(p for p in self._files if p.startswith(prefix))

    def delete(self, path: str) -> None:
        self._files.pop(path, None)


class SimFSBacking:
    """SimFilesystem backing: the simulated object store's disks, with the
    crash model every other durable component gets — a write is durable
    only once its fsync returned, a power kill drops buffered tails, and a
    restart image (storage/image.py) carries exactly the synced prefixes.
    The handle is process-less (the store is off-cluster: no region kill
    touches it), so durability is governed purely by the sync calls."""

    def __init__(self, fs, prefix: str = "blob/") -> None:
        self.fs = fs
        self.prefix = prefix

    def _p(self, path: str) -> str:
        return self.prefix + path

    async def write(self, path: str, data: bytes) -> None:
        p = self._p(path)
        self.fs.delete(p)  # objects are immutable; a rewrite replaces
        f = self.fs.open(p, None)
        try:
            f.append(data)
            await f.sync()
        except IOError as e:
            # the store's own disk refused (the disk fault plane —
            # injected error/ENOSPC/stall-kill): to the blob CLIENT this
            # is a transient backend failure like any 5xx, and its
            # backoff/retry budget owns it; a half-written object is
            # invisible (the meta record is the commit point)
            raise BlobTransientError(f"backing disk: {e}") from e
        finally:
            f.close()

    async def read(self, path: str) -> bytes | None:
        p = self._p(path)
        if not self.fs.exists(p):
            return None
        f = self.fs.open(p, None)
        try:
            return f.read_all()
        finally:
            f.close()

    def exists(self, path: str) -> bool:
        return self.fs.exists(self._p(path))

    def list(self, prefix: str) -> list[str]:
        n = len(self.prefix)
        return [p[n:] for p in self.fs.list(self._p(prefix))]

    def delete(self, path: str) -> None:
        self.fs.delete(self._p(path))


# ---------------------------------------------------------------------------
# the object store


class BlobObjectStore:
    """Server-side object model over a backing (see module doc).  Backing
    layout: `o/<name>` payload, `m/<name>` meta json (existence = meta),
    `u/<upload>/<part>` multipart staging with an 8-hex-digit claimed
    crc32 prefix per part."""

    def __init__(self, backing) -> None:
        self.backing = backing

    @staticmethod
    def _part_path(upload: str, part: int) -> str:
        return f"u/{upload}/{part:06d}"

    async def put_part(self, upload: str, part: int, data: bytes,
                       crc32: int) -> None:
        """Stage one part.  The CLAIMED crc rides with the bytes and is
        verified at complete(): a body torn in flight is caught there and
        the whole upload refused — never silently assembled."""
        await self.backing.write(
            self._part_path(upload, part), b"%08x" % crc32 + data
        )

    async def complete(self, name: str, upload: str, crc32: int,
                       parts: int) -> None:
        """Assemble `upload`'s parts into object `name` — THE torn-upload
        gate: every part's bytes must match its claimed crc32 and the
        whole must match the object crc32, or the staging is discarded and
        the uploader must start over."""
        bufs: list[bytes] = []
        torn = False
        for i in range(parts):
            raw = await self.backing.read(self._part_path(upload, i))
            if raw is None or len(raw) < 8:
                # a part that never arrived: the uploader died mid-stream
                # or the staging was already swept — retryable, the client
                # re-uploads everything under a fresh upload id
                self._sweep(upload)
                raise BlobTransientError(
                    f"{name}: upload {upload} part {i} missing"
                )
            claimed, body = int(raw[:8], 16), raw[8:]
            if blob_crc(body) != claimed:
                torn = True
                break
            bufs.append(body)
        data = b"".join(bufs)
        if not torn and blob_crc(data) != crc32:
            torn = True
        if torn:
            self._sweep(upload)
            testcov("blob.torn_refused")
            raise BlobChecksumError(
                f"{name}: upload {upload} fails its checksum — torn part "
                f"refused, re-upload required"
            )
        # payload BEFORE meta: a power kill between the two leaves an
        # unlisted payload (garbage), never a listed torn object
        await self.backing.write("o/" + name, data)
        await self.backing.write(
            "m/" + name,
            json.dumps({"size": len(data), "crc32": crc32}).encode(),
        )
        self._sweep(upload)

    def _sweep(self, upload: str) -> None:
        for p in self.backing.list(f"u/{upload}/"):
            self.backing.delete(p)

    async def put(self, name: str, data: bytes, crc32: int) -> None:
        """Single-shot put (small objects) — same checksum gate."""
        if blob_crc(data) != crc32:
            testcov("blob.put_refused")
            raise BlobChecksumError(f"{name}: body fails its claimed crc32")
        await self.backing.write("o/" + name, data)
        await self.backing.write(
            "m/" + name,
            json.dumps({"size": len(data), "crc32": crc32}).encode(),
        )

    async def head(self, name: str) -> dict:
        raw = await self.backing.read("m/" + name)
        if raw is None:
            raise BlobNotFound(name)
        try:
            return json.loads(raw)
        except ValueError:
            # the meta record IS the object's commit point (written only
            # after the payload is durable): a torn meta means the power
            # died mid-finalize, i.e. the object was never committed — and
            # the uploader never got its ack, so it never released (popped)
            # the source data.  Absent, not corrupt.
            testcov("blob.torn_meta_ignored")
            raise BlobNotFound(f"{name}: torn meta (finalize died)") from None

    async def get(self, name: str) -> tuple[bytes, dict]:
        meta = await self.head(name)
        data = await self.backing.read("o/" + name)
        if data is None:
            raise BlobNotFound(name)
        return data, meta

    async def list(self, prefix: str) -> list[str]:
        out = []
        for p in self.backing.list("m/" + prefix):
            raw = await self.backing.read(p)
            try:
                json.loads(raw if raw is not None else b"")
            except ValueError:
                continue  # finalize died mid-meta: never a listed object
            out.append(p[2:])
        return out

    async def delete(self, name: str) -> None:
        self.backing.delete("m/" + name)  # existence dies first
        self.backing.delete("o/" + name)


# ---------------------------------------------------------------------------
# transports


class SimBlobTransport:
    """The deterministic in-simulation transport: seeded latency plus the
    three injected blob faults, applied exactly where a real network would
    hurt — connection establishment, a part's bytes in flight, a read's
    bytes on the way back."""

    def __init__(self, store: BlobObjectStore, loop, rng) -> None:
        self.store = store
        self.loop = loop
        self.rng = rng.split()

    async def request(self, op: str, *, name: str | None = None,
                      upload: str | None = None, part: int | None = None,
                      data: bytes | None = None, crc32: int | None = None,
                      parts: int | None = None, prefix: str | None = None):
        await self.loop.delay(
            0.0002 + self.rng.random() * 0.002, TaskPriority.DISK_IO
        )
        if buggify("blob.connect_fail"):
            raise BlobTransientError("injected connection failure")
        if op == "put_part":
            if buggify("blob.upload_torn") and data:
                # the bytes tear in flight; the CLAIMED crc still rides the
                # request, so complete() must catch the mismatch
                data = data[: max(1, len(data) // 2)]
            return await self.store.put_part(upload, part, data, crc32)
        if op == "complete":
            return await self.store.complete(name, upload, crc32, parts)
        if op == "put":
            return await self.store.put(name, data, crc32)
        if op == "get":
            body, meta = await self.store.get(name)
            if buggify("blob.read_corrupt") and body:
                # one bit flips on the wire; the meta crc is intact, so the
                # client-side verify catches it and re-fetches
                body = body[:-1] + bytes([body[-1] ^ 0xFF])
            return body, meta
        if op == "head":
            return await self.store.head(name)
        if op == "list":
            return await self.store.list(prefix or "")
        if op == "delete":
            return await self.store.delete(name)
        raise ValueError(f"unknown blob op {op!r}")


# ---------------------------------------------------------------------------
# the retrying client


class BlobStoreClient:
    """Exponential-backoff retry around any transport (see module doc).
    `sleep` is the backoff primitive: pass the sim loop's delay for
    deterministic runs (`lambda s: loop.delay(s)`); defaults to
    asyncio.sleep for real-network use."""

    def __init__(self, transport, *, knobs=None, trace=None, sleep=None,
                 nonce: str = "c0") -> None:
        from ..runtime.knobs import CoreKnobs

        self.transport = transport
        self.knobs = knobs or CoreKnobs()
        self.trace = trace
        self.sleep = sleep or asyncio.sleep
        self._nonce = nonce      # upload-id namespace (unique per client)
        self._uploads = 0
        self.retries = 0         # total retried attempts (observability)

    async def _retrying(self, what: str, attempt_fn):
        backoff = self.knobs.BLOB_BACKOFF_S
        last: BlobError | None = None
        for attempt in range(self.knobs.BLOB_RETRY_LIMIT + 1):
            if attempt:
                self.retries += 1
                if self.trace is not None:
                    self.trace.trace(
                        "BlobRequestRetried", severity=SEV_WARN,
                        What=what, Attempt=attempt, Error=repr(last),
                        BackoffS=backoff,
                    )
                await self.sleep(backoff)
                backoff = min(backoff * 2, self.knobs.BLOB_MAX_BACKOFF_S)
            try:
                result = await attempt_fn()
                if attempt:
                    testcov("blob.retry_recovered")
                return result
            except ActorCancelled:
                raise  # teardown mid-request must not look like a retry
            except BlobNotFound:
                raise  # absence is an answer, not a fault
            except (BlobTransientError, BlobChecksumError) as e:
                last = e
        raise BlobError(
            f"{what}: retries exhausted "
            f"({self.knobs.BLOB_RETRY_LIMIT}): {last!r}"
        ) from last

    async def write_object(self, name: str, data: bytes) -> None:
        """Chunked multipart upload with whole-object retry: a torn part
        refused at complete() (or an uploader that died and restarted)
        re-uploads under a FRESH upload id — staging is never reused."""
        data = bytes(data)
        total_crc = blob_crc(data)
        psize = self.knobs.BLOB_PART_BYTES
        nparts = max(1, -(-len(data) // psize))

        async def attempt():
            self._uploads += 1
            upload = f"{self._nonce}-{self._uploads:06d}"
            for i in range(nparts):
                chunk = data[i * psize : (i + 1) * psize]
                await self.transport.request(
                    "put_part", upload=upload, part=i, data=chunk,
                    crc32=blob_crc(chunk),
                )
            await self.transport.request(
                "complete", name=name, upload=upload, crc32=total_crc,
                parts=nparts,
            )

        await self._retrying(f"put {name}", attempt)

    async def read_object(self, name: str) -> bytes:
        """GET + client-side crc verify: a corrupt body is re-fetched; an
        object that never passes its checksum raises BlobError — a torn
        object must be refused, never restored."""

        async def attempt():
            body, meta = await self.transport.request("get", name=name)
            if len(body) != meta["size"] or blob_crc(body) != meta["crc32"]:
                testcov("blob.read_corrupt_detected")
                raise BlobChecksumError(f"{name}: body fails its checksum")
            return body

        return await self._retrying(f"get {name}", attempt)

    async def list_objects(self, prefix: str = "") -> list[str]:
        return await self._retrying(
            f"list {prefix}",
            lambda: self.transport.request("list", prefix=prefix),
        )

    async def head_object(self, name: str) -> dict:
        return await self._retrying(
            f"head {name}", lambda: self.transport.request("head", name=name)
        )

    async def delete_object(self, name: str) -> None:
        await self._retrying(
            f"delete {name}",
            lambda: self.transport.request("delete", name=name),
        )


# ---------------------------------------------------------------------------
# DiskQueue-shaped adapter (the backup container's write/read surface)


class BlobQueue:
    """push/sync/recover over an object prefix, DiskQueue-compatible so
    the backup worker and snapshot writer stream to blob unchanged.  Each
    sync() uploads the pending records as ONE immutable object named
    `<prefix>/<nonce>-<seq>`; the nonce is unique per queue instance, so a
    restarted uploader can never collide with a dead predecessor's
    in-flight finalize (duplicate CONTENT is possible — the dead worker
    completed an object but never popped — and is deduplicated by the
    version-keyed reader, client/backup.py)."""

    def __init__(self, client: BlobStoreClient, prefix: str,
                 nonce: str) -> None:
        self.client = client
        self.prefix = prefix.rstrip("/")
        self.nonce = nonce
        self._seq = 0
        self._pending: list[bytes] = []

    def push(self, record: bytes) -> None:
        self._pending.append(bytes(record))

    async def sync(self) -> None:
        if not self._pending:
            return
        records, self._pending = self._pending, []
        self._seq += 1
        w = BinaryWriter().u32(len(records))
        for r in records:
            w.bytes_(r)
        name = f"{self.prefix}/{self.nonce}-{self._seq:08d}"
        try:
            await self.client.write_object(name, w.data())
        except BaseException:
            # not durable: the records stay pending so the caller's next
            # sync (or its replacement's re-pull) still covers them
            self._pending = records + self._pending
            raise

    async def recover(self) -> list[bytes]:
        """Every record of every COMPLETED object under the prefix (an
        uploader's unfinished multipart is invisible by construction)."""
        out: list[bytes] = []
        for name in sorted(await self.client.list_objects(self.prefix + "/")):
            data = await self.client.read_object(name)
            r = BinaryReader(data)
            out.extend(r.bytes_() for _ in range(r.u32()))
        return out


# ---------------------------------------------------------------------------
# the real-network half: HTTP/1.1 server + transport (asyncio)

_STATUS_TEXT = {200: "OK", 400: "Bad Request", 404: "Not Found",
                409: "Conflict", 503: "Service Unavailable"}


async def _read_request(reader):
    line = await reader.readline()
    if not line:
        return None
    try:
        method, target, _version = line.decode("latin-1").split(None, 2)
    except ValueError:
        return None
    headers: dict[str, str] = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    body = b""
    n = int(headers.get("content-length", "0") or "0")
    if n:
        body = await reader.readexactly(n)
    return method, target, headers, body


def _response(status: int, body: bytes = b"", headers: dict | None = None) -> bytes:
    lines = [f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, 'Status')}"]
    for k, v in (headers or {}).items():
        lines.append(f"{k}: {v}")
    lines.append(f"content-length: {len(body)}")
    lines.append("connection: close")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body


def _parse_qs(target: str) -> tuple[str, dict[str, str]]:
    path, _, qs = target.partition("?")
    params = {}
    for kv in qs.split("&"):
        if "=" in kv:
            k, _, v = kv.partition("=")
            params[k] = v
    return path, params


class BlobStoreServer:
    """A minimal HTTP/1.1 object-store server over asyncio sockets — the
    in-repo test destination an `http://` container URL names (the
    deterministic simulation uses SimBlobTransport instead; this server
    exists so the SAME client/object model is exercised over real
    sockets).  One request per connection (connection: close)."""

    def __init__(self, store: BlobObjectStore | None = None,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self.store = store or BlobObjectStore(HostBacking())
        self.host = host
        self.port = port
        self._server = None

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        # take ownership before suspending: two racing stops must not both
        # act on the shared handle across the await (flowcheck
        # check-then-act discipline)
        server, self._server = self._server, None
        if server is not None:
            server.close()
            await server.wait_closed()

    async def _handle(self, reader, writer) -> None:
        try:
            req = await _read_request(reader)
            if req is None:
                return
            method, target, headers, body = req
            writer.write(await self._dispatch(method, target, headers, body))
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # a dead client mid-request is the client's problem
        finally:
            writer.close()

    async def _dispatch(self, method: str, target: str, headers: dict,
                        body: bytes) -> bytes:
        path, params = _parse_qs(target)
        try:
            if method == "PUT" and path.startswith("/u/"):
                _, _, rest = path.partition("/u/")
                upload, _, part = rest.rpartition("/")
                await self.store.put_part(
                    upload, int(part), body,
                    int(headers.get("x-blob-crc32", "0"), 16),
                )
                return _response(200)
            if method == "POST" and path.startswith("/complete/"):
                await self.store.complete(
                    path[len("/complete/"):], params["upload"],
                    int(params["crc32"], 16), int(params["parts"]),
                )
                return _response(200)
            if method == "PUT" and path.startswith("/o/"):
                await self.store.put(
                    path[3:], body, int(headers.get("x-blob-crc32", "0"), 16)
                )
                return _response(200)
            if method == "GET" and path.startswith("/o/"):
                data, meta = await self.store.get(path[3:])
                return _response(200, data, {
                    "x-blob-crc32": "%08x" % meta["crc32"],
                    "x-blob-size": str(meta["size"]),
                })
            if method == "HEAD" and path.startswith("/o/"):
                meta = await self.store.head(path[3:])
                return _response(200, b"", {
                    "x-blob-crc32": "%08x" % meta["crc32"],
                    "x-blob-size": str(meta["size"]),
                })
            if method == "GET" and path.startswith("/list/"):
                names = await self.store.list(path[len("/list/"):])
                return _response(200, "\n".join(names).encode())
            if method == "DELETE" and path.startswith("/o/"):
                await self.store.delete(path[3:])
                return _response(200)
            return _response(400, b"unknown route")
        except BlobNotFound as e:
            return _response(404, repr(e).encode())
        except BlobChecksumError as e:
            return _response(409, repr(e).encode())
        except (BlobTransientError, KeyError, ValueError) as e:
            return _response(503, repr(e).encode())


class HttpBlobTransport:
    """The BlobStoreClient transport over real sockets (one connection per
    request, mirroring the server's connection: close)."""

    def __init__(self, host: str, port: int) -> None:
        self.host = host
        self.port = port

    async def _roundtrip(self, method: str, target: str, body: bytes = b"",
                         headers: dict | None = None):
        try:
            reader, writer = await asyncio.open_connection(self.host, self.port)
        except OSError as e:
            raise BlobTransientError(f"connect: {e}") from None
        try:
            hs = dict(headers or {})
            hs["content-length"] = str(len(body))
            head = f"{method} {target} HTTP/1.1\r\n" + "".join(
                f"{k}: {v}\r\n" for k, v in hs.items()
            ) + "\r\n"
            writer.write(head.encode("latin-1") + body)
            await writer.drain()
            status_line = await reader.readline()
            status = int(status_line.split()[1])
            rhead: dict[str, str] = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode("latin-1").partition(":")
                rhead[k.strip().lower()] = v.strip()
            rbody = b""
            n = int(rhead.get("content-length", "0") or "0")
            if n and method != "HEAD":
                rbody = await reader.readexactly(n)
            return status, rhead, rbody
        except (OSError, asyncio.IncompleteReadError, IndexError, ValueError) as e:
            raise BlobTransientError(f"roundtrip: {e}") from None
        finally:
            writer.close()

    @staticmethod
    def _raise_for(status: int, body: bytes, what: str) -> None:
        if status == 404:
            raise BlobNotFound(what)
        if status == 409:
            raise BlobChecksumError(f"{what}: {body[:200]!r}")
        if status != 200:
            raise BlobTransientError(f"{what}: HTTP {status} {body[:200]!r}")

    async def request(self, op: str, *, name: str | None = None,
                      upload: str | None = None, part: int | None = None,
                      data: bytes | None = None, crc32: int | None = None,
                      parts: int | None = None, prefix: str | None = None):
        if op == "put_part":
            s, _h, b = await self._roundtrip(
                "PUT", f"/u/{upload}/{part}", data or b"",
                {"x-blob-crc32": "%08x" % (crc32 or 0)},
            )
            return self._raise_for(s, b, f"part {upload}/{part}")
        if op == "complete":
            s, _h, b = await self._roundtrip(
                "POST",
                f"/complete/{name}?upload={upload}"
                f"&crc32={'%08x' % (crc32 or 0)}&parts={parts}",
            )
            return self._raise_for(s, b, f"complete {name}")
        if op == "put":
            s, _h, b = await self._roundtrip(
                "PUT", f"/o/{name}", data or b"",
                {"x-blob-crc32": "%08x" % (crc32 or 0)},
            )
            return self._raise_for(s, b, f"put {name}")
        if op == "get":
            s, h, b = await self._roundtrip("GET", f"/o/{name}")
            self._raise_for(s, b, f"get {name}")
            return b, {"size": int(h.get("x-blob-size", len(b))),
                       "crc32": int(h.get("x-blob-crc32", "0"), 16)}
        if op == "head":
            s, h, b = await self._roundtrip("HEAD", f"/o/{name}")
            self._raise_for(s, b, f"head {name}")
            return {"size": int(h.get("x-blob-size", "0")),
                    "crc32": int(h.get("x-blob-crc32", "0"), 16)}
        if op == "list":
            s, _h, b = await self._roundtrip("GET", f"/list/{prefix or ''}")
            self._raise_for(s, b, f"list {prefix}")
            return [n for n in b.decode().split("\n") if n]
        if op == "delete":
            s, _h, b = await self._roundtrip("DELETE", f"/o/{name}")
            return self._raise_for(s, b, f"delete {name}")
        raise ValueError(f"unknown blob op {op!r}")
