"""DiskQueue: checksummed framed append log over a (sim) file — the
fdbserver/DiskQueue.actor.cpp analog (RawDiskQueue_TwoFiles :112,
DiskQueue :644).

The reference keeps a durable ring of two files with checksummed pages;
here the same guarantees come from a single append log of framed records:

    [magic u32][len u32][crc32 u32][payload bytes]

`push()` buffers a record; `sync()` makes everything pushed so far durable
(one fsync covers all buffered records — group commit, exactly how the
TLog amortizes fsyncs).  `recover()` scans the synced prefix and stops at
the first torn/corrupt frame — a partial trailing record (the crash case)
is silently discarded, never served.

Compaction is the owner's job (the TLog/kvstore rewrites the file with a
fresh snapshot record when most of it is popped) via `rewrite()`.

Copy of the reference package's module, on the port's own modules.
"""

from __future__ import annotations

import struct
import zlib

from .files import SimFile

_MAGIC = 0x51FDB701
_HEADER = struct.Struct("<III")  # magic, len, crc32


class DiskQueue:
    def __init__(self, file: SimFile) -> None:
        self.file = file
        self.bytes_pushed = 0

    # -- write path ---------------------------------------------------------
    def push(self, payload: bytes) -> int:
        """Append one framed record; returns its file offset (the TLog's
        spill index records it to re-read entries evicted from memory)."""
        off = self.file.size()
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        self.file.append(_HEADER.pack(_MAGIC, len(payload), crc) + payload)
        self.bytes_pushed += len(payload)
        return off

    def read_at(self, off: int) -> bytes:
        """Re-read one record by the offset push() returned (spilled-entry
        fetch).  Offsets are invalidated by rewrite() — callers must not
        hold them across a rewrite.

        A checksum mismatch is retried once: the sim's corrupt-on-read
        fault (`disk.corrupt_read`, files.py) is a transient media error a
        real engine heals by re-reading; only a SECOND failure — the data
        is really gone — raises."""
        for attempt in (0, 1):
            head = self.file.pread(off, _HEADER.size)
            if len(head) < _HEADER.size:
                raise IOError(f"diskqueue short read at {off}")
            magic, ln, crc = _HEADER.unpack(head)
            if magic == _MAGIC:
                payload = self.file.pread(off + _HEADER.size, ln)
                if len(payload) == ln and (zlib.crc32(payload) & 0xFFFFFFFF) == crc:
                    return payload
            if attempt == 0:
                from ..runtime.coverage import testcov

                testcov("disk.corrupt_read_retried")
        raise IOError(f"diskqueue record corrupt at {off}")

    async def sync(self) -> None:
        await self.file.sync()

    def rewrite(self, records: list[bytes]) -> None:
        """Truncate and re-push `records` (compaction).  The truncate is
        JOURNALED (files.SimFile.truncate): the old synced contents stay
        recoverable until the next successful sync() makes the replacement
        durable, so a crash in the window recovers the pre-compaction log —
        never an empty file.  A push REFUSED mid-rewrite (disk fault
        plane: ENOSPC/injected error) un-journals the truncate before
        re-raising — otherwise the next sync would land the truncate with
        the replacement records missing, destroying the durable log.
        Records partially pushed before the failure stay appended after
        the old contents; every rewrite consumer's record vocabulary is
        snapshot-style (RESET/SNAPSHOT resets state on replay), so a
        recovered old-log + partial-replacement sequence reads correctly."""
        self.file.truncate()
        self.bytes_pushed = 0
        try:
            for r in records:
                self.push(r)
        except IOError:
            self.file.cancel_truncate()
            raise

    # -- recovery -----------------------------------------------------------
    def recover(self, include_unsynced: bool = False) -> list[bytes]:
        """Scan the log; return the valid record prefix.  Stops at the first
        torn or corrupt frame (trailing garbage from a crash mid-append).

        By default only the SYNCED prefix is read — recovery happens after a
        crash, where the page cache is gone.  include_unsynced exists for
        same-process reads (e.g. rolling restarts without a kill)."""
        buf = (
            self.file.read_all() if include_unsynced else self.file.read_durable()
        )
        out: list[bytes] = []
        pos = 0
        n = len(buf)
        while pos + _HEADER.size <= n:
            magic, ln, crc = _HEADER.unpack_from(buf, pos)
            if magic != _MAGIC or pos + _HEADER.size + ln > n:
                break  # torn/garbage frame: end of valid prefix
            payload = bytes(buf[pos + _HEADER.size : pos + _HEADER.size + ln])
            if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                break  # corrupt payload
            out.append(payload)
            pos += _HEADER.size + ln
        return out
