"""Simulated filesystem with kill-time data loss — the IAsyncFile /
AsyncFileNonDurable analog (fdbrpc/IAsyncFile.h;
fdbrpc/AsyncFileNonDurable.actor.h:173,191).

The reference's durability testing rests on one property: a simulated file
buffers writes until `sync()`, and a process kill drops (or corrupts) the
un-synced suffix — so only data the role explicitly fsynced survives a
crash.  `SimFilesystem` owns file state; files outlive their processes
(they are the machine's disk), while each open handle belongs to a process
and loses its un-synced buffer when that process dies.

Latency model: writes are buffered instantly (page cache); `sync()` pays a
seeded delay (the fsync).  Deterministic like everything else in the sim.

Resource-exhaustion fault plane (the AsyncFileNonDurable + SimulatedMachine
disk-fault surface): each file is its own simulated DISK (one durable file
per role's state in this runtime), carrying

  * a capacity — appends past it raise `DiskFull` (ENOSPC),
  * a degraded mode — a latency multiplier on every fsync,
  * a stall window — fsyncs hang until the window closes,
  * injected I/O errors and corrupt-on-read bit flips,

each also reachable through `disk.*` buggify sites armed per seed under
chaos, with per-disk gauges (`disk_usage()`) surfaced in cluster status.
A sync stalled past `io_timeout_s` FAIL-FASTS the owning process through
the ordinary kill/recovery machinery (the reference's io_timeout story:
a wedged disk must kill the process, not wedge the commit plane).

Copy of the reference package's module, on the port's runtime, rpc,
buggify and coverage: the same seed gives the same files byte for byte.
"""

from __future__ import annotations

from ..rpc.network import SimProcess
from ..runtime.buggify import buggify
from ..runtime.core import DeterministicRandom, EventLoop, TaskPriority
from ..runtime.coverage import testcov
from ..runtime.trace import SEV_WARN


class DiskFull(IOError):
    """ENOSPC: an append would exceed the disk's capacity.  A dedicated
    type so callers can distinguish out-of-space (operator clears it /
    ratekeeper free-space limiting prevents it) from transient I/O
    errors (retryable)."""


class DiskState:
    """Per-disk fault state + gauges.  One simulated disk per file path:
    this runtime keeps each role's durable state in exactly one file, so
    the file IS the disk — per-disk capacity, degradation, and gauges
    attach here and `status()` renders the table."""

    __slots__ = (
        "capacity", "latency_mult", "stall_until", "error_budget",
        "buggify_fault_after",
        "ops", "reads", "syncs", "stalls", "errors_injected",
        "enospc_errors", "corrupt_reads", "sync_s",
    )

    def __init__(self) -> None:
        self.capacity: int | None = None  # None = unbounded
        self.latency_mult = 1.0           # degraded mode: >1 slows fsyncs
        self.stall_until = 0.0            # fsyncs hang until this sim time
        self.error_budget = 0             # next N ops raise injected IOError
        # per-disk cooldown gate for the ARMED buggify faults (error/
        # enospc/stall): disk ops are a hot path, and an armed site firing
        # at the per-call rate turns "transient fault" into a sustained
        # outage that recovery-loops the commit plane — one injected fault
        # per disk per cooldown keeps every class firing without storms
        self.buggify_fault_after = 0.0
        self.ops = 0
        self.reads = 0                    # preads only (ops counts all)
        self.syncs = 0
        self.stalls = 0
        self.errors_injected = 0
        self.enospc_errors = 0
        self.corrupt_reads = 0
        self.sync_s = 0.0                 # total virtual seconds in fsync


class _FileState:
    __slots__ = ("synced", "unsynced", "pending_truncate")

    def __init__(self) -> None:
        self.synced = bytearray()
        self.unsynced: list[bytes] = []  # append-only tail, lost on kill
        # truncate() is journaled: the synced prefix survives until the next
        # successful sync() applies it, so compaction can never destroy
        # durable data before its replacement is durable.
        self.pending_truncate = False

    def apply_buffers(self) -> None:
        """The ONE encoding of what fsync makes durable: a pending
        journaled truncate lands first, then the buffered tail.  Shared by
        SimFile.sync (per-file fsync) and SimFilesystem.flush_buffers (the
        orderly-shutdown flush) so the two can never drift — the negative
        crash-durability tests discriminate between exactly these paths."""
        if self.pending_truncate:
            self.synced = bytearray()
            self.pending_truncate = False
        for chunk in self.unsynced:
            self.synced.extend(chunk)
        self.unsynced.clear()


class SimFile:
    """An open handle: append/sync/read of one simulated file."""

    def __init__(self, fs: "SimFilesystem", path: str, state: _FileState,
                 process: SimProcess) -> None:
        self._fs = fs
        self.path = path
        self._st = state
        self._process = process
        self._closed = False

    # -- write path ---------------------------------------------------------
    def append(self, data: bytes) -> None:
        """Buffered append (page cache): instant, not durable.  Raises
        `DiskFull` when the disk's capacity would be exceeded (checked
        BEFORE buffering, so a refused append leaves no partial state) and
        injected `IOError`s when the disk's fault plane says so."""
        assert not self._closed
        disk = self._fs.disk(self.path)
        disk.ops += 1
        self._fs._maybe_injected_error(disk, self.path,
                                       armed=self._process is not None)
        if disk.capacity is not None and self.size() + len(data) > disk.capacity:
            disk.enospc_errors += 1
            testcov("disk.enospc_hit")
            raise DiskFull(
                f"{self.path}: ENOSPC ({self.size() + len(data)} "
                f"> capacity {disk.capacity})"
            )
        self._st.unsynced.append(bytes(data))

    async def sync(self) -> None:
        """Make all buffered appends durable (fsync): pays seeded latency,
        scaled by the disk's degraded-mode multiplier, held by any stall
        window, and subject to injected errors.  On return, everything
        appended before the call survives any kill.  A sync stalled past
        the filesystem's `io_timeout_s` fail-fasts the owning process (the
        reference's io_timeout: kill the process, never wedge the caller
        forever)."""
        assert not self._closed
        loop, rng = self._fs.loop, self._fs.rng
        disk = self._fs.disk(self.path)
        disk.ops += 1
        disk.syncs += 1
        # buggify-armed faults target CLUSTER disks (process-owned
        # handles); process-less handles — the off-cluster blob store,
        # restart-image plumbing, fs-level probes — keep only their
        # deterministic controls (capacity, error budgets, degrade/stall)
        armed = self._process is not None
        self._fs._maybe_injected_error(disk, self.path, armed=armed)
        t0 = loop.now()
        mult = disk.latency_mult
        if armed and buggify("disk.slow"):
            # transient degraded disk: this fsync runs seeded-times slower
            mult *= 4.0 + rng.random() * 12.0
        if armed and loop.now() >= disk.stall_until + 2.0 and buggify("disk.stall"):
            # transient stall: operations hang for a seeded window.  The
            # 2s cooldown after each window bounds the injected badness —
            # syncs are a hot path, and an armed site re-firing into a
            # live stall would keep the disk wedged essentially forever
            # (a permanently dead commit plane is the kill plane's job;
            # THIS plane tests degradation the cluster must absorb)
            disk.stall_until = loop.now() + 0.1 + rng.random() * 0.4
        await loop.delay(
            (self._fs.min_sync_latency
             + rng.random() * (self._fs.max_sync_latency - self._fs.min_sync_latency))
            * mult,
            TaskPriority.DISK_IO,
        )
        deadline = (
            None if self._fs.io_timeout_s is None
            else t0 + self._fs.io_timeout_s
        )
        if loop.now() < disk.stall_until:
            disk.stalls += 1
            while loop.now() < disk.stall_until:
                # the io_timeout is a WATCHDOG: it fires AT the deadline
                # while the disk is still wedged, not after the stall
                # happens to end — a wedge that never ends must still
                # kill.  The watchdog only arms for a LIVE owning process
                # (there is nothing to kill otherwise): a sync issued by
                # an already-dead process's zombie actor must wait the
                # stall out and fail via the died-mid-fsync check below —
                # clamping its wait to an already-passed deadline would
                # spin the loop at zero delay forever (review finding)
                watchdog = (
                    deadline is not None
                    and self._process is not None
                    and self._process.alive
                )
                wait_to = (
                    min(disk.stall_until, deadline) if watchdog
                    else disk.stall_until
                )
                await loop.delay(
                    max(wait_to - loop.now(), 0.0), TaskPriority.DISK_IO
                )
                if (
                    watchdog
                    and loop.now() >= deadline
                    and loop.now() < disk.stall_until
                    and self._process.alive
                ):
                    # the io_timeout fail-fast: a wedged disk kills its
                    # process so the ordinary failure-detection/recovery
                    # machinery replaces the role, instead of the commit
                    # plane waiting forever on a sync that will never
                    # return
                    testcov("disk.io_timeout_kill")
                    if self._fs.trace is not None:
                        self._fs.trace.trace(
                            "IoTimeoutKilled", severity=SEV_WARN,
                            track_latest=f"io-timeout-{self.path}",
                            Path=self.path, Process=self._process.name,
                            ElapsedS=round(loop.now() - t0, 3),
                            TimeoutS=self._fs.io_timeout_s,
                        )
                    self._process.kill()
                    break
        disk.sync_s += loop.now() - t0
        if self._process is not None and not self._process.alive:
            # killed mid-fsync: the buffers are already dropped and NOTHING
            # was made durable — returning normally would let the caller
            # ack durability it does not have (a dying TLog acking a commit
            # its disk never saw, the phantom the recovery-version rule
            # exists to exclude).  The dead process's code must see failure.
            raise IOError(f"{self.path}: process died during fsync")
        self._st.apply_buffers()

    def truncate(self) -> None:
        """Journaled truncate: buffered contents are dropped now, but the
        SYNCED prefix stays durable until the next successful sync() — a
        crash in between recovers the old contents, never an empty file
        (the rewrite-then-crash hole of naive compaction)."""
        assert not self._closed
        self._st.unsynced.clear()
        self._st.pending_truncate = True
        self._invalidate_cache()

    def cancel_truncate(self) -> None:
        """Un-journal a truncate that no sync has applied yet: the synced
        prefix becomes the live contents again.  Exists for compaction
        aborted by the disk fault plane (DiskQueue.rewrite: a replacement
        record refused mid-rewrite must not let the journaled truncate
        destroy the old contents at the next sync)."""
        assert not self._closed
        self._st.pending_truncate = False
        self._invalidate_cache()

    def _invalidate_cache(self) -> None:
        """Page-cache coherence hook (storage/pagecache.py): file contents
        below the append tail changed (truncate / cancel_truncate / kill-
        time unsynced drop) — any cached pages of this path are stale."""
        pool = self._fs.page_pool
        if pool is not None:
            pool.invalidate_file(self.path)

    # -- read path ----------------------------------------------------------
    def pread(self, offset: int, length: int, faults: bool = True) -> bytes:
        """Positional read of the current contents (same-process view) —
        the IAsyncFile::read analog the paged B-tree engine and the TLog
        spill path use.  O(length + unsynced chunks), never a full copy.

        Under the `disk.corrupt_read` buggify site one byte of the result
        is flipped (a transient media error): every paged consumer sits
        behind a checksum (DiskQueue frames, B-tree pages), so the flip
        surfaces as a detected-and-retried corruption, never silent bad
        data.  `faults=False` skips the flip — the page cache's fill path
        (storage/pagecache.py), which re-applies the SAME flip on the
        assembled result so corruption is never cached and a retry
        heals."""
        st = self._st
        disk = self._fs.disk(self.path)
        disk.ops += 1
        disk.reads += 1
        parts: list[bytes] = []
        pos, need = offset, length
        base = 0 if st.pending_truncate else len(st.synced)
        if pos < base and need > 0:
            take = min(need, base - pos)
            parts.append(bytes(st.synced[pos : pos + take]))
            pos += take
            need -= take
        chunk_start = base
        for chunk in st.unsynced:
            if need <= 0:
                break
            chunk_end = chunk_start + len(chunk)
            if pos < chunk_end:
                s = pos - chunk_start
                take = min(need, len(chunk) - s)
                parts.append(chunk[s : s + take])
                pos += take
                need -= take
            chunk_start = chunk_end
        out = b"".join(parts)
        return self._maybe_corrupt(out) if faults else out

    def _maybe_corrupt(self, out: bytes) -> bytes:
        """The `disk.corrupt_read` transient flip, factored out so the
        page cache applies it ABOVE its pages (one flip per logical pread,
        same as the bare file — never cached)."""
        if out and self._process is not None and buggify("disk.corrupt_read"):
            self._fs.disk(self.path).corrupt_reads += 1
            i = self._fs.rng.random_int(0, len(out))
            out = out[:i] + bytes([out[i] ^ 0xFF]) + out[i + 1:]
        return out

    def read_all(self) -> bytes:
        """Contents as a same-process reader sees them (pending ops applied)."""
        out = bytearray() if self._st.pending_truncate else bytearray(self._st.synced)
        for chunk in self._st.unsynced:
            out.extend(chunk)
        return bytes(out)

    def read_durable(self) -> bytes:
        """The crash-surviving contents: the synced prefix, ignoring any
        not-yet-applied truncate and unsynced appends."""
        return bytes(self._st.synced)

    def synced_size(self) -> int:
        return len(self._st.synced)

    def size(self) -> int:
        base = 0 if self._st.pending_truncate else len(self._st.synced)
        return base + sum(len(c) for c in self._st.unsynced)

    def _drop_unsynced(self) -> None:
        self._st.unsynced.clear()
        self._st.pending_truncate = False
        # the power-kill coherence rule: the file's contents just REGRESSED
        # to the synced prefix, so cached pages (which reflected the
        # buffered view) die with the process
        self._invalidate_cache()

    def close(self) -> None:
        self._closed = True
        self._fs._handles.get(self._process, set()).discard(self)


class SimFilesystem:
    """All simulated disks; survives cluster restarts (it IS the disks)."""

    # TaskPriority for disk completions mirrors the reference's DiskIOComplete

    def __init__(self, loop: EventLoop, rng: DeterministicRandom,
                 min_sync_latency: float = 0.0005,
                 max_sync_latency: float = 0.005) -> None:
        self.loop = loop
        self.rng = rng.split()
        self.min_sync_latency = min_sync_latency
        self.max_sync_latency = max_sync_latency
        self._files: dict[str, _FileState] = {}
        self._handles: dict[SimProcess, set[SimFile]] = {}
        self._disks: dict[str, DiskState] = {}
        # io_timeout fail-fast (knobs.IO_TIMEOUT_S, armed by the cluster
        # assembly): a sync stalled past this kills the owning process.
        # None = off, the unit-test-friendly default.
        self.io_timeout_s: float | None = None
        self.trace = None  # TraceCollector for IoTimeoutKilled events
        # shared file-level page cache (storage/pagecache.py PageCachePool),
        # armed by the cluster assembly from the PAGE_CACHE_* knobs.  None =
        # no cache, bit-identical raw-file behavior.  Lives on the
        # filesystem object only as the wiring point — cached pages belong
        # to a PROCESS lifetime, so every boot installs a FRESH pool.
        self.page_pool = None

    def reattach(self, loop: EventLoop, rng: DeterministicRandom) -> None:
        """Point at a new EventLoop/RNG (whole-cluster restart builds a new
        loop but the disks persist).  Disk SHAPE (capacity, degradation)
        persists — it is a property of the hardware — but stall windows
        are anchored to the old loop's clock and reset."""
        self.loop = loop
        self.rng = rng.split()
        self._handles.clear()
        self.trace = None
        # a reattach is a new process lifetime: cached pages die with the
        # old one (the booting cluster installs its own fresh pool)
        self.page_pool = None
        for d in self._disks.values():
            d.stall_until = 0.0

    # -- the resource-exhaustion fault plane --------------------------------
    def disk(self, path: str) -> DiskState:
        """The disk under `path` (created on first touch; one per file)."""
        d = self._disks.get(path)
        if d is None:
            d = self._disks[path] = DiskState()
        return d

    def set_capacity(self, path: str, capacity: int | None) -> None:
        """Bound the disk: appends past `capacity` bytes raise DiskFull
        (None removes the bound — the operator added space)."""
        self.disk(path).capacity = capacity

    def degrade(self, path: str, latency_mult: float) -> None:
        """Degraded mode: every fsync on this disk pays `latency_mult`
        times the seeded latency (1.0 restores full speed)."""
        self.disk(path).latency_mult = latency_mult

    def stall(self, path: str, seconds: float) -> None:
        """Stall the disk: fsyncs hang until now+`seconds` (a stall past
        `io_timeout_s` fail-fasts the process mid-sync)."""
        d = self.disk(path)
        d.stall_until = max(d.stall_until, self.loop.now() + seconds)

    def inject_errors(self, path: str, n: int) -> None:
        """The next `n` operations on this disk raise an injected IOError."""
        self.disk(path).error_budget += n

    def _maybe_injected_error(self, disk: DiskState, path: str,
                              armed: bool = True) -> None:
        """One shared encoding of transient injected faults, consulted by
        every write-path operation: a deterministic error budget
        (`inject_errors`) plus — for process-owned handles (`armed`) —
        the seed-armed `disk.error` / `disk.enospc` buggify sites, rate-
        limited per disk (see DiskState.buggify_fault_after) so chaos
        injects FAULTS, not sustained outages."""
        if disk.error_budget > 0:
            disk.error_budget -= 1
            disk.errors_injected += 1
            raise IOError(f"{path}: injected disk error")
        if not armed or self.loop.now() < disk.buggify_fault_after:
            return
        if buggify("disk.error"):
            disk.errors_injected += 1
            disk.buggify_fault_after = self.loop.now() + 2.0
            raise IOError(f"{path}: injected disk error (buggify)")
        if buggify("disk.enospc"):
            disk.enospc_errors += 1
            disk.buggify_fault_after = self.loop.now() + 2.0
            raise DiskFull(f"{path}: injected ENOSPC (buggify)")

    def usage_for(self, path: str) -> tuple[int, int | None]:
        """(bytes used, capacity|None) for the disk under `path`."""
        st = self._files.get(path)
        base = 0
        if st is not None:
            base = (0 if st.pending_truncate else len(st.synced)) + sum(
                len(c) for c in st.unsynced
            )
        return base, self.disk(path).capacity

    def disk_usage(self) -> dict[str, dict]:
        """Per-disk gauges for status(): bytes used vs capacity, the
        latency multiplier, and the fault counters — the operator's view
        of which disk is full, slow, stalling, or erroring."""
        out: dict[str, dict] = {}
        for path in sorted(set(self._files) | set(self._disks)):
            used, cap = self.usage_for(path)
            d = self.disk(path)
            out[path] = {
                "bytes_used": used,
                "capacity": cap,
                "latency_mult": d.latency_mult,
                "stalled": self.loop.now() < d.stall_until,
                "ops": d.ops,
                "reads": d.reads,
                "syncs": d.syncs,
                "stalls": d.stalls,
                "errors_injected": d.errors_injected,
                "enospc_errors": d.enospc_errors,
                "corrupt_reads": d.corrupt_reads,
                "sync_s": round(d.sync_s, 6),
            }
        return out

    def open(self, path: str, process: SimProcess) -> SimFile:
        state = self._files.setdefault(path, _FileState())
        f = SimFile(self, path, state, process)
        if process is not None:
            handles = self._handles.setdefault(process, set())
            if not handles:
                # first open by this process: arm the kill hook
                from ..runtime.core import Promise

                p = Promise()

                def on_death(_f) -> None:
                    for h in self._handles.pop(process, set()):
                        h._drop_unsynced()

                p.future.add_done_callback(on_death)
                process.on_death.append(p)
            handles.add(f)
        return f

    def durable_items(self):
        """(path, crash-surviving bytes) for every file — the synced prefix
        only (`SimFile.read_durable` semantics): what a restart image saves
        after a power-kill has dropped the un-fsynced buffers."""
        for path in sorted(self._files):
            yield path, bytes(self._files[path].synced)

    @classmethod
    def from_durable_items(cls, items) -> "SimFilesystem":
        """The restore twin of `durable_items`: a fresh filesystem whose
        disks hold exactly `items` ({path: bytes} or (path, bytes) pairs)
        as durable contents — synced prefixes only, nothing buffered.
        Built on a throwaway loop/rng; RecoverableCluster(fs=...,
        restart=True) reattaches it to the booting cluster's."""
        from ..runtime.core import DeterministicRandom, EventLoop

        pairs = items.items() if hasattr(items, "items") else items
        fs = cls(EventLoop(), DeterministicRandom(0))
        for path, data in pairs:
            st = _FileState()
            st.synced = bytearray(data)
            fs._files[path] = st
        return fs

    def flush_buffers(self) -> None:
        """Apply every file's buffered state to its durable contents — the
        ORDERLY-shutdown flush (sync-everything-then-halt), the exact
        opposite of a power-kill.  Exists so the negative crash-durability
        test can prove the kill path is unclean: data that survives a
        clean shutdown must NOT survive the kill."""
        for st in self._files.values():
            st.apply_buffers()

    def exists(self, path: str) -> bool:
        return path in self._files

    def delete(self, path: str) -> None:
        self._files.pop(path, None)
        if self.page_pool is not None:
            self.page_pool.invalidate_file(path)

    def list(self, prefix: str = "") -> list[str]:
        return sorted(p for p in self._files if p.startswith(prefix))
