"""The port's DeviceSupervisor (foundationdb_tpu_torch/conflict/
supervisor.py) on the CPU: each test of tests/test_supervisor.py against
the port's supervisor over the port's DeviceConflictSet(device="cpu"),
the same seeded stream with the same forced faults through the reference's
supervisor and the port's (identical verdicts, health and coverage
census), classify_failure on the reference's texts and on the texts of
the port's own stack, and a device that keeps failing with a sticky CUDA
error.

The invariant every test here defends: across the degrade → serve-degraded
→ re-promote cycle, the verdict stream is bit-identical to a plain CPU
oracle fed the same batches."""

import random

import pytest
import torch

from foundationdb_tpu.conflict import supervisor as jsup
from foundationdb_tpu.conflict.api import TxInfo as JTxInfo
from foundationdb_tpu.conflict.device import DeviceConflictSet as JDeviceConflictSet
from foundationdb_tpu.runtime import buggify as jbuggify
from foundationdb_tpu.runtime import coverage as jcoverage
from foundationdb_tpu.runtime.core import DeterministicRandom as JRandom
from foundationdb_tpu_torch.conflict import _build, kernels
from foundationdb_tpu_torch.conflict import device as tdev
from foundationdb_tpu_torch.conflict.api import TxInfo, Verdict, validate_verdicts
from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
from foundationdb_tpu_torch.conflict.supervisor import (
    DeviceHang,
    DeviceLost,
    DeviceSupervisor,
    Watchdog,
    classify_failure,
)
from foundationdb_tpu_torch.runtime import buggify, coverage
from foundationdb_tpu_torch.runtime.core import DeterministicRandom


@pytest.fixture(autouse=True)
def _port_census_isolation():
    """The port's coverage counters and buggify state are process-global
    too (tests/conftest.py isolates only the reference's): every test
    starts with an empty census and a disabled buggify."""
    cov = coverage.snapshot()
    coverage.reset()
    buggify.disable()
    yield
    buggify.disable()
    coverage.restore(cov)


class FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _raw_stream(seed: int, n: int, alphabet: bytes = b"abcd"):
    """Version-chained random batches as (version, [(snapshot, reads,
    writes)]) — tests/test_supervisor.py's generator, before the TxInfo
    of either package is built."""
    rng = random.Random(seed)

    def rkey():
        return bytes(rng.choice(alphabet) for _ in range(rng.randrange(1, 5)))

    def rrange():
        a, b = sorted((rkey(), rkey()))
        return a, b + b"\x00"

    v = 0
    out = []
    for _ in range(n):
        v += rng.randrange(1, 4)
        out.append((
            v,
            [
                (
                    rng.randrange(max(v - 5, 0), v),
                    [rrange() for _ in range(rng.randrange(3))],
                    [rrange() for _ in range(rng.randrange(3))],
                )
                for _ in range(rng.randrange(1, 5))
            ],
        ))
    return out


def _batch_stream(seed: int, n: int, tx=TxInfo):
    return [(v, [tx(*t) for t in txns]) for v, txns in _raw_stream(seed, n)]


def _device(oldest=0):
    return tdev.DeviceConflictSet(oldest, capacity=1 << 10, device="cpu")


def _mk(clock, **kw):
    return DeviceSupervisor(_device, clock=clock, **kw)


def _force_sites():
    """Arm buggify so only force()d sites fire (deterministic injection)."""
    buggify.enable(DeterministicRandom(1), enable_prob=0.0)


# ---------------------------------------------------------------------------
# unit pieces

def test_classify_failure_vocabulary():
    assert classify_failure(DeviceHang("x")) == "hang"
    assert classify_failure(DeviceLost("x")) == "lost"
    assert classify_failure(TimeoutError()) == "hang"
    assert classify_failure(RuntimeError("UNAVAILABLE: connection reset by peer")) == "lost"
    assert classify_failure(RuntimeError("Unable to initialize backend 'tpu'")) == "no_device"
    assert classify_failure(RuntimeError("Mosaic compilation failed")) == "compile_fail"
    assert classify_failure(RuntimeError("wat")) == "error"


@pytest.mark.parametrize("text", [
    "UNAVAILABLE: connection reset by peer",
    "Unable to initialize backend 'tpu'",
    "Mosaic compilation failed",
    "wat",
    "RESOURCE_EXHAUSTED: Out of memory while trying to allocate 1.00GiB",
    "INTERNAL: device lost",
    "DEADLINE_EXCEEDED: socket closed",
])
def test_classify_failure_agrees_with_the_reference(text):
    """The reference's vocabulary is kept: its texts get the same class in
    both packages."""
    err = RuntimeError(text)
    assert classify_failure(err) == jsup.classify_failure(err)


_TORCH_STICKY = (
    "CUDA error: {}\nCUDA kernel errors might be asynchronously reported at "
    "some other API call, so the stacktrace below might be incorrect.\nFor "
    "debugging consider passing CUDA_LAUNCH_BLOCKING=1\nCompile with "
    "`TORCH_USE_CUDA_DSA` to enable device-side assertions.\n"
)
_TORCH_OOM = (
    "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
    "capacity of 79.19 GiB of which 1.06 GiB is free. Including non-PyTorch "
    "memory, this process has 78.12 GiB memory in use. If reserved but "
    "unallocated memory is large try setting "
    "PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True to avoid "
    "fragmentation.  See documentation for Memory Management  "
    "(https://pytorch.org/docs/stable/notes/cuda.html#environment-variables)"
)


@pytest.mark.parametrize("text, cls", [
    ("No CUDA GPUs are available", "no_device"),
    ("Found no NVIDIA driver on your system.", "no_device"),
    ("fdb_probe_fused launch failed: cuda error 100 (no CUDA-capable device "
     "is detected)", "no_device"),
    ("fdb_probe_fused launch failed: cuda error 209 (no kernel image is "
     "available for execution on the device)", "compile_fail"),
    ("fdb_probe_fused launch failed: cuda error 700 (an illegal memory "
     "access was encountered)", "lost"),
    ("fdb_intra_fixpoint launch failed: cuda error 719 (unspecified launch "
     "failure)", "lost"),
    ("fdb_compact_ranks launch failed: cuda error 710 (device-side assert "
     "triggered)", "lost"),
    (_TORCH_STICKY.format("an illegal memory access was encountered"), "lost"),
    (_TORCH_STICKY.format("unspecified launch failure"), "lost"),
    (_TORCH_STICKY.format("device-side assert triggered"), "lost"),
    ("fdb_run_to_step launch failed: cuda error 2 (out of memory)", "error"),
    (_TORCH_OOM, "error"),
])
def test_classify_failure_cuda_texts(text, cls):
    assert classify_failure(RuntimeError(text)) == cls


def test_classify_failure_the_ports_own_raises(monkeypatch, tmp_path):
    """The texts the port itself raises, raised by the code that raises
    them: no card (device.resolve_device), no nvcc and a failed nvcc run
    (conflict/_build.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as no_card:
        tdev.resolve_device("cuda")
    assert classify_failure(no_card.value) == "no_device"

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", str(tmp_path / "absent"))
    with pytest.raises(RuntimeError) as no_nvcc:
        _build.build()
    assert classify_failure(no_nvcc.value) == "compile_fail"

    monkeypatch.setattr(_build, "_nvcc", lambda: "false")  # exits 1
    with pytest.raises(RuntimeError) as failed:
        _build.build()
    assert "nvcc failed" in str(failed.value)
    assert classify_failure(failed.value) == "compile_fail"


def test_classify_failure_kernel_launch_text(monkeypatch):
    """The kernel wrappers' launch failure, as `kernels._launch` raises it
    for an error code the CUDA runtime names."""
    class _Lib:
        @staticmethod
        def fdb_probe(*_args):
            return 700

        @staticmethod
        def fdb_cuda_error_string(_err):
            return b"an illegal memory access was encountered"

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "load", lambda: _Lib)
    monkeypatch.setattr(kernels, "_entries", {})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda _dev: _Stream)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError) as launch:
        kernels._launch("fdb_probe", torch.device("cuda", 0))
    assert "launch failed: cuda error 700" in str(launch.value)
    assert classify_failure(launch.value) == "lost"


def test_validate_verdicts_rejects_garbage():
    validate_verdicts([Verdict.COMMITTED, 0, 1], 3)
    with pytest.raises(ValueError, match="verdict"):
        validate_verdicts([7], 1)
    with pytest.raises(ValueError, match="verdict"):
        validate_verdicts([0, 1], 3)


def test_watchdog_wall_mode_bounds_a_hang():
    import time as _time

    wd = Watchdog(0.1, wall=True)
    assert wd.run(lambda: 42) == 42
    with pytest.raises(DeviceHang):
        wd.run(lambda: _time.sleep(5))
    # the executor was replaced: the next call is not queued behind the hang
    assert wd.run(lambda: 43) == 43
    wd.close()


# ---------------------------------------------------------------------------
# degrade -> serve-degraded -> re-promote, sync path

def test_degrade_and_repromote_parity_sync():
    """Trip the breaker mid-stream; every verdict (device, degraded-CPU,
    parity batch, post-promotion device) must match the oracle referee."""
    clock = FakeClock()
    sup = _mk(clock)
    ref = OracleConflictSet(0)
    _force_sites()
    states = []
    for i, (v, txns) in enumerate(_batch_stream(3, 50)):
        if i == 10:
            buggify.force("device.lost", int(sup.retry_limit))  # trip exactly
        clock.advance(0.7)
        assert sup.resolve_batch(v, txns) == ref.resolve_batch(v, txns), (i, v)
        if v > 8:
            sup.remove_before(v - 8)
            ref.remove_before(v - 8)
        states.append(sup.health()["state"])
    h = sup.health()
    assert "degraded" in states, "breaker never tripped"
    assert h["state"] == "healthy", h
    assert h["trips"] == 1 and h["promotions"] >= 1
    assert h["time_degraded_s"] > 0
    assert coverage.hits("device.degraded") == 1
    assert coverage.hits("device.promoted") >= 1
    assert coverage.hits("device.cpu_rebuild") >= 1
    sup.close()


def test_single_failure_retries_with_backoff_before_tripping():
    """One failure quarantines the device (served from CPU) but does not
    trip the breaker; the retry rebuild waits out the exponential backoff."""
    clock = FakeClock()
    sup = _mk(clock)
    ref = OracleConflictSet(0)
    _force_sites()
    stream = _batch_stream(5, 12)
    v0, t0 = stream[0]
    assert sup.resolve_batch(v0, t0) == ref.resolve_batch(v0, t0)
    buggify.force("device.lost", 1)
    v1, t1 = stream[1]
    assert sup.resolve_batch(v1, t1) == ref.resolve_batch(v1, t1)
    h = sup.health()
    assert h["state"] == "healthy" and h["serving"] == "cpu"
    assert h["consecutive_failures"] == 1 and h["trips"] == 0
    # inside the backoff window: still CPU, no probe attempted
    v2, t2 = stream[2]
    assert sup.resolve_batch(v2, t2) == ref.resolve_batch(v2, t2)
    assert sup.health()["serving"] == "cpu"
    # past the backoff: probe + parity batch re-promotes (the startup
    # promotion was #1 — device construction is lazy, first batch promotes)
    clock.advance(sup.max_backoff + 0.1)
    v3, t3 = stream[3]
    assert sup.resolve_batch(v3, t3) == ref.resolve_batch(v3, t3)
    assert sup.health()["serving"] == "device"
    assert sup.health()["promotions"] == 2
    sup.close()


def test_readback_corrupt_is_detected_and_served_from_cpu():
    """Garbage verdict codes from the device must be caught by validation
    (classified readback_corrupt) and the batch answered by the CPU."""
    clock = FakeClock()
    sup = _mk(clock)
    ref = OracleConflictSet(0)
    _force_sites()
    for i, (v, txns) in enumerate(_batch_stream(9, 8)):
        if i == 3:
            buggify.force("device.readback_corrupt", 1)
        assert sup.resolve_batch(v, txns) == ref.resolve_batch(v, txns), i
    assert coverage.hits("device.fail.readback_corrupt") == 1
    assert "readback_corrupt" in sup.health()["last_failure"]
    sup.close()


def test_repromotion_replays_state_bit_identically():
    """The record replay (_replay_record) must reconstruct the committed
    step function EXACTLY: replaying into a fresh oracle reproduces the
    live referee's boundary keys and versions bit-for-bit, and the first
    post-promotion batch passes the kernel parity check."""
    clock = FakeClock()
    sup = _mk(clock)
    ref = OracleConflictSet(0)
    _force_sites()
    stream = _batch_stream(11, 30)
    for i, (v, txns) in enumerate(stream[:20]):
        if i == 8:
            buggify.force("device.lost", int(sup.retry_limit))
        clock.advance(0.9)
        assert sup.resolve_batch(v, txns) == ref.resolve_batch(v, txns)
        if v > 10:
            sup.remove_before(v - 10)
            ref.remove_before(v - 10)
    # direct bit-identity of the record replay vs the live referee
    rebuilt = OracleConflictSet(0)
    sup._replay_record(rebuilt)
    if sup.oldest_version > rebuilt.oldest_version:
        rebuilt.remove_before(sup.oldest_version)
    assert rebuilt._history._keys == ref._history._keys
    assert rebuilt._history._vals == ref._history._vals
    # the promotion itself: first promoted batch is parity-checked
    clock.advance(sup.reprobe_interval + 1)
    for v, txns in stream[20:]:
        assert sup.resolve_batch(v, txns) == ref.resolve_batch(v, txns)
    assert sup.health()["state"] == "healthy"
    assert coverage.hits("device.promoted") >= 1
    sup.close()


# ---------------------------------------------------------------------------
# device loss mid-pipeline (deferred window)

@pytest.mark.parametrize("site", [
    "device.lost", "device.dispatch_hang", "device.compile_fail",
    "device.readback_corrupt",
])
def test_deferred_window_survives_device_loss(site):
    """Kill the device while a deferred window is open: the supervisor must
    replay the window through the CPU fallback and keep every verdict equal
    to the oracle's — including batches whose handles were already waited."""
    clock = FakeClock()
    sup = _mk(clock)
    ref = OracleConflictSet(0)
    _force_sites()
    handles = []
    for i, (v, txns) in enumerate(_batch_stream(21 + len(site), 36)):
        if i == 14:
            buggify.force(site, 1)
        clock.advance(0.8)
        handles.append((sup.resolve_deferred(v, txns), ref.resolve_batch(v, txns), v))
        if len(handles) >= 3:  # keep a 2-deep window open
            h, want, hv = handles.pop(0)
            assert h.wait() == want, (i, hv)
        if v > 9:
            sup.remove_before(v - 9)
            ref.remove_before(v - 9)
    for h, want, hv in handles:
        assert h.wait() == want, hv
    assert coverage.hits(f"buggify.{site}") >= 1, "site never fired"
    assert sup.health()["state"] in ("healthy", "degraded")
    sup.close()


def test_mid_window_gc_replay_order():
    """remove_before while a window is open must replay at each batch's
    dispatch-time floor: a batch dispatched BEFORE a GC must not see the
    raised floor when the window is recovered on the CPU."""
    clock = FakeClock()
    sup = _mk(clock)
    ref = OracleConflictSet(0)
    _force_sites()
    # batch 1 writes k; batch 2 reads k at a snapshot below the coming GC
    h1 = sup.resolve_deferred(10, [TxInfo(5, [], [(b"k", b"k\x00")])])
    ref.resolve_batch(10, [TxInfo(5, [], [(b"k", b"k\x00")])])
    probe = [TxInfo(8, [(b"k", b"k\x00")], [])]
    h2 = sup.resolve_deferred(12, list(probe))
    want2 = ref.resolve_batch(12, list(probe))
    # GC past the probe's snapshot AFTER batch 2 dispatched, then lose the
    # device before anything was waited
    sup.remove_before(11)
    ref.remove_before(11)
    buggify.force("device.lost", 1)
    h3 = sup.resolve_deferred(14, [TxInfo(13, [], [(b"z", b"z\x00")])])
    want3 = ref.resolve_batch(14, [TxInfo(13, [], [(b"z", b"z\x00")])])
    assert h2.wait() == want2 == [Verdict.CONFLICT]  # floor at dispatch was 0
    assert h1.wait() == [Verdict.COMMITTED]
    assert h3.wait() == want3
    assert coverage.hits("device.window_recover") >= 1
    sup.close()


# ---------------------------------------------------------------------------
# operator surface

def test_force_degrade_and_force_promote():
    clock = FakeClock()
    sup = _mk(clock)
    ref = OracleConflictSet(0)
    stream = _batch_stream(31, 10)
    v0, t0 = stream[0]
    assert sup.resolve_batch(v0, t0) == ref.resolve_batch(v0, t0)
    sup.force_degrade()
    assert sup.health()["state"] == "degraded"
    v1, t1 = stream[1]
    assert sup.resolve_batch(v1, t1) == ref.resolve_batch(v1, t1)
    # forced: a passing clock does NOT auto-promote
    clock.advance(sup.reprobe_interval * 3)
    v2, t2 = stream[2]
    assert sup.resolve_batch(v2, t2) == ref.resolve_batch(v2, t2)
    assert sup.health()["serving"] == "cpu"
    sup.force_promote()
    v3, t3 = stream[3]
    assert sup.resolve_batch(v3, t3) == ref.resolve_batch(v3, t3)
    assert sup.health()["state"] == "healthy"
    assert sup.health()["serving"] == "device"
    sup.close()


def test_lazy_construction_and_empty_batch_parity():
    """Device construction is lazy (nothing touches the device until the
    owner could arm the wall watchdog), and the promotion parity check is
    NOT satisfied by an empty batch — it stays armed until the first batch
    that actually has transactions."""
    clock = FakeClock()
    sup = _mk(clock)
    assert sup._dev is None, "constructor must not touch the device"
    ref = OracleConflictSet(0)
    # empty batches only: probed, but never promoted (nothing verified)
    assert sup.resolve_batch(2, []) == ref.resolve_batch(2, []) == []
    assert sup.resolve_batch(3, []) == ref.resolve_batch(3, []) == []
    h = sup.health()
    assert h["probes"] >= 1 and h["promotions"] == 0, h
    assert h["serving"] == "cpu"
    # the first real batch completes the parity check and promotes
    txns = [TxInfo(3, [(b"a", b"b")], [(b"a", b"b")])]
    assert sup.resolve_batch(5, list(txns)) == ref.resolve_batch(5, list(txns))
    assert sup.health()["promotions"] == 1
    assert sup.health()["serving"] == "device"
    sup.close()


def test_force_degrade_at_boot():
    """The reference's FDBTPU_FORCE_DEGRADE=1 switch, which the port leaves
    to the operator's force_degrade() before the first batch: the set
    serves degraded and never auto-promotes."""
    clock = FakeClock()
    sup = _mk(clock)
    sup.force_degrade()
    assert sup.health()["state"] == "degraded"
    assert sup.health()["serving"] == "cpu"
    ref = OracleConflictSet(0)
    for v, txns in _batch_stream(41, 6):
        clock.advance(sup.reprobe_interval + 1)  # must still not promote
        assert sup.resolve_batch(v, txns) == ref.resolve_batch(v, txns)
    assert sup.health()["serving"] == "cpu"
    assert sup._dev is None, "a forced degrade never built the device"
    sup.close()


def test_failmon_feed_and_transitions():
    from foundationdb_tpu.rpc.failmon import FailureMonitor

    clock = FakeClock()
    fm = FailureMonitor(clock)
    sup = _mk(clock)
    sup.bind_failmon(fm, "resolver0.device")
    assert fm.device_report()["resolver0.device"]["state"] == "healthy"
    assert fm.degraded_devices() == []
    t0 = fm.device_transitions
    sup.force_degrade()
    rep = fm.device_report()["resolver0.device"]
    assert rep["state"] == "degraded" and rep["trips"] == 1
    assert fm.degraded_devices() == ["resolver0.device"]
    assert fm.device_transitions > t0
    # a FAILED re-probe must not leave the monitor frozen at "probing"
    _force_sites()
    buggify.force("device.lost", 1)
    sup.force_promote()  # probe fires and dies on the forced loss
    assert fm.device_report()["resolver0.device"]["state"] == "degraded"
    assert fm.degraded_devices() == ["resolver0.device"]
    sup.close()


def test_kernel_stats_and_node_count_survive_degrade():
    clock = FakeClock()
    sup = _mk(clock)
    ref = OracleConflictSet(0)
    for v, txns in _batch_stream(51, 4):
        assert sup.resolve_batch(v, txns) == ref.resolve_batch(v, txns)
    snap = sup.kernel_stats()
    assert snap["supervisor"]["state"] == "healthy"
    assert snap["backend"] == "cpu"  # the port's device set, on the CPU
    sup.force_degrade()
    snap = sup.kernel_stats()
    assert snap["supervisor"]["state"] == "degraded"
    assert snap["backend"] == "oracle"  # the active (fallback) backend's stats
    assert sup.node_count >= 0
    sup.close()


def test_resolver_enables_wall_watchdog_on_real_network():
    """On the REAL network the reference's Resolver must arm the port
    supervisor's wall-clock watchdog (it finds the supervisor by its
    methods); the sim resolver must NOT arm it."""
    from foundationdb_tpu.cluster import SimCluster
    from foundationdb_tpu.roles.resolver import Resolver
    from foundationdb_tpu.rpc.transport import RealNetwork
    from foundationdb_tpu.runtime.core import EventLoop
    from foundationdb_tpu.runtime.knobs import CoreKnobs

    loop = EventLoop()
    net = RealNetwork(loop, name="real-resolver")
    sup = _mk(FakeClock())
    r = Resolver(net.process, loop, CoreKnobs(), sup)
    assert sup._watchdog.wall, "real-network resolver left the watchdog inert"
    r.stop()
    net.close()

    c = SimCluster(seed=17)
    sup2 = _mk(FakeClock())
    p = c.net.create_process("resolver-simwd")
    r2 = Resolver(p, c.loop, c.knobs, sup2)
    assert not sup2._watchdog.wall
    r2.stop()
    c.stop()


def test_cluster_status_reports_device_health():
    """cluster_status of the reference SimCluster over the port's
    supervised set: kernel.device roll-up + a degraded-mode message, and
    the schema still validates."""
    from foundationdb_tpu.cluster import SimCluster
    from foundationdb_tpu.control.status import cluster_status, validate_status

    c = SimCluster(seed=91, conflict_backend=lambda: DeviceSupervisor(_device))
    db = c.database()

    async def commit_one():
        tr = db.create_transaction()
        tr.set(b"k", b"v")
        await tr.commit()

    c.run_until(c.loop.spawn(commit_one()), 60.0)
    doc = cluster_status(c)
    validate_status(doc)
    dev = doc["kernel"]["device"]
    assert dev["states"]["healthy"] == len(c.resolvers)
    assert dev["trips"] == 0
    assert not any(
        m["name"] == "device_backend_degraded" for m in doc["cluster"]["messages"]
    )
    c.resolvers[0].cs.force_degrade()
    doc = cluster_status(c)
    validate_status(doc)
    assert doc["kernel"]["device"]["states"]["degraded"] == 1
    assert doc["kernel"]["device"]["serving_cpu"] == 1
    assert any(
        m["name"] == "device_backend_degraded" for m in doc["cluster"]["messages"]
    )
    c.stop()


# ---------------------------------------------------------------------------
# the reference's supervisor and the port's on one seeded stream

FORCED = {6: ("device.lost", 3), 19: ("device.readback_corrupt", 1),
          27: ("device.dispatch_hang", 1), 33: ("device.compile_fail", 2)}


def _drive_supervisor(sup, mod, rng_cls, tx, clock, mode: str, seed: int):
    """One seeded stream through `sup`, whose faults come from the buggify
    module `mod`: sites armed at random (enable_prob 0.5, fire_prob 0.05)
    from `seed`, and FORCED's sites forced at their batch.  Returns the
    verdicts as ints, batch by batch."""
    mod.enable(rng_cls(seed), enable_prob=0.5, fire_prob=0.05)
    out, pending = [], []
    for i, (v, txns) in enumerate(_batch_stream(seed, 48, tx)):
        if i in FORCED:
            mod.force(*FORCED[i])
        clock.advance(0.6)
        if mode == "sync":
            out.append([int(x) for x in sup.resolve_batch(v, txns)])
        else:
            pending.append(sup.resolve_deferred(v, txns))
            if len(pending) > 2:
                out.append([int(x) for x in pending.pop(0).wait()])
        if v > 7:
            sup.remove_before(v - 7)
    out += [[int(x) for x in h.wait()] for h in pending]
    return out


@pytest.mark.parametrize("mode", ["sync", "deferred"])
def test_same_seed_parity_with_the_reference(mode):
    """The same seeded stream with the same forced (and randomly armed)
    faults through the reference's supervisor (over its JAX set, its
    buggify and coverage) and through the port's (over the port's CPU set,
    the port's buggify and coverage): identical verdicts, health and
    coverage census."""
    seed = 77
    jclock, tclock = FakeClock(), FakeClock()
    jref = jsup.DeviceSupervisor(
        lambda o=0: JDeviceConflictSet(o, capacity=1 << 10), clock=jclock)
    port = _mk(tclock)
    jbase = jcoverage.snapshot()
    try:
        want = _drive_supervisor(jref, jbuggify, JRandom, JTxInfo, jclock, mode, seed)
        jcensus = jcoverage.census(jbase)
        jarmed = jbuggify.census()
    finally:
        jbuggify.disable()
    got = _drive_supervisor(port, buggify, DeterministicRandom, TxInfo, tclock,
                            mode, seed)
    assert got == want
    oracle = OracleConflictSet(0)
    for (v, txns), verdicts in zip(_batch_stream(seed, 48), got):
        assert [int(x) for x in oracle.resolve_batch(v, txns)] == verdicts, v
        if v > 7:
            oracle.remove_before(v - 7)
    assert port.health() == jref.health()
    h = port.health()
    assert h["trips"] >= 1 and h["promotions"] >= 2, h
    assert buggify.census() == jarmed
    assert coverage.census() == jcensus
    assert coverage.hits("device.degraded") >= 1
    port.close()
    jref.close()


# ---------------------------------------------------------------------------
# a sticky CUDA error

_STICKY = _TORCH_STICKY.format("an illegal memory access was encountered")


class _StickyDevice:
    """A device set whose context took a sticky error: every call fails
    with torch's text, as every CUDA call of such a process does."""

    oldest_version = 0

    def _fail(self, *_args, **_kw):
        raise RuntimeError(_STICKY)

    resolve_batch = resolve_deferred = remove_before = healthcheck = _fail

    def close(self) -> None:
        pass


def test_sticky_cuda_error_stays_degraded_with_correct_verdicts():
    """After a sticky CUDA error every call of the device and every fresh
    device fails: each failure classifies `lost`, the breaker trips once,
    every re-probe fails again, and the set stays degraded on the CPU
    reference (the native skip list) with the oracle's verdicts.  No state
    beyond the reference's supervisor is needed."""
    from foundationdb_tpu_torch.conflict.native import NativeConflictSet

    sticky = {"on": False}

    def factory(oldest=0):
        if sticky["on"]:
            raise RuntimeError(_STICKY)
        return _device(oldest)

    clock = FakeClock()
    sup = DeviceSupervisor(factory, fallback_factory=NativeConflictSet, clock=clock)
    ref = OracleConflictSet(0)
    for i, (v, txns) in enumerate(_batch_stream(13, 40)):
        if i == 6:
            sticky["on"] = True
            sup._dev = _StickyDevice()  # the live set's context dies
        clock.advance(sup.reprobe_interval / 3)
        assert sup.resolve_batch(v, txns) == ref.resolve_batch(v, txns), (i, v)
        if v > 8:
            sup.remove_before(v - 8)
            ref.remove_before(v - 8)
    h = sup.health()
    assert h["state"] == "degraded" and h["serving"] == "cpu", h
    assert h["trips"] == 1 and h["promotions"] == 1, h
    assert h["last_failure"] == "probe:lost", h
    assert h["probes"] >= 5, h  # it kept re-probing, and every probe failed
    # the dispatch that met the error, then every probe but the first
    assert coverage.hits("device.fail.lost") == h["probes"]
    assert coverage.hits("device.fail.compile_fail") == 0
    assert sup.kernel_stats()["backend"] == "native"
    sup.close()
