"""The device supervisor's tunables: the DEVICE_* family of the reference
package's `CoreKnobs` (runtime/knobs.py there, the flow/Knobs.h analog),
with the same defaults.

`DeviceSupervisor(knobs=...)` reads only these five attributes, so any
object that has them will do: a reference cluster passes its own
`CoreKnobs`, randomized under simulation.  The reference's other knob
families, `ClientKnobs` and `set_knob` come with the host stack that reads
them, which is not ported yet."""

from __future__ import annotations


class DeviceKnobs:
    """The DEFAULT_BACKOFF family applied to the hardware conflict backend
    (conflict/supervisor.py).  Every device interaction is bounded by
    DEVICE_WATCHDOG_S (wall-clock watchdog on the real network; under sim
    the hang is injected virtually); failed attempts retry with exponential
    backoff (DEVICE_RETRY_BACKOFF doubling to DEVICE_MAX_BACKOFF), and
    after DEVICE_RETRY_LIMIT consecutive failures the circuit breaker trips
    to the CPU reference backend; re-probes then run every
    DEVICE_REPROBE_INTERVAL seconds until a parity-checked promotion
    succeeds."""

    DEVICE_WATCHDOG_S = 30.0
    DEVICE_RETRY_LIMIT = 3
    DEVICE_RETRY_BACKOFF = 0.05
    DEVICE_MAX_BACKOFF = 5.0
    DEVICE_REPROBE_INTERVAL = 5.0
