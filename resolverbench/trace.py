"""The reduction of a profiler trace to the numbers the per-layer metrics
read: launches and synchronisations the host asked for, device time by
kind (host-to-device copies, the program's hand-written kernels, torch's
own kernels), the device's busy time as the union of its intervals (so
work that overlaps on two streams counts once), and the idle gaps named by
what the host was doing in them.

The input is the Chrome trace that torch.profiler exports: a list of
complete events ("ph": "X") with a category, a name, a start and a
duration in microseconds.  The harness wraps each step of its loop in a
`record_function` span named "rb.<step>"; those spans bound the traced
window and name the gaps.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from pathlib import Path

import numpy as np

SPAN_PREFIX = "rb."
# host-side calls that enqueue a kernel: the CUDA runtime's launches, with the
# cluster (Ex) and cooperative forms the hand kernels use, and the CUDA driver API's
_LAUNCH = re.compile(r"^(cudaLaunch(Kernel|KernelExC?|CooperativeKernel)|cuLaunch"
                     r"(Kernel|KernelEx|CooperativeKernel))(_v\d+)?$")
_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"(?:void\s+)?([A-Za-z_]\w*)\s*\(")
_KERNEL_CATS = {"kernel"}
_COPY_CATS = {"gpu_memcpy", "memcpy"}
_SET_CATS = {"gpu_memset", "memset"}
_RUNTIME_CATS = {"cuda_runtime", "runtime", "cuda_driver"}
_HOST_CATS = _RUNTIME_CATS | {"cpu_op", "operator"}
TOP = 10


def hand_symbols(package_dir: Path) -> list[str]:
    """The names of the program's hand-written CUDA kernels: every
    `__global__` function of its csrc/*.cu sources."""
    names: set[str] = set()
    for src in sorted((Path(package_dir) / "csrc").glob("*.cu")):
        names.update(_GLOBAL.findall(src.read_text()))
    return sorted(names)


def is_launch(name: str) -> bool:
    return bool(_LAUNCH.match(name))


def is_sync(name: str) -> bool:
    return "Synchronize" in name


def union(intervals: np.ndarray) -> np.ndarray:
    """The union of [start, end) intervals [n, 2] as sorted disjoint
    intervals."""
    if len(intervals) == 0:
        return np.zeros((0, 2))
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > reach[:-1]
    starts = iv[new, 0]
    last = np.flatnonzero(np.r_[new[1:], True])
    return np.stack([starts, reach[last]], axis=1)


def clip(intervals: np.ndarray, lo: float, hi: float) -> np.ndarray:
    out = np.clip(intervals, lo, hi)
    return out[out[:, 1] > out[:, 0]]


def gaps(merged: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """The stretches of [lo, hi) that sorted disjoint intervals leave."""
    edges = np.concatenate([[lo], merged.ravel(), [hi]]).reshape(-1, 2)
    return edges[edges[:, 1] > edges[:, 0]]


def load_events(path: Path) -> list[dict]:
    doc = json.loads(Path(path).read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _short(name: str) -> str:
    return name[:160]


class _Innermost:
    """The innermost host event that contains a moment."""

    def __init__(self, events: list[dict]) -> None:
        events = sorted(events, key=lambda e: e["ts"])
        self.start = np.array([e["ts"] for e in events], dtype=np.float64)
        self.end = np.array([e["ts"] + e["dur"] for e in events], dtype=np.float64)
        self.name = [e["name"] for e in events]
        self.reach = (np.maximum.accumulate(self.end) if len(events)
                      else np.zeros(0))

    def at(self, t: float) -> str | None:
        i = int(np.searchsorted(self.start, t, side="right")) - 1
        while i >= 0 and self.reach[i] > t:
            if self.end[i] > t:
                return self.name[i]
            i -= 1
        return None


def summarize(events: list[dict], hand: list[str]) -> dict | None:
    """Per-kind totals of a traced window (seconds, counts), its busy time,
    and the breakdown: the device operations that took the most time and
    the idle gaps summed by what the host was doing.  None when the trace
    holds no harness span or no device event."""
    spans = [e for e in events if e.get("cat", "").lower() == "user_annotation"
             and e["name"].startswith(SPAN_PREFIX)]
    device = [e for e in events
              if e.get("cat", "").lower() in _KERNEL_CATS | _COPY_CATS | _SET_CATS]
    if not spans or not device:
        return None
    lo = min(e["ts"] for e in spans)
    hi = max(e["ts"] + e["dur"] for e in spans)
    hand_re = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(map(re.escape, hand)) +
                         r")(?![A-Za-z0-9_])") if hand else None
    kernel_s = defaultdict(float)
    h2d = hand_s = torch_s = 0.0
    for e in device:
        cat, dur = e["cat"].lower(), e["dur"] * 1e-6
        kernel_s[_short(e["name"])] += dur
        if cat in _COPY_CATS and "HtoD" in e["name"]:
            h2d += dur
        elif cat in _KERNEL_CATS:
            if hand_re is not None and hand_re.search(e["name"]):
                hand_s += dur
            else:
                torch_s += dur
    iv = np.array([[e["ts"], e["ts"] + e["dur"]] for e in device], dtype=np.float64)
    merged = union(clip(iv, lo, hi))
    busy = float((merged[:, 1] - merged[:, 0]).sum()) * 1e-6
    host = [e for e in events if e.get("cat", "").lower() in _HOST_CATS]
    launches = sum(1 for e in host if is_launch(e["name"]))
    syncs = sum(1 for e in host if e.get("cat", "").lower() in _RUNTIME_CATS
                and is_sync(e["name"]))
    span_at, op_at = _Innermost(spans), _Innermost(host)
    # each gap cut where a span or a host event starts or ends, and each
    # piece named by the innermost ones around it
    cuts = np.unique(np.concatenate([span_at.start, span_at.end, op_at.start, op_at.end]))
    idle = defaultdict(float)
    for a, b in gaps(merged, lo, hi):
        inner = cuts[np.searchsorted(cuts, a, "right"):np.searchsorted(cuts, b, "left")]
        edges = np.concatenate([[a], inner, [b]])
        for p, q in zip(edges[:-1].tolist(), edges[1:].tolist()):
            mid = 0.5 * (p + q)
            label = span_at.at(mid) or "between steps"
            op = op_at.at(mid)
            idle[f"{label}: {_short(op)}" if op else label] += (q - p) * 1e-6
    return dict(
        window_s=(hi - lo) * 1e-6, busy_s=busy, launches=launches, syncs=syncs,
        h2d_s=h2d, hand_s=hand_s, torch_s=torch_s,
        device_ops=_top(kernel_s), idle_gaps=_top(idle),
    )


def _top(totals: dict) -> list:
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]
