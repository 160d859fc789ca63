"""The traced run's reduction of a ``torch.profiler`` trace.

The benchmark opens host ranges with ``torch.profiler.record_function``:
``bench.window`` around the measured window, ``bench.step`` around each
``ServingEngine.step``, ``bench.submit`` around each ``submit``, and, in the
pass-through model it hands the engine in a traced run, ``model.prefill``
and ``model.decode`` around each call into the model.  Device operations
(kernels, copies, fills) are read from the profiler's raw events: each is
tied to the host range that launched it through its linked correlation id
(the host event that was open when it was queued), else to the range its
device interval lies in.  Times are the profiler's, in nanoseconds on one
clock for host and device.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

from torch.autograd import DeviceType

WINDOW = "bench.window"
STEP, SUBMIT = "bench.step", "bench.submit"
PREFILL, DECODE = "model.prefill", "model.decode"
RANGES = (WINDOW, STEP, SUBMIT, PREFILL, DECODE)
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# what the host was doing in an idle gap, innermost first
LABELS = ((PREFILL, "model.prefill"), (DECODE, "model.decode"),
          (SUBMIT, "submit"), (STEP, "step"))
BETWEEN = "between steps"


@dataclasses.dataclass
class Op:
    name: str
    kind: str                     # "kernel", "gpu_memcpy" or "gpu_memset"
    start: int
    end: int
    owner: tuple | None = None    # (range name, index) that queued it


@dataclasses.dataclass
class Trace:
    window: tuple[int, int]
    ops: list[Op]                            # device ops in the window
    ranges: dict[str, list[tuple[int, int]]]  # host ranges, by start

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


def _find(ranges: list[tuple[int, int]], starts: list[int], t: int
          ) -> int | None:
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and ranges[i][0] <= t <= ranges[i][1]:
        return i
    return None


def _kind(e) -> str:
    """The event's activity type (the profiler's own where this torch
    exposes it; else from its device and name)."""
    get = getattr(e, "activity_type", None)
    if get is not None:
        return get()
    name = e.name()
    if e.device_type() != DeviceType.CPU:
        if name in RANGES:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name in RANGES:
        return "user_annotation"
    if name.startswith("cuda"):
        return "cuda_runtime"
    return "cpu_op"


def read(prof) -> Trace | None:
    """The window's device operations and the benchmark's host ranges, or
    None where the trace holds no window or no device operation."""
    events = prof.profiler.kineto_results.events()
    ranges: dict[str, list[tuple[int, int]]] = defaultdict(list)
    host_start: dict[int, int] = {}
    device = []
    for e in events:
        kind = _kind(e)
        if kind in DEVICE_KINDS:
            device.append((e, kind))
        elif kind in ("cpu_op", "user_annotation"):
            start = e.start_ns()
            host_start[e.correlation_id()] = start
            if kind == "user_annotation" and e.name() in RANGES:
                ranges[e.name()].append((start, start + e.duration_ns()))
    if not ranges.get(WINDOW) or not device:
        return None
    for v in ranges.values():
        v.sort()
    window = ranges[WINDOW][0]
    starts = {k: [r[0] for r in v] for k, v in ranges.items()}
    ops = []
    for e, kind in device:
        s = e.start_ns()
        t = s + e.duration_ns()
        if t <= window[0] or s >= window[1]:
            continue
        op = Op(e.name(), kind, max(s, window[0]), min(t, window[1]))
        launched = host_start.get(e.linked_correlation_id())
        for name in (PREFILL, DECODE):
            if name not in ranges:
                continue
            at = launched if launched is not None else s
            i = _find(ranges[name], starts[name], at)
            if i is not None:
                op.owner = (name, i)
                break
        ops.append(op)
    return Trace(window, ops, dict(ranges))


def busy_intervals(trace: Trace) -> list[tuple[int, int]]:
    """The union of the device operations' intervals in the window."""
    out: list[list[int]] = []
    for s, t in sorted((o.start, o.end) for o in trace.ops):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def busy_s(trace: Trace) -> float:
    return sum(t - s for s, t in busy_intervals(trace)) / 1e9


def idle_by_label(trace: Trace) -> dict[str, float]:
    """Idle seconds of the device in the window, by the innermost of the
    benchmark's host ranges open at each gap's middle."""
    starts = {k: [r[0] for r in v] for k, v in trace.ranges.items()}
    out: dict[str, float] = defaultdict(float)
    edges = [trace.window[0]]
    for s, t in busy_intervals(trace):
        edges.extend((s, t))
    edges.append(trace.window[1])
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        label = BETWEEN
        for name, lab in LABELS:
            if name in trace.ranges and _find(trace.ranges[name],
                                               starts[name], mid) is not None:
                label = lab
                break
        out[label] += (b - a) / 1e9
    return dict(out)


def seconds_by_name(trace: Trace) -> dict[str, float]:
    out: dict[str, float] = defaultdict(float)
    for o in trace.ops:
        out[o.name] += (o.end - o.start) / 1e9
    return dict(out)


def ops_of(trace: Trace, range_name: str) -> dict[int, list[Op]]:
    """The device operations each ``range_name`` range queued, by the
    range's index in start order."""
    out: dict[int, list[Op]] = defaultdict(list)
    for o in trace.ops:
        if o.owner is not None and o.owner[0] == range_name:
            out[o.owner[1]].append(o)
    return dict(out)


def breakdown(trace: Trace, top: int = 10) -> dict:
    ops = sorted(seconds_by_name(trace).items(), key=lambda kv: -kv[1])
    idle = sorted(idle_by_label(trace).items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k[:160], v] for k, v in ops[:top]],
            "idle_gaps": [[k, v] for k, v in idle[:top]]}
