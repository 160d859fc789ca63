"""The program's own spans laid against a traced run's device trace.

With a recorder wired, the serving engine and the model emit wall-clocked
spans (``engine.*``, ``model.*``, ``layer.*``), each covering ``[wall -
wall_s, wall]`` on the unix clock that ``torch.profiler`` converts its host
and device events to (``bench/devtrace.py``'s nanoseconds).  Here:

* ``program_spans``: those spans from the run's events, each clamped into
  its parent (the two ends are rounded floats) and knowing the model call
  (``engine.prefill`` or ``engine.decode``) it lies in;
* ``attach_launches``: each device op of the trace gets ``launch_ns``, the
  host start of the CUDA API call that queued it (the event that shares
  its correlation id), else of the linked host op, as
  ``devtrace.read`` ties ops to ranges; ``launch_by`` says which;
* ``table``: for each span name, host seconds (its spans' lengths),
  device seconds and kernels launched innermost under it, and the idle
  seconds of the device whose gaps have their middle innermost under it;
* the readers' quantities: the admission waits (``queued_s`` of each
  ``engine.prefill``), the device's idle time inside each
  ``engine.decode``, the share of device-busy time launched inside
  ``layer.moe`` spans, and how far each ``engine.step`` lies from the
  ``bench.step`` range around it.

Each returns None (or an empty list) where the run has no such span, as
a program without them gives.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

from bench import devtrace

PREFIXES = ("engine.", "model.", "layer.")
CALLS = ("engine.prefill", "engine.decode")
RUNTIME_KINDS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "no program span"


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start: int                    # unix ns
    end: int
    attrs: dict
    depth: int                    # program spans above it
    call: str = ""                # the model call (``CALLS``) it lies in


def program_spans(events) -> list[Span]:
    """The wall-clocked program spans among ``events``, each clamped into
    its parent, ordered by start (a parent before its children)."""
    mine = sorted((e for e in events
                   if e.kind == "span" and e.wall_s is not None
                   and e.name.startswith(PREFIXES)),
                  key=lambda e: e.span_id)   # allocation: parents first
    by_id: dict[int, Span] = {}
    out = []
    for e in mine:
        start, end = round((e.wall - e.wall_s) * 1e9), round(e.wall * 1e9)
        parent = by_id.get(e.parent_id)
        depth, call = 0, ""
        if parent is not None:
            start = min(max(start, parent.start), parent.end)
            end = max(min(end, parent.end), start)
            depth = parent.depth + 1
            call = parent.name if parent.name in CALLS else parent.call
        s = Span(e.name, start, end, dict(e.attrs), depth, call)
        by_id[e.span_id] = s
        out.append(s)
    out.sort(key=lambda s: (s.start, s.depth))
    return out


def innermost(spans: list[Span], times: list[int]) -> list[Span | None]:
    """For each instant, the innermost span open at it (None outside
    every span); ``spans`` as ``program_spans`` orders them."""
    out: list[Span | None] = [None] * len(times)
    stack: list[Span] = []
    j = 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while j < len(spans) and spans[j].start <= t:
            s = spans[j]
            j += 1
            while stack and stack[-1].end < s.start:
                stack.pop()
            stack.append(s)
        while stack and stack[-1].end < t:
            stack.pop()
        out[k] = stack[-1] if stack else None
    return out


def attach_launches(prof, trace: devtrace.Trace) -> dict[str, int]:
    """Give each op of ``trace`` (``devtrace.read(prof)``'s) its
    ``launch_ns`` and ``launch_by`` (``"runtime"``, ``"linked"`` or None);
    returns the count of ops by ``launch_by``."""
    runtime: dict[int, int] = {}
    host: dict[int, int] = {}
    device = []
    for e in prof.profiler.kineto_results.events():
        kind = devtrace._kind(e)
        if kind in devtrace.DEVICE_KINDS:
            device.append(e)
        elif kind in RUNTIME_KINDS:
            runtime[e.correlation_id()] = e.start_ns()
        elif kind in ("cpu_op", "user_annotation"):
            host[e.correlation_id()] = e.start_ns()
    w0, w1 = trace.window
    inside = [e for e in device
              if e.start_ns() + e.duration_ns() > w0 and e.start_ns() < w1]
    if len(inside) != len(trace.ops):
        raise RuntimeError(f"{len(inside)} device events in the window, "
                           f"{len(trace.ops)} ops in the trace")
    counts: dict[str, int] = defaultdict(int)
    for e, op in zip(inside, trace.ops):
        if e.name() != op.name:
            raise RuntimeError(f"device event {e.name()!r} against op "
                               f"{op.name!r}")
        at = runtime.get(e.correlation_id())
        by = "runtime"
        if at is None:
            at = host.get(e.linked_correlation_id())
            by = "linked" if at is not None else None
        op.launch_ns, op.launch_by = at, by
        counts[str(by)] += 1
    return dict(counts)


def _launched(trace: devtrace.Trace) -> list:
    return [o for o in trace.ops if getattr(o, "launch_ns", None) is not None]


def owners(trace: devtrace.Trace, spans: list[Span]) -> list[tuple]:
    """(op, the innermost span open at its launch) for every op with a
    launch time."""
    ops = _launched(trace)
    return list(zip(ops, innermost(spans, [o.launch_ns for o in ops])))


def _gaps(trace: devtrace.Trace) -> list[tuple[int, int]]:
    edges = [trace.window[0]]
    for s, t in devtrace.busy_intervals(trace):
        edges.extend((s, t))
    edges.append(trace.window[1])
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def by_name(s: Span) -> str:
    return s.name


def by_call(s: Span) -> str:
    """The span's name under the model call it lies in, as
    ``engine.decode/layer.moe``."""
    return f"{s.call}/{s.name}" if s.call else s.name


def table(trace: devtrace.Trace, spans: list[Span], key=by_name
          ) -> dict[str, dict]:
    """By ``key`` of the span (``NO_SPAN`` for what lies outside every
    span): host seconds, device seconds and kernels launched innermost
    under it, device idle seconds put down to it by each gap's middle."""
    rows: dict[str, dict] = defaultdict(lambda: {
        "host_s": 0.0, "device_s": 0.0, "kernels": 0, "idle_s": 0.0})
    w0, w1 = trace.window
    for s in spans:
        if s.start >= w0 and s.end <= w1:
            rows[key(s)]["host_s"] += (s.end - s.start) / 1e9
    for op, s in owners(trace, spans):
        row = rows[NO_SPAN if s is None else key(s)]
        row["device_s"] += (op.end - op.start) / 1e9
        row["kernels"] += int(op.kind == "kernel")
    gaps = _gaps(trace)
    for (a, b), s in zip(gaps, innermost(spans,
                                         [(a + b) // 2 for a, b in gaps])):
        rows[NO_SPAN if s is None else key(s)]["idle_s"] += (b - a) / 1e9
    return dict(rows)


def admit_waits(events) -> list[float]:
    """Seconds from each admitted request's submit to its prefill."""
    return [e.attrs["queued_s"] for e in events
            if e.kind == "span" and e.name == "engine.prefill"
            and e.attrs.get("queued_s") is not None]


def decode_idle(trace: devtrace.Trace, spans: list[Span]) -> list[float]:
    """For each ``engine.decode`` span inside the traced window, its
    seconds in which no device op ran."""
    busy = devtrace.busy_intervals(trace)
    starts = [s for s, _ in busy]
    w0, w1 = trace.window
    out = []
    for sp in spans:
        if sp.name != "engine.decode" or sp.start < w0 or sp.end > w1:
            continue
        covered = 0
        i = max(bisect.bisect_right(starts, sp.start) - 1, 0)
        while i < len(busy) and busy[i][0] < sp.end:
            covered += max(0, min(busy[i][1], sp.end)
                           - max(busy[i][0], sp.start))
            i += 1
        out.append((sp.end - sp.start - covered) / 1e9)
    return out


def moe_busy_share(trace: devtrace.Trace, spans: list[Span]
                   ) -> float | None:
    """Device-busy time of the ops launched inside ``layer.moe`` spans over
    all device-busy time of the window, in %; None without such spans or
    without launch times."""
    if not any(s.name == "layer.moe" for s in spans):
        return None
    pairs = owners(trace, spans)
    if not pairs:
        return None
    moe = dataclasses.replace(trace, ops=[
        o for o, s in pairs if s is not None and s.name == "layer.moe"])
    busy = devtrace.busy_s(trace)
    if busy <= 0:
        return None
    return 100.0 * devtrace.busy_s(moe) / busy


def step_offsets(trace: devtrace.Trace, spans: list[Span]
                 ) -> list[tuple[int, int]]:
    """For each ``bench.step`` range of the trace that one ``engine.step``
    span overlaps: (span start - range start, range end - span end), in
    ns."""
    steps = [s for s in spans if s.name == "engine.step"]
    starts = [s.start for s in steps]
    out = []
    for r0, r1 in trace.ranges.get(devtrace.STEP, []):
        j = bisect.bisect_left(starts, r1)
        hits = [s for s in steps[max(j - 2, 0):j] if s.end > r0]
        if len(hits) == 1:
            out.append((hits[0].start - r0, r1 - hits[0].end))
    return out
