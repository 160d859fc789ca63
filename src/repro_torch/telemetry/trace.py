"""The port's copy of ``repro.telemetry.trace``.

Causal trace trees over a run's event log — where did the time go?

The recorder stamps every event with a deterministic ``span_id`` /
``parent_id`` (see :mod:`repro_torch.telemetry.recorder`); this module turns
the flat log back into the causal structure the ids encode and answers
the questions flat spans cannot:

* :func:`span_trees` — the forest: ``sim.request`` roots over their
  ``sim.attempt`` children over per-stage ``sim.plan`` / ``sim.compute``
  / ``sim.comm`` / ``sim.queue_wait`` shards (and ``load.request`` roots
  over queue-wait/service in load runs); non-span events (retry
  counters, membership gauges) attach to the span they happened inside.
* :func:`tree_lines` — the forest rendered as canonical indented lines:
  the byte surface two seeded replays must agree on (the fig8 trace gate
  compares exactly this).
* :func:`critical_path` — one request's latency decomposed into
  **plan / queue / compute / comm / retry_waste / other** with the
  categories summing to the recorded latency (failed attempts are
  retry-waste wholesale; the final attempt is walked backward along its
  dependency chain, with uncovered gaps — e.g. a strategy's modeled
  ``extra_latency`` — landing in ``other``).
* :func:`node_utilization` / :func:`overlap_headroom` — per-node
  busy/idle timelines and idle-while-a-peer-computes seconds: the
  number a pipelined executor would reclaim, which the ROADMAP's
  pipelining item optimizes.

Everything here is pure post-processing: it reads a
:class:`~repro_torch.telemetry.RunStore` (or a raw event list) and never
touches the hot path.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from .events import TelemetryEvent

#: critical-path categories, fixed order (reports render in this order)
CATEGORIES = ("plan", "queue", "compute", "comm", "retry_waste", "other")

#: span name → critical-path category for per-stage children
_STAGE_CATEGORY = {
    "sim.plan": "plan",
    "sim.queue_wait": "queue",
    "load.queue_wait": "queue",
    "sim.compute": "compute",
    "load.service": "compute",
    "sim.comm": "comm",
}

#: span names that root a request's trace tree
REQUEST_ROOTS = ("sim.request", "load.request")


@dataclasses.dataclass
class SpanNode:
    """One span in the reconstructed tree.

    Attributes:
        event: the span's :class:`TelemetryEvent`.
        children: child *spans*, in emission (seq) order.
        events: non-span events (counters, gauges) parented here.
    """

    event: TelemetryEvent
    children: list["SpanNode"] = dataclasses.field(default_factory=list)
    events: list[TelemetryEvent] = dataclasses.field(default_factory=list)

    @property
    def name(self) -> str:
        return self.event.name

    @property
    def start(self) -> float:
        return self.event.t

    @property
    def end(self) -> float:
        return self.event.t + self.event.value

    def walk(self) -> Iterable["SpanNode"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def __repr__(self) -> str:
        return (f"SpanNode({self.name!r}, id={self.event.span_id}, "
                f"{len(self.children)} children)")


def span_trees(events: Sequence[TelemetryEvent]) -> list[SpanNode]:
    """Rebuild the span forest from a flat event list.  Roots are spans
    with no parent (or whose parent id no span in the log claims — an
    orphan is surfaced, not dropped); non-span events attach to their
    parent's ``events`` list and are ignored when the parent is unknown.

    Children keep emission (seq) order, which is deterministic under the
    recorder's contract — so the forest, rendered via
    :func:`tree_lines`, is byte-identical across seeded replays."""
    nodes: dict[int, SpanNode] = {}
    spans: list[SpanNode] = []
    for e in events:
        if e.kind == "span":
            n = SpanNode(e)
            spans.append(n)
            if e.span_id is not None:
                nodes[e.span_id] = n
    roots: list[SpanNode] = []
    for n in spans:
        pid = n.event.parent_id
        parent = nodes.get(pid) if pid is not None else None
        if parent is None or parent is n:
            roots.append(n)
        else:
            parent.children.append(n)
    for e in events:
        if e.kind != "span" and e.parent_id is not None:
            parent = nodes.get(e.parent_id)
            if parent is not None:
                parent.events.append(e)
    return roots


def forest(store, run: str) -> list[SpanNode]:
    """:func:`span_trees` over everything a run logged."""
    return span_trees(store.events(run))


def tree_lines(roots: Sequence[SpanNode]) -> list[str]:
    """The forest as canonical indented lines — each node's
    wall-stripped JSON under its depth, children in order.  This is the
    replay-determinism surface for trace *shape*: two seeded replays
    must produce byte-identical lines (gated in fig8's trace gate and
    ``tests/test_trace.py``)."""
    out: list[str] = []

    def walk(node: SpanNode, depth: int) -> None:
        out.append("  " * depth + node.event.canonical())
        for e in node.events:
            out.append("  " * (depth + 1) + "· " + e.canonical())
        for c in node.children:
            walk(c, depth + 1)

    for r in roots:
        walk(r, 0)
    return out


# --------------------------------------------------------- critical path
@dataclasses.dataclass
class CriticalPath:
    """One request's latency, decomposed.  ``categories`` spans the full
    :data:`CATEGORIES` set and sums to ``latency`` (within float
    round-off — the trace gate holds the residual to ~1e-9)."""

    request: int | None
    tenant: str
    latency: float
    categories: dict[str, float]

    @property
    def total(self) -> float:
        return sum(self.categories.values())

    @property
    def residual(self) -> float:
        """latency − Σ categories: float dust, gated near zero."""
        return self.latency - self.total

    def fraction(self, category: str) -> float:
        return (self.categories[category] / self.latency
                if self.latency > 0 else 0.0)


def _walk_attempt(attempt: SpanNode, cats: dict[str, float],
                  eps: float = 1e-9) -> None:
    """Decompose one (successful) attempt: planning overhead first, then
    a backward walk from the attempt's completion along whichever stage
    span ends at the cursor — the dependency chain that actually gated
    completion.  Parallel shards off the chain are skipped (they
    overlapped the chain; their time is not additive latency), and
    uncovered gaps (modeled ``extra_latency``, inter-stage slack) land
    in ``other`` so the sum stays exact."""
    start, end = attempt.start, attempt.end
    stages: list[SpanNode] = []
    plan_total = 0.0
    for c in attempt.children:
        if c.name == "sim.plan":
            plan_total += c.event.value
            cats["plan"] += c.event.value
        elif c.name in _STAGE_CATEGORY:
            stages.append(c)
    exec_start = start + plan_total
    remaining = sorted(stages, key=lambda s: (s.end, s.event.value))
    cursor = end
    while cursor > exec_start + eps:
        pick = None
        for i in range(len(remaining) - 1, -1, -1):
            if remaining[i].end <= cursor + eps:
                pick = remaining.pop(i)
                break
        if pick is None:
            break
        if pick.end < cursor - eps:
            cats["other"] += cursor - pick.end
            cursor = pick.end
        seg_start = max(pick.start, exec_start)
        cats[_STAGE_CATEGORY[pick.name]] += cursor - seg_start
        cursor = seg_start
    if cursor > exec_start:
        cats["other"] += cursor - exec_start


def critical_path(root: SpanNode) -> CriticalPath:
    """Decompose one request root (``sim.request`` or ``load.request``)
    into :data:`CATEGORIES`.  Failed attempts (``ok=False`` — a crash
    killed their shards) are charged wholesale to ``retry_waste``: every
    second of a doomed attempt delayed the request, whatever that
    attempt was doing when the node died."""
    e = root.event
    if e.name not in REQUEST_ROOTS:
        raise ValueError(f"not a request root: {e.name!r} "
                         f"(expected one of {REQUEST_ROOTS})")
    cats = dict.fromkeys(CATEGORIES, 0.0)
    if e.name == "load.request":
        for c in root.children:
            cat = _STAGE_CATEGORY.get(c.name)
            if cat is not None:
                cats[cat] += c.event.value
        cats["other"] += e.value - sum(cats.values())
    else:
        attempts = [c for c in root.children if c.name == "sim.attempt"]
        for a in attempts:
            if a.event.attrs.get("ok", True):
                _walk_attempt(a, cats)
            else:
                cats["retry_waste"] += a.event.value
        cats["other"] += e.value - sum(cats.values())
    # flush float dust (including -0.0) so reports never print "-0.0000"
    cats = {k: (0.0 if abs(v) < 1e-12 else v) for k, v in cats.items()}
    return CriticalPath(request=e.attrs.get("request"), tenant=e.tenant,
                        latency=e.value, categories=cats)


def request_critical_paths(store, run: str) -> list[CriticalPath]:
    """Every request root in the run, decomposed, in emission order."""
    return [critical_path(r) for r in forest(store, run)
            if r.name in REQUEST_ROOTS]


def category_totals(paths: Sequence[CriticalPath]) -> dict[str, float]:
    """Summed seconds per category across requests (the report's
    where-did-the-time-go row)."""
    out = dict.fromkeys(CATEGORIES, 0.0)
    for p in paths:
        for k, v in p.categories.items():
            out[k] += v
    return out


# ------------------------------------------------- utilization & headroom
def _merged(intervals: Iterable[tuple[float, float]]
            ) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1] + 1e-12:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _subtract(a: Sequence[tuple[float, float]],
              b: Sequence[tuple[float, float]]
              ) -> list[tuple[float, float]]:
    """Interval difference a − b (both merged & sorted)."""
    out: list[tuple[float, float]] = []
    j = 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            bs, be = b[k]
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            if be >= e:
                break
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def _span_len(intervals: Sequence[tuple[float, float]]) -> float:
    return sum(e - s for s, e in intervals)


def busy_intervals(events: Sequence[TelemetryEvent]
                   ) -> dict[str, list[tuple[float, float]]]:
    """Merged busy windows per execution resource: ``sim.compute`` spans
    keyed by their ``node`` attr, ``sim.comm`` spans by their
    ``resource`` (the shared ``medium``, or a node's internal bus)."""
    raw: dict[str, list[tuple[float, float]]] = {}
    for e in events:
        if e.kind != "span" or e.value <= 0:
            continue
        if e.name == "sim.compute":
            key = str(e.attrs.get("node", "?"))
        elif e.name == "sim.comm":
            key = str(e.attrs.get("resource", "medium"))
        else:
            continue
        raw.setdefault(key, []).append((e.t, e.t + e.value))
    return {k: _merged(v) for k, v in raw.items()}


def node_utilization(store, run: str,
                     horizon: float | None = None) -> dict[str, dict]:
    """Per-resource busy/idle over ``[0, horizon]`` (default: the last
    busy instant or request completion).  Returns
    ``{resource: {busy_s, idle_s, utilization, intervals}}`` — the
    timeline the report's ASCII renderer draws, and the saturation
    evidence the throughput-maximization line needs (which resource
    fills first)."""
    events = store.events(run, kind="span")
    busy = busy_intervals(events)
    if horizon is None:
        ends = [iv[-1][1] for iv in busy.values() if iv]
        ends += [e.t + e.value for e in events if e.name in REQUEST_ROOTS]
        horizon = max(ends, default=0.0)
    out = {}
    for key in sorted(busy):
        b = _span_len(busy[key])
        out[key] = {"busy_s": b, "idle_s": max(horizon - b, 0.0),
                    "utilization": b / horizon if horizon > 0 else 0.0,
                    "intervals": busy[key]}
    return out


def overlap_headroom(store, run: str,
                     horizon: float | None = None) -> dict[str, dict]:
    """Idle-while-a-peer-computes, per node — the compute/comm overlap a
    pipelined executor could reclaim (ROADMAP's pipelining item; PAPERS
    arxiv 2201.06769).  For each compute node: seconds it sat idle while
    at least one *other* node was computing.  The ``"total"`` entry sums
    the per-node headroom and normalizes by nodes × any-busy time."""
    events = store.events(run, kind="span")
    busy = {k: v for k, v in busy_intervals(events).items()
            if k != "medium" and "/" not in k}      # compute nodes only
    any_busy = _merged(iv for v in busy.values() for iv in v)
    out: dict[str, dict] = {}
    total = 0.0
    for key in sorted(busy):
        others = _merged(iv for k, v in busy.items() if k != key
                         for iv in v)
        idle_while_peer = _span_len(_subtract(others, busy[key]))
        total += idle_while_peer
        out[key] = {"idle_while_peer_busy_s": idle_while_peer,
                    "busy_s": _span_len(busy[key])}
    denom = len(busy) * _span_len(any_busy)
    out["total"] = {"idle_while_peer_busy_s": total,
                    "fraction": total / denom if denom > 0 else 0.0}
    return out


# ------------------------------------------------------------- summaries
def trace_summary(store, run: str) -> dict:
    """Everything the report renders from the trace layer: per-category
    mean seconds (and fractions of mean latency), per-node utilization,
    and overlap headroom.  ``requests`` is 0 for runs with no request
    roots (pure benchmark runs) — the report then skips the section."""
    paths = request_critical_paths(store, run)
    totals = category_totals(paths)
    n = len(paths)
    mean_latency = (sum(p.latency for p in paths) / n) if n else 0.0
    return {
        "requests": n,
        "mean_latency_s": mean_latency,
        "category_means_s": {k: (v / n if n else 0.0)
                             for k, v in totals.items()},
        "category_fractions": {
            k: (v / n / mean_latency if n and mean_latency > 0 else 0.0)
            for k, v in totals.items()},
        "max_residual_s": max((abs(p.residual) for p in paths),
                              default=0.0),
        "utilization": node_utilization(store, run),
        "headroom": overlap_headroom(store, run),
    }
