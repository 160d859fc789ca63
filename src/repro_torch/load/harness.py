"""The port's copy of ``repro.load.harness``.

Open-loop queueing harness — arrivals meet a finite cluster.

The harness replays an :class:`~repro_torch.load.traces.ArrivalTrace` against a
cluster abstracted as ``servers`` identical service lanes priced by a
service model (:mod:`repro_torch.load.service`).  It is an *event-driven* loop
over two event kinds (arrival, lane-free) with all per-request state in
preallocated numpy arrays — 10⁵–10⁶ requests per run; the planner is
consulted O(tenants × epochs) times, never per request.

Request lifecycle (every arrival ends in exactly one terminal state)::

    arrive ──(queue full)──────────────▶ REJECTED    admission control
      │
      ▼ enqueue (per-tenant FIFO)
    queued ──(stale / doomed at dispatch)──▶ SHED    backpressure
      │
      ▼ dispatch (priority → WDRR)                   "admitted"
    in service ────────────────────────▶ COMPLETED

* **Admission control** — ``queue_capacity`` bounds the total backlog;
  an arrival that finds the queue full is rejected on the spot.  Bounded
  queues are what turn overload into accounted-for rejects instead of
  unbounded latency.
* **SLO-aware priorities** — tenants are grouped into priority classes
  (explicit ``TenantSpec.priority``, or derived: tighter SLO → served
  first).  Classes are strict and non-preemptive: a lane never takes a
  looser-class request while a tighter-class one is queued.
* **Per-tenant fairness** — within a class, weighted deficit round-robin
  (DRR): each visit credits a tenant ``quantum × weight`` seconds of
  service and serves while the head is affordable, so over any backlogged
  interval tenants receive service seconds proportional to their weights
  (within one quantum), regardless of who floods the queue.
* **Backpressure / shedding** — at dispatch, a request that waited past
  ``max_wait``, or whose SLO can no longer be met even if served
  immediately (``shed_doomed``), is shed rather than served.  Under
  sustained overload the queue stays bounded, sheds/rejects grow, and the
  *served* traffic keeps meeting its SLO — the saturation gate.
* **Churn** — pass ``fleet=`` (a ``repro_torch.fleet.FleetController``): the
  trace's availability events are consumed as simulated time advances,
  and every membership epoch re-prices service via
  ``service_model.begin_epoch`` (with a
  :class:`~repro_torch.load.service.PlanServiceModel`, one membership-keyed
  cache resolution per tenant per epoch).
* **Telemetry** — every queue decision is recorded: ``load.reject`` /
  ``load.shed`` / ``load.admit`` counters, ``load.queue_wait`` and
  ``load.service`` spans per dispatch and a ``load.request`` span per
  completion, all epoch-stamped with deterministic domain time.  The
  event loop cannot nest ``trace()`` contexts (a request's life spans
  many loop iterations), so each enqueued arrival gets an explicitly
  allocated span id: queue-wait/service/shed events carry it as
  ``parent_id`` and the terminal ``load.request`` claims it as
  ``span_id`` — the flat log still reconstructs into per-request trees
  (:mod:`repro_torch.telemetry.trace`), and two seeded replays of the same
  trace produce byte-identical canonical logs (docs/observability.md).

Ties are deterministic: a lane-free event at the same instant as an
arrival is processed first (the freed slot is visible to the arrival's
admission check), and simultaneous arrivals dispatch in trace order.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from collections import deque
from typing import Mapping, Sequence

import numpy as np

from .traces import ArrivalTrace

# request terminal/transient states (LoadReport.status values)
QUEUED, IN_FLIGHT, COMPLETED, REJECTED, SHED = 0, 1, 2, 3, 4
STATUS_NAMES = ("queued", "in_flight", "completed", "rejected", "shed")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's serving contract.

    Attributes:
        name: the tenant's name in the arrival trace.
        slo: end-to-end latency objective in seconds (None = best-effort).
        weight: WDRR share within the tenant's priority class.
        priority: explicit class (lower = served first); None derives it
            from the SLO — tighter SLOs get tighter classes, best-effort
            tenants the loosest.
        dag: the tenant's ModelDAG (what a ``PlanServiceModel`` prices).
        delta: compute intensity — part of the tenant's plan-cache key.
        objective: planning objective name for plan resolution (None =
            the planner's default, latency).
    """

    name: str
    slo: float | None = None
    weight: float = 1.0
    priority: int | None = None
    dag: object | None = None
    delta: float | None = None
    objective: str | None = None

    def __post_init__(self) -> None:
        if self.weight <= 0:
            raise ValueError("weight must be positive")
        if self.slo is not None and self.slo <= 0:
            raise ValueError("slo must be positive seconds")


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """Queueing knobs.

    Attributes:
        servers: concurrent service lanes the cluster sustains (HiDP's
            data-parallel plans span the whole cluster, so 1 is the
            faithful default; pipelined executors raise it).
        queue_capacity: max queued (not yet dispatched) requests across
            all tenants; an arrival over the cap is rejected.  None =
            unbounded (no admission control).
        max_wait: shed any request that waited longer than this at
            dispatch time (None = no age limit).
        shed_doomed: shed a request whose SLO is already unmeetable at
            dispatch (``wait + service > slo``) — serving it would burn
            capacity on a guaranteed violation.
        quantum: WDRR credit in service-seconds per unit weight per
            round; None auto-sizes to the largest current service time
            (the classic DRR choice — every backlogged tenant can afford
            its head once per round).
        drain: after the last arrival, keep serving until the queue is
            empty (True, the default) or stop the clock at the last
            arrival and leave the backlog as ``queued``/``in_flight``.
    """

    servers: int = 1
    queue_capacity: int | None = None
    max_wait: float | None = None
    shed_doomed: bool = True
    quantum: float | None = None
    drain: bool = True

    def __post_init__(self) -> None:
        if self.servers < 1:
            raise ValueError("servers must be >= 1")
        if self.queue_capacity is not None and self.queue_capacity < 0:
            raise ValueError("queue_capacity must be >= 0")
        if self.max_wait is not None and self.max_wait <= 0:
            raise ValueError("max_wait must be positive")
        if self.quantum is not None and self.quantum <= 0:
            raise ValueError("quantum must be positive")


def derive_priorities(specs: Sequence[TenantSpec]) -> dict[str, int]:
    """Effective priority class per tenant: explicit ``priority`` wins;
    otherwise classes are ranked by SLO tightness (distinct SLOs
    ascending → class 0, 1, …) with best-effort (no-SLO) tenants in the
    loosest derived class."""
    slos = sorted({s.slo for s in specs
                   if s.priority is None and s.slo is not None})
    rank = {slo: i for i, slo in enumerate(slos)}
    out = {}
    for s in specs:
        if s.priority is not None:
            out[s.name] = int(s.priority)
        elif s.slo is not None:
            out[s.name] = rank[s.slo]
        else:
            out[s.name] = len(rank)
    return out


@dataclasses.dataclass
class LoadReport:
    """Per-request outcome arrays plus the aggregates the saturation
    curves are drawn from.  ``status[i]`` is the i-th *arrival*'s fate
    (trace order); ``start``/``finish`` are NaN for requests that never
    dispatched/completed."""

    trace: ArrivalTrace
    specs: tuple[TenantSpec, ...]
    config: LoadConfig
    status: np.ndarray          # (N,) int8
    start: np.ndarray           # (N,) float64, dispatch instant
    finish: np.ndarray          # (N,) float64, completion instant
    clock_end: float            # when the run stopped

    # ------------------------------------------------------------- counts
    def count(self, status: int) -> int:
        return int(np.count_nonzero(self.status == status))

    @property
    def arrived(self) -> int:
        return int(self.status.size)

    @property
    def completed(self) -> int:
        return self.count(COMPLETED)

    @property
    def rejected(self) -> int:
        return self.count(REJECTED)

    @property
    def shed(self) -> int:
        return self.count(SHED)

    @property
    def in_flight(self) -> int:
        return self.count(IN_FLIGHT)

    @property
    def queued(self) -> int:
        return self.count(QUEUED)

    @property
    def admitted(self) -> int:
        """Requests that entered service: completed + still in flight."""
        return self.completed + self.in_flight

    def conservation_ok(self) -> bool:
        """arrived = admitted + rejected + shed + still-queued, and
        admitted = completed + in-flight — every arrival has exactly one
        fate."""
        return (self.arrived == self.admitted + self.rejected + self.shed
                + self.queued)

    # ---------------------------------------------------------- latencies
    def _done(self) -> np.ndarray:
        return self.status == COMPLETED

    def latencies(self) -> np.ndarray:
        """End-to-end (queue wait + service) seconds of completed
        requests, trace order."""
        m = self._done()
        return (self.finish[m] - self.trace.times[m])

    def waits(self) -> np.ndarray:
        """Queue-wait seconds of every dispatched request."""
        m = ~np.isnan(self.start)
        return self.start[m] - self.trace.times[m]

    def percentile(self, q: float) -> float:
        lat = self.latencies()
        return float(np.percentile(lat, q)) if lat.size else math.nan

    def slo_violations(self) -> int:
        """Completed requests that finished past their tenant's SLO."""
        slos = np.array([math.inf if s.slo is None else s.slo
                         for s in self.specs])
        m = self._done()
        lat = self.finish[m] - self.trace.times[m]
        return int(np.count_nonzero(lat > slos[self.trace.tenant_ids[m]]))

    def slo_violation_rate(self) -> float:
        """Violations among *served* requests — what admission control and
        doomed-shedding protect.  NaN when nothing completed."""
        done = self.completed
        return self.slo_violations() / done if done else math.nan

    def utilization(self, horizon: float | None = None) -> float:
        """Delivered service-seconds per lane-second over ``[0, horizon)``
        (default: until the clock stopped).  Physically bounded by 1.0 —
        the saturation gate's hard ceiling: no scheduler can deliver more
        service than the lanes hold.  (Throughput can legitimately exceed
        the *offered-mix* capacity when shedding biases the served mix
        toward cheap tenants, so gate on utilization, not requests/s.)"""
        horizon = self.clock_end if horizon is None else horizon
        if horizon <= 0:
            return 0.0
        s = np.minimum(self.finish, horizon) - np.minimum(self.start,
                                                          horizon)
        busy = float(np.nansum(np.clip(s, 0.0, None)))
        return busy / (self.config.servers * horizon)

    def throughput(self, horizon: float | None = None) -> float:
        """Completions per second inside ``[0, horizon)`` (default: the
        trace horizon) — the saturation curve's y-axis."""
        horizon = self.trace.horizon if horizon is None else horizon
        m = self._done() & (self.finish <= horizon)
        return float(np.count_nonzero(m)) / max(horizon, 1e-12)

    # ----------------------------------------------------------- breakdown
    def per_tenant(self) -> dict[str, dict[str, float]]:
        out: dict[str, dict[str, float]] = {}
        ids = self.trace.tenant_ids
        for ti, spec in enumerate(self.specs):
            m = ids == ti
            st = self.status[m]
            done = (st == COMPLETED)
            lat = (self.finish[m] - self.trace.times[m])[done]
            viol = (int(np.count_nonzero(lat > spec.slo))
                    if spec.slo is not None else 0)
            out[spec.name] = {
                "arrived": int(st.size),
                "completed": int(np.count_nonzero(done)),
                "rejected": int(np.count_nonzero(st == REJECTED)),
                "shed": int(np.count_nonzero(st == SHED)),
                "p50": float(np.percentile(lat, 50)) if lat.size
                else math.nan,
                "p99": float(np.percentile(lat, 99)) if lat.size
                else math.nan,
                "slo_violations": viol,
                "service_seconds": float(np.nansum(
                    (self.finish[m] - self.start[m])[done])),
            }
        return out

    def __repr__(self) -> str:
        return (f"LoadReport({self.arrived} arrived: {self.completed} "
                f"completed, {self.rejected} rejected, {self.shed} shed, "
                f"p99={self.percentile(99):.3g}s)")


class _DRRClass:
    """One priority class's weighted deficit round-robin state."""

    __slots__ = ("tenants", "ptr", "fresh")

    def __init__(self, tenants: list[int]):
        self.tenants = tenants
        self.ptr = 0
        self.fresh = True


class OpenLoopHarness:
    """Replays one arrival trace through the queueing layer.

    Attributes:
        trace / specs / config: the run's inputs (specs may omit tenants
            only if the trace has none of their arrivals — every trace
            tenant needs a spec).
        service_model: tenant → service-seconds provider
            (:mod:`repro_torch.load.service`).
        fleet: optional ``repro_torch.fleet.FleetController`` — availability
            events are consumed as simulated time passes; each epoch
            re-prices service.
        telemetry: optional ``repro_torch.telemetry.TelemetryRecorder``.
        epochs_seen: membership epochs observed mid-run.
    """

    def __init__(self, trace: ArrivalTrace,
                 specs: Mapping[str, TenantSpec] | Sequence[TenantSpec],
                 service_model, config: LoadConfig = LoadConfig(), *,
                 fleet=None, telemetry=None):
        if not isinstance(specs, Mapping):
            specs = {s.name: s for s in specs}
        missing = [n for n in trace.tenants if n not in specs]
        if missing:
            raise ValueError(f"no TenantSpec for trace tenants {missing}")
        self.trace = trace
        self.specs = tuple(specs[n] for n in trace.tenants)
        self.config = config
        self.service_model = service_model
        self.fleet = fleet
        from repro_torch.telemetry import active as _tel_active
        self.telemetry = _tel_active(telemetry)
        self.epochs_seen = 0
        # priority classes over tenant indices, tightest first
        prio = derive_priorities(self.specs)
        by_class: dict[int, list[int]] = {}
        for ti, spec in enumerate(self.specs):
            by_class.setdefault(prio[spec.name], []).append(ti)
        self._classes = [_DRRClass(by_class[p]) for p in sorted(by_class)]
        self._weights = np.array([s.weight for s in self.specs])
        self._slos = np.array([math.nan if s.slo is None else s.slo
                               for s in self.specs])

    # --------------------------------------------------------------- churn
    def _advance_fleet(self, now: float) -> None:
        """Consume availability events up to ``now``; on a membership
        epoch, re-price every tenant (one plan resolution each with a
        PlanServiceModel) and re-size the DRR quantum."""
        if self._churn_times is None:
            return
        i = self._churn_idx
        if i < len(self._churn_times) and self._churn_times[i] <= now:
            while (i < len(self._churn_times)
                   and self._churn_times[i] <= now):
                i += 1
            self._churn_idx = i
            before = self.fleet.epoch
            self.fleet.advance(now)
            if self.fleet.epoch != before:
                self.epochs_seen += 1
                self._refresh_service(now)

    def _refresh_service(self, now: float,
                         epoch: int | None = None) -> None:
        self.service_model.begin_epoch(
            self.fleet.epoch if self.fleet is not None else epoch)
        model = self.service_model
        self._svc = np.array([model.service_time(n)
                              for n in self.trace.tenants])
        self._quantum = (self.config.quantum
                         if self.config.quantum is not None
                         else float(self._svc.max(initial=0.0)) or 1.0)
        # a DRR round must let the cheapest-weighted tenant afford the
        # costliest head eventually; bound pop() visits accordingly
        wmin = float(self._weights.min(initial=1.0))
        self._max_rounds = int(math.ceil(
            float(self._svc.max(initial=0.0))
            / max(self._quantum * wmin, 1e-12))) + 2

    def _epoch(self) -> int | None:
        return self.fleet.epoch if self.fleet is not None else None

    # ----------------------------------------------------------- shedding
    def _sheddable(self, idx: int, now: float) -> str | None:
        """Why request ``idx`` should be shed at dispatch instant ``now``
        (None = serve it)."""
        wait = now - self._arrival[idx]
        if (self.config.max_wait is not None
                and wait > self.config.max_wait):
            return "max_wait"
        if self.config.shed_doomed:
            ti = self._tid[idx]
            slo = self._slos[ti]
            if not math.isnan(slo) and wait + self._svc[ti] > slo:
                return "doomed"
        return None

    def _shed(self, idx: int, now: float, reason: str) -> None:
        self._status[idx] = SHED
        self._queued_total -= 1
        tel = self.telemetry
        if tel is not None:
            tel.counter("load.shed", t=now,
                        tenant=self.trace.tenants[self._tid[idx]],
                        epoch=self._epoch(), request=int(idx),
                        reason=reason,
                        parent_id=int(self._span_ids[idx]))

    # ---------------------------------------------------------- scheduling
    def _pop(self, now: float) -> int | None:
        """The next request to serve: strict priority across classes,
        weighted DRR within, shedding stale/doomed heads along the way.
        Returns a request index, or None when every queue is empty."""
        queues = self._queues
        deficit = self._deficit
        for cls in self._classes:
            tenants = cls.tenants
            n = len(tenants)
            visits = 0
            budget = n * self._max_rounds
            while visits < budget:
                ti = tenants[cls.ptr]
                q = queues[ti]
                while q:
                    reason = self._sheddable(q[0], now)
                    if reason is None:
                        break
                    self._shed(q.popleft(), now, reason)
                if not q:
                    deficit[ti] = 0.0        # empty ⇒ no banked credit
                    cls.ptr = (cls.ptr + 1) % n
                    cls.fresh = True
                    visits += 1
                    continue
                if cls.fresh:
                    deficit[ti] += self._quantum * self._weights[ti]
                    cls.fresh = False
                cost = self._svc[ti]
                if deficit[ti] >= cost - 1e-12:
                    deficit[ti] -= cost
                    return q.popleft()
                cls.ptr = (cls.ptr + 1) % n
                cls.fresh = True
                visits += 1
            # the visit budget covers the worst quantum/weight ratio, so
            # reaching it means this class's queues drained via shedding
        return None

    def _dispatch(self, now: float) -> bool:
        """Fill one free lane.  Returns False when nothing is queued."""
        idx = self._pop(now)
        if idx is None:
            return False
        ti = self._tid[idx]
        self._status[idx] = IN_FLIGHT
        self._queued_total -= 1
        self._start[idx] = now
        fin = now + self._svc[ti]
        heapq.heappush(self._busy, fin)
        self._inflight.setdefault(fin, deque()).append(idx)
        tel = self.telemetry
        if tel is not None:
            name = self.trace.tenants[ti]
            ep = self._epoch()
            sid = int(self._span_ids[idx])
            tel.counter("load.admit", t=now, tenant=name, epoch=ep,
                        request=int(idx), parent_id=sid)
            tel.span("load.queue_wait", now - self._arrival[idx],
                     t=self._arrival[idx], tenant=name, epoch=ep,
                     request=int(idx), parent_id=sid)
            tel.span("load.service", self._svc[ti], t=now, tenant=name,
                     epoch=ep, request=int(idx), parent_id=sid)
        return True

    # ------------------------------------------------------------------ run
    def run(self) -> LoadReport:
        trace, cfg = self.trace, self.config
        n = len(trace)
        self._arrival = np.asarray(trace.times)
        self._tid = np.asarray(trace.tenant_ids)
        self._status = np.zeros(n, np.int8)
        self._start = np.full(n, math.nan)
        self._finish = np.full(n, math.nan)
        self._queues: list[deque[int]] = [deque()
                                          for _ in trace.tenants]
        # pre-allocated trace-tree identity per arrival: the event loop
        # cannot hold a trace() context open across iterations, so the
        # terminal load.request claims this id as span_id and every
        # queue-wait/service/shed event cites it as parent_id
        self._span_ids = np.full(n, -1, np.int64)
        self._deficit = np.zeros(len(trace.tenants))
        self._queued_total = 0
        self._busy: list[float] = []           # finish-time min-heap
        # pending finish → request idx (finish times can collide; FIFO per
        # instant keeps it deterministic)
        self._inflight = {}
        if self.fleet is not None:
            self._churn_times = [e.time for e in self.fleet.trace.events]
            self._churn_idx = 0
        else:
            self._churn_times = None
        self._refresh_service(0.0)
        tel = self.telemetry
        tenants = trace.tenants
        cap = cfg.queue_capacity

        def finish_one(now: float) -> None:
            heapq.heappop(self._busy)
            q = self._inflight[now]
            idx = q.popleft()
            if not q:
                del self._inflight[now]
            self._status[idx] = COMPLETED
            self._finish[idx] = now
            if tel is not None:
                ti = self._tid[idx]
                lat = now - self._arrival[idx]
                slo = self._slos[ti]
                tel.span("load.request", lat, t=self._arrival[idx],
                         tenant=tenants[ti], epoch=self._epoch(),
                         request=int(idx),
                         slo_violated=bool(not math.isnan(slo)
                                           and lat > slo),
                         span_id=int(self._span_ids[idx]))

        i = 0
        now = 0.0
        while i < n or self._busy:
            next_arr = self._arrival[i] if i < n else math.inf
            next_fin = self._busy[0] if self._busy else math.inf
            if next_fin == math.inf and next_arr == math.inf:
                break
            if next_fin <= next_arr:           # lane frees first on ties
                if not cfg.drain and i >= n:
                    break                      # clock stops at last arrival
                now = next_fin
                if tel is not None:
                    tel.advance(now)
                self._advance_fleet(now)
                finish_one(now)
            else:
                now = next_arr
                if tel is not None:
                    tel.advance(now)
                self._advance_fleet(now)
                idx = i
                i += 1
                # capacity bounds the *waiting room*: an arrival that will
                # go straight to a free lane is never rejected
                if (cap is not None and self._queued_total >= cap
                        and len(self._busy) >= cfg.servers):
                    self._status[idx] = REJECTED
                    if tel is not None:
                        tel.counter("load.reject", t=now,
                                    tenant=tenants[self._tid[idx]],
                                    epoch=self._epoch(), request=int(idx),
                                    reason="queue_full")
                    continue
                if tel is not None:
                    self._span_ids[idx] = tel.allocate_span()
                self._queues[self._tid[idx]].append(idx)
                self._queued_total += 1
            while len(self._busy) < cfg.servers:
                if not self._dispatch(now):
                    break
        return LoadReport(trace=trace, specs=self.specs, config=cfg,
                          status=self._status, start=self._start,
                          finish=self._finish, clock_end=now)
