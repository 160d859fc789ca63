"""The port's copy of ``repro.core.simulator``.

Event-driven edge-cluster simulator — the faithful-reproduction testbed.

Replays the paper's experiments (Figs. 1, 5, 6, 7, 8) for any Strategy over
the Table II cluster.  The simulator owns time: processors and the shared
wireless medium are capacity-1 resources with busy-until reservations;
requests are planned on arrival (greedy list scheduling, like the paper's
run-time scheduler servicing a queue) and their shards reserve resources in
dependency order.

The wireless medium is shared and half-duplex (all transfers serialize at
80 MB/s), which is what makes fine-grained data partitioning of large inputs
expensive — one of the trade-offs HiDP's DP weighs.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable, Sequence

from .baselines import STRATEGIES, Strategy
from .cost_model import Cluster, CostProvider, Node, comm_time, \
    compute_time, processors_as_resources
from .dag import DataPartition, ModelDAG, ModelPartition
from .hidp import HiDPPlan, sub_dag_for
from .local_partitioner import LocalPlan, dominant_kind
from .objective import Objective


@dataclasses.dataclass
class SimRequest:
    request_id: int
    dag: ModelDAG
    arrival: float
    delta: float = 1.0
    # Per-request planning objective; None inherits the simulator's default.
    objective: Objective | None = None
    # Latency SLO in seconds (None = unconstrained); violations are counted
    # per request in the report, which is how churn-induced retries show up
    # as a serving-quality figure and not just extra latency.
    slo: float | None = None


@dataclasses.dataclass
class ExecutionSpan:
    node: str
    processor: str
    start: float
    end: float
    flops: float
    watts: float
    request_id: int


@dataclasses.dataclass
class RequestRecord:
    request_id: int
    dag_name: str
    arrival: float
    completion: float
    active_energy: float
    mode: str
    # The plan's own predictions, kept so reports can hold the planner to
    # account against what the (possibly diverging) hardware actually did.
    predicted_latency: float = 0.0
    predicted_energy: float = 0.0
    # Churn accounting: how many times a mid-request node failure forced a
    # full re-plan-and-retry, and how many planned shards sat on nodes that
    # had to be abandoned (the work that migrated to survivors).
    retries: int = 0
    migrations: int = 0
    slo: float | None = None

    @property
    def latency(self) -> float:
        return self.completion - self.arrival

    @property
    def slo_violated(self) -> bool:
        return self.slo is not None and self.latency > self.slo


@dataclasses.dataclass
class SimReport:
    records: list[RequestRecord]
    spans: list[ExecutionSpan]
    cluster: Cluster

    # ------------------------------------------------------------- aggregates
    def latencies(self) -> dict[str, float]:
        out: dict[str, list[float]] = {}
        for r in self.records:
            out.setdefault(r.dag_name, []).append(r.latency)
        return {k: sum(v) / len(v) for k, v in out.items()}

    def energies(self) -> dict[str, float]:
        """Per-request energy: active shard energy + cluster idle power over
        the request's latency window (the paper's whole-cluster metering)."""
        idle_w = self._idle_watts()
        out: dict[str, list[float]] = {}
        for r in self.records:
            e = r.active_energy + idle_w * r.latency
            out.setdefault(r.dag_name, []).append(e)
        return {k: sum(v) / len(v) for k, v in out.items()}

    def _idle_watts(self) -> float:
        return sum(p.idle_power for n in self.cluster.nodes
                   for p in n.processors)

    def predicted_energies(self) -> dict[str, float]:
        """Planner-predicted per-request energy, normalized like
        :meth:`energies` (plan energy + cluster idle over the predicted
        latency window) so the two are directly comparable.  Empty dict
        for a run with zero completed requests (aggressive churn traces
        can drain a workload to nothing)."""
        if not self.records:
            return {}
        idle_w = self._idle_watts()
        out: dict[str, list[float]] = {}
        for r in self.records:
            e = r.predicted_energy + idle_w * r.predicted_latency
            out.setdefault(r.dag_name, []).append(e)
        return {k: sum(v) / len(v) for k, v in out.items()}

    def prediction_error(self) -> dict[str, float]:
        """Mean relative |predicted − measured| for latency and energy,
        across all requests — the ground-truth scoreboard a FeedbackLoop's
        drift detection acts on.  Approximate by construction (the plan's
        energy counts participating-node idle inside its own window; the
        measured side meters the whole cluster) but near zero whenever
        execution matches the cost model, and large when the hardware
        diverges.  Empty dict — never a raise, never a fake 0-error
        claim — when the run completed zero requests."""
        if not self.records:
            return {}
        idle_w = self._idle_watts()
        lat_errs, en_errs = [], []
        for r in self.records:
            if r.predicted_latency > 0:
                lat_errs.append(abs(r.predicted_latency - r.latency)
                                / max(r.latency, 1e-12))
            measured = r.active_energy + idle_w * r.latency
            predicted = r.predicted_energy + idle_w * r.predicted_latency
            if predicted > 0:
                en_errs.append(abs(predicted - measured)
                               / max(measured, 1e-12))
        mean = lambda xs: sum(xs) / len(xs) if xs else 0.0  # noqa: E731
        return {"latency": mean(lat_errs), "energy": mean(en_errs)}

    # ---------------------------------------------------- churn accounting
    def total_retries(self) -> int:
        """Mid-request failures retried to completion across all requests."""
        return sum(r.retries for r in self.records)

    def total_migrations(self) -> int:
        """Planned shards abandoned on a failed node and re-planned onto
        survivors."""
        return sum(r.migrations for r in self.records)

    def slo_violations(self) -> int:
        """Requests that finished past their declared SLO (requests with
        no SLO never count)."""
        return sum(1 for r in self.records if r.slo_violated)

    def makespan(self) -> float:
        return max((r.completion for r in self.records), default=0.0)

    def gflops_timeline(self, dt: float = 0.1) -> list[tuple[float, float]]:
        """(t, GFLOP/s) samples — Fig. 6."""
        horizon = self.makespan()
        out = []
        t = 0.0
        while t < horizon + dt:
            g = sum(s.flops / max(s.end - s.start, 1e-9)
                    for s in self.spans if s.start <= t < s.end)
            out.append((t, g / 1e9))
            t += dt
        return out

    def completed_by(self, horizon: float) -> int:
        return sum(1 for r in self.records if r.completion <= horizon)


class EdgeSimulator:
    """``provider`` feeds the *planner* (what the strategy believes about the
    hardware); ``ground_truth`` governs *execution* (what the hardware
    actually does — a ``repro_torch.profiling.SyntheticGroundTruth``, whose
    ``rate_scale`` shifts timing and ``power_scale`` shifts measured watts).
    Leaving both None reproduces the seed behaviour exactly: planning and
    execution share the analytic datasheet model, so predictions are perfect.
    ``feedback`` (a ``repro_torch.profiling.FeedbackLoop``) receives one
    observation per executed compute shard — the run-time scheduler's
    measured latencies *and joules*, so both latency and energy drift are
    caught.  ``objective`` sets the default planning objective for every
    request; a ``SimRequest.objective`` overrides it per request.
    ``plan_cache`` (a ``repro_torch.serving.plan_cache.PlanCache`` over this
    cluster) replaces per-request strategy calls with cached-frontier
    selection — including **mixed-tenant request streams**: every request
    resolves its own ``SimRequest.dag`` against the one shared cache, so
    the first request per (dag fingerprint, δ, calibration version) pays
    the frontier pass and every later one selects in microseconds — each
    request's arrival-time planning overhead reflects whichever path it
    took, so planner amortization (and any eviction churn under a bounded
    cache) shows up in simulated completion times exactly as it would in
    serving.  The cache's *planner config* then owns planning
    (HiDP, and the provider baked into ``cache.planner.config``), so
    combining it with a baseline ``strategy`` or a simulator-level
    ``provider`` is rejected rather than silently mislabelling results.

    ``fleet`` (a ``repro_torch.fleet.FleetController``) makes the cluster
    *churn*: the controller's trace is replayed as simulated time advances
    — graceful events (leave/join/battery/thermal) apply at each request's
    planning boundary, while a ``crash`` fails mid-request.  A failed
    request's doomed work is truncated at the crash instant (survivors'
    partial shards stay on the timeline as wasted-but-metered compute),
    the leader re-elects if it was the casualty
    (``ClusterManager.elect_leader`` via the controller), and the request
    re-plans on the survivors and retries from the crash time —
    ``RequestRecord.retries``/``migrations`` count the damage, and
    ``SimRequest.slo`` lets the report turn it into SLO violations.  With
    a ``plan_cache`` the cache must be membership-keyed
    (``membership_source=fleet``): each new membership costs one frontier
    pass per tenant and a *returning* membership serves warm.  Feedback
    observations from shards that completed before a crash are kept — the
    hardware really did execute them.

    ``telemetry`` (a ``repro_torch.telemetry.TelemetryRecorder``) makes the run
    durable — and causal: each ``sim.request`` span is a trace-tree root
    over its ``sim.attempt`` children (fault-injection retries parent
    under the original request), and each attempt carries per-stage
    ``sim.plan`` / ``sim.queue_wait`` / ``sim.compute`` / ``sim.comm``
    child spans plus whatever the plan cache and fleet emitted while the
    attempt was open — so ``repro_torch.telemetry.trace`` can answer where
    any request's latency went.  Retry/migration/SLO counters are stamped
    with the membership epoch in effect, and the logical clock advances
    with simulated time so every other instrumented subsystem (cache,
    fleet, feedback) timestamps consistently.  A disabled recorder is
    normalized away — the hot path pays a single ``is not None`` check
    (see docs/observability.md).

    ``planning_time`` controls how planner overhead enters *simulated*
    time: the default ``"wall"`` charges each attempt's measured
    ``planning_seconds`` (the paper-faithful accounting — DP overhead
    delays execution, which tab1 measures), while a float pins a fixed
    per-attempt overhead instead.  Pass ``planning_time=0.0`` for
    seeded-replay determinism: wall clocks are the only nondeterminism in
    the pipeline, so pinning this makes two replays byte-identical
    (telemetry's canonical-log contract is gated on exactly that)."""

    def __init__(self, cluster: Cluster, strategy: str | Strategy = "hidp",
                 leader: str | None = None,
                 provider: CostProvider | None = None,
                 ground_truth=None, feedback=None,
                 objective: Objective | None = None,
                 plan_cache=None, fleet=None, telemetry=None,
                 planning_time: float | str = "wall"):
        if fleet is not None and plan_cache is not None:
            ms = plan_cache.membership_source
            if not (ms is fleet or ms is fleet.manager):
                raise ValueError(
                    "a churning fleet with a membership-blind (or "
                    "differently-sourced) plan_cache would serve plans for "
                    "departed nodes; construct the cache with "
                    "membership_source=fleet (or fleet.manager, the same "
                    "object this simulator churns)")
        if plan_cache is not None:
            if not (strategy == "hidp" or strategy is STRATEGIES["hidp"]):
                raise ValueError(
                    "plan_cache replaces per-request planning with the "
                    "cache's own HiDPPlanner; it cannot simulate strategy "
                    f"{strategy!r} — drop plan_cache or use strategy='hidp'")
            if provider is not None:
                raise ValueError(
                    "plan_cache ignores the simulator-level provider; set "
                    "the provider on the cache's PlannerConfig instead")
        self.cluster = cluster
        self.strategy: Strategy = (STRATEGIES[strategy]
                                   if isinstance(strategy, str) else strategy)
        self.fleet = fleet
        if fleet is not None:
            self.leader = leader or fleet.manager.leader \
                or cluster.nodes[0].name
            fleet.elect_leader(self.leader)
        else:
            self.leader = leader or cluster.nodes[0].name
        self.provider = provider
        self.ground_truth = ground_truth
        self.feedback = feedback
        self.objective = objective
        self.plan_cache = plan_cache
        if planning_time != "wall":
            planning_time = float(planning_time)
            if planning_time < 0:
                raise ValueError("planning_time must be 'wall' or >= 0")
        self.planning_time = planning_time
        from repro_torch.telemetry import active as _tel_active
        self.telemetry = _tel_active(telemetry)
        self.leader_elections = 0
        # capacity-1 resources
        self.proc_busy: dict[tuple[str, str], float] = {}
        self.medium_busy: float = 0.0
        self.medium_spans: list[tuple[float, float]] = []
        self.radio_energy: float = 0.0
        self.spans: list[ExecutionSpan] = []
        # measurements buffered per attempt; see _observe
        self._pending_obs: list[tuple] = []

    # ----------------------------------------------------------- reservations
    def _reserve_proc(self, node: str, proc: str, ready: float,
                      duration: float, flops: float, watts: float,
                      rid: int) -> float:
        key = (node, proc)
        start = max(ready, self.proc_busy.get(key, 0.0))
        end = start + duration
        self.proc_busy[key] = end
        self.spans.append(ExecutionSpan(node, proc, start, end, flops,
                                        watts, rid))
        return end

    RADIO_POWER = 4.0          # W burned at the endpoints during a transfer

    def _reserve_medium(self, ready: float, nbytes: float, bw: float,
                        rtt: float) -> float:
        start = max(ready, self.medium_busy)
        end = start + comm_time(nbytes, bw, rtt)
        self.medium_busy = end
        self.medium_spans.append((start, end))
        self.radio_energy += self.RADIO_POWER * (end - start)
        tel = self.telemetry
        if tel is not None:
            # children of the open sim.attempt context: contention on the
            # shared half-duplex medium, then the transfer itself
            if start - ready > 1e-12:
                tel.child_span("sim.queue_wait", start - ready, t=ready,
                               resource="medium")
            tel.child_span("sim.comm", end - start, t=start,
                           resource="medium", bytes=nbytes)
        return end

    # ------------------------------------------------------- local execution
    def _compute_seconds(self, node: Node, proc_idx: int, flops: float,
                         analytic_rate: float, kind: str, delta: float
                         ) -> float:
        """Seconds a shard actually takes: analytic (seed path) unless a
        ground truth overrides the datasheet."""
        if self.ground_truth is None:
            return compute_time(flops, analytic_rate)
        return self.ground_truth.compute_seconds(
            node.name, node.processors[proc_idx].name, flops, kind, delta)

    def _active_watts(self, node: Node, proc_idx: int) -> float:
        """Watts a shard actually draws: datasheet unless the ground truth
        declares a diverging power model."""
        proc = node.processors[proc_idx]
        gt = self.ground_truth
        if gt is not None and hasattr(gt, "active_watts"):
            return gt.active_watts(node.name, proc.name)
        return proc.active_power

    def _observe(self, node: Node, proc_idx: int, flops: float,
                 nbytes: float, kind: str, delta: float,
                 measured: float, joules: float, end: float) -> None:
        """Buffer one executed shard's measurement (run-time scheduler
        measurements re-entering the Model Analyzer).  Buffered rather
        than reported immediately because the attempt's fate decides what
        the loop may see: a crashed attempt only produced real
        measurements for shards that *completed* before the crash instant
        — everything later is unwound and must never become a phantom
        observation (or be double-counted by the retry)."""
        if self.feedback is not None and flops > 0:
            key = f"{node.name}/{node.processors[proc_idx].name}"
            self._pending_obs.append(
                (end, key, kind, flops * delta, nbytes, measured, joules))

    def _flush_observations(self, up_to: float | None = None) -> None:
        """Report buffered measurements to the feedback loop — all of
        them, or (after a crash) only shards that finished by ``up_to``."""
        for end, key, kind, work, nbytes, measured, joules \
                in self._pending_obs:
            if up_to is None or end <= up_to + 1e-12:
                self.feedback.observe(
                    key, kind, work, nbytes, measured,
                    energy_j=joules if joules > 0 else None)
        self._pending_obs = []

    def _run_local(self, sub: ModelDAG, node: Node, lp: LocalPlan,
                   ready: float, delta: float, rid: int
                   ) -> tuple[float, float]:
        """Execute a node's share per its local plan. Returns (done, energy)."""
        kind = dominant_kind(sub)
        resources = processors_as_resources(node, delta, kind)
        energy = 0.0
        part = lp.partition
        tel = self.telemetry
        if isinstance(part, ModelPartition):
            t = ready
            for si in range(part.num_stages):
                a, b = part.boundaries[si], part.boundaries[si + 1]
                seg = sub.segment(a, b)
                ri = part.assignment[si]
                r = resources[ri]
                compute = self._compute_seconds(node, ri, seg.flops, r.rate,
                                                kind, delta)
                watts = self._active_watts(node, ri)
                comm = comm_time(seg.bytes_in, r.bw, r.rtt)
                dur = comm + compute
                proc = node.processors[ri].name
                t0 = t
                t = self._reserve_proc(node.name, proc, t, dur, seg.flops,
                                       watts, rid)
                if tel is not None:
                    self._emit_stage(tel, node.name, proc, rid, t0, t - dur,
                                     comm, compute, seg.bytes_in)
                energy += watts * dur
                self._observe(node, ri, seg.flops, seg.bytes_in, kind, delta,
                              compute, watts * compute, end=t)
            return t, energy
        assert isinstance(part, DataPartition)
        done = ready
        for f, ri in zip(part.fractions, part.assignment):
            r = resources[ri]
            compute = self._compute_seconds(node, ri, sub.total_flops * f,
                                            r.rate, kind, delta)
            watts = self._active_watts(node, ri)
            comm = comm_time((sub.input_bytes + sub.output_bytes) * f,
                             r.bw, r.rtt)
            dur = comm + compute
            proc = node.processors[ri].name
            end = self._reserve_proc(node.name, proc, ready, dur,
                                     sub.total_flops * f, watts, rid)
            if tel is not None:
                self._emit_stage(tel, node.name, proc, rid, ready,
                                 end - dur, comm, compute,
                                 (sub.input_bytes + sub.output_bytes) * f)
            energy += watts * dur
            self._observe(node, ri, sub.total_flops * f,
                          (sub.input_bytes + sub.output_bytes) * f, kind,
                          delta, compute, watts * compute, end=end)
            done = max(done, end)
        return done, energy

    def _emit_stage(self, tel, node: str, proc: str, rid: int,
                    ready: float, start: float, comm: float,
                    compute: float, nbytes: float) -> None:
        """Per-stage trace children under the open ``sim.attempt``:
        processor contention (queue-wait), the intra-node input transfer
        (its bus shares the processor reservation), and the compute
        shard itself — the spans critical paths and per-node utilization
        are computed from."""
        if start - ready > 1e-12:
            tel.child_span("sim.queue_wait", start - ready, t=ready,
                           resource=f"{node}/{proc}", request=rid)
        if comm > 0:
            tel.child_span("sim.comm", comm, t=start, request=rid,
                           resource=f"{node}/{proc}", bytes=nbytes)
        tel.child_span("sim.compute", compute, t=start + comm,
                       node=node, proc=proc, request=rid)

    # ----------------------------------------------------------- one request
    def _plan_for(self, req: SimRequest,
                  objective: Objective | None) -> HiDPPlan:
        """One planning pass at the current membership: through the
        (membership-keyed) cache when wired, else a strategy call against
        the live cluster."""
        if self.plan_cache is not None:
            return self.plan_cache.get(req.dag, objective=objective,
                                       delta=req.delta)
        kwargs = {}
        if self.provider is not None:
            kwargs["provider"] = self.provider
        if objective is not None:
            kwargs["objective"] = objective
        cluster = (self.fleet.cluster if self.fleet is not None
                   else self.cluster)
        return self.strategy(req.dag, cluster, req.delta, **kwargs)

    # ------------------------------------------------- fault-injection state
    def _snapshot(self) -> tuple:
        return (dict(self.proc_busy), self.medium_busy, self.radio_energy,
                len(self.spans), len(self.medium_spans))

    def _rollback_to_crash(self, snap: tuple, crash_t: float) -> float:
        """Truncate a doomed attempt at the crash instant.  Work started
        before the crash stays on the timeline (survivors were genuinely
        busy executing shards that are now worthless — FLOPs pro-rated to
        the truncated window, watts metered in full, and transfers billed
        for their actual pre-crash airtime); everything scheduled past it
        is unwound so the retry sees the resources free.  Returns the
        wasted active energy, which the request still pays for."""
        proc_busy, medium_busy, radio_energy, nspans, nmedium = snap
        attempt = self.spans[nspans:]
        del self.spans[nspans:]
        self.proc_busy = proc_busy
        # radio: re-bill only the airtime the attempt actually burned
        # before the crash — per reservation, never idle gaps
        medium_attempt = self.medium_spans[nmedium:]
        del self.medium_spans[nmedium:]
        self.medium_busy = medium_busy
        self.radio_energy = radio_energy
        wasted = 0.0
        for m_start, m_end in medium_attempt:
            if m_start >= crash_t:
                continue
            m_end = min(m_end, crash_t)
            self.medium_spans.append((m_start, m_end))
            self.medium_busy = max(self.medium_busy, m_end)
            burned = self.RADIO_POWER * (m_end - m_start)
            self.radio_energy += burned
            wasted += burned
        for s in attempt:
            if s.start >= crash_t:
                continue
            end = min(s.end, crash_t)
            frac = (end - s.start) / max(s.end - s.start, 1e-12)
            self.spans.append(dataclasses.replace(s, end=end,
                                                  flops=s.flops * frac))
            key = (s.node, s.processor)
            self.proc_busy[key] = max(self.proc_busy.get(key, 0.0), end)
            wasted += s.watts * (end - s.start)
        return wasted

    def _sync_leader(self) -> None:
        """Adopt the controller's leader (it re-elects whenever the sitting
        leader goes unavailable — Alg. 1 line 2 under churn)."""
        if self.fleet is None:
            return
        leader = self.fleet.manager.leader
        if leader is not None and leader != self.leader:
            self.leader = leader
            self.leader_elections += 1

    def _epoch(self) -> int | None:
        """The membership epoch in effect (None for a static fleet) —
        what telemetry events are stamped with."""
        return self.fleet.epoch if self.fleet is not None else None

    def _run_request(self, req: SimRequest) -> RequestRecord:
        objective = req.objective or self.objective
        tel = self.telemetry
        if tel is not None:
            tel.advance(req.arrival)
        # the request's trace-tree root: attempts, per-stage shards, plan
        # cache activity, and fleet epochs it triggered all parent under it
        with (tel.trace("sim.request", t=req.arrival, tenant=req.dag.name,
                        request=req.request_id) if tel is not None
              else contextlib.nullcontext()) as req_h:
            if self.fleet is not None:
                # graceful events (leave/join/battery/thermal) land at the
                # planning boundary; crashes are handled mid-request below
                self.fleet.advance(req.arrival)
                self._sync_leader()
            start = req.arrival
            total_energy = 0.0
            retries = migrations = 0
            while True:
                crash = None
                with (tel.trace("sim.attempt", t=start,
                                tenant=req.dag.name,
                                request=req.request_id)
                      if tel is not None
                      else contextlib.nullcontext()) as att_h:
                    plan = self._plan_for(req, objective)
                    snap = self._snapshot()
                    overhead = (plan.planning_seconds
                                if self.planning_time == "wall"
                                else self.planning_time)
                    if tel is not None:
                        # planning overhead as charged into domain time
                        tel.child_span("sim.plan", overhead, t=start,
                                       tenant=req.dag.name,
                                       request=req.request_id)
                    t, energy = self._execute_plan(req, plan,
                                                   start + overhead)
                    if self.fleet is not None:
                        used = {a.node.name
                                for a in plan.global_plan.assignments}
                        used.add(self.leader)
                        crash = self.fleet.next_failure(start, t, used)
                    if crash is None:
                        total_energy += energy
                        self._flush_observations()
                        if tel is not None:
                            tel.advance(t)
                            att_h.set(t - start, epoch=self._epoch(),
                                      ok=True)
                    else:
                        # mid-request failure: truncate the doomed attempt,
                        # consume the trace through the crash (one
                        # coalesced membership epoch), re-elect if the
                        # leader fell, re-plan on survivors, retry; only
                        # shards that really finished before the crash
                        # reach the feedback loop
                        self._flush_observations(up_to=crash.time)
                        total_energy += self._rollback_to_crash(snap,
                                                                crash.time)
                        self.fleet.advance(crash.time)
                        migrated = sum(
                            1 for a in plan.global_plan.assignments
                            if not self.fleet.manager.node(
                                a.node.name).available)
                        migrations += migrated
                        retries += 1
                        self._sync_leader()
                        if tel is not None:
                            tel.advance(crash.time)
                            att_h.set(crash.time - start,
                                      epoch=self._epoch(), ok=False,
                                      crashed=crash.node)
                if crash is None:
                    break
                # retry accounting parents under the *request*, not the
                # closed attempt — a retry is the request's fate
                if tel is not None:
                    tel.counter("sim.retry", t=crash.time,
                                tenant=req.dag.name, epoch=self._epoch(),
                                request=req.request_id, crashed=crash.node)
                    if migrated:
                        tel.counter("sim.migration", migrated,
                                    t=crash.time, tenant=req.dag.name,
                                    epoch=self._epoch(),
                                    request=req.request_id)
                if self.fleet.manager.first_available() is None:
                    raise RuntimeError(
                        f"request {req.request_id}: every node failed; "
                        "nothing left to retry on")
                start = crash.time
            rec = RequestRecord(request_id=req.request_id,
                                dag_name=req.dag.name,
                                arrival=req.arrival, completion=t,
                                active_energy=total_energy,
                                mode=plan.global_plan.mode,
                                predicted_latency=plan.predicted_latency,
                                predicted_energy=plan.predicted_energy,
                                retries=retries, migrations=migrations,
                                slo=req.slo)
            if tel is not None:
                req_h.set(rec.latency, epoch=self._epoch(), mode=rec.mode,
                          retries=retries, migrations=migrations,
                          slo_violated=rec.slo_violated,
                          active_energy_j=rec.active_energy,
                          predicted_latency_s=rec.predicted_latency,
                          predicted_energy_j=rec.predicted_energy)
                if rec.slo_violated:
                    tel.counter("sim.slo_violation", t=rec.completion,
                                tenant=req.dag.name, epoch=self._epoch(),
                                request=req.request_id)
                tel.gauge("sim.energy", rec.active_energy,
                          t=rec.completion, tenant=req.dag.name,
                          epoch=self._epoch(), request=req.request_id)
        return rec

    def _execute_plan(self, req: SimRequest, plan: HiDPPlan,
                      t: float) -> tuple[float, float]:
        """Execute one planned attempt starting at ``t`` (post-planning).
        Returns (completion time, active energy incl. radio)."""
        gp = plan.global_plan
        energy = 0.0
        radio0 = self.radio_energy
        if gp.mode == "model":
            # sequential pipeline: activation hops over the shared medium
            for a, lp in zip(gp.assignments, plan.local_plans):
                sd = sub_dag_for(req.dag, a)
                if a.node.name != self.leader or a.stage_index > 0:
                    t = self._reserve_medium(t, sd.input_bytes,
                                             a.node.net_bw, 2e-3)
                t, e = self._run_local(sd, a.node, lp, t, req.delta,
                                       req.request_id)
                energy += e
            last = gp.assignments[-1].node
            if last.name != self.leader:
                t = self._reserve_medium(t, req.dag.output_bytes,
                                         last.net_bw, 2e-3)
        else:
            # scatter inputs → parallel local execution → gather outputs
            shards = [(a, lp, sub_dag_for(req.dag, a))
                      for a, lp in zip(gp.assignments, plan.local_plans)]
            readies = []
            for a, lp, sd in shards:                      # scatter phase
                if a.node.name != self.leader:
                    readies.append(self._reserve_medium(
                        t, sd.input_bytes, a.node.net_bw, 2e-3))
                else:
                    readies.append(t)
            ends = []
            for (a, lp, sd), ready in zip(shards, readies):   # compute phase
                end, e = self._run_local(sd, a.node, lp, ready, req.delta,
                                         req.request_id)
                ends.append(end)
                energy += e
            done_times = []                               # gather phase
            for (a, lp, sd), end in sorted(zip(shards, ends),
                                           key=lambda p: p[1]):
                if a.node.name != self.leader:
                    end = self._reserve_medium(end, sd.output_bytes,
                                               a.node.net_bw, 2e-3)
                done_times.append(end)
            t = max(done_times)
            if plan.extra_comm_bytes:
                # strategy-specific per-layer exchange (MoDNN halos) occupies
                # the medium during execution and gates completion
                t = max(t, self._reserve_medium(
                    max(readies), plan.extra_comm_bytes,
                    self.cluster.nodes[0].net_bw, 0.0))
            t += plan.extra_latency
        energy += self.radio_energy - radio0
        return t, energy

    # ------------------------------------------------------------------ drive
    def run(self, requests: Sequence[SimRequest]) -> SimReport:
        records = [self._run_request(r)
                   for r in sorted(requests, key=lambda r: r.arrival)]
        return SimReport(records=records, spans=self.spans,
                         cluster=self.cluster)


def simulate(cluster: Cluster, strategy: str | Strategy,
             workload: Iterable[tuple[float, ModelDAG, float]],
             *, provider: CostProvider | None = None,
             ground_truth=None, feedback=None,
             objective: Objective | None = None,
             plan_cache=None, fleet=None, telemetry=None,
             planning_time: float | str = "wall") -> SimReport:
    sim = EdgeSimulator(cluster, strategy, provider=provider,
                        ground_truth=ground_truth, feedback=feedback,
                        objective=objective, plan_cache=plan_cache,
                        fleet=fleet, telemetry=telemetry,
                        planning_time=planning_time)
    reqs = [SimRequest(i, dag, t, delta)
            for i, (t, dag, delta) in enumerate(workload)]
    return sim.run(reqs)
