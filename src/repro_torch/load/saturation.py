"""The port's copy of ``repro.load.saturation``.

Saturation sweeps — the open-loop variants of fig7/fig8.

A sweep replays *one* seeded arrival trace at a ladder of offered-load
factors (:meth:`~repro_torch.load.traces.ArrivalTrace.scaled` — time
compression, so every load level sees the identical arrival sequence) and
runs each through the queueing harness.  The resulting curve is the
classic open-loop saturation story:

* below the knee — throughput tracks offered load, p99 flat, no sheds;
* at the knee (offered ≈ :func:`mix_capacity`) — queues build, p99 lifts;
* above it — throughput plateaus at capacity, and with admission control
  + shedding the *excess* shows up as rejects/sheds while the traffic
  that is served keeps meeting its SLO.

The JAX package's ``benchmarks/fig9_saturation.py`` draws these curves
(with and without a composed churn trace) and exit-code-gates the shape;
docs/load.md walks through reading them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Sequence

from .harness import LoadConfig, LoadReport, OpenLoopHarness, TenantSpec
from .traces import ArrivalTrace


@dataclasses.dataclass(frozen=True)
class SaturationPoint:
    """One offered-load level of a sweep.

    Attributes:
        factor: the time-compression factor applied to the base trace.
        offered: offered arrivals/second at this level.
        report: the full per-request :class:`LoadReport`.
    """

    factor: float
    offered: float
    report: LoadReport

    @property
    def throughput(self) -> float:
        return self.report.throughput()

    @property
    def p50(self) -> float:
        return self.report.percentile(50)

    @property
    def p99(self) -> float:
        return self.report.percentile(99)

    @property
    def goodput(self) -> float:
        """Completions *within SLO* per second over the horizon."""
        r = self.report
        h = max(r.trace.horizon, 1e-12)
        return (r.completed - r.slo_violations()) / h

    @property
    def loss_rate(self) -> float:
        """Fraction of arrivals turned away (rejected or shed)."""
        r = self.report
        return (r.rejected + r.shed) / max(r.arrived, 1)

    def row(self) -> dict[str, float]:
        """A flat dict for tables / telemetry gauges."""
        r = self.report
        return {
            "factor": self.factor,
            "offered": self.offered,
            "throughput": self.throughput,
            "goodput": self.goodput,
            "p50": self.p50,
            "p99": self.p99,
            "arrived": float(r.arrived),
            "completed": float(r.completed),
            "rejected": float(r.rejected),
            "shed": float(r.shed),
            "slo_violation_rate": (0.0 if r.completed == 0
                                   else r.slo_violation_rate()),
            "loss_rate": self.loss_rate,
        }


def mix_capacity(service_times: Mapping[str, float],
                 rates: Mapping[str, float], *, servers: int = 1) -> float:
    """The cluster's saturation throughput (requests/second) for a tenant
    mix: with mean service time ``s̄ = Σ pᵢ·sᵢ`` under the mix's arrival
    proportions ``pᵢ``, ``servers / s̄``.  The anchor for the no-shedding
    plateau; when shedding biases the *served* mix toward cheap tenants,
    throughput in requests/s can legitimately sit above this line — gate
    on :meth:`LoadReport.utilization` (≤ 1 always) in that regime."""
    total = sum(rates.values())
    if total <= 0:
        return math.inf
    mean = sum(service_times[n] * (r / total) for n, r in rates.items())
    return servers / mean if mean > 0 else math.inf


def saturation_sweep(trace: ArrivalTrace,
                     specs: Mapping[str, TenantSpec] | Sequence[TenantSpec],
                     service_model,
                     factors: Sequence[float],
                     config: LoadConfig = LoadConfig(), *,
                     fleet_factory: Callable[[], object] | None = None,
                     telemetry=None) -> list[SaturationPoint]:
    """Run ``trace.scaled(f)`` through the harness for each factor.

    ``fleet_factory`` (not a shared instance — a ``FleetController`` is
    stateful and each load level must replay churn from epoch 0) builds a
    fresh fleet per level; None sweeps a static cluster.  Points come
    back in ``factors`` order.
    """
    points = []
    for f in factors:
        scaled = trace.scaled(f)
        fleet = fleet_factory() if fleet_factory is not None else None
        harness = OpenLoopHarness(scaled, specs, service_model, config,
                                  fleet=fleet, telemetry=telemetry)
        report = harness.run()
        points.append(SaturationPoint(factor=float(f),
                                      offered=scaled.offered_rate(),
                                      report=report))
    return points
