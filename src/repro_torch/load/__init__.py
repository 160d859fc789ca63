"""The port's copy of ``repro.load``: open-loop, fleet-scale load
generation and queueing.

HiDP's own evaluation (Figs. 7/8) replays a *closed* request list and
measures makespan; real serving is *open-loop*: arrivals keep coming
whether or not the cluster keeps up, and the interesting regime is the
queueing behaviour around saturation (the throughput-maximization line of
work — Parthasarathy & Krishnamachari, arXiv:2210.12219 / 2304.11941).
This package supplies that missing layer:

* :mod:`repro_torch.load.traces` — seeded, replayable **arrival traces**
  (Poisson, diurnal, burst/MMPP) as immutable numpy arrays, the same
  idiom as ``repro_torch.fleet.traces`` for availability events;
* :mod:`repro_torch.load.service` — **service models** mapping a tenant to
  the seconds one of its requests occupies the cluster: fixed tables for
  tests, and :class:`~repro_torch.load.service.PlanServiceModel`, which
  resolves through the membership-keyed ``PlanCache`` (one frontier pass
  per tenant per membership epoch — churn re-prices service);
* :mod:`repro_torch.load.harness` — the **open-loop queueing harness**:
  bounded queues with arrival-time rejection (admission control),
  SLO-aware priority classes, weighted deficit round-robin fairness
  across tenants, dispatch-time shedding (backpressure), and per-decision
  telemetry (``load.admit`` / ``load.reject`` / ``load.shed`` counters,
  ``load.queue_wait`` spans, epoch-stamped);
* :mod:`repro_torch.load.saturation` — offered-load **sweeps** producing
  the saturation-curve variants of fig7/fig8: p50/p99 latency, SLO-violation
  rate, rejects and sheds vs offered load, with or without a composed
  churn trace.

See docs/load.md for the arrival-model taxonomy, the queue lifecycle, and
the saturation-curve how-to.
"""

from .harness import (LoadConfig, LoadReport, OpenLoopHarness,  # noqa: F401
                      TenantSpec)
from .saturation import (SaturationPoint, mix_capacity,  # noqa: F401
                         saturation_sweep)
from .service import FixedServiceModel, PlanServiceModel  # noqa: F401
from .traces import ArrivalTrace  # noqa: F401

__all__ = [
    "ArrivalTrace",
    "FixedServiceModel",
    "PlanServiceModel",
    "TenantSpec",
    "LoadConfig",
    "LoadReport",
    "OpenLoopHarness",
    "SaturationPoint",
    "saturation_sweep",
    "mix_capacity",
]
