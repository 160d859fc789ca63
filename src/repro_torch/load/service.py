"""The port's copy of ``repro.load.service``.

Service models — what one admitted request costs the cluster.

The open-loop harness (:mod:`repro_torch.load.harness`) needs exactly one
number per tenant: the seconds a request of that tenant occupies a
service lane.  Two providers:

* :class:`FixedServiceModel` — a literal table.  The unit-test and
  property-test workhorse: queueing invariants (conservation, FIFO,
  fairness, determinism) are independent of where service times come
  from.
* :class:`PlanServiceModel` — the production path: service times are the
  planner's own ``predicted_latency``, resolved through the shared
  multi-tenant :class:`~repro_torch.serving.plan_cache.PlanCache`.  Because the
  cache is membership-keyed, *churn re-prices service*: when a
  ``FleetController`` epoch changes the availability mask, the next
  resolution per tenant is that tenant's single frontier pass for the new
  membership (a warm hit for a returning one) — the
  one-frontier-pass-per-tenant-per-epoch invariant, counter-verified via
  ``PlanCache.stats()``.  The harness calls :meth:`begin_epoch` at each
  membership epoch; between epochs every ``service_time`` call is a local
  memo read, so a 10⁵-request run prices requests in O(tenants × epochs)
  planner work, not O(requests).

Planner overhead never enters the open-loop timeline: the cache amortizes
it to microseconds (tab1 measures it), and charging wall-clock would
break the seeded-replay byte-identity the telemetry contract gates.
"""

from __future__ import annotations

from typing import Mapping


class FixedServiceModel:
    """A fixed tenant → service-seconds table."""

    def __init__(self, times: Mapping[str, float]):
        for name, s in times.items():
            if s <= 0:
                raise ValueError(f"service time for {name!r} must be "
                                 f"positive, got {s}")
        self.times = dict(times)

    def begin_epoch(self, epoch: int | None = None) -> None:
        """Membership epochs do not re-price a fixed table."""

    def service_time(self, tenant: str) -> float:
        return self.times[tenant]

    def __repr__(self) -> str:
        return f"FixedServiceModel({self.times})"


class PlanServiceModel:
    """Service times resolved from the (membership-keyed) plan cache.

    ``specs`` maps tenant name → an object with ``dag`` (the tenant's
    ModelDAG), ``delta`` (compute intensity) and optionally ``objective``
    — a :class:`~repro_torch.load.harness.TenantSpec` fits.  Resolutions are
    memoized until :meth:`begin_epoch` clears the memo, so the cache (and
    its hit/miss counters) sees exactly one ``get`` per tenant per epoch.

    Attributes:
        cache: the :class:`~repro_torch.serving.plan_cache.PlanCache` resolved
            through (wire its ``membership_source`` to the same
            ``FleetController`` the harness advances).
        resolutions: lifetime ``cache.get`` calls — O(tenants × epochs),
            never O(requests).
    """

    def __init__(self, cache, specs: Mapping[str, object]):
        for name, spec in specs.items():
            if getattr(spec, "dag", None) is None:
                raise ValueError(
                    f"tenant {name!r} has no dag: PlanServiceModel prices "
                    "tenants by planning them — give TenantSpec a dag, or "
                    "use FixedServiceModel")
        self.cache = cache
        self.specs = dict(specs)
        self.resolutions = 0
        self._memo: dict[str, float] = {}

    def begin_epoch(self, epoch: int | None = None) -> None:
        """The membership moved: forget memoized prices so each tenant's
        next ``service_time`` re-resolves against the new mask (one
        cache ``get`` per tenant — a frontier pass only if this
        membership was never planned before)."""
        self._memo.clear()

    def service_time(self, tenant: str) -> float:
        s = self._memo.get(tenant)
        if s is None:
            spec = self.specs[tenant]
            plan = self.cache.get(
                spec.dag, objective=getattr(spec, "objective", None),
                delta=getattr(spec, "delta", None))
            self.resolutions += 1
            s = float(plan.predicted_latency)
            if s <= 0:
                raise ValueError(f"plan for tenant {tenant!r} predicts "
                                 f"non-positive latency {s}")
            self._memo[tenant] = s
        return s

    def __repr__(self) -> str:
        return (f"PlanServiceModel({len(self.specs)} tenants, "
                f"{self.resolutions} resolutions)")
