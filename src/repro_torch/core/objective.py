"""The port's copy of ``repro.core.objective``.

Planning objectives — what the DP partitioners minimize.

The paper's headline is not only 38% lower latency but **46% lower energy**
(§IV, Fig. 5), and CoEdge-style formulations show that energy-aware workload
partitioning *under a latency constraint* is the right shape for
heterogeneous edge clusters.  This module makes that choice explicit: every
planner entry point accepts an :class:`Objective` describing the scalar the
search minimizes.

Three metrics:

* ``latency`` — the seed behaviour (and the default): minimize end-to-end
  inference latency.  Bit-identical to planning before objectives existed.
* ``energy``  — minimize predicted energy-to-solution (active while busy,
  idle for the rest of the makespan — the algebra of
  ``dp_partitioner.predicted_energy``), optionally subject to
  ``latency_budget``.
* ``edp``     — minimize the energy-delay product ``E × T`` (equal weight to
  both; the classic low-power systems scalarization), optionally subject to
  ``latency_budget``.

``latency_budget`` turns the search constrained: plans within the budget are
always preferred over plans outside it; among infeasible plans the fastest
wins (drive toward feasibility), among feasible ones the metric decides.

``radio_power`` lets the planner price what the edge testbed actually
measures: the simulator charges ``EdgeSimulator.RADIO_POWER`` watts at the
endpoints of every wireless transfer, an energy term the datasheet algebra
does not see.  It defaults to 0 so the default objective reproduces the seed
numerics exactly; energy-aware callers set it to the radio's transmit power
(4 W for the paper's testbed) so data-partitioning across many nodes pays
its true communication energy.
"""

from __future__ import annotations

import dataclasses

METRICS = ("latency", "energy", "edp")


@dataclasses.dataclass(frozen=True)
class Objective:
    """What a planning pass minimizes.

    Attributes:
        metric: ``"latency"`` | ``"energy"`` | ``"edp"``.
        latency_budget: optional hard latency cap in seconds.  Feasible
            plans (latency ≤ budget) always beat infeasible ones; among
            infeasible plans lower latency wins so the search converges
            toward feasibility.
        radio_power: watts charged on wireless transfer seconds when
            pricing a plan's energy (0 = seed algebra, no radio term).
    """

    metric: str = "latency"
    latency_budget: float | None = None
    radio_power: float = 0.0

    def __post_init__(self):
        if self.metric not in METRICS:
            raise ValueError(
                f"unknown objective metric {self.metric!r}; "
                f"expected one of {METRICS}")
        if self.latency_budget is not None and self.latency_budget <= 0:
            raise ValueError("latency_budget must be positive")

    # ------------------------------------------------------------ properties
    @property
    def is_latency(self) -> bool:
        """True when the search reduces to the seed's latency-only DP."""
        return self.metric == "latency" and self.latency_budget is None

    def unconstrained(self) -> "Objective":
        """The same metric without the latency budget."""
        if self.latency_budget is None:
            return self
        return dataclasses.replace(self, latency_budget=None)

    def local(self) -> "Objective":
        """The objective as the *local* tier should see it: the same metric
        and budget, but no radio term — intra-node transfers are DRAM
        copies, not wireless.  A latency budget is kept as-is; the
        hierarchical planner replaces it with the node's decomposed share
        (see ``hidp._local_objective``) before planning locally."""
        if self.radio_power == 0.0:
            return self
        return dataclasses.replace(self, radio_power=0.0)

    # ------------------------------------------------------------ comparison
    def key(self, latency: float, energy: float) -> tuple:
        """Total order over (latency, energy) plan outcomes — smaller wins.

        The leading element is budget feasibility; the trailing elements
        break ties deterministically (``edp`` ties fall to lower energy,
        then lower latency — saving joules at equal E×T is free).
        """
        feasible = (self.latency_budget is None
                    or latency <= self.latency_budget)
        if not feasible:
            return (1, latency, energy, 0.0)
        if self.metric == "latency":
            return (0, latency, energy, 0.0)
        if self.metric == "energy":
            return (0, energy, latency, 0.0)
        return (0, latency * energy, energy, latency)        # edp

    def better(self, lat_a: float, en_a: float,
               lat_b: float, en_b: float) -> bool:
        """True iff outcome *a* is strictly better than outcome *b*."""
        return self.key(lat_a, en_a) < self.key(lat_b, en_b)

    def at_least_as_good(self, lat_a: float, en_a: float,
                         lat_b: float, en_b: float) -> bool:
        """Non-strict comparison — preserves the seed's model-over-data
        tie-breaking in ``dp_partitioner.partition``."""
        return self.key(lat_a, en_a) <= self.key(lat_b, en_b)

    # --------------------------------------------------------------- parsing
    @classmethod
    def parse(cls, spec: str, *, latency_budget: float | None = None,
              radio_power: float = 0.0) -> "Objective":
        """Build from a CLI-style spec: ``"energy"``, ``"edp@0.5"`` (metric @
        latency budget in seconds)."""
        metric, _, budget = spec.partition("@")
        return cls(metric=metric.strip(),
                   latency_budget=float(budget) if budget else latency_budget,
                   radio_power=radio_power)


LATENCY = Objective()


def resolve_objective(objective: Objective | None) -> Objective:
    """None → the default latency objective (the seed behaviour)."""
    return LATENCY if objective is None else objective
