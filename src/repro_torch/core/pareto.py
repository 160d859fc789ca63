"""The port's copy of ``repro.core.pareto``.

Pareto-frontier plan sets — the planner's first-class output.

Energy is a planning objective, but every ``(objective, budget)``
variation still paid a full two-tier DP pass.  The pair-(latency, energy) DP
already tracks a frontier internally; this module surfaces it: a planning
pass now returns a :class:`ParetoFront` of plans covering the whole
latency–energy trade-off, and an :class:`~repro_torch.core.objective.Objective`
becomes a *selector* over that front (feasible-first under
``latency_budget``, then metric-optimal) instead of a scalarizer baked into
the DP.  Plan the frontier once per ``(cluster, calibration, dag)``, then
serve any objective from cache (``repro_torch.serving.plan_cache.PlanCache``)
until a drift event invalidates it — the CoEdge/DEFER amortization the
paper's ~15 ms per-request overhead otherwise forfeits.

Invariants every :class:`ParetoFront` maintains:

* points are sorted by latency ascending, energy strictly decreasing —
  no point is dominated by another (lower-or-equal latency *and* energy);
* on exact ``(latency, energy)`` ties the earliest-inserted candidate wins,
  so callers can splice a canonical plan (the seed scalar-DP latency
  optimum) ahead of DP-discovered duplicates and guarantee it survives;
* ``select`` is deterministic: ``Objective.key`` totally orders the points
  and ties fall to the lower-latency (earlier) point.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Iterator, Sequence

from .objective import Objective, resolve_objective

# Callers cap per-cell DP frontiers (and composed fronts) at this many
# points; interior points with the smallest latency gap are thinned first,
# so the endpoints — latency-optimal and energy-optimal — always survive.
DEFAULT_FRONT_WIDTH = 16


@dataclasses.dataclass(frozen=True)
class ParetoPoint:
    """One non-dominated plan with its (latency, energy) price."""

    latency: float
    energy: float
    plan: Any

    def key(self, objective: Objective) -> tuple:
        return objective.key(self.latency, self.energy)

    def dominates(self, other: "ParetoPoint") -> bool:
        """Weak dominance: no worse on both axes, strictly better on one."""
        return (self.latency <= other.latency and self.energy <= other.energy
                and (self.latency < other.latency
                     or self.energy < other.energy))

    # -------------------------------------------------------- serialization
    def to_dict(self, encode_plan: Callable[[Any], Any] = lambda p: p
                ) -> dict:
        """A JSON-able view; ``encode_plan`` serializes the plan payload
        (e.g. ``repro_torch.core.hidp.plan_to_dict`` for :class:`HiDPPlan`)."""
        return {"latency": self.latency, "energy": self.energy,
                "plan": encode_plan(self.plan)}

    @classmethod
    def from_dict(cls, d: dict,
                  decode_plan: Callable[[Any], Any] = lambda p: p
                  ) -> "ParetoPoint":
        return cls(latency=d["latency"], energy=d["energy"],
                   plan=decode_plan(d["plan"]))


class ParetoFront:
    """An immutable, sorted, non-dominated set of plans.

    Construct with :meth:`build` (which prunes dominated candidates) rather
    than the raw constructor; the constructor trusts its input.
    """

    __slots__ = ("points",)

    def __init__(self, points: Sequence[ParetoPoint]):
        if not points:
            raise ValueError("a ParetoFront needs at least one point")
        self.points = tuple(points)

    # ------------------------------------------------------------- building
    @classmethod
    def build(cls, candidates: Iterable[ParetoPoint | tuple],
              *, anchor: ParetoPoint | tuple | None = None,
              width: int | None = None) -> "ParetoFront":
        """Skyline-filter ``candidates`` (points or ``(lat, en, plan)``
        tuples) into a front.  Insertion order is the tie-break: the first
        candidate at an exact ``(latency, energy)`` tie is kept.  ``width``
        caps the front size (endpoints always survive thinning).

        ``anchor`` pins the latency endpoint to a canonical plan — the seed
        scalar-DP optimum: every candidate at or below the anchor's latency
        is discarded, deliberately including candidates whose latency is
        *strictly* lower.  Such candidates only arise when a downstream
        re-pricing (the hierarchical re-cost) disagrees with the tier the
        anchor was optimal in; the seed planner commits at that tier and
        never finds them, and the API contract — ``latency_optimal``
        reproduces the seed plan bit-identically, selection under the
        default objective is the seed pass — outranks an opportunistic
        re-costing win at the endpoint."""
        pts = [c if isinstance(c, ParetoPoint) else ParetoPoint(*c)
               for c in candidates]
        if anchor is not None:
            a = anchor if isinstance(anchor, ParetoPoint) \
                else ParetoPoint(*anchor)
            pts = [a] + [p for p in pts if p.latency > a.latency]
        if not pts:
            raise ValueError("no candidates to build a ParetoFront from")
        # stable sort: equal (lat, en) keeps the earlier candidate first
        pts.sort(key=lambda p: (p.latency, p.energy))
        front: list[ParetoPoint] = []
        best_en = float("inf")
        for p in pts:
            if p.energy < best_en:
                front.append(p)
                best_en = p.energy
        if width is not None:
            front = _thin(front, width)
        return cls(front)

    # ------------------------------------------------------------ accessors
    @property
    def latency_optimal(self) -> ParetoPoint:
        """The fastest plan — for frontier DPs built here, bit-identical to
        the seed's scalar latency DP (the caller splices it in first)."""
        return self.points[0]

    @property
    def energy_optimal(self) -> ParetoPoint:
        return self.points[-1]

    def __len__(self) -> int:
        return len(self.points)

    def __iter__(self) -> Iterator[ParetoPoint]:
        return iter(self.points)

    def plans(self) -> tuple:
        return tuple(p.plan for p in self.points)

    # ------------------------------------------------------------ selection
    def select_point(self, objective: Objective | None = None) -> ParetoPoint:
        """The objective as a selector: feasible-first under the budget,
        then metric-optimal — ``Objective.key`` encodes exactly that order,
        and among infeasible points lower latency wins, so a front whose
        fastest point misses the budget still returns its fastest plan."""
        obj = resolve_objective(objective)
        return min(self.points, key=lambda p: p.key(obj))

    def select(self, objective: Objective | None = None):
        return self.select_point(objective).plan

    # -------------------------------------------------------- serialization
    def to_dict(self, encode_plan: Callable[[Any], Any] = lambda p: p
                ) -> dict:
        """JSON round-trip out: the sorted point list, plans encoded by
        ``encode_plan``.  ``from_dict(to_dict(f))`` rebuilds a front whose
        selections are bit-identical to the original's — floats survive the
        trip exactly (JSON uses shortest round-trippable reprs) and order
        is preserved, so ``select`` walks the same points in the same
        order."""
        return {"points": [p.to_dict(encode_plan) for p in self.points]}

    @classmethod
    def from_dict(cls, d: dict,
                  decode_plan: Callable[[Any], Any] = lambda p: p
                  ) -> "ParetoFront":
        """Rebuild a persisted front.  Trusts the stored order (the writer
        held the invariants), like the raw constructor."""
        return cls([ParetoPoint.from_dict(p, decode_plan)
                    for p in d["points"]])

    # ----------------------------------------------------------- invariants
    def dominated(self, latency: float, energy: float) -> bool:
        """True iff some front point strictly beats ``(latency, energy)``
        on one axis and is no worse on the other."""
        probe = ParetoPoint(latency, energy, None)
        return any(p.dominates(probe) for p in self.points)

    def __repr__(self) -> str:
        lo, hi = self.points[0], self.points[-1]
        return (f"ParetoFront({len(self.points)} points, "
                f"lat [{lo.latency:.4g}, {hi.latency:.4g}] s, "
                f"en [{hi.energy:.4g}, {lo.energy:.4g}] J)")


def _thin(front: list[ParetoPoint], width: int) -> list[ParetoPoint]:
    """Cap a sorted front at ``width`` points, dropping interior points with
    the smallest latency gap to their predecessor (endpoints survive)."""
    while len(front) > max(width, 2):
        i = min(range(1, len(front) - 1),
                key=lambda k: front[k].latency - front[k - 1].latency)
        del front[i]
    return front


def pareto_filter(states: list[tuple], state: tuple,
                  cap: int = DEFAULT_FRONT_WIDTH) -> list[tuple]:
    """Insert ``state`` (``(lat, en, ...payload)``) into a sorted
    non-dominated state list — the per-cell frontier op of the DP searches.
    Existing points win ties (first-inserted preference).  Returns the
    original list unchanged when ``state`` is dominated.  Like
    :func:`_thin`, the cap floors at 2 so both endpoints always survive
    (``cap=1`` would otherwise leave no interior point to drop)."""
    lat, en = state[0], state[1]
    for s in states:
        if s[0] <= lat and s[1] <= en:
            return states                       # dominated (or an exact tie)
    out = [s for s in states if not (lat <= s[0] and en <= s[1])]
    out.append(state)
    out.sort(key=lambda s: (s[0], s[1]))
    if len(out) > max(cap, 2):
        i = min(range(1, len(out) - 1),
                key=lambda k: out[k][0] - out[k - 1][0])
        del out[i]
    return out
