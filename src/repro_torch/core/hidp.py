"""The port's copy of ``repro.core.hidp``.

HiDPPlanner — the end-to-end two-tier planner (the paper's contribution).

Given an inference request (a ModelDAG) and a Cluster, produce:

  tier 1: GlobalPlan  — mode (model|data) + node assignments     (Alg.1 l.3-7)
  tier 2: LocalPlan   — per node, mode + processor split         (Alg.1 l.8-10)

and the *hierarchical* latency/energy prediction, where each node's share is
costed by its own local plan instead of the optimistic Λ_j = Σλ_k global
collapse.  This refinement is exactly why HiDP beats global-only strategies:
the global tier books capacity a node cannot actually realise without a good
local split, and HiDP is the only strategy that then realises it.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Sequence
from weakref import WeakKeyDictionary

from .cost_model import (Cluster, CostProvider, node_as_resource,
                         resolve_provider)
from .dag import DataPartition, ModelDAG, ModelPartition
from .global_partitioner import (GlobalAssignment, GlobalPlan, plan_global,
                                 plan_global_front)
from .local_partitioner import (LocalPlan, p1_plan, plan_local,
                                plan_local_front)
from .objective import Objective, resolve_objective
from .pareto import ParetoFront, ParetoPoint, pareto_filter

# Sub-workload memo for the planner: a hierarchical pass (and
# every speculative pre-warm over N-1 memberships) re-derives the same
# ``dag.blocks[lo:hi]`` slices and σ-scaled copies many times over.  Keyed
# weakly on the parent DAG (a frozen dataclass — hashable, weakref-able) so
# entries die with the model; returning the *same* sub-DAG object also makes
# every downstream fingerprint/prefix-sum cache hit.  Bounded per DAG.
_SUBDAG_CACHE: "WeakKeyDictionary[ModelDAG, OrderedDict]" = (
    WeakKeyDictionary())
_SUBDAG_MAX = 512


def sub_dag_for(dag: ModelDAG, a: GlobalAssignment) -> ModelDAG:
    """Extract the sub-workload a global assignment hands to a node."""
    try:
        per = _SUBDAG_CACHE.get(dag)
        if per is None:
            per = OrderedDict()
            _SUBDAG_CACHE[dag] = per
    except TypeError:                 # unhashable custom DAG subclass
        per = None
    else:
        key = (a.block_range, a.fraction)
        got = per.get(key)
        if got is not None:
            per.move_to_end(key)
            return got
    if a.block_range is not None:                        # model mode: ω blocks
        lo, hi = a.block_range
        blocks = dag.blocks[lo:hi]
        sub = ModelDAG(name=f"{dag.name}[{lo}:{hi}]", blocks=blocks,
                       input_bytes=blocks[0].bytes_in,
                       output_bytes=blocks[-1].bytes_out)
    else:
        assert a.fraction is not None                    # data mode: σ slice
        sub = ModelDAG(name=f"{dag.name}x{a.fraction:.3f}",
                       blocks=tuple(b.scaled(a.fraction)
                                    for b in dag.blocks),
                       input_bytes=dag.input_bytes * a.fraction,
                       output_bytes=dag.output_bytes * a.fraction)
    if per is not None:
        per[(a.block_range, a.fraction)] = sub
        while len(per) > _SUBDAG_MAX:
            per.popitem(last=False)
    return sub


@dataclasses.dataclass(frozen=True)
class HiDPPlan:
    dag_name: str
    global_plan: GlobalPlan
    local_plans: tuple[LocalPlan, ...]     # parallel to global_plan.assignments
    predicted_latency: float               # hierarchical (tier-2 refined)
    predicted_energy: float
    planning_seconds: float                # DP overhead (paper: ~15 ms)
    # strategy-specific extra traffic on the shared medium (MoDNN's per-layer
    # halo exchange); the simulator reserves the medium for it.
    extra_comm_bytes: float = 0.0
    # fixed serial overhead (MoDNN's per-layer barrier round-trips)
    extra_latency: float = 0.0

    @property
    def mode(self) -> str:
        return self.global_plan.mode


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Knobs for one :func:`plan` invocation.

    Attributes:
        delta: model compute-intensity [cycles/flop]; rescales datasheet
            rates to the model's arithmetic profile.
        weight_transfer: price cold-start weight shipping into model-mode
            stage costs (steady-state serving keeps weights resident).
        local_tier: False → global-only planning (the DisNet ablation).
        p1_local: True → pin the local tier to the framework-default
            single-processor behaviour (SoA config "P1").
        node_capacity: ``"sum"`` (HiDP's Λ_j = Σλ_k) or ``"default"``
            (what global-only strategies measure probing the default
            runtime).
        provider: cost predictions — None → the analytic datasheet model
            (seed behaviour); a ``CalibratedCostProvider`` answers from the
            profiling subsystem's fitted regressors (the paper's DNN Model
            Analyzer).
        objective: what both DP tiers minimize — None → latency (seed
            behaviour); ``Objective("energy", latency_budget=...)`` or
            ``Objective("edp")`` make energy a first-class planning goal.
            The budget and radio term apply at the global tier; the local
            tier minimizes the same metric via ``objective.local()``.
        front_width: cap on the composed :func:`plan_front` frontier (and
            on the global front it composes from).  Endpoints always
            survive thinning.
    """

    delta: float = 1.0                 # model compute-intensity [cycles/flop]
    weight_transfer: bool = False      # cold-start weight shipping
    local_tier: bool = True            # False → global-only (ablation/DisNet)
    p1_local: bool = False             # True → SoA default local behaviour
    node_capacity: str = "sum"         # "sum" (HiDP) | "default" (SoA probe)
    provider: CostProvider | None = None
    objective: Objective | None = None
    # max points kept when composing the hierarchical frontier (plan_front);
    # endpoints always survive, so this trades interior resolution for speed
    front_width: int = 8


def _hierarchical_cost(dag: ModelDAG, gp: GlobalPlan,
                       locals_: Sequence[LocalPlan],
                       provider: CostProvider | None = None,
                       objective: Objective | None = None
                       ) -> tuple[float, float]:
    """Re-cost the global plan with tier-2 refined per-node latencies.

    Energy is the sum of the local plans' predictions plus the objective's
    radio term on the inter-node transfer seconds priced here — keeping
    ``HiDPPlan.predicted_energy`` consistent with the figure the global DP
    minimized and with the simulator's radio-metered measurement (both
    terms are zero under the default objective, the seed behaviour)."""
    prov = resolve_provider(provider)
    radio = objective.radio_power if objective is not None else 0.0
    energy = sum(lp.predicted_energy for lp in locals_)
    if gp.mode == "model":
        total = 0.0
        for a, lp in zip(gp.assignments, locals_):
            r = node_as_resource(a.node)
            xfer = sub_dag_for(dag, a).input_bytes
            comm_s = prov.comm_time(xfer, r)
            total += comm_s + lp.predicted_latency
            energy += radio * comm_s
        out_s = prov.comm_time(dag.output_bytes,
                               node_as_resource(gp.assignments[-1].node),
                               rtt=0.0)
        total += out_s
        energy += radio * out_s
        return total, energy
    # data mode: concurrent, slowest node dominates
    per_node = []
    for a, lp in zip(gp.assignments, locals_):
        r = node_as_resource(a.node)
        sd = sub_dag_for(dag, a)
        comm_s = prov.comm_time(sd.input_bytes + sd.output_bytes, r)
        per_node.append(comm_s + lp.predicted_latency)
        energy += radio * comm_s
    return max(per_node), energy


def _local_objective(objective: Objective | None, gp: GlobalPlan,
                     a: GlobalAssignment, sub_dag: ModelDAG,
                     config: PlannerConfig,
                     provider: CostProvider | None) -> Objective | None:
    """Decompose a request-level latency budget into a per-node one.

    The global tier booked ``sub_dag`` on this node at the optimistic
    Λ_j = Σλ_k collapse; the local tier may spend that booking times the
    request's slack ratio (budget / global predicted latency), but no more —
    otherwise an unconstrained energy objective would happily pick a
    low-power local split that blows the request budget a tier above."""
    if objective is None:
        return None
    local = objective.local()
    if objective.latency_budget is None:
        return local
    kind = sub_dag.dominant_kind()
    r = node_as_resource(a.node, config.delta, kind,
                         capacity=config.node_capacity)
    prov = resolve_provider(provider)
    booked = prov.compute_time(sub_dag.total_flops, r, kind)
    slack = objective.latency_budget / max(gp.predicted_latency, 1e-12)
    return dataclasses.replace(local,
                               latency_budget=booked * max(slack, 1.0))


def plan(dag: ModelDAG, cluster: Cluster,
         config: PlannerConfig = PlannerConfig()) -> HiDPPlan:
    """Run the full two-tier HiDP planning pass for one request.

    Tier 1 (:func:`plan_global`) chooses the mode and node shares over the
    available cluster; tier 2 (:func:`plan_local`) re-partitions each node's
    sub-workload over its own processors, both priced by ``config.provider``
    (the analytic datasheet model by default).  Under the default latency
    objective this is the seed DP pass, bit-identical; any other
    ``config.objective`` *selects* from the plan frontier
    (:func:`plan_front`) — feasible-first under the latency budget, then
    metric-optimal.  The returned :class:`HiDPPlan` carries the
    tier-2-refined latency *and* energy predictions plus the planning
    overhead (paper: ~15 ms; the frontier pass costs a few times that and
    is amortized by ``repro_torch.serving.plan_cache.PlanCache``).
    """
    objective = config.objective
    if not resolve_objective(objective).is_latency:
        t0 = time.perf_counter()
        selected = plan_front(dag, cluster, config).select(objective)
        return dataclasses.replace(
            selected, planning_seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    provider = config.provider
    if provider is not None:
        provider = provider.at_delta(config.delta)
    gp = plan_global(dag, cluster, delta=config.delta,
                     weight_transfer=config.weight_transfer,
                     capacity=config.node_capacity, provider=provider,
                     objective=objective)
    locals_: list[LocalPlan] = []
    for a in gp.assignments:
        sd = sub_dag_for(dag, a)
        if not config.local_tier or config.p1_local:
            locals_.append(p1_plan(sd, a.node, delta=config.delta,
                                   provider=provider))
        else:
            locals_.append(plan_local(sd, a.node, delta=config.delta,
                                      provider=provider,
                                      objective=_local_objective(
                                          objective, gp, a, sd, config,
                                          provider)))
    latency, energy = _hierarchical_cost(dag, gp, locals_, provider,
                                         objective)
    dt = time.perf_counter() - t0
    return HiDPPlan(dag_name=dag.name, global_plan=gp,
                    local_plans=tuple(locals_), predicted_latency=latency,
                    predicted_energy=energy, planning_seconds=dt)


# --------------------------------------------------------------------------
# Frontier planning — one pass, every objective
# --------------------------------------------------------------------------

def _compose_front(dag: ModelDAG, gp: GlobalPlan,
                   lfronts: Sequence[ParetoFront], prov: CostProvider,
                   radio: float, cap: int) -> list[tuple]:
    """Compose per-node local fronts under one global plan into
    hierarchical (latency, energy, local-plan-choice) states — the
    node-separable unrolling of :func:`_hierarchical_cost`, so every
    composed state prices exactly as the scalar path would price that
    combination of local plans."""
    if gp.mode == "model":
        states: list[tuple] = [(0.0, 0.0, ())]
        for a, lf in zip(gp.assignments, lfronts):
            r = node_as_resource(a.node)
            xfer = sub_dag_for(dag, a).input_bytes
            comm_s = prov.comm_time(xfer, r)
            nxt: list[tuple] = []
            for lat, en, chosen in states:
                for p in lf:
                    nxt = pareto_filter(
                        nxt, (lat + comm_s + p.latency,
                              en + p.energy + radio * comm_s,
                              chosen + (p.plan,)), cap)
            states = nxt
        out_s = prov.comm_time(dag.output_bytes,
                               node_as_resource(gp.assignments[-1].node),
                               rtt=0.0)
        return [(lat + out_s, en + radio * out_s, chosen)
                for lat, en, chosen in states]
    # data mode: concurrent, slowest node dominates
    states = [(0.0, 0.0, ())]
    for a, lf in zip(gp.assignments, lfronts):
        r = node_as_resource(a.node)
        sd = sub_dag_for(dag, a)
        comm_s = prov.comm_time(sd.input_bytes + sd.output_bytes, r)
        nxt = []
        for lat, en, chosen in states:
            for p in lf:
                nxt = pareto_filter(
                    nxt, (max(lat, comm_s + p.latency),
                          en + p.energy + radio * comm_s,
                          chosen + (p.plan,)), cap)
        states = nxt
    return states


def plan_front(dag: ModelDAG, cluster: Cluster,
               config: PlannerConfig = PlannerConfig()) -> ParetoFront:
    """One planning pass, every objective: the hierarchical latency–energy
    frontier of two-tier HiDP plans.

    Tier 1 produces the global frontier; for each global plan on it, tier 2
    produces per-node local fronts, and the hierarchy composes them
    node-separably (pipeline: sums; data: max-latency/sum-energy) into
    non-dominated :class:`HiDPPlan` candidates.  The seed latency-optimal
    plan (the exact scalar two-tier pass) is spliced in first, so
    ``front.latency_optimal`` reproduces it bit-identically.  Select a plan
    for any request with ``front.select(objective)`` — zero DP work; that
    is what ``repro_torch.serving.plan_cache.PlanCache`` serves from.

    Radio pricing comes from ``config.objective.radio_power`` (a pricing
    parameter, not a selector): every point's energy includes it, so the
    front is valid for any later selection objective with the same radio
    assumption."""
    t0 = time.perf_counter()
    provider = config.provider
    if provider is not None:
        provider = provider.at_delta(config.delta)
    prov = resolve_provider(provider)
    radio = resolve_objective(config.objective).radio_power
    width = config.front_width

    # the exact seed pass anchors the latency endpoint, bit-identically —
    # but its energy must be re-priced with the radio term (the scalar pass
    # ran radio-free) so the anchor skylines and selects against the
    # composed candidates on equal footing
    seed = plan(dag, cluster, dataclasses.replace(config, objective=None))
    if radio != 0.0:
        _, seed_energy = _hierarchical_cost(
            dag, seed.global_plan, seed.local_plans, provider,
            resolve_objective(config.objective))
        seed = dataclasses.replace(seed, predicted_energy=seed_energy)

    gfront = plan_global_front(dag, cluster, delta=config.delta,
                               weight_transfer=config.weight_transfer,
                               capacity=config.node_capacity,
                               provider=provider, radio_power=radio,
                               width=width)
    local_cache: dict[tuple, ParetoFront] = {}

    def local_front(a: GlobalAssignment) -> ParetoFront:
        key = (a.node.name, a.block_range, a.fraction)
        lf = local_cache.get(key)
        if lf is None:
            sd = sub_dag_for(dag, a)
            if not config.local_tier or config.p1_local:
                lp = p1_plan(sd, a.node, delta=config.delta, provider=prov)
                lf = ParetoFront([ParetoPoint(lp.predicted_latency,
                                              lp.predicted_energy, lp)])
            else:
                lf = plan_local_front(sd, a.node, delta=config.delta,
                                      provider=prov, width=width)
            local_cache[key] = lf
        return lf

    candidates: list[tuple[float, float, GlobalPlan, tuple]] = []
    for gpoint in gfront:
        gp = gpoint.plan
        lfronts = [local_front(a) for a in gp.assignments]
        for lat, en, chosen in _compose_front(dag, gp, lfronts, prov,
                                              radio, cap=width):
            candidates.append((lat, en, gp, chosen))

    dt = time.perf_counter() - t0
    anchor = ParetoPoint(seed.predicted_latency, seed.predicted_energy,
                         dataclasses.replace(seed, planning_seconds=dt))
    points: list[ParetoPoint] = []
    for lat, en, gp, chosen in candidates:
        points.append(ParetoPoint(lat, en, HiDPPlan(
            dag_name=dag.name, global_plan=gp, local_plans=tuple(chosen),
            predicted_latency=lat, predicted_energy=en,
            planning_seconds=dt)))
    return ParetoFront.build(points, anchor=anchor, width=width)


# --------------------------------------------------------------------------
# Plan serialization — the JSON round-trip persisted fronts ride on
# --------------------------------------------------------------------------

def _partition_to_dict(p: ModelPartition | DataPartition) -> dict:
    if isinstance(p, ModelPartition):
        return {"mode": "model", "boundaries": list(p.boundaries),
                "assignment": list(p.assignment),
                "predicted_latency": p.predicted_latency}
    return {"mode": "data", "fractions": list(p.fractions),
            "assignment": list(p.assignment),
            "predicted_latency": p.predicted_latency}


def _partition_from_dict(d: dict) -> ModelPartition | DataPartition:
    if d["mode"] == "model":
        return ModelPartition(boundaries=tuple(d["boundaries"]),
                              assignment=tuple(d["assignment"]),
                              predicted_latency=d["predicted_latency"])
    return DataPartition(fractions=tuple(d["fractions"]),
                         assignment=tuple(d["assignment"]),
                         predicted_latency=d["predicted_latency"])


def plan_to_dict(plan: HiDPPlan) -> dict:
    """A JSON-able view of a two-tier plan.  Nodes are stored by *name*
    only: a persisted plan is always filed under its cluster's fingerprint,
    so the loader (:func:`plan_from_dict`) reattaches the full ``Node``
    objects from a cluster guaranteed topology-identical to the writer's."""
    gp = plan.global_plan
    return {
        "dag_name": plan.dag_name,
        "predicted_latency": plan.predicted_latency,
        "predicted_energy": plan.predicted_energy,
        "planning_seconds": plan.planning_seconds,
        "extra_comm_bytes": plan.extra_comm_bytes,
        "extra_latency": plan.extra_latency,
        "global_plan": {
            "mode": gp.mode,
            "partition": _partition_to_dict(gp.partition),
            "predicted_latency": gp.predicted_latency,
            "predicted_energy": gp.predicted_energy,
            "assignments": [
                {"node": a.node.name, "block_range": list(a.block_range)
                 if a.block_range is not None else None,
                 "fraction": a.fraction, "stage_index": a.stage_index}
                for a in gp.assignments],
        },
        "local_plans": [
            {"node_name": lp.node_name, "mode": lp.mode,
             "partition": _partition_to_dict(lp.partition),
             "predicted_latency": lp.predicted_latency,
             "predicted_energy": lp.predicted_energy}
            for lp in plan.local_plans],
    }


def plan_from_dict(d: dict, cluster: Cluster) -> HiDPPlan:
    """Rebuild a persisted plan against ``cluster``; bit-identical to the
    plan :func:`plan_to_dict` serialized whenever the cluster's fingerprint
    matches the writer's (the persistence layer enforces that)."""
    nodes = {n.name: n for n in cluster.nodes}
    gd = d["global_plan"]
    assignments = tuple(
        GlobalAssignment(
            node=nodes[a["node"]],
            block_range=tuple(a["block_range"])
            if a["block_range"] is not None else None,
            fraction=a["fraction"], stage_index=a["stage_index"])
        for a in gd["assignments"])
    gp = GlobalPlan(mode=gd["mode"],
                    partition=_partition_from_dict(gd["partition"]),
                    assignments=assignments,
                    predicted_latency=gd["predicted_latency"],
                    predicted_energy=gd["predicted_energy"])
    locals_ = tuple(
        LocalPlan(node_name=ld["node_name"], mode=ld["mode"],
                  partition=_partition_from_dict(ld["partition"]),
                  predicted_latency=ld["predicted_latency"],
                  predicted_energy=ld["predicted_energy"])
        for ld in d["local_plans"])
    return HiDPPlan(dag_name=d["dag_name"], global_plan=gp,
                    local_plans=locals_,
                    predicted_latency=d["predicted_latency"],
                    predicted_energy=d["predicted_energy"],
                    planning_seconds=d["planning_seconds"],
                    extra_comm_bytes=d["extra_comm_bytes"],
                    extra_latency=d["extra_latency"])


class HiDPPlanner:
    """First-class two-tier planner: one configuration, frontier output.

    The object every consumer of planning should hold: ``front`` runs the
    (expensive, objective-independent) frontier pass once per
    ``(cluster, dag)``; ``plan`` selects a single plan for a concrete
    objective.  ``repro_torch.serving.plan_cache.PlanCache`` wraps a planner to
    amortize ``front`` across requests."""

    def __init__(self, config: PlannerConfig = PlannerConfig()):
        self.config = config

    def at_delta(self, delta: float) -> "HiDPPlanner":
        """The same planner rebound to a model's compute intensity."""
        if delta == self.config.delta:
            return self
        return HiDPPlanner(dataclasses.replace(self.config, delta=delta))

    def front(self, dag: ModelDAG, cluster: Cluster) -> ParetoFront:
        return plan_front(dag, cluster, self.config)

    def plan(self, dag: ModelDAG, cluster: Cluster,
             objective: Objective | None = None) -> HiDPPlan:
        """A single plan: the configured objective unless overridden."""
        cfg = self.config
        if objective is not None:
            cfg = dataclasses.replace(cfg, objective=objective)
        return plan(dag, cluster, cfg)
