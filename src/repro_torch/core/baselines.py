"""The port's copy of ``repro.core.baselines``.

State-of-the-art baselines the paper compares against (§IV-A).

* **MoDNN** (Mao et al., DATE'17) — data partitioning only: input split
  proportionally to node compute capacity; no local tier (framework-default
  single-processor execution = config P1).  Implemented, per the paper, "using
  the data partitioning module of HiDP".  MoDNN partitions feature maps
  one-dimensionally *per layer*, so partitions exchange boundary rows at every
  layer over the wireless medium — its dominant overhead, modelled explicitly.

* **OmniBoost** (Karatzas et al., DAC'23) — model/pipeline partitioning with a
  Monte-Carlo tree search over cut points and a learned throughput estimator.
  We implement the MCTS over the same analytic cost model (our stand-in for
  their trained estimator) with a fixed rollout budget; it optimises pipeline
  *throughput* (max stage time), which is exactly why it cedes latency to
  HiDP.  Locally it pipelines over CPU+GPU (model-mode local split).

* **DisNet** (Samikwa et al., IoT-J'24) — hybrid partitioning (both modes,
  chosen heuristically at the *global* level only), no fine-grained local
  control: per the paper we reuse HiDP's global data+model partitioning and
  pin the local tier to P1.

All strategies share the HiDPPlan output type so the simulator and benchmarks
treat them uniformly.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable

from .cost_model import (Cluster, CostProvider, node_as_resource,
                         resolve_provider)
from .dag import DataPartition, ModelDAG, ModelPartition
from .dp_partitioner import partition_data, partition_model, predicted_energy
from .global_partitioner import GlobalAssignment, GlobalPlan
from .hidp import (HiDPPlan, PlannerConfig, _hierarchical_cost, plan,
                   plan_front, sub_dag_for)
from .local_partitioner import p1_plan, plan_local
from .objective import Objective, resolve_objective
from .pareto import ParetoFront, ParetoPoint

# Strategies optionally accept ``provider=`` (a CostProvider) so the whole
# comparison can be re-run against calibrated cost predictions, and
# ``objective=`` (an Objective) so it can be re-run minimizing energy or EDP
# wherever the strategy has a real degree of freedom (HiDP: both DP tiers;
# DisNet: its global mode choice; MoDNN's proportional split and OmniBoost's
# throughput-reward MCTS are fixed by their papers and ignore it).
Strategy = Callable[..., HiDPPlan]


def _resolve(provider: CostProvider | None, delta: float) -> CostProvider:
    return resolve_provider(provider).at_delta(delta)


# --------------------------------------------------------------------------
# HiDP itself, as a Strategy
# --------------------------------------------------------------------------

def hidp_strategy(dag: ModelDAG, cluster: Cluster, delta: float = 1.0,
                  provider: CostProvider | None = None,
                  objective: Objective | None = None) -> HiDPPlan:
    return plan(dag, cluster, PlannerConfig(delta=delta, provider=provider,
                                            objective=objective))


# --------------------------------------------------------------------------
# MoDNN — proportional data partitioning, P1 local
# --------------------------------------------------------------------------

def modnn_strategy(dag: ModelDAG, cluster: Cluster, delta: float = 1.0,
                   provider: CostProvider | None = None,
                   objective: Objective | None = None) -> HiDPPlan:
    t0 = time.perf_counter()
    prov = _resolve(provider, delta)
    kind = dag.dominant_kind()
    nodes = cluster.available_nodes()
    # MoDNN profiles nodes end-to-end with the default runtime, so it sees
    # default-processor capacity; it splits input proportionally to that
    # capacity (it does not drop slow helpers or model comm in the split).
    resources = [node_as_resource(n, delta, capacity="default")
                 for n in nodes]
    total = sum(prov.effective_rate(r, kind) for r in resources)
    fr = tuple(prov.effective_rate(r, kind) / total for r in resources)
    per_node = [prov.compute_time(dag.total_flops * f, r, kind)
                + prov.comm_time((dag.input_bytes + dag.output_bytes) * f, r)
                for f, r in zip(fr, resources)]
    # Per-layer 1-D feature-map partitioning ⇒ boundary-row exchange at every
    # block, between σ−1 neighbour pairs, all over the shared wireless medium,
    # plus a synchronisation barrier (one wireless round-trip) per block —
    # MoDNN's dominant overhead on multi-node clusters.
    sigma = len(nodes)
    halo_bytes = sum(b.bytes_out * b.halo_fraction for b in dag.blocks) * (
        sigma - 1)
    sync_latency = len(dag.blocks) * 2 * 2e-3
    part = DataPartition(fractions=fr,
                         assignment=tuple(range(len(nodes))),
                         predicted_latency=max(per_node))
    gp = GlobalPlan(
        mode="data", partition=part,
        assignments=tuple(GlobalAssignment(node=n, fraction=f, stage_index=i)
                          for i, (n, f) in enumerate(zip(nodes, fr))),
        predicted_latency=part.predicted_latency,
        predicted_energy=predicted_energy(dag, resources, part, prov))
    locals_ = tuple(p1_plan(sub_dag_for(dag, a), a.node, delta=delta,
                            provider=prov)
                    for a in gp.assignments)
    lat, en = _hierarchical_cost(dag, gp, locals_, prov, objective)
    lat += halo_bytes / nodes[0].net_bw + sync_latency
    return HiDPPlan(dag_name=dag.name, global_plan=gp, local_plans=locals_,
                    predicted_latency=lat, predicted_energy=en,
                    planning_seconds=time.perf_counter() - t0,
                    extra_comm_bytes=halo_bytes,
                    extra_latency=sync_latency)


# --------------------------------------------------------------------------
# OmniBoost — MCTS pipeline partitioning, throughput objective
# --------------------------------------------------------------------------

def _mcts_pipeline(dag: ModelDAG, resources, *, budget: int = 128,
                   seed: int = 0, max_stages: int = 2,
                   provider: CostProvider | None = None) -> ModelPartition:
    """Monte-Carlo search over cut points: states are partial boundary lists;
    rollouts complete them randomly; reward = −max stage time (throughput).
    Deliberately budget- and depth-limited (the paper's OmniBoost explores a
    learned estimator the same way, over small candidate pipelines)."""
    prov = resolve_provider(provider)
    rng = random.Random(seed)
    n, m = len(dag.blocks), len(resources)
    kind = dag.dominant_kind()
    order = sorted(range(m),
                   key=lambda i: -prov.effective_rate(resources[i], kind))

    def stage_time(a: int, b: int, ri: int) -> float:
        seg = dag.segment(a, b)
        r = resources[ri]
        return (prov.comm_time(seg.bytes_in, r)
                + prov.compute_time(seg.flops, r, seg.kind))

    def evaluate(cuts: list[int]) -> float:
        bounds = [0] + cuts + [n]
        return max(stage_time(bounds[i], bounds[i + 1], order[i % m])
                   for i in range(len(bounds) - 1))

    best_cuts, best_val = [], evaluate([])
    max_cuts = max(min(m, n, max_stages) - 1, 0)
    for _ in range(budget):
        k = rng.randint(1, max_cuts) if max_cuts else 0
        cuts = sorted(rng.sample(range(1, n), k)) if k else []
        v = evaluate(cuts)
        if v < best_val:
            best_val, best_cuts = v, cuts
    bounds = [0] + best_cuts + [n]
    assign = tuple(order[i % m] for i in range(len(bounds) - 1))
    # latency of the pipeline for a single request = sum of stage times
    latency = sum(stage_time(bounds[i], bounds[i + 1], assign[i])
                  for i in range(len(bounds) - 1))
    return ModelPartition(boundaries=tuple(bounds), assignment=assign,
                          predicted_latency=latency)


def omniboost_strategy(dag: ModelDAG, cluster: Cluster, delta: float = 1.0,
                       provider: CostProvider | None = None,
                       objective: Objective | None = None) -> HiDPPlan:
    t0 = time.perf_counter()
    prov = _resolve(provider, delta)
    nodes = cluster.available_nodes()
    resources = [node_as_resource(n, delta, capacity="default")
                 for n in nodes]
    part = _mcts_pipeline(dag, resources, provider=prov)
    assignments = []
    for si in range(part.num_stages):
        a, b = part.boundaries[si], part.boundaries[si + 1]
        assignments.append(GlobalAssignment(node=nodes[part.assignment[si]],
                                            block_range=(a, b),
                                            stage_index=si))
    gp = GlobalPlan(mode="model", partition=part,
                    assignments=tuple(assignments),
                    predicted_latency=part.predicted_latency,
                    predicted_energy=predicted_energy(dag, resources, part,
                                                      prov))
    # local: OmniBoost pipelines each stage over the node's CPU+GPU.
    locals_ = []
    for a in gp.assignments:
        sd = sub_dag_for(dag, a)
        from .cost_model import processors_as_resources
        lres = processors_as_resources(a.node, delta)
        lp_part = _mcts_pipeline(sd, lres, budget=64, seed=1, provider=prov)
        from .local_partitioner import LocalPlan
        locals_.append(LocalPlan(
            node_name=a.node.name, mode="model", partition=lp_part,
            predicted_latency=lp_part.predicted_latency,
            predicted_energy=predicted_energy(sd, lres, lp_part, prov)))
    lat, en = _hierarchical_cost(dag, gp, tuple(locals_), prov,
                                 objective)
    return HiDPPlan(dag_name=dag.name, global_plan=gp,
                    local_plans=tuple(locals_), predicted_latency=lat,
                    predicted_energy=en,
                    planning_seconds=time.perf_counter() - t0)


# --------------------------------------------------------------------------
# DisNet — heuristic hybrid global tier, P1 local
# --------------------------------------------------------------------------

def disnet_strategy(dag: ModelDAG, cluster: Cluster, delta: float = 1.0,
                    provider: CostProvider | None = None,
                    objective: Objective | None = None) -> HiDPPlan:
    """DisNet chooses between data and model partitioning *heuristically* at
    the global level (micro-split heuristics, not an exact DP): data fractions
    proportional to capacity, model cuts at equal-compute points; the better
    of the two estimates under the objective wins (the faster one for the
    default latency objective — the seed behaviour).  No local tier (P1)."""
    t0 = time.perf_counter()
    prov = _resolve(provider, delta)
    kind = dag.dominant_kind()
    nodes = cluster.available_nodes()
    resources = [node_as_resource(n, delta, capacity="default")
                 for n in nodes]
    order = sorted(range(len(nodes)),
                   key=lambda i: -prov.effective_rate(resources[i], kind))

    # Heuristic data split: proportional fractions over all nodes.
    total = sum(prov.effective_rate(r, kind) for r in resources)
    fr = tuple(prov.effective_rate(resources[i], kind) / total for i in order)
    per_node = [prov.compute_time(dag.total_flops * f, resources[i], kind)
                + prov.comm_time(
                    (dag.input_bytes + dag.output_bytes) * f, resources[i])
                for f, i in zip(fr, order)]
    data_part = DataPartition(fractions=fr, assignment=tuple(order),
                              predicted_latency=max(per_node))

    # Heuristic model split: equal-compute cuts over the 2 fastest nodes.
    k = min(2, len(order))
    cum = dag.cumulative_flops()
    target = dag.total_flops / k
    bounds, acc = [0], 0.0
    for i, b in enumerate(dag.blocks):
        acc += b.flops
        if acc >= target * len(bounds) and len(bounds) < k:
            bounds.append(i + 1)
    bounds.append(len(dag.blocks))
    bounds = sorted(set(bounds))
    assign = tuple(order[i % len(order)] for i in range(len(bounds) - 1))
    lat = 0.0
    for si in range(len(bounds) - 1):
        seg = dag.segment(bounds[si], bounds[si + 1])
        r = resources[assign[si]]
        lat += (prov.comm_time(seg.bytes_in, r)
                + prov.compute_time(seg.flops, r, seg.kind))
    model_part = ModelPartition(boundaries=tuple(bounds), assignment=assign,
                                predicted_latency=lat)

    obj = resolve_objective(objective)
    if obj.is_latency:
        part = (data_part if data_part.predicted_latency
                <= model_part.predicted_latency else model_part)
    else:
        en_d = predicted_energy(dag, resources, data_part, prov,
                                radio_power=obj.radio_power)
        en_m = predicted_energy(dag, resources, model_part, prov,
                                radio_power=obj.radio_power)
        part = (data_part
                if obj.at_least_as_good(data_part.predicted_latency, en_d,
                                        model_part.predicted_latency, en_m)
                else model_part)
    if isinstance(part, DataPartition):
        assignments = tuple(
            GlobalAssignment(node=nodes[ri], fraction=f, stage_index=i)
            for i, (f, ri) in enumerate(zip(part.fractions, part.assignment)))
        mode = "data"
    else:
        assignments = tuple(
            GlobalAssignment(node=nodes[part.assignment[si]],
                             block_range=(part.boundaries[si],
                                          part.boundaries[si + 1]),
                             stage_index=si)
            for si in range(part.num_stages))
        mode = "model"
    gp = GlobalPlan(mode=mode, partition=part, assignments=assignments,
                    predicted_latency=part.predicted_latency,
                    predicted_energy=predicted_energy(dag, resources, part,
                                                      prov))
    locals_ = tuple(p1_plan(sub_dag_for(dag, a), a.node, delta=delta,
                            provider=prov)
                    for a in gp.assignments)
    lat, en = _hierarchical_cost(dag, gp, locals_, prov, objective)
    return HiDPPlan(dag_name=dag.name, global_plan=gp, local_plans=locals_,
                    predicted_latency=lat, predicted_energy=en,
                    planning_seconds=time.perf_counter() - t0)


STRATEGIES: dict[str, Strategy] = {
    "hidp": hidp_strategy,
    "modnn": modnn_strategy,
    "omniboost": omniboost_strategy,
    "disnet": disnet_strategy,
}


# --------------------------------------------------------------------------
# Frontier views — every strategy as a ParetoFront, so figures comparing
# strategies can compare whole trade-off curves, not one scalarization.
# --------------------------------------------------------------------------

def hidp_front(dag: ModelDAG, cluster: Cluster, delta: float = 1.0,
               provider: CostProvider | None = None,
               objective: Objective | None = None) -> ParetoFront:
    """HiDP's full hierarchical frontier (``objective`` only contributes its
    radio-power pricing; selection happens at the caller)."""
    return plan_front(dag, cluster, PlannerConfig(delta=delta,
                                                  provider=provider,
                                                  objective=objective))


def _single_point_front(strategy: Strategy, dag: ModelDAG, cluster: Cluster,
                        delta: float, provider: CostProvider | None,
                        objective: Objective | None) -> ParetoFront:
    p = strategy(dag, cluster, delta, provider=provider, objective=objective)
    return ParetoFront([ParetoPoint(p.predicted_latency, p.predicted_energy,
                                    p)])


def modnn_front(dag: ModelDAG, cluster: Cluster, delta: float = 1.0,
                provider: CostProvider | None = None,
                objective: Objective | None = None) -> ParetoFront:
    """MoDNN's split is fixed by its paper (capacity-proportional, ignores
    the objective), so its "frontier" is one point."""
    return _single_point_front(modnn_strategy, dag, cluster, delta, provider,
                               objective)


def omniboost_front(dag: ModelDAG, cluster: Cluster, delta: float = 1.0,
                    provider: CostProvider | None = None,
                    objective: Objective | None = None) -> ParetoFront:
    """OmniBoost's MCTS rewards throughput only — one point."""
    return _single_point_front(omniboost_strategy, dag, cluster, delta,
                               provider, objective)


def disnet_front(dag: ModelDAG, cluster: Cluster, delta: float = 1.0,
                 provider: CostProvider | None = None,
                 objective: Objective | None = None) -> ParetoFront:
    """DisNet has one real degree of freedom — its heuristic global mode
    choice — so its frontier is the skyline of the latency-picked and
    energy-picked hybrids (one or two points)."""
    obj = resolve_objective(objective)
    p_lat = disnet_strategy(dag, cluster, delta, provider=provider)
    p_en = disnet_strategy(dag, cluster, delta, provider=provider,
                           objective=Objective("energy",
                                               radio_power=obj.radio_power))
    return ParetoFront.build([
        (p.predicted_latency, p.predicted_energy, p) for p in (p_lat, p_en)])


StrategyFront = Callable[..., ParetoFront]

STRATEGY_FRONTS: dict[str, StrategyFront] = {
    "hidp": hidp_front,
    "modnn": modnn_front,
    "omniboost": omniboost_front,
    "disnet": disnet_front,
}
