"""The port's copy of ``repro.core.global_partitioner``.

Tier-1 (global) partitioner — Algorithm 1 lines 3-7.

The leader node collapses every *available* node to a Resource (Λ_j, β_j),
consults the DSE agent (the DP search in ``dp_partitioner``) for both modes,
and picks Θ = min(Θ_ω, Θ_σ).  The output maps sub-workloads to nodes; the
sub-workload that lands on a node is then re-partitioned locally (tier 2).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .cost_model import (Cluster, CostProvider, Node, Resource,
                         node_as_resource, resolve_provider)
from .dag import DataPartition, ModelDAG, ModelPartition, Partition
from .dp_cache import workspace_for
from .fingerprint import dag_fingerprint
from .objective import Objective
from .pareto import ParetoFront, ParetoPoint
from . import dp_partitioner


@dataclasses.dataclass(frozen=True)
class GlobalAssignment:
    """One node's share of the request after global partitioning."""

    node: Node
    # Model mode: the contiguous block range this node executes.
    block_range: tuple[int, int] | None = None
    # Data mode: the fraction of the request's data this node executes.
    fraction: float | None = None
    # Position in the pipeline (model mode) for ordering transfers.
    stage_index: int = 0


@dataclasses.dataclass(frozen=True)
class GlobalPlan:
    mode: str                            # "model" | "data"
    partition: Partition
    assignments: tuple[GlobalAssignment, ...]
    predicted_latency: float
    predicted_energy: float


def plan_global(dag: ModelDAG, cluster: Cluster, *, delta: float = 1.0,
                weight_transfer: bool = False,
                capacity: str = "sum",
                provider: CostProvider | None = None,
                objective: Objective | None = None) -> GlobalPlan:
    """Tier-1 planning pass: collapse available nodes to (Λ_j, β_j)
    Resources, run the DP at the given ``objective``, and map the winning
    partition back onto nodes."""
    nodes = cluster.available_nodes()
    if not nodes:
        raise RuntimeError("no available nodes in cluster (A(N_φ) all-zero)")
    resources = [node_as_resource(n, delta, capacity=capacity) for n in nodes]
    plan = dp_partitioner.partition(dag, resources,
                                    weight_transfer=weight_transfer,
                                    provider=provider, objective=objective)
    # report energy with the objective's radio term so the figure quoted in
    # GlobalPlan matches what the DP minimized (0 under the default
    # objective — the seed algebra)
    radio = objective.radio_power if objective is not None else 0.0
    energy = dp_partitioner.predicted_energy(dag, resources, plan, provider,
                                             radio_power=radio)
    return _as_global_plan(plan, nodes, energy)


def _as_global_plan(plan: Partition, nodes: Sequence[Node],
                    energy: float) -> GlobalPlan:
    """Map a winning Partition back onto cluster nodes."""
    assignments: list[GlobalAssignment] = []
    if isinstance(plan, ModelPartition):
        for si in range(plan.num_stages):
            a, b = plan.boundaries[si], plan.boundaries[si + 1]
            assignments.append(GlobalAssignment(
                node=nodes[plan.assignment[si]], block_range=(a, b),
                stage_index=si))
        mode = "model"
    else:
        assert isinstance(plan, DataPartition)
        for si, (f, ri) in enumerate(zip(plan.fractions, plan.assignment)):
            assignments.append(GlobalAssignment(
                node=nodes[ri], fraction=f, stage_index=si))
        mode = "data"
    return GlobalPlan(mode=mode, partition=plan,
                      assignments=tuple(assignments),
                      predicted_latency=plan.predicted_latency,
                      predicted_energy=energy)


def plan_global_front(dag: ModelDAG, cluster: Cluster, *, delta: float = 1.0,
                      weight_transfer: bool = False,
                      capacity: str = "sum",
                      provider: CostProvider | None = None,
                      radio_power: float = 0.0,
                      width: int | None = None) -> ParetoFront:
    """Tier-1 frontier: every non-dominated (latency, energy) trade-off over
    both partitioning modes, mapped onto nodes as :class:`GlobalPlan`\\ s.

    The front's ``latency_optimal`` plan is exactly what :func:`plan_global`
    returns under the default objective (the seed DP, bit-identical);
    ``radio_power`` prices wireless transfer seconds into every point's
    energy, matching what a scalarized pass would have minimized."""
    nodes = cluster.available_nodes()
    if not nodes:
        raise RuntimeError("no available nodes in cluster (A(N_φ) all-zero)")
    prov = resolve_provider(provider)
    ws = workspace_for(prov)
    if ws is not None:
        # Keyed on the available-node tuple (frozen dataclasses), so distinct
        # membership masks memo side by side and a warm tier-1 pass skips the
        # Resource collapse and GlobalPlan mapping entirely.
        rkey = ("pgf", dag_fingerprint(dag), tuple(nodes), delta,
                weight_transfer, capacity, radio_power, width)
        memo = ws.results.get(rkey)
        if memo is not None:
            return memo
    resources = [node_as_resource(n, delta, capacity=capacity) for n in nodes]
    pf = dp_partitioner.partition_front(dag, resources,
                                        weight_transfer=weight_transfer,
                                        provider=prov,
                                        radio_power=radio_power, width=width)
    front = ParetoFront([
        ParetoPoint(p.latency, p.energy,
                    _as_global_plan(p.plan, nodes, p.energy))
        for p in pf])
    if ws is not None:
        ws.results.put(rkey, front)
    return front
