"""The port's copy of ``repro.core.local_partitioner``.

Tier-2 (local) partitioner — Algorithm 1 lines 8-10.

Each node re-partitions its assigned sub-workload across its own processors
ρ_k using the *same* DP search, now driven by the local ratio vector
ψ = {λ_k/μ_k}.  This is the tier that the SoA strategies lack (Table I) and
the source of the "P1 is never optimal" observation of Fig. 1: on a Jetson,
running a whole block on the GPU alone loses to a tuned CPU+GPU split.

Block-kind affinity makes the split heterogeneity-aware: λ_k is modulated per
block kind (conv/attn/moe/ssm/...), the paper's "CPU-friendly layers" effect.
In the TPU guise, processors are sharding lanes and affinity encodes
per-(block-kind × axis) sharding efficiency (DESIGN.md §2).
"""

from __future__ import annotations

import dataclasses

from .cost_model import (CostProvider, Node, Resource, resolve_provider,
                         processors_as_resources)
from .dag import DataPartition, ModelDAG, ModelPartition, Partition
from .dp_cache import workspace_for
from .fingerprint import dag_fingerprint
from .objective import Objective, resolve_objective
from .pareto import ParetoFront, ParetoPoint
from . import dp_partitioner


@dataclasses.dataclass(frozen=True)
class LocalPlan:
    node_name: str
    mode: str                        # "model" | "data"
    partition: Partition
    predicted_latency: float
    predicted_energy: float


def dominant_kind(dag: ModelDAG) -> str:
    """The block kind carrying the most FLOPs — used to pick the affinity row
    when collapsing a sub-workload to a single scalar rate."""
    return dag.dominant_kind()


def plan_local(sub_dag: ModelDAG, node: Node, *, delta: float = 1.0,
               provider: CostProvider | None = None,
               objective: Objective | None = None) -> LocalPlan:
    """Tier-2 planning pass: re-partition ``sub_dag`` over the node's own
    processors with the same DP, minimizing ``objective.local()`` — the same
    metric as the global tier, unconstrained and without the radio term
    (intra-node links are DRAM copies, not wireless)."""
    kind = dominant_kind(sub_dag)
    resources = processors_as_resources(node, delta, kind)
    obj = resolve_objective(objective).local()
    plan = dp_partitioner.partition(sub_dag, resources, provider=provider,
                                    objective=obj)
    energy = dp_partitioner.predicted_energy(sub_dag, resources, plan,
                                             provider)
    mode = "model" if isinstance(plan, ModelPartition) else "data"
    return LocalPlan(node_name=node.name, mode=mode, partition=plan,
                     predicted_latency=plan.predicted_latency,
                     predicted_energy=energy)


def plan_local_front(sub_dag: ModelDAG, node: Node, *, delta: float = 1.0,
                     provider: CostProvider | None = None,
                     width: int | None = None) -> ParetoFront:
    """Tier-2 frontier: the node's own latency–energy trade-offs for
    ``sub_dag`` over its processors.  No radio term — intra-node transfers
    are DRAM copies, not wireless.  The front's ``latency_optimal`` plan is
    exactly :func:`plan_local`'s answer under the default objective."""
    prov = resolve_provider(provider)
    ws = workspace_for(prov)
    if ws is not None:
        # Node is a frozen dataclass, so the hierarchical hot path can memo
        # the *wrapped* front per (sub-workload, node, δ) — a warm pass skips
        # even the LocalPlan re-wrapping, not just the DP underneath.
        rkey = ("plf", dag_fingerprint(sub_dag), node, delta, width)
        memo = ws.results.get(rkey)
        if memo is not None:
            return memo
    kind = dominant_kind(sub_dag)
    resources = processors_as_resources(node, delta, kind)
    pf = dp_partitioner.partition_front(sub_dag, resources, provider=prov,
                                        width=width)
    points = []
    for p in pf:
        mode = "model" if isinstance(p.plan, ModelPartition) else "data"
        points.append(ParetoPoint(p.latency, p.energy, LocalPlan(
            node_name=node.name, mode=mode, partition=p.plan,
            predicted_latency=p.latency, predicted_energy=p.energy)))
    front = ParetoFront(points)
    if ws is not None:
        ws.results.put(rkey, front)
    return front


def p1_plan(sub_dag: ModelDAG, node: Node, *, delta: float = 1.0,
            processor_kind: str | None = None,
            provider: CostProvider | None = None) -> LocalPlan:
    """The SoA default (Fig. 1 config "P1"): run the whole block on a single
    processor — the framework-default device — with no local partitioning.
    Used by the MoDNN/OmniBoost/DisNet baselines and the Fig. 1 benchmark."""
    prov = resolve_provider(provider)
    kind = dominant_kind(sub_dag)
    resources = processors_as_resources(node, delta, kind)
    # Prefer the requested processor kind; fall back to the fastest.
    if processor_kind is None:
        processor_kind = node.default_processor
    idx = next((i for i, p in enumerate(node.processors)
                if p.kind == processor_kind), None)
    if idx is None:
        idx = max(range(len(resources)),
                  key=lambda i: prov.effective_rate(resources[i], kind))
    r = resources[idx]
    # per-block segment pricing (identical to total-FLOPs ÷ rate for the
    # analytic provider; carries fitted per-block overheads when calibrated)
    lat = (prov.segment_coster(sub_dag, r)(0, len(sub_dag.blocks))
           + prov.comm_time(sub_dag.input_bytes + sub_dag.output_bytes, r))
    plan = DataPartition(fractions=(1.0,), assignment=(idx,),
                         predicted_latency=lat)
    energy = dp_partitioner.predicted_energy(sub_dag, resources, plan, prov)
    return LocalPlan(node_name=node.name, mode="data", partition=plan,
                     predicted_latency=lat, predicted_energy=energy)
