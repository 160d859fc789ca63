"""The port's copy of ``repro.core.cost_model``.

HiDP cost model — §III "System Model" of the paper, verbatim algebra.

* processor compute rate        λ_k = f_k / δ           [flops/s]      (Eq. ρ)
* node compute rate             Λ_j = Σ_k λ_k           [flops/s]      (Eq. 2)
* local  comm rate              μ_k                     [bytes/s]
* local  ratio vector           ψ = {λ_k/μ_k}                          (Eq. 1)
* global comm rate              β_j                     [bytes/s]
* global ratio vector           Ψ = {Λ_j/β_j}                          (Eq. 3)
* availability vector           A(N_φ) = {α_j ∈ {0,1}}                 (Eq. 4)

The same classes describe (a) the paper's edge boards (Table II) for the
faithful reproduction and (b) TPU pods/chips for the production launcher —
only the numbers differ (see DESIGN.md §2).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Protocol, Sequence, runtime_checkable

import numpy as np

if TYPE_CHECKING:
    from .dag import ModelDAG


# --------------------------------------------------------------------------
# Hardware descriptions
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Processor:
    """One processing unit ρ_k inside a node: CPU cluster, GPU, NPU — or, in
    the TPU guise, one intra-pod sharding *lane* (a group of chips reachable
    at ICI bandwidth)."""

    name: str
    kind: str                    # "cpu" | "gpu" | "npu" | "tpu"
    peak_flops: float            # f_k / δ at δ=1; per-model δ rescales this
    local_bw: float              # μ_k — bytes/s to peers inside the node
    idle_power: float = 0.0      # W
    active_power: float = 0.0    # W
    # Per-block-kind efficiency multipliers (the "CPU-friendly layer" effect;
    # §I: "CPU-friendly layers of DNN models"). 1.0 = peak.
    affinity: tuple[tuple[str, float], ...] = ()

    def rate(self, delta: float = 1.0, kind: str = "generic") -> float:
        """λ_k = f_k/δ, modulated by the layer-kind affinity."""
        eff = dict(self.affinity).get(kind, 1.0)
        return self.peak_flops * eff / max(delta, 1e-12)


@dataclasses.dataclass(frozen=True)
class Node:
    """Edge node φ_j (or TPU pod). ``net_bw`` is β_j in bytes/s.

    ``default_processor`` is the framework-default unit (the paper's "P1"
    behaviour: TensorFlow schedules on GPU unless told otherwise; on boards
    without a usable GPU delegate the default is the CPU)."""

    name: str
    processors: tuple[Processor, ...]
    net_bw: float                # β_j — bytes/s on the inter-node link
    available: bool = True       # α_j
    default_processor: str = "gpu"

    def compute_rate(self, delta: float = 1.0, kind: str = "generic") -> float:
        """Λ_j(ρ_k) = Σ_k λ_k   (Eq. 2)."""
        return sum(p.rate(delta, kind) for p in self.processors)

    def default_rate(self, delta: float = 1.0, kind: str = "generic") -> float:
        """Capacity as global-only strategies see it: they profile a node by
        timing inference with the default runtime, which exercises only the
        default processor (§I — "misrepresents the compute capacity")."""
        for p in self.processors:
            if p.kind == self.default_processor:
                return p.rate(delta, kind)
        return max(p.rate(delta, kind) for p in self.processors)

    def psi(self, delta: float = 1.0) -> tuple[float, ...]:
        """ψ{λ, μ} = {λ_k/μ_k}   (Eq. 1)."""
        return tuple(p.rate(delta) / p.local_bw for p in self.processors)


@dataclasses.dataclass(frozen=True)
class Cluster:
    """The edge cluster N(φ_j)."""

    nodes: tuple[Node, ...]

    def availability(self) -> tuple[int, ...]:
        """A(N_φ)   (Eq. 4)."""
        return tuple(1 if n.available else 0 for n in self.nodes)

    def available_nodes(self) -> tuple[Node, ...]:
        return tuple(n for n in self.nodes if n.available)

    def Psi(self, delta: float = 1.0) -> tuple[float, ...]:
        """Ψ{Λ, β} = {Λ_j/β_j}   (Eq. 3) over *available* nodes."""
        return tuple(n.compute_rate(delta) / n.net_bw
                     for n in self.available_nodes())

    def with_availability(self, alphas: Sequence[bool]) -> "Cluster":
        if len(alphas) != len(self.nodes):
            raise ValueError("availability vector length mismatch")
        return Cluster(tuple(
            dataclasses.replace(n, available=bool(a))
            for n, a in zip(self.nodes, alphas)))


# --------------------------------------------------------------------------
# Latency primitives used by the DP partitioners
# --------------------------------------------------------------------------

def compute_time(flops: float, rate: float) -> float:
    """Θ for a block on a resource at λ (or Λ) flops/s."""
    return flops / max(rate, 1e-12)


def comm_time(nbytes: float, bw: float, rtt: float = 0.0) -> float:
    return rtt + nbytes / max(bw, 1e-12)


@dataclasses.dataclass(frozen=True)
class Resource:
    """Uniform view the DP algorithm sees, at either tier (paper §III:
    "the function arguments are essentially the same in either case").

    Global tier: one Resource per available node  — rate Λ_j, bw β_j.
    Local  tier: one Resource per processor ρ_k   — rate λ_k, bw μ_k.
    """

    name: str
    rate: float                  # flops/s (already δ- and affinity-adjusted)
    bw: float                    # bytes/s toward the coordinator
    rtt: float = 0.0             # fixed per-transfer latency (s)
    active_power: float = 0.0    # W, for energy accounting
    idle_power: float = 0.0
    # Which calibration entries describe this resource ("" → use ``name``).
    # Distinguishes a node's Λ=Σλ view ("orin_nx") from the default-runtime
    # view global-only strategies probe ("orin_nx/gpu").
    profile_key: str = ""

    def time_for(self, block_flops: float, xfer_bytes: float) -> float:
        return compute_time(block_flops, self.rate) + comm_time(
            xfer_bytes, self.bw, self.rtt)


# --------------------------------------------------------------------------
# Cost providers — pluggable latency prediction
# --------------------------------------------------------------------------

@runtime_checkable
class CostProvider(Protocol):
    """How the planner prices compute, communication, and energy on a
    :class:`Resource`.

    The analytic provider reproduces the paper's closed-form algebra
    (the seed behaviour, bit-identical); a calibrated provider
    (``repro_torch.profiling.CalibratedCostProvider``) answers from regressors
    fitted to measured samples — the paper's DNN Model Analyzer.

    Latency queries:

    * ``compute_time(flops, resource, kind)`` — seconds to execute
      ``flops`` on the resource.
    * ``comm_time(nbytes, resource, rtt)`` — seconds to move ``nbytes``
      over the resource's link (``rtt=None`` uses the resource's own).
    * ``effective_rate(resource, kind)`` — flops/s as the provider believes
      them; orders resources by heterogeneity.
    * ``segment_coster(dag, resource)`` — O(1) ``cost(a, b)`` for the
      compute seconds of ``dag.blocks[a:b]`` (prefix-summed).
    * ``data_coeffs(dag, resource)`` — ``(linear, fixed)`` seconds pricing a
      proportional data slice: fraction *f* costs ``f·linear + fixed``.

    Energy queries (J; the active-power draw while the resource works —
    idle power is accounted by the caller over the plan makespan):

    * ``energy(flops, nbytes, resource, kind)`` — joules to execute
      ``flops`` and move ``nbytes`` on the resource.
    * ``compute_energy(flops, resource, kind)`` / ``comm_energy(nbytes,
      resource, rtt)`` — the two terms of ``energy`` separately.
    * ``segment_energy_coster(dag, resource)`` — O(1) ``cost(a, b)`` for
      the compute joules of ``dag.blocks[a:b]``.

    ``at_delta(delta)`` rebinds the provider to a model's compute intensity
    (cycles/flop); the analytic provider is δ-invariant because its
    resources arrive already δ-adjusted.
    """

    def compute_time(self, flops: float, resource: Resource,
                     kind: str = "generic") -> float: ...

    def comm_time(self, nbytes: float, resource: Resource,
                  rtt: float | None = None) -> float: ...

    def effective_rate(self, resource: Resource,
                       kind: str = "generic") -> float: ...

    def segment_coster(self, dag: "ModelDAG", resource: Resource
                       ) -> Callable[[int, int], float]: ...

    def data_coeffs(self, dag: "ModelDAG", resource: Resource
                    ) -> tuple[float, float]: ...

    def energy(self, flops: float, nbytes: float, resource: Resource,
               kind: str = "generic") -> float: ...

    def compute_energy(self, flops: float, resource: Resource,
                       kind: str = "generic") -> float: ...

    def comm_energy(self, nbytes: float, resource: Resource,
                    rtt: float | None = None) -> float: ...

    def segment_energy_coster(self, dag: "ModelDAG", resource: Resource
                              ) -> Callable[[int, int], float]: ...

    def at_delta(self, delta: float) -> "CostProvider": ...


class AnalyticCostProvider:
    """Datasheet algebra: Θ = flops/rate, comm = rtt + bytes/bw.

    Every method reduces to exactly the arithmetic the seed modules inlined,
    so planning with this provider is bit-identical to planning without one.
    """

    def compute_time(self, flops: float, resource: Resource,
                     kind: str = "generic") -> float:
        return compute_time(flops, resource.rate)

    def comm_time(self, nbytes: float, resource: Resource,
                  rtt: float | None = None) -> float:
        return comm_time(nbytes, resource.bw,
                         resource.rtt if rtt is None else rtt)

    def effective_rate(self, resource: Resource,
                       kind: str = "generic") -> float:
        return resource.rate

    def segment_coster(self, dag: "ModelDAG", resource: Resource
                       ) -> Callable[[int, int], float]:
        """O(1) segment compute cost via the DAG's FLOP prefix sums."""
        cum = dag.cumulative_flops()
        rate = resource.rate

        def cost(a: int, b: int) -> float:
            return compute_time(cum[b] - cum[a], rate)

        return cost

    def data_coeffs(self, dag: "ModelDAG", resource: Resource
                    ) -> tuple[float, float]:
        """(seconds per unit data fraction, fixed per-slice seconds) for a
        proportional slice of the whole DAG.  The analytic model has no
        per-block overheads, so the fixed part is zero."""
        return (self.compute_time(dag.total_flops, resource,
                                  dag.dominant_kind()), 0.0)

    # ------------------------------------------------------------- energy
    # The datasheet energy model is P_active × time — exactly the algebra the
    # seed's ``predicted_energy`` inlined, now queryable per term so the DP
    # can minimize energy directly.

    def energy(self, flops: float, nbytes: float, resource: Resource,
               kind: str = "generic") -> float:
        """J to execute ``flops`` and move ``nbytes``: active_power × time."""
        return (self.compute_energy(flops, resource, kind)
                + self.comm_energy(nbytes, resource))

    def compute_energy(self, flops: float, resource: Resource,
                       kind: str = "generic") -> float:
        return resource.active_power * self.compute_time(flops, resource,
                                                         kind)

    def comm_energy(self, nbytes: float, resource: Resource,
                    rtt: float | None = None) -> float:
        return resource.active_power * self.comm_time(nbytes, resource, rtt)

    def segment_energy_coster(self, dag: "ModelDAG", resource: Resource
                              ) -> Callable[[int, int], float]:
        """O(1) segment compute energy: active_power × segment seconds."""
        coster = self.segment_coster(dag, resource)
        watts = resource.active_power

        def cost(a: int, b: int) -> float:
            return watts * coster(a, b)

        return cost

    # ------------------------------------------------- vectorized fast path
    # Array variants of the queries above, elementwise bit-identical to the
    # scalar ones (same operations in the same order, IEEE-754 float64
    # throughout) — the fast DP engine builds its transition matrices from
    # these instead of calling the scalar closures O(n²·m) times.

    def segment_cost_matrix(self, dag: "ModelDAG",
                            resource: Resource) -> np.ndarray:
        """``M[a, b] == segment_coster(dag, resource)(a, b)`` bit-exactly:
        (cum[b] − cum[a]) / max(rate, 1e-12), vectorized."""
        cum = np.asarray(dag.cumulative_flops(), dtype=np.float64)
        return (cum[None, :] - cum[:, None]) / max(resource.rate, 1e-12)

    def segment_energy_matrix(self, dag: "ModelDAG",
                              resource: Resource) -> np.ndarray:
        """``M[a, b] == segment_energy_coster(dag, resource)(a, b)``."""
        return resource.active_power * self.segment_cost_matrix(dag, resource)

    def comm_time_array(self, nbytes, resource: Resource,
                        rtt: float | None = None) -> np.ndarray:
        """Elementwise ``comm_time`` over an array of byte counts."""
        r = resource.rtt if rtt is None else rtt
        return r + np.asarray(nbytes, dtype=np.float64) / max(
            resource.bw, 1e-12)

    def comm_energy_array(self, nbytes, resource: Resource,
                          rtt: float | None = None) -> np.ndarray:
        return resource.active_power * self.comm_time_array(nbytes, resource,
                                                            rtt)

    def at_delta(self, delta: float) -> "AnalyticCostProvider":
        """Resources arrive already δ-adjusted; nothing to rebind."""
        return self


ANALYTIC = AnalyticCostProvider()


def resolve_provider(provider: CostProvider | None) -> CostProvider:
    return ANALYTIC if provider is None else provider


def node_as_resource(node: Node, delta: float = 1.0, kind: str = "generic",
                     capacity: str = "sum") -> Resource:
    """Global-tier view: collapse a node to (Λ_j, β_j).

    ``capacity="sum"`` is HiDP's Λ_j = Σλ_k (justified because its local tier
    actually realises it); ``capacity="default"`` is what global-only
    strategies measure when profiling the default runtime (P1)."""
    rate = (node.compute_rate(delta, kind) if capacity == "sum"
            else node.default_rate(delta, kind))
    if capacity == "sum":
        profile_key = node.name                     # Λ = Σλ over calibrations
    else:
        default = next((p.name for p in node.processors
                        if p.kind == node.default_processor), None)
        profile_key = f"{node.name}/{default}" if default else node.name
    return Resource(
        name=node.name,
        rate=rate,
        bw=node.net_bw,
        rtt=2e-3,  # wireless round-trip floor; overridden for TPU DCN
        active_power=sum(p.active_power for p in node.processors),
        idle_power=sum(p.idle_power for p in node.processors),
        profile_key=profile_key,
    )


def processors_as_resources(node: Node, delta: float = 1.0,
                            kind: str = "generic") -> tuple[Resource, ...]:
    """Local-tier view: each ρ_k as (λ_k, μ_k)."""
    return tuple(
        Resource(name=f"{node.name}/{p.name}", rate=p.rate(delta, kind),
                 bw=p.local_bw, rtt=2e-5,
                 active_power=p.active_power, idle_power=p.idle_power)
        for p in node.processors)


# --------------------------------------------------------------------------
# TPU production constants (v5e) — used by the roofline and the TPU-guise
# cost model.  Single source of truth for benchmarks/roofline.py.
# --------------------------------------------------------------------------

TPU_V5E_PEAK_FLOPS = 197e12        # bf16 FLOP/s per chip
TPU_V5E_HBM_BW = 819e9             # bytes/s per chip
TPU_V5E_ICI_BW = 50e9              # bytes/s per link (~intra-pod)
TPU_V5E_DCN_BW = 25e9              # bytes/s per pod-pair (inter-pod, approx)
TPU_V5E_TDP = 215.0                # W per chip (nameplate-ish, for energy est)


def tpu_chip(name: str = "v5e") -> Processor:
    return Processor(name=name, kind="tpu", peak_flops=TPU_V5E_PEAK_FLOPS,
                     local_bw=TPU_V5E_ICI_BW, idle_power=60.0,
                     active_power=TPU_V5E_TDP)


def tpu_pod(name: str, chips: int = 256) -> Node:
    return Node(name=name,
                processors=tuple(
                    dataclasses.replace(tpu_chip(), name=f"chip{i}")
                    for i in range(chips)),
                net_bw=TPU_V5E_DCN_BW)


# --------------------------------------------------------------------------
# NVIDIA H100 SXM constants — the port's device.  Datasheet values,
# unmeasured until calibrated: a CalibratedCostProvider fitted from
# ``repro_torch.profiling.calibrate_kernels`` replaces them where it has
# samples.
# --------------------------------------------------------------------------

H100_PEAK_FLOPS = 989e12           # dense bf16 FLOP/s per GPU (tensor cores)
H100_HBM_BW = 3.35e12              # HBM3 bytes/s per GPU
H100_NVLINK_BW = 450e9             # NVLink 4 bytes/s, one direction of 900 GB/s
H100_NET_BW = 50e9                 # one 400 Gb/s NDR InfiniBand port per GPU
H100_TDP = 700.0                   # W, SXM board power limit
# the datasheet gives no idle draw; 0 until measured


def gpu_chip(name: str = "h100") -> Processor:
    return Processor(name=name, kind="gpu", peak_flops=H100_PEAK_FLOPS,
                     local_bw=H100_NVLINK_BW, idle_power=0.0,
                     active_power=H100_TDP)


def gpu_node(name: str, chips: int = 1) -> Node:
    """One host of ``chips`` H100s, processors ``gpu0 .. gpu{chips-1}``: the
    local tier's resources are ``<name>/gpu<i>``, the global tier's
    ``<name>``."""
    return Node(name=name,
                processors=tuple(
                    dataclasses.replace(gpu_chip(), name=f"gpu{i}")
                    for i in range(chips)),
                net_bw=H100_NET_BW, default_processor="gpu")
