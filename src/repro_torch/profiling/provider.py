"""The port's copy of ``repro.profiling.provider``.

CalibratedCostProvider — measured cost predictions behind the planner's
``CostProvider`` protocol.

Drop-in for the analytic provider everywhere the DP partitioners price
compute *and energy*: segment costs come from per-block regressor
predictions (prefix summed, so the DP's inner loop stays O(1)); scalar
compute/rate/energy queries come from fitted marginals.  Communication stays
analytic — link bandwidths are declared, not discovered, in this
reproduction.

Any (resource × kind) the model has never seen falls back to the analytic
provider, so a partially-calibrated cluster still plans everywhere.

``delta`` handling: the model is fitted in work units (δ-weighted FLOPs),
making it model-agnostic; ``at_delta`` rebinds the provider to the
requesting model's compute intensity.  ``HiDPPlanner`` and the baseline
strategies call it automatically.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.cost_model import (ANALYTIC, CostProvider, Resource)
from repro_torch.core.dag import ModelDAG

from .learned import LearnedCostModel
from .profiler import block_traffic


@dataclasses.dataclass(frozen=True)
class CalibratedCostProvider:
    model: LearnedCostModel
    fallback: CostProvider = ANALYTIC
    delta: float = 1.0

    def at_delta(self, delta: float) -> "CalibratedCostProvider":
        return dataclasses.replace(self, delta=delta)

    # ------------------------------------------------------------- protocol
    @staticmethod
    def _key(resource: Resource) -> str:
        return getattr(resource, "profile_key", "") or resource.name

    def compute_time(self, flops: float, resource: Resource,
                     kind: str = "generic") -> float:
        rate = self.model.rate(self._key(resource), kind)
        if rate is None:
            return self.fallback.compute_time(flops, resource, kind)
        return flops * self.delta / max(rate, 1e-300)

    def comm_time(self, nbytes: float, resource: Resource,
                  rtt: float | None = None) -> float:
        return self.fallback.comm_time(nbytes, resource, rtt)

    def effective_rate(self, resource: Resource,
                       kind: str = "generic") -> float:
        """Measured flops/s at the bound δ (for heterogeneity ordering)."""
        rate = self.model.rate(self._key(resource), kind)
        if rate is None:
            return self.fallback.effective_rate(resource, kind)
        return rate / max(self.delta, 1e-300)

    def block_time(self, resource: Resource, block) -> float:
        p = self.model.predict(self._key(resource), block.kind,
                               block.flops * self.delta,
                               block_traffic(block))
        if p is None:
            return self.fallback.compute_time(block.flops, resource,
                                              block.kind)
        return p

    def segment_coster(self, dag: ModelDAG, resource: Resource
                       ) -> Callable[[int, int], float]:
        """Prefix sums of per-block predictions → O(1) segment costs."""
        pre = [0.0]
        for b in dag.blocks:
            pre.append(pre[-1] + self.block_time(resource, b))

        def cost(a: int, b: int) -> float:
            return pre[b] - pre[a]

        return cost

    # ------------------------------------------------- vectorized fast path
    # Matrix/array views of the closures above for the fast DP engine —
    # elementwise bit-identical (``pre[b] - pre[a]`` is the same float64
    # subtraction whether done by the closure or by numpy broadcasting).

    def segment_cost_matrix(self, dag: ModelDAG,
                            resource: Resource) -> np.ndarray:
        pre = [0.0]
        for b in dag.blocks:
            pre.append(pre[-1] + self.block_time(resource, b))
        p = np.asarray(pre, dtype=np.float64)
        return p[None, :] - p[:, None]

    def segment_energy_matrix(self, dag: ModelDAG,
                              resource: Resource) -> np.ndarray:
        pre = [0.0]
        for b in dag.blocks:
            pre.append(pre[-1] + self.block_energy(resource, b))
        p = np.asarray(pre, dtype=np.float64)
        return p[None, :] - p[:, None]

    def comm_time_array(self, nbytes, resource: Resource,
                        rtt: float | None = None):
        """Vectorized only when the fallback is (None → the caller loops)."""
        fn = getattr(self.fallback, "comm_time_array", None)
        return None if fn is None else fn(nbytes, resource, rtt)

    def comm_energy_array(self, nbytes, resource: Resource,
                          rtt: float | None = None):
        fn = getattr(self.fallback, "comm_energy_array", None)
        return None if fn is None else fn(nbytes, resource, rtt)

    # ------------------------------------------------------------- energy
    # Fitted energy predictors answer first; a (resource × kind) without one
    # degrades gracefully to datasheet power × *calibrated* seconds (better
    # than fully-analytic: the time half is still measured), and a fully
    # unknown resource bottoms out at the analytic provider.

    def energy(self, flops: float, nbytes: float, resource: Resource,
               kind: str = "generic") -> float:
        return (self.compute_energy(flops, resource, kind)
                + self.comm_energy(nbytes, resource))

    def compute_energy(self, flops: float, resource: Resource,
                       kind: str = "generic") -> float:
        p = self.model.predict_energy(self._key(resource), kind,
                                      flops * self.delta)
        if p is None:
            return resource.active_power * self.compute_time(flops, resource,
                                                             kind)
        return p

    def comm_energy(self, nbytes: float, resource: Resource,
                    rtt: float | None = None) -> float:
        """Link energy stays analytic, like the comm latencies it prices."""
        return self.fallback.comm_energy(nbytes, resource, rtt)

    def block_energy(self, resource: Resource, block) -> float:
        p = self.model.predict_energy(self._key(resource), block.kind,
                                      block.flops * self.delta,
                                      block_traffic(block))
        if p is None:
            return resource.active_power * self.block_time(resource, block)
        return p

    def segment_energy_coster(self, dag: ModelDAG, resource: Resource
                              ) -> Callable[[int, int], float]:
        """Prefix sums of per-block energy predictions → O(1) segment J."""
        pre = [0.0]
        for b in dag.blocks:
            pre.append(pre[-1] + self.block_energy(resource, b))

        def cost(a: int, b: int) -> float:
            return pre[b] - pre[a]

        return cost

    def data_coeffs(self, dag: ModelDAG, resource: Resource
                    ) -> tuple[float, float]:
        """Price a proportional data slice consistently with the per-block
        segment costs: a fraction f of the DAG costs f·linear + fixed, where
        the fixed part carries the fitted per-block overheads (c) and the
        weight-traffic term (params do not shrink with f).  Without this,
        data partitioning would be systematically under-priced relative to
        model partitioning under calibration."""
        key = self._key(resource)
        linear = fixed = 0.0
        for b in dag.blocks:
            e = self.model.entry(key, b.kind)
            if e is not None and e.a > 0:
                linear += e.a * (b.flops * self.delta) + e.b * (
                    b.bytes_in + b.bytes_out)
                fixed += e.c + e.b * b.param_bytes
                continue
            rate = self.model.rate(key, b.kind)
            if rate is not None:
                linear += b.flops * self.delta / max(rate, 1e-300)
            else:
                linear += self.fallback.compute_time(b.flops, resource,
                                                     b.kind)
        return linear, fixed
