"""The port's copy of ``repro.runtime.elastic``, planning for its own chip.

Elastic scaling: re-plan and re-mesh when availability changes.

When a pod or host (or a chip group) joins or leaves, the HiDP planner re-runs
with the new availability vector — the same Ψ/A machinery as the paper's
leader node probing the cluster (Alg. 1 line 3) — producing a new
ShardingPlan for the surviving mesh.  Every (re-)plan goes through
``sharding.plan.plan`` with the controller's ``chip``: the H100 unless the
caller passes another :class:`~repro_torch.sharding.plan.ChipSpec` (the
parity tests pass ``V5E`` to reproduce the reference's ``plan_tpu``).
Moving parameters onto the new mesh waits for the port's multi-GPU slice.

:meth:`ElasticController.on_epoch` closes the loop with the fleet layer:
wire it as (or from) a ``repro_torch.fleet.FleetController``'s ``on_epoch``
callback and every membership epoch — a simulated edge node leaving, or a
real pod dropping out — resizes the elastic world to the epoch's
available-node count.  With a ``telemetry=`` recorder the controller emits
an ``elastic.world`` gauge per epoch and an ``elastic.replan`` counter per
actual re-plan (see docs/observability.md).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ShapeConfig
from repro_torch.models.model import Model
from repro_torch.sharding.plan import (H100, ChipSpec, MeshDesc,
                                       ShardingPlan, plan)


@dataclasses.dataclass
class ElasticController:
    model: Model
    shape: ShapeConfig
    base_mesh: MeshDesc
    current_plan: ShardingPlan | None = None
    replans: int = 0
    telemetry: object = None
    chip: ChipSpec = H100

    def __post_init__(self):
        from repro_torch.telemetry import active as _tel_active
        self.telemetry = _tel_active(self.telemetry)

    def initial_plan(self) -> ShardingPlan:
        self.current_plan = plan(self.model, self.shape, self.base_mesh,
                                 self.chip)
        return self.current_plan

    def shrunk_mesh(self, available_pods: int, *,
                    data_scale: float = 1.0) -> MeshDesc:
        """Mesh for a reduced fleet.  Pods leave whole (the DCN failure
        domain); intra-pod shrink rescales the data axis."""
        axes, shape = list(self.base_mesh.axes), list(self.base_mesh.shape)
        if "pod" in axes:
            shape[axes.index("pod")] = max(available_pods, 1)
            if available_pods <= 1:
                i = axes.index("pod")
                del axes[i], shape[i]
        if data_scale != 1.0 and "data" in axes:
            i = axes.index("data")
            shape[i] = max(int(shape[i] * data_scale), 1)
        return MeshDesc(tuple(axes), tuple(shape))

    def on_availability_change(self, available_pods: int) -> ShardingPlan:
        """Re-enter EXPLORE with the new A(N_φ): fresh plan for the
        surviving mesh.  A no-op (same plan object) when nothing changed."""
        mesh = self.shrunk_mesh(available_pods)
        if (self.current_plan is not None
                and mesh == self.current_plan.mesh):
            return self.current_plan
        self.replans += 1
        if self.telemetry is not None:
            self.telemetry.counter("elastic.replan", reason="availability",
                                   pods=available_pods,
                                   mesh="x".join(map(str, mesh.shape)))
        self.current_plan = plan(self.model, self.shape, mesh, self.chip)
        return self.current_plan

    def on_epoch(self, epoch) -> ShardingPlan:
        """Membership-epoch adapter: wire this as (or from) a
        ``repro_torch.fleet.FleetController.on_epoch`` callback.  The epoch's
        available-node count becomes the elastic world size — a departed
        node shrinks the mesh, a returned one grows it back — and the
        transition lands as an ``elastic.world`` gauge."""
        world = int(epoch.available())
        if self.telemetry is not None:
            self.telemetry.gauge(
                "elastic.world", float(world),
                t=getattr(epoch, "time", None) or 0.0,
                epoch=getattr(epoch, "epoch", None),
                fingerprint=getattr(epoch, "fingerprint", "")[:12])
        return self.on_availability_change(world)

    def on_drift(self) -> ShardingPlan:
        """Re-enter EXPLORE because the cost model drifted, not because the
        fleet changed: the mesh stays, the plan is recomputed.  This is the
        hook a ``repro_torch.profiling.FeedbackLoop`` fires when predicted and
        measured shard latencies diverge past its threshold."""
        mesh = (self.current_plan.mesh if self.current_plan is not None
                else self.base_mesh)
        self.replans += 1
        if self.telemetry is not None:
            self.telemetry.counter("elastic.replan", reason="drift",
                                   mesh="x".join(map(str, mesh.shape)))
        self.current_plan = plan(self.model, self.shape, mesh, self.chip)
        return self.current_plan
