"""The port's sharding planner and elastic controller against the JAX
package's: ``plan_tpu`` equals ``repro.sharding.plan.plan_tpu`` on every
applicable cell (every field but ``planning_seconds``, ``predicted`` float
for float), ``plan_gpu`` gives valid plans on both GPU meshes, and
``ElasticController`` re-plans as the reference does, through the port's
own ``FleetController`` and ``TelemetryRecorder``."""

import dataclasses

import pytest

from repro.configs import ARCH_IDS, get_config as jget_config
from repro.core.edge_models import paper_cluster as jpaper_cluster
from repro.fleet import ChurnTrace as JChurnTrace
from repro.fleet import FleetController as JFleetController
from repro.models import build_model as jbuild_model
from repro.models.config import SHAPES as JSHAPES
from repro.runtime.elastic import ElasticController as JElasticController
from repro.sharding import plan as jplan
from repro_torch.configs import get_config
from repro_torch.core import cost_model as cm
from repro_torch.core.edge_models import paper_cluster
from repro_torch.fleet import ChurnTrace, FleetController
from repro_torch.models import SHAPES, build_model, shape_applicable
from repro_torch.runtime import ElasticController
from repro_torch.sharding.plan import (GPU_MULTI_NODE, GPU_NODE, H100,
                                       MULTI_POD, SINGLE_POD, V5E, plan,
                                       plan_gpu, plan_tpu)
from repro_torch.telemetry import TelemetryRecorder

MOE = "qwen3-moe-30b-a3b"


def _fields(p) -> dict:
    d = dataclasses.asdict(p)
    d.pop("planning_seconds")
    return d


def _cells(aid):
    cfg = get_config(aid)
    return [(name, shape) for name, shape in SHAPES.items()
            if shape_applicable(cfg, shape)[0]]


def test_chip_specs_carry_the_reference_and_datasheet_constants():
    assert (V5E.peak, V5E.hbm, V5E.ici, V5E.dcn) == tuple(
        jplan.CHIP[k] for k in ("peak", "hbm", "ici", "dcn"))
    assert V5E.hbm_per_chip == jplan.HBM_PER_CHIP and V5E.node is cm.tpu_pod
    assert (H100.peak, H100.hbm, H100.ici, H100.dcn, H100.hbm_per_chip) == (
        cm.H100_PEAK_FLOPS, cm.H100_HBM_BW, cm.H100_NVLINK_BW,
        cm.H100_NET_BW, 80e9)
    assert H100.node is cm.gpu_node
    assert (SINGLE_POD, MULTI_POD) == tuple(
        type(SINGLE_POD)(m.axes, m.shape)
        for m in (jplan.SINGLE_POD, jplan.MULTI_POD))
    assert (GPU_NODE.total_chips, GPU_MULTI_NODE.total_chips) == (8, 16)
    assert GPU_MULTI_NODE.n_pods == 2 and GPU_MULTI_NODE.chips_per_pod == 8


@pytest.mark.parametrize("mesh", ["SINGLE_POD", "MULTI_POD"])
@pytest.mark.parametrize("aid", ARCH_IDS)
def test_plan_tpu_equals_the_jax_planner(aid, mesh):
    """Every applicable shape of one (arch, mesh): the same plan, field by
    field, and the same three predicted terms to the last bit."""
    model, jmodel = build_model(get_config(aid)), jbuild_model(jget_config(aid))
    ours_mesh, jmesh = {"SINGLE_POD": (SINGLE_POD, jplan.SINGLE_POD),
                        "MULTI_POD": (MULTI_POD, jplan.MULTI_POD)}[mesh]
    for name, shape in _cells(aid):
        ours = plan_tpu(model, shape, ours_mesh)
        theirs = jplan.plan_tpu(jmodel, JSHAPES[name], jmesh)
        assert _fields(ours) == _fields(theirs), (aid, name)
        assert _fields(plan(model, shape, ours_mesh, V5E)) == _fields(ours)


@pytest.mark.parametrize("kw", [
    dict(force_layout="dp_tp"), dict(moe_impl="ep_a2a_q8"),
    dict(force_layout="dp_tp_ep", moe_impl="ep_a2a"),
    dict(force_layout="dp_sp_fsdp_ep_q8", moe_impl="ep_a2a_q8"),
    dict(force_global="model"), dict(moe_impl="dense")],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_plan_tpu_forced_choices_equal_the_jax_planner(kw):
    """A layout a shape does not offer (decode has no ``dp_sp_fsdp``)
    raises in both packages."""
    model, jmodel = build_model(get_config(MOE)), jbuild_model(jget_config(MOE))
    planned = 0
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        for mesh, jmesh in ((SINGLE_POD, jplan.SINGLE_POD),
                            (MULTI_POD, jplan.MULTI_POD)):
            try:
                theirs = jplan.plan_tpu(jmodel, JSHAPES[name], jmesh, **kw)
            except ValueError:
                with pytest.raises(ValueError):
                    plan_tpu(model, SHAPES[name], mesh, **kw)
                continue
            ours = plan_tpu(model, SHAPES[name], mesh, **kw)
            assert _fields(ours) == _fields(theirs), (name, mesh)
            planned += 1
            for k, v in kw.items():
                if k == "force_layout":
                    assert ours.local_layout == v
                elif k == "moe_impl":
                    assert ours.moe_impl == v
    assert planned >= 4


@pytest.mark.parametrize("aid", ARCH_IDS)
def test_plan_gpu_emits_valid_plans_for_all_cells(aid):
    """``tests/test_training.py::test_planner_emits_valid_plans_for_all_cells``
    on the H100 meshes, plus the fit test against 80 GB."""
    model = build_model(get_config(aid))
    for name, shape in _cells(aid):
        for mesh in (GPU_NODE, GPU_MULTI_NODE):
            p = plan_gpu(model, shape, mesh)
            assert p.mesh == mesh and p.local_layout, (aid, name)
            assert p.predicted["total"] >= 0
            assert p.dp_size <= max(shape.global_batch, 1) or p.seq_axes
            if p.predicted["fits"]:
                assert p.predicted["resident"] <= 0.92 * 80e9
                assert p.predicted["total"] == max(
                    p.predicted[k] for k in ("compute", "memory",
                                             "collective"))


def _least_resident(model, shape, mesh, chip) -> float:
    """The smallest resident bytes over every layout, each forced."""
    layouts = {"P1_pure_dp", "dp_tp", "dp_tp_fsdp", "fsdp_all", "dp_sp_fsdp",
               "seq_tp", "ctx_tp", "tp_all"}
    seen = []
    for layout in layouts:
        for suffix in ("", "_ep", "_ep_q8"):
            try:
                p = plan(model, shape, mesh, chip,
                         force_layout=layout + suffix)
            except ValueError:                  # no candidate of that name
                continue
            seen.append(p.predicted["resident"])
    return min(seen)


@pytest.mark.parametrize("aid,shape,mesh,fits_h100", [
    ("gemma-2b", "train_4k", GPU_NODE, True),
    ("mistral-large-123b", "decode_32k", GPU_NODE, False)],
    ids=["fits-80GB-not-16GB", "fits-neither"])
def test_plan_falls_back_to_the_least_resident_layout(aid, shape, mesh,
                                                      fits_h100):
    """The fit test reads the chip's HBM: a cell that fits 80 GB but not
    16 GB takes the cheapest layout on the H100 and the least-resident one
    on the v5e; a cell that fits neither takes the least-resident one on
    both."""
    model = build_model(get_config(aid))
    shape = SHAPES[shape]
    gpu, tpu = plan(model, shape, mesh, H100), plan(model, shape, mesh, V5E)
    assert gpu.predicted["fits"] is fits_h100
    assert not tpu.predicted["fits"]
    assert tpu.predicted["resident"] == _least_resident(model, shape, mesh,
                                                        V5E)
    if fits_h100:                  # over the v5e's budget, inside the H100's
        assert 0.92 * 16e9 < gpu.predicted["resident"] <= 0.92 * 80e9
        assert gpu.predicted["total"] < float("inf")
    else:
        assert gpu.predicted["resident"] == _least_resident(model, shape,
                                                            mesh, H100)


def test_elastic_on_v5e_gives_the_jax_controllers_plans():
    """``tests/test_training.py::test_elastic_replan_shrinks_and_is_stable``
    with ``chip=V5E``, plan for plan against the JAX controller, drift
    re-plans included."""
    ctl = ElasticController(build_model(get_config("gemma-2b")),
                            SHAPES["train_4k"], MULTI_POD, chip=V5E)
    jctl = JElasticController(jbuild_model(jget_config("gemma-2b")),
                              JSHAPES["train_4k"], jplan.MULTI_POD)
    plans = [(ctl.initial_plan(), jctl.initial_plan())]
    assert plans[0][0].mesh.n_pods == 2
    for pods in (1, 1, 2):
        plans.append((ctl.on_availability_change(pods),
                      jctl.on_availability_change(pods)))
    plans.append((ctl.on_drift(), jctl.on_drift()))
    for ours, theirs in plans:
        assert _fields(ours) == _fields(theirs)
    assert plans[2][0] is plans[1][0]           # nothing changed → no replan
    assert [p.mesh.n_pods for p, _ in plans] == [2, 1, 1, 2, 2]
    assert ctl.replans == jctl.replans == 3


def test_elastic_on_h100_shrinks_and_grows_a_gpu_world():
    ctl = ElasticController(build_model(get_config("gemma-2b")),
                            SHAPES["train_4k"], GPU_MULTI_NODE)
    assert ctl.chip is H100
    p0 = ctl.initial_plan()
    assert p0.mesh == GPU_MULTI_NODE
    p1 = ctl.on_availability_change(1)           # a host leaves
    assert p1.mesh == GPU_NODE and ctl.replans == 1
    assert ctl.on_availability_change(1) is p1
    p2 = ctl.on_availability_change(2)
    assert p2.mesh == GPU_MULTI_NODE and ctl.replans == 2
    assert _fields(p2) == _fields(p0)
    assert _fields(p1) == _fields(plan_gpu(ctl.model, ctl.shape, GPU_NODE))


@pytest.mark.parametrize("chip,mesh", [(V5E, MULTI_POD),
                                       (H100, GPU_MULTI_NODE)],
                         ids=["v5e", "h100"])
def test_fleet_epoch_resizes_elastic_world(chip, mesh):
    """``tests/test_serving.py::test_fleet_epoch_resizes_elastic_world`` on
    the port's objects alone; on the v5e its telemetry equals the JAX
    run's in canonical projection."""
    def run(pkg):
        rec = pkg["rec"]("elastic")
        ctl = pkg["elastic"](pkg["model"], pkg["shape"], pkg["mesh"],
                             telemetry=rec, **pkg["kw"])
        assert ctl.initial_plan().mesh.n_pods == 2
        fleet = pkg["fleet"](
            pkg["cluster"](2),
            pkg["trace"].scripted([(1.0, "tx2", "leave"),
                                   (2.0, "tx2", "join")]),
            on_epoch=ctl.on_epoch, telemetry=rec)
        fleet.advance(1.5)                       # tx2 leaves → world of 1
        assert ctl.current_plan.mesh.n_pods == 1 and ctl.replans == 1
        fleet.advance(2.5)                       # tx2 returns → world of 2
        assert ctl.current_plan.mesh.n_pods == 2 and ctl.replans == 2
        worlds = [e for e in rec.events if e.name == "elastic.world"]
        assert [e.value for e in worlds] == [1.0, 2.0]
        assert [e.epoch for e in worlds] == [1, 2]
        members = [e for e in rec.events if e.name == "fleet.membership"]
        assert [(e.value, e.epoch) for e in members] == [(1.0, 1), (2.0, 2)]
        assert len([e for e in rec.events
                    if e.name == "elastic.replan"]) == 2
        return [e.canonical() for e in rec.events]

    ours = run(dict(rec=TelemetryRecorder, elastic=ElasticController,
                    model=build_model(get_config("gemma-2b")),
                    shape=SHAPES["train_4k"], mesh=mesh, kw=dict(chip=chip),
                    fleet=FleetController, cluster=paper_cluster,
                    trace=ChurnTrace))
    if chip is V5E:
        from repro.telemetry import TelemetryRecorder as JRecorder

        theirs = run(dict(rec=JRecorder, elastic=JElasticController,
                          model=jbuild_model(jget_config("gemma-2b")),
                          shape=JSHAPES["train_4k"], mesh=jplan.MULTI_POD,
                          kw={}, fleet=JFleetController,
                          cluster=jpaper_cluster, trace=JChurnTrace))
        assert ours == theirs


def test_chip_smokes_elastic_phase_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.plan_elastic`` is host code: it runs here whole, and
    raises on any failed check."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    chip_smoke.plan_elastic("cpu")
