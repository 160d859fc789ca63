"""The port's planner (``repro_torch.core``), cost bridge
(``Model.step_flops`` / ``block_costs``) and plan cache
(``repro_torch.serving.plan_cache``) against the JAX package's, exactly: the
same inputs, built field by field in each package, give equal dataclasses,
equal digests and equal plans.

``planning_seconds`` is the only field of a plan left out of the
comparison: it is the wall time the pass took, not a result of it.
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import hidp as jhidp  # noqa: E402
from repro.core.dag import Block as JBlock, ModelDAG as JModelDAG  # noqa: E402
from repro.core.edge_models import battery_cluster, paper_cluster  # noqa: E402
from repro.core.fingerprint import (  # noqa: E402
    cluster_fingerprint as jcluster_fingerprint,
    dag_fingerprint as jdag_fingerprint)
from repro.core.objective import Objective as JObjective  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models.config import ShapeConfig as JShapeConfig  # noqa: E402
from repro.profiling import (  # noqa: E402
    CalibratedCostProvider as JProvider, CalibrationStore as JStore,
    LearnedCostModel as JLearned, Profiler as JProfiler,
    SyntheticGroundTruth as JTruth)
from repro.serving import PlanCache as JPlanCache  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.core import hidp  # noqa: E402
from repro_torch.core.dag import Block, ModelDAG  # noqa: E402
from repro_torch.core.fingerprint import (cluster_fingerprint,  # noqa: E402
                                          dag_fingerprint)
from repro_torch.core.objective import Objective  # noqa: E402
from repro_torch.models import ShapeConfig, build_model  # noqa: E402
from repro_torch.profiling import (CalibratedCostProvider,  # noqa: E402
                                   CalibrationStore, LearnedCostModel,
                                   Profiler, SyntheticGroundTruth)
from repro_torch.serving.plan_cache import PlanCache  # noqa: E402

ARCHS = ("gemma-2b", "mamba2-780m", "hymba-1.5b", "qwen3-moe-30b-a3b",
         "mixtral-8x7b", "whisper-tiny", "llama-3.2-vision-11b")
# (name, seq_len, global_batch, kind): a 512-token prompt, a decode step of
# four sequences over a 1024-position cache (the chip's serving shapes), and
# a short training step
SHAPES = (("prefill", 512, 1, "prefill"), ("serve", 1024, 4, "decode"),
          ("train", 256, 2, "train"))
METRICS = ("latency", "energy", "edp")


# --------------------------------------------------------------------------
# rebuilding one package's objects in the other, field by field
# --------------------------------------------------------------------------

def _rebuild_cluster(cluster, mod):
    return mod.Cluster(tuple(
        mod.Node(name=n.name,
                 processors=tuple(mod.Processor(**dataclasses.asdict(p))
                                  for p in n.processors),
                 net_bw=n.net_bw, available=n.available,
                 default_processor=n.default_processor)
        for n in cluster.nodes))


def port_cluster(jcluster):
    """A JAX-package cluster rebuilt from the port's classes."""
    return _rebuild_cluster(jcluster, cm)


def jax_cluster(cluster):
    """A port cluster rebuilt from the JAX package's classes."""
    return _rebuild_cluster(cluster, jcm)


def port_dag(jdag):
    return ModelDAG(name=jdag.name,
                    blocks=tuple(Block(**dataclasses.asdict(b))
                                 for b in jdag.blocks),
                    input_bytes=jdag.input_bytes,
                    output_bytes=jdag.output_bytes)


def toy_dag(mod_block=JBlock, mod_dag=JModelDAG):
    """``tests/test_serving.py::_toy_cache``'s workload."""
    blocks = tuple(mod_block(name=f"b{i}", flops=2e9, param_bytes=1e6,
                             bytes_in=4e5, bytes_out=4e5, kind="conv")
                   for i in range(6))
    return mod_dag(name="toy", blocks=blocks, input_bytes=4e5,
                   output_bytes=4e5)


CLUSTERS = {
    "paper": lambda: paper_cluster(),
    "battery": lambda: battery_cluster(),
    "h100": lambda: jax_cluster(cm.Cluster((cm.gpu_node("h100", chips=2),))),
}


def _dags(source: str):
    """(JAX dag, port dag) for ``<arch>:<shape>`` or ``toy``, each built by
    its own package."""
    if source == "toy":
        return toy_dag(), toy_dag(Block, ModelDAG)
    arch, shape = source.split(":")
    spec = next(s for s in SHAPES if s[0] == shape)
    return (jbuild_model(jget_config(arch)).block_costs(JShapeConfig(*spec)),
            build_model(get_config(arch)).block_costs(ShapeConfig(*spec)))


def _plan_dict(mod, plan) -> dict:
    d = mod.plan_to_dict(plan)
    d.pop("planning_seconds")
    return d


def _calibrated(jcluster, jdag, dag):
    """One calibrated provider per package, fitted from each package's own
    ``profile_cluster`` over a ground truth where the first node runs at
    half its datasheet rate."""
    slow = {jcluster.nodes[0].name: 0.5}
    jsamples = JProfiler(seed=3).profile_cluster(
        jcluster, {"w": jdag}, {"w": 1.0},
        ground_truth=JTruth(jcluster, rate_scale=slow, noise=0.05))
    cluster = port_cluster(jcluster)
    samples = Profiler(seed=3).profile_cluster(
        cluster, {"w": dag}, {"w": 1.0},
        ground_truth=SyntheticGroundTruth(cluster, rate_scale=slow,
                                          noise=0.05))
    return (JProvider(JLearned.fit(jsamples)),
            CalibratedCostProvider(LearnedCostModel.fit(samples)))


# --------------------------------------------------------------------------
# the cost bridge
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_cost_bridge_equals_the_jax_models(arch, shape):
    jmodel = jbuild_model(jget_config(arch))
    model = build_model(get_config(arch))
    assert model.step_flops(ShapeConfig(*shape)) == \
        jmodel.step_flops(JShapeConfig(*shape))
    assert model.param_bytes() == jmodel.param_bytes()
    jdag = jmodel.block_costs(JShapeConfig(*shape))
    dag = model.block_costs(ShapeConfig(*shape))
    assert dataclasses.asdict(dag) == dataclasses.asdict(jdag)
    assert dag_fingerprint(dag) == jdag_fingerprint(jdag)
    assert len(dag.blocks) == get_config(arch).n_layers + 2


# --------------------------------------------------------------------------
# plans and fronts
# --------------------------------------------------------------------------

SOURCES = ["toy"] + [f"{a}:{s[0]}" for a in ARCHS for s in SHAPES[:2]]


@pytest.mark.parametrize("provider", ["analytic", "calibrated"])
@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("cluster", list(CLUSTERS))
def test_plans_and_fronts_equal_the_jax_planner(cluster, source, provider):
    jcl = CLUSTERS[cluster]()
    cl = port_cluster(jcl)
    assert cluster_fingerprint(cl) == jcluster_fingerprint(jcl)
    jdag, dag = _dags(source)
    jprov = prov = None
    if provider == "calibrated":
        jprov, prov = _calibrated(jcl, jdag, dag)
        assert prov.model.to_json() == jprov.model.to_json()
    for metric in METRICS:
        jcfg = jhidp.PlannerConfig(provider=jprov, objective=JObjective(
            metric, radio_power=4.0))
        cfg = hidp.PlannerConfig(provider=prov, objective=Objective(
            metric, radio_power=4.0))
        got = hidp.HiDPPlanner(cfg).plan(dag, cl)
        want = jhidp.HiDPPlanner(jcfg).plan(jdag, jcl)
        assert _plan_dict(hidp, got) == _plan_dict(jhidp, want), metric
        front = hidp.plan_front(dag, cl, cfg)
        jfront = jhidp.plan_front(jdag, jcl, jcfg)
        assert [_plan_dict(hidp, p.plan) for p in front] == \
            [_plan_dict(jhidp, p.plan) for p in jfront], metric
        assert [(p.latency, p.energy) for p in front] == \
            [(p.latency, p.energy) for p in jfront]
        # the round trip rebuilds the plan against the port's own nodes
        again = hidp.plan_from_dict(hidp.plan_to_dict(got), cl)
        assert _plan_dict(hidp, again) == _plan_dict(hidp, got)


def test_gpu_node_is_the_h100_datasheet():
    node = cm.gpu_node("h100", chips=4)
    assert [p.name for p in node.processors] == [f"gpu{i}" for i in range(4)]
    p = node.processors[0]
    assert (p.kind, p.peak_flops, p.active_power) == ("gpu", 989e12, 700.0)
    assert cm.node_as_resource(node).profile_key == "h100"
    assert [r.name for r in cm.processors_as_resources(node)] == \
        [f"h100/gpu{i}" for i in range(4)]
    assert cm.gpu_chip().kind == "gpu" and cm.H100_HBM_BW == 3.35e12


def test_planner_datasheet_equals_chip_smokes_bound_peaks():
    """chip_smoke.py keeps its own published H100 peaks for every kernel's
    bound; the planner's uncalibrated datasheet constants agree with them."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert (cm.H100_PEAK_FLOPS, cm.H100_HBM_BW) == \
        (chip_smoke.PEAK_BF16_FLOPS, chip_smoke.PEAK_BYTES)


# --------------------------------------------------------------------------
# the plan cache
# --------------------------------------------------------------------------

def test_plan_cache_serves_the_jax_caches_selections(tmp_path):
    """Both caches over the same cluster and tenant: one frontier pass, then
    every objective a hit with the same selection; fronts persisted by
    either package warm the other's cache with zero DP work."""
    jcl = battery_cluster()
    cl = port_cluster(jcl)
    jcache = JPlanCache(jhidp.HiDPPlanner(jhidp.PlannerConfig(
        objective=JObjective("energy", radio_power=4.0))), jcl)
    cache = PlanCache(hidp.HiDPPlanner(hidp.PlannerConfig(
        objective=Objective("energy", radio_power=4.0))), cl)
    assert cache.fingerprint == jcache.fingerprint
    jdag, dag = toy_dag(), toy_dag(Block, ModelDAG)
    for metric in METRICS + ("energy",):
        got = cache.get(dag, objective=metric)
        want = jcache.get(jdag, objective=metric)
        assert _plan_dict(hidp, got) == _plan_dict(jhidp, want)
    assert (cache.misses, cache.hits) == (jcache.misses, jcache.hits) == (1, 3)
    stats, jstats = cache.stats(), jcache.stats()
    assert set(stats) == set(jstats)

    edp = _plan_dict(hidp, cache.get(dag, objective="edp"))

    # the port persists, the JAX package warms from it
    assert cache.persist(CalibrationStore(tmp_path / "port")) == 1
    jwarm = JPlanCache(jcache.planner, jcl, store=JStore(tmp_path / "port"))
    assert jwarm.loaded == 1
    assert _plan_dict(jhidp, jwarm.get(jdag, objective="edp")) == edp
    assert (jwarm.misses, jwarm.hits) == (0, 1)
    # and the other way round
    assert jcache.persist(JStore(tmp_path / "jax")) == 1
    warm = PlanCache(cache.planner, cl, store=CalibrationStore(tmp_path / "jax"))
    assert warm.loaded == 1
    assert _plan_dict(hidp, warm.get(dag, objective="edp")) == edp
    assert (warm.misses, warm.hits) == (0, 1)
