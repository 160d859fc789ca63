"""The port stands alone: it imports neither jax nor anything of ``repro``,
its entry points refuse CUDA on a machine without a GPU (no fallback to the
CPU), and its copies of the JAX package's data and digests are exact."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.edge_models import battery_cluster, paper_cluster  # noqa: E402
from repro.core.fingerprint import (  # noqa: E402
    cluster_fingerprint as jcluster_fingerprint,
    dag_fingerprint as jdag_fingerprint,
    membership_fingerprint as jmembership_fingerprint)
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core.fingerprint import (cluster_fingerprint,  # noqa: E402
                                          dag_fingerprint,
                                          membership_fingerprint)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"))
ours = sorted(n for n in sys.modules if n.startswith("repro_torch"))
print("LOADED", len(ours))
print("BAD", bad)
print("NAMES", " ".join(ours))
"""

# the analyzer, planner and plan cache the port copies from ``repro``
PLANNER_MODULES = [f"repro_torch.core.{m}" for m in (
    "cost_model", "dag", "dp_cache", "dp_partitioner", "fingerprint",
    "global_partitioner", "hidp", "local_partitioner", "objective",
    "pareto")] + [f"repro_torch.profiling.{m}" for m in (
        "feedback", "learned", "profiler", "provider", "store")] + [
    "repro_torch.serving.plan_cache"]
# the fleet, elasticity and GPU-tier planning layers the port copies
FLEET_MODULES = [f"repro_torch.{m}" for m in (
    "core.cluster", "core.edge_models", "fleet.traces", "fleet.controller",
    "sharding.plan", "runtime.elastic", "telemetry.events",
    "telemetry.recorder")]
# the training stack
TRAINING_MODULES = [f"repro_torch.{m}" for m in (
    "training.optimizer", "training.train_loop", "training.checkpoint",
    "training._msgpack", "training.data", "training.tree",
    "runtime.fault_tolerance", "launch.train")]
# the paper's evaluation layer: baselines, simulator, FSMs, load, telemetry
EVAL_MODULES = [f"repro_torch.{m}" for m in (
    "core.baselines", "core.simulator", "core.scheduler", "load",
    "load.traces", "load.service", "load.harness", "load.saturation",
    "telemetry.store", "telemetry.trace", "telemetry.report",
    "telemetry.regress")]
# the kernel wrappers, their plain versions and `_build`
KERNEL_MODULES = [f"repro_torch.kernels.{m}" for m in (
    "_build", "_wrap", "ops", "ref", "flash_attention", "decode_attention",
    "ssd_scan")]


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL, str(ROOT)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert int(out.stdout.split("LOADED")[1].split()[0]) >= 50
    loaded = set(out.stdout.split("NAMES")[1].split())
    for mods in (PLANNER_MODULES, FLEET_MODULES, TRAINING_MODULES,
                 KERNEL_MODULES, EVAL_MODULES):
        assert set(mods) <= loaded, set(mods) - loaded


# jax and repro cannot even be found: an import of either raises
_PLAN_WITHOUT_JAX = """
import sys


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"refused: {name}")


sys.meta_path.insert(0, Refuse())
from repro_torch.configs import get_config
from repro_torch.core import paper_cluster
from repro_torch.fleet import ChurnTrace, FleetController
from repro_torch.models import SHAPES, build_model
from repro_torch.runtime import ElasticController
from repro_torch.sharding.plan import GPU_MULTI_NODE, GPU_NODE, plan_gpu
from repro_torch.telemetry import TelemetryRecorder

model = build_model(get_config("gemma-2b"))
rec = TelemetryRecorder("elastic")
ctl = ElasticController(model, SHAPES["train_4k"], GPU_MULTI_NODE,
                        telemetry=rec)
ctl.initial_plan()
fleet = FleetController(paper_cluster(2), ChurnTrace.scripted(
    [(1.0, "tx2", "leave"), (2.0, "tx2", "join")]), on_epoch=ctl.on_epoch,
    telemetry=rec)
worlds = []
for now in (1.5, 2.5):
    fleet.advance(now)
    worlds.append(ctl.current_plan.mesh.n_pods)
print("WORLDS", *worlds, ctl.replans, len(rec.events))
print("NODE", plan_gpu(model, SHAPES["decode_32k"], GPU_NODE).local_layout)
print("BAD", sorted(n for n in sys.modules
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def test_gpu_planning_and_fleet_run_where_jax_and_repro_cannot_import():
    """``plan_gpu``, ``ElasticController``, ``FleetController`` and the
    recorder import and run with jax and ``repro`` refused at import."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", _PLAN_WITHOUT_JAX], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "WORLDS 1 2 2 6" in out.stdout, out.stdout
    assert "NODE dp_tp" in out.stdout and "BAD []" in out.stdout, out.stdout


# the evaluation layer with jax, repro and benchmarks refused: the paper's
# strategy comparison on the simulator, an open-loop load run and a
# saturation sweep priced by the plan cache, the store, report and regress
_EVAL_WITHOUT_JAX = """
import sys, tempfile


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"):
            raise ImportError(f"refused: {name}")


sys.meta_path.insert(0, Refuse())
from repro_torch.core import (EDGE_MODELS, MODEL_DELTA, STRATEGIES,
                              HiDPPlanner, paper_cluster, simulate)
from repro_torch.load import (ArrivalTrace, LoadConfig, OpenLoopHarness,
                              PlanServiceModel, TenantSpec, saturation_sweep)
from repro_torch.serving import PlanCache
from repro_torch.telemetry import RunStore, TelemetryRecorder, regress
from repro_torch.telemetry import report

wins = 0
for name in EDGE_MODELS:
    lat = {s: simulate(paper_cluster(), s, [(0.0, EDGE_MODELS[name](),
                                             MODEL_DELTA[name])],
                       planning_time=0.0).records[0].latency
           for s in STRATEGIES}
    wins += min(lat, key=lat.get) == "hidp"
root = tempfile.mkdtemp()
store = RunStore(root)
rec = TelemetryRecorder(store.new_run("load"), store=store)
spec = TenantSpec("resnet", slo=5.0, dag=EDGE_MODELS["resnet152"](),
                  delta=MODEL_DELTA["resnet152"])
svc = PlanServiceModel(PlanCache(HiDPPlanner(), paper_cluster()),
                       {"resnet": spec})
tr = ArrivalTrace.poisson({"resnet": 2.0}, horizon=10.0, seed=1)
rep = OpenLoopHarness(tr, [spec], svc, LoadConfig(queue_capacity=8),
                      telemetry=rec).run()
pts = saturation_sweep(tr, [spec], svc, [0.5, 2.0])
rec.close()
snap = regress.write_snapshot(root + "/s.json", {"n": {
    "value": float(rep.completed), "unit": "count", "direction": "lower"}})
print("EVAL", wins, len(EDGE_MODELS), rep.conservation_ok(),
      svc.resolutions, len(pts), report.main([root]),
      regress.main([str(snap), str(snap)]))
print("BAD", sorted(n for n in sys.modules
                    if n.split(".")[0] in ("jax", "jaxlib", "repro",
                                           "benchmarks")))
"""


def test_evaluation_layer_runs_where_jax_repro_and_benchmarks_cannot_import():
    """The baselines, simulator, load harness, run store, report and
    regress run with jax, ``repro`` and ``benchmarks`` refused at
    import."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", _EVAL_WITHOUT_JAX], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "EVAL 4 4 True 3 2 0 0" in out.stdout, out.stdout
    assert "BAD []" in out.stdout, out.stdout


# the GPU plan explorer example, run as a script with jax and repro refused
_EXPLORER_WITHOUT_JAX = """
import runpy, sys


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"refused: {name}")


sys.meta_path.insert(0, Refuse())
sys.argv = [sys.argv[1], "--arch", "qwen3-moe-30b-a3b", "--shape",
            "train_4k", "--multi-node"]
runpy.run_path(sys.argv[0], run_name="__main__")
print("BAD", sorted(n for n in sys.modules
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def test_gpu_plan_explorer_runs_where_jax_and_repro_cannot_import():
    """``examples/gpu_plan_explorer.py`` plans with jax and ``repro``
    refused at import."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "-c", _EXPLORER_WITHOUT_JAX,
         str(ROOT / "examples" / "gpu_plan_explorer.py")], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "HiDP picked: " in out.stdout, out.stdout
    assert "BAD []" in out.stdout, out.stdout


# the training path with jax, repro and msgpack refused (the GPU machine has
# no msgpack): two train steps, a checkpoint written and restored
_TRAIN_WITHOUT_JAX = """
import sys, tempfile


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack"):
            raise ImportError(f"refused: {name}")


sys.meta_path.insert(0, Refuse())
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.runtime import CheckpointPolicy
from repro_torch.sharding.plan import SINGLE_POD, ShardingPlan
from repro_torch.training import optimizer as optim, tree
from repro_torch.training.data import SyntheticDataset
from repro_torch.training.train_loop import make_train_step

model = build_model(get_config("gemma-2b").reduced())
params = model.init(torch.Generator().manual_seed(0), device="cpu")
state = optim.init(params)
step = make_train_step(model, optim.OptConfig(warmup_steps=1), ShardingPlan(
    arch="t", shape="s", mesh=SINGLE_POD, global_mode="data",
    local_layout="x", batch_axes=()))
data = iter(SyntheticDataset(model.cfg, 2, 16))
for _ in range(2):
    batch = {k: torch.from_numpy(v) for k, v in next(data).items()}
    params, state, metrics = step(params, state, batch)
pol = CheckpointPolicy(tempfile.mkdtemp(), every_steps=1)
pol.maybe_save(2, (params, state))
(p2, s2), at = pol.resume((params, state))
same = all(torch.equal(a, b) for a, b in zip(tree.leaves((p2, s2)),
                                             tree.leaves((params, state))))
print("STEP", int(state.step), at, same, np.isfinite(float(metrics["loss"])))
print("BAD", sorted(n for n in sys.modules if n.split(".")[0]
                    in ("jax", "jaxlib", "repro", "msgpack")))
"""


def test_training_runs_where_jax_repro_and_msgpack_cannot_import():
    """Train steps and a checkpoint round trip with jax, ``repro`` and
    ``msgpack`` refused at import: the port carries its own codec."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", _TRAIN_WITHOUT_JAX],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "STEP 2 2 True True" in out.stdout, out.stdout
    assert "BAD []" in out.stdout, out.stdout


def _needs_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA requests succeed here")


def test_entry_points_refuse_cuda_without_a_gpu():
    _needs_no_gpu()
    cfg = get_config("gemma-2b").reduced()
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        model.init(torch.Generator(), device="cuda")
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(model, params)                 # cuda is the default
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_cache(1, 8)
    ssm = build_model(get_config("mamba2-780m").reduced())
    with pytest.raises(RuntimeError, match="cuda"):
        ssm.init(torch.Generator(), device="cuda")
    ssm_params = ssm.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(ssm, ssm_params)
    with pytest.raises(RuntimeError, match="cuda"):
        ssm.init_cache(1, 8)
    with pytest.raises(ValueError, match="backend"):
        ops.set_backend("cuda")


@pytest.mark.parametrize("aid", ["whisper-tiny", "llama-3.2-vision-11b"])
def test_cross_families_refuse_cuda_without_a_gpu(aid):
    """The encoder-decoder and VLM entry points default to cuda too."""
    _needs_no_gpu()
    model = build_model(get_config(aid).reduced())
    with pytest.raises(RuntimeError, match="cuda"):
        model.init(torch.Generator(), device="cuda")
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(model, params)
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_cache(1, 8)


# the fields only the port's dataclasses have (its ``hybrid_moe`` family's),
# each at the value under which a configuration computes as the JAX
# package's does
PORT_ONLY_NEUTRAL = {
    "mixers": None, "embedding_multiplier": 1.0, "residual_multiplier": 1.0,
    "logits_scaling": 1.0, "attn_scale": None, "rope": True,
    "d_ff_shared": 0, "conv_bias": False, "norm_eps": 1e-6}


def _same_config(ours, theirs) -> None:
    """Every field of the JAX dataclass ``theirs`` equal in ``ours``,
    nested specs compared the same way; the fields only the port has at
    their neutral values."""
    if not dataclasses.is_dataclass(theirs):
        assert ours == theirs
        return
    assert type(ours).__name__ == type(theirs).__name__
    jax_fields = {f.name for f in dataclasses.fields(theirs)}
    for f in dataclasses.fields(ours):
        if f.name in jax_fields:
            _same_config(getattr(ours, f.name), getattr(theirs, f.name))
        else:
            assert f.name in PORT_ONLY_NEUTRAL, f.name
            assert getattr(ours, f.name) == PORT_ONLY_NEUTRAL[f.name], f.name
    assert jax_fields <= {f.name for f in dataclasses.fields(ours)}


@pytest.mark.parametrize("aid", ARCH_IDS)
def test_config_copies_equal_their_counterparts(aid):
    _same_config(get_config(aid), jget_config(aid))
    _same_config(get_config(aid).reduced(), jget_config(aid).reduced())


def test_dag_fingerprint_equals_the_jax_digest():
    from test_serving import _toy_cache

    _, dag = _toy_cache()
    ours = dag_fingerprint(dataclasses.replace(dag))      # fresh instances:
    theirs = jdag_fingerprint(dataclasses.replace(dag))   # no memo shared
    assert ours == theirs
    two = dataclasses.replace(dag, name="toy_b", blocks=dag.blocks[:-1])
    assert dag_fingerprint(two) == jdag_fingerprint(dataclasses.replace(two))
    assert dag_fingerprint(two) != ours


def test_cluster_and_membership_fingerprints_equal_the_jax_digests():
    """The keys CalibrationStore files under and PlanCache looks up by: the
    same declared cluster, rebuilt field by field in the port, hashes alike
    in both packages, whatever its availability mask."""
    from test_torch_planner import jax_cluster, port_cluster
    from repro_torch.core.cost_model import Cluster, gpu_node

    h100 = jax_cluster(Cluster((gpu_node("a", chips=4), gpu_node("b"))))
    for jcl in (paper_cluster(), battery_cluster(), h100):
        seen = set()
        for mask in ([True] * len(jcl.nodes),
                     [i != 1 for i in range(len(jcl.nodes))]):
            jc = jcl.with_availability(mask)
            c = port_cluster(jc)
            assert cluster_fingerprint(c) == jcluster_fingerprint(jc)
            assert membership_fingerprint(c) == jmembership_fingerprint(jc)
            seen.add(membership_fingerprint(c))
        assert len(seen) == 2                 # a node away is another key


# the multi-GPU layer with jax, repro and msgpack refused: the expert
# all-to-all, the sharded step, the pipeline and the tensor-parallel serving
# and train steps on two gloo ranks, then dry-run cells on the fake process
# group.  A file, so that the spawned ranks can import its worker (and
# refuse the same imports)
_MULTI_WITHOUT_JAX = """
import logging, sys, tempfile


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack"):
            raise ImportError(f"refused: {name}")


sys.meta_path.insert(0, Refuse())
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)


def bad():
    return sorted(n for n in sys.modules
                  if n.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack"))


def worker(rank, path):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import build_model, moe_ep
    from repro_torch.sharding import MeshDesc, ShardingPlan, ctx, pipeline
    from repro_torch.sharding import specs, spmd
    from repro_torch.training import optimizer as optim
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=2)
    mesh = make_smoke_mesh((1, 2), ("data", "model"), device_type="cpu")
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1)).bfloat16()
    p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    with ctx.plan_specs(specs.Spec(None, "model", None), None, mesh=mesh,
                        ep_axis="model"):
        y = moe_ep.moe_ep_a2a(cfg, p, x[:, 4 * rank:4 * rank + 4])
    plan = ShardingPlan(arch="t", shape="t", mesh=MeshDesc(
        ("data", "model"), (1, 2)), global_mode="data",
        local_layout="dp_sp_fsdp_ep", batch_axes=("data",),
        seq_axes=("model",), tp_axes=(), fsdp_axes=("data", "model"),
        moe_impl="ep_a2a")
    sp = specs.param_shardings(mesh, params, plan)
    tok = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator()
                        .manual_seed(2), dtype=torch.int32)
    step = spmd.make_sharded_train_step(model, optim.OptConfig(), plan, mesh)
    _, _, m = step(sp, optim.init(sp), {"tokens": tok, "targets": tok})
    gcfg = get_config("gemma-2b").reduced()
    gparams = build_model(gcfg).init(torch.Generator().manual_seed(0),
                                     device="cpu")
    pmesh = make_smoke_mesh((2,), ("pod",), device_type="cpu")
    staged = pipeline.stage_param_shardings(
        pmesh, pipeline.stage_params(gcfg, gparams, 2))
    h = pipeline.pipeline_hidden(gcfg, staged, tok, mesh=pmesh, n_stages=2,
                                 microbatches=2)
    # tensor-parallel serving: gemma's one KV head puts the cache's
    # sequence over "model"
    gmodel = build_model(gcfg)
    tplan = ShardingPlan(arch="t", shape="t", mesh=MeshDesc(
        ("data", "model"), (1, 2)), global_mode="data", local_layout="dp_tp",
        batch_axes=("data",), tp_axes=("model",))
    gsp = specs.param_shardings(mesh, gparams, tplan)
    lens = torch.tensor([16, 9], dtype=torch.int32)
    _, cache = spmd.make_sharded_prefill(gmodel, tplan, mesh)(
        gsp, {"tokens": tok, "lengths": lens})
    dc = specs.cache_shardings(mesh, gmodel.init_cache(2, 32, device="cpu"),
                               tplan)
    logits, _ = spmd.make_sharded_decode(gmodel, tplan, mesh)(
        gsp, dc, {"tokens": tok[:, :1], "lengths": lens})
    logits = logits.full_tensor()
    # tensor-parallel training: the same plan's train step
    tstep = spmd.make_sharded_train_step(gmodel, optim.OptConfig(), tplan,
                                         mesh)
    gtrain = specs.param_shardings(mesh, gparams, tplan)
    _, _, tm = tstep(gtrain, optim.init(gtrain), {"tokens": tok,
                                                  "targets": tok})
    if rank == 0:
        print("RANKS", tuple(y.shape), bool(torch.isfinite(m["loss"])),
              tuple(h.shape), "BAD", bad(), flush=True)
        print("TP", tuple(cache["k"].to_local().shape),
              tuple(logits.shape), bool(torch.isfinite(logits).all()),
              bool(torch.isfinite(tm["loss"])), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(worker, args=(tempfile.mktemp(),), nprocs=2)
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    ok = dryrun.run_cell("gemma-2b", "train_4k", False, out_dir=None,
                         cfg=get_config("gemma-2b").reduced())
    tp = dryrun.run_cell("gemma-2b", "decode_32k", False, out_dir=None,
                         cfg=get_config("gemma-2b").reduced())
    tpt = dryrun.run_cell("gemma-2b", "train_4k", False, out_dir=None,
                          cfg=get_config("gemma-2b").reduced(),
                          force_layout="dp_tp")
    ctx = dryrun.run_cell("gemma-2b", "decode_32k", False, out_dir=None,
                          cfg=get_config("gemma-2b").reduced(),
                          force_layout="ctx_tp")
    print("DRYRUN", ok["status"], tp["status"], tpt["status"],
          ctx["status"], "BAD", bad())
"""


def test_multi_gpu_layer_runs_where_jax_and_repro_cannot_import(tmp_path):
    """``moe_ep``'s all-to-all, the sharded step, the pipeline and the
    tensor-parallel serving and train steps on gloo ranks, and the dry-run
    on the fake process group (a tensor-parallel train cell and a
    ``ctx_tp`` decode cell traced), with jax, ``repro`` and ``msgpack``
    refused at import in every process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    script = tmp_path / "multi_without_jax.py"
    script.write_text(_MULTI_WITHOUT_JAX)
    out = subprocess.run([sys.executable, str(script)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=150)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "RANKS (2, 4, 64) True (2, 16, 64) BAD []" in out.stdout, \
        out.stdout
    assert "TP (2, 2, 8, 1, 16) (2, 1, 256) True True" in out.stdout, \
        out.stdout
    assert "DRYRUN ok ok ok ok BAD []" in out.stdout, out.stdout
