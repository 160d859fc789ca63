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
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
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
                 KERNEL_MODULES):
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


@pytest.mark.parametrize("aid", ARCH_IDS)
def test_config_copies_equal_their_counterparts(aid):
    assert dataclasses.asdict(get_config(aid)) == \
        dataclasses.asdict(jget_config(aid))
    assert dataclasses.asdict(get_config(aid).reduced()) == \
        dataclasses.asdict(jget_config(aid).reduced())


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
