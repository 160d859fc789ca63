"""Multi-rank paths of the port on gloo ranks on the CPU, against the JAX
package on an 8-device host mesh and against the port's single-process
paths:

* ``moe_ep.moe_ep_a2a`` across 8 ranks of a (1, 8) ("data", "model") mesh
  (the expert all-to-all), with x replicated over the EP axis and with the
  sequence split over it, its payload in bf16 and in int8: the output
  against the JAX ``moe_ep_a2a`` under the same mesh and against the JAX
  ``moe_dense`` (tests/test_distributed.py's atol 5e-2), the gradients of
  every parameter and of x against ``jax.grad`` of the reference's (per
  leaf by relative norm);
* ``pipeline.pipeline_hidden`` over 2 stages against the port's flat stack
  (tests/test_distributed.py's 3e-2) and against the JAX pipeline over a
  (2, 4) ("pod", "data") mesh (tests/test_torch_model.py's 5e-2 between
  the packages), and one pipelined train step against
  the port's unsharded ``make_train_step`` (loss rtol 2e-3, parameters atol
  3e-3: tests/test_distributed.py's sharded-step tolerances).

The JAX side runs in a subprocess with 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
tests/test_distributed.py does), which also draws the weights; the port's
ranks load them through ``from_jax``.  Inputs come from numpy seeds.  Each
spawn of ranks has its own timeout.  ``spawn`` is this file's harness, also
used by tests/test_torch_sharded_step.py.
"""

import os
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
DENSE_TOL = 5e-2            # tests/test_distributed.py: moe_ep vs moe_dense
PIPE_TOL = 3e-2             # tests/test_distributed.py: pipeline vs flat
CROSS_TOL = 5e-2            # tests/test_torch_model.py: port vs reference
LOSS_RTOL, PARAM_ATOL = 2e-3, 3e-3   # tests/test_distributed.py: sharded
# one MoE layer's gradients against the reference's, per leaf by relative
# norm: bf16 products in both packages (tests/test_torch_moe_train.py's
# LAYER_GRAD_TOL); the int8 payload rounds at boundaries in one package
# and not the other (ROADMAP quirks), so four round trips part further
GRAD_TOL = {"bfloat16": 1e-2, "int8": 3e-2}
MOE_CASES = [("replicated", "bfloat16"), ("replicated", "int8"),
             ("seq_split", "bfloat16"), ("seq_split", "int8")]
SPAWN_TIMEOUT = 150


# --------------------------------------------------------------------------
# The harness: gloo ranks in spawned processes
# --------------------------------------------------------------------------

def _entry(rank: int, world: int, d: str, worker) -> None:
    import logging
    import torch.distributed as dist
    torch.set_num_threads(1)
    # DTensor warns once per process of each redistribution over two mesh
    # dims, gloo of its all-to-all through an all-gather
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    try:
        res = worker(rank, torch.load(f"{d}/in.pt", weights_only=False))
        if rank == 0:
            torch.save(res, f"{d}/out.pt")
    finally:
        dist.destroy_process_group()


def spawn(worker, world: int, payload, timeout: float = SPAWN_TIMEOUT):
    """Runs ``worker(rank, payload)`` on ``world`` gloo ranks; returns rank
    0's result.  Kills the ranks and fails after ``timeout`` seconds."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        torch.save(payload, f"{d}/in.pt")
        pc = mp.start_processes(_entry, args=(world, d, worker),
                                nprocs=world, join=False,
                                start_method="spawn")
        deadline = time.time() + timeout
        while not pc.join(timeout=max(1.0, deadline - time.time())):
            if time.time() > deadline:
                for p in pc.processes:
                    p.kill()
                pytest.fail(f"{world} ranks ran past {timeout} s")
        return torch.load(f"{d}/out.pt", weights_only=False)


def run_jax(code: str) -> dict:
    """Runs ``code`` in a subprocess with 8 host devices; it saves arrays to
    the npz path in ``OUT``; returns them."""
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        env["PYTHONPATH"] = str(ROOT / "src")
        env["OUT"] = f"{d}/out.npz"
        out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                             capture_output=True, text=True, env=env,
                             timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        with np.load(f"{d}/out.npz") as z:
            return dict(z)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --------------------------------------------------------------------------
# The expert all-to-all
# --------------------------------------------------------------------------

_MOE_JAX = """
    import os
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.models.config import ArchConfig, MoESpec
    from repro.models import layers as L, moe_ep
    from repro.sharding import ctx as shard_ctx
    cfg = ArchConfig(name="t", family="moe", n_layers=1, d_model=32,
                     n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
                     moe=MoESpec(num_experts=16, top_k=2, d_ff_expert=48,
                                 capacity_factor=8.0))
    p = L.moe_params(cfg, jax.random.PRNGKey(0))
    x = jnp.asarray(np.random.default_rng(1).standard_normal(
        (4, 16, 32)).astype(np.float32)).astype(jnp.bfloat16)
    out = {f"p_{k}": np.asarray(v) for k, v in p.items()}
    out["x"] = np.asarray(x.astype(jnp.float32))

    def loss(f):
        return lambda p, x: jnp.sum(f(p, x).astype(jnp.float32) ** 2)

    def record(tag, f):
        y = jax.jit(f)(p, x)
        gp, gx = jax.jit(jax.grad(loss(f), argnums=(0, 1)))(p, x)
        out[f"{tag}_y"] = np.asarray(y.astype(jnp.float32))
        out[f"{tag}_gx"] = np.asarray(gx.astype(jnp.float32))
        for k, v in gp.items():
            out[f"{tag}_g_{k}"] = np.asarray(v)

    record("dense", lambda p, x: L.moe_dense(cfg, p, x))
    mesh = jax.make_mesh((1, 8), ("data", "model"))
    for case, act in (("replicated", P("data", None, None)),
                      ("seq_split", P(None, "model", None))):
        for a2a in ("bfloat16", "int8"):
            with mesh, shard_ctx.plan_specs(act, None, mesh=mesh,
                                            ep_axis="model"):
                record(f"{case}_{a2a}",
                       lambda p, x, a2a=a2a: moe_ep.moe_ep_a2a(
                           cfg, p, x, a2a_dtype=a2a))
    np.savez(os.environ["OUT"], **out)
"""


def moe_worker(rank: int, payload: dict) -> dict:
    """Every MoE case on this rank: the output and the gradients, gathered
    whole (x's gradient and the sequence-split output by the split, the
    parameters' by a sum over ranks: each holds its experts' and its
    tokens' share)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import moe_ep
    from repro_torch.models.config import ArchConfig, MoESpec
    from repro_torch.sharding import ctx as shard_ctx
    from repro_torch.sharding.specs import Spec
    cfg = ArchConfig(name="t", family="moe", n_layers=1, d_model=32,
                     n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
                     moe=MoESpec(num_experts=16, top_k=2, d_ff_expert=48,
                                 capacity_factor=8.0))
    mesh = make_smoke_mesh((1, 8), ("data", "model"), device_type="cpu")
    world = dist.get_world_size()
    x_all = payload["x"].bfloat16()
    t_loc = x_all.shape[1] // world
    out = {}
    for case, a2a in MOE_CASES:
        p = {k: v.clone().requires_grad_(True)
             for k, v in payload["p"].items()}
        if case == "replicated":
            act, x = Spec("data", None, None), x_all.clone()
        else:
            act = Spec(None, "model", None)
            x = x_all[:, rank * t_loc:(rank + 1) * t_loc].clone()
        x.requires_grad_(True)
        with shard_ctx.plan_specs(act, None, mesh=mesh, ep_axis="model"):
            y = moe_ep.moe_ep_a2a(cfg, p, x, a2a_dtype=a2a)
        # the global loss is the ranks' sum: a replicated output counts
        # once over the EP axis
        share = world if case == "replicated" else 1
        (torch.sum(y.float() ** 2) / share).backward()
        grads = {k: v.grad.clone() for k, v in p.items()}
        for g in grads.values():
            dist.all_reduce(g)
        if case == "replicated":
            gx = x.grad.float()
            dist.all_reduce(gx)
            yw = y.detach().float()
        else:
            parts = [torch.empty_like(x.grad.float()) for _ in range(world)]
            dist.all_gather(parts, x.grad.float())
            gx = torch.cat(parts, 1)
            parts = [torch.empty_like(y.float()) for _ in range(world)]
            dist.all_gather(parts, y.detach().float())
            yw = torch.cat(parts, 1)
        out[(case, a2a)] = {"y": yw, "gx": gx, **{f"g_{k}": g for k, g
                                                   in grads.items()}}
    return out


@pytest.fixture(scope="module")
def moe_runs():
    from repro_torch.models.convert import from_jax
    ref = run_jax(_MOE_JAX)
    p = from_jax({k[2:]: ref[k] for k in ref if k.startswith("p_")},
                 device="cpu")
    got = spawn(moe_worker, 8, {"p": p, "x": torch.from_numpy(ref["x"])})
    return ref, got


@pytest.mark.parametrize("case,a2a", MOE_CASES)
def test_moe_ep_across_ranks_equals_the_references(moe_runs, case, a2a):
    ref, got = moe_runs
    g = got[(case, a2a)]
    tag = f"{case}_{a2a}"
    y = g["y"].numpy()
    np.testing.assert_allclose(y, ref[f"{tag}_y"], atol=DENSE_TOL)
    np.testing.assert_allclose(y, ref["dense_y"], atol=DENSE_TOL)
    errs = {k: rel(g[f"g_{k}"].numpy(), ref[f"{tag}_g_{k}"])
            for k in ("router", "w_gate", "w_up", "w_down")}
    errs["x"] = rel(g["gx"].numpy(), ref[f"{tag}_gx"])
    assert max(errs.values()) < GRAD_TOL[a2a], errs
    assert all(np.isfinite(v) for v in errs.values())


# --------------------------------------------------------------------------
# The GPipe pipeline
# --------------------------------------------------------------------------

_PIPE_JAX = """
    import os
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.models import build_model
    from repro.models import transformer
    from repro.sharding import pipeline
    cfg = get_config("gemma-2b").reduced()          # 2 layers, 2 stages
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    mesh = jax.make_mesh((2, 4), ("pod", "data"))
    staged = pipeline.stage_params(cfg, params, n_stages=2)
    with mesh:
        got = jax.jit(lambda s, t: pipeline.pipeline_hidden(
            cfg, s, t, mesh=mesh, n_stages=2, microbatches=2))(
            staged, jnp.asarray(tokens))
    flat, _ = jax.jit(lambda p, t: transformer.forward(
        cfg, p, t, mode="train", return_hidden=True))(params,
                                                      jnp.asarray(tokens))
    out = {"hidden": np.asarray(got.astype(jnp.float32)), "tokens": tokens,
           "flat": np.asarray(flat.astype(jnp.float32))}
    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["p/" + "/".join(k.key for k in path)] = np.asarray(v)
    np.savez(os.environ["OUT"], **out)
"""


def _unflat(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def pipe_worker(rank: int, payload: dict) -> dict:
    """The pipelined hidden states and the port's flat stack's on two
    stages; one pipelined train step and one unsharded step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import build_model, transformer
    from repro_torch.sharding import MeshDesc, ShardingPlan, pipeline
    from repro_torch.training import optimizer as optim
    from repro_torch.training import train_loop, tree
    cfg = get_config("gemma-2b").reduced()
    model = build_model(cfg)
    mesh = make_smoke_mesh((2, 1), ("pod", "data"), device_type="cpu")
    params, tokens = payload["params"], payload["tokens"]
    targets = torch.roll(tokens, -1, 1)
    flat, _ = transformer.forward(cfg, params, tokens, mode="train",
                                  return_hidden=True)
    staged = pipeline.stage_param_shardings(
        mesh, pipeline.stage_params(cfg, params, 2))
    hidden = pipeline.pipeline_hidden(cfg, staged, tokens, mesh=mesh,
                                      n_stages=2, microbatches=2)
    plan = ShardingPlan(arch=cfg.name, shape="t",
                        mesh=MeshDesc(("pod", "data"), (2, 1)),
                        global_mode="model", local_layout="pipeline",
                        batch_axes=(), tp_axes=(), pipeline_stages=2,
                        microbatches=2, remat=False)
    oc = optim.OptConfig(lr=1e-3, warmup_steps=1)
    batch = {"tokens": tokens, "targets": targets}
    step = pipeline.make_pipeline_train_step(model, oc, plan, mesh)
    p2, _, m2 = step(staged, optim.init(staged), batch)
    one = train_loop.make_train_step(
        model, oc, dataclasses.replace(plan, pipeline_stages=1,
                                       microbatches=1))
    p1, _, m1 = one(params, optim.init(params), batch)
    p1 = pipeline.stage_params(cfg, p1, 2)
    err = max(float((a.float() - b.full_tensor().float()).abs().max())
              for a, b in zip(tree.leaves(p1), tree.leaves(p2)))
    return {"hidden": hidden.float(), "flat": flat.float(),
            "loss": (float(m1["loss"]), float(m2["loss"])),
            "grad_norm": (float(m1["grad_norm"]), float(m2["grad_norm"])),
            "param_err": err}


@pytest.fixture(scope="module")
def pipe_run():
    from repro_torch.models.convert import from_jax
    ref = run_jax(_PIPE_JAX)
    params = from_jax(_unflat({k[2:]: ref[k] for k in ref
                               if k.startswith("p/")}), device="cpu")
    got = spawn(pipe_worker, 2, {"params": params,
                                 "tokens": torch.from_numpy(ref["tokens"])})
    return ref, got


def test_pipeline_hidden_equals_the_flat_stack_and_the_reference(pipe_run):
    """Each package's pipeline against its own flat stack at 3e-2, and the
    port's against the reference's at the cross-package TOL of
    tests/test_torch_model.py: the two flat stacks themselves part by up
    to 0.039 at one element of 4096 (XLA's fused tanh-GeLU rounds once,
    PyTorch after each op)."""
    ref, got = pipe_run
    hidden = got["hidden"].numpy()
    np.testing.assert_allclose(hidden, got["flat"].numpy(), atol=PIPE_TOL,
                               rtol=PIPE_TOL)
    np.testing.assert_allclose(ref["hidden"], ref["flat"], atol=PIPE_TOL,
                               rtol=PIPE_TOL)
    np.testing.assert_allclose(hidden, ref["hidden"], atol=CROSS_TOL,
                               rtol=CROSS_TOL)


def test_pipeline_train_step_equals_the_unsharded_step(pipe_run):
    _, got = pipe_run
    (l1, l2), (n1, n2) = got["loss"], got["grad_norm"]
    np.testing.assert_allclose(l2, l1, rtol=LOSS_RTOL)
    np.testing.assert_allclose(n2, n1, rtol=1e-4)
    assert got["param_err"] < PARAM_ATOL, got["param_err"]
