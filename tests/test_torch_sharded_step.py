"""The sharded train step (``repro_torch.sharding.spmd``) on 4 gloo ranks
against the port's unsharded ``make_train_step``, on reduced gemma-2b and
reduced qwen3-moe-30b-a3b from the JAX package's initialisation
(``from_jax``), under the GPU planner's training layouts:

* ``P1_pure_dp``: the batch over ("data", "model"), parameters replicated,
  two microbatches accumulated;
* ``fsdp_all``: the batch and FSDP over ("data", "model");
* ``dp_sp_fsdp_ep``: the batch over "data", the sequence over "model"
  (attention gathers keys and values, queries offset), FSDP over both, and
  for qwen3 the experts split over "model" behind the all-to-all;
* ``fsdp_all`` on a (2, 1, 2) ("pod", "data", "model") mesh, the batch over
  all three axes and FSDP over ("data", "model"), as ``plan_gpu`` plans
  gemma-2b on two nodes.

Two steps each: the losses at tests/test_distributed.py's rtol 2e-3, every
parameter after the first step at its atol 3e-3 (after the second at
twice that), and the first step's clip norm
(global over the shards; a rank's own norm would miss by tens of percent)
at rtol 1e-3: under the sequence split the keys' and values' gradients are
sums of the ranks' bf16 partials (2.3e-4 from the unsharded norm on gemma).
The second step's norm is not compared: AdamW's first step moves each
parameter by about ±lr whatever its gradient's size, so that parameters
whose gradients are near 0 part by up to 2·lr between the runs.  qwen3's
capacity factor is raised to 8 so that no assignment is dropped in either
step (the unsharded grouped step bounds the flat assignment index, the
sharded one each destination's).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from test_torch_distributed import LOSS_RTOL, PARAM_ATOL, spawn  # noqa: E402

ARCHS = ("gemma-2b", "qwen3-moe-30b-a3b")
LAYOUTS = ("P1_pure_dp", "fsdp_all", "dp_sp_fsdp_ep", "fsdp_all_pod")
B, T, STEPS = 8, 32, 2
NORM_RTOL = 1e-3


def _cfg(aid: str):
    from repro_torch.configs import get_config
    cfg = get_config(aid).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


def _plan(layout: str, moe_impl: str):
    from repro_torch.sharding import MeshDesc, ShardingPlan
    two = MeshDesc(("data", "model"), (2, 2))
    kw = dict(arch="t", shape="t", global_mode="data", tp_axes=(),
              moe_impl=moe_impl)
    if layout == "P1_pure_dp":
        return ShardingPlan(mesh=two, local_layout=layout,
                            batch_axes=("data", "model"), microbatches=2,
                            **kw)
    if layout == "fsdp_all":
        return ShardingPlan(mesh=two, local_layout=layout,
                            batch_axes=("data", "model"),
                            fsdp_axes=("data", "model"), **kw)
    if layout == "dp_sp_fsdp_ep":
        return ShardingPlan(mesh=two, local_layout=layout,
                            batch_axes=("data",), seq_axes=("model",),
                            fsdp_axes=("data", "model"), **kw)
    return ShardingPlan(mesh=MeshDesc(("pod", "data", "model"), (2, 1, 2)),
                        local_layout="fsdp_all",
                        batch_axes=("pod", "data", "model"),
                        fsdp_axes=("data", "model"), **kw)


def step_worker(rank: int, payload: dict) -> dict:
    """STEPS unsharded steps, then STEPS sharded steps under each layout,
    all from the same parameters and batches."""
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import specs, spmd
    from repro_torch.training import optimizer as optim
    from repro_torch.training import train_loop, tree
    cfg = _cfg(payload["arch"])
    model = build_model(cfg)
    impl = "ep_a2a" if cfg.moe is not None else "dense"
    oc = optim.OptConfig(lr=1e-3, warmup_steps=1)
    batches = payload["batches"]
    meshes = {"data,model": make_smoke_mesh((2, 2), ("data", "model"),
                                            device_type="cpu"),
              "pod,data,model": make_smoke_mesh(
                  (2, 1, 2), ("pod", "data", "model"), device_type="cpu")}
    flat_plan = dataclasses.replace(_plan("fsdp_all", impl), batch_axes=(),
                                    fsdp_axes=())
    step = train_loop.make_train_step(model, oc, flat_plan)
    params, opt = payload["params"], optim.init(payload["params"])
    want, trail = [], []
    for b in batches:
        params, opt, m = step(params, opt, b)
        want.append((float(m["loss"]), float(m["grad_norm"])))
        trail.append(params)
    out = {"want": want}
    for layout in LAYOUTS:
        plan = _plan(layout, impl)
        mesh = meshes[",".join(plan.mesh.axes)]
        sp = specs.param_shardings(mesh, payload["params"], plan)
        so = optim.init(sp)
        sstep = spmd.make_sharded_train_step(model, oc, plan, mesh)
        got, errs = [], []
        for b, ps in zip(batches, trail):
            sp, so, m = sstep(sp, so, b)
            got.append((float(m["loss"]), float(m["grad_norm"])))
            errs.append(max(
                float((a.float() - b.full_tensor().float()).abs().max())
                for a, b in zip(tree.leaves(ps), tree.leaves(sp))))
        out[layout] = {"metrics": got, "param_err": errs}
    return out


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    aid = request.param
    jparams = jbuild_model(jget_config(aid).reduced()).init(
        jax.random.PRNGKey(0))
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    vocab = jget_config(aid).reduced().vocab
    rng = np.random.default_rng(1)
    batches = [{k: torch.from_numpy(rng.integers(0, vocab, (B, T)).astype(
        np.int32)) for k in ("tokens", "targets")} for _ in range(STEPS)]
    return spawn(step_worker, 4, {"arch": aid, "params": params,
                                  "batches": batches})


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_step_equals_the_unsharded_step(runs, layout):
    got = runs[layout]
    for (l1, _), (l2, _) in zip(runs["want"], got["metrics"]):
        np.testing.assert_allclose(l2, l1, rtol=LOSS_RTOL)
    (_, n1), (_, n2) = runs["want"][0], got["metrics"][0]
    np.testing.assert_allclose(n2, n1, rtol=NORM_RTOL)
    # each AdamW step may part a parameter by up to its own 2·lr
    for i, err in enumerate(got["param_err"]):
        assert err < (i + 1) * PARAM_ATOL, got["param_err"]
