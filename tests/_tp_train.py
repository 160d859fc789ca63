"""The harness of tests/test_torch_tp_train.py and
tests/test_torch_tp_train_ssm.py: training under tensor parallelism on 4
gloo ranks against the port's unsharded ``train_loop`` and the reference's
single-device ``make_train_step`` (see the test files for what is held).
A case is (arch, layout, mesh shape, plan overrides)."""

import dataclasses
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from test_torch_distributed import (LOSS_RTOL, PARAM_ATOL, ROOT,  # noqa: E402
                                    rel, spawn)

GEMMA, QWEN3 = "gemma-2b", "qwen3-moe-30b-a3b"
B, T, STEPS = 4, 32, 2
GRAD_RTOL = 1e-4
BF16_NORM_RTOL = 1e-2
SPAWN_TIMEOUT = JAX_TIMEOUT = 300


def tag(aid, layout, mesh, extra=None) -> str:
    return f"{aid}_{layout}_{mesh[0]}x{mesh[1]}"


def _cfg(aid: str):
    from repro_torch.configs import get_config
    cfg = get_config(aid).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


def _plan(layout: str, mesh, extra: dict):
    from repro_torch.sharding import MeshDesc, ShardingPlan
    impl = ("ep_a2a_q8" if layout.endswith("_q8") else
            "ep_a2a" if layout.endswith("_ep") else "dense")
    return ShardingPlan(
        arch="t", shape="t", mesh=MeshDesc(("data", "model"), mesh),
        global_mode="data", local_layout=layout, batch_axes=("data",),
        tp_axes=("model",),
        fsdp_axes=("data",) if "fsdp" in layout else (), moe_impl=impl,
        **{"remat": False, **extra})


def _batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
           for k in ("tokens", "targets")}
    if cfg.family == "audio":
        out["frames"] = (rng.standard_normal((B, T // 2, cfg.d_model))
                         * 0.1).astype(np.float32)
    return out


# the reference's first loss of each arch: its single-device
# make_train_step in bf16, from PRNGKey(0) (the weights the ranks load)
_JAX = """
    import dataclasses, os
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import build_model
    from repro.sharding.plan import SINGLE_POD, ShardingPlan
    from repro.training import optimizer as optim, train_loop
    out = {}
    with np.load(os.environ["BATCHES"]) as z:
        batches = dict(z)
    for aid in os.environ["ARCHS"].split(","):
        cfg = get_config(aid).reduced()
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0))
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        step = jax.jit(train_loop.make_train_step(
            model, optim.OptConfig(lr=1e-3, warmup_steps=1),
            ShardingPlan(arch="t", shape="t", mesh=SINGLE_POD,
                         global_mode="data", local_layout="x",
                         batch_axes=())))
        batch = {k.split("/")[1]: jnp.asarray(v) for k, v in batches.items()
                 if k.startswith(aid + "/")}
        _, _, m = step(params, optim.init(params), batch)
        out[aid] = np.asarray(m["loss"])
    np.savez(os.environ["OUT"], **out)
"""


def _recorder(group_name: str):
    """A dispatch mode that records every collective issued under it and
    whether it named ``group_name`` (the tp group; the functional
    collectives take their group by name)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.launch import dryrun

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.records: list = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func._schema.name
            if dryrun.collective_kind(name) is not None:
                self.records.append((name.split("::")[-1], any(
                    isinstance(a, str) and a == group_name for a in args)))
            return func(*args, **(kwargs or {}))

    return Recorder()


def tp_train_worker(rank: int, payload: dict) -> dict:
    """Every case on this rank: the unsharded port's fp32 gradients and
    bf16 steps, then the tp step's; rank 0 returns the errors, metrics,
    the leaves the layers saw and the collectives issued."""
    import logging
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import build_model, layers
    from repro_torch.sharding import specs, spmd
    from repro_torch.training import optimizer as optim
    from repro_torch.training import train_loop, tree
    from torch.distributed.tensor import DTensor, Shard
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    cases = payload["cases"]
    meshes = {m: make_smoke_mesh(m, ("data", "model"), device_type="cpu")
              for m in sorted({c[2] for c in cases})}
    seen: list = []
    leaf = spmd._Gather.leaf

    def spy_leaf(self, path, x):
        out = leaf(self, path, x)
        if isinstance(x, DTensor):
            i = list(x.device_mesh.mesh_dim_names).index("model")
            if isinstance(x.placements[i], Shard):
                seen.append((path, tuple(x.shape), tuple(out.shape)))
        return out
    spmd._Gather.leaf = spy_leaf
    oc = optim.OptConfig(lr=1e-3, warmup_steps=1)
    res = {}
    for aid, layout, shp, extra in cases:
        cfg = _cfg(aid)
        model = build_model(cfg)
        plan, mesh = _plan(layout, shp, extra), meshes[shp]
        flat = dataclasses.replace(plan, batch_axes=(), tp_axes=(),
                                   fsdp_axes=())
        params = payload["params"][aid]
        batches = payload["batches"][aid]
        out = {}
        # (a) fp32 compute: every gradient leaf
        compute = layers.COMPUTE_DTYPE
        layers.COMPUTE_DTYPE = torch.float32
        try:
            with torch.enable_grad():
                ps = tree.map(lambda p: p.detach().requires_grad_(True),
                              params)
                want = torch.autograd.grad(train_loop.loss_fn(
                    model, ps, batches[0], remat=False,
                    moe_impl=plan.moe_impl), tree.leaves(ps))
            sp = specs.param_shardings(mesh, params, plan)
            _, grads = spmd.make_sharded_grad_fn(model, plan, mesh)(
                sp, batches[0])
            out["grad_err"] = {
                "/".join(p): rel(g.full_tensor().numpy(), w.numpy())
                for p, g, w in zip(_paths(params), tree.leaves(grads),
                                   want)}
            out["norm_fp32"] = float(torch.sqrt(sum(
                torch.sum(w.double() ** 2) for w in want)))
        finally:
            layers.COMPUTE_DTYPE = compute
        # (b) bf16: two steps each
        step = train_loop.make_train_step(model, oc, flat)
        p, o, want, trail = params, optim.init(params), [], []
        for b in batches:
            p, o, m = step(p, o, b)
            want.append((float(m["loss"]), float(m["grad_norm"])))
            trail.append(p)
        sp = specs.param_shardings(mesh, params, plan)
        so = optim.init(sp)
        sstep = spmd.make_sharded_train_step(model, oc, plan, mesh)
        rec = _recorder(mesh.get_group("model").group_name)
        seen.clear()
        got, errs = [], []
        for i, (b, ps) in enumerate(zip(batches, trail)):
            if i == 0:
                with rec:
                    sp, so, m = sstep(sp, so, b)
            else:
                sp, so, m = sstep(sp, so, b)
            got.append((float(m["loss"]), float(m["grad_norm"])))
            errs.append(max(
                float((a.float() - s.full_tensor().float()).abs().max())
                for a, s in zip(tree.leaves(ps), tree.leaves(sp))))
        out.update(want=want, got=got, param_err=errs, seen=list(seen),
                   collectives=rec.records)
        res[tag(aid, layout, shp)] = out
    return res


def _paths(tree: dict, prefix: tuple = ()) -> list:
    """The leaves' key paths, in ``training.tree.leaves``' order."""
    out = []
    for k in sorted(tree):
        out += (_paths(tree[k], prefix + (k,)) if isinstance(tree[k], dict)
                else [prefix + (k,)])
    return out


def run_cases(cases: list) -> tuple[dict, dict]:
    """The ranks' runs of ``cases`` (one spawn of 4 ranks for all), and
    the reference's first loss of each arch (a JAX subprocess beside
    them): (reference losses by arch, results by ``tag``)."""
    archs = sorted({c[0] for c in cases})
    params, batches, flat = {}, {}, {}
    for aid in archs:
        jparams = jbuild_model(jget_config(aid).reduced()).init(
            jax.random.PRNGKey(0))
        params[aid] = from_jax(jax.tree.map(np.asarray, jparams),
                               device="cpu")
        cfg = jget_config(aid).reduced()
        bs = [_batch(cfg, 10 + i) for i in range(STEPS)]
        flat.update({f"{aid}/{k}": v for k, v in bs[0].items()})
        batches[aid] = [{k: torch.from_numpy(v) for k, v in b.items()}
                        for b in bs]
    with tempfile.TemporaryDirectory() as d:
        np.savez(f"{d}/batches.npz", **flat)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OUT=f"{d}/out.npz", BATCHES=f"{d}/batches.npz",
                   ARCHS=",".join(archs))
        proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_JAX)],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            got = spawn(tp_train_worker, 4, {"cases": cases,
                                             "params": params,
                                             "batches": batches},
                        timeout=SPAWN_TIMEOUT)
            _, err = proc.communicate(timeout=JAX_TIMEOUT)
            assert proc.returncode == 0, err[-3000:]
            with np.load(f"{d}/out.npz") as z:
                ref = {k: float(z[k]) for k in z.files}
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return ref, got


def check_gradients(runs, case) -> None:
    """(a) every fp32 gradient leaf within ``GRAD_RTOL``."""
    errs = runs[1][tag(*case)]["grad_err"]
    bad = {k: e for k, e in errs.items() if not e < GRAD_RTOL}
    assert not bad, bad


def check_steps(runs, case) -> None:
    """(b) two bf16 steps against the unsharded step's."""
    r = runs[1][tag(*case)]
    for (l1, _), (l2, _) in zip(r["want"], r["got"]):
        np.testing.assert_allclose(l2, l1, rtol=LOSS_RTOL)
    # the first clip norm: both bf16 norms lie within BF16_NORM_RTOL of the
    # exact one (the unsharded step's in fp32), and of each other
    exact = r["norm_fp32"]
    for n in (r["want"][0][1], r["got"][0][1]):
        np.testing.assert_allclose(n, exact, rtol=BF16_NORM_RTOL)
    np.testing.assert_allclose(r["got"][0][1], r["want"][0][1],
                               rtol=BF16_NORM_RTOL)
    # each AdamW step may part a parameter by up to its own 2·lr
    for i, err in enumerate(r["param_err"]):
        assert err < (i + 1) * PARAM_ATOL, r["param_err"]


def check_first_loss(runs, case) -> None:
    """(c) the first loss against the reference's single-device step."""
    ref, got = runs
    np.testing.assert_allclose(got[tag(*case)]["got"][0][0], ref[case[0]],
                               rtol=LOSS_RTOL)


def check_split(runs, case) -> None:
    """(d) every leaf split over ``model`` reached the layers as its shard;
    an all-reduce crossed the tp group."""
    r = runs[1][tag(*case)]
    assert r["seen"], "no leaf split over model reached a layer"
    for path, whole, local in r["seen"]:
        assert local != whole, (path, whole, local)
    over_model = {name for name, tp in r["collectives"] if tp}
    assert "all_reduce" in over_model, r["collectives"]
