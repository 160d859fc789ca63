"""Tensor-parallel serving (``sharding.spmd.make_sharded_prefill`` and
``make_sharded_decode``) on 4 gloo ranks on the CPU, against the
reference's sharded ``jax.jit(prefill | decode, in_shardings=...,
out_shardings=...)`` on the same mesh shape (8 host devices, in a
subprocess that also draws the weights) and against the port's unsharded
``apply_prefill``/``apply_decode``.

Reduced gemma-2b, gemma3-1b, mixtral-8x7b (``dp_tp_ep``: the expert
all-to-all, and a one-token batch that takes the dense fall-back over the
rank's experts), whisper-tiny, mamba2-780m and hymba-1.5b, each under a
(2, 2) and a (1, 4) ("data", "model") mesh: at ``model`` 2 the archs with
2 KV heads split their caches by heads, at ``model`` 4 (and gemma's single
KV head at 2) over the sequence, and the shares of gemma3-1b's windowed
layers run empty.  A prompt of T tokens with ragged lengths, some at the
shares' boundaries, then ``STEPS`` decode steps into a cache of S rows.

Held: the logits of every step (gathered) at tests/test_torch_model.py's
5e-2 against both, greedy tokens equal save near ties, the caches by
relative norm per layer; no leaf split over ``model`` is gathered whole
(every leaf the layers see keeps its shard), and the collectives issued
are recorded.  The weights come from the reference's initialisation
(``from_jax``); MoE capacity factors are raised to 8 so that no
assignment is dropped in either package's lowering.
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_distributed import CROSS_TOL, ROOT, spawn  # noqa: E402

MESHES = ((2, 2), (1, 4))
# (arch, batch, meshes): the reference's shard_map cannot split a batch of
# 1 over ``data`` = 2, so the one-token MoE batch runs on (1, 4) only
CASES = [(aid, 4, MESHES) for aid in
         ("gemma-2b", "gemma3-1b", "mixtral-8x7b", "whisper-tiny",
          "mamba2-780m", "hymba-1.5b")] + [("mixtral-8x7b", 1, MESHES[1:])]
T, S, STEPS = 16, 32, 3
# prompt lengths: the first decode writes at 16 (a share's first row at
# model 2 and 4), 15 (the last row of the share before), 8, 11
LENS = [16, 15, 8, 11]
# a greedy token may differ only where the reference's top two logits lie
# closer than this (tests/test_torch_moe.py's near-tie rule)
NEAR_TIE = 5e-2
# the reference's 13 cases and the ranks' run of them each take about a
# minute alone; the limits leave room for a loaded machine
JAX_TIMEOUT = SPAWN_TIMEOUT = 300


def _tag(aid, b, mesh) -> str:
    return f"{aid}_{b}_{mesh[0]}x{mesh[1]}"


_JAX = """
    import dataclasses, json, os
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.configs import get_config
    from repro.models import build_model
    from repro.sharding import ctx as shard_ctx, specs
    from repro.sharding.plan import MeshDesc, ShardingPlan
    CASES, (T, S, STEPS), LENS = json.loads(os.environ["CASES"])
    out, inputs, bf16 = {}, {}, []

    def cfg_of(aid):
        cfg = get_config(aid).reduced()
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0))
        return cfg

    def flat(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, f"{prefix}{k}/")
            else:
                if v.dtype == jnp.bfloat16:
                    bf16.append(prefix + k)
                inputs[prefix + k] = np.asarray(v.astype(jnp.float32))

    models = {}
    for aid, b, _ in CASES:
        cfg = cfg_of(aid)
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0), dtype=jnp.bfloat16)
        rng = np.random.default_rng(1)
        tag = f"{aid}_{b}"
        batch = {"tokens": rng.integers(0, cfg.vocab, (b, T)).astype(
                     np.int32),
                 "lengths": np.asarray(LENS[:b], np.int32)}
        steps = rng.integers(0, cfg.vocab, (STEPS, b, 1)).astype(np.int32)
        if cfg.family == "audio":
            batch["frames"] = (rng.standard_normal((b, T, cfg.d_model))
                               * 0.1).astype(np.float32)
        flat(params, f"p/{aid}/")
        for k, v in batch.items():
            inputs[f"in/{tag}/{k}"] = v
        inputs[f"in/{tag}/steps"] = steps
        models[(aid, b)] = (cfg, model, params, batch, steps)
    np.savez(os.environ["PARAMS"], bf16=np.asarray(bf16), **inputs)
    os.rename(os.environ["PARAMS"], os.environ["PARAMS"] + ".ready.npz")

    for aid, b, meshes in CASES:
        cfg, model, params, batch, steps = models[(aid, b)]
        batch = {k: jnp.asarray(v).astype(jnp.bfloat16) if k == "frames"
                 else jnp.asarray(v) for k, v in batch.items()}
        impl = "ep_a2a" if cfg.moe is not None else "dense"
        enc = T if cfg.family == "audio" else None
        for shp in meshes:
            mesh = Mesh(np.array(jax.devices()[:shp[0] * shp[1]]).reshape(
                shp), ("data", "model"))
            plan = ShardingPlan(
                arch=aid, shape="t", mesh=MeshDesc(("data", "model"), shp),
                global_mode="data", local_layout="dp_tp", moe_impl=impl,
                batch_axes=("data",), tp_axes=("model",))
            p_sh = specs.param_shardings(mesh, params, plan)
            c_sh = specs.cache_shardings(
                mesh, model.init_cache(b, T, abstract=True, enc_len=enc),
                plan)
            dc_sh = specs.cache_shardings(
                mesh, model.init_cache(b, S, abstract=True, enc_len=enc),
                plan)
            lsh = specs.logits_sharding(mesh, plan, (b, 1, cfg.vocab))
            step_b = {"tokens": steps[0], "lengths": batch["lengths"]}
            tag = f"{aid}_{b}_{shp[0]}x{shp[1]}"
            with mesh, shard_ctx.plan_specs(
                    P("data", None, None), P("data", None, "model"),
                    mesh=mesh, ep_axis="model"):
                pf = jax.jit(lambda p, bt: model.apply_prefill(
                    p, bt, moe_impl=impl), in_shardings=(
                    p_sh, specs.batch_shardings(mesh, batch, plan)),
                    out_shardings=(lsh, c_sh))
                dec = jax.jit(lambda p, c, bt: model.apply_decode(
                    p, c, bt, moe_impl=impl), in_shardings=(
                    p_sh, dc_sh, specs.batch_shardings(mesh, step_b, plan)),
                    out_shardings=(lsh, dc_sh), donate_argnums=(1,))
                ps = jax.device_put(params, p_sh)
                logits, cache = pf(ps, batch)
                out[f"{tag}/logits0"] = np.asarray(logits)
                for k, v in cache.items():
                    out[f"{tag}/prefill_{k}"] = np.asarray(
                        v.astype(jnp.float32))
                    if k in ("k", "v"):
                        pad = [(0, 0)] * v.ndim
                        pad[-3] = (0, S - T)
                        cache[k] = jnp.pad(v, pad)
                cache = jax.device_put(cache, dc_sh)
                lens = batch["lengths"]
                for i in range(STEPS):
                    lens = lens + 1
                    logits, cache = dec(ps, cache, {
                        "tokens": jnp.asarray(steps[i]), "lengths": lens})
                    out[f"{tag}/logits{i + 1}"] = np.asarray(logits)
                for k, v in cache.items():
                    out[f"{tag}/cache_{k}"] = np.asarray(
                        v.astype(jnp.float32))
    np.savez(os.environ["OUT"], **out)
"""


def _cfg(aid: str):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(aid).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    return cfg


def _plan(aid: str, mesh_shape):
    from repro_torch.sharding import MeshDesc, ShardingPlan
    moe = _cfg(aid).moe is not None
    return ShardingPlan(arch=aid, shape="t",
                        mesh=MeshDesc(("data", "model"), tuple(mesh_shape)),
                        global_mode="data",
                        local_layout="dp_tp_ep" if moe else "dp_tp",
                        batch_axes=("data",), tp_axes=("model",),
                        moe_impl="ep_a2a" if moe else "dense")


def _pad(cache: dict) -> dict:
    """A prompt's cache (k/v of T rows) in a decode cache of S rows."""
    out = {}
    for k, v in cache.items():
        if k in ("k", "v"):
            w = torch.zeros((*v.shape[:-3], S, *v.shape[-2:]),
                            dtype=v.dtype)
            w[..., :T, :, :] = v
            v = w
        out[k] = v.clone()          # decode writes h and conv in place
    return out


def serve_worker(rank: int, payload: dict) -> dict:
    """Every case on this rank: the unsharded steps, then the sharded ones
    under each mesh; rank 0 returns the logits, caches, the leaves the
    layers saw and the collectives issued."""
    import logging
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import specs, spmd
    from torch.distributed.tensor import DTensor, Shard
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    meshes = {m: make_smoke_mesh(m, ("data", "model"), device_type="cpu")
              for m in MESHES}
    seen: list = []
    serving_params, leaf = spmd.serving_params, spmd._Gather.leaf

    def record(path, x, out):
        if isinstance(x, DTensor):
            i = list(x.device_mesh.mesh_dim_names).index("model")
            if isinstance(x.placements[i], Shard):
                seen.append((path, tuple(x.shape), tuple(out.shape)))

    def spy_params(params, gather):
        ps, g = serving_params(params, gather)
        if g is None:                  # every local shard taken at once
            specs.tree_map_with_path(
                lambda path, x: record(path, x, _at(ps, path)), params)
        return ps, g

    def spy_leaf(self, path, x):
        out = leaf(self, path, x)
        record(path, x, out)
        return out
    spmd.serving_params, spmd._Gather.leaf = spy_params, spy_leaf
    res = {}
    for aid, b, mesh_shapes in CASES:
        cfg = _cfg(aid)
        model = build_model(cfg)
        params = payload["params"][aid]
        inp = payload["inputs"][f"{aid}_{b}"]
        batch = {k: v for k, v in inp.items() if k != "steps"}
        steps = inp["steps"]
        impl = "ep_a2a" if cfg.moe is not None else "dense"
        with torch.no_grad():
            logits, cache = model.apply_prefill(params, batch, moe_impl=impl)
            want = {"logits0": logits, **{f"prefill_{k}": v
                                          for k, v in cache.items()}}
            cache, lens = _pad(cache), batch["lengths"]
            for i in range(STEPS):
                lens = lens + 1
                logits, cache = model.apply_decode(
                    params, cache, {"tokens": steps[i], "lengths": lens},
                    moe_impl=impl)
                want[f"logits{i + 1}"] = logits
            want.update({f"cache_{k}": v for k, v in cache.items()})
        for shp in mesh_shapes:
            mesh, plan = meshes[shp], _plan(aid, shp)
            sp = specs.param_shardings(mesh, params, plan)
            prefill = spmd.make_sharded_prefill(model, plan, mesh)
            decode = spmd.make_sharded_decode(model, plan, mesh)
            rec = dryrun._recording_mode()
            seen.clear()
            got = {}
            with rec:
                logits, cache = prefill(sp, batch)
            got["logits0"] = logits.full_tensor()
            whole = {k: v.full_tensor() for k, v in cache.items()}
            got.update({f"prefill_{k}": v for k, v in whole.items()})
            layout = {k: tuple(map(str, v.placements))
                      for k, v in cache.items()}
            dc = specs.cache_shardings(mesh, _pad(whole), plan)
            lens = batch["lengths"]
            for i in range(STEPS):
                lens = lens + 1
                with rec:
                    logits, dc = decode(sp, dc, {"tokens": steps[i],
                                                 "lengths": lens})
                got[f"logits{i + 1}"] = logits.full_tensor()
            got.update({f"cache_{k}": v.full_tensor() for k, v in dc.items()})
            got["layout"] = layout
            got["seen"] = list(seen)
            got["collectives"] = rec.records
            res[_tag(aid, b, shp)] = {"got": got, "want": want}
    dist.barrier()
    return res


def _at(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


@pytest.fixture(scope="module")
def runs():
    """The reference's sharded runs (a subprocess with 8 host devices,
    which first saves the weights and inputs) and the port's, side by
    side: the ranks start as soon as the weights are saved."""
    import ml_dtypes
    from repro_torch.models.convert import from_jax
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        env["PYTHONPATH"] = str(ROOT / "src")
        env.update(OUT=f"{d}/out.npz", PARAMS=f"{d}/params.npz",
                   CASES=json.dumps([CASES, (T, S, STEPS), LENS]))
        proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_JAX)],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            ready, deadline = f"{d}/params.npz.ready.npz", \
                time.time() + JAX_TIMEOUT
            while not os.path.exists(ready):
                if proc.poll() is not None or time.time() > deadline:
                    pytest.fail("the reference did not save its weights: "
                                + proc.communicate()[1][-3000:])
                time.sleep(0.2)
            with np.load(ready) as z:
                bf16 = set(z["bf16"].tolist())
                tree = _unflatten({k: (z[k].astype(ml_dtypes.bfloat16)
                                       if k in bf16 else z[k])
                                   for k in z.files if k != "bf16"})
            params = {aid: from_jax(p, device="cpu")
                      for aid, p in tree["p"].items()}
            inputs = {tag: {k: (torch.from_numpy(v).bfloat16()
                                if k == "frames" else torch.from_numpy(v))
                            for k, v in case.items()}
                      for tag, case in tree["in"].items()}
            got = spawn(serve_worker, 4, {"params": params,
                                          "inputs": inputs},
                        timeout=SPAWN_TIMEOUT)
            _, err = proc.communicate(timeout=JAX_TIMEOUT)
            assert proc.returncode == 0, err[-3000:]
            with np.load(f"{d}/out.npz") as z:
                ref = dict(z)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return ref, got


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, what):
    np.testing.assert_allclose(_np(got), _np(want), atol=CROSS_TOL,
                               rtol=CROSS_TOL, err_msg=what)


def _close_cache(got, want, what):
    """Per layer by relative Frobenius norm (deeper layers see inputs that
    already differ by bf16 rounding, tests/test_torch_model.py)."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    for layer in range(len(g)):
        err = np.linalg.norm(g[layer] - w[layer]) / max(
            np.linalg.norm(w[layer]), 1e-30)
        assert err < CROSS_TOL, (what, layer, err)


def _greedy_equal(got, want, what):
    """argmax of every row equal, save where the reference's top two lie
    within ``NEAR_TIE``."""
    g = _np(got).reshape(-1, got.shape[-1])
    w = _np(want).reshape(-1, got.shape[-1])
    top2 = np.sort(w, -1)[:, -2:]
    tie = top2[:, 1] - top2[:, 0] < NEAR_TIE
    off = g.argmax(-1) != w.argmax(-1)
    assert not (off & ~tie).any(), (what, np.argwhere(off & ~tie))


ALL = [(aid, b, m) for aid, b, meshes in CASES for m in meshes]


@pytest.mark.parametrize("aid,b,mesh", ALL,
                         ids=[_tag(*c) for c in ALL])
def test_sharded_serving_equals_the_reference_and_unsharded(runs, aid, b,
                                                            mesh):
    ref, got = runs
    tag = _tag(aid, b, mesh)
    g, w = got[tag]["got"], got[tag]["want"]
    for i in range(STEPS + 1):
        key = f"logits{i}"
        _close(g[key], ref[f"{tag}/{key}"], f"{tag} {key} vs reference")
        _close(g[key], w[key], f"{tag} {key} vs unsharded")
        _greedy_equal(g[key], ref[f"{tag}/{key}"], f"{tag} {key}")
    for k in [k for k in g if k.startswith(("prefill_", "cache_"))]:
        _close_cache(g[k], ref[f"{tag}/{k}"], f"{tag} {k} vs reference")
        _close_cache(g[k], w[k], f"{tag} {k} vs unsharded")


@pytest.mark.parametrize("aid,b,mesh", ALL,
                         ids=[_tag(*c) for c in ALL])
def test_weights_stay_split_and_activations_cross(runs, aid, b, mesh):
    """Every leaf split over ``model`` reached the layers as its shard; the
    steps all-reduce over the tp group; the caches lie as the specs say."""
    _, got = runs
    g = got[_tag(aid, b, mesh)]["got"]
    assert g["seen"], "no leaf split over model reached a layer"
    for path, whole, local in g["seen"]:
        assert local != whole, (path, whole, local)
    kinds = {}
    for name, results in g["collectives"]:
        kind = name.split("::")[-1]
        kinds[kind] = kinds.get(kind, 0) + 1
    assert kinds.get("all_reduce", 0) > 0, kinds
    # the prompt's k/v (L, B, T, Hkv, hd) over ``model``: by heads where
    # they divide, else along the sequence
    if "k" in g["layout"]:
        dim = 3 if _cfg(aid).n_kv_heads % mesh[1] == 0 else 2
        assert g["layout"]["k"][1] == f"S({dim})", g["layout"]


def world_one_worker(rank: int, payload: dict) -> dict:
    """Reduced gemma-2b under ``dp_tp`` on a (1, 1) mesh: the cache splits
    by its one KV head over a ``model`` of 1, every weight is its own
    share, and the collectives run over one rank."""
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import specs, spmd
    cfg = _cfg("gemma-2b")
    model = build_model(cfg)
    mesh = make_smoke_mesh((1, 1), ("data", "model"), device_type="cpu")
    plan = _plan("gemma-2b", (1, 1))
    params = model.init(torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.bfloat16)
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab, (4, T)).astype(np.int32)),
             "lengths": torch.tensor(LENS, dtype=torch.int32)}
    step = {"tokens": batch["tokens"][:, :1], "lengths": batch["lengths"] + 1}
    with torch.no_grad():
        want0, cache = model.apply_prefill(params, batch)
        want1, _ = model.apply_decode(params, _pad(cache), step)
    sp = specs.param_shardings(mesh, params, plan)
    got0, cache = spmd.make_sharded_prefill(model, plan, mesh)(sp, batch)
    dc = specs.cache_shardings(mesh, _pad({k: v.to_local()
                                           for k, v in cache.items()}), plan)
    got1, _ = spmd.make_sharded_decode(model, plan, mesh)(sp, dc, step)
    return {"got": (got0.to_local(), got1.to_local()),
            "want": (want0, want1),
            "layout": tuple(map(str, cache["k"].placements))}


def test_world_one_equals_the_unsharded_steps():
    """At world 1 the sharded steps run the unsharded arithmetic: equal
    to the bit."""
    r = spawn(world_one_worker, 1, {})
    assert r["layout"] == ("S(1)", "S(3)")      # batch, KV heads
    for g, w in zip(r["got"], r["want"]):
        assert torch.equal(g, w)
