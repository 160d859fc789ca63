"""The harness of tests/test_torch_ctx_tp.py, tests/test_torch_tp_all.py and
tests/test_torch_ssm_seq_split.py: the sharded serving steps
(``spmd.make_sharded_prefill``/``make_sharded_decode``) under the layouts
that put a sequence split beside tensor parallelism (``seq_tp``,
``ctx_tp``, ``ctx_tp_ep``, ``ctx_tp_ep_q8``) or split tensors over two
axes (``tp_all``), on 4 gloo ranks, against the reference's sharded
``jax.jit(prefill | decode, in_shardings=..., out_shardings=...)`` on the
same mesh (8 host devices, in a subprocess that first saves the weights,
so that the ranks start beside it) and the port's unsharded steps.

A case is (arch, batch, mesh, prefill layout, decode layout, config
overrides): a prompt of ``T`` tokens with ragged lengths, some at the
shares' boundaries, under the prefill layout, its cache padded to ``S``
rows and placed under the decode layout, then ``STEPS`` decode steps.
Held (``check``): the logits of every step at 5e-2 against both, greedy
tokens equal save near ties, the caches by relative norm per layer.  Every
leaf split over a tp axis reached the layers as its shard, and the
collectives issued are recorded.  MoE capacity factors are raised to 8 so
that no assignment is dropped in either package's lowering.
"""

import dataclasses
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

T, S, STEPS = 16, 32, 3
# prompt lengths: the first decode writes at 16 (a share's first row at 2
# and 4 shares of S), 15 (the last row of the share before), 8 (a share's
# first row at 4 shares), 11
LENS = [16, 15, 8, 11]
# a greedy token may differ only where the reference's top two logits lie
# closer than this (tests/test_torch_moe.py's near-tie rule)
NEAR_TIE = 5e-2
JAX_TIMEOUT = SPAWN_TIMEOUT = 300

# layout -> (batch axes, seq axes, tp axes, moe lowering), as the planners
# build them (``sharding.plan``: ``seq_tp`` and ``ctx_tp`` at no pod axis,
# ``tp_all`` at B = 1)
LAYOUTS = {
    "dp_tp": (("data",), (), ("model",), "dense"),
    "seq_tp": ((), ("data",), ("model",), "dense"),
    "ctx_tp": ((), ("data",), ("model",), "dense"),
    "ctx_tp_ep": ((), ("data",), ("model",), "ep_a2a"),
    "ctx_tp_ep_q8": ((), ("data",), ("model",), "ep_a2a_q8"),
    "tp_all": ((), (), ("data", "model"), "dense"),
}


def tag(aid, b, mesh, prefill, decode, over=None) -> str:
    extra = "".join(f"_{k}{v}" for k, v in sorted((over or {}).items()))
    return f"{aid}{extra}_{b}_{prefill}_{decode}_{mesh[0]}x{mesh[1]}"


def cfg_of(aid: str, over: dict | None = None):
    from repro_torch.configs import get_config
    cfg = get_config(aid).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    return dataclasses.replace(cfg, **(over or {}))


def plan_of(aid: str, layout: str, mesh):
    from repro_torch.sharding import MeshDesc, ShardingPlan
    b, s, t, impl = LAYOUTS[layout]
    return ShardingPlan(arch=aid, shape="t",
                        mesh=MeshDesc(("data", "model"), tuple(mesh)),
                        global_mode="data", local_layout=layout,
                        batch_axes=b, seq_axes=s, tp_axes=t, moe_impl=impl)


_JAX = """
    import dataclasses, json, os
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.configs import get_config
    from repro.models import build_model
    from repro.sharding import ctx as shard_ctx, specs
    from repro.sharding.plan import MeshDesc, ShardingPlan
    CASES, (T, S, STEPS), LENS, LAYOUTS = json.loads(os.environ["CASES"])
    out, inputs, bf16 = {}, {}, []

    def cfg_of(aid, over):
        cfg = get_config(aid).reduced()
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0))
        return dataclasses.replace(cfg, **over)

    def flat(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, f"{prefix}{k}/")
            else:
                if v.dtype == jnp.bfloat16:
                    bf16.append(prefix + k)
                inputs[prefix + k] = np.asarray(v.astype(jnp.float32))

    def ax(axes):
        return None if not axes else axes[0] if len(axes) == 1 else tuple(
            axes)

    models = {}
    for tg, aid, b, shp, pf_l, dec_l, over, key in CASES:
        if key in models:
            continue
        cfg = cfg_of(aid, over)
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0), dtype=jnp.bfloat16)
        rng = np.random.default_rng(1)
        batch = {"tokens": rng.integers(0, cfg.vocab, (b, T)).astype(
                     np.int32),
                 "lengths": np.asarray(LENS[:b], np.int32)}
        steps = rng.integers(0, cfg.vocab, (STEPS, b, 1)).astype(np.int32)
        if cfg.family == "audio":
            batch["frames"] = (rng.standard_normal((b, T, cfg.d_model))
                               * 0.1).astype(np.float32)
        if cfg.family == "vlm":
            # random vision and open gates: closed ones make the cross
            # branch exactly 0 (tests/test_torch_vlm.py)
            batch["vision"] = (rng.standard_normal(
                (b, cfg.n_vision_tokens, cfg.d_model)) * 0.1).astype(
                np.float32)
            params["cross"] = {**params["cross"], **{
                g: jnp.full_like(params["cross"][g], 0.5)
                for g in ("gate_attn", "gate_mlp")}}
        flat(params, f"p/{key}/")
        for k, v in batch.items():
            inputs[f"in/{key}/{k}"] = v
        inputs[f"in/{key}/steps"] = steps
        models[key] = (cfg, model, params, batch, steps)
    np.savez(os.environ["PARAMS"], bf16=np.asarray(bf16), **inputs)
    os.rename(os.environ["PARAMS"], os.environ["PARAMS"] + ".ready.npz")

    def plan_of(layout, shp):
        b, s, t, impl = LAYOUTS[layout]
        return ShardingPlan(
            arch="t", shape="t", mesh=MeshDesc(("data", "model"), tuple(shp)),
            global_mode="data", local_layout=layout, moe_impl=impl,
            batch_axes=tuple(b), seq_axes=tuple(s), tp_axes=tuple(t))

    for tg, aid, b, shp, pf_l, dec_l, over, key in CASES:
        cfg, model, params, batch, steps = models[key]
        batch = {k: jnp.asarray(v).astype(jnp.bfloat16)
                 if k in ("frames", "vision") else jnp.asarray(v)
                 for k, v in batch.items()}
        enc = T if cfg.family == "audio" else None
        mesh = Mesh(np.array(jax.devices()[:shp[0] * shp[1]]).reshape(
            shp), ("data", "model"))
        pplan, dplan = plan_of(pf_l, shp), plan_of(dec_l, shp)
        step_b = {"tokens": steps[0], "lengths": batch["lengths"]}
        ps = jax.device_put(params, specs.param_shardings(mesh, params,
                                                          pplan))
        for plan, kind in ((pplan, "prefill"), (dplan, "decode")):
            # at decode the sequence entry names a T of 1: the reference's
            # constraint skips it, but its expert step would take it as
            # its shard_map's in_spec, so it is dropped (as the port's
            # ``spmd.act_specs`` drops it)
            act = P(ax(plan.batch_axes),
                    ax(plan.seq_axes) if kind == "prefill" else None, None)
            logits = P(ax(plan.batch_axes), None, ax(plan.tp_axes))
            lsh = specs.logits_sharding(mesh, plan, (b, 1, cfg.vocab))
            p_sh = specs.param_shardings(mesh, params, plan)
            impl = plan.moe_impl
            with mesh, shard_ctx.plan_specs(act, logits, mesh=mesh,
                                            ep_axis="model"):
                if kind == "prefill":
                    c_sh = specs.cache_shardings(mesh, model.init_cache(
                        b, T, abstract=True, enc_len=enc), plan)
                    pf = jax.jit(lambda p, bt: model.apply_prefill(
                        p, bt, moe_impl=impl), in_shardings=(
                        p_sh, specs.batch_shardings(mesh, batch, plan)),
                        out_shardings=(lsh, c_sh))
                    lg, cache = pf(ps, batch)
                    out[f"{tg}/logits0"] = np.asarray(lg)
                    for k, v in cache.items():
                        out[f"{tg}/prefill_{k}"] = np.asarray(
                            v.astype(jnp.float32))
                        if k in ("k", "v"):
                            pad = [(0, 0)] * v.ndim
                            pad[-3] = (0, S - T)
                            cache[k] = jnp.pad(v, pad)
                    continue
                dc_sh = specs.cache_shardings(mesh, model.init_cache(
                    b, S, abstract=True, enc_len=enc), plan)
                dec = jax.jit(lambda p, c, bt: model.apply_decode(
                    p, c, bt, moe_impl=impl), in_shardings=(
                    p_sh, dc_sh, specs.batch_shardings(mesh, step_b, plan)),
                    out_shardings=(lsh, dc_sh), donate_argnums=(1,))
                ps = jax.device_put(params, p_sh)
                cache = jax.device_put(cache, dc_sh)
                lens = batch["lengths"]
                for i in range(STEPS):
                    lens = lens + 1
                    lg, cache = dec(ps, cache, {
                        "tokens": jnp.asarray(steps[i]), "lengths": lens})
                    out[f"{tg}/logits{i + 1}"] = np.asarray(lg)
                for k, v in cache.items():
                    out[f"{tg}/cache_{k}"] = np.asarray(v.astype(jnp.float32))
    np.savez(os.environ["OUT"], **out)
"""


def _key(aid, b, over) -> str:
    return f"{aid}_{b}" + "".join(f"_{k}{v}"
                                  for k, v in sorted((over or {}).items()))


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


def _split_axes(x, names) -> tuple:
    """The mesh axes a DTensor is split over."""
    return tuple(a for a, pl in zip(names, x.placements) if pl.is_shard())


def serve_worker(rank: int, payload: dict) -> dict:
    """Every case on this rank: the unsharded steps, then the sharded ones;
    rank 0 returns the logits, caches, layouts, the leaves the layers saw
    and the collectives issued.  ``payload["extra"]``: functions of
    ``(rank, meshes)`` run after the cases, their results returned under
    their names."""
    import logging
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import specs, spmd
    from torch.distributed.tensor import DTensor
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    cases = payload["cases"]
    meshes = {m: make_smoke_mesh(m, ("data", "model"), device_type="cpu")
              for m in sorted({tuple(c[2]) for c in cases}
                              | set(payload.get("meshes", ())))}
    seen: list = []
    serving_params, leaf = spmd.serving_params, spmd._Gather.leaf

    def record(path, x, out):
        if isinstance(x, DTensor):
            names = list(x.device_mesh.mesh_dim_names)
            if _split_axes(x, names):
                seen.append((path, _split_axes(x, names), tuple(x.shape),
                             tuple(out.shape)))

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
    for aid, b, shp, pf_l, dec_l, over in cases:
        cfg = cfg_of(aid, over)
        model = build_model(cfg)
        key = _key(aid, b, over)
        params = payload["params"][key]
        inp = payload["inputs"][key]
        batch = {k: v for k, v in inp.items() if k != "steps"}
        steps = inp["steps"]
        mesh = meshes[tuple(shp)]
        pplan, dplan = plan_of(aid, pf_l, shp), plan_of(aid, dec_l, shp)
        with torch.no_grad():
            logits, cache = model.apply_prefill(params, batch,
                                                moe_impl=pplan.moe_impl)
            want = {"logits0": logits, **{f"prefill_{k}": v
                                          for k, v in cache.items()}}
            cache, lens = _pad(cache), batch["lengths"]
            for i in range(STEPS):
                lens = lens + 1
                logits, cache = model.apply_decode(
                    params, cache, {"tokens": steps[i], "lengths": lens},
                    moe_impl=dplan.moe_impl)
                want[f"logits{i + 1}"] = logits
            want.update({f"cache_{k}": v for k, v in cache.items()})
        prefill = spmd.make_sharded_prefill(model, pplan, mesh)
        decode = spmd.make_sharded_decode(model, dplan, mesh)
        rec = dryrun._recording_mode()
        seen.clear()
        got = {}
        with rec:
            logits, cache = prefill(specs.param_shardings(mesh, params,
                                                          pplan), batch)
        got["logits0"] = logits.full_tensor()
        whole = {k: v.full_tensor() for k, v in cache.items()}
        got.update({f"prefill_{k}": v for k, v in whole.items()})
        got["prefill_layout"] = {k: tuple(map(str, v.placements))
                                 for k, v in cache.items()}
        sp = specs.param_shardings(mesh, params, dplan)
        dc = specs.cache_shardings(mesh, _pad(whole), dplan)
        got["layout"] = {k: tuple(map(str, v.placements))
                         for k, v in dc.items()}
        lens = batch["lengths"]
        for i in range(STEPS):
            lens = lens + 1
            with rec:
                logits, dc = decode(sp, dc, {"tokens": steps[i],
                                             "lengths": lens})
            got[f"logits{i + 1}"] = logits.full_tensor()
        got.update({f"cache_{k}": v.full_tensor() for k, v in dc.items()})
        got["seen"] = list(seen)
        got["collectives"] = rec.records
        res[tag(aid, b, shp, pf_l, dec_l, over)] = {"got": got,
                                                     "want": want}
    for name, fn in payload.get("extra", {}).items():
        res[name] = fn(rank, meshes)
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


def run_cases(cases: list, extra: dict | None = None,
              meshes: tuple = ()) -> tuple[dict, dict]:
    """The reference's sharded runs of ``cases`` (a subprocess with 8 host
    devices, which first saves the weights and inputs) and the ranks' (one
    spawn of 4 for all, started as soon as the weights are saved):
    (reference arrays by ``tag``/name, results by ``tag``).  ``extra``
    and ``meshes``: ``serve_worker``'s."""
    import ml_dtypes
    from repro_torch.models.convert import from_jax
    jcases = [[tag(*c), c[0], c[1], list(c[2]), c[3], c[4], c[5] or {},
               _key(c[0], c[1], c[5])] for c in cases]
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        env["PYTHONPATH"] = str(ROOT / "src")
        env.update(OUT=f"{d}/out.npz", PARAMS=f"{d}/params.npz",
                   CASES=json.dumps([jcases, (T, S, STEPS), LENS, LAYOUTS]))
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
            params = {key: from_jax(p, device="cpu")
                      for key, p in tree["p"].items()}
            inputs = {key: {k: (torch.from_numpy(v).bfloat16()
                                if k in ("frames", "vision")
                                else torch.from_numpy(v))
                            for k, v in case.items()}
                      for key, case in tree["in"].items()}
            got = spawn(serve_worker, 4, {"cases": cases, "params": params,
                                          "inputs": inputs,
                                          "extra": extra or {},
                                          "meshes": meshes},
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


def check(runs, case) -> None:
    """The logits of every step, the prompt's and the final caches, against
    the reference's sharded jit and the port's unsharded steps."""
    ref, got = runs
    tg = tag(*case)
    g, w = got[tg]["got"], got[tg]["want"]
    for i in range(STEPS + 1):
        key = f"logits{i}"
        _close(g[key], ref[f"{tg}/{key}"], f"{tg} {key} vs reference")
        _close(g[key], w[key], f"{tg} {key} vs unsharded")
        _greedy_equal(g[key], ref[f"{tg}/{key}"], f"{tg} {key}")
    for k in [k for k in g if k.startswith(("prefill_", "cache_"))
              and not k.endswith("layout")]:
        _close_cache(g[k], ref[f"{tg}/{k}"], f"{tg} {k} vs reference")
        _close_cache(g[k], w[k], f"{tg} {k} vs unsharded")


def check_split(runs, case) -> None:
    """Every leaf split over a tp axis reached the layers as its shard;
    the steps all-reduced."""
    g = runs[1][tag(*case)]["got"]
    assert g["seen"], "no split leaf reached a layer"
    for path, axes, whole, local in g["seen"]:
        assert local != whole, (path, axes, whole, local)
    kinds = {name.split("::")[-1] for name, _ in g["collectives"]}
    assert "all_reduce" in kinds, kinds
