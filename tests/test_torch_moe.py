"""The port's MoE family (qwen3-moe-30b-a3b, mixtral-8x7b) against the JAX
package on reduced configs (2 layers, d 64, 4 experts, top-2, d_ff_expert
64): the router, the dense oracle, the expert-parallel step at an EP axis of
width 1 (the JAX ``moe_ep_a2a`` under a 1 x 1 mesh), the whole model's logits
and caches, init, the engine's greedy tokens and the serve CLI.

Inputs are drawn with numpy and handed to both packages; the weights are the
JAX model's, converted with ``from_jax``.  Tolerances: the router's weights
at 1e-6 (fp32 softmax), the MoE layers at the bf16 TOL of test_kernels.py
(2e-2), the port's grouped step against its dense oracle at
test_distributed.py's 5e-2, the model's logits and caches as
test_torch_model.py holds them.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe_ep as jmoe_ep  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro.sharding import ctx as shard_ctx  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe_ep  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from test_torch_model import TOL, _close, _close_cache  # noqa: E402
from test_torch_ssm import _flat, _fill  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x7b")
B, S = 2, 32
BF16_TOL = 2e-2          # tests/test_kernels.py::TOL for bf16
DENSE_TOL = 5e-2         # tests/test_distributed.py's moe_ep against dense


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(port cfg, port model, port params, jax cfg, jax model, jax
    params)."""
    aid = request.param
    jcfg = jget_config(aid).reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    cfg = get_config(aid).reduced()
    return cfg, build_model(cfg), params, jcfg, jmodel, jparams


def _layer0(pair):
    """Layer 0's MoE parameters in both packages."""
    _, _, params, _, _, jparams = pair
    return ({k: v[0] for k, v in params["layers"]["moe"].items()},
            jax.tree.map(lambda v: v[0], jparams["layers"]["moe"]))


def _x(shape, seed=0):
    """The same bf16 activations for both packages."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).bfloat16(), jnp.asarray(a).astype(jnp.bfloat16)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _jax_ep(jcfg, jp, jx, capacity_factor=None):
    """The JAX ``moe_ep_a2a`` under a 1 x 1 (data, model) mesh: its EP axis
    has width 1, so its all-to-alls are identities."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with mesh, shard_ctx.plan_specs(P("data", None, None), None, mesh=mesh,
                                    ep_axis="model"):
        return jax.jit(lambda p, x: jmoe_ep.moe_ep_a2a(
            jcfg, p, x, capacity_factor=capacity_factor))(jp, jx)


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


# A token whose k-th and (k+1)-th router probabilities lie closer than this,
# in some layer, may be routed to other experts by the two packages: their
# bf16 activations differ by an ulp here and there (XLA fuses and rounds
# once where PyTorch rounds after each op), which moves a router logit by
# about 1e-3.  Top-k is not continuous there, so that token's output, and
# its logits, may part by more than TOL.
NEAR_TIE = 1e-2


def _routed(monkeypatch, fn):
    """``fn()`` and, per token of the port's forward, the smallest gap over
    the layers between its k-th and (k+1)-th router probability (B*T,)."""
    gaps = []
    real = L.moe_router

    def spy(spec, router_w, x2d):
        probs = torch.softmax(x2d.float() @ router_w.float(), -1)
        top = probs.sort(-1, descending=True).values
        gaps.append(top[:, spec.top_k - 1] - top[:, spec.top_k])
        return real(spec, router_w, x2d)

    monkeypatch.setattr(L, "moe_router", spy)
    try:
        out = fn()
    finally:
        monkeypatch.undo()
    return out, torch.stack(gaps).min(0).values


def _close_routed(got, want, gaps):
    """``_close`` at every position whose routing has no near tie; a
    position that parts by more than TOL must be a near tie, and there are
    at most two.  ``got`` (B, T, V) against ``gaps`` (B*T',) with T <= T':
    position t of a row is token T' - T + t of it."""
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    b, t = g.shape[:2]
    tie = (gaps.reshape(b, -1)[:, -t:] < NEAR_TIE).numpy()
    off = (np.abs(g - w) > TOL + TOL * np.abs(w)).any(-1)
    assert not (off & ~tie).any(), np.argwhere(off & ~tie)
    assert off.sum() <= 2, np.argwhere(off)
    _close(torch.from_numpy(g[~off]), w[~off])


# --------------------------------------------------------------------------
# the MoE layer
# --------------------------------------------------------------------------

def test_router_matches_jax(pair):
    """The same experts per token (as sets: the order of tied values is not
    guaranteed) with the same weights at 1e-6; fp32 weights summing to 1,
    int32 indices."""
    cfg, _, _, jcfg, _, _ = pair
    p, jp = _layer0(pair)
    a = np.random.default_rng(1).standard_normal((37, cfg.d_model)).astype(
        np.float32)
    vals, idx = L.moe_router(cfg.moe, p["router"], torch.from_numpy(a))
    jvals, jidx = JL.moe_router(jcfg.moe, jp["router"], jnp.asarray(a))
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    assert idx.shape == (37, cfg.moe.top_k)
    for t in range(37):
        got = dict(zip(idx[t].tolist(), vals[t].tolist()))
        want = dict(zip(np.asarray(jidx[t]).tolist(),
                        np.asarray(jvals[t]).tolist()))
        assert set(got) == set(want), t
        for e in got:
            assert abs(got[e] - want[e]) <= 1e-6, (t, e)
    np.testing.assert_allclose(vals.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 1), (2, 31)], ids=["decode", "prefill"])
def test_moe_dense_matches_jax(pair, shape):
    cfg, _, _, jcfg, _, _ = pair
    p, jp = _layer0(pair)
    x, jx = _x((*shape, cfg.d_model), 2)
    got = L.moe_dense(cfg, p, x)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(JL.moe_dense(jcfg, jp, jx)),
                               atol=BF16_TOL, rtol=BF16_TOL)


def _empty_expert(p, jp, e):
    """Router weights under which expert ``e`` wins no token of a positive
    input: its logit is -100 times the input's sum, far below every other
    expert's."""
    r = p["router"].clone()
    r[:, e] = -100.0
    return ({**p, "router": r},
            {**jp, "router": jnp.asarray(r.float().numpy()).astype(
                jp["router"].dtype)})


EP_CASES = {"decode": ((4, 1), None, False),
            "prefill": ((2, 31), None, False),
            "empty_expert": ((2, 31), None, True),
            "capacity_0.5": ((2, 31), 0.5, False)}


@pytest.mark.parametrize("case", list(EP_CASES))
def test_moe_ep_matches_jax_and_the_dense_oracle(pair, case):
    """The port's grouped step against the JAX ``moe_ep_a2a`` at an EP axis
    of width 1 (bf16 TOL) and against the port's ``moe_dense`` (5e-2).  An
    expert that gets no token leaves an empty group.  With capacity factor
    0.5 both packages keep the same first 64 of the 124 assignments, so the
    tokens past the 32nd get nothing (and the dense oracle no longer
    applies)."""
    cfg, _, _, jcfg, _, _ = pair
    p, jp = _layer0(pair)
    shape, cf, empty = EP_CASES[case]
    x, jx = _x((*shape, cfg.d_model), 3)
    if empty:
        x, jx = x.abs(), jnp.abs(jx)
        p, jp = _empty_expert(p, jp, cfg.moe.num_experts - 1)
        _, idx = L.moe_router(cfg.moe, p["router"],
                              x.reshape(-1, cfg.d_model))
        assert not (idx == cfg.moe.num_experts - 1).any()
    got = moe_ep.moe_ep_a2a(cfg, p, x, capacity_factor=cf)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(_jax_ep(jcfg, jp, jx, cf)),
                               atol=BF16_TOL, rtol=BF16_TOL)
    if cf is None:
        np.testing.assert_allclose(_np(got), _np(L.moe_dense(cfg, p, x)),
                                   atol=DENSE_TOL, rtol=DENSE_TOL)
    else:
        t, k = shape[0] * shape[1], cfg.moe.top_k
        kept = moe_ep.capacity(t, k, cf)
        assert kept == 64 < t * k
        flat = got.reshape(t, -1)
        assert not flat[kept // k:].any() and flat[:kept // k].any()


def test_moe_apply_dispatch(pair, monkeypatch):
    """"dense" is the oracle, "ep_a2a" the grouped step and "ep_a2a_q8" the
    grouped step with its all-to-alls' payload in int8, in this process
    when no mesh is published and across the EP axis's ranks
    (``moe_ep._ep_step``, tests/test_torch_distributed.py) when one is;
    unknown lowerings are refused."""
    cfg, _, _, _, _, _ = pair
    p, _ = _layer0(pair)
    x, _ = _x((2, 5, cfg.d_model), 4)
    assert torch.equal(L.moe_apply(cfg, p, x), L.moe_dense(cfg, p, x))
    assert torch.equal(L.moe_apply(cfg, p, x, impl="ep_a2a"),
                       moe_ep.moe_ep_a2a(cfg, p, x))
    assert torch.equal(L.moe_apply(cfg, p, x, impl="ep_a2a_q8"),
                       moe_ep.moe_ep_a2a(cfg, p, x, a2a_dtype="int8"))
    with pytest.raises(ValueError, match="moe impl"):
        L.moe_apply(cfg, p, x, impl="sparse")
    from repro_torch.sharding import ctx as port_ctx
    calls = []
    monkeypatch.setattr(moe_ep, "_ep_step", lambda cfg_, p_, x_, mesh, ep,
                        cf, a2a: calls.append((mesh, ep, cf, a2a)) or x_)
    mesh = object()
    with port_ctx.plan_specs(None, None, mesh=mesh, ep_axis="model"):
        for impl in ("ep_a2a", "ep_a2a_q8"):
            assert L.moe_apply(cfg, p, x, impl=impl) is x
    cf = cfg.moe.capacity_factor
    assert calls == [(mesh, "model", cf, "bfloat16"),
                     (mesh, "model", cf, "int8")]


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def test_train_logits_match_jax(pair, monkeypatch):
    """Logits over the whole sequence, position by position, with the
    routing near-tie rule (``_close_routed``)."""
    cfg, model, params, _, jmodel, jparams = pair
    toks = _tokens(cfg)
    want = jmodel.apply_train(jparams, {"tokens": jnp.asarray(toks)},
                              remat=False)
    got, gaps = _routed(monkeypatch, lambda: model.apply_train(
        params, {"tokens": torch.from_numpy(toks)}))
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
    _close_routed(got, want, gaps)


def test_prefill_logits_and_cache_match_jax(pair, monkeypatch):
    """The JAX model's dense MoE against the port's, ``moe_impl="dense"``
    (the inference steps' default is "routed")."""
    cfg, model, params, _, jmodel, jparams = pair
    toks = _tokens(cfg, 1)
    lens = np.asarray([S, S - 7], np.int32)
    want, jcache = jmodel.apply_prefill(
        jparams, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)})
    (got, cache), gaps = _routed(monkeypatch, lambda: model.apply_prefill(
        params, {"tokens": torch.from_numpy(toks),
                 "lengths": torch.from_numpy(lens)}, moe_impl="dense"))
    assert got.shape == (B, 1, cfg.vocab)
    _close_routed(got, want, gaps)
    assert set(cache) == set(jcache) == {"k", "v"}
    for k in cache:
        _close_cache(cache[k], jcache[k])


def test_decode_logits_and_cache_match_jax(pair, monkeypatch):
    """One decode step from the same (JAX-built) cache: logits (with the
    routing near-tie rule), and k/v written in place at lengths-1 only;
    the port's MoE layers ``moe_impl="dense"``, as the JAX model's."""
    cfg, model, params, _, jmodel, jparams = pair
    toks = _tokens(cfg, 2)
    p = S - 1
    _, jpre = jmodel.apply_prefill(
        jparams, {"tokens": jnp.asarray(toks[:, :p]),
                  "lengths": jnp.full((B,), p, jnp.int32)})
    jcache = {k: v.at[..., :p, :, :].set(jpre[k])
              for k, v in jmodel.init_cache(B, S).items()}
    cache = from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    before = {k: v.clone() for k, v in cache.items()}
    lens = np.full((B,), p + 1, np.int32)
    want, jnew = jmodel.apply_decode(
        jparams, jcache, {"tokens": jnp.asarray(toks[:, p:]),
                          "lengths": jnp.asarray(lens)})
    (got, new), gaps = _routed(monkeypatch, lambda: model.apply_decode(
        params, cache, {"tokens": torch.from_numpy(toks[:, p:]),
                        "lengths": torch.from_numpy(lens)},
        moe_impl="dense"))
    assert new is cache
    _close_routed(got, want, gaps)
    for k in ("k", "v"):
        _close_cache(new[k][:, :, p], jnew[k][:, :, p])   # the new token
        new[k][:, :, p] = before[k][:, :, p]
        assert torch.equal(new[k], before[k])              # nothing else


def test_prefill_then_decode_matches_full_forward(pair):
    cfg, model, params, _, _, _ = pair
    toks = torch.from_numpy(_tokens(cfg, 3))
    p = S - 1
    _, pcache = model.apply_prefill(
        params, {"tokens": toks[:, :p],
                 "lengths": torch.full((B,), p, dtype=torch.int32)})
    cache = _fill(model.init_cache(B, S, device="cpu"), pcache, p)
    got, _ = model.apply_decode(
        params, cache, {"tokens": toks[:, p:],
                        "lengths": torch.full((B,), p + 1,
                                              dtype=torch.int32)})
    want = model.apply_train(params, {"tokens": toks})[:, p]
    _close(got[:, 0], want.numpy())


@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
def test_ep_a2a_logits_match_dense(pair, step):
    """The whole model through ``moe_impl="ep_a2a"`` against "dense", at
    each step kind (the engine serves "routed", the same grouped step with
    every assignment kept: tests/test_torch_moe_routed_serving.py)."""
    cfg, model, params, _, _, _ = pair
    toks = torch.from_numpy(_tokens(cfg, 4))
    lens = torch.full((B,), S, dtype=torch.int32)
    if step == "train":
        out = [model.apply_train(params, {"tokens": toks}, moe_impl=m)
               for m in ("ep_a2a", "dense")]
    elif step == "prefill":
        out = [model.apply_prefill(params, {"tokens": toks, "lengths": lens},
                                   moe_impl=m)[0]
               for m in ("ep_a2a", "dense")]
    else:
        _, pcache = model.apply_prefill(
            params, {"tokens": toks[:, :-1], "lengths": lens - 1})
        out = [model.apply_decode(
            params, _fill(model.init_cache(B, S, device="cpu"), pcache,
                          S - 1),
            {"tokens": toks[:, -1:], "lengths": lens}, moe_impl=m)[0]
            for m in ("ep_a2a", "dense")]
    _close(out[0], out[1].numpy())


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

@pytest.mark.parametrize("aid", ARCHS)
def test_init_matches_the_jax_param_specs(aid):
    """Seeded init on the CPU: the JAX tree's stacked shapes and dtypes
    (matmul weights in the asked dtype, norms fp32), and N(0, 1/fan_in) with
    the fan-in each stack's second-last axis: d for router, w_gate and
    w_up, d_ff_expert for w_down.  d_ff_expert is 128 here, so that the two
    fan-ins differ (the reduced config has both at 64)."""
    def widen(c):
        return dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, d_ff_expert=128))
    cfg = widen(get_config(aid).reduced())
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu", dtype=torch.bfloat16)
    jspecs = jbuild_model(widen(jget_config(aid).reduced())).param_specs(
        jnp.bfloat16)
    want = {jax.tree_util.keystr(p): (tuple(s.shape), s.dtype.name)
            for p, s in jax.tree_util.tree_leaves_with_path(jspecs)}
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in _flat(params).items()}
    assert got == want
    assert params["layers"]["ln2"]["w"].dtype == torch.float32
    moe = params["layers"]["moe"]
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    for name, fan_in in (("router", d), ("w_gate", d), ("w_up", d),
                         ("w_down", f)):
        # within three standard errors of a std over n draws, 1/sqrt(2n)
        std, n = moe[name].float().std().item(), moe[name].numel()
        assert abs(std * fan_in ** 0.5 - 1) < 3 / (2 * n) ** 0.5, name
        # every layer drawn, none repeated
        assert not torch.equal(moe[name][0], moe[name][1]), name


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def test_engine_emits_the_jax_engines_greedy_tokens(pair, monkeypatch):
    """The port's engine and the JAX engine, on the same weights and prompts,
    emit the same greedy tokens; where they first part, the JAX logits at
    that step must have a top-1/top-2 margin under 5e-2 (the near-tie rule
    of test_torch_serving.py) and the comparison stops there.  The port's
    inference steps are pinned to "dense" here, the JAX engine's lowering
    (the port's engine serves "routed"), and launch no kernel on CPU
    tensors."""
    cfg, model, params, _, jmodel, jparams = pair
    for name in ("apply_prefill", "apply_decode"):
        monkeypatch.setattr(Model, name, functools.partialmethod(
            getattr(Model, name), moe_impl="dense"))
    prompts = [np.random.default_rng(i).integers(
        0, cfg.vocab, size=n).astype(np.int32)
        for i, n in enumerate((3, 11, 5))]
    n_new = 8
    kw = dict(max_batch=2, max_len=32)
    jeng = JServingEngine(jmodel, jparams, **kw)
    eng = ServingEngine(model, params, device="cpu", **kw)
    jids = [jeng.submit(p, max_new_tokens=n_new) for p in prompts]
    ids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    jdone, done = jeng.run_until_done(), eng.run_until_done()
    compared = 0
    for p, jid, rid in zip(prompts, jids, ids):
        want, got = jdone[jid].generated, done[rid].generated
        assert len(got) == len(want) == n_new
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                toks = jnp.asarray([list(p) + want[:i]], jnp.int32)
                top = jnp.sort(jmodel.apply_train(
                    jparams, {"tokens": toks}, remat=False)[0, -1])[-2:]
                margin = float(top[1] - top[0])
                assert margin < 5e-2, (i, g, w, margin)
                break
            compared += 1
    assert compared >= len(prompts) * n_new // 2
    assert fa.launches == 0 and da.launches == 0


@pytest.mark.parametrize("aid", ARCHS)
def test_serve_cli_runs_on_cpu(aid):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", aid,
         "--device", "cpu", "--requests", "4"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"arch={aid}: served 4/4 requests" in out.stdout


def test_moe_active_params():
    """tests/test_arch_smoke.py::test_moe_active_params on the port's
    configs."""
    qw = get_config("qwen3-moe-30b-a3b")
    assert qw.params_active() < 0.2 * qw.params_total()
    mx = get_config("mixtral-8x7b")
    assert 0.2 < mx.params_active() / mx.params_total() < 0.35
