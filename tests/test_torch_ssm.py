"""The port's SSM (mamba2-780m) and hybrid (hymba-1.5b) families against the
JAX package on reduced configs: the same weights (converted with
``from_jax``) and tokens give the same logits and caches, the engine emits
the JAX engine's greedy tokens, and the serve CLI runs them.

Tolerances and the relative-norm rule for deep cache layers are those of
tests/test_torch_model.py (5e-2, from
test_arch_smoke.py::test_prefill_then_decode_matches_full_forward).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from test_torch_model import _close, _close_cache  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("mamba2-780m", "hymba-1.5b")
B, S = 2, 32


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    """(port cfg, port model, port params, jax model, jax params)."""
    aid = request.param
    jmodel = jbuild_model(jget_config(aid).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    cfg = get_config(aid).reduced()
    return cfg, build_model(cfg), params, jmodel, jparams


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


def _fill(cache, pcache, p):
    """Write a prefill cache into a full decode cache: k/v into the first p
    positions, the SSM state and conv context whole."""
    for k, v in pcache.items():
        if k in ("k", "v"):
            cache[k][:, :, :p] = v
        else:
            cache[k].copy_(v)
    return cache


def test_train_logits_match_jax(pair):
    cfg, model, params, jmodel, jparams = pair
    toks = _tokens(cfg)
    want = jmodel.apply_train(jparams, {"tokens": jnp.asarray(toks)},
                              remat=False)
    got = model.apply_train(params, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
    _close(got, want)


def test_prefill_logits_and_cache_match_jax(pair):
    """Prefill logits and every cache entry: the SSM state h
    (L, B, nh, hd, n) in fp32 and the conv context (L, B, cw-1, C) in bf16,
    and k/v for hymba.  S = 32 is four reduced chunks of 8."""
    cfg, model, params, jmodel, jparams = pair
    toks = _tokens(cfg, 1)
    lens = np.asarray([S, S - 7], np.int32)
    want, jcache = jmodel.apply_prefill(
        jparams, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)})
    got, cache = model.apply_prefill(
        params, {"tokens": torch.from_numpy(toks),
                 "lengths": torch.from_numpy(lens)})
    assert got.shape == (B, 1, cfg.vocab)
    _close(got, want)
    assert set(cache) == set(jcache)
    assert cache["h"].dtype == torch.float32
    assert cache["conv"].dtype == torch.bfloat16
    for k in cache:
        _close_cache(cache[k], jcache[k])


def test_decode_logits_and_cache_match_jax(pair):
    """One decode step from the same (JAX-built) cache: logits, and the
    in-place write — h and conv replaced whole, k/v at lengths-1 only —
    agree with JAX's functional update."""
    cfg, model, params, jmodel, jparams = pair
    toks = _tokens(cfg, 2)
    p = S - 1
    _, jpre = jmodel.apply_prefill(
        jparams, {"tokens": jnp.asarray(toks[:, :p]),
                  "lengths": jnp.full((B,), p, jnp.int32)})
    jcache = {k: (v.at[..., :p, :, :].set(jpre[k]) if k in ("k", "v")
                  else jpre[k].astype(v.dtype))
              for k, v in jmodel.init_cache(B, S).items()}
    cache = from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    views = {k: v.data_ptr() for k, v in cache.items()}
    before = {k: v.clone() for k, v in cache.items()}
    lens = np.full((B,), p + 1, np.int32)
    want, jnew = jmodel.apply_decode(
        jparams, jcache, {"tokens": jnp.asarray(toks[:, p:]),
                          "lengths": jnp.asarray(lens)})
    got, new = model.apply_decode(
        params, cache, {"tokens": torch.from_numpy(toks[:, p:]),
                        "lengths": torch.from_numpy(lens)})
    assert new is cache and {k: v.data_ptr() for k, v in new.items()} == views
    _close(got, want)
    for k in ("h", "conv"):
        _close_cache(new[k], jnew[k])
        assert not torch.equal(new[k], before[k])
    for k in set(new) & {"k", "v"}:
        _close_cache(new[k][:, :, p], jnew[k][:, :, p])   # the new token
        new[k][:, :, p] = before[k][:, :, p]
        assert torch.equal(new[k], before[k])              # nothing else


def test_prefill_then_decode_matches_full_forward(pair):
    """Exactness of the serving path on the port alone: prefill P = 31
    tokens (three chunks of 8 and a padded one), decode one, and match the
    full-sequence forward at that position."""
    cfg, model, params, _, _ = pair
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


def _flat(tree, path=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + f"[{k!r}]"))
        else:
            out[path + f"[{k!r}]"] = v
    return out


@pytest.mark.parametrize("aid", FAMILIES)
def test_init_matches_the_jax_param_specs(aid):
    """Seeded init on the CPU: the JAX tree's stacked shapes and dtypes —
    norms fp32, everything else, the SSM mixer's A_log/D/dt_bias/norm
    included, in the parameter dtype — and ssm_params' values."""
    cfg = get_config(aid).reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu", dtype=torch.bfloat16)
    jspecs = jbuild_model(jget_config(aid).reduced()).param_specs(
        jnp.bfloat16)
    want = {jax.tree_util.keystr(p): (tuple(s.shape), s.dtype.name)
            for p, s in jax.tree_util.tree_leaves_with_path(jspecs)}
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in _flat(params).items()}
    assert got == want
    ssm = params["layers"]["ssm"]
    s, nl = cfg.ssm, cfg.n_layers
    nh = s.n_heads(cfg.d_model)
    a_log = torch.log(torch.linspace(1.0, 16.0, nh)).bfloat16()
    assert torch.equal(ssm["A_log"], a_log.expand(nl, -1))
    assert (ssm["D"] == 1).all() and not ssm["dt_bias"].any()
    assert not ssm["norm"].any()
    assert abs(ssm["conv"].float().std().item() - s.conv_width ** -0.5) < 0.05
    assert abs(ssm["w_in"].float().std().item() - cfg.d_model ** -0.5) < 0.02


def _reference_greedy(model, params, prompt, n_new):
    """Full-forward greedy decoding (no cache) — the exactness oracle."""
    toks = list(map(int, prompt))
    for _ in range(n_new):
        logits = model.apply_train(
            params, {"tokens": torch.tensor([toks], dtype=torch.int32)})
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


@pytest.mark.parametrize("aid", FAMILIES)
def test_engine_ssm_family(aid):
    """test_serving.py::test_engine_ssm_family on the port: the recurrent
    state rides the same engine path and decodes what the full forward
    decodes."""
    cfg = get_config(aid).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(5), device="cpu")
    prompt = np.asarray([3, 1, 4], np.int32)
    want = _reference_greedy(model, params, prompt, 5)
    eng = ServingEngine(model, params, max_batch=2, max_len=24, device="cpu")
    rid = eng.submit(prompt, max_new_tokens=5)
    done = eng.run_until_done()
    assert done[rid].generated[:5] == want
    assert ssd_scan.launches == 0              # CPU tensors never launch


def test_engine_emits_the_jax_engines_greedy_tokens(pair):
    """The port's engine and the JAX engine, on the same weights and prompts,
    emit the same greedy tokens.  Three prompts over two slots: a short chunk
    (3, 5 tokens), a padded second chunk (11 tokens) and a slot reused after
    a request ends.  Where the tokens first part, the JAX logits at that
    step must have a top-1/top-2 margin under 5e-2 (the near-tie rule of
    test_torch_serving.py) and the comparison stops there."""
    cfg, model, params, jmodel, jparams = pair
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


@pytest.mark.parametrize("aid", FAMILIES)
def test_serve_cli_runs_on_cpu(aid):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", aid,
         "--device", "cpu", "--requests", "4"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"arch={aid}: served 4/4 requests" in out.stdout
