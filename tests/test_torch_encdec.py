"""The port's encoder-decoder family (whisper-tiny) against the JAX package on
its reduced config (2 encoder and 2 decoder layers, d 64, 4 query heads over
2): cross-attention (``layers.attention(kv_override=...)``), the encoder,
the model's logits and caches, init, the engine's greedy tokens and the
serve CLI.  The helpers here also serve tests/test_torch_vlm.py.

Inputs are drawn with numpy and handed to both packages: tokens, and the
stub frontends' frames or vision embeddings, N(0, 0.1²) as in
test_arch_smoke.py (zeros, as the engines feed them, would make every cross
K/V and so the cross branch exactly 0).  The weights are the JAX model's,
converted with ``from_jax``; the VLM's gates are opened to 0.5 first.
Tolerances are those of test_torch_model.py (5e-2; deep cache layers in
relative norm).
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
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import build_model, encdec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from test_torch_model import TOL, _close, _close_cache  # noqa: E402
from test_torch_ssm import _flat  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
AID = "whisper-tiny"
B, S = 2, 32
# the VLM's tanh gates, opened so that its cross branch carries weight
GATE = 0.5


# --------------------------------------------------------------------------
# helpers shared with tests/test_torch_vlm.py
# --------------------------------------------------------------------------

def make_pair(aid: str):
    """(port cfg, port model, port params, jax model, jax params) on the
    reduced config, the port holding the JAX weights (VLM gates at
    ``GATE``)."""
    jmodel = jbuild_model(jget_config(aid).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    if "cross" in jparams:
        for g in ("gate_attn", "gate_mlp"):
            jparams["cross"][g] = jnp.full_like(jparams["cross"][g], GATE)
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    cfg = get_config(aid).reduced()
    return cfg, build_model(cfg), params, jmodel, jparams


def _stub(cfg, rng, b):
    """The family's stub frontend input: (name, (b, rows, d) fp32 numpy) —
    S // 2 frames or the vision tokens."""
    if cfg.family == "audio":
        return "frames", rng.standard_normal((b, S // 2, cfg.d_model)) * 0.1
    return "vision", rng.standard_normal(
        (b, cfg.n_vision_tokens, cfg.d_model)) * 0.1


def make_batch(cfg, seed: int, b: int = B, t: int = S,
               zeros: bool = False) -> tuple[dict, dict]:
    """The same tokens (b, t) and stub input (bf16, rounded from the same
    fp32 values; all 0 with ``zeros``) for the port and for JAX."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(b, t)).astype(np.int32)
    name, stub = _stub(cfg, rng, b)
    stub = (np.zeros_like(stub) if zeros else stub).astype(np.float32)
    return ({"tokens": torch.from_numpy(toks),
             name: torch.from_numpy(stub).bfloat16()},
            {"tokens": jnp.asarray(toks),
             name: jnp.asarray(stub).astype(jnp.bfloat16)})


def enc_len(cfg):
    return S // 2 if cfg.family == "audio" else None


def check_train_logits(pair):
    cfg, model, params, jmodel, jparams = pair
    tb, jb = make_batch(cfg, 0)
    want = jmodel.apply_train(jparams, jb, remat=False)
    got = model.apply_train(params, tb)
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
    _close(got, want)


def check_prefill(pair):
    """Prefill logits and every cache entry, the self k/v and the cross
    xk/xv, over ragged lengths."""
    cfg, model, params, jmodel, jparams = pair
    tb, jb = make_batch(cfg, 1)
    lens = np.asarray([S, S - 7], np.int32)
    want, jcache = jmodel.apply_prefill(jparams,
                                        {**jb, "lengths": jnp.asarray(lens)})
    got, cache = model.apply_prefill(params,
                                     {**tb, "lengths": torch.from_numpy(lens)})
    assert got.shape == (B, 1, cfg.vocab)
    _close(got, want)
    assert set(cache) == set(jcache) == {"k", "v", "xk", "xv"}
    for k in cache:
        _close_cache(cache[k], jcache[k])


def check_decode(pair):
    """One decode step from the same (JAX-built) cache: logits, and the
    in-place write of the new token's self k/v at lengths-1 — nothing else,
    the cross cache untouched — agree with JAX's functional update."""
    cfg, model, params, jmodel, jparams = pair
    tb, jb = make_batch(cfg, 2)
    p = S - 1
    toks = np.array(jb["tokens"])
    _, jpre = jmodel.apply_prefill(
        jparams, {**jb, "tokens": jb["tokens"][:, :p],
                  "lengths": jnp.full((B,), p, jnp.int32)})
    jcache = {k: (v.at[..., :p, :, :].set(jpre[k]) if k in ("k", "v")
                  else jpre[k])
              for k, v in jmodel.init_cache(B, S,
                                            enc_len=enc_len(cfg)).items()}
    cache = from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    before = {k: v.clone() for k, v in cache.items()}
    lens = np.full((B,), p + 1, np.int32)
    want, jnew = jmodel.apply_decode(
        jparams, jcache, {"tokens": jnp.asarray(toks[:, p:]),
                          "lengths": jnp.asarray(lens)})
    got, new = model.apply_decode(
        params, cache, {"tokens": torch.from_numpy(toks[:, p:]),
                        "lengths": torch.from_numpy(lens)})
    assert new is cache
    _close(got, want)
    for k in ("k", "v"):
        _close_cache(new[k][..., p, :, :], jnew[k][..., p, :, :])
        new[k][..., p, :, :] = before[k][..., p, :, :]
    for k in new:
        assert torch.equal(new[k], before[k]), k        # nothing else


def check_prefill_then_decode(pair):
    """test_arch_smoke.py::test_prefill_then_decode_matches_full_forward on
    the port: prefill P tokens with the stub input, decode one from the
    padded cache, and match the full forward at that position."""
    cfg, model, params, _, _ = pair
    tb, _ = make_batch(cfg, 3)
    p = S - 1
    _, pcache = model.apply_prefill(params, {
        **tb, "tokens": tb["tokens"][:, :p],
        "lengths": torch.full((B,), p, dtype=torch.int32)})
    cache = model.init_cache(B, S, device="cpu", enc_len=enc_len(cfg))
    for k, v in pcache.items():
        cache[k][..., :v.shape[-3], :, :] = v
    got, _ = model.apply_decode(params, cache, {
        "tokens": tb["tokens"][:, p:],
        "lengths": torch.full((B,), p + 1, dtype=torch.int32)})
    want = model.apply_train(params, tb)[:, p]
    _close(got[:, 0], want.numpy())


def check_init(aid):
    """Seeded init on the CPU: the JAX tree's stacked shapes and dtypes
    (norms fp32, the rest, the VLM's gates too, in the parameter dtype),
    N(0, 1/fan_in) projections, closed gates."""
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
    for k, v in _flat(params).items():
        if k.endswith("['wq']"):
            assert abs(v.float().std().item() - cfg.d_model ** -0.5) < 0.02
        if k.endswith(("['gate_attn']", "['gate_mlp']")):
            assert not v.any(), k
    return params


def check_engine_tokens(pair):
    """The port's engine and the JAX engine, on the same weights and prompts,
    emit the same greedy tokens; both feed zero frames or vision at admit.
    Three prompts over two slots (3, 11, 5 tokens; a slot reused after a
    request ends).  Where the tokens first part, the JAX logits at that step
    must have a top-1/top-2 margin under 5e-2 (the near-tie rule of
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
                seq = list(p) + want[:i]
                _, jb = make_batch(cfg, 0, b=1, t=len(seq), zeros=True)
                if cfg.family == "audio":       # as the engine's admit
                    jb["frames"] = jnp.zeros(
                        (1, max(len(p) // 2, 1), cfg.d_model), jnp.bfloat16)
                jb["tokens"] = jnp.asarray([seq], jnp.int32)
                top = jnp.sort(jmodel.apply_train(jparams, jb, remat=False)
                               [0, -1])[-2:]
                margin = float(top[1] - top[0])
                assert margin < 5e-2, (i, g, w, margin)
                break
            compared += 1
    assert compared >= len(prompts) * n_new // 2
    assert fa.launches == 0 and da.launches == 0


def check_cli(aid):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", aid,
         "--device", "cpu", "--requests", "4"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"arch={aid}: served 4/4 requests" in out.stdout


# --------------------------------------------------------------------------
# whisper-tiny
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    return make_pair(AID)


# (mode, Tq, Tk, causal): the decoder's cross query (not roped) over fewer
# and over more encoder rows, a causal override (roped query), and decode
# against a static cross cache over all its rows
CROSS_CASES = [("full", 8, 24, False), ("full", 24, 8, False),
               ("full", 12, 20, True), ("decode", 1, 24, False),
               ("decode", 1, 5, False)]


@pytest.mark.parametrize("case", CROSS_CASES, ids=str)
def test_attention_kv_override_matches_jax(pair, case):
    """``layers.attention(kv_override=(k, v))`` against the JAX package's
    on the same query input, cross K/V and weights (decoder layer 0's
    ``xattn``)."""
    mode, tq, tk, causal = case
    cfg, _, params, jmodel, jparams = pair
    rng = np.random.default_rng(tq * 100 + tk)
    hkv, hd = cfg.n_kv_heads, cfg.hd
    x = rng.standard_normal((B, tq, cfg.d_model)).astype(np.float32)
    k = rng.standard_normal((B, tk, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, tk, hkv, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(tq)[None] + 3, (B, tq)).astype(np.int32)
    p = {n: w[0] for n, w in params["decoder"]["xattn"].items()}
    jp = {n: w[0] for n, w in jparams["decoder"]["xattn"].items()}
    jx, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, k, v))
    want, _ = JL.attention(jmodel.cfg, jp, jx, positions=jnp.asarray(pos),
                           mode=mode, causal=causal, kv_override=(jk, jv))
    tx, tk_, tv = (torch.from_numpy(a).bfloat16() for a in (x, k, v))
    got, cache = L.attention(cfg, p, tx, positions=torch.from_numpy(pos),
                             mode=mode, causal=causal, kv_override=(tk_, tv))
    assert got.shape == (B, tq, cfg.d_model) and got.dtype == torch.bfloat16
    if mode == "decode":
        assert cache is None                 # the static cache is not written
    _close(got, want)


def test_encode_matches_jax(pair):
    cfg, _, params, jmodel, jparams = pair
    tb, jb = make_batch(cfg, 4)
    want = jencdec.encode(jmodel.cfg, jparams, jb["frames"])
    got = encdec.encode(cfg, params, tb["frames"])
    assert got.shape == (B, S // 2, cfg.d_model)
    _close(got, want)


def test_train_logits_match_jax(pair):
    check_train_logits(pair)


def test_prefill_logits_and_cache_match_jax(pair):
    check_prefill(pair)


def test_decode_logits_and_cache_match_jax(pair):
    check_decode(pair)


def test_prefill_then_decode_matches_full_forward(pair):
    check_prefill_then_decode(pair)


def test_init_matches_the_jax_param_specs():
    params = check_init(AID)
    assert set(params) == {"embed", "encoder", "decoder", "enc_norm",
                           "final_norm"}


def test_engine_emits_the_jax_engines_greedy_tokens(pair):
    check_engine_tokens(pair)


def test_engine_cross_cache_keeps_rows_past_the_prompt(pair):
    """The reference's quirk, mirrored: the engine's audio cross cache has
    max_len // 2 rows, a prompt writes plen // 2 of them, and rows past that
    keep what an earlier request wrote (decode attends over all rows)."""
    cfg, model, params, _, _ = pair
    eng = ServingEngine(model, params, max_batch=1, max_len=32, device="cpu")
    assert eng.cache["xk"].shape[2] == 16
    eng.cache["xk"].fill_(1.0)
    eng.submit(np.arange(6, dtype=np.int32), max_new_tokens=2)
    eng.step()
    assert not eng.cache["xk"][:, 0, :3].any()     # zero frames: zero K
    assert (eng.cache["xk"][:, 0, 3:] == 1).all()


def test_serve_cli_runs_on_cpu():
    check_cli(AID)
