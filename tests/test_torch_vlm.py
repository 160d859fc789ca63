"""The port's VLM family (llama-3.2-vision-11b) against the JAX package on its
reduced config (4 layers as 2 groups of one self layer and one cross layer,
d 64, 4 query heads over 2, 16 vision tokens): the model's logits, the
two-level self cache and the cross cache, a decode step, init, the engine's
greedy tokens and the serve CLI.

The JAX parameters get open gates (``GATE``) before conversion, and the
vision embeddings are random, so the cross branch carries weight (closed
gates or zero vision would make it exactly 0).  Helpers and tolerances are
those of tests/test_torch_encdec.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import vlm  # noqa: E402
from test_torch_encdec import (B, GATE, S, check_cli, check_decode,  # noqa: E402
                               check_engine_tokens, check_init,
                               check_prefill, check_prefill_then_decode,
                               check_train_logits, make_batch, make_pair)
from test_torch_model import _close  # noqa: E402

AID = "llama-3.2-vision-11b"


@pytest.fixture(scope="module")
def pair():
    return make_pair(AID)


def test_cache_layout(pair):
    """Self k/v (groups, self per group, B, S, Hkv, hd) and cross xk/xv
    (groups, B, Nv, Hkv, hd), as the JAX package's."""
    cfg, model, params, jmodel, _ = pair
    g, spg = vlm.n_groups(cfg), vlm.self_per_group(cfg)
    cache = model.init_cache(B, S, device="cpu")
    jcache = jmodel.init_cache(B, S)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    assert cache["k"].shape == (g, spg, B, S, cfg.n_kv_heads, cfg.hd)
    assert cache["xk"].shape == (g, B, cfg.n_vision_tokens, cfg.n_kv_heads,
                                 cfg.hd)
    assert float(params["cross"]["gate_attn"][0]) == GATE


def test_the_jax_comparison_sees_the_cross_branch(pair):
    """With the attention gate open and random vision, the port without its
    cross-attention branch (gate_attn closed) is more than twice as far from
    the JAX logits, in relative norm, as the port with it: the logit
    comparisons below would catch the branch missing, where closed gates or
    zero vision multiply it by 0.  (At the reduced widths the branch moves
    the logits by about 3% of their norm, under the 5e-2 element-wise
    tolerance on its own.)"""
    cfg, model, params, jmodel, jparams = pair
    tb, jb = make_batch(cfg, 5)
    want = np.asarray(jmodel.apply_train(jparams, jb, remat=False))
    closed = {**params, "cross": {**params["cross"],
                                  "gate_attn": torch.zeros_like(
                                      params["cross"]["gate_attn"])}}

    def dist(p):
        got = model.apply_train(p, tb).numpy()
        return np.linalg.norm(got - want) / np.linalg.norm(want)
    near, without = dist(params), dist(closed)
    assert without > 2 * near, (near, without)


def test_train_logits_match_jax(pair):
    check_train_logits(pair)


def test_prefill_logits_and_cache_match_jax(pair):
    check_prefill(pair)


def test_decode_logits_and_cache_match_jax(pair):
    check_decode(pair)


def test_prefill_then_decode_matches_full_forward(pair):
    check_prefill_then_decode(pair)


def test_decode_reads_the_cross_cache(pair):
    """A decode step attends over the cached image K/V: its logits are the
    full forward's with the vision its cache was built from, and further
    from the full forward's with other vision than they are from those."""
    cfg, model, params, _, _ = pair
    p = S - 1
    tb, _ = make_batch(cfg, 6)
    other = make_batch(cfg, 7)[0]["vision"]
    _, pcache = model.apply_prefill(params, {
        **tb, "tokens": tb["tokens"][:, :p],
        "lengths": torch.full((B,), p, dtype=torch.int32)})
    cache = model.init_cache(B, S, device="cpu")
    for k, v in pcache.items():
        cache[k][..., :v.shape[-3], :, :] = v
    got, _ = model.apply_decode(params, cache, {
        "tokens": tb["tokens"][:, p:],
        "lengths": torch.full((B,), p + 1, dtype=torch.int32)})
    same = model.apply_train(params, tb)[:, p]
    diff = model.apply_train(params, {**tb, "vision": other})[:, p]
    _close(got[:, 0], same.numpy())
    assert (got[:, 0] - diff).norm() > 2 * (got[:, 0] - same).norm()


def test_init_matches_the_jax_param_specs():
    params = check_init(AID)
    assert set(params) == {"embed", "self", "cross", "final_norm"}
    assert params["cross"]["gate_attn"].dtype == torch.bfloat16


def test_engine_emits_the_jax_engines_greedy_tokens(pair):
    check_engine_tokens(pair)


def test_serve_cli_runs_on_cpu():
    check_cli(AID)
