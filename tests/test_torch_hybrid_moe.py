"""The port's ``hybrid_moe`` family (granite-4.0-h-small) at its reduced
size on the CPU, against the plain fp32 reference ``_plain_hybrid_moe`` on
seeded random weights: the forward pass in fp32 compute, prefill then eight
decode steps through the cache in the served bf16, the serving engine's
greedy tokens, the per-kind cache, the planner's blocks and FLOPs, the
layer spans, and that a reference without the shared expert or without the
0.22 residual scale is told apart.  The JAX package has no such family: the
reference here is the only oracle."""

import contextlib
import dataclasses
import math
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _plain_hybrid_moe as plain  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import build_model, transformer  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.telemetry import TelemetryRecorder  # noqa: E402

AID = "granite-4.0-h-small"
P, STEPS, S = 19, 8, 48        # prompt, decode steps, the cache's rows
# fp32 compute against the fp32 reference: the two sum in other orders (the
# chunked scan against the step-by-step recurrence, the routed combine, the
# blocked attention), a few fp32 ulps a layer: 1.6e-7 to 1.9e-7 of the
# logits' norm over seeds 0-5
TOL_FP32 = 1e-5
# the served bf16 against the fp32 reference: every product's inputs and
# outputs rounded to bf16 (8 bits of mantissa, a relative step of 2^-8), the
# K/V and conv caches in bf16, over three layers.  Over seeds 0-5 the
# worst step reads 0.56-0.75% of the logits' norm; a reference without the
# shared expert reads 13.4% at its nearest, one with the residual branches
# unscaled 55.9%
TOL_BF16 = 2e-2


def _cfg():
    return get_config(AID).reduced()


def _params(cfg, seed: int, dtype=torch.float32) -> dict:
    """The program's init with the leaves it sets constant drawn at random
    too: norm offsets N(0, 0.1^2), the conv bias N(0, 1/cw), D near 1,
    dt_bias the inverse softplus of dt log-uniform in [1e-3, 1e-1]; the
    embedding N(0, 1/12^2), so that its rows, times 12, are as large as
    the layers' branches and the logits depend on every layer."""
    g = torch.Generator().manual_seed(seed)
    p = build_model(cfg).init(g, device="cpu", dtype=dtype)
    lp, s = p["layers"], p["layers"]["ssm"]

    def draw(t, scale, shift=0.0):
        t.copy_(shift + scale * torch.randn(t.shape, generator=g))

    for t in (lp["ln1"]["w"], lp["ln2"]["w"], p["final_norm"]["w"],
              s["norm"]):
        draw(t, 0.1)
    draw(s["conv_b"], cfg.ssm.conv_width ** -0.5)
    draw(s["D"], 0.1, 1.0)
    dt = torch.exp(torch.empty(s["dt_bias"].shape).uniform_(
        math.log(1e-3), math.log(1e-1), generator=g))
    s["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
    draw(p["embed"]["embedding"], 1.0 / cfg.embedding_multiplier)
    return p


def _tokens(cfg, n: int, seed: int) -> torch.Tensor:
    return torch.randint(0, cfg.vocab, (n,),
                         generator=torch.Generator().manual_seed(100 + seed))


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want).norm() / want.norm()).item()


@contextlib.contextmanager
def _fp32_compute():
    old = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float32
    try:
        yield
    finally:
        L.COMPUTE_DTYPE = old


def _prefill_decode(cfg, params, toks: torch.Tensor) -> torch.Tensor:
    """Logits (STEPS, V) of positions P-1 .. P+STEPS-2 as the served path
    computes them: the prompt's P tokens through ``apply_prefill`` into
    slot 1 of a two-row cache, then STEPS - 1 decode steps through the
    cache, each fed the next token of ``toks``."""
    model = build_model(cfg)
    cache = model.init_cache(2, S, device="cpu")
    eng = ServingEngine.__new__(ServingEngine)   # its slot write alone
    eng.cache = cache
    with torch.no_grad():
        logits, pcache = model.apply_prefill(
            params, {"tokens": toks[None, :P],
                     "lengths": torch.tensor([P], dtype=torch.int32)})
        eng._write_slot(1, pcache)
        out = [logits[0, -1]]
        for i in range(STEPS - 1):
            tok = torch.zeros((2, 1), dtype=torch.int64)
            tok[1, 0] = toks[P + i]
            logits, cache = model.apply_decode(
                params, cache, {"tokens": tok,
                                "lengths": torch.tensor([1, P + i + 1],
                                                        dtype=torch.int32)})
            out.append(logits[1, -1])
    return torch.stack(out)


def test_the_id_is_the_ports_own():
    cfg = get_config(AID)
    assert AID not in ARCH_IDS and cfg.family == "hybrid_moe"
    assert cfg.mixers == "MMMMMAMMMM" * 4
    r = cfg.reduced()
    assert set(r.mixers) == {"M", "A"} and r.moe.d_ff_shared > 0
    with pytest.raises(ValueError, match="mixers"):
        dataclasses.replace(r, n_layers=4)


@pytest.mark.parametrize("moe_impl", ["routed", "dense"])
@pytest.mark.parametrize("seed", [0, 1])
def test_forward_in_fp32_equals_the_plain_reference(seed, moe_impl):
    """Both lowerings of the MoE: "routed", which the engine serves, and
    "dense", the oracle every MoE family keeps."""
    cfg = _cfg()
    params = _params(cfg, seed)
    toks = _tokens(cfg, 37, seed)
    with torch.no_grad(), _fp32_compute():
        got, _ = transformer.forward(cfg, params, toks[None],
                                     mode="prefill", moe_impl=moe_impl)
    want = plain.forward(cfg, params, toks)
    assert got[0].shape == want.shape == (37, cfg.vocab)
    assert _rel(got[0], want) < TOL_FP32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefill_then_decode_matches_the_reference(seed):
    """bf16 weights served as the engine serves them, against the
    reference's full forward in fp32 over the same tokens."""
    cfg = _cfg()
    params = _params(cfg, seed, torch.bfloat16)
    toks = _tokens(cfg, P + STEPS, seed)
    got = _prefill_decode(cfg, params, toks)
    want = plain.forward(cfg, params, toks)[P - 1:P + STEPS - 1]
    for i in range(STEPS):
        assert _rel(got[i], want[i]) < TOL_BF16, i


@pytest.mark.parametrize("left_out", ["shared_expert", "residual_scale"])
def test_a_reference_without_a_part_fails_the_tolerance(left_out):
    """The tolerance is tight enough to see each part of the layer: a
    reference without the shared expert, or with the residual branches
    unscaled, is further from the served logits than TOL_BF16."""
    cfg = _cfg()
    params = _params(cfg, 0, torch.bfloat16)
    toks = _tokens(cfg, P + STEPS, 0)
    got = _prefill_decode(cfg, params, toks)
    kw = ({"shared": False} if left_out == "shared_expert"
          else {"residual_multiplier": 1.0})
    wrong = plain.forward(cfg, params, toks, **kw)[P - 1:P + STEPS - 1]
    assert min(_rel(got[i], wrong[i]) for i in range(STEPS)) > TOL_BF16


def test_the_engine_serves_the_full_forwards_greedy_tokens():
    """Three requests through two slots (the third reuses a slot, its state
    and K/V overwritten), against greedy decoding by the program's own
    full forward without a cache."""
    cfg = _cfg()
    model = build_model(cfg)
    params = _params(cfg, 3, torch.bfloat16)
    prompts = [_tokens(cfg, n, i).numpy().astype(np.int32)
               for i, n in enumerate((11, 17, 6))]
    eng = ServingEngine(model, params, max_batch=2, max_len=S, device="cpu")
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    done = eng.run_until_done()
    for rid, prompt in zip(rids, prompts):
        toks = list(map(int, prompt))
        with torch.no_grad():
            for _ in range(6):
                logits, _ = transformer.forward(
                    cfg, params, torch.tensor([toks]), mode="prefill",
                    moe_impl="routed", logits_tail=1)
                toks.append(int(torch.argmax(logits[0, -1])))
        assert done[rid].generated == toks[len(prompt):]


def test_the_cache_holds_each_kind_at_its_own_depth():
    cfg = _cfg()
    model = build_model(cfg)
    n_a, n_m = cfg.n_mixer_layers("A"), cfg.n_mixer_layers("M")
    assert (n_a, n_m) == (1, 2)
    s = cfg.ssm
    di, n, nh = s.d_inner(cfg.d_model), s.d_state, s.n_heads(cfg.d_model)
    cache = model.init_cache(3, S, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        "k": (n_a, 3, S, cfg.n_kv_heads, cfg.hd),
        "v": (n_a, 3, S, cfg.n_kv_heads, cfg.hd),
        "h": (n_m, 3, nh, s.head_dim, n),
        "conv": (n_m, 3, s.conv_width - 1, di + 2 * n)}
    assert cache["h"].dtype == torch.float32
    assert cache["k"].dtype == cache["conv"].dtype == torch.bfloat16
    params = _params(cfg, 4, torch.bfloat16)
    with torch.no_grad():
        _, pcache = model.apply_prefill(
            params, {"tokens": _tokens(cfg, P, 4)[None],
                     "lengths": torch.tensor([P], dtype=torch.int32)})
    assert {k: v.shape[0] for k, v in pcache.items()} == {
        "k": n_a, "v": n_a, "h": n_m, "conv": n_m}
    eng = ServingEngine.__new__(ServingEngine)
    eng.cache = cache
    eng._write_slot(2, pcache)
    for k in ("k", "v"):
        assert torch.equal(cache[k][:, 2, :P], pcache[k][:, 0])
        assert not cache[k][:, :2].any() and not cache[k][:, 2, P:].any()
    for k in ("h", "conv"):
        assert torch.equal(cache[k][:, 2], pcache[k][:, 0].to(
            cache[k].dtype))
        assert not cache[k][:, :2].any()


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_blocks_by_kind_and_flops_sum_to_the_analytic_count(kind):
    """Mamba layers are "ssm" blocks the decode step cannot split by data,
    attention layers "moe" blocks; the blocks' FLOPs (the layers' and the
    head's) are the model's analytic step FLOPs, counted here from the
    widths, and their parameters the model's."""
    cfg = get_config(AID)
    model = build_model(cfg)
    seq, batch = 4096, 8
    shape = ShapeConfig("t", seq, batch, kind)
    dag = model.block_costs(shape)
    layers = dag.blocks[1:-1]
    assert [b.kind for b in layers] == [
        "ssm" if m == "M" else "moe" for m in cfg.mixers]
    assert [b.data_splittable for b in layers] == [
        m == "A" or kind != "decode" for m in cfg.mixers]

    d, m, s = cfg.d_model, cfg.moe, cfg.ssm
    di, n, nh, hd = (s.d_inner(d), s.d_state, s.n_heads(d), s.head_dim)
    tokens = batch * (1 if kind == "decode" else seq)
    ffn = 2 * d * m.num_experts + 6 * d * (m.top_k * m.d_ff_expert
                                           + m.d_ff_shared)
    if kind == "decode":
        scan = 4 * nh * hd * n
    else:
        scan = 2 * s.chunk * n + 2 * s.chunk * nh * hd + 4 * nh * hd * n
    mamba = (2 * d * (2 * di + 2 * n + nh) + 2 * di * d
             + 2 * s.conv_width * (di + 2 * n) + scan)
    attn = (4 * d * cfg.n_heads * cfg.hd + 4 * d * cfg.n_kv_heads * cfg.hd
            + 4 * cfg.n_heads * cfg.hd * seq / 2)
    want = tokens * sum(ffn + (mamba if mx == "M" else attn)
                        for mx in cfg.mixers) + batch * 2 * d * cfg.vocab
    got = sum(b.flops for b in dag.blocks[1:])
    assert got == pytest.approx(want, rel=1e-12)
    assert model.step_flops(shape) == pytest.approx(want, rel=1e-12)
    params = sum(b.param_bytes for b in dag.blocks) / 2
    assert params == pytest.approx(cfg.params_total(), rel=1e-12)
    # the 32B-total, 9B-active model of the source
    assert 31.5e9 < cfg.params_total() < 33e9
    assert 8.5e9 < cfg.params_active() < 9.5e9


def test_the_layer_spans_name_each_kind():
    cfg = _cfg()
    model = build_model(cfg)
    rec = TelemetryRecorder("hybrid_moe")
    eng = ServingEngine(model, _params(cfg, 5, torch.bfloat16), max_batch=2,
                        max_len=S, device="cpu", telemetry=rec)
    eng.submit(_tokens(cfg, 9, 5).numpy().astype(np.int32),
               max_new_tokens=3)
    eng.run_until_done()
    spans = [e for e in rec.events if e.kind == "span"]
    calls = [e for e in spans if e.name in ("engine.prefill",
                                            "engine.decode")]
    assert [e.name for e in calls] == ["engine.prefill"] + [
        "engine.decode"] * 2
    mamba = [i for i, m in enumerate(cfg.mixers) if m == "M"]
    attn = [i for i, m in enumerate(cfg.mixers) if m == "A"]
    every = list(range(cfg.n_layers))
    want = {"layer.norm": every * 2, "layer.ssm": mamba,
            "layer.attention": attn, "layer.shared_mlp": every,
            "layer.moe": every}
    for call in calls:
        mine = [e for e in spans if e.parent_id == call.span_id]
        layers = {name: sorted(e.attrs["layer"] for e in mine
                               if e.name == name) for name in want}
        assert layers == {k: sorted(v) for k, v in want.items()}
        order = [e.name for e in mine if e.name.startswith("layer.")
                 and e.attrs["layer"] == attn[0]]
        assert order == ["layer.norm", "layer.attention", "layer.norm",
                         "layer.moe", "layer.shared_mlp"]
        assert {e.attrs["impl"] for e in mine
                if e.name == "layer.moe"} == {"routed"}
        # a Mamba layer names its path, prefill and decode: plain on CPU
        assert {e.attrs.get("impl") for e in mine if e.name == "layer.ssm"
                } == {"plain"}
        names = Counter(e.name for e in mine)
        assert names["model.embed"] == names["model.head"] == 1


def test_training_and_the_sharded_steps_refuse_the_family():
    from repro_torch.sharding import spmd
    cfg = _cfg()
    model = build_model(cfg)
    params = _params(cfg, 6)
    with pytest.raises(NotImplementedError, match="hybrid_moe"):
        model.apply_train(params, {"tokens": _tokens(cfg, 8, 6)[None]})
    for make in (spmd.make_sharded_prefill, spmd.make_sharded_decode):
        with pytest.raises(NotImplementedError, match="hybrid_moe"):
            make(model, None, None)
    with pytest.raises(NotImplementedError, match="hybrid_moe"):
        spmd.make_sharded_grad_fn(model, None, None)
