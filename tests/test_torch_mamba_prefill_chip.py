"""The Mamba-2 mixer's prefill passes (``csrc/mamba_prefill.cu``) on the
card: each pass against its plain version in ``ref``, the whole mixer
(``mamba_prefill.mixer``) against the same composition over the plain
versions, at granite-4.0-h-small's, mamba2-780m's and hymba-1.5b's mixer
widths and prompts of 1 to 4096 tokens, from zeros and from a cache; the
launches a prefill Mamba layer queues (the profiler's count); no host
synchronisation on the path; and a granite-shaped 20-layer prefill and
decode against the eager mixer's.  Needs an NVIDIA GPU and skips, deciding
inside a fixture, without one.  Imports no JAX, so that it runs where JAX is
not installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mamba_prefill_chip.py
"""

import contextlib
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import mamba_prefill as mp  # noqa: E402
from repro_torch.kernels import ops, ref, ssd_scan  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.telemetry import TelemetryRecorder  # noqa: E402

# (nh, hd, n, chunk, conv bias, norm eps) of each mixer
WIDTHS = {"granite": (128, 64, 128, 256, True, 1e-5),
          "mamba2": (48, 64, 128, 128, False, 1e-6),
          "hymba": (50, 64, 16, 128, False, 1e-6)}
TS = [1, 3, 255, 256, 257, 1385, 4096]
CW = 4
# bf16 outputs: the fp32 sums under them (C·h_in, the sum of squares) run in
# another order than the plain version's, which may move a rounding to the
# neighbouring bf16 value, and the gated norm rounds twice after it: two
# ulps.  fp32 values the passes compute as the plain version does (the same
# products, sums and device exp): one ulp.  The final state: 1e-5 relative.
BF16_ULPS, F32_RTOL, STATE_RTOL = 2, 2 ** -23, 1e-5
# the launches a prefill Mamba layer may queue between its two projections
MAX_LAUNCHES = 14


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rn(gen, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device="cuda") * scale
            ).to(dtype)


def _case(width, t, seed, cached):
    """zxbcdt (1, t, 2di + 2n + nh) and the mixer's weights in bf16, as the
    engine serves them: each weight, the conv context and h0 (with
    ``cached``) layer 1's slice of a stack of 3 layers, which at hymba's 50
    heads starts off 16 bytes."""
    nh, hd, n, _, bias, _ = WIDTHS[width]
    di = nh * hd
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16

    def layer(*shape, scale=1.0, dtype=bf):
        return _rn(gen, 3, *shape, scale=scale, dtype=dtype)[1]
    zxbcdt = _rn(gen, 1, t, 2 * di + 2 * n + nh, dtype=bf)
    p = {"conv": layer(CW, di + 2 * n, scale=0.5),
         "dt_bias": layer(nh, scale=0.5),
         "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device="cuda")
                            ).to(bf).expand(3, nh).clone()[1],
         "D": layer(nh),
         "norm": layer(di, scale=0.1)}
    if bias:
        p["conv_b"] = layer(di + 2 * n, scale=0.1)
    conv = h0 = None
    if cached:
        conv = layer(1, CW - 1, di + 2 * n)
        h0 = layer(1, nh, hd, n, scale=0.1, dtype=torch.float32)
    return zxbcdt, p, conv, h0


def _ulps(got, want) -> float:
    """The largest |got - want| in units of the last place of want's
    bf16 value (2^-7 of its binade)."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2 ** -100)))
                     - 7)
    return float(((g - w).abs() / ulp).max())


def _close_bf16(got, want):
    assert got.dtype == want.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert _ulps(got, want) <= BF16_ULPS


def _close_f32(got, want, rtol=F32_RTOL):
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=rtol, atol=1e-30)


def _plain_with_kernel_intra():
    """``mixer``'s plain composition with the intra-chunk kernel in its
    place: the two sides then share the kernel, and differ in the passes
    alone."""
    return mp.PLAIN._replace(intra=ssd_scan.ssd_intra_chunk_fwd)


def _run_mixer(width, zxbcdt, p, conv, h0, passes):
    nh, hd, n, chunk, _, eps = WIDTHS[width]
    return mp.mixer(zxbcdt, p, hd=hd, n=n, chunk=chunk, eps=eps,
                    conv_state=conv, h0=h0, passes=passes)


@pytest.mark.chip
@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_each_pass_equals_its_plain_version(cuda, width, t, cached):
    nh, hd, n, chunk, _, eps = WIDTHS[width]
    di = nh * hd
    zxbcdt, p, conv, h0 = _case(width, t, 10, cached)
    dtr, xbc = zxbcdt[..., 2 * di + 2 * n:], zxbcdt[..., di:2 * di + 2 * n]
    dt, dacs = mp.ssd_dt(dtr, p["dt_bias"], p["A_log"], chunk)
    want = ref.ssd_dt(dtr, p["dt_bias"], p["A_log"], chunk)
    _close_f32(dt, want[0])
    _close_f32(dacs, want[1])
    got = mp.conv(xbc, p["conv"], p.get("conv_b"), conv, dt, hd=hd)
    want = ref.mamba_conv(xbc, p["conv"], p.get("conv_b"), conv, dt, hd=hd)
    _close_bf16(got[0], want[0])
    assert torch.equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        _close_f32(g, w)
    out, _, xdt, B, C = want
    nc, c = dacs.shape[1:3]
    C = C.reshape(1, nc, c, n)
    y_diag, states = ssd_scan.ssd_intra_chunk_fwd(
        xdt.reshape(1, nc, c, di), dacs, B.reshape(1, nc, c, n), C, nh=nh,
        hd=hd)
    want_in, want_h = ref.ssd_chunk_states(states, dacs, h0)
    h_in, h = mp.chunk_states(states.clone(), dacs, h0)
    _close_f32(h_in, want_in.contiguous())
    _close_f32(h, want_h)
    x = out[..., :di].unflatten(-1, (nh, hd))
    y = mp.output(y_diag, h_in, dacs, C, x, p["D"], zero_first=h0 is None)
    want_y = ref.ssd_output(y_diag, h_in, dacs, C, x, p["D"])
    _close_bf16(y, want_y)
    y = y.reshape(1, t, di)
    z = zxbcdt[..., :di]
    _close_bf16(mp.gated_norm(y, z, p["norm"], eps),
                ref.gated_rmsnorm(y, z, p["norm"], eps))


@pytest.mark.chip
@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_the_mixer_equals_its_plain_composition(cuda, width, t, cached):
    """Output within two bf16 ulps, the final state within 1e-5 relative,
    the conv context exact; five launches of the passes and one of the
    intra-chunk kernel."""
    zxbcdt, p, conv, h0 = _case(width, t, 11, cached)
    n0, i0 = mp.launches, ssd_scan.launches
    y, h, ctx = _run_mixer(width, zxbcdt, p, conv, h0, mp.KERNELS)
    torch.cuda.synchronize()
    assert (mp.launches - n0, ssd_scan.launches - i0) == (5, 1)
    wy, wh, wctx = _run_mixer(width, zxbcdt, p, conv, h0,
                              _plain_with_kernel_intra())
    _close_bf16(y, wy)
    _close_f32(h, wh, STATE_RTOL)
    assert torch.equal(ctx, wctx)


def _granite_mixer(cuda_dev):
    """One full-width granite-4.0-h-small Mamba layer's weights in bf16 and
    its configuration."""
    cfg = get_config("granite-4.0-h-small")
    s, d = cfg.ssm, cfg.d_model
    di, n, nh = s.d_inner(d), s.d_state, s.n_heads(d)
    gen = torch.Generator(device="cuda").manual_seed(12)
    bf = torch.bfloat16
    p = {"w_in": _rn(gen, d, 2 * di + 2 * n + nh, scale=d ** -0.5,
                     dtype=bf),
         "conv": _rn(gen, s.conv_width, di + 2 * n, scale=0.5, dtype=bf),
         "conv_b": _rn(gen, di + 2 * n, scale=0.1, dtype=bf),
         "dt_bias": _rn(gen, nh, scale=0.5, dtype=bf),
         "A_log": torch.log(torch.linspace(1.0, 16.0, nh,
                                           device="cuda")).to(bf),
         "D": _rn(gen, nh, dtype=bf),
         "norm": _rn(gen, di, scale=0.1, dtype=bf),
         "w_out": _rn(gen, di, d, scale=di ** -0.5, dtype=bf)}
    return cfg, p


def _device_ops(fn) -> list[str]:
    """The names of the device operations (kernels, copies, fills) ``fn``
    queues, from the profiler.  A short sleep kernel goes first and is left
    out: the trace has been seen to drop a session's first kernel."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin_kernel" not in e.name]


@contextlib.contextmanager
def plain_mixer():
    """Every Mamba layer's prefill on the eager path, for the comparison
    runs only."""
    real = L.mamba_prefill_impl
    L.mamba_prefill_impl = lambda p, x: "plain"
    try:
        yield
    finally:
        L.mamba_prefill_impl = real


@pytest.mark.chip
@pytest.mark.parametrize("t", [1385, 4096])
def test_a_prefill_mamba_layer_queues_at_most_14_launches(cuda, t):
    """Counted by the profiler: the device operations of one granite
    prefill ``mamba_block`` less those of its two projections alone, and
    those of ``ops.mamba_prefill`` alone; the eager path's count beside
    them (~70 + 2 a chunk)."""
    cfg, p = _granite_mixer(cuda)
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = _rn(gen, 1, t, cfg.d_model, dtype=torch.bfloat16)
    s = cfg.ssm

    def layer():
        return L.mamba_block(cfg, p, x, mode="prefill")

    zxbcdt = x @ p["w_in"]
    y = torch.zeros((1, t, s.d_inner(cfg.d_model)), dtype=torch.bfloat16,
                    device="cuda")

    def projections():
        return x @ p["w_in"], y @ p["w_out"]

    def between():
        return ops.mamba_prefill(zxbcdt, p, hd=s.head_dim, n=s.d_state,
                                 chunk=s.chunk, eps=s.norm_eps)

    layer(), projections(), between()                    # warm
    with torch.no_grad():
        whole, proj = _device_ops(layer), _device_ops(projections)
        alone = _device_ops(between)
        with plain_mixer():
            layer()
            eager = _device_ops(layer)
    nc = -(-t // s.chunk)
    print(f"T={t}: {len(whole)} device ops a layer, {len(proj)} in the "
          f"projections, {len(alone)} between them ({alone}); eager "
          f"{len(eager) - len(proj)} between them ({nc} chunks)")
    assert len(whole) - len(proj) <= MAX_LAUNCHES
    assert len(alone) <= MAX_LAUNCHES
    assert sum("ssd_intra_chunk_kernel" in k for k in alone) == 1
    assert len(eager) - len(proj) > len(alone)


@pytest.mark.chip
def test_the_fused_path_makes_no_host_sync(cuda):
    cfg, p = _granite_mixer(cuda)
    gen = torch.Generator(device="cuda").manual_seed(14)
    x = _rn(gen, 1, 1385, cfg.d_model, dtype=torch.bfloat16)
    with torch.no_grad():
        L.mamba_block(cfg, p, x, mode="prefill")          # warm: the build
        torch.cuda.synchronize()
        n0 = mp.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, cache = L.mamba_block(cfg, p, x, mode="prefill")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert mp.launches == n0 + 5
    assert bool(torch.isfinite(y.float()).all())
    assert cache["h"].dtype == torch.float32


def _greedy(model, params, prompt, steps, forced=None):
    """A prefill of ``prompt`` (1, P), its cache written into a decode
    cache as the engine writes a slot, then ``steps`` decode steps, each
    fed the argmax of the last logits (or ``forced``'s next token).
    Returns the tokens and the logits of every position read, fp32."""
    P = prompt.shape[1]
    batch = {"tokens": prompt,
             "lengths": torch.tensor([P], dtype=torch.int32, device="cuda")}
    logits, pcache = model.apply_prefill(params, batch)
    cache = model.init_cache(1, P + steps + 1, device="cuda")
    for k, dst in cache.items():
        if k in ("k", "v"):
            dst[:, 0, :P] = pcache[k][:, 0, :P]
        else:
            dst[:, 0] = pcache[k][:, 0]
    outs, toks = [logits[0, -1].float()], []
    for s in range(steps + 1):
        toks.append(int(outs[-1].argmax()) if forced is None
                    else forced[s])
        if s == steps:
            break
        batch = {"tokens": torch.tensor([[toks[-1]]], dtype=torch.int32,
                                        device="cuda"),
                 "lengths": torch.tensor([P + s + 1], dtype=torch.int32,
                                         device="cuda")}
        logits, cache = model.apply_decode(params, cache, batch)
        outs.append(logits[0, -1].float())
    return toks, torch.stack(outs)


def _granite20(top_k: int):
    """granite-4.0-h-small's first 20 layers (18 Mamba, 2 attention) at its
    widths, the experts cut to 8 of top-``top_k`` and the vocab to 4096 to
    keep the test small, with seeded bf16 weights."""
    full = get_config("granite-4.0-h-small")
    cfg = dataclasses.replace(
        full, n_layers=20, mixers=full.mixers[:20], vocab=4096,
        moe=dataclasses.replace(full.moe, num_experts=8, top_k=top_k))
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=torch.bfloat16)
    return cfg, model, params


def _against_eager(cfg, model, params, seed, steps=8):
    """Two prompts' greedy tokens through the passes and the eager mixer's
    logits on the same tokens: per prompt (tokens, the eager argmaxes, the
    largest logit difference, the eager logits' std, the eager top-2
    gaps)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    with torch.no_grad():
        for P in (300, 1385):
            prompt = torch.randint(0, cfg.vocab, (1, P), generator=gen,
                                   device="cuda", dtype=torch.int32)
            toks, got = _greedy(model, params, prompt, steps)
            with plain_mixer():
                _, want = _greedy(model, params, prompt, steps, toks)
            top2 = want.topk(2, -1).values
            out.append((toks, want.argmax(-1).tolist(),
                        float((got - want).abs().max()), float(want.std()),
                        top2[:, 0] - top2[:, 1]))
            print(f"top-{cfg.moe.top_k}, P={P}: max |logit diff| "
                  f"{out[-1][2]:.3e}, logit std {out[-1][3]:.3e}, smallest "
                  f"top-2 gap {float(out[-1][4].min()):.3e}")
    return out


@pytest.mark.chip
@pytest.mark.parametrize("top_k", [2, 8])
def test_a_granite_prefill_and_decode_give_the_eager_mixers_tokens(cuda,
                                                                   top_k):
    """Every token is the eager run's argmax, except where the eager run's
    two best logits lie closer than twice the largest logit difference
    between the runs (a near tie that the passes' fp32 sums in another
    order may turn: their rare one-ulp differences grow over 20 layers, and
    at top-2 a router's near tie may send a token to another expert); at
    most two such positions.  The prefill ``layer.ssm`` spans say
    "kernels", and a prefill launches the passes 5 times a Mamba layer."""
    cfg, model, params = _granite20(top_k)
    ties = 0
    for toks, plain, diff, _, gap in _against_eager(cfg, model, params,
                                                    15 + top_k):
        near = gap <= 2 * diff
        for i, (a, b) in enumerate(zip(toks, plain)):
            assert a == b or bool(near[i]), (i, a, b)
        ties += int(near.sum())
    assert ties <= 2
    rec = TelemetryRecorder("mamba_prefill_chip")
    n0 = mp.launches
    tokens = torch.zeros((1, 300), dtype=torch.int32, device="cuda")
    with torch.no_grad():
        model.apply_prefill(params, {"tokens": tokens}, telemetry=rec)
    torch.cuda.synchronize()
    assert mp.launches - n0 == 5 * cfg.n_mixer_layers("M") == 90
    impls = [e.attrs.get("impl") for e in rec.events
             if e.kind == "span" and e.name == "layer.ssm"]
    assert impls == ["kernels"] * 18
