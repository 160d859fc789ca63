"""The Mamba-2 mixer's prefill passes (``kernels/mamba_prefill.py``,
``csrc/mamba_prefill.cu``) on the CPU: each pass's plain version in ``ref``
against the eager code of its stage (``layers.mamba_block``,
``ssd_scan.ssd``, ``layers.rmsnorm``) to the bit, at granite-4.0-h-small's,
mamba2-780m's and hymba-1.5b's mixer widths; ``mamba_prefill.mixer`` over
the plain versions against ``mamba_block``'s eager path; the dispatch
(``ops.mamba_prefill_impl``: plain on the CPU, under grad and under a
split) and the wrappers' refusals.  The kernels themselves run in
``tests/test_torch_mamba_prefill_chip.py`` on the card.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import mamba_prefill as mp  # noqa: E402
from repro_torch.kernels import ops, ref, ssd_scan  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.sharding import ctx as shard_ctx  # noqa: E402

# (nh, hd, n, chunk, conv bias, norm eps) of each mixer
WIDTHS = {"granite": (128, 64, 128, 256, True, 1e-5),
          "mamba2": (48, 64, 128, 128, False, 1e-6),
          "hymba": (50, 64, 16, 128, False, 1e-6)}
TS = [1, 3, 255, 256, 257, 1385]
DTYPES = [torch.float32, torch.bfloat16]
CW, B = 4, 1


def _rn(gen, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen) * scale).to(dtype)


def _case(width, t, dtype, seed):
    """zxbcdt (B, t, 2di + 2n + nh) in ``dtype`` and the mixer's weights in
    ``dtype``, drawn so that every stage sees values of its real range."""
    nh, hd, n, _, bias, _ = WIDTHS[width]
    di = nh * hd
    gen = torch.Generator().manual_seed(seed)
    zxbcdt = _rn(gen, B, t, 2 * di + 2 * n + nh, dtype=dtype)
    p = {"conv": _rn(gen, CW, di + 2 * n, scale=0.5, dtype=dtype),
         "dt_bias": _rn(gen, nh, scale=0.5, dtype=dtype),
         "A_log": torch.log(torch.linspace(1.0, 16.0, nh)).to(dtype),
         "D": _rn(gen, nh, dtype=dtype),
         "norm": _rn(gen, di, scale=0.1, dtype=dtype)}
    if bias:
        p["conv_b"] = _rn(gen, di + 2 * n, scale=0.1, dtype=dtype)
    return zxbcdt, p


def _split(zxbcdt, width):
    nh, hd, n = WIDTHS[width][:3]
    di = nh * hd
    return torch.split(zxbcdt, [di, di, n, n, nh], -1)


def _eager_dt(dtr, p):
    """``mamba_block``'s dt and A."""
    return (F.softplus(dtr.float() + p["dt_bias"].float()),
            -torch.exp(p["A_log"].float()))


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_dt_pass_equals_the_eager_stage(width, t, dtype):
    nh, hd, n, chunk = WIDTHS[width][:4]
    zxbcdt, p = _case(width, t, dtype, 1)
    z, xs, Bc, Cc, dtr = _split(zxbcdt, width)
    dt, dacs = ref.ssd_dt(dtr, p["dt_bias"], p["A_log"], chunk)
    want_dt, A = _eager_dt(dtr, p)
    _, want_dacs, _, _ = ssd_scan.chunk_operands(
        xs.reshape(B, t, nh, hd), want_dt, A, Bc, Cc, chunk)
    _same(dt[:, :t], want_dt)
    assert not dt[:, t:].any()
    _same(dacs, want_dacs)


@pytest.mark.parametrize("context", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_conv_pass_equals_the_eager_stage(width, t, dtype, context):
    """The conv over the projection's x|B|C columns (no cat), its context
    and the intra-chunk operands, as ``mamba_block``'s conv and
    ``ssd_scan.chunk_operands`` give them."""
    nh, hd, n, chunk = WIDTHS[width][:4]
    zxbcdt, p = _case(width, t, dtype, 2)
    z, xs, Bc, Cc, dtr = _split(zxbcdt, width)
    di = nh * hd
    state = (_rn(torch.Generator().manual_seed(3), B, CW - 1, di + 2 * n,
                 dtype=dtype) if context else None)
    dt, _ = ref.ssd_dt(dtr, p["dt_bias"], p["A_log"], chunk)
    got = ref.mamba_conv(zxbcdt[..., di:2 * di + 2 * n], p["conv"],
                         p.get("conv_b"), state, dt, hd=hd)
    bias = p.get("conv_b")
    out, new_state = ref.causal_conv(
        torch.cat([xs, Bc, Cc], -1), p["conv"].to(dtype), state,
        None if bias is None else bias.to(dtype))
    xo, Bo, Co = torch.split(out, [di, n, n], -1)
    want_dt, A = _eager_dt(dtr, p)
    xdt, _, Bf, Cf = ssd_scan.chunk_operands(
        xo.reshape(B, t, nh, hd), want_dt, A, Bo, Co, chunk)
    tp = xdt.shape[1] * xdt.shape[2]
    _same(got[0], out)
    _same(got[1], new_state)
    _same(got[2], xdt.reshape(B, tp, di))
    _same(got[3], Bf.reshape(B, tp, n))
    _same(got[4], Cf.reshape(B, tp, n))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_state_and_output_passes_equal_the_eager_scan(width, t, dtype,
                                                      with_h0):
    """``ssd_scan.ssd``'s code after its intra-chunk pass (the inter-chunk
    loop, y_off, the D skip, the cast) on the pass's outputs, here drawn at
    random and handed to ``ssd`` by a stand-in pass, against
    ``ref.ssd_chunk_states`` then ``ref.ssd_output`` on the same."""
    nh, hd, n, chunk = WIDTHS[width][:4]
    gen = torch.Generator().manual_seed(4)
    x = _rn(gen, B, t, nh, hd, scale=0.5, dtype=dtype)
    dt = F.softplus(_rn(gen, B, t, nh)) * 0.1
    A = -torch.exp(_rn(gen, nh))
    Bc, Cc = (_rn(gen, B, t, n, scale=0.3, dtype=dtype) for _ in range(2))
    D = _rn(gen, nh)
    h0 = _rn(gen, B, nh, hd, n, scale=0.1) if with_h0 else None
    c = min(chunk, t)
    nc = -(-t // c)
    y_diag = _rn(gen, B, nc, c, nh * hd)
    states = _rn(gen, B, nc, nh, n, hd, scale=0.1)
    seen = {}

    def intra(xdt, dacs, Bf, Cf, *, nh, hd):
        seen.update(dacs=dacs, C=Cf)
        return y_diag, states

    want_y, want_h = ssd_scan.ssd(x, dt, A, Bc, Cc, D, chunk=chunk, h0=h0,
                                  intra_chunk=intra)
    h_in, h = ref.ssd_chunk_states(states, seen["dacs"], h0)
    assert h_in.shape == states.shape
    _same(h, want_h)
    _same(ref.ssd_output(y_diag, h_in, seen["dacs"], seen["C"], x, D),
          want_y)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_gated_norm_pass_equals_the_eager_stage(width, t, dtype):
    nh, hd, _, _, _, eps = WIDTHS[width]
    zxbcdt, p = _case(width, t, dtype, 5)
    z = _split(zxbcdt, width)[0]
    y = _rn(torch.Generator().manual_seed(6), B, t, nh * hd, dtype=dtype)
    want = layers.rmsnorm(y * F.silu(z.float()).to(y.dtype), p["norm"], eps)
    _same(ref.gated_rmsnorm(y, z, p["norm"], eps), want)


def _cfg(aid):
    """The reduced configuration of ``aid``'s mixer (granite's: mamba2's
    reduced model with granite's SSM spec: conv bias, its epsilon, chunk
    256)."""
    if aid == "granite":
        base = get_config("mamba2-780m").reduced()
        spec = get_config("granite-4.0-h-small").ssm
        return dataclasses.replace(
            base, ssm=dataclasses.replace(spec, head_dim=base.ssm.head_dim,
                                          d_state=base.ssm.d_state))
    return get_config({"mamba2": "mamba2-780m",
                       "hymba": "hymba-1.5b"}[aid]).reduced()


def _mixer_weights(cfg, dtype, seed):
    s, d = cfg.ssm, cfg.d_model
    di, n, nh = s.d_inner(d), s.d_state, s.n_heads(d)
    gen = torch.Generator().manual_seed(seed)
    p = {"w_in": _rn(gen, d, 2 * di + 2 * n + nh, scale=d ** -0.5,
                     dtype=dtype),
         "conv": _rn(gen, s.conv_width, di + 2 * n, scale=0.5, dtype=dtype),
         "dt_bias": _rn(gen, nh, scale=0.5, dtype=dtype),
         "A_log": torch.log(torch.linspace(1.0, 16.0, nh)).to(dtype),
         "D": _rn(gen, nh, dtype=dtype),
         "norm": _rn(gen, di, scale=0.1, dtype=dtype),
         "w_out": _rn(gen, di, d, scale=di ** -0.5, dtype=dtype)}
    if s.conv_bias:
        p["conv_b"] = _rn(gen, di + 2 * n, scale=0.1, dtype=dtype)
    return p


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("compute", DTYPES)
@pytest.mark.parametrize("t", [1, 3, 40, 300])
@pytest.mark.parametrize("aid", ["granite", "mamba2", "hymba"])
def test_mixer_over_the_plain_passes_equals_mamba_block(aid, t, compute,
                                                        cached, monkeypatch):
    """``ops.mamba_prefill`` on CPU tensors (``mixer`` over ``PLAIN``) and
    ``w_out`` against ``mamba_block``'s eager prefill, its scan through
    ``ssd_scan.ssd`` with the plain intra-chunk pass (the code a CUDA
    prefill ran before the passes): output, state and conv context to the
    bit, from zeros and from a cache."""
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", compute)
    monkeypatch.setattr(ops, "ssd", lambda *a, **k: ssd_scan.ssd(
        *a, **k, intra_chunk=ref.ssd_intra_chunk))
    cfg = _cfg(aid)
    s, d = cfg.ssm, cfg.d_model
    di, n, nh = s.d_inner(d), s.d_state, s.n_heads(d)
    p = _mixer_weights(cfg, torch.bfloat16, 7)
    gen = torch.Generator().manual_seed(8)
    x = _rn(gen, 2, t, d, dtype=torch.bfloat16)
    cache = None
    if cached:
        cache = {"h": _rn(gen, 2, nh, s.head_dim, n, scale=0.1),
                 "conv": _rn(gen, 2, s.conv_width - 1, di + 2 * n,
                             dtype=torch.bfloat16)}
    assert layers.mamba_prefill_impl(p, x) == "plain"
    want, wc = layers.mamba_block(cfg, p, x, mode="prefill", cache=cache)
    zxbcdt = x.to(compute) @ p["w_in"].to(compute)
    y, h, conv = ops.mamba_prefill(
        zxbcdt, p, hd=s.head_dim, n=n, chunk=s.chunk, eps=s.norm_eps,
        conv_state=None if cache is None else cache["conv"],
        h0=None if cache is None else cache["h"])
    _same((y @ p["w_out"].to(compute)).to(x.dtype), want)
    _same(h, wc["h"])
    _same(conv, wc["conv"])


def test_mamba_block_on_cpu_takes_the_plain_path_and_its_span_says_so():
    """A reduced mamba2-780m prefill through the engine's model on the
    CPU: every prefill ``layer.ssm`` span says "plain", and no pass
    launched."""
    from repro_torch.models import build_model
    from repro_torch.telemetry import TelemetryRecorder

    cfg = get_config("mamba2-780m").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.bfloat16)
    before = (mp.launches, ssd_scan.launches)
    rec = TelemetryRecorder("mamba_prefill")
    tokens = torch.randint(0, cfg.vocab, (1, 9), dtype=torch.int32)
    with torch.no_grad():
        model.apply_prefill(params, {"tokens": tokens}, telemetry=rec)
    impls = [e.attrs.get("impl") for e in rec.events
             if e.kind == "span" and e.name == "layer.ssm"]
    assert impls == ["plain"] * cfg.n_layers
    assert (mp.launches, ssd_scan.launches) == before


def test_the_fused_path_is_chosen_by_device_gradient_and_split(monkeypatch):
    """``ops.mamba_prefill_impl``: "kernels" only for a CUDA input with no
    gradient to keep outside a split.  A CUDA tensor is stood in for by
    patching ``ops._on_cuda``, since this machine has none."""
    x = torch.zeros(1, 2, 4)
    w = torch.zeros(4, 4, requires_grad=True)
    assert ops.mamba_prefill_impl(x, w) == "plain"
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    with torch.no_grad():
        assert ops.mamba_prefill_impl(x, w) == "kernels"
        assert ops.mamba_prefill_impl(x, w, split=True) == "plain"
    assert ops.mamba_prefill_impl(x, w) == "plain"          # under grad
    assert ops.mamba_prefill_impl(x, w.detach()) == "kernels"
    p = {"w": w.detach()}
    assert layers.mamba_prefill_impl(p, x) == "kernels"
    monkeypatch.setattr(shard_ctx, "tp", lambda: object())
    assert layers.mamba_prefill_impl(p, x) == "plain"
    monkeypatch.setattr(shard_ctx, "tp", lambda: None)
    monkeypatch.setattr(shard_ctx, "seq_group", lambda: object())
    assert layers.mamba_prefill_impl(p, x) == "plain"


def _refusals():
    """(wrapper, arguments, message) for every check that precedes the
    device's: CPU tensors, head dims outside ``HEAD_DIMS``, chunks over
    ``MAX_CHUNK``, d_state over ``MAX_STATE``, conv widths over
    ``MAX_CONV``."""
    nh, hd, n, t = 2, 8, 16, 6
    di, f32 = nh * hd, torch.float32
    z = torch.zeros
    dtr, bias, alog = z(B, t, nh), z(nh), z(nh)
    xbc, w, dt = z(B, t, di + 2 * n), z(CW, di + 2 * n), z(B, t, nh)
    states, dacs, h0 = z(B, 1, nh, n, hd), z(B, 1, t, nh), z(B, nh, hd, n)
    y_diag, C, x = z(B, 1, t, di), z(B, 1, t, n), z(B, t, nh, hd)
    y = z(B, t, di)
    big = mp.MAX_CHUNK + 1
    return [
        (mp.ssd_dt, (dtr, bias, alog, 4), "CUDA tensors"),
        (mp.ssd_dt, (z(B, big, nh), bias, alog, big), "chunks of 1 to"),
        (mp.conv, (xbc, w, None, None, dt), {"hd": hd}, "CUDA tensors"),
        (mp.conv, (z(B, t, 24 + 2 * n), w, None, None, z(B, t, 2)),
         {"hd": 12}, "head_dim"),
        (mp.conv, (xbc, z(mp.MAX_CONV + 1, di + 2 * n), None, None, dt),
         {"hd": hd}, "conv width"),
        (mp.chunk_states, (states, dacs, h0), "CUDA tensors"),
        (mp.chunk_states, (z(B, 1, 1, 8, 256), dacs, None), "head_dim"),
        (mp.chunk_states, (z(B, 1, nh, mp.MAX_STATE + 4, hd), dacs, None),
         "d_state"),
        (mp.output, (y_diag, states, dacs, C, x, bias), "CUDA tensors"),
        (mp.output, (z(B, 1, big, di), states, z(B, 1, big, nh),
                     z(B, 1, big, n), z(B, big, nh, hd), bias), "chunk"),
        (mp.output, (z(B, 1, t, nh * 256), z(B, 1, nh, n, 256), dacs, C,
                     z(B, t, nh, 256), bias), "head_dim"),
        (mp.output, (y_diag, z(B, 1, nh, mp.MAX_STATE + 4, hd), dacs,
                     z(B, 1, t, mp.MAX_STATE + 4), x, bias), "d_state"),
        (mp.output, (y_diag, z(B, 1, nh, 18, hd), dacs, z(B, 1, t, 18), x,
                     bias), "multiple"),
        (mp.gated_norm, (y, y, z(di), 1e-5), "CUDA tensors")]


@pytest.mark.parametrize("i", range(len(_refusals())))
def test_the_wrappers_refuse_what_their_kernels_do_not_take(i):
    """Each wrapper raises before any build or launch."""
    fn, args, *rest = _refusals()[i]
    kw, match = (rest[0], rest[1]) if len(rest) == 2 else ({}, rest[0])
    with pytest.raises(ValueError, match=match):
        fn(*args, **kw)
    assert mp.launches == 0
