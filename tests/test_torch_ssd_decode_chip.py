"""The SSD decode kernel (``csrc/ssd_decode.cu``) on the card: the state
stepped in place and y against ``ref.ssd_decode_step`` at the serving
shapes, with x, B and C strided views into one conv output as the mixer
passes them; its launch counter; and a granite-shaped 20-layer decode call
through it, one launch a Mamba layer.  Needs an NVIDIA GPU and skips,
deciding inside a fixture, without one.  Imports no JAX, so that it runs
where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ssd_decode_chip.py
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref, ssd_decode  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.telemetry import TelemetryRecorder  # noqa: E402

# (b, nh, hd, n): granite-4.0-h-small's decode at the benchmark's 256 rows,
# mamba2-780m's 48 heads, hymba-1.5b's d_state 16 (50 heads)
SHAPES = {"granite": (256, 128, 64, 128), "mamba2": (64, 48, 64, 128),
          "hymba": (64, 50, 64, 16)}
# The kernel rounds each product and sum of the state as the plain version
# does, so the state matches to the last bit unless exp(dt A) differs by an
# ulp between the kernel's expf and torch's exp: rtol 1e-6 holds one ulp.
STATE_RTOL, STATE_ATOL = 1e-6, 1e-7
# y's sum over n runs in another order (fp32, ~1e-6 relative apart); in
# bf16 that may round to the neighbouring value, one ulp: 2^-8 relative,
# held at 2^-7.
Y_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
Y_ATOL = 1e-5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(shape, dtype, seed):
    """(h, x, dt, A, B, C, D) drawn like tests/test_kernels.py's SSD inputs,
    x, B and C views into one (b, 1, nh*hd + 2n) tensor of ``dtype``."""
    b, nh, hd, n = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*s):
        return torch.randn(s, generator=gen, device="cuda")
    conv_out = torch.cat([rn(b, 1, nh * hd) * 0.5, rn(b, 1, 2 * n) * 0.3],
                         -1).to(dtype)
    xs, B, C = torch.split(conv_out, [nh * hd, n, n], -1)
    x = xs.reshape(b, 1, nh, hd)[:, 0]
    dt = torch.nn.functional.softplus(rn(b, 1, nh))[:, 0] * 0.1
    return (rn(b, nh, hd, n) * 0.1, x, dt, -torch.exp(rn(nh)), B[:, 0],
            C[:, 0], torch.full((nh,), 0.1, device="cuda"))


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(SHAPES))
def test_kernel_steps_the_state_in_place_as_the_plain_version(cuda, case,
                                                              dtype):
    h, x, dt, A, B, C, D = _case(SHAPES[case], dtype, 1)
    assert not x.is_contiguous() and not B.is_contiguous()
    want_y, want_h = ref.ssd_decode_step(h, x, dt, A, B, C, D)
    ptr = h.data_ptr()
    y = ssd_decode.ssd_decode_step_(h, x, dt, A, B, C, D)
    torch.cuda.synchronize()
    assert h.data_ptr() == ptr and y.dtype == dtype
    torch.testing.assert_close(h, want_h, rtol=STATE_RTOL, atol=STATE_ATOL)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=Y_RTOL[dtype],
                               atol=Y_ATOL)


@pytest.mark.chip
def test_one_call_is_one_launch(cuda):
    h, x, dt, A, B, C, D = _case(SHAPES["hymba"], torch.bfloat16, 2)
    n0 = ssd_decode.launches
    ops.ssd_decode_step_(h, x, dt, A, B, C, D)
    torch.cuda.synchronize()
    assert ssd_decode.launches == n0 + 1
    assert ops.ssd_decode_impl(h) == "kernel"


@pytest.mark.chip
def test_a_granite_decode_call_launches_once_a_mamba_layer(cuda):
    """granite-4.0-h-small's first 20 layers (18 Mamba, 2 attention) at its
    mixer and attention widths, the experts cut to 8 of top-2 and the vocab
    to 4096 to keep the test small: one decode call launches the kernel 18
    times, and each decode ``layer.ssm`` span names it."""
    full = get_config("granite-4.0-h-small")
    cfg = dataclasses.replace(
        full, n_layers=20, mixers=full.mixers[:20], vocab=4096,
        moe=dataclasses.replace(full.moe, num_experts=8, top_k=2))
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=torch.bfloat16)
    b = 16
    cache = model.init_cache(b, 64, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, 1), device="cuda",
                                     dtype=torch.int32),
             "lengths": torch.ones(b, dtype=torch.int32, device="cuda")}
    model.apply_decode(params, cache, batch)             # warm
    rec = TelemetryRecorder("ssd_decode_chip")
    n0 = ssd_decode.launches
    logits, _ = model.apply_decode(params, cache, batch, telemetry=rec)
    torch.cuda.synchronize()
    assert ssd_decode.launches - n0 == cfg.n_mixer_layers("M") == 18
    assert bool(torch.isfinite(logits).all())
    impls = [e.attrs.get("impl") for e in rec.events
             if e.kind == "span" and e.name == "layer.ssm"]
    assert impls == ["kernel"] * 18
