"""Each plain reference against the program (``repro_torch``) at a
reduced size on the CPU, both computing in fp32; the SSM reference's
quadratic form against the recurrence it stands for; the fp8 control
parting from fp32."""

import contextlib

import pytest
import torch

from bench import spec
from bench.tests import _tiny
from bench.run import arch_config

CELLS = {"moe": "mixtral-8x7b-l8.azconv_c256", "ssm": _tiny.SSM_CELL}


@contextlib.contextmanager
def _fp32_compute():
    from repro_torch.models import layers
    old = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        yield
    finally:
        layers.COMPUTE_DTYPE = old


def _setup(family, seed=3, t=40):
    from repro_torch.models import build_model
    conf = _tiny.cell(CELLS[family]).config
    ref = spec.reference(family)
    gen = torch.Generator().manual_seed(seed)
    params = ref.make_params(conf, gen, "cpu", dtype=torch.float32)
    toks = torch.randint(0, conf["vocab"], (t,),
                         generator=torch.Generator().manual_seed(seed + 1))
    return conf, ref, params, toks, build_model(arch_config(conf))


@pytest.mark.parametrize("family", sorted(CELLS))
def test_reference_equals_the_program_in_fp32(family):
    conf, ref, params, toks, model = _setup(family)
    with torch.no_grad(), _fp32_compute():
        got = model.apply_train(params, {"tokens": toks[None]})[0]
    want = ref.logits(conf, params, toks, 0)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() < 1e-4
    assert ((got - want).norm() / want.norm()).item() < 1e-5


@pytest.mark.parametrize("family", sorted(CELLS))
def test_logits_from_a_start_are_the_tail(family):
    conf, ref, params, toks, _ = _setup(family)
    whole = ref.logits(conf, params, toks, 0)
    tail = ref.logits(conf, params, toks, 25)
    assert torch.allclose(tail, whole[25:], atol=1e-5)


def test_ssd_quadratic_form_is_the_recurrence():
    from bench.reference import ssm
    g = torch.Generator().manual_seed(0)
    t, nh, hd, n = 37, 3, 4, 5
    x = torch.randn(t, nh, hd, generator=g)
    dt = torch.rand(t, nh, generator=g) * 0.3
    A = -torch.rand(nh, generator=g) * 4 - 0.5
    B, C = torch.randn(t, n, generator=g), torch.randn(t, n, generator=g)
    h = torch.zeros(nh, hd, n)
    want = []
    for i in range(t):
        h = h * torch.exp(dt[i] * A)[:, None, None] + \
            (x[i] * dt[i][:, None])[..., None] * B[i]
        want.append(h @ C[i])
    got = ssm.ssd(x, dt, A, B, C, block=8)
    assert torch.allclose(got, torch.stack(want), atol=1e-5)


@pytest.mark.parametrize("family", sorted(CELLS))
def test_fp8_control_parts_from_fp32(family):
    conf, ref, params, toks, _ = _setup(family)
    hi = ref.logits(conf, params, toks, 0)
    lo = ref.logits(conf, params, toks, 0, precision="fp8")
    rel = ((hi - lo).norm() / hi.norm()).item()
    assert 1e-3 < rel < 0.5


def test_make_params_is_the_program_layout():
    from repro_torch.models import build_model
    for family in CELLS:
        conf, ref, params, _, model = _setup(family)
        shapes = model.param_specs()
        flat = {}

        def walk(a, b, path=""):
            assert set(a) == set(b), path
            for k in a:
                if isinstance(a[k], dict):
                    walk(a[k], b[k], f"{path}/{k}")
                else:
                    assert a[k].shape == b[k].shape, f"{path}/{k}"
                    flat[f"{path}/{k}"] = a[k]
        walk(params, shapes)
        assert flat
