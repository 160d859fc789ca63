"""The routed MoE step on the card at the benchmark cell's widths
(mixtral-8x7b: d 4096, 8 experts of 14336, top-2): once warm, it makes no
host synchronisation (``torch.cuda.set_sync_debug_mode("error")`` raises
on one), and its output is the dense oracle's at the bf16 tolerance.
Needs an NVIDIA GPU and skips, deciding inside a fixture, without one.
Imports no JAX, so that it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider tests/test_torch_moe_routed_chip.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe_ep  # noqa: E402

# (B, T): prompts of 256, 1024 and 4096 tokens (2·T rows over 8 experts),
# a decode step over 256 rows (512 rows)
SHAPES = {"prefill_256": (1, 256), "prefill_1024": (1, 1024),
          "prefill_4096": (1, 4096), "decode_256": (256, 1)}
BF16_TOL = 2e-2          # tests/test_kernels.py::TOL for bf16


@pytest.fixture(scope="module")
def layer():
    """One full-width mixtral MoE layer on the card, N(0, 1/fan_in) bf16
    weights with the fan-in the second-last axis."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = get_config("mixtral-8x7b")
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    gen = torch.Generator(device="cuda").manual_seed(0)

    def w(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                / shape[-2] ** 0.5).bfloat16()
    return cfg, {"router": w(d, e), "w_gate": w(e, d, f),
                 "w_up": w(e, d, f), "w_down": w(e, f, d)}


@pytest.mark.chip
@pytest.mark.parametrize("case", list(SHAPES))
def test_routed_step_makes_no_host_sync_at_the_cells_shapes(layer, case):
    cfg, p = layer
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((*SHAPES[case], cfg.d_model), generator=gen,
                    device="cuda").bfloat16()
    moe_ep.moe_routed(cfg, p, x)                # warm: handles, workspaces
    torch.cuda.synchronize()
    c0 = moe_ep.calls
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe_ep.moe_routed(cfg, p, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert moe_ep.calls == c0 + 1
    want = L.moe_dense(cfg, p, x)
    assert got.dtype == x.dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL,
                               rtol=BF16_TOL)
