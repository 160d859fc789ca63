"""The arithmetic of the CUDA SSD backward kernel on the CPU.

``csrc/ssd_intra_chunk_bwd.cu`` runs every product of the intra-chunk
pass's backward on TF32 tensor cores with each operand split in two
(3xTF32), over 64 x 64 tiles, and sums dW ⊙ L and dB's state term over a
group of heads inside a block (``ssd_scan.bwd_plan``) before the groups are
added.  It cannot run here, so ``ref.ssd_intra_chunk_bwd_tf32`` models its
arithmetic.  These tests hold the model to the plain version
``ref.ssd_intra_chunk_bwd`` and, through the whole scan, to ``jax.vjp`` of
the JAX package's ``ref.ssd_chunked``, at atol 1e-4 (the scan's gradients
also 1e-4 relative, as tests/test_torch_ssd_train.py holds them); show that
a single TF32 product misses 1e-4 at mamba2-780m's widths where the split
holds it; check strong decay; and check the plan at the training shapes.
The kernel itself is held to both on the card by ``chip_smoke.py``.

Inputs are numpy-seeded, as in tests/test_torch_ssd_train.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref, ssd_scan  # noqa: E402
from test_kernels import SSD_SHAPES  # noqa: E402
from test_torch_ssd_train import (STRONG, STRONG_A, WIDE,  # noqa: E402
                                  _pass_inputs, _scan_inputs)

ATOL = 1e-4
SCAN_ATOL = SCAN_RTOL = 1e-4


def _err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


@pytest.mark.parametrize("shape", SSD_SHAPES + WIDE)
def test_bwd_model_matches_plain(shape):
    nh, hd = shape[2], shape[3]
    ops_, dy, dstates = _pass_inputs(shape, 40)
    got = ref.ssd_intra_chunk_bwd_tf32(*ops_, dy, dstates, nh=nh, hd=hd)
    want = ref.ssd_intra_chunk_bwd(*ops_, dy, dstates, nh=nh, hd=hd)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
    assert _err(got, want) <= ATOL


def _model_fn(xdt, dacs, B, C, *, nh, hd):
    """``SSDIntraChunkFn`` with the forward's and the backward's arithmetic
    in the kernels' places."""
    return ssd_scan.SSDIntraChunkFn.apply(
        xdt, dacs, B, C, nh, hd, ref.ssd_intra_chunk_tf32,
        ref.ssd_intra_chunk_bwd_tf32)


@pytest.mark.parametrize("shape", SSD_SHAPES + WIDE[1:2])
def test_scan_gradients_through_the_model_match_jax_vjp(shape):
    """Gradients of x, dt, A, B, C, D and h0 of ``ssd_scan.ssd`` with the
    kernels' arithmetic in the intra-chunk pass, against ``jax.vjp`` of
    ``repro.kernels.ref.ssd_chunked``."""
    b, t, nh, hd, n, chunk = shape
    arrs = _scan_inputs(41, b, t, nh, hd, n)
    rng = np.random.default_rng(42)
    arrs.append((rng.standard_normal((b, nh, hd, n)) * 0.1)
                .astype(np.float32))
    dy = rng.standard_normal((b, t, nh, hd)).astype(np.float32)
    dh = rng.standard_normal((b, nh, hd, n)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jref.ssd_chunked(*a[:6], chunk=chunk,
                                                 h0=a[6]),
                     *map(jnp.asarray, arrs))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y, h = ssd_scan.ssd(*leaves[:6], chunk=chunk, h0=leaves[6],
                        intra_chunk=_model_fn)
    got = torch.autograd.grad((y, h), leaves, (torch.from_numpy(dy),
                                               torch.from_numpy(dh)))
    for name, g, w in zip(("x", "dt", "A", "B", "C", "D", "h0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   atol=SCAN_ATOL, rtol=SCAN_RTOL,
                                   err_msg=name)


def test_single_tf32_misses_and_split_holds():
    """Why the kernel splits: at mamba2-780m's widths one TF32 product (10
    mantissa bits per operand) misses atol 1e-4; the 3xTF32 split holds it
    four times inside (1.9e-5 measured: dxdt reaches 10, so that is about
    2e-6 relative)."""
    shape = WIDE[0]
    nh, hd = shape[2], shape[3]
    ops_, dy, dstates = _pass_inputs(shape, 43)
    want = ref.ssd_intra_chunk_bwd(*ops_, dy, dstates, nh=nh, hd=hd)
    single = ref.ssd_intra_chunk_bwd_tf32(*ops_, dy, dstates, nh=nh, hd=hd,
                                          split=False)
    split = ref.ssd_intra_chunk_bwd_tf32(*ops_, dy, dstates, nh=nh, hd=hd)
    assert _err(single, want) > ATOL
    assert _err(split, want) <= ATOL / 4


def test_bwd_model_is_finite_under_strong_decay():
    """exp(dacs_i - dacs_j) overflows for j > i here; the select before the
    exp keeps inf * 0 out of W, G and the mask's gradient."""
    nh, hd = STRONG[2], STRONG[3]
    ops_, dy, dstates = _pass_inputs(STRONG, 44, STRONG_A)
    assert float((ops_[1][..., :1, :] - ops_[1]).max()) > 89.0
    got = ref.ssd_intra_chunk_bwd_tf32(*ops_, dy, dstates, nh=nh, hd=hd)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    want = ref.ssd_intra_chunk_bwd(*ops_, dy, dstates, nh=nh, hd=hd)
    assert _err(got, want) <= ATOL


@pytest.mark.parametrize("gh", [1, 2, 3, 8])
def test_head_groups_change_only_the_sum_order(gh):
    """Any head group (a ragged last group included: 8 heads in groups of
    3) gives the one-head-a-group answer up to fp32 rounding."""
    shape = (1, 130, 8, 16, 70, 64)
    nh, hd = shape[2], shape[3]
    ops_, dy, dstates = _pass_inputs(shape, 45)
    one = ref.ssd_intra_chunk_bwd_tf32(*ops_, dy, dstates, nh=nh, hd=hd,
                                       heads_per_group=1)
    got = ref.ssd_intra_chunk_bwd_tf32(*ops_, dy, dstates, nh=nh, hd=hd,
                                       heads_per_group=gh)
    assert _err(got, one) <= 1e-5


@pytest.mark.parametrize("tag, shape, want", [
    ("mamba2-780m", (2, 8, 128, 48, 128),
     dict(heads_per_group=3, groups=16, blocks=256, scores_bytes=786432,
          ds_bytes=12582912, r_bytes=16777216)),
    ("hymba-1.5b", (1, 16, 128, 50, 16),
     dict(heads_per_group=4, groups=13, blocks=208, scores_bytes=786432,
          ds_bytes=10223616, r_bytes=6815744)),
])
def test_bwd_plan_at_the_training_shapes(tag, shape, want):
    """One round of resident blocks (two an SM at head_dim 64) at both
    shapes, with the fewest heads a block can walk there (mamba2-780m: 2
    heads a group would take two rounds of 384 blocks, 4 head-times; 3
    take one of 256), and the scratches below the per-head ones they
    replace: dW ⊙ L and the state term, (b, nc, nh, c, c) and
    (b, nc, nh, c, n) fp32."""
    b, nc, c, nh, n = shape
    plan = ssd_scan.bwd_plan(b, nc, c, nh, n, 64)
    assert plan == want
    assert plan["blocks"] <= 2 * ssd_scan.SMS
    per_head = 4 * b * nc * nh * c * (c + n)
    assert plan["ds_bytes"] + plan["r_bytes"] < per_head / 2


def test_bwd_plan_groups_heads_when_one_round_cannot_hold_them():
    """A long batch: 3072 one-head blocks would take 12 rounds; 12 heads a
    group fill one round of 256 blocks in as many head-times, with a
    twelfth of the scratch."""
    plan = ssd_scan.bwd_plan(4, 16, 128, 48, 128, 64)
    assert plan["heads_per_group"] == 12 and plan["blocks"] == 256
