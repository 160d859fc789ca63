"""The arithmetic of the CUDA SSD intra-chunk kernel on the CPU.

The kernel (``csrc/ssd_intra_chunk.cu``) runs its three products on TF32
tensor cores with every operand split in two (3xTF32).  It cannot run here,
so ``ref.ssd_intra_chunk_tf32`` models its arithmetic: the TF32 rounding of
each operand, the split, and the kernel's 64-row and 32-key tiles.  These
tests hold that model to the Pallas kernel in interpret mode and to the
plain version at test_kernels.py's atol 1e-4, show that a single TF32
product misses that tolerance at serving widths while the split holds it,
and check that strong decay gives no inf or NaN.  The kernel itself is held
to ``ref.ssd_intra_chunk`` on the card by ``chip_smoke.py``.

Inputs follow test_kernels.py's ``_mk_ssd`` distributions, drawn with numpy
as in test_torch_ssd.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ssd_scan as jssd  # noqa: E402
from repro_torch.kernels import ref, ssd_scan  # noqa: E402
from test_kernels import SSD_SHAPES  # noqa: E402
from test_torch_ssd import WIDE  # noqa: E402

ATOL = 1e-4
# (b, t, nh, hd, n, chunk): 512-token prompts at mamba2-780m's and
# hymba-1.5b's SSD widths, as chip_smoke.py times them
SERVING = [(1, 512, 48, 64, 128, 128), (1, 512, 50, 64, 16, 128)]


def _operands(seed, b, t, nh, hd, n, chunk, a_scale=1.0):
    """The intra-chunk pass's operands as ``ssd_scan.ssd`` builds them, from
    numpy-seeded (x, dt, A, B, C); A is multiplied by ``a_scale``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, t, nh, hd)) * 0.5,
            np.log1p(np.exp(rng.standard_normal((b, t, nh)))) * 0.1,
            -np.exp(rng.standard_normal(nh)) * a_scale,
            rng.standard_normal((b, t, n)) * 0.3,
            rng.standard_normal((b, t, n)) * 0.3]
    x, dt, A, B, C = (torch.from_numpy(a.astype(np.float32)) for a in arrs)
    return ssd_scan.chunk_operands(x, dt, A, B, C, chunk)


def _err(got, want) -> tuple[float, float]:
    return tuple(float((g.float() - torch.from_numpy(np.array(w, np.float32))).abs()
                       .max()) for g, w in zip(got, want))


@pytest.mark.parametrize("shape", SSD_SHAPES + WIDE)
def test_split_model_matches_pallas_interpret(shape):
    b, t, nh, hd, n, chunk = shape
    ops = _operands(20, b, t, nh, hd, n, chunk)
    got = ref.ssd_intra_chunk_tf32(*ops, nh=nh, hd=hd)
    want = jssd.ssd_intra_chunk(*(jnp.asarray(o.numpy()) for o in ops),
                                nh=nh, hd=hd, interpret=True)
    assert got[0].shape == ops[0].shape
    assert got[1].shape == (*ops[0].shape[:2], nh, n, hd)
    assert max(_err(got, want)) <= ATOL


@pytest.mark.parametrize("shape", SSD_SHAPES + WIDE)
def test_split_model_matches_plain(shape):
    b, t, nh, hd, n, chunk = shape
    ops = _operands(21, b, t, nh, hd, n, chunk)
    got = ref.ssd_intra_chunk_tf32(*ops, nh=nh, hd=hd)
    want = ref.ssd_intra_chunk(*ops, nh=nh, hd=hd)
    assert got[0].dtype == got[1].dtype == torch.float32
    assert max(_err(got, want)) <= ATOL


@pytest.mark.parametrize("shape", SERVING + WIDE[:1])
def test_single_tf32_misses_and_split_holds(shape):
    """Why the kernel splits: one TF32 product (10 mantissa bits per
    operand) misses atol 1e-4 at serving widths; the 3xTF32 split stays two
    orders of magnitude inside it."""
    b, t, nh, hd, n, chunk = shape
    ops = _operands(22, b, t, nh, hd, n, chunk)
    want = ref.ssd_intra_chunk(*ops, nh=nh, hd=hd)
    single = _err(ref.ssd_intra_chunk_tf32(*ops, nh=nh, hd=hd, split=False),
                  want)
    split = _err(ref.ssd_intra_chunk_tf32(*ops, nh=nh, hd=hd), want)
    assert max(single) > ATOL
    assert max(split) <= ATOL / 100


@pytest.mark.parametrize("shape", [(1, 256, 8, 64, 128, 128),
                                   (1, 200, 6, 32, 16, 64)])
def test_strong_decay_stays_finite(shape):
    """A scaled so that the log-decay cumsum falls far below -100 inside a
    chunk: exp(dacs_i - dacs_j) overflows for j > i, and the select before
    the exp keeps inf * 0 out of the sums."""
    b, t, nh, hd, n, chunk = shape
    ops = _operands(23, b, t, nh, hd, n, chunk, a_scale=20.0)
    assert float(ops[1].min()) < -100
    got = ref.ssd_intra_chunk_tf32(*ops, nh=nh, hd=hd)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert max(_err(got, ref.ssd_intra_chunk(*ops, nh=nh, hd=hd))) <= ATOL
    want = jssd.ssd_intra_chunk(*(jnp.asarray(o.numpy()) for o in ops),
                                nh=nh, hd=hd, interpret=True)
    assert max(_err(got, want)) <= ATOL


def test_tf32_round_is_nearest_ties_away():
    """ref.tf32_round keeps 10 mantissa bits, rounds to nearest with ties
    away from zero (cvt.rna), and the split recovers x to about 2^-22."""
    one = 1.0
    ulp = 2.0 ** -10                       # TF32 spacing in [1, 2)
    x = torch.tensor([one, one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0e-3, -7.5, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([one, one + ulp, -(one + ulp), one, one + ulp],
                        dtype=torch.float32)
    got = ref.tf32_round(x)
    assert torch.equal(got[:5], want)
    bits = got.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    rng = np.random.default_rng(24)
    v = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    big, small = ref.tf32_split(v)
    rel = ((big + small - v).abs() / v.abs()).max()
    assert float(rel) < 2.0 ** -21
    assert float(((ref.tf32_round(v) - v).abs() / v.abs()).max()) <= 2 ** -11


def test_split_model_tiles_cover_ragged_chunks():
    """Chunk lengths that are not multiples of the kernel's 64-row and
    32-key tiles (39, 100) and a one-token chunk give the plain version's
    answer: no row or key is dropped or counted twice at a tile edge."""
    for t, chunk in ((39, 128), (100, 100), (1, 1), (130, 65)):
        ops = _operands(25, 1, t, 3, 16, 8, chunk)
        got = ref.ssd_intra_chunk_tf32(*ops, nh=3, hd=16)
        want = ref.ssd_intra_chunk(*ops, nh=3, hd=16)
        assert max(_err(got, want)) <= 1e-5
