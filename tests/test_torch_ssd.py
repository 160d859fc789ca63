"""The port's SSD functions against the JAX package on the CPU: the plain
versions (``ssd_naive``, ``ssd_chunked``, ``ssd_decode_step``,
``ssd_intra_chunk``), the ``ssd_scan.ssd`` wrapper's own PyTorch code run
with the plain intra-chunk pass, and the ``ops`` dispatch.

Inputs follow test_kernels.py's ``_mk_ssd`` distributions, drawn with numpy
and handed to both packages.  Tolerances are test_kernels.py's: atol 1e-4,
and 1e-5 for the decode step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ssd_scan as jssd  # noqa: E402
from repro_torch.kernels import ops, ref, ssd_scan  # noqa: E402
from test_kernels import SSD_SHAPES  # noqa: E402

ATOL, DECODE_ATOL = 1e-4, 1e-5
# (b, t, nh, hd, n, chunk) at the serving widths: mamba2-780m with one full
# chunk and with a 39-token prompt's short chunk, hymba-1.5b's SSD branch
WIDE = [(1, 128, 48, 64, 128, 128), (1, 39, 48, 64, 128, 128),
        (1, 128, 50, 64, 16, 128)]


def _inputs(seed, b, t, nh, hd, n):
    """(x, dt, A, B, C, D) as torch tensors and as jax arrays."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, t, nh, hd)) * 0.5,
            np.log1p(np.exp(rng.standard_normal((b, t, nh)))) * 0.1,
            -np.exp(rng.standard_normal(nh)),
            rng.standard_normal((b, t, n)) * 0.3,
            rng.standard_normal((b, t, n)) * 0.3,
            np.full(nh, 0.1)]
    arrs = [a.astype(np.float32) for a in arrs]
    return ([torch.from_numpy(a) for a in arrs],
            [jnp.asarray(a) for a in arrs])


def _h0(seed, b, nh, hd, n):
    a = (np.random.default_rng(seed).standard_normal((b, nh, hd, n)) * 0.1
         ).astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


def _close_pair(got, want, atol=ATOL):
    _close(got[0], want[0], atol)
    _close(got[1], want[1], atol)


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_naive_matches_jax(shape):
    b, t, nh, hd, n, _ = shape
    targs, jargs = _inputs(0, b, t, nh, hd, n)
    _close_pair(ref.ssd_naive(*targs), jref.ssd_naive(*jargs))


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_chunked_matches_jax(shape):
    b, t, nh, hd, n, chunk = shape
    targs, jargs = _inputs(1, b, t, nh, hd, n)
    _close_pair(ref.ssd_chunked(*targs, chunk=chunk),
                jref.ssd_chunked(*jargs, chunk=chunk))


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_chunked_matches_naive(shape):
    """test_kernels.py::test_ssd_chunked_vs_naive on the port alone."""
    b, t, nh, hd, n, chunk = shape
    targs, _ = _inputs(2, b, t, nh, hd, n)
    y0, h0 = ref.ssd_naive(*targs)
    y1, h1 = ref.ssd_chunked(*targs, chunk=chunk)
    _close_pair((y1, h1), (y0.numpy(), h0.numpy()))


def _intra_inputs(seed, b, t, nh, hd, n, chunk):
    """The intra-chunk pass's operands as ``ssd`` builds them (padded to
    whole chunks of min(chunk, t)), as torch tensors and jax arrays."""
    (x, dt, A, B, C, _), _ = _inputs(seed, b, t, nh, hd, n)
    ops_ = ssd_scan.chunk_operands(x, dt, A, B, C, chunk)
    return ops_, [jnp.asarray(o.numpy()) for o in ops_]


@pytest.mark.parametrize("shape", SSD_SHAPES + WIDE)
def test_ssd_intra_chunk_matches_pallas_interpret(shape):
    """The kernel's plain version against the TPU kernel itself, on the same
    (xdt, dacs, B, C), chunk lengths 4 to 128 and a padded last chunk."""
    b, t, nh, hd, n, chunk = shape
    tops, jops = _intra_inputs(3, b, t, nh, hd, n, chunk)
    got = ref.ssd_intra_chunk(*tops, nh=nh, hd=hd)
    want = jssd.ssd_intra_chunk(*jops, nh=nh, hd=hd, interpret=True)
    assert got[0].dtype == got[1].dtype == torch.float32
    assert got[1].shape == (*tops[0].shape[:2], nh, n, hd)
    _close_pair(got, want)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_wrapper_matches_pallas_interpret(shape, with_h0):
    """The wrapper's own PyTorch code (pad, casts, cumsum, the inter-chunk
    recurrence, y_off, the D skip) around the plain intra-chunk pass,
    against the JAX wrapper around the TPU kernel."""
    b, t, nh, hd, n, chunk = shape
    targs, jargs = _inputs(4, b, t, nh, hd, n)
    th0, jh0 = _h0(5, b, nh, hd, n) if with_h0 else (None, None)
    got = ssd_scan.ssd(*targs, chunk=chunk, h0=th0,
                       intra_chunk=ref.ssd_intra_chunk)
    want = jssd.ssd(*jargs, chunk=chunk, h0=jh0, interpret=True)
    _close_pair(got, want)


@pytest.mark.parametrize("backend", ["blocked", "naive"])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ops_ssd_cpu_matches_jax(shape, backend):
    b, t, nh, hd, n, chunk = shape
    targs, jargs = _inputs(6, b, t, nh, hd, n)
    th0, jh0 = _h0(7, b, nh, hd, n)
    ops.set_backend(backend)
    try:
        got = ops.ssd(*targs, chunk=chunk, h0=th0)
    finally:
        ops.set_backend("blocked")
    want = (jref.ssd_naive(*jargs, h0=jh0) if backend == "naive" else
            jref.ssd_chunked(*jargs, chunk=chunk, h0=jh0))
    _close_pair(got, want)
    assert ssd_scan.launches == 0              # CPU tensors never launch


def test_ssd_decode_step_matches_jax():
    b, nh, hd, n = 2, 4, 8, 16
    (x, dt, A, B, C, D), (jx, jdt, jA, jB, jC, jD) = _inputs(8, b, 1, nh,
                                                             hd, n)
    th, jh = _h0(9, b, nh, hd, n)
    got = ops.ssd_decode_step(th, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D)
    want = jref.ssd_decode_step(jh, jx[:, 0], jdt[:, 0], jA, jB[:, 0],
                                jC[:, 0], jD)
    _close_pair(got, want, DECODE_ATOL)


def test_ssd_decode_matches_scan_tail():
    """test_kernels.py::test_ssd_decode_matches_scan_tail on the port."""
    b, t, nh, hd, n = 2, 48, 4, 8, 16
    (x, dt, A, B, C, D), _ = _inputs(10, b, t, nh, hd, n)
    y_full, h_full = ref.ssd_naive(x, dt, A, B, C, D)
    _, h_prefix = ref.ssd_naive(x[:, :-1], dt[:, :-1], A, B[:, :-1],
                                C[:, :-1], D)
    y_last, h_last = ops.ssd_decode_step(h_prefix, x[:, -1], dt[:, -1], A,
                                         B[:, -1], C[:, -1], D)
    _close_pair((y_last, h_last), (y_full[:, -1].numpy(), h_full.numpy()),
                DECODE_ATOL)


def test_ssd_state_carry_composes():
    """Chunked prefill of [0:t1] then [t1:t] == one pass (h0 handoff), for
    the plain version and for the wrapper's own code."""
    b, t, nh, hd, n, t1 = 1, 64, 2, 8, 8, 32
    (x, dt, A, B, C, D), _ = _inputs(11, b, t, nh, hd, n)
    for fn in (ref.ssd_chunked,
               lambda *a, **k: ssd_scan.ssd(
                   *a, intra_chunk=ref.ssd_intra_chunk, **k)):
        y_full, h_full = fn(x, dt, A, B, C, D, chunk=16)
        y1, h1 = fn(x[:, :t1], dt[:, :t1], A, B[:, :t1], C[:, :t1], D,
                    chunk=16)
        y2, h2 = fn(x[:, t1:], dt[:, t1:], A, B[:, t1:], C[:, t1:], D,
                    chunk=16, h0=h1)
        _close_pair((torch.cat([y1, y2], 1), h2),
                    (y_full.numpy(), h_full.numpy()))


def test_ssd_keeps_bf16_activations():
    """bf16 x comes back in bf16 with an fp32 state, as the model needs."""
    (x, dt, A, B, C, D), _ = _inputs(12, 1, 20, 2, 8, 4)
    y, h = ops.ssd(x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16(), D,
                   chunk=8)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y, h = ops.ssd_decode_step(h, x[:, 0].bfloat16(), dt[:, 0], A,
                               B[:, 0].bfloat16(), C[:, 0].bfloat16(), D)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32


def test_ssd_intra_chunk_wrapper_rejects_cpu_tensors():
    """The wrapper launches its kernel or raises, before any build; the
    scan with its default intra-chunk pass does the same."""
    (x, dt, A, B, C, D), _ = _inputs(13, 1, 16, 2, 8, 4)
    tops, _ = _intra_inputs(13, 1, 16, 2, 8, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan.ssd_intra_chunk(*tops, nh=2, hd=8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan.ssd(x, dt, A, B, C, D, chunk=8)
    assert ssd_scan.launches == 0
