"""The SSM and hybrid training path of the port against the JAX package on
the CPU: the SSD intra-chunk pass's backward (``ref.ssd_intra_chunk_bwd``,
the plain version of ``csrc/ssd_intra_chunk_bwd.cu``), ``SSDIntraChunkFn``
(the ``Function`` the card runs, here with the plain versions in the
kernels' places), the whole scan's gradients, and reduced mamba2-780m and
hymba-1.5b through ``loss_fn`` and one ``make_train_step``.

The JAX package has no SSD backward kernel (its Pallas kernel has no reverse
mode): its training differentiates ``ref.ssd_chunked``, which is the oracle
here.

Tolerances.  The plain backward against torch's autograd of
``ref.ssd_intra_chunk``: atol 1e-5 in fp32 (measured: dxdt, dB and dC
equal bit for bit, ddacs 1.9e-6 apart at the serving widths).  The whole
scan against ``jax.vjp`` of ``repro.kernels.ref.ssd_chunked``: atol 1e-4
plus 1e-4 relative, the forward's atol with a relative term for the
gradients of A and dt, which sum over every position and head.  The
models: with both packages computing in fp32 (``_compute_in``), loss and
gradient leaves agree to fp32 accuracy (held at 1e-6 and 1e-4 by relative
norm), which shows that the port computes the reference's gradient; in
bf16, as they ship, the two packages round at other places and their
gradients part by about as much as each parts from the exact one, so each
leaf is held to the reference's own bf16 error (see the tests).
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.sharding.plan import SINGLE_POD as JSINGLE_POD  # noqa: E402
from repro.sharding.plan import ShardingPlan as JShardingPlan  # noqa: E402
from repro.training import optimizer as joptim  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref, ssd_scan  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.models.convert import (from_jax,  # noqa: E402
                                        opt_state_from_jax)
from repro_torch.sharding.plan import SINGLE_POD, ShardingPlan  # noqa: E402
from repro_torch.training import optimizer as optim  # noqa: E402
from repro_torch.training import train_loop as tl  # noqa: E402
from repro_torch.training import tree  # noqa: E402
from test_kernels import SSD_SHAPES  # noqa: E402
from test_torch_train_parity import (LOSS_RTOL, _batch, _np,  # noqa: E402
                                     _rel, _torch_leaf)

BWD_ATOL = 1e-5
SCAN_ATOL = SCAN_RTOL = 1e-4
GRAD_TOL = 2e-2
NOISE_RATIO = 3.0
FP32_LOSS_RTOL, FP32_GRAD_TOL = 1e-6, 1e-4
BF16_MOMENT_TOL = 3e-2
ARCHS = ("mamba2-780m", "hymba-1.5b")
# (b, t, nh, hd, n, chunk): mamba2-780m's widths over a full chunk and a
# 39-token one (a ragged chunk: c = 39), and hymba-1.5b's SSD branch
WIDE = [(1, 128, 48, 64, 128, 128), (1, 39, 48, 64, 128, 128),
        (1, 128, 50, 64, 16, 128)]
# strong decay: A scaled by 20, so that the log-decay cumsum falls far
# enough within a chunk that exp(dacs_i - dacs_j) overflows for j > i
STRONG, STRONG_A = (1, 64, 4, 16, 16, 64), 20.0


def _scan_inputs(seed, b, t, nh, hd, n, a_scale=1.0):
    """(x, dt, A, B, C, D) as numpy, drawn like test_kernels.py's
    ``_mk_ssd``, A multiplied by ``a_scale``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, t, nh, hd)) * 0.5,
            np.log1p(np.exp(rng.standard_normal((b, t, nh)))) * 0.1,
            -np.exp(rng.standard_normal(nh)) * a_scale,
            rng.standard_normal((b, t, n)) * 0.3,
            rng.standard_normal((b, t, n)) * 0.3,
            np.full(nh, 0.1)]
    return [a.astype(np.float32) for a in arrs]


def _pass_inputs(shape, seed, a_scale=1.0):
    """The intra-chunk pass's operands (xdt, dacs, B, C) of a scan input,
    and seeded gradients (dy, dstates) of its two outputs."""
    b, t, nh, hd, n, chunk = shape
    x, dt, A, B, C, _ = map(torch.from_numpy,
                            _scan_inputs(seed, b, t, nh, hd, n, a_scale))
    ops_ = ssd_scan.chunk_operands(x, dt, A, B, C, chunk)
    _, nc, c, _ = ops_[0].shape
    rng = np.random.default_rng(seed + 1)
    dy = torch.from_numpy(rng.standard_normal(
        (b, nc, c, nh * hd)).astype(np.float32))
    dstates = torch.from_numpy(rng.standard_normal(
        (b, nc, nh, n, hd)).astype(np.float32))
    return ops_, dy, dstates


def _plain_fn(xdt, dacs, B, C, *, nh, hd):
    """``SSDIntraChunkFn`` with the plain versions in the kernels' places."""
    return ssd_scan.SSDIntraChunkFn.apply(xdt, dacs, B, C, nh, hd,
                                          ref.ssd_intra_chunk,
                                          ref.ssd_intra_chunk_bwd)


def _autograd(fn, ops_, dy, dstates, nh, hd):
    leaves = [o.clone().requires_grad_(True) for o in ops_]
    y, st = fn(*leaves, nh=nh, hd=hd)
    return (y, st), torch.autograd.grad((y, st), leaves, (dy, dstates))


# --------------------------------------------------------------------------
# The intra-chunk pass's backward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SSD_SHAPES + WIDE)
def test_ssd_intra_chunk_bwd_matches_autograd(shape):
    nh, hd = shape[2], shape[3]
    ops_, dy, dstates = _pass_inputs(shape, 0)
    _, want = _autograd(ref.ssd_intra_chunk, ops_, dy, dstates, nh, hd)
    got = ref.ssd_intra_chunk_bwd(*ops_, dy, dstates, nh=nh, hd=hd)
    for g, w, o in zip(got, want, ops_):
        assert g.shape == o.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=BWD_ATOL)


def test_ssd_intra_chunk_bwd_is_finite_under_strong_decay():
    """The select before the exp: exp(dacs_i - dacs_j) overflows for j > i
    here, and inf * 0 would make the mask's gradient NaN."""
    b, t, nh, hd, n, chunk = STRONG
    ops_, dy, dstates = _pass_inputs(STRONG, 1, STRONG_A)
    dacs = ops_[1]
    assert float((dacs[..., :1, :] - dacs).max()) > 89.0   # exp overflows
    got = ref.ssd_intra_chunk_bwd(*ops_, dy, dstates, nh=nh, hd=hd)
    assert all(torch.isfinite(g).all() for g in got)
    _, want = _autograd(ref.ssd_intra_chunk, ops_, dy, dstates, nh, hd)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=BWD_ATOL)


@pytest.mark.parametrize("used", ["both", "y_diag", "states"])
def test_ssd_intra_chunk_fn_on_the_plain_versions_matches_autograd(used):
    """The ``Function`` the card runs builds a graph and gives autograd's
    gradients, also when only one of its outputs is used."""
    shape = (2, 48, 3, 16, 8, 16)
    nh, hd = shape[2], shape[3]
    ops_, dy, dstates = _pass_inputs(shape, 2)
    if used == "y_diag":
        dstates = torch.zeros_like(dstates)
    elif used == "states":
        dy = torch.zeros_like(dy)
    outs = {}
    for name, fn in (("fn", _plain_fn), ("ref", ref.ssd_intra_chunk)):
        leaves = [o.clone().requires_grad_(True) for o in ops_]
        y, st = fn(*leaves, nh=nh, hd=hd)
        if name == "fn":
            assert type(y.grad_fn).__name__ == "SSDIntraChunkFnBackward"
        loss = ((y * dy).sum() if used != "states" else 0) + \
            ((st * dstates).sum() if used != "y_diag" else 0)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        outs[name] = ((y, st), [torch.zeros_like(o) if g is None else g
                                for g, o in zip(grads, ops_)])
    for g, w in zip(outs["fn"][0], outs["ref"][0]):
        assert torch.equal(g, w)
    for g, w in zip(outs["fn"][1], outs["ref"][1]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=BWD_ATOL)


# --------------------------------------------------------------------------
# The whole scan against jax.vjp of the reference's ssd_chunked
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_h0", "h0"])
@pytest.mark.parametrize("shape", SSD_SHAPES + WIDE[1:2])
def test_ssd_scan_gradients_match_jax_vjp(shape, with_h0):
    """Gradients of x, dt, A, B, C, D (and h0) of ``ssd_scan.ssd`` through
    ``SSDIntraChunkFn`` on the plain versions, against ``jax.vjp`` of
    ``repro.kernels.ref.ssd_chunked``, both outputs' cotangents seeded."""
    b, t, nh, hd, n, chunk = shape
    arrs = _scan_inputs(3, b, t, nh, hd, n)
    rng = np.random.default_rng(4)
    h0 = (rng.standard_normal((b, nh, hd, n)) * 0.1).astype(np.float32)
    dy = rng.standard_normal((b, t, nh, hd)).astype(np.float32)
    dh = rng.standard_normal((b, nh, hd, n)).astype(np.float32)
    if with_h0:
        arrs.append(h0)

    def jfn(*a):
        return jref.ssd_chunked(*a[:6], chunk=chunk,
                                h0=a[6] if with_h0 else None)

    _, vjp = jax.vjp(jfn, *map(jnp.asarray, arrs))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y, h = ssd_scan.ssd(*leaves[:6], chunk=chunk,
                        h0=leaves[6] if with_h0 else None,
                        intra_chunk=_plain_fn)
    got = torch.autograd.grad((y, h), leaves, (torch.from_numpy(dy),
                                               torch.from_numpy(dh)))
    for name, g, w in zip(("x", "dt", "A", "B", "C", "D", "h0"), got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=SCAN_ATOL,
                                   rtol=SCAN_RTOL, err_msg=name)


# --------------------------------------------------------------------------
# Reduced mamba2-780m and hymba-1.5b
# --------------------------------------------------------------------------

def _through_the_function(x, dt, A, B, C, D, *, chunk=128, h0=None):
    """``ops.ssd`` with the intra-chunk pass in ``SSDIntraChunkFn`` on the
    plain versions: the card's route through the scan, on the CPU."""
    return ssd_scan.ssd(x, dt, A, B, C, D, chunk=chunk, h0=h0,
                        intra_chunk=_plain_fn)


@contextlib.contextmanager
def _compute_in(dtype: str):
    """Both packages' compute dtype (the bf16 of their matmul inputs and
    residual stream) switched to fp32 for ``dtype == "fp32"``, in this
    process only: the reference's ``layers.COMPUTE_DTYPE`` and the
    ``jnp.bfloat16`` its forward casts the embedding to, and the port's
    ``layers.COMPUTE_DTYPE``.  Without bf16 rounding the two packages'
    gradients must agree to fp32 accuracy."""
    with pytest.MonkeyPatch.context() as mp:
        if dtype == "fp32":
            mp.setattr(jnp, "bfloat16", jnp.float32)
            mp.setattr(jlayers, "COMPUTE_DTYPE", jnp.float32)
            mp.setattr(layers, "COMPUTE_DTYPE", torch.float32)
        yield


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(aid, port model, port params, jax model, the batch, and the
    reference's (loss, gradient leaves) of ``jax.value_and_grad`` of its
    ``loss_fn`` in bf16 and in fp32)."""
    aid = request.param
    jmodel = jbuild_model(jget_config(aid).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    batch = _batch(jmodel.cfg)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    want = {}
    for dtype in ("bf16", "fp32"):
        with _compute_in(dtype):
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b: jtl.loss_fn(jmodel, p, b)))(jparams, jb)
        want[dtype] = (float(loss), [_np(g) for g in jax.tree.leaves(grads)])
    return aid, build_model(get_config(aid).reduced()), params, batch, want


def _port_loss_and_grads(model, params, batch, dtype):
    with _compute_in(dtype):
        ps = tree.map(lambda x: x.detach().requires_grad_(True), params)
        loss = tl.loss_fn(model, ps, {k: torch.from_numpy(x)
                                      for k, x in batch.items()})
        grads = torch.autograd.grad(loss, tree.leaves(ps))
    return loss.item(), [_torch_leaf(g) for g in grads]


@pytest.mark.parametrize("route", ["ops", "function"])
def test_loss_and_gradients_match_jax_value_and_grad_in_fp32(pair, route,
                                                             monkeypatch):
    """With both packages computing in fp32, ``loss_fn`` (remat, 8-chunk
    CE) and every gradient leaf agree with ``jax.value_and_grad`` of the
    reference's ``loss_fn`` to fp32 accuracy (measured: loss equal, worst
    leaf 1e-5 by relative norm; held at 1e-6 and 1e-4), the SSD through
    ``ops.ssd`` as it is on the CPU (autograd of ``ref.ssd_chunked``) and
    through ``SSDIntraChunkFn`` on the plain versions."""
    _, model, params, batch, want = pair
    if route == "function":
        monkeypatch.setattr(ops, "ssd", _through_the_function)
    loss, grads = _port_loss_and_grads(model, params, batch, "fp32")
    jloss, jgrads = want["fp32"]
    assert loss == pytest.approx(jloss, rel=FP32_LOSS_RTOL)
    errs = [_rel(g, w) for g, w in zip(grads, jgrads)]
    assert max(errs) < FP32_GRAD_TOL, max(errs)


@pytest.mark.parametrize("route", ["ops", "function"])
def test_loss_and_gradients_match_jax_value_and_grad(pair, route,
                                                     monkeypatch):
    """The models as they ship, in bf16: the loss at 1e-3 relative
    (``test_torch_train_parity.py``'s rule), and each gradient leaf no
    further from the exact gradient (the reference's in fp32) than
    ``NOISE_RATIO`` times the reference's own bf16 gradient is, or
    ``GRAD_TOL``.  The two packages round to bf16 at other places, so their
    bf16 gradients part by about as much as each parts from the exact one:
    measured, the port against the reference's bf16 gradient 2.16e-2
    (mamba2-780m) and 9.17e-2 (hymba-1.5b's ``A_log``, a sum over every
    position with heavy cancellation, whose own bf16 error is 3.11e-2).
    Each leaf's ratio to the reference's own bf16 error, measured at this
    fixture's seed: mamba2-780m at most 1.01 (``ln1``, the head), hymba-1.5b
    2.59 on ``A_log``, then 1.14 (``D``) and 1.10 (``dt_bias``), every other
    leaf of both at most 1.10.  Over weight and batch seeds 0-3 every leaf
    stays at or below 1.34 (hymba-1.5b's ``dt_bias`` at seed 3) except that
    one ``A_log``.  ``NOISE_RATIO`` 3.0 is the least round bound above the
    worst ratio seen (2.59), not a multiple of it; the fp32 test above, at
    1e-4, is the parity check, and this one holds the bf16 models to the
    reference's own rounding noise."""
    _, model, params, batch, want = pair
    if route == "function":
        monkeypatch.setattr(ops, "ssd", _through_the_function)
    loss, grads = _port_loss_and_grads(model, params, batch, "bf16")
    jloss, jgrads = want["bf16"]
    _, exact = want["fp32"]
    assert loss == pytest.approx(jloss, rel=LOSS_RTOL)
    for g, w, x in zip(grads, jgrads, exact):
        assert np.isfinite(g).all()
        assert _rel(g, x) <= max(NOISE_RATIO * _rel(w, x), GRAD_TOL), (
            _rel(g, x), _rel(w, x))


def test_the_function_route_equals_autograd_of_the_scan(pair, monkeypatch):
    """On the port alone: the model's gradients through ``SSDIntraChunkFn``
    on the plain versions against torch's autograd of ``ref.ssd_chunked``
    (the same arithmetic, up to fp32 rounding of the backward's sums)."""
    _, model, params, batch, _ = pair
    outs = [_port_loss_and_grads(model, params, batch, "bf16")]
    monkeypatch.setattr(ops, "ssd", _through_the_function)
    outs.append(_port_loss_and_grads(model, params, batch, "bf16"))
    assert outs[1][0] == pytest.approx(outs[0][0], rel=1e-6)
    for g, w in zip(outs[1][1], outs[0][1]):
        assert _rel(g, w) < 1e-2


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_one_train_step_matches_the_reference(dtype):
    """Step 2 of reduced mamba2-780m from the reference's state after step 1
    (non-zero moments), the same batch in both packages, the SSD through
    ``SSDIntraChunkFn`` on the plain versions.  In fp32 compute the
    gradient norm, the moments and the updates agree to 1e-4 by relative
    norm (measured 2.7e-6 and 3.5e-6).  In bf16 the moments carry the
    gradients' bf16 noise (measured 2.73e-2, held at ``BF16_MOMENT_TOL``),
    and the updates are not compared: AdamW divides each element's gradient
    by its own running scale, so the noise of an element whose gradient is
    small reaches its update undamped (measured 9.12e-2 on the embedding,
    where ``test_torch_train_parity.py`` saw 2.74e-2 for gemma-2b)."""
    aid = "mamba2-780m"
    moment_tol = FP32_GRAD_TOL if dtype == "fp32" else BF16_MOMENT_TOL
    jmodel = jbuild_model(jget_config(aid).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(3))
    cfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    b1, b2 = (_batch(jmodel.cfg, s, b=2, t=16) for s in (5, 6))
    with _compute_in(dtype):
        jstep = jax.jit(jtl.make_train_step(
            jmodel, joptim.OptConfig(**cfg),
            JShardingPlan(arch="t", shape="s", mesh=JSINGLE_POD,
                          global_mode="data", local_layout="x",
                          batch_axes=())))
        jp1, js1, _ = jstep(jparams, joptim.init(jparams),
                            {k: jnp.asarray(x) for k, x in b1.items()})
        jp2, js2, jm2 = jstep(jp1, js1, {k: jnp.asarray(x)
                                         for k, x in b2.items()})

    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    params = from_jax(to_np(jp1), device="cpu")
    state = opt_state_from_jax(to_np(js1), device="cpu")
    step = tl.make_train_step(
        build_model(get_config(aid).reduced()), optim.OptConfig(**cfg),
        ShardingPlan(arch="t", shape="s", mesh=SINGLE_POD,
                     global_mode="data", local_layout="x", batch_axes=()))
    with _compute_in(dtype), pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "ssd", _through_the_function)
        p2, s2, m2 = step(params, state, {k: torch.from_numpy(x)
                                          for k, x in b2.items()})
    assert float(m2["loss"]) == pytest.approx(float(jm2["loss"]),
                                              rel=LOSS_RTOL)
    assert float(m2["grad_norm"]) == pytest.approx(float(jm2["grad_norm"]),
                                                   rel=moment_tol)
    assert int(s2.step) == 2
    for got, want in ((s2.m, js2.m), (s2.v, js2.v)):
        for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
            assert _rel(_torch_leaf(g), w) < moment_tol
    for new, old, jnew, jold in zip(tree.leaves(p2), tree.leaves(params),
                                    jax.tree.leaves(jp2),
                                    jax.tree.leaves(jp1)):
        upd, jupd = _torch_leaf(new - old), _np(jnew) - _np(jold)
        assert np.isfinite(upd).all()
        if dtype == "fp32":
            assert _rel(upd, jupd) < FP32_GRAD_TOL
