"""MoE training in the port against the JAX package on the CPU: the int8
all-to-all payload (``_quant_i8``, the straight-through round trip
``A2AInt8Fn``), one MoE layer's gradients under the three lowerings
(``moe_ep_a2a`` with a bf16 or an int8 payload, ``moe_dense``), the whole
reduced qwen3-moe-30b-a3b's ``loss_fn`` and its gradients under each
lowering, and five train steps of each.

The reference's grouped step runs under a 1 x 1 ("data", "model") mesh
published with ``shard_ctx.plan_specs`` (EP axis "model" of width 1, so its
all-to-alls are identities); without a mesh it would serve ``moe_dense``.
Inputs are numpy arrays drawn from a seed and handed to both packages; the
weights are the JAX model's, converted with ``from_jax``.

Tolerances.
- ``_quant_i8`` and the round trip: bit for bit (the same fp32 scale, the
  same round half to even).
- One layer's gradients (router, w_gate, w_up, w_down, x) by relative norm
  at ``LAYER_GRAD_TOL`` 1e-2: the reference's own grouped step and dense
  oracle, two bf16 lowerings of one function, part by up to 5.64e-3 (x;
  ``test_layer_tolerances_are_set_from_the_references_own_gaps``), and the
  port meets the reference within 5.79e-3 in every case.  ``Q8_TOL`` 3e-2
  bounds the int8 payload against the bf16 one in the reference (measured
  1.30e-2 and 1.42e-2): four round trips, each within half a step (1/254)
  of its row's largest entry.
- The whole model: the loss at ``LOSS_RTOL`` 1e-3 (test_torch_train_parity's
  rule).  Top-k routing is not continuous, and the two packages' bf16
  activations differ by an ulp here and there, so a token whose k-th and
  (k+1)-th router probabilities nearly tie may be routed apart (measured:
  one or two tokens of 64 in two layers, over weight seeds 0-3; alone they
  move a gradient leaf by up to 1.1e-1).  So the reference's routing is
  recorded, every token the port routes otherwise must be a near tie
  (``NEAR_TIE``, test_torch_moe's), at most two, and the port's gradients
  are taken with the reference's routing replayed (the port's own router
  probabilities at the reference's experts).  Then the leaves agree to
  ``GRAD_TOL`` 2e-2 (test_torch_train_parity's for two layers; measured
  1.49e-2 and 1.55e-2 for "ep_a2a" and "dense"); the int8 payload adds
  rounding at its boundaries, a quotient within an ulp of a half step lands
  on the neighbouring int8 in one package (measured 2.73e-2, held at
  ``Q8_MODEL_TOL`` 4e-2).  With both packages computing in fp32 the leaves
  agree to ``FP32_GRAD_TOL`` 1e-4 (measured 1.5e-6), the int8 payload's to
  ``FP32_Q8_TOL`` 1e-2 (measured 2.2e-3, the same boundary effect).
"""

import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe_ep as jmoe_ep  # noqa: E402
from repro.sharding import ctx as shard_ctx  # noqa: E402
from repro.sharding._compat import shard_map  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe_ep  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.sharding.plan import SINGLE_POD, ShardingPlan  # noqa: E402
from repro_torch.training import optimizer as optim  # noqa: E402
from repro_torch.training import train_loop as tl  # noqa: E402
from repro_torch.training import tree  # noqa: E402
from test_torch_moe import NEAR_TIE  # noqa: E402
from test_torch_train_parity import (LOSS_RTOL, _batch, _rel,  # noqa: E402
                                     _torch_leaf)

ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x7b")
QWEN3 = ARCHS[0]
LEAVES = ("router", "w_gate", "w_up", "w_down")
LAYER_GRAD_TOL = 1e-2
Q8_TOL = 3e-2
GRAD_TOL = 2e-2
Q8_MODEL_TOL = 4e-2
FP32_GRAD_TOL, FP32_Q8_TOL = 1e-4, 1e-2
# capacity factors: 8 and the default 1.25 keep every assignment of the
# layer's 62 tokens x top-2 (cap 992 and 160 >= 124), 0.5 keeps the first
# 64 (the tokens past the 32nd get nothing)
CAPACITY = (8.0, 1.25, 0.5)
LAYER_SHAPE = (2, 31)
# (capacity factor, lowering): the grouped step with each payload at each
# factor, and the dense oracle, which has no capacity
LAYER_CASES = [(cf, dt) for cf in CAPACITY for dt in moe_ep.A2A_DTYPES] \
    + [(None, "dense")]
IMPLS = ("dense", "ep_a2a", "ep_a2a_q8")


def _np(x):
    return np.asarray(x, np.float32)


@contextlib.contextmanager
def _ep_mesh():
    """The reference's grouped step at an EP axis of width 1: a 1 x 1
    ("data", "model") mesh published with EP axis "model" (activations
    replicated: a 1 x 1 mesh shards nothing)."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with shard_ctx.plan_specs(None, None, mesh=mesh, ep_axis="model"):
        yield mesh


@contextlib.contextmanager
def _compute_in(dtype: str):
    """Both packages' compute dtype switched to fp32 for ``dtype ==
    "fp32"`` (test_torch_ssd_train.py's switch): the reference's
    ``jnp.bfloat16`` (which its grouped step casts to) and
    ``COMPUTE_DTYPE``, and the port's ``COMPUTE_DTYPE``."""
    with pytest.MonkeyPatch.context() as mp:
        if dtype == "fp32":
            mp.setattr(jnp, "bfloat16", jnp.float32)
            mp.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
            mp.setattr(L, "COMPUTE_DTYPE", torch.float32)
        yield


# --------------------------------------------------------------------------
# the int8 payload
# --------------------------------------------------------------------------

def _rows(seed=0):
    """(1, 9, 64) rows: one all zero, one with a single large entry, the
    rest normal with a spread of scales."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((1, 9, 64)).astype(np.float32)
    v *= np.exp(rng.standard_normal((1, 9, 1))).astype(np.float32)
    v[0, 3] = 0.0
    v[0, 5] = 1e-3 * rng.standard_normal(64)
    v[0, 5, 17] = 250.0
    return v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_i8_equals_the_reference_bit_for_bit(dtype):
    v = _rows()
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    jv = jnp.asarray(v).astype(getattr(jnp, dtype))
    q, s = moe_ep._quant_i8(tv)
    jq, js = jmoe_ep._quant_i8(jv)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy().view(np.uint32),
                          np.asarray(js).view(np.uint32))
    assert not q[0, 3].any() and int(q[0, 5, 17]) == 127
    assert (q[0, 5] == 0).sum() == 63       # the small entries vanish


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_round_trip_and_its_gradient_equal_jax_vjp(dtype):
    """``A2AInt8Fn`` against ``jax.vjp`` of the reference's ``_a2a_i8``
    inside a shard_map over the 1 x 1 mesh: the forward is the payload's
    round trip and the backward the cotangent's, both in the input's dtype,
    bit for bit."""
    v, g = _rows(1), _rows(2)
    jdt = getattr(jnp, dtype)
    with _ep_mesh() as mesh:
        fn = shard_map(lambda a: jmoe_ep._a2a_i8(a, "model"), mesh=mesh,
                       in_specs=P(), out_specs=P(), check_vma=False)
        jout, vjp = jax.vjp(fn, jnp.asarray(v).astype(jdt))
        (jgrad,) = vjp(jnp.asarray(g).astype(jdt))
    tv = torch.from_numpy(v).to(getattr(torch, dtype)).requires_grad_(True)
    out = moe_ep.A2AInt8Fn.apply(tv)
    (grad,) = torch.autograd.grad(out, tv, torch.from_numpy(g).to(tv.dtype))
    assert out.dtype == grad.dtype == tv.dtype
    assert np.array_equal(_np(out.detach().float()), _np(jout))
    assert np.array_equal(_np(grad.float()), _np(jgrad))
    assert not torch.equal(out.detach(), tv.detach())   # it does round


# --------------------------------------------------------------------------
# one MoE layer's gradients
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _layer(aid):
    """(port cfg, port params, jax cfg, jax params) of layer 0, each arch's
    weights from its own seed; x and the cotangent as numpy."""
    jcfg = jget_config(aid).reduced()
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(ARCHS.index(aid)))
    jp = jax.tree.map(lambda v: v[0], jparams["layers"]["moe"])
    p = from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(10 + ARCHS.index(aid))
    x, ct = (rng.standard_normal((*LAYER_SHAPE, jcfg.d_model)).astype(
        np.float32) for _ in range(2))
    return get_config(aid).reduced(), p, jcfg, jp, x, ct


@functools.lru_cache(maxsize=None)
def _jax_layer_grads(aid, cf):
    """The reference's gradients of <y, ct> (bf16 x and y) with respect to
    (p, x): its grouped step with each payload at capacity factor ``cf``
    under the 1 x 1 mesh, and its dense oracle."""
    _, _, jcfg, jp, x, ct = _layer(aid)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jct = jnp.asarray(ct).astype(jnp.bfloat16).astype(jnp.float32)

    def grad_of(f):
        return jax.grad(lambda p, a: jnp.vdot(
            f(p, a).astype(jnp.float32), jct), argnums=(0, 1))

    def all_grads(p, a):
        out = {dt: grad_of(lambda p_, a_, dt=dt: jmoe_ep.moe_ep_a2a(
            jcfg, p_, a_, capacity_factor=cf, a2a_dtype=dt))(p, a)
            for dt in moe_ep.A2A_DTYPES}
        out["dense"] = grad_of(lambda p_, a_: JL.moe_dense(jcfg, p_, a_))(
            p, a)
        return out

    with _ep_mesh():
        got = jax.jit(all_grads)(jp, jx)
    return {k: {**{n: _np(pg[n]) for n in LEAVES}, "x": _np(xg)}
            for k, (pg, xg) in got.items()}


def _port_layer_grads(aid, cf, impl):
    cfg, p, _, _, x, ct = _layer(aid)
    ps = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xs = torch.from_numpy(x).bfloat16().requires_grad_(True)
    y = (L.moe_dense(cfg, ps, xs) if impl == "dense"
         else moe_ep.moe_ep_a2a(cfg, ps, xs, capacity_factor=cf,
                                a2a_dtype=impl))
    grads = torch.autograd.grad(
        y, [ps[n] for n in LEAVES] + [xs],
        torch.from_numpy(ct).bfloat16())
    return dict(zip(LEAVES + ("x",), (_torch_leaf(g) for g in grads)))


@pytest.mark.parametrize("cf,impl", LAYER_CASES,
                         ids=[f"{i}-cf{c}" for c, i in LAYER_CASES])
@pytest.mark.parametrize("aid", ARCHS)
def test_layer_gradients_match_the_reference(aid, cf, impl):
    """Every leaf within ``LAYER_GRAD_TOL`` of the reference's counterpart
    (its ``moe_ep_a2a`` with the same ``a2a_dtype`` and capacity factor, or
    its ``moe_dense``).  At capacity factor 0.5 a dropped assignment adds
    nothing, forward or backward: the tokens past the kept ones get exactly
    zero gradient in both packages."""
    got = _port_layer_grads(aid, cf, impl)
    want = _jax_layer_grads(aid, cf if cf is not None else 8.0)[impl]
    for n in LEAVES + ("x",):
        assert np.isfinite(got[n]).all(), n
        assert _rel(got[n], want[n]) < LAYER_GRAD_TOL, (n, _rel(got[n],
                                                                want[n]))
    if cf == 0.5:
        cfg = _layer(aid)[0]
        k, t = cfg.moe.top_k, LAYER_SHAPE[0] * LAYER_SHAPE[1]
        kept = moe_ep.capacity(t, k, cf) // k
        assert kept == 32 < t
        for gx in (got["x"], want["x"]):
            flat = gx.reshape(t, -1)
            assert not flat[kept:].any() and flat[:kept].any(-1).all()


@pytest.mark.parametrize("aid", ARCHS)
def test_layer_tolerances_are_set_from_the_references_own_gaps(aid):
    """The reference's own grouped step against its dense oracle (at a
    capacity factor that keeps everything) stays under ``LAYER_GRAD_TOL``
    and above a quarter of it, and its int8 payload against its bf16 one
    under ``Q8_TOL`` and above a sixth of it: the limits are of the size
    of the reference's own bf16 and int8 rounding."""
    want = _jax_layer_grads(aid, 8.0)
    gap = max(_rel(want["bfloat16"][n], want["dense"][n])
              for n in LEAVES + ("x",))
    q8 = max(_rel(want["int8"][n], want["bfloat16"][n])
             for n in LEAVES + ("x",))
    assert LAYER_GRAD_TOL / 4 < gap < LAYER_GRAD_TOL, gap
    assert Q8_TOL / 6 < q8 < Q8_TOL, q8


# --------------------------------------------------------------------------
# the whole model
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _jax_routes():
    """The expert indices of every ``jax.lax.top_k`` the reference runs
    while the block runs (its router, in the dense oracle and in the
    grouped step alike), recorded through ``jax.debug.callback`` in the
    order they run: the forward's layers first, then the remat
    recomputes."""
    calls = []
    real = jax.lax.top_k

    def spy(x, k):
        vals, idx = real(x, k)
        jax.debug.callback(lambda i: calls.append(np.array(i)), idx)
        return vals, idx

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "top_k", spy)
        yield calls
        jax.effects_barrier()


@contextlib.contextmanager
def _replayed(routers: torch.Tensor, routes: list):
    """The port's ``moe_router`` with the reference's experts: each layer
    (told by its slice of the stacked ``routers``) routes to ``routes[i]``
    with the port's own probabilities there, renormalised.  Yields, per
    layer, the port's own indices and its gap between the k-th and (k+1)-th
    probability (the forward's call)."""
    own = {}
    real = L.moe_router
    stride = routers.stride(0) * routers.element_size()

    def spy(spec, router_w, x2d):
        layer = (router_w.data_ptr() - routers.data_ptr()) // stride
        probs = torch.softmax(x2d.float() @ router_w.float(), -1)
        top = probs.detach().topk(spec.top_k + 1, -1).values
        own.setdefault(layer, (real(spec, router_w, x2d)[1],
                               top[:, -2] - top[:, -1]))
        idx = torch.from_numpy(routes[layer]).long()
        vals = probs.gather(-1, idx)
        return vals / vals.sum(-1, keepdim=True).clamp_min(1e-9), idx.int()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "moe_router", spy)
        yield own


@functools.lru_cache(maxsize=None)
def _model():
    """(port model, port params, jax model, jax params, batch) of reduced
    qwen3-moe-30b-a3b."""
    jmodel = jbuild_model(jget_config(QWEN3).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return (build_model(get_config(QWEN3).reduced()), params, jmodel,
            jparams, _batch(jmodel.cfg))


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_gradients_match_jax_value_and_grad(impl, dtype):
    """``loss_fn`` (remat, 8-chunk CE) of reduced qwen3-moe-30b-a3b under
    each lowering against ``jax.value_and_grad`` of the reference's
    ``loss_fn`` with the same ``moe_impl`` ("dense" with no mesh, the
    grouped step under the 1 x 1 mesh): the loss, the near-tie rule on the
    tokens routed apart, and every gradient leaf with the reference's
    routing replayed (see the module's note)."""
    model, params, jmodel, jparams, batch = _model()
    nl = model.cfg.n_layers
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    mesh = contextlib.nullcontext() if impl == "dense" else _ep_mesh()
    with _compute_in(dtype), mesh, _jax_routes() as calls:
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: jtl.loss_fn(jmodel, p, b, moe_impl=impl)))(
            jparams, jb)
        jax.block_until_ready(jgrads)
    assert len(calls) == 2 * nl                  # forward, then recompute
    with _compute_in(dtype), _replayed(params["layers"]["moe"]["router"],
                                       calls[:nl]) as own:
        ps = tree.map(lambda x: x.detach().requires_grad_(True), params)
        loss = tl.loss_fn(model, ps, {k: torch.from_numpy(x)
                                      for k, x in batch.items()},
                          moe_impl=impl)
        grads = torch.autograd.grad(loss, tree.leaves(ps))
    gaps = []
    for layer, (idx, gap) in own.items():
        apart = (np.sort(idx.numpy(), -1) != np.sort(calls[layer], -1)
                 ).any(-1)
        gaps += gap[torch.from_numpy(apart)].tolist()
    assert len(gaps) <= 2 and all(g < NEAR_TIE for g in gaps), gaps
    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
    tol = {("bf16", False): GRAD_TOL, ("bf16", True): Q8_MODEL_TOL,
           ("fp32", False): FP32_GRAD_TOL, ("fp32", True): FP32_Q8_TOL}[
        dtype, impl == "ep_a2a_q8"]
    errs = [_rel(_torch_leaf(g), w)
            for g, w in zip(grads, jax.tree.leaves(jgrads))]
    assert all(np.isfinite(_torch_leaf(g)).all() for g in grads)
    assert max(errs) < tol, max(errs)


@pytest.mark.parametrize("impl", IMPLS)
def test_five_train_steps_lower_the_loss(impl):
    """``make_train_step`` with the plan's ``moe_impl`` on reduced
    qwen3-moe-30b-a3b: five steps on one batch, the loss falls."""
    model, params, _, _, batch = _model()
    step = tl.make_train_step(
        model, optim.OptConfig(lr=5e-3, warmup_steps=1),
        ShardingPlan(arch=QWEN3, shape="smoke", mesh=SINGLE_POD,
                     global_mode="data", local_layout="dp_tp",
                     batch_axes=(), moe_impl=impl))
    params = tree.map(torch.clone, params)
    opt = optim.init(params)
    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    losses = []
    for _ in range(5):
        params, opt, metrics = step(params, opt, tb)
        losses.append(float(metrics["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0], losses
