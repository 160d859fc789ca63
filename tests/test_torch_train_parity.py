"""The port's training path against the JAX package on the CPU, from the
same numpy inputs and weights: the attention backward's plain version and
``FlashAttentionFn``, ``apply_updates``, the CE losses, ``loss_fn``'s value
and gradients for reduced gemma-2b, gemma3-1b and whisper-tiny, and one
whole ``make_train_step``.

Gradient tolerance.  Both packages compute in bf16 with fp32 norms and
softmax, but XLA fuses elementwise chains (the tanh-GeLU among them) and
rounds once where PyTorch rounds after each op (``ROADMAP.md``, quirks of
the reference), and the 1-ulp differences compound with depth: the worst
leaf's relative-norm error measured 1.47e-2 at 2 layers (reduced gemma-2b,
whisper-tiny's 2 + 2: 2.31e-2 over its two stacks) and 2.6e-2 to 3.8e-2 at
6 layers (gemma3-1b's reduced depth, and gemma-2b cut to 6 layers alike:
depth, not the window, drives it).  So the leaves are held by relative norm
at 2e-2 per two layers of depth: 2e-2 for gemma-2b, 3e-2 for whisper-tiny,
5e-2 for gemma3-1b.  The losses agree to 3.3e-5 relative (held at 1e-3).
Each of the port's variants (remat on and off, ``loss_chunks`` 1 and 8,
``remat_group`` 2) is held to the reference's ``loss_fn`` at its defaults
(remat, 8 chunks), which those variants leave unchanged up to rounding.

A train step's parameter updates are held at 5e-2: AdamW's m/√v divides
each element's gradient by its own running scale, so an element whose
gradient is small against its history moves by an amount that the
gradients' bf16 noise sets, not their size (the reference's own microbatch
test says the same, ``tests/test_training.py``).  Measured: 2.74e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.sharding.plan import SINGLE_POD as JSINGLE_POD  # noqa: E402
from repro.sharding.plan import ShardingPlan as JShardingPlan  # noqa: E402
from repro.training import optimizer as joptim  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (from_jax,  # noqa: E402
                                        opt_state_from_jax)
from repro_torch.sharding.plan import SINGLE_POD, ShardingPlan  # noqa: E402
from repro_torch.training import optimizer as optim  # noqa: E402
from repro_torch.training import train_loop as tl  # noqa: E402
from repro_torch.training import tree  # noqa: E402
from test_kernels import SHAPES  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # test_kernels.py's
GRAD_TOL = {"gemma-2b": 2e-2, "whisper-tiny": 3e-2, "gemma3-1b": 5e-2}
LOSS_RTOL = 1e-3
UPDATE_TOL = 5e-2


def _np(x):
    return np.asarray(x, np.float32)


def _rel(got, want) -> float:
    g, w = _np(got), _np(want)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _torch_leaf(x):
    return np.asarray(x.detach().float())


# --------------------------------------------------------------------------
# Attention backward: the plain version and FlashAttentionFn
# --------------------------------------------------------------------------

def _attn_case(shape, seed, dtype=torch.float32, lens=None):
    b, tq, tk, hq, hkv, d, win, caus, _, _ = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, tq, hq, d), (b, tk, hkv, d), (b, tk, hkv, d),
                      (b, tq, hq, d))]
    if lens is None:
        lens = [tk] + [max(tk * 2 // 3, 1)] * (b - 1)
    kw = dict(causal=caus, window=win, q_offset=tk - tq,
              lengths=torch.tensor(lens, dtype=torch.int32))
    return arrs, [torch.from_numpy(a).to(dtype) for a in arrs], kw


@pytest.mark.parametrize("shape", SHAPES)
def test_attention_bwd_naive_matches_jax_vjp(shape):
    arrs, (q, k, v, do), kw = _attn_case(shape, 7)
    jkw = {**kw, "lengths": jnp.asarray(kw["lengths"].numpy())}
    want = jax.jit(lambda a, b_, c, g: jax.vjp(
        lambda x, y, z: jref.attention_naive(x, y, z, **jkw), a, b_, c)[1](g))(
        *(jnp.asarray(a) for a in arrs))
    o, lse = ref.attention_lse_naive(q, k, v, **kw)
    got = ref.attention_bwd_naive(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=TOL[torch.float32],
                                   rtol=TOL[torch.float32])


@pytest.mark.parametrize("shape", SHAPES)
def test_attention_lse_naive_is_the_rows_logsumexp(shape):
    arrs, (q, k, v, _), kw = _attn_case(shape, 8)
    o, lse = ref.attention_lse_naive(q, k, v, **kw)
    assert torch.equal(o, ref.attention_naive(q, k, v, **kw))
    b, tq, tk, hq, hkv, d, win, caus, _, _ = shape
    qpos = kw["q_offset"] + np.arange(tq)[:, None]
    kpos = np.arange(tk)[None]
    s = np.einsum("bqhd,bkhd->bhqk", arrs[0].astype(np.float64),
                  np.repeat(arrs[1], hq // hkv, axis=2)) / np.sqrt(d)
    for bi in range(b):
        ok = kpos < kw["lengths"][bi].item()
        if caus:
            ok = ok & (kpos <= qpos)
        if win is not None:
            ok = ok & (kpos > qpos - win)
        ok = np.broadcast_to(ok, (tq, tk))
        for h in range(hq):
            for i in range(tq):
                row = s[bi, h, i][ok[i]]
                want = (np.logaddexp.reduce(row) if row.size
                        else ref.NEG_INF)
                assert lse[bi, h, i].item() == pytest.approx(
                    want, rel=1e-5, abs=1e-5)


def _autograd_grads(fn, q, k, v, do):
    qs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = fn(*qs)
    return out, torch.autograd.grad(out, qs, do)


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_attention_fn_on_the_plain_versions_matches_autograd(
        shape, dtype):
    """The ``FlashAttentionFn`` the card runs, with the plain versions in
    its kernels' places, against torch's autograd of the oracle."""
    _, (q, k, v, do), kw = _attn_case(shape, 9, dtype)
    lens, mask = kw["lengths"], {x: kw[x] for x in ("causal", "window",
                                                    "q_offset")}
    out, got = _autograd_grads(
        lambda a, b_, c: fa.FlashAttentionFn.apply(
            a, b_, c, lens, mask["causal"], mask["window"],
            mask["q_offset"], ref.attention_lse_naive,
            ref.attention_bwd_naive), q, k, v, do)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    want_out, want = _autograd_grads(
        lambda a, b_, c: ref.attention_naive(a, b_, c, **kw), q, k, v, do)
    assert torch.equal(out, want_out)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        np.testing.assert_allclose(_torch_leaf(g), _torch_leaf(w),
                                   atol=TOL[dtype], rtol=TOL[dtype])


def test_fully_masked_rows_get_zero_gradients_not_nan():
    """A sequence of length 0 and rows whose window holds no valid key:
    output 0, LSE NEG_INF, and zero gradients, through the plain backward,
    through FlashAttentionFn and through ``ops`` on the CPU."""
    shape = (3, 24, 24, 4, 2, 16, 4, True, 0, 0)
    _, (q, k, v, do), kw = _attn_case(shape, 10, lens=[0, 24, 6])
    o, lse = ref.attention_lse_naive(q, k, v, **kw)
    assert torch.all(o[0] == 0) and torch.all(lse[0] == ref.NEG_INF)
    assert torch.all(lse[2, :, 9:] == ref.NEG_INF)   # qpos - 4 >= 6: none
    grads = ref.attention_bwd_naive(q, k, v, o, lse, do, **kw)
    for fn in (
            lambda a, b_, c: fa.FlashAttentionFn.apply(
                a, b_, c, kw["lengths"], True, 4, 0, ref.attention_lse_naive,
                ref.attention_bwd_naive),
            lambda a, b_, c: ops.flash_attention(a, b_, c, **kw)):
        _, got = _autograd_grads(fn, q, k, v, do)
        for g, w in zip(got, grads):
            assert torch.isfinite(g).all()
            torch.testing.assert_close(g, w, atol=2e-5, rtol=2e-5)
    dq, dk, dv = grads
    assert torch.all(dq[0] == 0) and torch.all(dq[2, 9:] == 0)
    assert torch.all(dk[0] == 0) and torch.all(dv[0] == 0)
    assert torch.all(dk[2, 6:] == 0) and torch.all(dv[2, 6:] == 0)


# --------------------------------------------------------------------------
# The optimizer
# --------------------------------------------------------------------------

def _opt_inputs(seed, state_dtype, master):
    """Params, grads and a mid-run AdamW state (step 5, non-zero moments) as
    numpy; grads large enough that the clip scales them."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 6), "b/w": (7, 5), "b/a": (3,), "c": (2, 3, 4)}

    def draw(scale, uniform=False):
        out: dict = {}
        for path, shape in shapes.items():
            *outer, leaf = path.split("/")
            x = rng.random(shape) if uniform else rng.standard_normal(shape)
            node = out
            for key in outer:
                node = node.setdefault(key, {})
            node[leaf] = (x * scale).astype(np.float32)
        return out

    params, grads, m, v = draw(1.0), draw(3.0), draw(0.1), draw(0.1, True)
    jdt = jnp.bfloat16 if state_dtype == "bfloat16" else jnp.float32
    jstate = joptim.OptState(
        step=jnp.asarray(5, jnp.int32),
        m=jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), m),
        v=jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), v),
        master=(jax.tree.map(jnp.asarray, params) if master else None))
    jparams = jax.tree.map(
        lambda x: jnp.asarray(x).astype(jnp.bfloat16 if master
                                        else jnp.float32), params)
    return jparams, jax.tree.map(jnp.asarray, grads), jstate


@pytest.mark.parametrize("state_dtype,master", [
    ("float32", False), ("bfloat16", False), ("float32", True),
    ("bfloat16", True)])
def test_apply_updates_matches_the_reference(state_dtype, master):
    jparams, jgrads, jstate = _opt_inputs(3, state_dtype, master)
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=50, weight_decay=0.1,
               grad_clip=1.0, state_dtype=state_dtype)
    jp, js, jm = joptim.apply_updates(joptim.OptConfig(**cfg), jparams,
                                      jgrads, jstate)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    params = from_jax(to_np(jparams), device="cpu")
    state = opt_state_from_jax(to_np(jstate), device="cpu")
    p, s, m = optim.apply_updates(optim.OptConfig(**cfg), params,
                                  from_jax(to_np(jgrads), device="cpu"),
                                  state)
    assert float(m["grad_norm"]) > 1.0                  # the clip acted
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-6)
    assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(s.step) == int(js.step) == 6
    for got, want in ((p, jp), (s.m, js.m), (s.v, js.v),
                      (s.master, js.master)):
        for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
            np.testing.assert_allclose(_torch_leaf(g), _np(w), rtol=1e-6,
                                       atol=1e-7)


# --------------------------------------------------------------------------
# Losses and gradients of the models
# --------------------------------------------------------------------------

def _batch(cfg, seed=0, b=2, t=32):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = (rng.standard_normal((b, t // 2, cfg.d_model))
                         * 0.1).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=list(GRAD_TOL))
def pair(request):
    """(aid, port model, port params, jax model, jax params)."""
    aid = request.param
    jmodel = jbuild_model(jget_config(aid).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return aid, build_model(get_config(aid).reduced()), params, jmodel, \
        jparams


def test_ce_losses_match_each_other_and_the_reference():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((2, 12, 50)) * 3).astype(np.float32)
    targets = rng.integers(0, 50, (2, 12)).astype(np.int32)
    got = tl.ce_loss(torch.from_numpy(logits), torch.from_numpy(targets))
    want = jtl.ce_loss(jnp.asarray(logits), jnp.asarray(targets))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    cfg = get_config("gemma-2b").reduced()
    jmodel = jbuild_model(jget_config("gemma-2b").reduced())
    jparams = jmodel.init(jax.random.PRNGKey(2))
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    model = build_model(cfg)
    hidden = (rng.standard_normal((2, 12, cfg.d_model))).astype(np.float32)
    tg = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    h = torch.from_numpy(hidden).to(torch.bfloat16)
    whole = tl.ce_loss(model.unembed_hidden(params, h), torch.from_numpy(tg))
    jwhole = jtl.ce_loss(jmodel.unembed_hidden(
        jparams, jnp.asarray(hidden).astype(jnp.bfloat16)), jnp.asarray(tg))
    assert float(whole) == pytest.approx(float(jwhole), rel=1e-5)
    for chunks in (1, 5, 40):                         # 5 → 4, 40 → 12
        got = tl.chunked_ce_loss(model, params, h, torch.from_numpy(tg),
                                 chunks)
        want = jtl.chunked_ce_loss(
            jmodel, jparams, jnp.asarray(hidden).astype(jnp.bfloat16),
            jnp.asarray(tg), chunks)
        assert float(got) == pytest.approx(float(whole), rel=1e-6)
        assert float(got) == pytest.approx(float(want), rel=1e-5)


LOSS_VARIANTS = {
    "gemma-2b": [dict(remat=False, loss_chunks=1),
                 dict(remat=True, loss_chunks=8),
                 dict(remat=True, remat_group=2, loss_chunks=8)],
    "gemma3-1b": [dict(remat=True, loss_chunks=8)],
    "whisper-tiny": [dict(remat=True, loss_chunks=8),
                     dict(remat=False, loss_chunks=1)]}


def test_loss_and_gradients_match_jax_value_and_grad(pair):
    aid, model, params, jmodel, jparams = pair
    b = _batch(model.cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, jb: jtl.loss_fn(
        jmodel, p, jb)))(jparams, {k: jnp.asarray(x) for k, x in b.items()})
    for kw in LOSS_VARIANTS[aid]:
        ps = tree.map(lambda x: x.detach().requires_grad_(True), params)
        loss = tl.loss_fn(model, ps, {k: torch.from_numpy(x)
                                      for k, x in b.items()}, **kw)
        grads = torch.autograd.grad(loss, tree.leaves(ps))
        assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
        errs = [_rel(_torch_leaf(g), w)
                for g, w in zip(grads, jax.tree.leaves(jgrads))]
        assert max(errs) < GRAD_TOL[aid], (kw, max(errs))


def test_remat_changes_no_value_on_the_port(pair):
    """Remat recomputes the same arithmetic: loss and gradients are equal
    with and without it, whatever the group."""
    aid, model, params, _, _ = pair
    b = {k: torch.from_numpy(x) for k, x in _batch(model.cfg, 1).items()}
    outs = []
    for kw in (dict(remat=False), dict(remat=True),
               dict(remat=True, remat_group=2)):
        ps = tree.map(lambda x: x.detach().requires_grad_(True), params)
        loss = tl.loss_fn(model, ps, b, loss_chunks=4, **kw)
        outs.append((loss, torch.autograd.grad(loss, tree.leaves(ps))))
    for loss, grads in outs[1:]:
        assert torch.equal(loss, outs[0][0])
        for g, w in zip(grads, outs[0][1]):
            assert torch.equal(g, w)


def test_one_train_step_matches_the_reference():
    """Step 2 of gemma-2b from the reference's state after step 1 (non-zero
    moments), the same batch in both packages."""
    aid = "gemma-2b"
    jmodel = jbuild_model(jget_config(aid).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(3))
    cfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jtl.make_train_step(
        jmodel, joptim.OptConfig(**cfg),
        JShardingPlan(arch="t", shape="s", mesh=JSINGLE_POD,
                      global_mode="data", local_layout="x", batch_axes=())))
    b1, b2 = (_batch(jmodel.cfg, s, b=2, t=16) for s in (5, 6))
    jb = {k: jnp.asarray(x) for k, x in b1.items()}
    jp1, js1, _ = jstep(jparams, joptim.init(jparams), jb)
    jp2, js2, jm2 = jstep(jp1, js1, {k: jnp.asarray(x)
                                     for k, x in b2.items()})

    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    params = from_jax(to_np(jp1), device="cpu")
    state = opt_state_from_jax(to_np(js1), device="cpu")
    step = tl.make_train_step(
        build_model(get_config(aid).reduced()), optim.OptConfig(**cfg),
        ShardingPlan(arch="t", shape="s", mesh=SINGLE_POD,
                     global_mode="data", local_layout="x", batch_axes=()))
    p2, s2, m2 = step(params, state, {k: torch.from_numpy(x)
                                      for k, x in b2.items()})
    assert float(m2["loss"]) == pytest.approx(float(jm2["loss"]),
                                              rel=LOSS_RTOL)
    assert float(m2["grad_norm"]) == pytest.approx(float(jm2["grad_norm"]),
                                                   rel=GRAD_TOL[aid])
    assert int(s2.step) == 2
    for got, want in ((s2.m, js2.m), (s2.v, js2.v)):
        for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
            assert _rel(_torch_leaf(g), w) < GRAD_TOL[aid]
    for new, old, jnew, jold in zip(tree.leaves(p2), tree.leaves(params),
                                    jax.tree.leaves(jp2),
                                    jax.tree.leaves(jp1)):
        upd, jupd = _torch_leaf(new - old), _np(jnew) - _np(jold)
        assert _rel(upd, jupd) < UPDATE_TOL
