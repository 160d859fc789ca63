"""The arithmetic of the bf16 flash-attention backward kernel on the CPU.

``csrc/flash_attention_bwd.cu`` runs the FlashAttention-2 backward on wgmma:
P and dS rounded to bf16 for their products, dK and dV summed per split of
the GQA group (``flash_attention.bwd_plan``) into fp32 partials that a
second pass adds in split order, and dQ formed from the rounded dS tiles
over 64-key tiles.  It cannot run here, so ``ref.attention_bwd_split``
models that arithmetic.  These tests hold the model to ``jax.vjp`` of the
JAX package's ``ref.attention_naive`` on the same numpy-seeded inputs: at
the fp32 ``TOL`` of tests/test_kernels.py (2e-5) with its roundings off,
and at ``chip_smoke.py``'s bf16 ``BWD_TOL`` (2e-2) with them on; and they
check the split plan at gemma-2b's and hymba-1.5b's training shapes.  The
kernel itself is held to ``ref.attention_bwd_naive`` and to this model on
the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from test_kernels import SHAPES  # noqa: E402

FP32_TOL, BF16_TOL = 2e-5, 2e-2
# (b, tq, tk, hq, hkv, d, window, causal, bq, bk): test_kernels.py's list,
# gemma-2b's MQA group (8 query heads over 1, head_dim 256) at reduced
# length over several query and key tiles, and hymba-1.5b's group (25 over
# 5, head_dim 64) with a window that masks whole tiles
BWD_SHAPES = SHAPES + [
    (1, 200, 200, 8, 1, 256, None, True, 64, 64),
    (1, 320, 320, 25, 5, 64, 96, True, 64, 64),
]


def _case(shape, seed, dtype):
    b, tq, tk, hq, hkv, d, win, caus, _, _ = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, tq, hq, d), (b, tk, hkv, d), (b, tk, hkv, d),
                      (b, tq, hq, d))]
    ts = [torch.from_numpy(a).to(dtype) for a in arrs]
    lens = [tk] + [max(tk * 2 // 3, 1)] * (b - 1)
    kw = dict(causal=caus, window=win, q_offset=tk - tq,
              lengths=torch.tensor(lens, dtype=torch.int32))
    return ts, kw


def _jax_grads(ts, kw):
    """jax.vjp of the reference's attention_naive at the same values (the
    bf16 inputs exactly, in fp32)."""
    q, k, v, do = (jnp.asarray(x.float().numpy()) for x in ts)
    jkw = {**kw, "lengths": jnp.asarray(kw["lengths"].numpy())}
    _, vjp = jax.vjp(lambda a, b_, c: jref.attention_naive(a, b_, c, **jkw),
                     q, k, v)
    return [np.asarray(g, np.float32) for g in vjp(do)]


def _model(ts, kw, **extra):
    q, k, v, do = ts
    o, lse = ref.attention_lse_naive(q, k, v, **kw)
    return ref.attention_bwd_split(q, k, v, o, lse, do, **kw, **extra)


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_split_model_fp32_matches_jax_vjp(shape):
    ts, kw = _case(shape, 31, torch.float32)
    got = _model(ts, kw, bf16_products=False)
    for g, w in zip(got, _jax_grads(ts, kw)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=FP32_TOL,
                                   rtol=FP32_TOL)


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_split_model_bf16_matches_jax_vjp(shape):
    """With the kernel's bf16 roundings of P and dS, on bf16 inputs and the
    forward's bf16 output, within chip_smoke.py's bf16 BWD_TOL."""
    ts, kw = _case(shape, 32, torch.bfloat16)
    got = _model(ts, kw)
    for g, w in zip(got, _jax_grads(ts, kw)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, atol=BF16_TOL,
                                   rtol=BF16_TOL)


@pytest.mark.parametrize("shape", BWD_SHAPES[-2:] + [SHAPES[1]])
def test_split_count_changes_only_the_sum_order(shape):
    """Every split count of the GQA group gives the one-split answer up to
    fp32 rounding: the splits only reorder dK's and dV's sums."""
    ts, kw = _case(shape, 33, torch.float32)
    g = shape[3] // shape[4]
    one = _model(ts, kw, n_splits=1, bf16_products=False)
    for ns in range(2, g + 1):
        got = _model(ts, kw, n_splits=ns, bf16_products=False)
        for a, w in zip(got, one):
            np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-5,
                                       rtol=1e-5)


def _tiles_reached(tq, tk, causal, window, q_offset):
    """(query tile, key tile) pairs of 64 that hold a pair inside the
    causal and window masks, counted pair by pair."""
    w = 2 ** 30 if window is None else window
    qpos = q_offset + np.arange(tq)[:, None]
    kpos = np.arange(tk)[None, :]
    ok = kpos > qpos - w
    if causal:
        ok &= kpos <= qpos
    nq, nk = -(-tq // 64), -(-tk // 64)
    return [[bool(ok[i * 64:(i + 1) * 64, j * 64:(j + 1) * 64].any())
             for j in range(nk)] for i in range(nq)]


@pytest.mark.parametrize("tag, shape, want", [
    ("gemma-2b", (2, 1024, 1024, 8, 1, 256, None),
     dict(splits=8, blocks=256, partial_bytes=33554432, ds_run=16,
          ds_bytes=33554432, tiles_per_head=136)),
    ("hymba-1.5b", (1, 2048, 2048, 25, 5, 64, 1024),
     dict(splits=5, blocks=800, partial_bytes=26214400, ds_run=17,
          ds_bytes=111411200, tiles_per_head=408)),
])
def test_bwd_plan_at_the_training_shapes(tag, shape, want):
    """gemma-2b: 16 key tiles x 1 kv head x 2 sequences give 32 blocks; no
    divisor of its group of 8 reaches two blocks an SM (264), so each of
    the 8 heads gets its own blocks (256).  hymba-1.5b: 32 x 5 x 1 = 160
    blocks; its group of 5 splits 5 ways (800).  Each query head of a
    sequence reaches the key tiles counted pair by pair."""
    b, t, _, hq, hkv, d, win = shape
    plan = fa.bwd_plan(b, t, t, hq, hkv, d, causal=True, window=win)
    assert plan == want
    reached = _tiles_reached(t, t, True, win, 0)
    assert sum(map(sum, reached)) == plan["tiles_per_head"]
    assert max(map(sum, reached)) == plan["ds_run"]
    assert plan["blocks"] >= fa.BWD_TARGET_BLOCKS or \
        plan["splits"] == hq // hkv


def test_bwd_plan_keeps_one_split_where_kv_heads_fill_the_card():
    """Many kv heads (no GQA) need no split: the kernel writes bf16 dK and
    dV itself, with no partials and no second pass."""
    plan = fa.bwd_plan(4, 2048, 2048, 32, 32, 128)
    assert plan["splits"] == 1 and plan["partial_bytes"] == 0
    assert plan["blocks"] == 32 * 32 * 4


def test_flash_attention_fn_with_the_split_model_matches_autograd():
    """The ``FlashAttentionFn`` the card runs, with the kernel's arithmetic
    as its backward, against torch's autograd of the plain version (fp32,
    roundings off)."""
    shape = BWD_SHAPES[-2]
    (q, k, v, do), kw = _case(shape, 34, torch.float32)
    lens = kw["lengths"]
    qs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = fa.FlashAttentionFn.apply(
        *qs, lens, kw["causal"], kw["window"], kw["q_offset"],
        ref.attention_lse_naive,
        lambda *a, **m: ref.attention_bwd_split(*a, **m,
                                                bf16_products=False))
    got = torch.autograd.grad(out, qs, do)
    ps = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(ref.attention_naive(*ps, **kw), ps, do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=FP32_TOL,
                                   rtol=FP32_TOL)
