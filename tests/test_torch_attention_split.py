"""Flash-decoding, the algorithm of the CUDA decode-attention kernels, on the
CPU: ``ref.decode_attention_split`` (fp32 partials per split of each
sequence's valid range, then the combine) against the JAX package's oracle
``decode_attention_naive`` and its Pallas kernel in interpret mode, on the
same numpy-seeded inputs, at the tolerances of tests/test_kernels.py; and
the split plan the wrapper launches with.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attention as jda  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from test_kernels import DECODE_SHAPES  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}

# (b, s, hq, hkv, d, window, bk, lengths): hymba-1.5b's group (G = 5, D =
# 64) windowed; lengths 0, 1, S and exactly one tile; a window whose start
# (200 - 70 = 130) is not on a tile boundary, next to lengths it cuts in
# the middle of the cache
EDGE_SHAPES = [
    (2, 192, 25, 5, 64, 96, 32, [150, 37]),
    (4, 256, 8, 1, 64, None, 64, [0, 1, 256, 32]),
    (4, 128, 12, 3, 32, 40, 32, [0, 1, 128, 32]),
    (3, 256, 8, 2, 16, 70, 64, [200, 71, 69]),
]


def _case(shape, lens, dtype, seed):
    b, s, hq, hkv, d = shape[:5]
    rng = np.random.default_rng(seed)
    tdt, jdt, _ = DTYPES[dtype]
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, 1, hq, d), (b, s, hkv, d), (b, s, hkv, d))]
    lens = np.asarray(lens, np.int32)
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a).astype(jdt) for a in arrs], lens)


def _close(got, want, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _all_cases():
    for shape in DECODE_SHAPES:
        b, s = shape[:2]
        yield shape, [s] + [max(s // 3, 1)] * (b - 1)
    for *shape, lens in EDGE_SHAPES:
        yield tuple(shape), lens


CASES = list(_all_cases())
IDS = [f"{c[0]}-lens{c[1]}" for c in CASES]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_matches_jax_oracle(case, dtype):
    shape, lens = case
    (q, kc, vc), (jq, jkc, jvc), lens = _case(shape, lens, dtype, 11)
    win = shape[5]
    want = jref.decode_attention_naive(jq, jkc, jvc, jnp.asarray(lens),
                                       window=win)
    got = ref.decode_attention_split(q, kc, vc, torch.from_numpy(lens),
                                     window=win)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_matches_pallas_interpret(case, dtype):
    shape, lens = case
    (q, kc, vc), (jq, jkc, jvc), lens = _case(shape, lens, dtype, 12)
    win, bk = shape[5], shape[6]
    want = jda.decode_attention(jq, jkc, jvc, jnp.asarray(lens), window=win,
                                block_k=bk, interpret=True)
    got = ref.decode_attention_split(q, kc, vc, torch.from_numpy(lens),
                                     window=win)
    _close(got, want, dtype)


@pytest.mark.parametrize("n_splits", [1, 2, 5, 64])
def test_any_split_count_gives_the_same_answer(n_splits):
    """The combine is exact up to rounding for any number of splits, more
    splits than tiles (empty splits) included."""
    (q, kc, vc), _, lens = _case((4, 256, 8, 2, 64), [256, 100, 33, 0],
                                 "float32", 13)
    lens = torch.from_numpy(lens)
    want = ref.decode_attention_naive(q, kc, vc, lens, window=120)
    got = ref.decode_attention_split(q, kc, vc, lens, window=120,
                                     n_splits=n_splits)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_combine_of_empty_splits_is_zero_not_nan():
    acc = torch.zeros(2, 3, 4, 16)
    ml = torch.zeros(2, 3, 4, 2)
    ml[..., 0] = ref.NEG_INF
    out = ref.decode_combine(acc, ml)
    assert torch.isfinite(out).all() and (out == 0).all()


@pytest.mark.parametrize("b,hkv,s,window,want", [
    (4, 1, 1024, None, 32),      # gemma-2b in the engine: 128 blocks
    (4, 5, 1024, 1024, 7),       # hymba-1.5b: 140 blocks
    (1, 1, 64, None, 2),         # capped by the tiles of the range
    (4, 1, 1024, 64, 2),         # a window caps it like a short cache
    (132, 1, 4096, None, 1),     # a batch that covers the SMs alone
    (2, 1, 8, 0, 1),             # an empty window still has one split
])
def test_split_plan_from_shapes(b, hkv, s, window, want):
    ns = da.split_plan(b, hkv, s, window)
    assert ns == want
    span = s if window is None else max(1, min(s, window))
    assert ns * da.TILE < span + da.TILE       # no split below one tile
    assert b * hkv * ns >= da.SMS or ns * da.TILE >= span


def test_split_plan_reads_no_lengths():
    """The plan is a function of the shapes: the wrapper calls it before it
    reads anything on the card, and the lengths are not among its inputs."""
    import inspect

    assert list(inspect.signature(da.split_plan).parameters) == [
        "b", "hkv", "s", "window"]


@pytest.mark.parametrize("s,window", [(1024, None), (256, 100), (96, 24),
                                      (64, 1)])
def test_each_valid_key_in_exactly_one_split(s, window):
    for b, hkv in ((4, 1), (1, 1), (4, 5)):
        ns = da.split_plan(b, hkv, s, window)
        for length in range(0, s + 40):
            lo = 0 if window is None else max(0, length - window)
            hi = min(length, s)
            seen = np.zeros(s + 1, np.int64)
            for i in range(ns):
                a, e = da.split_range(length, s, window, ns, i)
                if e > a:
                    assert (a - lo) % da.TILE == 0     # whole tiles from lo
                    seen[a:e] += 1
            assert (seen[lo:hi] == 1).all() if hi > lo else True
            assert seen.sum() == max(0, hi - lo)
