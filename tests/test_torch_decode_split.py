"""Decode attention at a rank's share of a cache split along the sequence,
on the CPU: the plain versions the tensor-parallel decode runs there
(``ref.decode_attention_naive`` and ``ref.decode_attention_split`` with
``k_offset`` and the log-sum-exp output, then ``ref.decode_merge`` over
the shares) against the JAX package's ``decode_attention_naive`` on the
whole cache, on the same numpy-seeded inputs, at tests/test_kernels.py's
tolerances.  Windowed and not, GQA and MQA, shares with no valid key, and
lengths at the shares' boundaries.  Also the abstract path the dry-run's
fake tensors take through ``ops``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from test_kernels import TOL as JTOL  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}

# (b, s, hq, hkv, d, window, shares, lengths): MQA at gemma's 8/1 group;
# GQA; a window that leaves most shares empty; lengths 1, at a share's
# first row (s/shares + 1), at its last (s/shares), and the whole cache
CASES = [
    (4, 64, 8, 1, 32, None, 4, [64, 17, 16, 1]),
    (4, 64, 8, 1, 32, 12, 4, [64, 17, 16, 1]),
    (3, 96, 12, 4, 16, None, 3, [33, 32, 96]),
    (3, 96, 12, 4, 16, 20, 3, [33, 32, 96]),
    (2, 128, 4, 2, 64, 9, 8, [128, 50]),
    (2, 64, 6, 6, 16, None, 2, [0, 31]),
]


def _inputs(case, dtype, seed):
    b, s, hq, hkv, d = case[:5]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, 1, hq, d), (b, s, hkv, d), (b, s, hkv, d))]
    tdt, jdt = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a).astype(jdt) for a in arrs],
            np.asarray(case[7], np.int32))


def _shares(case, q, k, v, lens, split: bool):
    """Every share's (out, lse), stacked as the ranks' gather gives them."""
    s, window, n = case[1], case[5], case[6]
    m = s // n
    outs, lses = [], []
    for r in range(n):
        fn = ref.decode_attention_split if split else \
            ref.decode_attention_naive
        o, lse = fn(q, k[:, r * m:(r + 1) * m], v[:, r * m:(r + 1) * m],
                    torch.from_numpy(lens), window=window, k_offset=r * m,
                    return_lse=True)
        outs.append(o[:, 0])
        lses.append(lse)
    return torch.stack(outs, 2), torch.stack(lses, 2)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("split", [False, True], ids=["naive", "split"])
@pytest.mark.parametrize("case", CASES, ids=range(len(CASES)))
def test_merged_shares_equal_the_whole_cache(case, split, dtype):
    (q, k, v), (jq, jk, jv), lens = _inputs(case, dtype, 0)
    outs, lses = _shares(case, q, k, v, lens, split)
    got = ref.decode_merge(outs, lses)
    want = jref.decode_attention_naive(jq, jk, jv, jnp.asarray(lens),
                                       window=case[5])
    tol = JTOL[DTYPES[dtype][1]]
    assert got.shape == q.shape and got.dtype == q.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    # a length-0 row has no key anywhere: 0, never NaN
    for i, n in enumerate(lens):
        if n == 0:
            assert not got[i].float().abs().any()


@pytest.mark.parametrize("case", CASES, ids=range(len(CASES)))
def test_share_lse_and_empty_shares(case):
    """Each share's log-sum-exp is the log of its softmax denominator over
    its valid keys (fp32), NEG_INF exactly where the share holds none; the
    split algorithm gives the same."""
    (q, k, v), _, lens = _inputs(case, "float32", 1)
    b, s, hq, hkv, d, window, n, _ = case
    m = s // n
    g = hq // hkv
    for r in range(n):
        ks = k[:, r * m:(r + 1) * m]
        _, lse = ref.decode_attention_naive(
            q, ks, v[:, r * m:(r + 1) * m], torch.from_numpy(lens),
            window=window, k_offset=r * m, return_lse=True)
        _, lse2 = ref.decode_attention_split(
            q, ks, v[:, r * m:(r + 1) * m], torch.from_numpy(lens),
            window=window, k_offset=r * m, return_lse=True)
        pos = r * m + np.arange(m)
        for bi, length in enumerate(lens):
            lo = 0 if window is None else length - window
            valid = (pos < length) & (pos >= lo)
            for h in range(hq):
                if not valid.any():
                    assert lse[bi, h] == ref.NEG_INF
                    assert lse2[bi, h] == ref.NEG_INF
                    continue
                sc = (ks[bi, valid, h // g].double()
                      @ q[bi, 0, h].double()) / np.sqrt(d)
                want = float(torch.logsumexp(sc, 0))
                np.testing.assert_allclose(float(lse[bi, h]), want,
                                           rtol=1e-5, atol=1e-5)
                np.testing.assert_allclose(float(lse2[bi, h]), want,
                                           rtol=1e-5, atol=1e-5)


def test_split_range_with_an_offset():
    """The share's valid range is the global one shifted and clamped; its
    splits tile it in whole tiles and cover it exactly."""
    s, ns = 96, 3
    for length in (0, 1, 95, 96, 97, 200, 300):
        for window in (None, 10, 64):
            for off in (0, 96, 192):
                lo = 0 if window is None else max(0, length - window)
                want = set(range(max(lo - off, 0), min(max(length - off, 0),
                                                        s)))
                got = set()
                for i in range(ns):
                    a, e = da.split_range(length, s, window, ns, i, off)
                    assert a >= 0 and e <= s
                    got |= set(range(a, e))
                assert got == want, (length, window, off)


def test_fake_tensors_take_the_abstract_path(monkeypatch):
    """Under FakeTensorMode ``ops.decode_attention`` allocates what the
    kernels allocate and counts their FLOPs; the plain version (an fp32
    copy of the cache) is never called."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def boom(*a, **k):
        raise AssertionError("the plain version ran on fake tensors")
    monkeypatch.setattr(ref, "decode_attention_naive", boom)
    monkeypatch.setattr(ref, "decode_merge", boom)
    b, s, hq, hkv, d = 128, 4096, 8, 1, 256
    da.abstract_flops = 0.0
    with FakeTensorMode():
        q = torch.empty((b, 1, hq, d), dtype=torch.bfloat16)
        k = torch.empty((b, s, hkv, d), dtype=torch.bfloat16)
        lens = torch.empty((b,), dtype=torch.int32)
        out, lse = ops.decode_attention(q, k, k, lens, window=None,
                                        k_offset=4096, return_lse=True)
        assert out.shape == (b, 1, hq, d) and out.dtype == torch.bfloat16
        assert lse.shape == (b, hq) and lse.dtype == torch.float32
        merged = ops.decode_merge(torch.empty((b, hq, 8, d),
                                              dtype=torch.bfloat16),
                                  torch.empty((b, hq, 8)))
        assert merged.shape == (b, 1, hq, d)
        win = ops.decode_attention(q, k, k, lens, window=512)
        assert win.shape == (b, 1, hq, d)
    assert da.abstract_flops == (4.0 * b * hq * d * (s + 512)
                                 + 3.0 * b * hq * 8 * d)


def _row_rel(got, want):
    g = got.float().flatten(0, -2)
    w = want.float().flatten(0, -2)
    return ((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max()


@pytest.mark.parametrize("window", [None, 512], ids=["full", "window512"])
def test_row_limit_separates_the_merge_from_its_faults(window):
    """chip_smoke's per-row limit on merged shares (``TP_ROW_RTOL``), at
    gemma-2b's heads (8/1, D=256) over 8 shares of a bf16 cache with random
    lengths: the plain merge lies within it of the JAX oracle on the whole
    cache, while a share's rows offset by one key, or a share left out,
    put a row outside it."""
    import chip_smoke
    b, s, hq, hkv, d, n = 8, 8192, 8, 1, 256, 8
    case = (b, s, hq, hkv, d, window, n,
            np.random.default_rng(3).integers(1, s + 1, b).tolist())
    (q, k, v), (jq, jk, jv), lens = _inputs(case, "bfloat16", 4)
    want = torch.from_numpy(np.asarray(jref.decode_attention_naive(
        jq.astype(jnp.float32), jk.astype(jnp.float32),
        jv.astype(jnp.float32), jnp.asarray(lens), window=window)))
    limit = chip_smoke.TP_ROW_RTOL
    outs, lses = _shares(case, q, k, v, lens, False)
    assert _row_rel(ref.decode_merge(outs, lses), want) <= limit
    dropped = lses.clone()
    dropped[:, :, n // 2] = ref.NEG_INF
    assert _row_rel(ref.decode_merge(outs, dropped), want) > limit
    m = s // n
    shifted = [ref.decode_attention_naive(
        q, k[:, r * m:(r + 1) * m], v[:, r * m:(r + 1) * m],
        torch.from_numpy(lens), window=window, k_offset=r * m + 1,
        return_lse=True) for r in range(n)]
    got = ref.decode_merge(torch.stack([o[:, 0] for o, _ in shifted], 2),
                           torch.stack([x for _, x in shifted], 2))
    assert _row_rel(got, want) > limit
