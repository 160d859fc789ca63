"""The port's attention plain versions and ops dispatch against the JAX
package's oracles, on the CPU, over the shape lists of test_kernels.py.

Inputs are drawn with numpy and handed to both packages; bf16 inputs are
rounded from the same fp32 values on both sides, so they hold the same bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attention as jda  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from test_kernels import DECODE_SHAPES, SHAPES, SSD_SHAPES  # noqa: E402

# the tolerances of tests/test_kernels.py::TOL
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _pair(rng, shape, dtype):
    """The same values as a torch tensor and a jax array."""
    tdt, jdt, _ = DTYPES[dtype]
    a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _qkv(seed, b, tq, tk, hq, hkv, d, dtype):
    rng = np.random.default_rng(seed)
    return [_pair(rng, s, dtype)
            for s in ((b, tq, hq, d), (b, tk, hkv, d), (b, tk, hkv, d))]


def _close(got, want, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _flash_case(shape, dtype, seed=0):
    b, tq, tk, hq, hkv, d, win, caus, bq, bk = shape
    (tq_, jq), (tk_, jk), (tv_, jv) = _qkv(seed, b, tq, tk, hq, hkv, d,
                                           dtype)
    lens = np.asarray([tk] + [max(tk * 2 // 3, 1)] * (b - 1), np.int32)
    kw = dict(causal=caus, window=win, q_offset=tk - tq)
    want = jref.attention_naive(jq, jk, jv, lengths=jnp.asarray(lens), **kw)
    return (tq_, tk_, tv_), torch.from_numpy(lens), kw, want, (jq, jk, jv)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_attention_naive_matches_jax(shape, dtype):
    (q, k, v), lens, kw, want, _ = _flash_case(shape, dtype)
    _close(ref.attention_naive(q, k, v, lengths=lens, **kw), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_attention_blocked_matches_jax(shape, dtype):
    (q, k, v), lens, kw, want, _ = _flash_case(shape, dtype)
    bq, bk = shape[-2:]
    got = ref.attention_blocked(q, k, v, lengths=lens, block_q=bq,
                                block_k=bk, **kw)
    _close(got, want, dtype)


@pytest.mark.parametrize("backend", ["blocked", "naive"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_ops_flash_attention_cpu_matches_jax(shape, dtype, backend):
    (q, k, v), lens, kw, want, _ = _flash_case(shape, dtype)
    before = fa.launches
    ops.set_backend(backend)
    try:
        got = ops.flash_attention(q, k, v, lengths=lens, **kw)
    finally:
        ops.set_backend("blocked")
    _close(got, want, dtype)
    assert fa.launches == before == 0          # CPU tensors never launch


def _decode_case(shape, dtype, seed=1):
    b, s, hq, hkv, d, win, bk = shape
    rng = np.random.default_rng(seed)
    (q, jq), (kc, jkc), (vc, jvc) = [
        _pair(rng, sh, dtype)
        for sh in ((b, 1, hq, d), (b, s, hkv, d), (b, s, hkv, d))]
    lens = np.asarray([s] + [max(s // 3, 1)] * (b - 1), np.int32)
    want = jref.decode_attention_naive(jq, jkc, jvc, jnp.asarray(lens),
                                       window=win)
    return (q, kc, vc), torch.from_numpy(lens), win, want, (jq, jkc, jvc)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_attention_naive_matches_jax(shape, dtype):
    (q, kc, vc), lens, win, want, _ = _decode_case(shape, dtype)
    _close(ref.decode_attention_naive(q, kc, vc, lens, window=win), want,
           dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_ops_decode_attention_cpu_matches_jax(shape, dtype):
    (q, kc, vc), lens, win, want, _ = _decode_case(shape, dtype)
    got = ops.decode_attention(q, kc, vc, lens, window=win)
    _close(got, want, dtype)
    assert da.launches == 0                    # CPU tensors never launch


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_matches_pallas_interpret(dtype):
    """The port's ops path against the TPU kernel itself (interpret mode),
    on the windowed ragged GQA shape."""
    shape = SHAPES[2]
    (q, k, v), lens, kw, _, (jq, jk, jv) = _flash_case(shape, dtype)
    bq, bk = shape[-2:]
    want = jfa.flash_attention(jq, jk, jv, lengths=jnp.asarray(lens.numpy()),
                               block_q=bq, block_k=bk, interpret=True, **kw)
    _close(ops.flash_attention(q, k, v, lengths=lens, **kw), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_matches_pallas_interpret(dtype):
    shape = DECODE_SHAPES[3]
    (q, kc, vc), lens, win, _, (jq, jkc, jvc) = _decode_case(shape, dtype)
    want = jda.decode_attention(jq, jkc, jvc, jnp.asarray(lens.numpy()),
                                window=win, block_k=shape[-1],
                                interpret=True)
    _close(ops.decode_attention(q, kc, vc, lens, window=win), want, dtype)


# cross-attention (the whisper decoder's and the VLM's image layers):
# non-causal, q_offset 0, no lengths, Tq below and above Tk, Tk not a
# multiple of the key block.  (b, tq, tk, hq, hkv, d, bq, bk)
CROSS_SHAPES = [(1, 24, 72, 4, 2, 32, 16, 32), (2, 40, 12, 6, 6, 16, 16, 8)]


@pytest.mark.parametrize("fn", ["naive", "blocked"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", CROSS_SHAPES)
def test_cross_attention_matches_pallas_interpret(shape, dtype, fn):
    b, tq, tk, hq, hkv, d, bq, bk = shape
    (q, jq), (k, jk), (v, jv) = _qkv(11, b, tq, tk, hq, hkv, d, dtype)
    want = jfa.flash_attention(jq, jk, jv, causal=False, block_q=bq,
                               block_k=bk, interpret=True)
    if fn == "naive":
        got = ref.attention_naive(q, k, v, causal=False)
    else:
        got = ref.attention_blocked(q, k, v, causal=False, block_q=bq,
                                    block_k=bk)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s", [72, 12])
def test_cross_decode_matches_pallas_interpret(s, dtype):
    """Decode against a static cross cache: every length is the whole cache,
    not a multiple of the Pallas key block (32)."""
    b, hq, hkv, d = 2, 8, 2, 32
    (q, jq), (kc, jkc), (vc, jvc) = _qkv(12, b, 1, s, hq, hkv, d, dtype)
    lens = np.full((b,), s, np.int32)
    want = jda.decode_attention(jq, jkc, jvc, jnp.asarray(lens), block_k=32,
                                interpret=True)
    _close(ops.decode_attention(q, kc, vc, torch.from_numpy(lens)), want,
           dtype)
    assert da.launches == 0


def test_fully_masked_rows_are_zero_not_nan():
    """Rows with no valid key (q past lengths under a window, empty slots)
    give 0 in every plain version, as in the reference."""
    q = torch.randn(2, 8, 4, 16)
    k = torch.randn(2, 8, 2, 16)
    lens = torch.tensor([8, 0])
    for fn in (ref.attention_naive, ref.attention_blocked):
        out = fn(q, k, k, lengths=lens, window=2)
        assert torch.isfinite(out).all()
        assert (out[1] == 0).all()
    dec = ref.decode_attention_naive(q[:, :1], k, k, lens)
    assert torch.isfinite(dec).all() and (dec[1] == 0).all()


def test_kernel_wrappers_reject_cpu_tensors():
    """A wrapper launches its kernel or raises; it never runs the plain
    version, and its checks fire before any build; no backend value
    routes around the kernels."""
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        da.decode_attention(q[:, :1], q, q, torch.tensor([4]))
    with pytest.raises(ValueError, match="backend"):
        ops.set_backend("cuda")
    assert fa.launches == 0 and da.launches == 0


def _wrapper_calls():
    """Each kernel wrapper with CPU inputs it would otherwise take."""
    from repro_torch.kernels import ssd_scan
    q = torch.zeros(1, 4, 2, 16)
    lens = torch.tensor([4])
    ssd_in = (torch.zeros(1, 1, 8, 2 * 8), torch.zeros(1, 1, 8, 2),
              torch.zeros(1, 1, 8, 4), torch.zeros(1, 1, 8, 4))
    return {
        "flash_attention": (fa.flash_attention, (q, q, q), {}),
        "decode_attention": (da.decode_attention, (q[:, :1], q, q, lens),
                             {}),
        "ssd_intra_chunk": (ssd_scan.ssd_intra_chunk, ssd_in,
                            {"nh": 2, "hd": 8}),
    }


def _flash_builds_a_graph_under_grad():
    """Flash attention has a backward kernel: under grad its wrapper runs
    ``FlashAttentionFn``, whose graph a CPU test builds with the plain
    versions in the kernels' places; the wrapper itself still takes CUDA
    tensors only, and raises on the CPU before any build or launch."""
    q = torch.randn(1, 4, 2, 16, generator=torch.Generator().manual_seed(0))
    qg = q.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(qg, q, q)
    out = fa.FlashAttentionFn.apply(qg, q, q, None, True, None, 0,
                                    ref.attention_lse_naive,
                                    ref.attention_bwd_naive)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    out.sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()
    assert ops.flash_attention(qg, q, q).grad_fn is not None  # ref's autograd
    assert fa.launches == 0 and fa.bwd_launches == 0


def _ssd_builds_a_graph_under_grad():
    """The SSD intra-chunk pass has a backward kernel: under grad its
    wrapper runs ``SSDIntraChunkFn``, whose graph a CPU test builds with the
    plain versions in the kernels' places; the wrapper itself still takes
    CUDA tensors only, and raises on the CPU before any build or launch."""
    from repro_torch.kernels import ssd_scan
    gen = torch.Generator().manual_seed(0)
    xdt, dacs, B, C = (torch.randn(x.shape, generator=gen)
                       for x in _wrapper_calls()["ssd_intra_chunk"][1])
    dacs = -dacs.abs().cumsum(2)
    xg = xdt.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan.ssd_intra_chunk(xg, dacs, B, C, nh=2, hd=8)
    y, states = ssd_scan.SSDIntraChunkFn.apply(
        xg, dacs, B, C, 2, 8, ref.ssd_intra_chunk, ref.ssd_intra_chunk_bwd)
    assert type(y.grad_fn).__name__ == "SSDIntraChunkFnBackward"
    (y.sum() + states.sum()).backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
    assert ssd_scan.launches == 0 and ssd_scan.bwd_launches == 0


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "ssd_intra_chunk"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(name):
    """A kernel's output carries no grad_fn, so a backward pass through it
    would drop its inputs' gradients silently: under grad, the decode
    wrapper, given an input that requires grad, raises (naming what would
    lift the refusal), before its device check (so CPU tensors show it);
    under no_grad the same call reaches the device check as before, and
    nothing launches.  Flash attention and the SSD pass no longer refuse:
    they have their backward kernels (``_flash_builds_a_graph_under_grad``,
    ``_ssd_builds_a_graph_under_grad``)."""
    if name == "flash_attention":
        _flash_builds_a_graph_under_grad()
        return
    if name == "ssd_intra_chunk":
        _ssd_builds_a_graph_under_grad()
        return
    fn, args, kw = _wrapper_calls()[name]
    grad_args = [a.clone().requires_grad_(True) if i == 0 else a
                 for i, a in enumerate(args)]
    with pytest.raises(RuntimeError, match="training slice"):
        fn(*grad_args, **kw)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*grad_args, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*args, **kw)                       # no input requires grad
    assert fa.launches == 0 and da.launches == 0


def test_chip_smoke_checks_the_reference_shape_lists():
    """chip_smoke.py holds the kernels to the same shape lists as the JAX
    package's kernel tests (it cannot import them: they import jax)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.SHAPES == SHAPES
    assert chip_smoke.DECODE_SHAPES == DECODE_SHAPES
    assert chip_smoke.SSD_SHAPES == SSD_SHAPES
    # the SSD backward's training shapes are the training cells' SSD calls
    from repro_torch.configs import get_config
    want = []
    for aid, (b, t) in chip_smoke.SSM_TRAIN_BATCH.items():
        cfg = get_config(aid)
        s = cfg.ssm
        want.append((b, t, s.n_heads(cfg.d_model), s.head_dim, s.d_state,
                     s.chunk))
    assert chip_smoke.SSD_TRAIN == want


def test_every_kernel_library_exports_its_wrappers_entry_points():
    """Each library ``_build.KERNELS`` builds is loaded by a wrapper whose
    ctypes signature matches the C entry point in its source, argument for
    argument (a pointer as ``c_void_p``, an int as ``c_int``, ...): ctypes
    would pass a mismatched argument on without a word."""
    import ctypes
    import re

    from repro_torch.kernels import _build, mamba_prefill, ssd_decode, ssd_scan
    ctype = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
             ctypes.c_longlong: "long long", ctypes.c_float: "float"}
    loaded = {"flash_attention": fa._SIGNATURES,
              "flash_attention_bwd": fa._BWD_SIGNATURES,
              "decode_attention": da._SIGNATURES,
              "ssd_intra_chunk": ssd_scan._SIGNATURES,
              "ssd_intra_chunk_bwd": ssd_scan._BWD_SIGNATURES,
              "ssd_decode": ssd_decode._SIGNATURES,
              "mamba_prefill": mamba_prefill._SIGNATURES}
    assert set(loaded) == set(_build.KERNELS)
    for lib, sigs in loaded.items():
        src = (_build.CSRC / f"{lib}.cu").read_text()
        for fn, argtypes in sigs.items():
            m = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src)
            assert m, f"{lib}.cu has no entry point {fn}"
            params = [p.strip() for p in m.group(1).split(",")]
            kinds = ["ptr" if "*" in p else
                     re.sub(r"\s+\w+$", "", p).replace("const ", "")
                     for p in params]
            assert kinds == [ctype[t] for t in argtypes], (lib, fn, kinds)
