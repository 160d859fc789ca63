"""Wrappers of the hand-written CUDA flash-attention kernels: the forward
(``csrc/flash_attention.cu``), the port of the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``, and its backward
(``csrc/flash_attention_bwd.cu``), which the JAX package does not have (its
training differentiates ``ref.attention_blocked`` under ``jax.checkpoint``).

CUDA tensors only: each kernel launches on the current stream, without a
synchronisation, into outputs allocated here.  The plain versions are
``ref.attention_lse_naive`` and ``ref.attention_bwd_naive`` (``ops`` sends
CPU tensors to ``ref``); ``ref.attention_bwd_split`` is the bf16 backward's
arithmetic (its tile walk, bf16 roundings and split sums).
``launches`` counts the forward kernel's calls in this process,
``bwd_launches`` the backward's (one per call: a bf16 backward call is
Δ, dK/dV on wgmma over ``bwd_plan``'s splits of the GQA group, the sum of
the splits' partials where there are several, and dQ from the dK/dV
kernel's dS tiles; an fp32 call is Δ, dK/dV and dQ).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._wrap import (DTYPES, NO_WINDOW, check_bthd, check_common,
                    check_lengths, raise_on_error)

launches = 0
bwd_launches = 0

# the backward's tiles (64 keys or queries), and the blocks its dK/dV
# kernel aims for: two for each of the H100's 132 SMs
BWD_TILE = 64
BWD_TARGET_BLOCKS = 2 * 132

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"flash_attention_fwd": [
    _I, _I, _P, _P, _P, _P, _P, _P,        # dtype, D, q, k, v, o, lse, lengths
    _I, _I, _I, _I, _I,                    # B, Tq, Tk, Hq, Hkv
    _LL, _LL, _LL, _LL, _LL, _LL,          # (b, t) strides of q, k, v
    _I, _I, _I, ctypes.c_float, _P]}       # causal, q_offset, window, scale, stream
_BWD_SIGNATURES = {"flash_attention_bwd": [
    _I, _I, _P, _P, _P, _P, _P, _P,        # dtype, D, q, k, v, o, do, lse
    _P, _P, _P, _P, _P,                    # lengths, dq, dk, dv, delta
    _P, _P,                                # split partials, dS scratch
    _I, _I, _I, _I, _I,                    # B, Tq, Tk, Hq, Hkv
    _I, _I,                                # n_splits, ds_run
    _LL, _LL, _LL, _LL, _LL, _LL,          # (b, t) strides of q, k, v
    _LL, _LL, _LL, _LL,                    # (b, t) strides of o, do
    _I, _I, _I, ctypes.c_float, _P]}       # causal, q_offset, window, scale, stream


def _check_qkv(q, k, v, window, lengths):
    """The forward's argument checks; returns the kernel's window and the
    int32 lengths (None: every key valid)."""
    w = check_common(q, window)
    b, _, hq, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_bthd(name, x, q.dtype, q.device)
    _, _, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    # no lengths: a null pointer, every key valid (a tensor of Tk made here
    # would be copied from the host, a stream synchronisation each call)
    lens = None if lengths is None else check_lengths(lengths, b, q.device)
    return w, lens


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        q_offset: int = 0,
                        lengths: torch.Tensor | None = None,
                        with_lse: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The forward kernel: (B, Tq, Hq, D) output in q's dtype and, with
    ``with_lse``, each row's natural-log log-sum-exp, fp32 (B, Hq, Tq)
    (NEG_INF for a row with no valid key), else None.  Semantics of
    ``ref.attention_lse_naive``."""
    global launches
    w, lens = _check_qkv(q, k, v, window, lengths)
    b, tq, hq, d = q.shape
    _, tk, hkv, _ = k.shape
    lib = _build.load("flash_attention", _SIGNATURES)
    out = torch.empty((b, tq, hq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_fwd(
        DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(),
        None if lens is None else lens.data_ptr(),
        b, tq, tk, hq, hkv, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), int(causal), int(q_offset), w,
        1.0 / math.sqrt(d), stream)
    launches += 1
    raise_on_error(err, "flash_attention")
    return out, lse


def _ds_range(qt: int, nkt: int, causal: bool, window: int,
              q_offset: int) -> tuple[int, int]:
    """The key tiles [first, last] that query tile ``qt`` reaches whatever
    the lengths: the dS scratch's tiles of that query tile (the kernel's
    ``ds_first`` is ``first``)."""
    t = BWD_TILE
    q_lo, q_hi = q_offset + qt * t, q_offset + qt * t + t - 1
    first = next((j for j in range(nkt) if j * t + t - 1 > q_lo - window),
                 nkt)
    last = min(nkt - 1, q_hi // t) if causal else nkt - 1
    return first, last


def bwd_plan(b: int, tq: int, tk: int, hq: int, hkv: int, d: int, *,
             causal: bool = True, window: int | None = None,
             q_offset: int = 0) -> dict:
    """How the bf16 backward cuts its work, from shapes alone (the lengths
    stay on the card):

    * ``splits``: the GQA group's query heads go to this many dK/dV blocks
      per (key tile, kv head, batch), the smallest divisor of the group
      size that gives ``BWD_TARGET_BLOCKS`` blocks, else the group size;
      ``blocks`` is the dK/dV grid, ``partial_bytes`` the splits' fp32
      partials of dK and dV (0 for one split: it writes them itself);
    * ``ds_run``: the most key tiles one query tile reaches; the dS scratch
      holds that many 64 x 64 bf16 tiles per (batch, head, query tile),
      ``ds_bytes`` in all; ``tiles_per_head``: the tiles one query head of
      one sequence writes there (the dQ kernel's key tiles)."""
    t = BWD_TILE
    w = NO_WINDOW if window is None else int(window)
    g = hq // hkv
    nqt, nkt = -(-tq // t), -(-tk // t)
    base = nkt * hkv * b
    splits = next((s for s in range(1, g + 1)
                   if g % s == 0 and base * s >= BWD_TARGET_BLOCKS), g)
    runs = [max(0, last - first + 1) for first, last in
            (_ds_range(i, nkt, causal, w, q_offset) for i in range(nqt))]
    ds_run = max(1, max(runs))
    return dict(splits=splits, blocks=base * splits,
                partial_bytes=(splits * 2 * b * tk * hkv * d * 4
                               if splits > 1 else 0),
                ds_run=ds_run, ds_bytes=b * hq * nqt * ds_run * t * t * 2,
                tiles_per_head=sum(runs))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        q_offset: int = 0,
                        lengths: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel: (dq, dk, dv) in the inputs' dtype from the
    forward's inputs, its output ``o`` and ``lse``, and the output's
    gradient ``do``.  Semantics of ``ref.attention_bwd_naive``."""
    global bwd_launches
    w, lens = _check_qkv(q, k, v, window, lengths)
    b, tq, hq, d = q.shape
    _, tk, hkv, _ = k.shape
    do = do.contiguous()
    for name, x in (("o", o), ("do", do)):
        check_bthd(name, x, q.dtype, q.device)
        if x.shape != q.shape:
            raise ValueError(f"{name} must be {tuple(q.shape)}, got "
                             f"{tuple(x.shape)}")
    if (lse.dtype != torch.float32 or lse.device != q.device
            or lse.shape != (b, hq, tq) or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 ({b}, {hq}, {tq}) "
                         f"tensor on {q.device}")
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    dq = torch.empty((b, tq, hq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, hkv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, tk, hkv, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    part = ds = None
    splits, ds_run = 1, 1
    if q.dtype == torch.bfloat16:
        plan = bwd_plan(b, tq, tk, hq, hkv, d, causal=causal, window=window,
                        q_offset=q_offset)
        splits, ds_run = plan["splits"], plan["ds_run"]
        ds = torch.empty(plan["ds_bytes"] // 2, dtype=torch.bfloat16,
                         device=q.device)
        if splits > 1:
            part = torch.empty(plan["partial_bytes"] // 4,
                               dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_bwd(
        DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        None if lens is None else lens.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        None if part is None else part.data_ptr(),
        None if ds is None else ds.data_ptr(),
        b, tq, tk, hq, hkv, splits, ds_run,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), o.stride(0), o.stride(1), do.stride(0),
        do.stride(1), int(causal), int(q_offset), w, 1.0 / math.sqrt(d),
        stream)
    bwd_launches += 1
    raise_on_error(err, "flash_attention_bwd")
    return dq, dk, dv


def _kernel_fwd(q, k, v, **kw):
    return flash_attention_fwd(q, k, v, with_lse=True, **kw)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a backward pass.  ``fwd(q, k, v, **mask)`` returns
    (o, lse) and ``bwd(q, k, v, o, lse, do, **mask)`` returns (dq, dk, dv):
    the two kernels on the card (``flash_attention`` passes them), the plain
    versions ``ref.attention_lse_naive`` / ``ref.attention_bwd_naive`` where
    a CPU test runs this same code.  Saves q, k, v, o and lse; ``lengths``
    and the flags get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal, window, q_offset, fwd, bwd):
        mask = dict(causal=causal, window=window, q_offset=q_offset,
                    lengths=lengths)
        o, lse = fwd(q, k, v, **mask)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask, ctx.bwd = mask, bwd
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, o, lse, do, **ctx.mask)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0,
                    lengths: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, Tq, Hq, D); k/v: (B, Tk, Hkv, D).  Returns (B, Tq, Hq, D) in
    q's dtype.  Semantics of ``repro.kernels.ref.attention_naive``.  Under
    grad with an input that requires it, the forward kernel also writes the
    LSE and the result's ``grad_fn`` runs the backward kernel
    (``FlashAttentionFn``); otherwise one forward launch without LSE."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, lengths, causal, window,
                                      q_offset, _kernel_fwd,
                                      flash_attention_bwd)
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, lengths=lengths)[0]
