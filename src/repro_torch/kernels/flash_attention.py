"""Wrapper of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``), the port of the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``.

CUDA tensors only: the kernel launches on the current stream, without a
synchronisation, into an output allocated here.  Its plain version is
``ref.attention_naive`` (``ops`` sends CPU tensors to ``ref``).
``launches`` counts the kernel launches of this process.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._wrap import (DTYPES, check_bthd, check_common, check_lengths,
                    check_no_grad, raise_on_error)

launches = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"flash_attention_fwd": [
    _I, _I, _P, _P, _P, _P, _P,            # dtype, D, q, k, v, o, lengths
    _I, _I, _I, _I, _I,                    # B, Tq, Tk, Hq, Hkv
    _LL, _LL, _LL, _LL, _LL, _LL,          # (b, t) strides of q, k, v
    _I, _I, _I, ctypes.c_float, _P]}       # causal, q_offset, window, scale, stream


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0,
                    lengths: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, Tq, Hq, D); k/v: (B, Tk, Hkv, D).  Returns (B, Tq, Hq, D) in
    q's dtype.  Semantics of ``repro.kernels.ref.attention_naive``."""
    global launches
    check_no_grad("flash_attention", q, k, v)
    w = check_common(q, window)
    b, tq, hq, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_bthd(name, x, q.dtype, q.device)
    _, tk, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    # no lengths: a null pointer, every key valid (a tensor of Tk made here
    # would be copied from the host, a stream synchronisation each call)
    lens = None if lengths is None else check_lengths(lengths, b, q.device)
    lib = _build.load("flash_attention", _SIGNATURES)
    out = torch.empty((b, tq, hq, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_fwd(
        DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if lens is None else lens.data_ptr(),
        b, tq, tk, hq, hkv, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), int(causal), int(q_offset), w,
        1.0 / math.sqrt(d), stream)
    launches += 1
    raise_on_error(err, "flash_attention")
    return out
