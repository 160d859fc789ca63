"""Wrapper of the hand-written CUDA decode-attention kernels
(``csrc/decode_attention.cu``), the port of the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention``.

Flash-decoding: each sequence's valid cache range is split over
``split_plan`` blocks per (kv head, sequence), which write fp32 partials
into scratch allocated here; a second kernel combines them.  CUDA tensors
only: both kernels launch on the current stream, without a
synchronisation.  Its plain version is ``ref.decode_attention_naive``
(``ops`` sends CPU tensors to ``ref``); ``ref.decode_attention_split`` is
the split algorithm itself, for the tests.  ``launches`` counts the calls
of this process that launched the kernels (two launches each).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._wrap import (DTYPES, check_bthd, check_common, check_lengths,
                    check_no_grad, raise_on_error)

launches = 0

# streaming multiprocessors of an H100 SXM; the split plan aims to cover them
SMS = 132
# keys per tile of the kernel (attention_tile.cuh BK); splits are whole tiles
TILE = 32

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"decode_attention_fwd": [
    _I, _I, _P, _P, _P, _P, _P,            # dtype, D, q, k, v, o, lengths
    _P, _P, _I,                            # partials acc, (m, l); n_splits
    _I, _I, _I, _I,                        # B, S, Hq, Hkv
    _LL, _LL, _LL, _LL, _LL,               # q batch; k, v (b, s) strides
    _I, ctypes.c_float, _P]}               # window, scale, stream


def split_plan(b: int, hkv: int, s: int, window: int | None) -> int:
    """Splits of each sequence's valid range, from the shapes alone (never
    from the lengths, which would need a host sync): enough that
    b * hkv * splits covers the SMs, and no more than the tiles of the
    longest valid range, min(s, window)."""
    span = s if window is None else max(1, min(s, window))
    return max(1, min(-(-SMS // (b * hkv)), -(-span // TILE)))


def split_range(length: int, s: int, window: int | None, n_splits: int,
                i: int) -> tuple[int, int]:
    """Keys [a, b) of split ``i``: the i-th equal share, in whole tiles
    counted from its start, of the valid range [max(0, length - window),
    min(length, s)).  The kernel's ``split_range`` computes the same."""
    lo = 0 if window is None else max(0, length - window)
    hi = min(length, s)
    tiles = -(-(hi - lo) // TILE) if hi > lo else 0
    return (lo + tiles * i // n_splits * TILE,
            min(hi, lo + tiles * (i + 1) // n_splits * TILE))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: int | None = None) -> torch.Tensor:
    """q: (B, 1, Hq, D); caches: (B, S, Hkv, D); lengths: (B,) valid cache
    entries.  Returns (B, 1, Hq, D) in q's dtype.  Semantics of
    ``repro.kernels.ref.decode_attention_naive``."""
    global launches
    check_no_grad("decode_attention",
                  "no training slice needs one: training attends over whole "
                  "sequences through flash attention", q, k_cache, v_cache)
    w = check_common(q, window)
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        check_bthd(name, x, q.dtype, q.device)
    b, one, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    if one != 1:
        raise ValueError(f"q must hold one token, got {tuple(q.shape)}")
    if (k_cache.shape[0] != b or k_cache.shape[3] != d
            or v_cache.shape != k_cache.shape):
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    lens = check_lengths(lengths, b, q.device)
    lib = _build.load("decode_attention", _SIGNATURES)
    ns = split_plan(b, hkv, s, window)
    out = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
    part_acc = torch.empty((b, hq, ns, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, hq, ns, 2), dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_fwd(
        DTYPES[q.dtype], d, q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), lens.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), ns, b, s, hq, hkv,
        q.stride(0), k_cache.stride(0), k_cache.stride(1),
        v_cache.stride(0), v_cache.stride(1), w, 1.0 / math.sqrt(d), stream)
    launches += 1
    raise_on_error(err, "decode_attention")
    return out
