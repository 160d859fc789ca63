"""Wrapper of the hand-written CUDA decode-attention kernels
(``csrc/decode_attention.cu``), the port of the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention``.

Flash-decoding: each sequence's valid cache range is split over
``split_plan`` blocks per (kv head, sequence), which write fp32 partials
into scratch allocated here; a second kernel combines them, on the grid
``combine_plan`` gives (a warp per run of 16-byte columns of a (sequence,
query head) row, its lanes over the row's partials; ``combine_lanes``
walks the kernel's index mapping).  CUDA tensors only: both kernels
launch on the current stream, without a synchronisation.  Its plain
version is ``ref.decode_attention_naive`` (``ops`` sends CPU tensors to
``ref``); ``ref.decode_attention_split`` is the split algorithm itself,
for the tests.  ``launches`` counts the calls of this process that
launched the kernels (two launches each).

Tensor-parallel serving keeps a cache split over the sequence: each rank
holds rows [k_offset, k_offset + S) of it.  ``decode_attention`` takes the
share's ``k_offset`` and can return each row's log-sum-exp beside the
output; ``merge`` combines the ranks' (output, log-sum-exp) with the same
combine kernel, each rank one partial (``merge_launches`` counts its
calls; plain version ``ref.decode_merge``).  ``decode_attention_abstract``
and ``merge_abstract`` are the shape paths of abstract (fake) tensors, the
dry-run's: the kernels' allocations and their FLOPs counted, nothing
computed.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from ._wrap import (DTYPES, check_bthd, check_common, check_lengths,
                    check_no_grad, raise_on_error)

launches = 0
merge_launches = 0
# FLOPs of the calls made on abstract tensors in this process (the dry-run
# adds them to its FLOP counter, which does not see a kernel)
abstract_flops = 0.0

# streaming multiprocessors of an H100 SXM; the split plan aims to cover them
SMS = 132
# keys per tile of the kernel (attention_tile.cuh BK); splits are whole tiles
TILE = 32
# the combine kernel: bytes of one load, the loads a lane keeps in flight
# (CK), the most warps in a block (COMBINE_WARPS)
VEC_BYTES, COMBINE_LOADS, COMBINE_WARPS = 16, 8, 4

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "decode_attention_fwd": [
        _I, _I, _P, _P, _P, _P,            # dtype, D, q, k, v, o
        _P, _P,                            # lse (or null), lengths
        _P, _P, _I,                        # partials acc, (m, l); n_splits
        _I, _I,                            # combine_plan: chunk, warps
        _I, _I, _I, _I,                    # B, S, Hq, Hkv
        _LL, _LL, _LL, _LL, _LL,           # q batch; k, v (b, s) strides
        _I, _LL, ctypes.c_float, _P],      # window, k_offset, scale, stream
    "decode_attention_merge": [
        _I, _I, _P, _P, _P, _P,            # dtype, D, parts, lses, o, lse
        _I, _I, _I,                        # R, B, Hq
        _I, _I, _P]}                       # combine_plan: chunk, warps; stream


def split_plan(b: int, hkv: int, s: int, window: int | None) -> int:
    """Splits of each sequence's valid range, from the shapes alone (never
    from the lengths, which would need a host sync): enough that
    b * hkv * splits covers the SMs, and no more than the tiles of the
    longest valid range, min(s, window)."""
    span = s if window is None else max(1, min(s, window))
    return max(1, min(-(-SMS // (b * hkv)), -(-span // TILE)))


def split_range(length: int, s: int, window: int | None, n_splits: int,
                i: int, k_offset: int = 0) -> tuple[int, int]:
    """Keys [a, b) of split ``i``: the i-th equal share, in whole tiles
    counted from its start, of the valid range of a cache whose row 0 is
    the global position ``k_offset``: [clamp(max(0, length - window) -
    k_offset), clamp(length - k_offset)), each clamped to [0, s).  The
    kernel's ``split_range`` computes the same."""
    lo = 0 if window is None else max(0, length - window)
    lo = min(max(lo - k_offset, 0), s)
    hi = min(max(length - k_offset, 0), s)
    tiles = -(-(hi - lo) // TILE) if hi > lo else 0
    return (lo + tiles * i // n_splits * TILE,
            min(hi, lo + tiles * (i + 1) // n_splits * TILE))


@functools.cache
def combine_plan(rows: int, n: int, d: int, itemsize: int = 4) -> dict:
    """The combine kernel's grid for ``rows`` rows of ``n`` partials of
    ``d`` values, ``itemsize`` bytes each (4: the split kernel's fp32
    partials; the merge's outputs 2 or 4), from the shapes alone.  A row is
    ``nv`` = d·itemsize / 16 columns of 16 bytes; a warp takes ``chunk`` of
    them (a power of two dividing nv), its 32 / chunk lanes a column over
    the row's partials.  Narrower runs (more warps, more lanes a column)
    while the warps do not cover the SMs, where rows·nv allows, or a lane
    would keep more than ``COMBINE_LOADS`` loads in flight; then blocks of
    4, 2 or 1 warps, as many as keep a block for each SM.  Returns chunk,
    warps (a block) and blocks, cached per shape (every decode call asks;
    do not change the dict).  gemma-2b's serving decode (32 rows of 32
    splits) takes chunk 8, the merge of 8 shares of B=128 x Hq=8 rows
    whole 32-column runs in blocks of 4 warps;
    ``scripts/combine_plan_sweep.py`` times every other grid beside them
    on the card."""
    v = VEC_BYTES // itemsize
    if d % v:
        raise ValueError(f"D={d} is not a multiple of {v} elements of "
                         f"{itemsize} bytes (16-byte loads)")
    nv = d // v
    chunk = 1
    while chunk < 32 and nv % (2 * chunk) == 0:
        chunk *= 2

    def narrower(c: int) -> bool:
        return (rows * (nv // c) < SMS
                or -(-n // (32 // c)) > COMBINE_LOADS)

    while chunk > 1 and narrower(chunk):
        chunk //= 2
    warps = rows * (nv // chunk)
    per_block = next(k for k in (COMBINE_WARPS, 2, 1)
                     if k == 1 or warps >= k * SMS)
    return dict(chunk=chunk, warps=per_block,
                blocks=-(-warps // per_block))


def combine_lanes(plan: dict, rows: int, nv: int):
    """The combine kernel's index mapping over the grid of ``plan``, for
    the tests: for every thread of every block, its row (-1 for a warp past
    the last row), its 16-byte column, its first partial and the stride of
    its partials, as tensors.  Warp w = block·warps + warp-in-block takes
    row w // (nv // chunk) and its (w % (nv // chunk))-th run of ``chunk``
    columns; lane l column l % chunk of the run and partials l // chunk,
    l // chunk + 32 // chunk, ... (csrc/decode_attention.cu
    ``decode_combine``)."""
    chunk, per_block = plan["chunk"], plan["warps"]
    t = torch.arange(plan["blocks"] * per_block * 32)
    w, lane = t // 32, t % 32
    runs = nv // chunk
    row = w // runs
    col = (w % runs) * chunk + lane % chunk
    return (torch.where(row < rows, row, -1), col, lane // chunk,
            torch.full_like(t, 32 // chunk))


def _check_decode(q, k_cache, v_cache, lengths, window):
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
    return w, check_lengths(lengths, b, q.device)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: int | None = None, k_offset: int = 0,
                     return_lse: bool = False, scale: float | None = None):
    """q: (B, 1, Hq, D); caches: (B, S, Hkv, D), rows [k_offset, k_offset +
    S) of the sequence; lengths: (B,) valid entries of the whole sequence.
    Returns (B, 1, Hq, D) in q's dtype, and with ``return_lse`` also each
    row's log-sum-exp of its scaled scores, (B, Hq) fp32 (``ref.NEG_INF``
    for a row with no valid key in the share).  ``scale`` multiplies the
    scores (1 / sqrt(D) where None).  Semantics of
    ``repro.kernels.ref.decode_attention_naive`` on a whole cache."""
    global launches
    check_no_grad("decode_attention",
                  "no training slice needs one: training attends over whole "
                  "sequences through flash attention", q, k_cache, v_cache)
    w, lens = _check_decode(q, k_cache, v_cache, lengths, window)
    b, _, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    lib = _build.load("decode_attention", _SIGNATURES)
    ns = split_plan(b, hkv, s, window)
    out = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    part_acc = torch.empty((b, hq, ns, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, hq, ns, 2), dtype=torch.float32,
                          device=q.device)
    plan = combine_plan(b * hq, ns, d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_fwd(
        DTYPES[q.dtype], d, q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), lens.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), ns, plan["chunk"],
        plan["warps"], b, s, hq, hkv,
        q.stride(0), k_cache.stride(0), k_cache.stride(1),
        v_cache.stride(0), v_cache.stride(1), w, int(k_offset),
        1.0 / math.sqrt(d) if scale is None else float(scale), stream)
    launches += 1
    raise_on_error(err, "decode_attention")
    return (out, lse) if return_lse else out


def _check_merge(outs: torch.Tensor, lses: torch.Tensor) -> None:
    if outs.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got {outs.device}; "
            "ops.* sends CPU tensors to the plain version")
    if outs.dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {outs.dtype}: float32 or "
                         "bfloat16")
    if outs.dim() != 4 or lses.shape != outs.shape[:3]:
        raise ValueError(f"outs (B, Hq, R, D) and lses (B, Hq, R), got "
                         f"{tuple(outs.shape)} and {tuple(lses.shape)}")
    if lses.dtype != torch.float32 or lses.device != outs.device:
        raise ValueError(f"lses must be float32 on {outs.device}")
    if not outs.is_contiguous() or not lses.is_contiguous():
        raise ValueError("outs and lses must be contiguous")
    # rows are loaded 16 bytes at a time
    per16 = VEC_BYTES // outs.element_size()
    if outs.shape[-1] % per16 or outs.data_ptr() % VEC_BYTES:
        raise ValueError(f"outs must start on 16 bytes and hold D a "
                         f"multiple of {per16}, got D={outs.shape[-1]}")


def merge(outs: torch.Tensor, lses: torch.Tensor):
    """The ranks' results over a cache split along the sequence merged:
    ``outs`` (B, Hq, R, D) their outputs, ``lses`` (B, Hq, R) their
    log-sum-exps (``decode_attention(..., return_lse=True)`` on each
    share).  Returns (B, 1, Hq, D) in the outputs' dtype: the attention
    over the whole cache.  One launch of the combine kernel, on the grid
    ``combine_plan`` gives for B·Hq rows of R partials."""
    global merge_launches
    _check_merge(outs, lses)
    b, hq, r, d = outs.shape
    lib = _build.load("decode_attention", _SIGNATURES)
    out = torch.empty((b, 1, hq, d), dtype=outs.dtype, device=outs.device)
    plan = combine_plan(b * hq, r, d, outs.element_size())
    stream = torch.cuda.current_stream(outs.device).cuda_stream
    err = lib.decode_attention_merge(DTYPES[outs.dtype], d, outs.data_ptr(),
                                     lses.data_ptr(), out.data_ptr(), None,
                                     r, b, hq, plan["chunk"], plan["warps"],
                                     stream)
    merge_launches += 1
    raise_on_error(err, "decode_attention_merge")
    return out


def decode_attention_abstract(q, k_cache, v_cache, lengths, *, window=None,
                              k_offset: int = 0, return_lse: bool = False):
    """``decode_attention`` on abstract (fake) tensors: the output, the
    log-sum-exps and the split partials allocated as the wrapper allocates
    them (``split_plan``), and 4·B·Hq·D FLOPs a key counted over the keys a
    full cache holds in this share (every row valid, at most ``window``);
    nothing computed."""
    global abstract_flops
    b, _, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    ns = split_plan(b, hkv, s, window)
    keys = s if window is None else min(s, int(window))
    abstract_flops += 4.0 * b * hq * d * keys
    out = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
    scratch = (torch.empty((b, hq, ns, d), dtype=torch.float32,
                           device=q.device),
               torch.empty((b, hq, ns, 2), dtype=torch.float32,
                           device=q.device))
    del scratch
    if return_lse:
        return out, torch.empty((b, hq), dtype=torch.float32,
                                device=q.device)
    return out


def merge_abstract(outs, lses):
    """``merge`` on abstract tensors: its output allocated, 3·B·Hq·R·D
    FLOPs counted."""
    global abstract_flops
    b, hq, r, d = outs.shape
    abstract_flops += 3.0 * b * hq * r * d
    return torch.empty((b, 1, hq, d), dtype=outs.dtype, device=outs.device)
