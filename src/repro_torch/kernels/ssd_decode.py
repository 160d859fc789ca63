"""The Mamba-2 decode step in one hand-written CUDA kernel
(``csrc/ssd_decode.cu``): the fp32 state is stepped where it lies, read once
and written once, and the readout y comes back in x's dtype.

No Pallas kernel computes this step (the JAX package runs it in plain jnp,
``repro/kernels/ops.py::ssd_decode_step``).  Its plain version is
``ref.ssd_decode_step``, which returns the new state instead of writing it;
``ops.ssd_decode_step_`` sends a CPU state there and copies the result into
it.  ``ssd_decode_step_`` takes CUDA tensors only and launches on the current
stream, without a synchronisation.  ``launches`` counts its calls in this
process.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._wrap import DTYPES, raise_on_error

launches = 0

# the kernel keeps a head row's n state columns as n/4 float4 chunks, at
# most two chunks on each of a warp's 32 lanes
MAX_STATE = 256

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"ssd_decode_step": [
    _I, _P, _P, _P, _P, _P, _P, _P, _P,    # dtype, h, x, dt, A, B, C, D, y
    _I, _I, _I, _I,                        # b, nh, hd, n
    _L, _L, _L, _L, _L, _L, _L, _L,        # h, x, dt (row, head); B, C (row)
    _P]}                                   # stream


def _check(name: str, t: torch.Tensor, shape: tuple, dtypes, device) -> None:
    """On ``device``, of one of ``dtypes``, of ``shape``, its last axis
    dense."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} is {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"{name} needs a dense last axis, got strides "
                         f"{t.stride()}")


def ssd_decode_step_(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                     A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                     D: torch.Tensor) -> torch.Tensor:
    """One-token SSM update of ``h`` (b, nh, hd, n) fp32, in place; returns
    y (b, nh, hd) in x's dtype.  x (b, nh, hd), B/C (b, n) in fp32 or bf16
    (one dtype), dt (b, nh) fp32, A/D (nh,) fp32; x, B, C and dt may be
    strided views.  n is a multiple of 4, at most ``MAX_STATE``.  Semantics
    of ``ref.ssd_decode_step``, the new state written into ``h``."""
    global launches
    if h.dtype != torch.float32:
        raise ValueError(f"the state h is {h.dtype}, expected torch.float32")
    if h.dim() != 4:
        raise ValueError(f"h must be (b, nh, hd, n), got {tuple(h.shape)}")
    b, nh, hd, n = h.shape
    if n % 4 or not 4 <= n <= MAX_STATE:
        raise ValueError(f"d_state {n} must be a multiple of 4 in "
                         f"[4, {MAX_STATE}]")
    if h.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got {h.device}; "
            "ops.* sends CPU tensors to the plain version")
    if b > 65535:
        raise ValueError(f"{b} rows: the kernel's grid takes at most 65535")
    # rows of n fp32 are loaded 16 bytes at a time
    if (h.stride(3) != 1 or h.stride(2) != n or h.data_ptr() % 16
            or h.stride(0) % 4 or h.stride(1) % 4):
        raise ValueError(f"h needs dense (hd, n) rows on 16 bytes, got "
                         f"strides {h.stride()}")
    dev, act = h.device, (torch.float32, torch.bfloat16)
    _check("x", x, (b, nh, hd), act, dev)
    _check("B", B, (b, n), (x.dtype,), dev)
    _check("C", C, (b, n), (x.dtype,), dev)
    f32 = (torch.float32,)
    _check("dt", dt, (b, nh), f32, dev)
    _check("A", A, (nh,), f32, dev)
    _check("D", D, (nh,), f32, dev)
    lib = _build.load("ssd_decode", _SIGNATURES)
    y = torch.empty((b, nh, hd), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ssd_decode_step(
        DTYPES[x.dtype], h.data_ptr(), x.data_ptr(), dt.data_ptr(),
        A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(), y.data_ptr(),
        b, nh, hd, n, h.stride(0), h.stride(1), x.stride(0), x.stride(1),
        dt.stride(0), dt.stride(1), B.stride(0), C.stride(0), stream)
    launches += 1
    raise_on_error(err, "ssd_decode_step")
    return y
