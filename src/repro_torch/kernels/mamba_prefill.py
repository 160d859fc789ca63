"""The Mamba-2 mixer's prefill between its two projections in five
hand-written CUDA passes (``csrc/mamba_prefill.cu``) around the SSD
intra-chunk kernel (``ssd_scan.ssd_intra_chunk_fwd``), with no launch per
chunk and no Python loop.

No Pallas kernel computes this work: the JAX package leaves it to XLA
(``repro/models/layers.py``'s Mamba-2 block and ``repro/kernels/ssd_scan.py``'s
wrapper), and the port's eager path (``layers.mamba_block`` with
``ssd_scan.ssd``) stays for CPU tensors, training, and the tensor-parallel
and sequence-split mixers.  Each pass has its plain version in ``ref`` (the
eager code of its stage): ``ssd_dt`` (``ref.ssd_dt``), ``conv``
(``ref.mamba_conv``), ``chunk_states`` (``ref.ssd_chunk_states``), ``output``
(``ref.ssd_output``) and ``gated_norm`` (``ref.gated_rmsnorm``).  ``mixer``
composes them; ``PLAIN`` puts the plain versions in the kernels' places, so
that the CPU tests run the same composition.

The wrappers take CUDA tensors only, launch on the current stream without a
synchronisation, and count their launches in this process in ``launches``
(one a call).  A ``mixer`` call is six launches: five of this module's and
the intra-chunk kernel's (``ssd_scan.launches``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build, ref, ssd_scan
from ._wrap import DTYPES, raise_on_error

launches = 0

HEAD_DIMS = ssd_scan.HEAD_DIMS
MAX_CHUNK, MAX_STATE = ssd_scan.MAX_CHUNK, ssd_scan.MAX_STATE
MAX_CONV = 4                  # the conv kernel keeps its window in registers

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "ssd_dt": [_I, _P, _L, _L, _P, _I, _P, _I, _P, _P,
               _I, _I, _I, _I, _I, _P],
    "mamba_conv": [_I, _P, _L, _L, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P,
                   _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "ssd_states": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ssd_output": [_I, _I, _P, _P, _P, _P, _P, _L, _L, _P, _I, _P,
                   _I, _I, _I, _I, _I, _I, _I, _P],
    "gated_rmsnorm": [_I, _P, _P, _L, _L, _P, _I, _P, _I, _I, _I, _F, _P]}


def _lib() -> ctypes.CDLL:
    return _build.load("mamba_prefill", _SIGNATURES)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got {x.device}; "
            "ops.* sends CPU tensors to the plain version")


def _dtype(name: str, x: torch.Tensor) -> int:
    if x.dtype not in DTYPES:
        raise ValueError(f"{name} is {x.dtype}, expected one of "
                         f"{tuple(DTYPES)}")
    return DTYPES[x.dtype]


def _rows(name: str, x: torch.Tensor, shape: tuple, dtype, device) -> None:
    """On ``device``, of ``dtype``, of ``shape``, its last axis dense (any
    other strides)."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} is {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if x.stride(-1) != 1 and x.shape[-1] > 1:
        raise ValueError(f"{name} needs a dense last axis, got strides "
                         f"{x.stride()}")


def _contiguous(name: str, x: torch.Tensor, shape: tuple, dtype,
                device) -> None:
    """``_rows``, contiguous: read one element at a time, anywhere (a
    layer's slice of a stacked weight or cache)."""
    _rows(name, x, shape, dtype, device)
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _dense(name: str, x: torch.Tensor, shape: tuple, dtype, device) -> None:
    """``_contiguous``, on 16 bytes: read 16 bytes at a time."""
    _contiguous(name, x, shape, dtype, device)
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must start on 16 bytes")


def _weight(name: str, w: torch.Tensor, shape: tuple, device) -> int:
    """A weight of ``shape``, contiguous, fp32 or bf16; returns 1 for
    bf16."""
    _contiguous(name, w, shape, w.dtype, device)
    return _dtype(name, w)


def _head_dim(hd: int) -> None:
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")


def ssd_dt(dtr: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
           chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """dt = softplus(dtr + dt_bias) (b, tp, nh) and its within-chunk cumsum
    of dt·A, A = -exp(A_log), as dacs (b, nc, c, nh), both fp32; dtr (b, t,
    nh) a view with a dense last axis (the projection's dt columns).
    Semantics of ``ref.ssd_dt``; one launch."""
    global launches
    if dtr.dim() != 3:
        raise ValueError(f"dtr must be (b, t, nh), got {tuple(dtr.shape)}")
    b, t, nh = dtr.shape
    if t < 1 or chunk < 1 or min(chunk, t) > MAX_CHUNK:
        raise ValueError(f"{t} rows in chunks of {chunk}: at least one "
                         f"row, chunks of 1 to {MAX_CHUNK}")
    _cuda(dtr)
    code = _dtype("dtr", dtr)
    _rows("dtr", dtr, (b, t, nh), dtr.dtype, dtr.device)
    c = min(chunk, t)
    nc = -(-t // c)
    bias_bf16 = _weight("dt_bias", dt_bias, (nh,), dtr.device)
    alog_bf16 = _weight("A_log", A_log, (nh,), dtr.device)
    dt = torch.empty((b, nc * c, nh), dtype=torch.float32, device=dtr.device)
    dacs = torch.empty((b, nc, c, nh), dtype=torch.float32, device=dtr.device)
    err = _lib().ssd_dt(code, dtr.data_ptr(), dtr.stride(0), dtr.stride(1),
                        dt_bias.data_ptr(), bias_bf16, A_log.data_ptr(),
                        alog_bf16, dt.data_ptr(), dacs.data_ptr(), b, t, c,
                        nc, nh, _stream(dtr))
    launches += 1
    raise_on_error(err, "ssd_dt")
    return dt, dacs


def conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
         conv_state: torch.Tensor | None, dt: torch.Tensor, *, hd: int
         ) -> tuple[torch.Tensor, ...]:
    """The depthwise causal conv over xbc (b, t, di + 2n) (the projection's
    x|B|C columns: a view with a dense last axis), its bias and SiLU, and
    the intra-chunk operands.  w (cw, di + 2n) and bias (di + 2n,) fp32 or
    bf16, rounded to xbc's dtype; conv_state (b, cw-1, di + 2n) in xbc's
    dtype or a narrower one, or None (zeros); dt (b, tp, nh) from
    ``ssd_dt``.  Returns (out (b, t, di + 2n), new context (b, cw-1,
    di + 2n)) in xbc's dtype and xdt (b, tp, di), B, C (b, tp, n) in fp32.
    Semantics of ``ref.mamba_conv``; one launch."""
    global launches
    if xbc.dim() != 3 or dt.dim() != 3:
        raise ValueError(f"xbc (b, t, C) and dt (b, tp, nh), got "
                         f"{tuple(xbc.shape)} and {tuple(dt.shape)}")
    b, t, cc = xbc.shape
    tp, nh = dt.shape[1:]
    di = nh * hd
    n = (cc - di) // 2
    _head_dim(hd)
    if n < 1 or di + 2 * n != cc or tp < t:
        raise ValueError(f"xbc's {cc} columns are not {nh} heads of {hd} "
                         f"and two equal state blocks, or dt's {tp} rows "
                         f"are fewer than its {t}")
    cw = w.shape[0]
    if not 2 <= cw <= MAX_CONV:
        raise ValueError(f"conv width {cw} not in [2, {MAX_CONV}]")
    _cuda(xbc)
    code = _dtype("xbc", xbc)
    dev = xbc.device
    _rows("xbc", xbc, (b, t, cc), xbc.dtype, dev)
    _dense("dt", dt, (b, tp, nh), torch.float32, dev)
    w_bf16 = _weight("w", w, (cw, cc), dev)
    bias_bf16 = 0 if bias is None else _weight("bias", bias, (cc,), dev)
    if conv_state is not None:
        if torch.promote_types(conv_state.dtype, xbc.dtype) != xbc.dtype:
            raise ValueError(f"a {conv_state.dtype} conv context is wider "
                             f"than the {xbc.dtype} activations")
        conv_state = conv_state.to(xbc.dtype).contiguous()
        _contiguous("conv_state", conv_state, (b, cw - 1, cc), xbc.dtype,
                    dev)
    out = torch.empty((b, t, cc), dtype=xbc.dtype, device=dev)
    new_state = torch.empty((b, cw - 1, cc), dtype=xbc.dtype, device=dev)
    xdt = torch.empty((b, tp, di), dtype=torch.float32, device=dev)
    B, C = (torch.empty((b, tp, n), dtype=torch.float32, device=dev)
            for _ in range(2))
    err = _lib().mamba_conv(
        code, xbc.data_ptr(), xbc.stride(0), xbc.stride(1),
        None if conv_state is None else conv_state.data_ptr(), w.data_ptr(),
        w_bf16, None if bias is None else bias.data_ptr(), bias_bf16,
        dt.data_ptr(), out.data_ptr(), new_state.data_ptr(), xdt.data_ptr(),
        B.data_ptr(), C.data_ptr(), b, t, tp, cc, di, n, nh, hd, cw,
        _stream(xbc))
    launches += 1
    raise_on_error(err, "mamba_conv")
    return out, new_state, xdt, B, C


def chunk_states(states: torch.Tensor, dacs: torch.Tensor,
                 h0: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence across chunks over the intra-chunk kernel's states
    (b, nc, nh, n, hd) fp32, which it overwrites in place with the state
    entering each chunk; dacs (b, nc, c, nh) fp32; h0 (b, nh, hd, n) or
    None (zeros).  Returns (h_in, the same storage as ``states``; the final
    state (b, nh, hd, n) fp32).  Semantics of ``ref.ssd_chunk_states``;
    one launch."""
    global launches
    if states.dim() != 5 or dacs.dim() != 4:
        raise ValueError(f"states (b, nc, nh, n, hd) and dacs (b, nc, c, "
                         f"nh), got {tuple(states.shape)} and "
                         f"{tuple(dacs.shape)}")
    b, nc, nh, n, hd = states.shape
    c = dacs.shape[2]
    _head_dim(hd)
    if n > MAX_STATE:
        raise ValueError(f"d_state {n} must be at most {MAX_STATE}")
    _cuda(states)
    dev, f32 = states.device, torch.float32
    _dense("states", states, (b, nc, nh, n, hd), f32, dev)
    _dense("dacs", dacs, (b, nc, c, nh), f32, dev)
    if h0 is not None:
        h0 = h0.float().contiguous()
        _contiguous("h0", h0, (b, nh, hd, n), f32, dev)
    h = torch.empty((b, nh, hd, n), dtype=f32, device=dev)
    err = _lib().ssd_states(hd, states.data_ptr(), dacs.data_ptr(),
                            None if h0 is None else h0.data_ptr(),
                            h.data_ptr(), b, nc, c, nh, n, _stream(states))
    launches += 1
    raise_on_error(err, "ssd_states")
    return states, h


def output(y_diag: torch.Tensor, h_in: torch.Tensor, dacs: torch.Tensor,
           C: torch.Tensor, x: torch.Tensor, D: torch.Tensor, *,
           zero_first: bool = False) -> torch.Tensor:
    """y = y_diag + exp(dacs)·(C·h_in) + D·x in fp32, stored in x's dtype:
    y_diag (b, nc, c, nh·hd), h_in (b, nc, nh, n, hd), dacs (b, nc, c, nh),
    C (b, nc, c, n), all fp32 and dense, n a multiple of 4; x (b, t, nh,
    hd) fp32 or bf16, dense heads (a view into the conv's output); D (nh,)
    fp32 or bf16.
    ``zero_first``: h_in's first chunk is zero (no h0), and its product is
    skipped.  Returns y (b, t, nh, hd).  Semantics of ``ref.ssd_output``;
    one launch."""
    global launches
    if x.dim() != 4 or h_in.dim() != 5:
        raise ValueError(f"x (b, t, nh, hd) and h_in (b, nc, nh, n, hd), "
                         f"got {tuple(x.shape)} and {tuple(h_in.shape)}")
    b, t, nh, hd = x.shape
    nc, _, n = h_in.shape[1:4]
    c = dacs.shape[2]
    _head_dim(hd)
    if c > MAX_CHUNK or n > MAX_STATE or n % 4 or nc * c < t:
        raise ValueError(f"chunk {c} and d_state {n} must be at most "
                         f"{MAX_CHUNK} and {MAX_STATE} (d_state a multiple "
                         f"of 4), and {nc} chunks must cover {t} rows")
    _cuda(x)
    dev, f32 = x.device, torch.float32
    code = _dtype("x", x)
    _dense("y_diag", y_diag, (b, nc, c, nh * hd), f32, dev)
    _dense("h_in", h_in, (b, nc, nh, n, hd), f32, dev)
    _dense("dacs", dacs, (b, nc, c, nh), f32, dev)
    _dense("C", C, (b, nc, c, n), f32, dev)
    _rows("x", x, (b, t, nh, hd), x.dtype, dev)
    if x.stride(2) != hd:
        raise ValueError(f"x needs dense heads, got strides {x.stride()}")
    d_bf16 = _weight("D", D, (nh,), dev)
    y = torch.empty((b, t, nh, hd), dtype=x.dtype, device=dev)
    err = _lib().ssd_output(
        code, hd, y_diag.data_ptr(), h_in.data_ptr(), dacs.data_ptr(),
        C.data_ptr(), x.data_ptr(), x.stride(0), x.stride(1), D.data_ptr(),
        d_bf16, y.data_ptr(), b, t, nc, c, nh, n, int(zero_first),
        _stream(x))
    launches += 1
    raise_on_error(err, "ssd_output")
    return y


def gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
               eps: float) -> torch.Tensor:
    """g = y·silu(z) rounded to y's dtype, then g·rsqrt(mean(g²) + eps)·
    (1 + w): y (b, t, di) contiguous, z (b, t, di) a view with a dense last
    axis (the projection's z columns), both fp32 or bf16; w (di,) fp32 or
    bf16.  Returns (b, t, di) in y's dtype.  Semantics of
    ``ref.gated_rmsnorm``; one launch, one block a row."""
    global launches
    if y.dim() != 3:
        raise ValueError(f"y must be (b, t, di), got {tuple(y.shape)}")
    _cuda(y)
    b, t, di = y.shape
    code = _dtype("y", y)
    dev = y.device
    _dense("y", y, (b, t, di), y.dtype, dev)
    _rows("z", z, (b, t, di), y.dtype, dev)
    w_bf16 = _weight("w", w, (di,), dev)
    out = torch.empty_like(y)
    err = _lib().gated_rmsnorm(code, y.data_ptr(), z.data_ptr(), z.stride(0),
                               z.stride(1), w.data_ptr(), w_bf16,
                               out.data_ptr(), b, t, di, float(eps),
                               _stream(y))
    launches += 1
    raise_on_error(err, "gated_rmsnorm")
    return out


class Passes(NamedTuple):
    """The six stages ``mixer`` composes, with the signatures of this
    module's wrappers (``intra``: ``ssd_scan.ssd_intra_chunk_fwd``'s)."""
    dt: object
    conv: object
    intra: object
    states: object
    output: object
    norm: object


KERNELS = Passes(ssd_dt, conv, ssd_scan.ssd_intra_chunk_fwd, chunk_states,
                 output, gated_norm)


def _plain_output(y_diag, h_in, dacs, C, x, D, *, zero_first=False):
    return ref.ssd_output(y_diag, h_in, dacs, C, x, D)


PLAIN = Passes(ref.ssd_dt, ref.mamba_conv, ref.ssd_intra_chunk,
               ref.ssd_chunk_states, _plain_output, ref.gated_rmsnorm)


def mixer(zxbcdt: torch.Tensor, p: dict, *, hd: int, n: int, chunk: int,
          eps: float, conv_state: torch.Tensor | None = None,
          h0: torch.Tensor | None = None, passes: Passes = KERNELS
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Mamba-2 mixer from its input projection zxbcdt (b, t, 2di + 2n +
    nh) to the gated norm's output, before ``w_out``: the weights of ``p``
    (``conv``, ``conv_b`` where the configuration has one, ``dt_bias``,
    ``A_log``, ``D``, ``norm``), ``conv_state`` (b, cw-1, di + 2n) and
    ``h0`` (b, nh, hd, n), each None in a fresh prefill.  Returns (y (b, t,
    di) in zxbcdt's dtype, the final state (b, nh, hd, n) fp32, the new
    conv context (b, cw-1, di + 2n)).  ``passes``: the kernels, or
    ``PLAIN``."""
    b, t, _ = zxbcdt.shape
    nh = p["A_log"].shape[-1]
    di = nh * hd
    dt, dacs = passes.dt(zxbcdt[..., 2 * di + 2 * n:], p["dt_bias"],
                         p["A_log"], chunk)
    nc, c = dacs.shape[1:3]
    out, new_conv, xdt, B, C = passes.conv(
        zxbcdt[..., di:2 * di + 2 * n], p["conv"], p.get("conv_b"),
        conv_state, dt, hd=hd)
    C = C.reshape(b, nc, c, n)
    y_diag, states = passes.intra(xdt.reshape(b, nc, c, di), dacs,
                                  B.reshape(b, nc, c, n), C, nh=nh, hd=hd)
    del xdt, B, dt              # freed before the later passes allocate
    h_in, h = passes.states(states, dacs, h0)
    y = passes.output(y_diag, h_in, dacs, C, out[..., :di].unflatten(
        -1, (nh, hd)), p["D"], zero_first=h0 is None)
    del y_diag, h_in, states
    y = passes.norm(y.reshape(b, t, di), zxbcdt[..., :di], p["norm"], eps)
    return y, h, new_conv
