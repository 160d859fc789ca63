"""The Mamba-2 SSD scan with its intra-chunk pass in a hand-written CUDA
kernel (``csrc/ssd_intra_chunk.cu``): the port of
``repro/kernels/ssd_scan.py``.

The SSD algorithm splits into (a) a quadratic attention-like pass inside each
chunk, which carries nearly all the FLOPs, and (b) a linear recurrence across
the chunks' states.  (a) is the kernel; (b), the padding, the casts, the
log-decay cumsum, ``y_off`` and the ``D`` skip stay in PyTorch here, as they
stay in XLA in the JAX package.

``ssd_intra_chunk`` takes CUDA tensors only: the kernel launches on the
current stream, without a synchronisation, into outputs allocated here.  Its
plain version is ``ref.ssd_intra_chunk``; ``ref.ssd_intra_chunk_tf32``
models the kernel's arithmetic (its fp32 products on TF32 tensor cores, each
operand split in two).  Under grad it runs as ``SSDIntraChunkFn``, whose
backward is a second hand-written kernel (``csrc/ssd_intra_chunk_bwd.cu``,
plain version ``ref.ssd_intra_chunk_bwd``), which the JAX package does not
have: its Pallas kernel has no reverse mode, so its training differentiates
``ref.ssd_chunked``; ``ref.ssd_intra_chunk_bwd_tf32`` models the backward's
arithmetic (3xTF32 products, the head-group and group sums in its order).
``launches`` counts the forward kernel's calls of this process,
``bwd_launches`` the backward's (one per call: a backward call is four
launches, three of them on TF32 wgmma: the scores C·Bᵀ once per chunk, one
block per group of ``bwd_plan``'s heads, the sum of the groups' partials,
and dC = dS·B, dB = dSᵀ·C plus the state term).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._wrap import raise_on_error
from .ref import _pad_chunks

launches = 0
bwd_launches = 0

HEAD_DIMS = (8, 16, 32, 64, 128)
# a y block keeps 64 rows of C and a ring of B tiles (d_state wide), and
# dacs for the chunk, in shared memory; these bounds keep a block within the
# card's 227 KB
MAX_CHUNK, MAX_STATE = 512, 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ssd_intra_chunk_fwd": [
    _I, _P, _P, _P, _P, _P, _P,            # hd, xdt, dacs, B, C, y, states
    _I, _I, _I, _I, _I, _P]}               # b, nc, c, nh, n, stream
_BWD_SIGNATURES = {"ssd_intra_chunk_bwd": [
    _I, _P, _P, _P, _P, _P, _P,            # hd, xdt, dacs, B, C, dy, dstates
    _P, _P, _P, _P, _P, _P, _P,            # dxdt, ddacs, dB, dC, scores, dS, R
    _I, _I, _I, _I, _I, _I, _P]}           # b, nc, c, nh, n, heads/group, stream
# the backward's tiles (64 rows, keys or state columns); the H100's SMs,
# each of which holds two head-group blocks at head_dim <= 64 (102 KB of
# shared memory a block) and one at 128 (198 KB)
BWD_TILE = 64
SMS = 132


def bwd_plan(b: int, nc: int, c: int, nh: int, n: int, hd: int = 64
             ) -> dict:
    """How the backward cuts its work, from shapes alone:
    ``heads_per_group`` heads go to one block per (group, chunk, batch),
    the count that minimises the rounds of resident blocks times the heads
    each block walks (the largest on a tie: the scratches shrink with it);
    ``groups``, ``blocks``; and the fp32 scratches, in 64 x 64 tiles:
    ``scores_bytes`` (C·Bᵀ per chunk), ``ds_bytes`` (each group's sum of
    dW ⊙ L) and ``r_bytes`` (each group's state term of dB)."""
    t = BWD_TILE
    slots = SMS * (2 if hd <= 64 else 1)

    def cost(gh: int) -> tuple[int, int]:
        rounds = -(-(-(-nh // gh) * nc * b) // slots)
        return rounds * gh, -gh

    gh = min(range(1, nh + 1), key=cost)
    groups = -(-nh // gh)
    nt, ncol = -(-c // t), -(-n // t)
    pairs = nt * (nt + 1) // 2
    tile = t * t * 4
    return dict(heads_per_group=gh, groups=groups, blocks=groups * nc * b,
                scores_bytes=b * nc * pairs * tile,
                ds_bytes=b * nc * groups * pairs * tile,
                r_bytes=b * nc * groups * nt * ncol * tile)


def _check(name: str, x: torch.Tensor, shape: tuple, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} is {x.dtype}, expected torch.float32")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must start on 16 bytes")


def _check_operands(xdt, dacs, B, C, nh: int, hd: int) -> tuple[int, ...]:
    """The forward's argument checks; returns (b, nc, c, n)."""
    if xdt.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got {xdt.device}; "
            "ops.* sends CPU tensors to the plain version")
    if xdt.dim() != 4:
        raise ValueError(f"xdt must be (b, nc, c, nh*hd), got "
                         f"{tuple(xdt.shape)}")
    b, nc, c, _ = xdt.shape
    n = B.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if c > MAX_CHUNK or n > MAX_STATE:
        raise ValueError(f"chunk {c} and d_state {n} must be at most "
                         f"{MAX_CHUNK} and {MAX_STATE}")
    for name, x, shape in (("xdt", xdt, (b, nc, c, nh * hd)),
                           ("dacs", dacs, (b, nc, c, nh)),
                           ("B", B, (b, nc, c, n)), ("C", C, (b, nc, c, n))):
        _check(name, x, shape, xdt.device)
    return b, nc, c, n


def ssd_intra_chunk_fwd(xdt: torch.Tensor, dacs: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor, *, nh: int, hd: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: xdt (b, nc, c, nh*hd), dacs (b, nc, c, nh), B/C
    (b, nc, c, n), all fp32.  Returns (y_diag (b, nc, c, nh*hd), states
    (b, nc, nh, n, hd)) in fp32.  Semantics of ``ref.ssd_intra_chunk``."""
    global launches
    b, nc, c, n = _check_operands(xdt, dacs, B, C, nh, hd)
    lib = _build.load("ssd_intra_chunk", _SIGNATURES)
    y = torch.empty_like(xdt)
    states = torch.empty((b, nc, nh, n, hd), dtype=torch.float32,
                         device=xdt.device)
    stream = torch.cuda.current_stream(xdt.device).cuda_stream
    err = lib.ssd_intra_chunk_fwd(
        hd, xdt.data_ptr(), dacs.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), states.data_ptr(), b, nc, c, nh, n, stream)
    launches += 1
    raise_on_error(err, "ssd_intra_chunk")
    return y, states


def _dense(x: torch.Tensor) -> torch.Tensor:
    """x itself where the kernel takes it (contiguous, on 16 bytes), else a
    dense copy: an output's gradient may be a strided view."""
    if x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def ssd_intra_chunk_bwd(xdt: torch.Tensor, dacs: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                        dstates: torch.Tensor, *, nh: int, hd: int
                        ) -> tuple[torch.Tensor, ...]:
    """The backward kernel: from the forward's inputs and the gradients of
    its outputs, dy (b, nc, c, nh*hd) and dstates (b, nc, nh, n, hd), the
    fp32 gradients (dxdt, ddacs, dB, dC) in the inputs' layouts.  Semantics
    of ``ref.ssd_intra_chunk_bwd``.  The sums over heads into dB and dC run
    in a fixed order (heads within a group, then groups): two calls give the
    same bits."""
    global bwd_launches
    b, nc, c, n = _check_operands(xdt, dacs, B, C, nh, hd)
    dy, dstates = _dense(dy), _dense(dstates)
    _check("dy", dy, (b, nc, c, nh * hd), xdt.device)
    _check("dstates", dstates, (b, nc, nh, n, hd), xdt.device)
    lib = _build.load("ssd_intra_chunk_bwd", _BWD_SIGNATURES)
    dxdt = torch.empty_like(xdt)
    ddacs = torch.empty_like(dacs)
    dB = torch.empty_like(B)
    dC = torch.empty_like(C)
    # scratch: each chunk's scores, each group's dW ⊙ L and dB state term
    plan = bwd_plan(b, nc, c, nh, n, hd)
    scores, ds, r = (torch.empty(plan[k] // 4, dtype=torch.float32,
                                 device=xdt.device)
                     for k in ("scores_bytes", "ds_bytes", "r_bytes"))
    stream = torch.cuda.current_stream(xdt.device).cuda_stream
    err = lib.ssd_intra_chunk_bwd(
        hd, xdt.data_ptr(), dacs.data_ptr(), B.data_ptr(), C.data_ptr(),
        dy.data_ptr(), dstates.data_ptr(), dxdt.data_ptr(), ddacs.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), scores.data_ptr(), ds.data_ptr(),
        r.data_ptr(), b, nc, c, nh, n, plan["heads_per_group"], stream)
    bwd_launches += 1
    raise_on_error(err, "ssd_intra_chunk_bwd")
    return dxdt, ddacs, dB, dC


class SSDIntraChunkFn(torch.autograd.Function):
    """The intra-chunk pass with a backward pass.  ``fwd(xdt, dacs, B, C,
    nh=, hd=)`` returns (y_diag, states) and ``bwd(xdt, dacs, B, C, dy,
    dstates, nh=, hd=)`` returns (dxdt, ddacs, dB, dC): the two kernels on
    the card (``ssd_intra_chunk`` passes them), the plain versions
    ``ref.ssd_intra_chunk`` / ``ref.ssd_intra_chunk_bwd`` where a CPU test
    runs this same code.  Saves the four inputs."""

    @staticmethod
    def forward(ctx, xdt, dacs, B, C, nh, hd, fwd, bwd):
        y, states = fwd(xdt, dacs, B, C, nh=nh, hd=hd)
        ctx.save_for_backward(xdt, dacs, B, C)
        ctx.nh, ctx.hd, ctx.bwd = nh, hd, bwd
        return y, states

    @staticmethod
    def backward(ctx, dy, dstates):
        # autograd gives an unused output's gradient as zeros, and either
        # may be a strided view (the kernel's wrapper makes it dense)
        xdt, dacs, B, C = ctx.saved_tensors
        grads = ctx.bwd(xdt, dacs, B, C, dy, dstates, nh=ctx.nh, hd=ctx.hd)
        return (*grads, None, None, None, None)


def ssd_intra_chunk(xdt: torch.Tensor, dacs: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, *, nh: int, hd: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """xdt (b, nc, c, nh*hd), dacs (b, nc, c, nh), B/C (b, nc, c, n), all
    fp32.  Returns (y_diag (b, nc, c, nh*hd), states (b, nc, nh, n, hd)) in
    fp32.  Semantics of ``ref.ssd_intra_chunk``.  Under grad with an input
    that requires it, the results' ``grad_fn`` runs the backward kernel
    (``SSDIntraChunkFn``); otherwise one forward launch."""
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (xdt, dacs, B, C)):
        return SSDIntraChunkFn.apply(xdt, dacs, B, C, nh, hd,
                                     ssd_intra_chunk_fwd, ssd_intra_chunk_bwd)
    return ssd_intra_chunk_fwd(xdt, dacs, B, C, nh=nh, hd=hd)


def chunk_operands(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, chunk: int
                   ) -> tuple[torch.Tensor, ...]:
    """The intra-chunk pass's fp32 operands, the time axis padded to whole
    chunks of ``min(chunk, t)``: xdt = x·dt (b, nc, c, nh*hd), the
    within-chunk cumsum of the log-decay dt·A (b, nc, c, nh), and B, C
    (b, nc, c, n)."""
    b, _, nh, hd = x.shape
    n = B.shape[-1]
    xp, dtp, Bp, Cp, c, nc = _pad_chunks(x, dt, B, C, chunk)
    dtf = dtp.float().reshape(b, nc, c, nh)
    xdt = (xp.float().reshape(b, nc, c, nh, hd) * dtf[..., None]).reshape(
        b, nc, c, nh * hd)
    dacs = torch.cumsum(dtf * A[None, None, None, :], 2)
    return (xdt, dacs, Bp.float().reshape(b, nc, c, n).contiguous(),
            Cp.float().reshape(b, nc, c, n).contiguous())


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, D: torch.Tensor, *, chunk: int = 128,
        h0: torch.Tensor | None = None, intra_chunk=ssd_intra_chunk
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``ref.ssd_chunked`` with the quadratic pass in ``intra_chunk``: the
    CUDA kernel, or, in the CPU tests of this function's own code,
    ``ref.ssd_intra_chunk``.  Returns y (b, t, nh, hd) in x's dtype and the
    final state (b, nh, hd, n) in fp32."""
    b, t, nh, hd = x.shape
    n = B.shape[-1]
    xdt, dA_cs, Bf, Cf = chunk_operands(x, dt, A, B, C, chunk)
    nc, c = xdt.shape[1:3]

    y_diag, states = intra_chunk(xdt, dA_cs, Bf, Cf, nh=nh, hd=hd)
    states = states.transpose(3, 4)                      # (b,nc,nh,hd,n)

    # inter-chunk recurrence (tiny, stays in PyTorch); h_in[z] is the state
    # entering chunk z
    h = (torch.zeros((b, nh, hd, n), device=x.device) if h0 is None
         else h0.float())
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])          # (b,nc,nh)
    h_in = []
    for z in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, z, :, None, None] + states[:, z]
    h_in = torch.stack(h_in, 1)

    in_decay = torch.exp(dA_cs)                          # (b,nc,c,nh)
    y_off = torch.einsum("bzcn,bzch,bzhpn->bzchp", Cf, in_decay, h_in)
    y = y_diag.reshape(b, nc, c, nh, hd) + y_off
    y = y.reshape(b, nc * c, nh, hd)[:, :t]
    y = y + x.float() * D[None, None, :, None]
    return y.to(x.dtype), h
