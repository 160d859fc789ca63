"""Dispatch of the kernel entry points, the port's ``repro.kernels.ops``.

The tensor's device picks the path:

  * a CUDA tensor goes through the hand-written CUDA kernel
    (``flash_attention`` / ``decode_attention`` / the intra-chunk pass of
    ``ssd``), or the call raises.  Under grad, flash attention runs as
    ``FlashAttentionFn`` (its forward kernel with the LSE output, and its
    backward kernel when the graph is differentiated) and the SSD
    intra-chunk pass as ``SSDIntraChunkFn`` (its forward and backward
    kernels; the rest of the scan is PyTorch under autograd);
  * a CPU tensor goes through the plain version in ``ref``:
    ``set_backend("blocked")`` (the default, as in the JAX package) or
    ``"naive"`` chooses which; torch's autograd differentiates it, as JAX's
    differentiates the reference's plain versions.

No backend value sends a CUDA tensor to the plain version.  Models call only
these entry points.
"""

from __future__ import annotations

from typing import Literal

from . import decode_attention as da
from . import flash_attention as fa
from . import ref, ssd_scan

Backend = Literal["blocked", "naive"]
_BACKENDS = ("blocked", "naive")
_BACKEND: Backend = "blocked"


def set_backend(backend: Backend) -> None:
    """Choose the plain version CPU tensors go through."""
    global _BACKEND
    if backend not in _BACKENDS:
        raise ValueError(
            f"backend {backend!r} not in {_BACKENDS}: CUDA tensors always go "
            "through the CUDA kernels")
    _BACKEND = backend


def get_backend() -> Backend:
    return _BACKEND


def _on_cuda(x) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}: cuda or cpu")
    return False


# --------------------------------------------------------------------------
# Attention (prefill / training)
# --------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                    lengths=None, block_q=512, block_k=512):
    if _on_cuda(q):
        return fa.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, lengths=lengths)
    if _BACKEND == "naive":
        return ref.attention_naive(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, lengths=lengths)
    return ref.attention_blocked(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, lengths=lengths,
                                 block_q=block_q, block_k=block_k)


# --------------------------------------------------------------------------
# Decode attention (one token vs. KV cache)
# --------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, lengths, *, window=None):
    if _on_cuda(q):
        return da.decode_attention(q, k_cache, v_cache, lengths,
                                   window=window)
    return ref.decode_attention_naive(q, k_cache, v_cache, lengths,
                                      window=window)


# --------------------------------------------------------------------------
# Mamba-2 SSD
# --------------------------------------------------------------------------

def ssd(x, dt, A, B, C, D, *, chunk=128, h0=None):
    """Chunked SSD scan (prefill/training); the intra-chunk pass of a CUDA
    tensor runs in the CUDA kernel."""
    if _on_cuda(x):
        return ssd_scan.ssd(x, dt, A, B, C, D, chunk=chunk, h0=h0)
    if _BACKEND == "naive":
        return ref.ssd_naive(x, dt, A, B, C, D, h0=h0)
    return ref.ssd_chunked(x, dt, A, B, C, D, chunk=chunk, h0=h0)


def ssd_decode_step(h, x, dt, A, B, C, D):
    """One-token SSM update in plain PyTorch on either device.  No TPU
    kernel computes it: the JAX package runs it outside Pallas too
    (``repro/kernels/ops.py::ssd_decode_step``), so this mirrors it and is
    not a fallback."""
    return ref.ssd_decode_step(h, x, dt, A, B, C, D)
