"""Dispatch of the kernel entry points, the port's ``repro.kernels.ops``.

The tensor's device picks the path:

  * a CUDA tensor goes through the hand-written CUDA kernel
    (``flash_attention`` / ``decode_attention`` / the intra-chunk pass of
    ``ssd`` / ``ssd_decode_step_`` / ``mamba_prefill``'s passes), or the
    call raises.  Under grad, flash attention runs as ``FlashAttentionFn``
    (its forward kernel with the LSE output, and its backward kernel when
    the graph is differentiated) and the SSD intra-chunk pass as
    ``SSDIntraChunkFn`` (its forward and backward kernels; the rest of the
    scan is PyTorch under autograd);
  * a CPU tensor goes through the plain version in ``ref``:
    ``set_backend("blocked")`` (the default, as in the JAX package) or
    ``"naive"`` chooses which; torch's autograd differentiates it, as JAX's
    differentiates the reference's plain versions.

No backend value sends a CUDA tensor to the plain version.  Models call only
these entry points.

An abstract tensor (a ``FakeTensor``: the dry-run, ``launch.dryrun``) takes
the attention kernels' shape paths, ``flash_attention.
flash_attention_abstract`` and ``decode_attention.decode_attention_abstract``
/ ``merge_abstract``: the kernels' outputs and scratch allocated as on the
card and their FLOPs counted, nothing computed.  The plain blocked loop
would issue about 10⁵ abstract ops a layer at a 4k context, and the plain
decode an fp32 copy of each layer's cache; neither is what the card holds.
"""

from __future__ import annotations

from typing import Literal

import torch

from . import decode_attention as da
from . import flash_attention as fa
from . import mamba_prefill as mp
from . import ref, ssd_decode, ssd_scan

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

def _abstract(x) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor)


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                    lengths=None, block_q=512, block_k=512, scale=None):
    """``scale`` multiplies the scores (1 / sqrt(D) where None)."""
    if _abstract(q):
        return fa.flash_attention_abstract(q, k, v, causal=causal,
                                           window=window, q_offset=q_offset,
                                           lengths=lengths)
    if _on_cuda(q):
        return fa.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, lengths=lengths,
                                  scale=scale)
    if _BACKEND == "naive":
        return ref.attention_naive(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, lengths=lengths,
                                   scale=scale)
    return ref.attention_blocked(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, lengths=lengths,
                                 block_q=block_q, block_k=block_k,
                                 scale=scale)


# --------------------------------------------------------------------------
# Decode attention (one token vs. KV cache)
# --------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, lengths, *, window=None,
                     k_offset=0, return_lse=False, scale=None):
    """One token against a cache, or against a rank's share of one that
    starts at the global position ``k_offset``; with ``return_lse`` also the
    rows' log-sum-exps, for ``decode_merge``.  ``scale`` multiplies the
    scores (1 / sqrt(D) where None)."""
    kw = dict(window=window, k_offset=k_offset, return_lse=return_lse)
    if _abstract(q):
        return da.decode_attention_abstract(q, k_cache, v_cache, lengths,
                                            **kw)
    kw["scale"] = scale
    if _on_cuda(q):
        return da.decode_attention(q, k_cache, v_cache, lengths, **kw)
    return ref.decode_attention_naive(q, k_cache, v_cache, lengths, **kw)


def decode_merge(outs, lses):
    """The ranks' (output, log-sum-exp) over a sequence-split cache, (B, Hq,
    R, D) and (B, Hq, R), merged into (B, 1, Hq, D)."""
    if _abstract(outs):
        return da.merge_abstract(outs, lses)
    if _on_cuda(outs):
        return da.merge(outs, lses)
    return ref.decode_merge(outs, lses)


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
    """One-token SSM update in plain PyTorch on either device, returning
    (y, h_new): the JAX package's ``repro/kernels/ops.py::ssd_decode_step``,
    which runs it outside Pallas too.  The models step their cache with
    ``ssd_decode_step_``."""
    return ref.ssd_decode_step(h, x, dt, A, B, C, D)


def ssd_decode_impl(h) -> str:
    """Which path ``ssd_decode_step_`` takes for the state ``h``: "kernel"
    (``csrc/ssd_decode.cu``) for a CUDA tensor, "plain" for a CPU or
    abstract one."""
    return "plain" if _abstract(h) or not _on_cuda(h) else "kernel"


def ssd_decode_step_(h, x, dt, A, B, C, D):
    """One-token SSM update that writes the new state into ``h`` in place
    and returns y (b, nh, hd) in x's dtype.  A CUDA state goes through the
    CUDA kernel (``ssd_decode.ssd_decode_step_``: the state read once and
    written once); a CPU or abstract one through ``ref.ssd_decode_step``
    and a copy into ``h``."""
    if ssd_decode_impl(h) == "kernel":
        return ssd_decode.ssd_decode_step_(h, x, dt, A, B, C, D)
    y, h_new = ref.ssd_decode_step(h, x, dt, A, B, C, D)
    h.copy_(h_new)
    return y


def mamba_prefill_impl(x, *params, split: bool = False) -> str:
    """Which path a Mamba-2 mixer's prefill takes for its input ``x`` and
    weights ``params``: "kernels" (``mamba_prefill``) for a CUDA input with
    no gradient to keep (grad off, or no tensor that requires it) and no
    tensor-parallel or sequence split (``split``); "plain" (the eager code
    of ``layers.mamba_block``) for a CPU or abstract input, under grad, or
    under a split."""
    if split or _abstract(x) or not _on_cuda(x):
        return "plain"
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, *params)):
        return "plain"
    return "kernels"


def mamba_prefill(zxbcdt, p, *, hd, n, chunk, eps, conv_state=None,
                  h0=None):
    """The Mamba-2 mixer's prefill from its input projection to the gated
    norm's output (``mamba_prefill.mixer``): (y (b, t, di), final state,
    new conv context).  A CUDA projection goes through the five CUDA passes
    and the intra-chunk kernel, a CPU one through their plain versions."""
    passes = mp.KERNELS if _on_cuda(zxbcdt) else mp.PLAIN
    return mp.mixer(zxbcdt, p, hd=hd, n=n, chunk=chunk, eps=eps,
                    conv_state=conv_state, h0=h0, passes=passes)
