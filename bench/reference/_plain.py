"""Plain PyTorch pieces shared by the model references: fp32 arithmetic, no
kernels, no cache, no batching.

Every product of a weight goes through :func:`linear`, which computes in
fp32 (TF32 off: the caller of a reference sets
``torch.backends.cuda.matmul.allow_tf32 = False``), or, for the lower
precision control, with both operands rounded to fp8 e4m3 (a per-row scale
on the activations, a per-column scale on the weight) and the product
accumulated in fp32, as an fp8 GEMM computes it.  Nothing here imports the
program.
"""

from __future__ import annotations

import math

import torch

PRECISIONS = ("fp32", "fp8")
FP8_MAX = 448.0                  # largest finite float8_e4m3fn


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to the format's largest value)."""
    scale = x.abs().amax(dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str = "fp32"
           ) -> torch.Tensor:
    """x (..., k) @ w (k, m) in fp32, or in fp8 for the control."""
    xf, wf = x.float(), w.float()
    if precision == "fp8":
        xf, wf = _fp8(xf, -1), _fp8(wf, 0)
    elif precision != "fp32":
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    return xf @ wf


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) · (1 + w): the weight is stored as an offset from one."""
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (
        1.0 + w.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of (T, H, D) at positions 0..T-1, the two halves of
    the head dim rotated as a pair."""
    t, _, d = x.shape
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                    device=x.device) / d)
    ang = (torch.arange(t, dtype=torch.float64, device=x.device)[:, None]
           * freqs).float()
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.float().chunk(2, -1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int | None, block: int = 1024) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over keys j <= i (and j > i - window),
    q (T, Hq, D), k and v (T, Hkv, D), query head h reading key head
    h // (Hq / Hkv); computed in blocks of ``block`` queries."""
    t, hq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    kf = k.float().permute(1, 0, 2)                     # (Hkv, T, D)
    vf = v.float().permute(1, 0, 2)
    out = torch.empty((t, hq, d), dtype=torch.float32, device=q.device)
    kpos = torch.arange(t, device=q.device)
    for lo in range(0, t, block):
        hi = min(t, lo + block)
        qb = q[lo:hi].float().reshape(hi - lo, hkv, g, d).permute(1, 2, 0, 3)
        s = torch.einsum("hgqd,hkd->hgqk", qb, kf[:, :hi]) / math.sqrt(d)
        qpos = kpos[lo:hi, None]
        keep = kpos[None, :hi] <= qpos
        if window is not None:
            keep &= kpos[None, :hi] > qpos - window
        s = s.masked_fill(~keep, float("-inf"))
        p = torch.softmax(s, -1)
        ob = torch.einsum("hgqk,hkd->qhgd", p, vf[:, :hi])
        out[lo:hi] = ob.reshape(hi - lo, hq, d)
    return out


def gap_of(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per row: how far the logit of ``tokens`` lies below the row's
    largest (0 where the token is the row's best)."""
    best = logits.amax(-1)
    return best - logits.gather(-1, tokens.long()[:, None])[:, 0]
