"""Building blocks of every family's layers, ported from
``repro.models.layers``.

Parameters are plain dicts of tensors with the JAX package's names and
layouts.  Compute runs in bf16 with fp32 norm, rope angles, softmax and SSM
state, as in the JAX package.  Attention and the SSD scan dispatch through
``repro_torch.kernels.ops``: the CUDA kernels on the card, the plain versions
on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.sharding import comm
from repro_torch.sharding import ctx as shard_ctx
from .config import ArchConfig, MoESpec

COMPUTE_DTYPE = torch.bfloat16


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + w)).to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def apply_norm(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p["b"], cfg.norm_eps)
    return rmsnorm(x, p["w"], cfg.norm_eps)


# --------------------------------------------------------------------------
# Rotary position embedding
# --------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (B, T, H, D) with D even; positions: (B, T) absolute indices.
    Split-half rotation with the angles in fp32."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    ang = positions[..., None].float() * freqs                # (B,T,D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention block (self / cross, with optional KV cache)
# --------------------------------------------------------------------------

def attention(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
              positions: torch.Tensor, mode: str, causal: bool = True,
              window: int | None = None, cache: dict | None = None,
              lengths: torch.Tensor | None = None,
              kv_override: tuple[torch.Tensor, torch.Tensor] | None = None
              ) -> tuple[torch.Tensor, dict | None]:
    """Self- or cross-attention.

    mode: "full"   — train/prefill over the whole sequence; returns the
                     (k, v) computed here as the new cache entry.
          "decode" — T == 1; writes the new token's k/v into ``cache``
                     {"k","v"} of shape (B,S,Hkv,hd) at ``lengths-1`` and
                     attends over it.
    kv_override: (k, v) already in head layout, (B, Tk, Hkv, hd) — the
                 cross-attention of the whisper decoder and the VLM's image
                 layers.  Its keys are not roped, and the query only when
                 ``causal``; decode attends over all Tk keys and writes no
                 cache.

    Under a sequence split (``sharding.ctx.seq_group``), x is this rank's
    slice of the sequence and ``positions`` are global: "full" self-attention
    gathers k and v over the split (its backward reduce-scatters their
    gradients) and runs the kernel with the queries offset to their place;
    the cache entry keeps the rank's own k and v.
    """
    b, t, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    xc = x.to(COMPUTE_DTYPE)
    q = (xc @ p["wq"].to(COMPUTE_DTYPE)).reshape(b, t, hq, hd)
    if kv_override is None:
        k = (xc @ p["wk"].to(COMPUTE_DTYPE)).reshape(b, t, hkv, hd)
        v = (xc @ p["wv"].to(COMPUTE_DTYPE)).reshape(b, t, hkv, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    else:
        k, v = kv_override
        if causal:
            q = rope(q, positions, cfg.rope_theta)

    if mode == "decode" and kv_override is None:
        if cache is None or lengths is None:
            raise ValueError("decode mode needs cache and lengths")
        slot = lengths.long() - 1                             # (B,)
        bidx = torch.arange(b, device=x.device)
        # Written in place: the engine owns the cache, where the JAX engine
        # donates it and rebuilds it functionally with .at[].set — in place
        # saves a copy of the whole (B,S,Hkv,hd) cache per layer and step.
        cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
        out = ops.decode_attention(q, cache["k"], cache["v"], lengths,
                                   window=window)
        new_cache = cache
    elif mode == "decode":                                # cross, static KV
        full = torch.full((b,), k.shape[1], dtype=torch.int32,
                          device=x.device)
        out = ops.decode_attention(q, k, v, full, window=None)
        new_cache = cache
    else:
        group = None if kv_override is not None else shard_ctx.seq_group()
        kg, vg, q_offset = k, v, 0
        if group is not None:
            kg, vg = (comm.all_gather_autograd(a, 1, group) for a in (k, v))
            q_offset = shard_ctx.seq_offset(t)
        out = ops.flash_attention(q, kg, vg, causal=causal, window=window,
                                  q_offset=q_offset, lengths=lengths)
        new_cache = {"k": k, "v": v}
    out = out.reshape(b, t, hq * hd)
    return (out @ p["wo"].to(COMPUTE_DTYPE)).to(x.dtype), new_cache


# --------------------------------------------------------------------------
# MLP (gated / plain)
# --------------------------------------------------------------------------

def _act(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")              # geglu / gelu


def mlp(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    xc = x.to(COMPUTE_DTYPE)
    if "w_gate" in p:
        h = _act(cfg, xc @ p["w_gate"].to(COMPUTE_DTYPE)) * (
            xc @ p["w_up"].to(COMPUTE_DTYPE))
    else:
        h = _act(cfg, xc @ p["w_up"].to(COMPUTE_DTYPE))
    return (h @ p["w_down"].to(COMPUTE_DTYPE)).to(x.dtype)


# --------------------------------------------------------------------------
# Mixture-of-Experts FFN
# --------------------------------------------------------------------------

MOE_IMPLS = ("dense", "ep_a2a", "ep_a2a_q8")


def moe_router(spec: MoESpec, router_w: torch.Tensor, x2d: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing.  Returns (weights (T, k) fp32, indices (T, k) int32):
    the softmax over fp32 logits, its k largest, renormalised to sum 1."""
    logits = x2d.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.topk(probs, spec.top_k, dim=-1)
    vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return vals, idx.to(torch.int32)


def moe_dense(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The oracle lowering: every expert computes every token, and a routed
    combine mixes their outputs (the JAX package's ``moe_dense``, which its
    engine serves).  The expert products are batched matmuls of x (1, T, d)
    broadcast against the (E, d, f) stacks, which reads each stack in place;
    an einsum may permute a stack into (d, E·f) first, a copy larger than
    the product at decode."""
    spec = cfg.moe
    b, t, d = x.shape
    x2 = x.reshape(b * t, d)
    vals, idx = moe_router(spec, p["router"], x2)
    w = torch.zeros((b * t, spec.num_experts), dtype=torch.float32,
                    device=x.device).scatter_add_(1, idx.long(), vals)
    xc = x2.to(COMPUTE_DTYPE)[None]                          # (1, T, d)
    gate = torch.matmul(xc, p["w_gate"].to(COMPUTE_DTYPE))   # (E, T, f)
    up = torch.matmul(xc, p["w_up"].to(COMPUTE_DTYPE))
    h = _act(cfg, gate) * up
    out_e = torch.matmul(h, p["w_down"].to(COMPUTE_DTYPE))   # (E, T, d)
    y = torch.einsum("etd,te->td", out_e.float(), w)
    return y.reshape(b, t, d).to(x.dtype)


def moe_apply(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
              impl: str = "dense") -> torch.Tensor:
    """``impl``: "dense" (``moe_dense``), or the expert-parallel step at an
    EP axis of width 1 (``moe_ep.moe_ep_a2a``: routed tokens sorted by
    expert through grouped products), its all-to-all payload in bf16
    ("ep_a2a") or in int8 with fp32 row scales ("ep_a2a_q8")."""
    if impl not in MOE_IMPLS:
        raise ValueError(f"moe impl {impl!r} not in {MOE_IMPLS}")
    if impl == "dense":
        return moe_dense(cfg, p, x)
    from . import moe_ep
    return moe_ep.moe_ep_a2a(
        cfg, p, x, a2a_dtype="int8" if impl == "ep_a2a_q8" else "bfloat16")


# --------------------------------------------------------------------------
# Mamba-2 (SSD) block
# --------------------------------------------------------------------------

def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 conv_state: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, width cw.  xbc: (B,T,C); w: (cw,C).
    conv_state: (B,cw-1,C) carried context (decode) or None (prefill).
    Returns (out (B,T,C), new_state (B,cw-1,C))."""
    cw, t = w.shape[0], xbc.shape[1]
    if conv_state is None:
        conv_state = xbc.new_zeros((xbc.shape[0], cw - 1, xbc.shape[2]))
    full = torch.cat([conv_state, xbc], 1)                 # (B,T+cw-1,C)
    out = sum(full[:, i:i + t] * w[i][None, None] for i in range(cw))
    return F.silu(out), full[:, -(cw - 1):]


def mamba_block(cfg: ArchConfig, p: dict, x: torch.Tensor, *, mode: str,
                cache: dict | None = None) -> tuple[torch.Tensor, dict]:
    """One Mamba-2 mixer.  cache = {"h": (B,nh,hd,n), "conv": (B,cw-1,C)}.

    mode="decode" (T == 1) steps the recurrence from ``cache`` and writes the
    new state into it in place (the engine owns the cache; the JAX engine
    rebuilds it functionally instead); other modes run the chunked scan from
    a zero state and return the state they end in."""
    if shard_ctx.seq_axes():
        raise NotImplementedError(
            f"{cfg.name}: a sequence split of the SSM scan; no GPU plan asks "
            "for one")
    spec = cfg.ssm
    b, t, d = x.shape
    di, n, nh = spec.d_inner(d), spec.d_state, spec.n_heads(d)
    xc = x.to(COMPUTE_DTYPE)
    zxbcdt = xc @ p["w_in"].to(COMPUTE_DTYPE)
    z, xs, B, C, dt = torch.split(zxbcdt, [di, di, n, n, nh], -1)
    conv_in = torch.cat([xs, B, C], -1)
    conv_state = None if cache is None else cache["conv"]
    conv_out, new_conv = _causal_conv(conv_in, p["conv"].to(COMPUTE_DTYPE),
                                      conv_state)
    xs, B, C = torch.split(conv_out, [di, n, n], -1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())      # (B,T,nh)
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(b, t, nh, spec.head_dim)
    D = p["D"].float()
    if mode == "decode":
        if cache is None:
            raise ValueError("decode mode needs the SSM cache")
        y, h_new = ops.ssd_decode_step(cache["h"], xh[:, 0], dt[:, 0], A,
                                       B[:, 0], C[:, 0], D)
        y = y[:, None]                                      # (B,1,nh,hd)
        cache["h"].copy_(h_new)
        cache["conv"].copy_(new_conv)
        new_cache = cache
    else:
        y, h_new = ops.ssd(xh, dt, A, B, C, D, chunk=spec.chunk,
                           h0=None if cache is None else cache["h"])
        new_cache = {"h": h_new, "conv": new_conv}
    y = y.reshape(b, t, di)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p["norm"])
    out = y.to(COMPUTE_DTYPE) @ p["w_out"].to(COMPUTE_DTYPE)
    return out.to(x.dtype), new_cache


# --------------------------------------------------------------------------
# Embedding / head
# --------------------------------------------------------------------------

def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens]


def unembed(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    w = p["embedding"].T if cfg.tie_embeddings else p["head"]
    return (x.to(COMPUTE_DTYPE) @ w.to(COMPUTE_DTYPE)).float()
