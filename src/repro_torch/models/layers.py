"""Building blocks of every family's layers, ported from
``repro.models.layers``.

Parameters are plain dicts of tensors with the JAX package's names and
layouts.  Compute runs in bf16 with fp32 norm, rope angles, softmax and SSM
state, as in the JAX package.  Attention and the SSD scan dispatch through
``repro_torch.kernels.ops``: the CUDA kernels on the card, the plain versions
on the CPU.

Under tensor parallelism (``sharding.ctx.tp()`` published by the sharded
train, prefill and decode steps) each weight arrives as the shard its spec
gives it, after ``sanitize``: a leaf whose split dim is narrower than the
model's is split over the group, one that is not stays whole.  Weights are
never gathered; activations cross the group instead, where the GSPMD
partitioning of the reference reshards them.  Every crossing is
differentiable (``sharding.comm``'s ``AllGatherFn`` and ``AllReduceFn``; a
rank's slice of a replicated tensor is a plain view), in the convention
that each rank's loss is its share of the global loss, so that a replicated
activation carries a partial gradient:

* a column-split projection's output is all-gathered where the next op
  needs whole heads or segments (one all-gather for q, k and v together);
* a row-split projection (``wo``, ``w_down``, ``w_out``, the MoE
  ``w_down``) takes its rows' slice of its input and its output is
  all-reduced;
* attention over a cache split by KV heads runs the rank's own heads; over
  a cache split along the sequence every rank attends with every head over
  its share (``k_offset``) and the ranks' (output, log-sum-exp) are
  merged (``ops.decode_merge``);
* the embedding split over the vocab is a masked lookup, all-reduced; the
  head gives the rank's vocab slice of the logits;
* the Mamba-2 mixer runs its conv on the rank's channels and the scan on
  the rank's heads, and all-reduces the gated RMSNorm's sum of squares.
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
    # under tensor parallelism: how the caches this call reads lie over the
    # group ("heads", "seq" or None: see the module's notes)
    tp = shard_ctx.tp()
    layout = None if tp is None else (
        tp.xkv if kv_override is not None else tp.kv)
    xc = x.to(COMPUTE_DTYPE)
    q = xc @ p["wq"].to(COMPUTE_DTYPE)
    if kv_override is None:
        k = xc @ p["wk"].to(COMPUTE_DTYPE)
        v = xc @ p["wv"].to(COMPUTE_DTYPE)
        if layout != "heads":
            q, k, v = _whole_cols([q, k, v], [hq * hd, hkv * hd, hkv * hd])
        q = rope(q.reshape(b, t, -1, hd), positions, cfg.rope_theta)
        k = rope(k.reshape(b, t, -1, hd), positions, cfg.rope_theta)
        v = v.reshape(b, t, -1, hd)
    else:
        k, v = kv_override
        if layout != "heads":
            (q,) = _whole_cols([q], [hq * hd])
        q = q.reshape(b, t, -1, hd)
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
        if layout == "seq":
            # the rank's share of the sequence: only the rank whose rows
            # hold position len-1 writes, the others write back what the
            # slot holds (a mask on the device, no read of the lengths on
            # the host); its (out, lse) are merged with the other ranks'
            s_loc = cache["k"].shape[1]
            off = shard_ctx.k_offset(s_loc)
            slot = slot - off
            own = ((slot >= 0) & (slot < s_loc))[:, None, None]
            slot = slot.clamp(0, s_loc - 1)
            for name, new in (("k", k), ("v", v)):
                c = cache[name]
                c[bidx, slot] = torch.where(own, new[:, 0].to(c.dtype),
                                            c[bidx, slot])
            out, lse = ops.decode_attention(q, cache["k"], cache["v"],
                                            lengths, window=window,
                                            k_offset=off, return_lse=True)
            out = ops.decode_merge(*comm.all_gather_out_lse(out, lse,
                                                            tp.group))
        else:
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
        if layout == "seq" and kv_override is None:
            new_cache = {"k": _seq_share(k), "v": _seq_share(v)}
    y = _row_split_out(out.reshape(b, t, -1), p["wo"], hq * hd)
    return y.to(x.dtype), new_cache


# --------------------------------------------------------------------------
# Tensor parallelism: the activations' crossings
# --------------------------------------------------------------------------

def _split(local: int, full: int) -> bool:
    """Whether a weight dim of ``full`` entries reached this rank split
    over the tensor-parallel group (``local`` its share)."""
    if local == full:
        return False
    _, n = shard_ctx.tp_rank_size()
    if local * n != full:
        raise ValueError(f"a dim of {local} entries is neither {full} nor "
                         f"its 1/{n} share")
    return True


def _share(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's equal slice of ``x`` along ``dim`` (a view)."""
    r, n = shard_ctx.tp_rank_size()
    m = x.shape[dim] // n
    return x.narrow(dim, r * m, m)


def _reduce(y: torch.Tensor) -> torch.Tensor:
    """The sum of the ranks' partial ``y`` (its gradient: the ranks'
    summed cotangents)."""
    return comm.all_reduce_autograd(y, shard_ctx.tp().group)


def _whole_cols(parts: list, fulls: list) -> list:
    """Each column shard (..., c) of ``parts`` whose ``fulls`` width it
    falls short of, gathered to (..., n·c) in rank order; one all-gather
    for all of them (its gradient: each rank's columns of the ranks' summed
    cotangents).  Parts already whole pass through."""
    idx = [i for i, (a, f) in enumerate(zip(parts, fulls))
           if _split(a.shape[-1], f)]
    if not idx:
        return list(parts)
    n = shard_ctx.tp_rank_size()[1]
    sizes = [parts[i].shape[-1] for i in idx]
    cat = torch.cat([parts[i] for i in idx], -1)
    g = comm.all_gather_autograd(cat[None], 0,
                                 shard_ctx.tp().group)        # (n, ..., c)
    out = list(parts)
    for i, piece in zip(idx, torch.split(g, sizes, -1)):
        out[i] = torch.movedim(piece, 0, -2).reshape(
            *piece.shape[1:-1], n * piece.shape[-1])
    return out


def _row_split_out(h: torch.Tensor, w: torch.Tensor, rows: int
                   ) -> torch.Tensor:
    """``h`` through ``w`` (``rows`` rows or the rank's share of them):
    where ``w`` is row-split, the rank's rows of ``h`` (``h`` whole, or
    already the share) and the partial products all-reduced."""
    wc = w.to(COMPUTE_DTYPE)
    if not _split(w.shape[0], rows):
        return h @ wc
    if h.shape[-1] == rows:
        h = _share(h, -1)
    return _reduce(h @ wc)


def cross_kv(cfg: ArchConfig, p: dict, src: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention keys and values of ``src`` (B, Tk, d), roped
    neither, in head layout (B, Tk, Hkv, hd).  Under tensor parallelism the
    rank's KV heads where the cross caches are split by heads, else every
    head (the column shards gathered)."""
    b, tk, _ = src.shape
    sc = src.to(COMPUTE_DTYPE)
    k = sc @ p["wk"].to(COMPUTE_DTYPE)
    v = sc @ p["wv"].to(COMPUTE_DTYPE)
    tp = shard_ctx.tp()
    if tp is not None and tp.xkv != "heads":
        full = cfg.n_kv_heads * cfg.hd
        k, v = _whole_cols([k, v], [full, full])
    return (k.reshape(b, tk, -1, cfg.hd), v.reshape(b, tk, -1, cfg.hd))


def _seq_share(k: torch.Tensor) -> torch.Tensor:
    """The rank's share of a prompt's (B, T, Hkv, hd) keys or values along
    the sequence, as the cache spec splits it; a length that does not split
    (an encoder's, whose entry is not kept) stays whole."""
    _, n = shard_ctx.tp_rank_size()
    return k if k.shape[1] % n else _share(k, 1)


# --------------------------------------------------------------------------
# MLP (gated / plain)
# --------------------------------------------------------------------------

def _act(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")              # geglu / gelu


def mlp(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Under tensor parallelism the rank's ``w_gate``/``w_up`` columns and
    ``w_down`` rows, the output all-reduced."""
    xc = x.to(COMPUTE_DTYPE)
    if "w_gate" in p:
        h = _act(cfg, xc @ p["w_gate"].to(COMPUTE_DTYPE)) * (
            xc @ p["w_up"].to(COMPUTE_DTYPE))
    else:
        h = _act(cfg, xc @ p["w_up"].to(COMPUTE_DTYPE))
    return _row_split_out(h, p["w_down"], cfg.d_ff).to(x.dtype)


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
    # under tensor parallelism the stacks are the rank's experts (E split)
    # or the rank's expert-FF slice: routed over all E, the rank's partial
    # sum, all-reduced (GSPMD's dense MoE over sharded stacks)
    e_loc = p["w_gate"].shape[-3]
    partial = shard_ctx.tp() is not None and (
        _split(e_loc, spec.num_experts)
        or _split(p["w_gate"].shape[-1], spec.d_ff_expert))
    if partial and e_loc != spec.num_experts:
        w = _share(w, 1)
    xc = x2.to(COMPUTE_DTYPE)[None]                          # (1, T, d)
    gate = torch.matmul(xc, p["w_gate"].to(COMPUTE_DTYPE))   # (E, T, f)
    up = torch.matmul(xc, p["w_up"].to(COMPUTE_DTYPE))
    h = _act(cfg, gate) * up
    out_e = torch.matmul(h, p["w_down"].to(COMPUTE_DTYPE))   # (E, T, d)
    y = torch.einsum("etd,te->td", out_e.float(), w)
    if partial:
        y = _reduce(y)
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
    a zero state and return the state they end in.

    Under tensor parallelism: ``w_in``'s column shard gathered whole (its
    columns cut through the z/x/B/C/dt segments), the depthwise conv on the
    rank's channels (a channel needs only its own weight and context) and
    its output gathered, the scan on the rank's heads of ``h``, the gated
    RMSNorm's sum of squares all-reduced, ``w_out``'s rows and an
    all-reduce.  Leaves that ``sanitize`` left whole compute whole."""
    if shard_ctx.seq_axes():
        raise NotImplementedError(
            f"{cfg.name}: a sequence split of the SSM scan; no GPU plan asks "
            "for one")
    spec = cfg.ssm
    b, t, d = x.shape
    di, n, nh = spec.d_inner(d), spec.d_state, spec.n_heads(d)
    tp = shard_ctx.tp()
    xc = x.to(COMPUTE_DTYPE)
    zxbcdt = xc @ p["w_in"].to(COMPUTE_DTYPE)
    if tp is not None:
        (zxbcdt,) = _whole_cols([zxbcdt], [2 * di + 2 * n + nh])
    z, xs, B, C, dt = torch.split(zxbcdt, [di, di, n, n, nh], -1)
    conv_in = torch.cat([xs, B, C], -1)
    conv_state = None if cache is None else cache["conv"]
    # the conv context split by channels, the state h by heads, as the
    # cache specs put them (the weights of those dims split alike)
    conv_split = tp is not None and tp.conv
    if conv_split:
        conv_in = _share(conv_in, -1)
    conv_out, new_conv = _causal_conv(conv_in, p["conv"].to(COMPUTE_DTYPE),
                                      conv_state)
    if conv_split:
        (conv_out,) = _whole_cols([conv_out], [di + 2 * n])
    xs, B, C = torch.split(conv_out, [di, n, n], -1)
    heads = tp is not None and tp.ssm_heads
    xh = xs.reshape(b, t, nh, spec.head_dim)
    if heads:
        xh, dt, z = _share(xh, 2), _share(dt, -1), _share(z, -1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())      # (B,T,nh)
    A = -torch.exp(p["A_log"].float())
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
    y = y.reshape(b, t, -1)
    g = y * F.silu(z.float()).to(y.dtype)
    if tp is None:
        y = rmsnorm(g, p["norm"])
    else:
        y = _gated_norm_tp(g, p["norm"], di, heads)
    out = _row_split_out(y.to(COMPUTE_DTYPE), p["w_out"], di)
    return out.to(x.dtype), new_cache


def _gated_norm_tp(g: torch.Tensor, w: torch.Tensor, di: int, heads: bool
                   ) -> torch.Tensor:
    """``rmsnorm`` over the d_inner channels of ``g`` under tensor
    parallelism: ``g`` whole, or the rank's head channels (``heads``),
    whose sum of squares is all-reduced; ``w`` whole or the rank's channel
    slice.  Returns the channels ``w`` covers (``layers.rmsnorm``'s
    arithmetic)."""
    gf = g.float()
    ss = (gf * gf).sum(-1, keepdim=True)
    if heads:
        ss = _reduce(ss)
    scale = torch.rsqrt(ss / di + 1e-6)
    if not heads and _split(w.shape[-1], di):
        gf = _share(gf, -1)
    return ((gf * scale) * (1.0 + w)).to(g.dtype)


# --------------------------------------------------------------------------
# Embedding / head
# --------------------------------------------------------------------------

def embed(p: dict, tokens: torch.Tensor, vocab: int | None = None
          ) -> torch.Tensor:
    """The tokens' rows of the embedding.  Under tensor parallelism with
    the vocab split (the rank's ``vocab``/n rows), a lookup masked to the
    rank's rows, all-reduced."""
    e = p["embedding"]
    if (shard_ctx.tp() is None or vocab is None
            or not _split(e.shape[0], vocab)):
        return e[tokens]
    r, _ = shard_ctx.tp_rank_size()
    local = tokens.long() - r * e.shape[0]
    mine = (local >= 0) & (local < e.shape[0])
    rows = e[local.clamp(0, e.shape[0] - 1)]
    return _reduce(torch.where(mine[..., None], rows, torch.zeros_like(rows)))


def unembed(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, T, d) → (B, T, V) fp32 logits; under tensor parallelism with the
    vocab split, the rank's vocab slice of them (``specs.logits_pspec``)."""
    w = p["embedding"].T if cfg.tie_embeddings else p["head"]
    return (x.to(COMPUTE_DTYPE) @ w.to(COMPUTE_DTYPE)).float()
