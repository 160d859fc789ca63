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
model's is split over the group of the axes its spec names (one tp axis,
or under ``tp_all`` both, ``data`` alone or ``model`` alone), one that is
not stays whole.  Weights are never gathered; activations cross the group
of the leaf's own axes instead (``TPState.split``: never read off a local
shape, which at (2, 2) cannot tell ``data`` from ``model``), where the
GSPMD partitioning of the reference reshards them.  Every crossing is
differentiable (``sharding.comm``'s ``AllGatherFn`` and ``AllReduceFn``; a
rank's slice of a replicated tensor is a plain view), in the convention
that each rank's loss is its share of the global loss, so that a replicated
activation carries a partial gradient:

* a column-split projection's output is brought to the split the next op
  needs: gathered whole (one all-gather per group), then the rank's block
  of the heads or channels it computes on (``_cols_to``);
* a row-split projection (``wo``, ``w_down``, ``w_out``, the MoE
  ``w_down``) takes its rows' block of its input and its output is
  all-reduced over its rows' group;
* attention runs the rank's KV heads over the cache's head split
  (``TPState.kv_heads``); over a cache whose sequence is split
  (``TPState.kv_seq``: the plan's ``seq_axes`` under ``ctx_tp``, and the
  tp axes the KV heads do not divide) each rank attends over its share
  (``k_offset``) and the ranks' (output, log-sum-exp) are merged over that
  group, which may span both axes (``ops.decode_merge``);
* the embedding split over the vocab is a masked lookup, all-reduced; the
  head gives the rank's vocab slice of the logits;
* the Mamba-2 mixer runs its conv on the rank's channels and the scan on
  the rank's heads, and all-reduces the gated RMSNorm's sum of squares.

Under an activation sequence split (``seq_tp``'s ``data``, ``dp_sp_fsdp``'s
``model``) attention gathers keys and values over it, the Mamba-2 scan
exchanges the ranks' final states (``_ssd_seq_split``), and the last
positions' logits come from the last rank (``seq_tail``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
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

    Without ``cfg.rope`` neither query nor key is roped (NoPE); the scores
    are scaled by ``cfg.attn_scale`` where given, else 1 / sqrt(hd).

    Under a sequence split (``sharding.ctx.seq_group``), x is this rank's
    slice of the sequence and ``positions`` are global: "full" self-attention
    gathers k and v over the split (its backward reduce-scatters their
    gradients) and runs the kernel with the queries offset to their place;
    the cache entry keeps the rank's own k and v (its share of them where
    the cache's sequence lies over tp axes too).
    """
    b, t, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    # under tensor parallelism: the KV-head split of the caches this call
    # reads, and the self-attention cache's sequence split (see the
    # module's notes)
    tp = shard_ctx.tp()
    heads = seq = shard_ctx.NO_SPLIT
    if tp is not None:
        heads = tp.xkv if kv_override is not None else tp.kv_heads
        seq = tp.kv_seq if kv_override is None else seq
    xc = x.to(COMPUTE_DTYPE)
    q = xc @ p["wq"].to(COMPUTE_DTYPE)
    if kv_override is None:
        k = xc @ p["wk"].to(COMPUTE_DTYPE)
        v = xc @ p["wv"].to(COMPUTE_DTYPE)
        if tp is not None:
            q, k, v = _cols_to(
                [q, k, v], [_wsplit(p["wq"], hq * hd),
                            _wsplit(p["wk"], hkv * hd),
                            _wsplit(p["wv"], hkv * hd)], heads)
        q, k = q.reshape(b, t, -1, hd), k.reshape(b, t, -1, hd)
        if cfg.rope:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        v = v.reshape(b, t, -1, hd)
    else:
        k, v = kv_override
        if tp is not None:
            (q,) = _cols_to([q], [_wsplit(p["wq"], hq * hd)], heads)
        q = q.reshape(b, t, -1, hd)
        if causal and cfg.rope:
            q = rope(q, positions, cfg.rope_theta)

    if mode == "decode" and kv_override is None:
        if cache is None or lengths is None:
            raise ValueError("decode mode needs cache and lengths")
        slot = lengths.long() - 1                             # (B,)
        bidx = torch.arange(b, device=x.device)
        # Written in place: the engine owns the cache, where the JAX engine
        # donates it and rebuilds it functionally with .at[].set — in place
        # saves a copy of the whole (B,S,Hkv,hd) cache per layer and step.
        if seq.size > 1:
            # the rank's share of the sequence: only the rank whose rows
            # hold position len-1 writes, the others write back what the
            # slot holds (a mask on the device, no read of the lengths on
            # the host); its (out, lse) are merged with the other ranks' of
            # the sequence group (which may span the data and model axes)
            s_loc = cache["k"].shape[1]
            off = seq.rank * s_loc
            slot = slot - off
            own = ((slot >= 0) & (slot < s_loc))[:, None, None]
            slot = slot.clamp(0, s_loc - 1)
            for name, new in (("k", k), ("v", v)):
                c = cache[name]
                c[bidx, slot] = torch.where(own, new[:, 0].to(c.dtype),
                                            c[bidx, slot])
            out, lse = ops.decode_attention(q, cache["k"], cache["v"],
                                            lengths, window=window,
                                            k_offset=off, return_lse=True,
                                            scale=cfg.attn_scale)
            out = ops.decode_merge(*comm.all_gather_out_lse(out, lse,
                                                            seq.group))
        else:
            cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
            cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
            out = ops.decode_attention(q, cache["k"], cache["v"], lengths,
                                       window=window, scale=cfg.attn_scale)
        new_cache = cache
    elif mode == "decode":                                # cross, static KV
        full = torch.full((b,), k.shape[1], dtype=torch.int32,
                          device=x.device)
        out = ops.decode_attention(q, k, v, full, window=None,
                                   scale=cfg.attn_scale)
        new_cache = cache
    else:
        group = None if kv_override is not None else shard_ctx.seq_group()
        kg, vg, q_offset = k, v, 0
        if group is not None:
            kg, vg = (comm.all_gather_autograd(a, 1, group) for a in (k, v))
            q_offset = shard_ctx.seq_offset(t)
        out = ops.flash_attention(q, kg, vg, causal=causal, window=window,
                                  q_offset=q_offset, lengths=lengths,
                                  scale=cfg.attn_scale)
        new_cache = {"k": k, "v": v}
        if tp is not None and kv_override is None:
            new_cache = {"k": _seq_share(k, tp.kv_seq_tp),
                         "v": _seq_share(v, tp.kv_seq_tp)}
    y = _row_split_out(out.reshape(b, t, -1), p["wo"], hq * hd, heads)
    return y.to(x.dtype), new_cache


# --------------------------------------------------------------------------
# Tensor parallelism: the activations' crossings
# --------------------------------------------------------------------------
#
# Every crossing names its groups (``sharding.ctx.Group``): a weight's
# from its sanitized spec (``_wsplit``: ``TPState.split``), an activation's
# from the split it was computed at.  At (2, 2) under ``tp_all`` a dim
# split over ``data`` alone has the local shape of one split over
# ``model`` alone, so no group is read off a shape.

NO_SPLIT = shard_ctx.NO_SPLIT


def _wsplit(w: torch.Tensor, full: int, dim: int = -1) -> shard_ctx.Group:
    """The group ``w``'s dim ``dim`` (``full`` entries in the whole weight)
    is split over; ``NO_SPLIT`` where it came whole or outside tensor
    parallelism."""
    tp = shard_ctx.tp()
    if tp is None:
        return NO_SPLIT
    return tp.split(w.shape[dim], full)


def _share(x: torch.Tensor, dim: int, g: shard_ctx.Group) -> torch.Tensor:
    """This rank's equal block of ``x`` along ``dim`` over ``g`` (a
    view)."""
    if g.size == 1:
        return x
    m = x.shape[dim] // g.size
    return x.narrow(dim, g.rank * m, m)


def _reduce(y: torch.Tensor, g: shard_ctx.Group) -> torch.Tensor:
    """The sum of ``g``'s ranks' partial ``y`` (its gradient: the ranks'
    summed cotangents)."""
    return comm.all_reduce_autograd(y, g.group)


def _whole_cols(parts: list, groups: list) -> list:
    """Each column block (..., c) of ``parts`` split over its group in
    ``groups``, gathered to (..., n·c) in the group's rank order: one
    all-gather per distinct group (its gradient: each rank's columns of the
    ranks' summed cotangents).  Parts split over no group pass through."""
    out = list(parts)
    by: dict = {}
    for i, g in enumerate(groups):
        if g.size > 1:
            by.setdefault(g.axes, []).append(i)
    for idx in by.values():
        g = groups[idx[0]]
        sizes = [parts[i].shape[-1] for i in idx]
        cat = torch.cat([parts[i] for i in idx], -1)
        gathered = comm.all_gather_autograd(cat[None], 0, g.group)
        for i, piece in zip(idx, torch.split(gathered, sizes, -1)):
            out[i] = torch.movedim(piece, 0, -2).reshape(
                *piece.shape[1:-1], g.size * piece.shape[-1])
    return out


def _cols_to(parts: list, srcs: list, dst: shard_ctx.Group) -> list:
    """Each part, its columns split over its group in ``srcs``, as
    ``dst``'s block of its whole columns: gathered whole where the groups
    differ (one all-gather per source group), then sliced; a part already
    split as ``dst`` passes through."""
    idx = [i for i, g in enumerate(srcs) if g.axes != dst.axes]
    whole = _whole_cols([parts[i] for i in idx], [srcs[i] for i in idx])
    out = list(parts)
    for i, w in zip(idx, whole):
        out[i] = _share(w, -1, dst)
    return out


def _row_split_out(h: torch.Tensor, w: torch.Tensor, rows: int,
                   src: shard_ctx.Group = NO_SPLIT) -> torch.Tensor:
    """``h`` (its ``rows`` columns split over ``src``) through ``w``
    (``rows`` rows, or its spec's share of them): ``h`` brought to ``w``'s
    rows, and where ``w`` is row-split the partial products all-reduced
    over its group."""
    wc = w.to(COMPUTE_DTYPE)
    g = _wsplit(w, rows, 0)
    (h,) = _cols_to([h], [src], g)
    y = h @ wc
    return y if g.size == 1 else _reduce(y, g)


def cross_kv(cfg: ArchConfig, p: dict, src: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention keys and values of ``src`` (B, Tk, d), roped
    neither, in head layout (B, Tk, Hkv, hd).  Under tensor parallelism the
    rank's KV heads over the cross caches' head split, else every head."""
    b, tk, _ = src.shape
    sc = src.to(COMPUTE_DTYPE)
    k = sc @ p["wk"].to(COMPUTE_DTYPE)
    v = sc @ p["wv"].to(COMPUTE_DTYPE)
    tp = shard_ctx.tp()
    if tp is not None:
        full = cfg.n_kv_heads * cfg.hd
        k, v = _cols_to([k, v], [_wsplit(p["wk"], full),
                                 _wsplit(p["wv"], full)], tp.xkv)
    return (k.reshape(b, tk, -1, cfg.hd), v.reshape(b, tk, -1, cfg.hd))


def _seq_share(k: torch.Tensor, g: shard_ctx.Group) -> torch.Tensor:
    """The rank's share over ``g`` of a prompt's (B, T, Hkv, hd) keys or
    values along the sequence (``T`` this rank's rows under an activation
    sequence split), as the cache spec splits it; a length that does not
    split (an encoder's, whose entry is not kept) stays whole."""
    return k if k.shape[1] % g.size else _share(k, 1, g)


# --------------------------------------------------------------------------
# MLP (gated / plain)
# --------------------------------------------------------------------------

def _act(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")              # geglu / gelu


def mlp(cfg: ArchConfig, p: dict, x: torch.Tensor,
        d_ff: int | None = None) -> torch.Tensor:
    """``d_ff`` wide (``cfg.d_ff`` by default; the shared expert passes its
    own).  Under tensor parallelism the rank's ``w_gate``/``w_up`` columns
    and ``w_down`` rows, the output all-reduced."""
    ff = cfg.d_ff if d_ff is None else d_ff
    xc = x.to(COMPUTE_DTYPE)
    if "w_gate" in p:
        h = _act(cfg, xc @ p["w_gate"].to(COMPUTE_DTYPE)) * (
            xc @ p["w_up"].to(COMPUTE_DTYPE))
    else:
        h = _act(cfg, xc @ p["w_up"].to(COMPUTE_DTYPE))
    return _row_split_out(h, p["w_down"], ff,
                          _wsplit(p["w_up"], ff)).to(x.dtype)


# --------------------------------------------------------------------------
# Mixture-of-Experts FFN
# --------------------------------------------------------------------------

MOE_IMPLS = ("dense", "ep_a2a", "ep_a2a_q8", "routed")


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
    combine mixes their outputs (the JAX package's ``moe_dense``, which the
    JAX engine serves; the port serves "routed", ``moe_apply``, and keeps
    this as the oracle and the training default).  The expert products are
    batched matmuls of x (1, T, d) broadcast against the (E, d, f) stacks,
    which reads each stack in place; an einsum may permute a stack into
    (d, E·f) first, a copy larger than the product at decode."""
    spec = cfg.moe
    b, t, d = x.shape
    x2 = x.reshape(b * t, d)
    vals, idx = moe_router(spec, p["router"], x2)
    w = torch.zeros((b * t, spec.num_experts), dtype=torch.float32,
                    device=x.device).scatter_add_(1, idx.long(), vals)
    # under tensor parallelism the stacks are the rank's experts (E split)
    # or the rank's expert-FF slice, each over the group of its spec's axes:
    # routed over all E, the rank's partial sum, all-reduced (GSPMD's dense
    # MoE over sharded stacks)
    ge = _wsplit(p["w_gate"], spec.num_experts, -3)
    g = ge if ge.size > 1 else _wsplit(p["w_gate"], spec.d_ff_expert)
    w = _share(w, 1, ge)
    xc = x2.to(COMPUTE_DTYPE)[None]                          # (1, T, d)
    gate = torch.matmul(xc, p["w_gate"].to(COMPUTE_DTYPE))   # (E, T, f)
    up = torch.matmul(xc, p["w_up"].to(COMPUTE_DTYPE))
    h = _act(cfg, gate) * up
    out_e = torch.matmul(h, p["w_down"].to(COMPUTE_DTYPE))   # (E, T, d)
    y = torch.einsum("etd,te->td", out_e.float(), w)
    if g.size > 1:
        y = _reduce(y, g)
    return y.reshape(b, t, d).to(x.dtype)


def moe_apply(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
              impl: str = "dense") -> torch.Tensor:
    """``impl``: "dense" (``moe_dense``); "routed" (``moe_ep.moe_routed``,
    inference: each token through its top-k experts alone, every assignment
    kept); or the expert-parallel step at an EP axis of width 1
    (``moe_ep.moe_ep_a2a``: routed tokens sorted by expert through grouped
    products, under a capacity bound), its all-to-all payload in bf16
    ("ep_a2a") or in int8 with fp32 row scales ("ep_a2a_q8")."""
    if impl not in MOE_IMPLS:
        raise ValueError(f"moe impl {impl!r} not in {MOE_IMPLS}")
    if impl == "dense":
        return moe_dense(cfg, p, x)
    from . import moe_ep
    if impl == "routed":
        return moe_ep.moe_routed(cfg, p, x)
    return moe_ep.moe_ep_a2a(
        cfg, p, x, a2a_dtype="int8" if impl == "ep_a2a_q8" else "bfloat16")


# --------------------------------------------------------------------------
# Mamba-2 (SSD) block
# --------------------------------------------------------------------------

def mamba_prefill_impl(p: dict, x: torch.Tensor) -> str:
    """The path of a Mamba-2 mixer's prefill on input ``x`` with weights
    ``p``: ``ops.mamba_prefill_impl``, told whether a tensor-parallel or
    sequence split is published."""
    split = shard_ctx.tp() is not None or shard_ctx.seq_group() is not None
    return ops.mamba_prefill_impl(x, *p.values(), split=split)


def mamba_block(cfg: ArchConfig, p: dict, x: torch.Tensor, *, mode: str,
                cache: dict | None = None) -> tuple[torch.Tensor, dict]:
    """One Mamba-2 mixer.  cache = {"h": (B,nh,hd,n), "conv": (B,cw-1,C)}.
    With ``ssm.conv_bias`` the conv adds ``p["conv_b"]`` (C,); the gated
    RMSNorm takes ``ssm.norm_eps``.

    mode="decode" (T == 1) steps the recurrence from ``cache`` and writes the
    new state into it in place (the engine owns the cache; the JAX engine
    rebuilds it functionally instead); other modes run the chunked scan from
    a zero state and return the state they end in.  Where
    ``mamba_prefill_impl`` says "kernels" (a CUDA input, no gradient, no
    split), everything between the two projections runs in
    ``ops.mamba_prefill``'s CUDA passes; the eager code below is the plain
    version.

    Under tensor parallelism: ``w_in``'s column shard gathered whole (its
    columns cut through the z/x/B/C/dt segments), the depthwise conv on the
    rank's channels (a channel needs only its own weight and context) and
    its output gathered, the scan on the rank's heads of ``h``, the gated
    RMSNorm's sum of squares all-reduced, ``w_out``'s rows and an
    all-reduce, each over the group of its spec's axes.  Leaves that
    ``sanitize`` left whole compute whole.

    Under a sequence split (prefill and training; ``sharding.ctx.
    seq_group``) each rank scans its own rows: the conv takes the earlier
    ranks' last rows as its context, the scan runs from a zero state, and
    the ranks' final states and total decays, all-gathered, fold into the
    state entering each rank, whose contribution is added to its output
    (``_ssd_seq_split``).  The prompt's cache holds the whole sequence's
    state and conv context on every rank."""
    spec = cfg.ssm
    b, t, d = x.shape
    di, n, nh = spec.d_inner(d), spec.d_state, spec.n_heads(d)
    tp = shard_ctx.tp()
    seq = shard_ctx.seq_group() if mode != "decode" else None
    xc = x.to(COMPUTE_DTYPE)
    zxbcdt = xc @ p["w_in"].to(COMPUTE_DTYPE)
    if mode != "decode" and mamba_prefill_impl(p, x) == "kernels":
        y, h_new, new_conv = ops.mamba_prefill(
            zxbcdt, p, hd=spec.head_dim, n=n, chunk=spec.chunk,
            eps=spec.norm_eps,
            conv_state=None if cache is None else cache["conv"],
            h0=None if cache is None else cache["h"])
        out = _row_split_out(y, p["w_out"], di)
        return out.to(x.dtype), {"h": h_new, "conv": new_conv}
    if tp is not None:
        (zxbcdt,) = _cols_to([zxbcdt], [_wsplit(p["w_in"],
                                                2 * di + 2 * n + nh)],
                             NO_SPLIT)
    z, xs, B, C, dt = torch.split(zxbcdt, [di, di, n, n, nh], -1)
    conv_in = torch.cat([xs, B, C], -1)
    conv_state = None if cache is None else cache["conv"]
    # the conv context split by channels, the state h by heads, as the
    # cache specs put them (the weights of those dims split alike)
    conv_g = NO_SPLIT if tp is None else tp.conv
    heads_g = NO_SPLIT if tp is None else tp.ssm_heads
    conv_in = _share(conv_in, -1, conv_g)
    if seq is not None:
        conv_state, last = _seq_conv_context(conv_in, p["conv"].shape[0],
                                             seq, conv_state)
    bias = None
    if spec.conv_bias:
        if tp is not None:
            raise NotImplementedError("a conv bias under tensor parallelism")
        bias = p["conv_b"].to(COMPUTE_DTYPE)
    conv_out, new_conv = ref.causal_conv(conv_in,
                                         p["conv"].to(COMPUTE_DTYPE),
                                         conv_state, bias)
    if seq is not None:
        new_conv = last
    (conv_out,) = _cols_to([conv_out], [conv_g], NO_SPLIT)
    xs, B, C = torch.split(conv_out, [di, n, n], -1)
    xh = xs.reshape(b, t, nh, spec.head_dim)
    xh, dt, z = _share(xh, 2, heads_g), _share(dt, -1, heads_g), \
        _share(z, -1, heads_g)
    dt = F.softplus(dt.float() + p["dt_bias"].float())      # (B,T,nh)
    A = -torch.exp(p["A_log"].float())
    D = p["D"].float()
    if mode == "decode":
        if cache is None:
            raise ValueError("decode mode needs the SSM cache")
        y = ops.ssd_decode_step_(cache["h"], xh[:, 0], dt[:, 0], A,
                                 B[:, 0], C[:, 0], D)[:, None]  # (B,1,nh,hd)
        cache["conv"].copy_(new_conv)
        new_cache = cache
    else:
        h0 = None if cache is None else cache["h"]
        if seq is None:
            y, h_new = ops.ssd(xh, dt, A, B, C, D, chunk=spec.chunk, h0=h0)
        else:
            y, h_new = _ssd_seq_split(xh, dt, A, B, C, D, spec.chunk, h0,
                                      seq)
        new_cache = {"h": h_new, "conv": new_conv}
    y = y.reshape(b, t, -1)
    g = y * F.silu(z.float()).to(y.dtype)
    if tp is None:
        y, src = rmsnorm(g, p["norm"], spec.norm_eps), NO_SPLIT
    else:
        y, src = _gated_norm_tp(g, p["norm"], di, heads_g, spec.norm_eps)
    out = _row_split_out(y.to(COMPUTE_DTYPE), p["w_out"], di, src)
    return out.to(x.dtype), new_cache


def _seq_conv_context(conv_in: torch.Tensor, cw: int, group,
                      conv_state: torch.Tensor | None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Under a sequence split: (the conv context entering this rank's rows,
    the context after the last rank's), (B, cw-1, C) each.  The ranks' last
    min(T, cw-1) rows of ``conv_in`` are all-gathered (differentiably); the
    context is the last cw-1 rows of ``conv_state`` (zeros without one)
    followed by the earlier ranks' rows."""
    b, t, c = conv_in.shape
    r, _ = shard_ctx.seq_rank_size()
    k = min(t, cw - 1)
    tails = comm.all_gather_autograd(conv_in[:, t - k:][None], 0, group)
    start = (conv_in.new_zeros((b, cw - 1, c)) if conv_state is None
             else conv_state.to(conv_in.dtype))
    # slices of one tensor that holds every rank's rows, so that each rank's
    # graph reaches the gather (its backward, a collective, runs on every
    # rank alike, rank 0's included)
    rows = torch.cat([start, *tails.unbind(0)], 1)     # (B, cw-1 + R·k, C)
    return rows[:, r * k:r * k + cw - 1], rows[:, -(cw - 1):]


def _ssd_seq_split(x, dt, A, B, C, D, chunk: int, h0, group
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan over this rank's rows of a sequence split over
    ``group``: ``ops.ssd`` from a zero state gives the rank's output and
    final state h_r; h_r and the rows' total decay exp(A·Σdt) are
    all-gathered (B·nh·(hd·n+1) values a rank; the gather's gradient a
    reduce-scatter); the state entering rank r is the fold of ranks < r
    (from ``h0``, or zeros); its contribution C_t · exp(A·cumsum(dt)_t) ·
    h_in is added to the output in one einsum.  Returns (y, the state after
    the last rank, the same on every rank)."""
    r, n_ranks = shard_ctx.seq_rank_size()
    y, h_r = ops.ssd(x, dt, A, B, C, D, chunk=chunk)
    cum = torch.cumsum(dt * A, 1)                         # (B, T, nh)
    bsz, nhl, hd, n = h_r.shape
    packed = torch.cat([h_r.float().reshape(bsz, nhl, hd * n),
                        torch.exp(cum[:, -1])[..., None]], -1)
    every = comm.all_gather_autograd(packed[None], 0, group)
    states = every[..., :-1].reshape(n_ranks, bsz, nhl, hd, n)
    decays = every[..., -1]                               # (R, B, nh)
    h = (torch.zeros_like(h_r, dtype=torch.float32) if h0 is None
         else h0.float())
    h_in = torch.zeros_like(h)
    for j in range(n_ranks):
        # picked by a mask, not a branch: every rank's graph then reaches
        # every rank's state, and the gather's backward (a collective) runs
        # on all of them alike
        h_in = h_in + float(j == r) * h
        h = h * decays[j][..., None, None] + states[j]
    corr = torch.einsum("btn,bth,bhpn->bthp", C.float(), torch.exp(cum),
                        h_in)
    return (y.float() + corr).to(y.dtype), h


def _gated_norm_tp(g: torch.Tensor, w: torch.Tensor, di: int,
                   src: shard_ctx.Group, eps: float
                   ) -> tuple[torch.Tensor, shard_ctx.Group]:
    """``rmsnorm`` over the d_inner channels of ``g`` under tensor
    parallelism: ``g`` whole, or the rank's head channels over ``src``,
    whose sum of squares is all-reduced; ``w`` whole or its spec's channel
    block.  Returns the channels ``w`` covers (``layers.rmsnorm``'s
    arithmetic) and their group."""
    gf = g.float()
    ss = (gf * gf).sum(-1, keepdim=True)
    if src.size > 1:
        ss = _reduce(ss, src)
    scale = torch.rsqrt(ss / di + eps)
    dst = _wsplit(w, di)
    (g,) = _cols_to([g], [src], dst)
    return ((g.float() * scale) * (1.0 + w)).to(g.dtype), dst


def seq_tail(x: torch.Tensor, n: int) -> torch.Tensor:
    """The last ``n`` positions of (B, T, d) hidden states; under a
    sequence split they are the last rank's, all-gathered from it."""
    x = x[:, -n:]
    group = shard_ctx.seq_group()
    if group is not None:
        x = comm.all_gather_autograd(x, 0, group)[-x.shape[0]:]
    return x


# --------------------------------------------------------------------------
# Embedding / head
# --------------------------------------------------------------------------

def embed(p: dict, tokens: torch.Tensor, vocab: int | None = None
          ) -> torch.Tensor:
    """The tokens' rows of the embedding.  Under tensor parallelism with
    the vocab split (the rank's ``vocab``/n rows), a lookup masked to the
    rank's rows, all-reduced."""
    e = p["embedding"]
    g = NO_SPLIT if vocab is None else _wsplit(e, vocab, 0)
    if g.size == 1:
        return e[tokens]
    local = tokens.long() - g.rank * e.shape[0]
    mine = (local >= 0) & (local < e.shape[0])
    rows = e[local.clamp(0, e.shape[0] - 1)]
    return _reduce(torch.where(mine[..., None], rows, torch.zeros_like(rows)),
                   g)


def unembed(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, T, d) → (B, T, V) fp32 logits, divided by ``cfg.logits_scaling``
    where it is not 1; under tensor parallelism with the vocab split, the
    rank's vocab slice of them (``specs.logits_pspec``)."""
    w = p["embedding"].T if cfg.tie_embeddings else p["head"]
    logits = (x.to(COMPUTE_DTYPE) @ w.to(COMPUTE_DTYPE)).float()
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits
