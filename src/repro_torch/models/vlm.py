"""Llama-3.2-Vision-class VLM backbone, ported from ``repro.models.vlm``:
groups of self-attention layers with one image cross-attention layer per
group (``cross_attn_every``).

The vision tower is a stub, as in the JAX package: callers provide
(B, n_vision_tokens, d_model) precomputed patch embeddings.  The cross K/V
over the image is computed once at prefill and is static during decode.

Parameter layout: a two-level stack, groups (n_layers // cross_attn_every)
outside and self layers per group (cross_attn_every − 1) inside, plus one
cross layer per group with its tanh gates, which start closed (0).  Python
loops over both levels take the place of the nested ``lax.scan``; training
remats each group with ``torch.utils.checkpoint``.
"""

from __future__ import annotations

import torch

from . import layers as L
from .config import ArchConfig
from .transformer import (CACHE_DTYPE, attn_params, embed_params,
                          mlp_params, norm_params, remat_groups, run_remat,
                          unstack)


def n_groups(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.cross_attn_every


def self_per_group(cfg: ArchConfig) -> int:
    return cfg.cross_attn_every - 1


def init_params(cfg: ArchConfig, gen: torch.Generator, device,
                dtype=torch.float32) -> dict:
    """The JAX tree (``self`` stacked (groups, self per group); ``cross``
    stacked over groups) with the JAX init's distributions, drawn layer by
    layer (one (8, 4, 4096, 14336) MLP stack of llama-3.2-vision-11b in
    fp32 would be 7.5 GB); the gates 0 in ``dtype``, norms fp32."""
    g, spg, d = n_groups(cfg), self_per_group(cfg), cfg.d_model
    embed = embed_params(cfg, gen, device, dtype)
    self_ = {"ln1": norm_params(cfg, (g, spg, d), device),
             "attn": attn_params(cfg, (g, spg), gen, device, dtype),
             "ln2": norm_params(cfg, (g, spg, d), device),
             "mlp": mlp_params(cfg, (g, spg), gen, device, dtype)}
    cross = {"ln1": norm_params(cfg, (g, d), device),
             "xattn": attn_params(cfg, (g,), gen, device, dtype),
             "ln2": norm_params(cfg, (g, d), device),
             "mlp": mlp_params(cfg, (g,), gen, device, dtype),
             "gate_attn": torch.zeros((g,), device=device, dtype=dtype),
             "gate_mlp": torch.zeros((g,), device=device, dtype=dtype)}
    return {"embed": embed, "self": self_, "cross": cross,
            "final_norm": norm_params(cfg, (d,), device)}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> dict:
    """Self k/v (g, spg, B, S, Hkv, hd); cross xk/xv (g, B, Nv, Hkv, hd)."""
    g, spg = n_groups(cfg), self_per_group(cfg)
    hkv, hd, nv = cfg.n_kv_heads, cfg.hd, cfg.n_vision_tokens

    def mk(*shape):
        return torch.zeros(shape, dtype=CACHE_DTYPE, device=device)
    return {"k": mk(g, spg, batch, max_len, hkv, hd),
            "v": mk(g, spg, batch, max_len, hkv, hd),
            "xk": mk(g, batch, nv, hkv, hd),
            "xv": mk(g, batch, nv, hkv, hd)}


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            vision: torch.Tensor | None = None, mode: str = "train",
            cache: dict | None = None, lengths: torch.Tensor | None = None,
            logits_tail: int | None = None, remat: bool = False,
            return_hidden: bool = False
            ) -> tuple[torch.Tensor, dict | None]:
    """tokens: (B, T); vision: (B, Nv, d_model) stub patch embeddings,
    required for train/prefill (decode reads the cached cross K/V).  Prefill
    returns the cache it built; decode updates ``cache`` in place and
    returns it.  ``remat`` (train mode under autograd): checkpoint every
    group (its self layers and its cross layer), as the reference does.
    ``return_hidden``: the final-normed hidden states in place of the
    logits."""
    b, t = tokens.shape
    hkv, hd = cfg.n_kv_heads, cfg.hd
    x = L.embed(params["embed"], tokens).to(torch.bfloat16)
    if mode == "decode":
        if cache is None or lengths is None:
            raise ValueError("decode mode needs cache and lengths")
        positions = (lengths - 1)[:, None]
    else:
        if vision is None:
            raise ValueError(f"mode {mode!r} needs the vision embeddings")
        positions = torch.arange(t, device=tokens.device)[None].expand(b, t)
    vis = None if vision is None else vision.to(torch.bfloat16)
    selfs = [unstack(g) for g in unstack(params["self"])]
    crosses = unstack(params["cross"])

    def group(gi, x, gc=None):
        kvs = []
        for j, p in enumerate(selfs[gi]):
            h = L.apply_norm(cfg, p["ln1"], x)
            a, kv = L.attention(cfg, p["attn"], h, positions=positions,
                                mode=mode, causal=True,
                                cache=None if gc is None
                                else {"k": gc["k"][j], "v": gc["v"][j]},
                                lengths=lengths)
            x = x + a
            x = x + L.mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x))
            kvs.append(kv)
        # the group's cross-attention layer
        pc = crosses[gi]
        h = L.apply_norm(cfg, pc["ln1"], x)
        if mode == "decode":
            xk, xv = gc["xk"], gc["xv"]
        else:
            xk = (vis @ pc["xattn"]["wk"].to(torch.bfloat16)
                  ).reshape(b, -1, hkv, hd)
            xv = (vis @ pc["xattn"]["wv"].to(torch.bfloat16)
                  ).reshape(b, -1, hkv, hd)
        c, _ = L.attention(cfg, pc["xattn"], h, positions=positions,
                           mode=mode, causal=False, kv_override=(xk, xv))
        x = x + torch.tanh(pc["gate_attn"]).to(x.dtype) * c
        m = L.mlp(cfg, pc["mlp"], L.apply_norm(cfg, pc["ln2"], x))
        x = x + torch.tanh(pc["gate_mlp"]).to(x.dtype) * m
        return x, kvs, xk, xv

    built: dict[str, list] = {"k": [], "v": [], "xk": [], "xv": []}
    groups = remat_groups(n_groups(cfg), remat and mode == "train", 1)
    if groups is not None:
        x = run_remat(groups, lambda gi, x: group(gi, x)[0], x)
    else:
        for gi in range(n_groups(cfg)):
            gc = (None if cache is None
                  else {k: v[gi] for k, v in cache.items()})
            x, kvs, xk, xv = group(gi, x, gc)
            if mode == "prefill":
                built["k"].append(torch.stack([kv["k"] for kv in kvs]))
                built["v"].append(torch.stack([kv["v"] for kv in kvs]))
                built["xk"].append(xk)
                built["xv"].append(xv)
    new_cache = None
    if mode == "prefill":
        new_cache = {k: torch.stack(v) for k, v in built.items()}
    elif mode == "decode":
        new_cache = cache
    x = L.apply_norm(cfg, params["final_norm"], x)
    if logits_tail is not None:
        x = x[:, -logits_tail:]
    if return_hidden:
        return x, new_cache
    return L.unembed(cfg, params["embed"], x), new_cache
