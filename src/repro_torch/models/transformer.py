"""The dense decoder-only LM, ported from the dense path of
``repro.models.transformer``.

Parameters are stacked along a leading L axis as in the JAX package (so
``convert.from_jax`` maps them one to one); a Python loop over layers takes
the place of ``lax.scan``.  Non-uniform attention (gemma3's local:global)
rides a per-layer window list: global layers get ``kv_len``.  Remat and the
bf16 carry barrier are training concerns and come with the training slice.
"""

from __future__ import annotations

import math

import torch

from . import layers as L
from .config import ArchConfig

CACHE_DTYPE = torch.bfloat16
NO_WINDOW = 2 ** 30


# --------------------------------------------------------------------------
# Parameter construction
# --------------------------------------------------------------------------

def _normal(shape, scale: float, gen: torch.Generator, device, dtype
            ) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * scale).to(dtype)


def _norm_params(cfg: ArchConfig, shape, device) -> dict:
    """Norm weights stay fp32 whatever the parameter dtype, as in the JAX
    package."""
    if cfg.norm == "layernorm":
        return {"w": torch.ones(shape, device=device),
                "b": torch.zeros(shape, device=device)}
    return {"w": torch.zeros(shape, device=device)}


def init_params(cfg: ArchConfig, gen: torch.Generator, device,
                dtype=torch.float32) -> dict:
    """Full parameter tree with the JAX init's distributions: projections
    N(0, 1/fan_in), embedding and head N(0, 0.02²), norms 0 (rmsnorm scales
    by 1 + w) or 1/0 (layernorm)."""
    d, nl = cfg.d_model, cfg.n_layers
    hq, hkv, hd, ff = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff

    def proj(*shape):
        return _normal((nl, *shape), 1.0 / math.sqrt(shape[0]), gen, device,
                       dtype)

    emb = {"embedding": _normal((cfg.vocab, d), 0.02, gen, device, dtype)}
    if not cfg.tie_embeddings:
        emb["head"] = _normal((d, cfg.vocab), 0.02, gen, device, dtype)
    if cfg.act in ("swiglu", "geglu"):
        mlp = {"w_gate": proj(d, ff), "w_up": proj(d, ff),
               "w_down": proj(ff, d)}
    else:
        mlp = {"w_up": proj(d, ff), "w_down": proj(ff, d)}
    layers = {
        "ln1": _norm_params(cfg, (nl, d), device),
        "attn": {"wq": proj(d, hq * hd), "wk": proj(d, hkv * hd),
                 "wv": proj(d, hkv * hd), "wo": proj(hq * hd, d)},
        "ln2": _norm_params(cfg, (nl, d), device),
        "mlp": mlp,
    }
    return {"embed": emb, "layers": layers,
            "final_norm": _norm_params(cfg, (d,), device)}


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# --------------------------------------------------------------------------
# Per-layer window schedule (the 5:1 local:global pattern etc.)
# --------------------------------------------------------------------------

def window_schedule(cfg: ArchConfig, kv_len: int) -> list[int] | None:
    """Per-layer window sizes, or None if no layer is windowed.  Global
    layers get kv_len (mask no-op)."""
    if cfg.sliding_window is None:
        return None
    out = []
    for i in range(cfg.n_layers):
        is_global = (cfg.local_global is not None
                     and i % (cfg.local_global + 1) == cfg.local_global)
        out.append(kv_len if is_global else cfg.sliding_window)
    return out


# --------------------------------------------------------------------------
# KV cache
# --------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> dict:
    """Stacked (leading L) decode cache."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=CACHE_DTYPE, device=device)}


# --------------------------------------------------------------------------
# Layer application
# --------------------------------------------------------------------------

def apply_layer(cfg: ArchConfig, p: dict, x: torch.Tensor, *, mode: str,
                positions: torch.Tensor, window: int | None,
                layer_cache: dict | None, lengths: torch.Tensor | None
                ) -> tuple[torch.Tensor, dict]:
    h = L.apply_norm(cfg, p["ln1"], x)
    a, kv = L.attention(cfg, p["attn"], h, positions=positions, mode=mode,
                        causal=True, window=window, cache=layer_cache,
                        lengths=lengths)
    x = x + a
    h2 = L.apply_norm(cfg, p["ln2"], x)
    return x + L.mlp(cfg, p["mlp"], h2), kv


# --------------------------------------------------------------------------
# Full forward pass
# --------------------------------------------------------------------------

def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            mode: str = "train", cache: dict | None = None,
            lengths: torch.Tensor | None = None,
            logits_tail: int | None = None
            ) -> tuple[torch.Tensor, dict | None]:
    """tokens: (B, T) integer.

    mode="train"/"prefill": full sequence; prefill returns the built cache
    (L, B, T, Hkv, hd).  mode="decode": T == 1, needs ``cache`` + ``lengths``
    (new token position = lengths-1); the cache is updated in place and
    returned.  ``logits_tail``: only unembed the last N positions.
    """
    b, t = tokens.shape
    x = L.embed(params["embed"], tokens).to(torch.bfloat16)
    if mode == "decode":
        if cache is None or lengths is None:
            raise ValueError("decode mode needs cache and lengths")
        positions = (lengths - 1)[:, None]
        kv_len = cache["k"].shape[2]
    else:
        positions = torch.arange(t, device=tokens.device)[None].expand(b, t)
        kv_len = t
    wsched = window_schedule(cfg, kv_len)
    built: dict[str, list] = {"k": [], "v": []}
    for i in range(cfg.n_layers):
        # a window of -1 means "no window"
        w = None if wsched is None else (NO_WINDOW if wsched[i] < 0
                                         else wsched[i])
        lc = (None if cache is None else
              {"k": cache["k"][i], "v": cache["v"][i]})
        x, kv = apply_layer(cfg, layer_params(params["layers"], i), x,
                            mode=mode, positions=positions, window=w,
                            layer_cache=lc, lengths=lengths)
        if mode == "prefill":
            built["k"].append(kv["k"])
            built["v"].append(kv["v"])
    new_cache = None
    if mode == "prefill":
        new_cache = {k: torch.stack(v) for k, v in built.items()}
    elif mode == "decode":
        new_cache = cache
    x = L.apply_norm(cfg, params["final_norm"], x)
    if logits_tail is not None:
        x = x[:, -logits_tail:]
    return L.unembed(cfg, params["embed"], x), new_cache
