"""Whisper-family encoder-decoder backbone, ported from
``repro.models.encdec``.

The conv frontend is a stub, as in the JAX package: callers provide
precomputed frame embeddings (B, T_enc, d_model), the shape the stride-2
conv stem would emit (T_enc = audio seq // 2).  RoPE stands in for the
positional embeddings; LayerNorm and GeLU as in the Whisper family.

Decode cache: self-attention ``k``/``v`` (L, B, S, Hkv, hd) and the static
cross K/V ``xk``/``xv`` (L, B, T_enc, Hkv, hd) computed once at prefill,
both stacked over the decoder layers.  A Python loop over layers takes the
place of ``lax.scan``; training remats each decoder layer, as the reference
does, with ``torch.utils.checkpoint`` (``transformer.run_remat``).
"""

from __future__ import annotations

import torch

from . import layers as L
from .config import ArchConfig
from .transformer import (CACHE_DTYPE, attn_params, embed_params,
                          mlp_params, norm_params, remat_groups, run_remat,
                          unstack)


# --------------------------------------------------------------------------
# Params
# --------------------------------------------------------------------------

def init_params(cfg: ArchConfig, gen: torch.Generator, device,
                dtype=torch.float32) -> dict:
    """The JAX tree (``encoder``: ln1, attn, ln2, mlp; ``decoder``: ln1,
    attn, lnx, xattn, ln2, mlp; each stacked along its layers) with the JAX
    init's distributions; norms fp32 at 1/0."""
    d, ne, nd = cfg.d_model, cfg.encoder_layers, cfg.n_layers

    def norm(n):
        return norm_params(cfg, (n, d), device)

    embed = embed_params(cfg, gen, device, dtype)
    encoder = {"ln1": norm(ne),
               "attn": attn_params(cfg, (ne,), gen, device, dtype),
               "ln2": norm(ne),
               "mlp": mlp_params(cfg, (ne,), gen, device, dtype)}
    decoder = {"ln1": norm(nd),
               "attn": attn_params(cfg, (nd,), gen, device, dtype),
               "lnx": norm(nd),
               "xattn": attn_params(cfg, (nd,), gen, device, dtype),
               "ln2": norm(nd),
               "mlp": mlp_params(cfg, (nd,), gen, device, dtype)}
    return {"embed": embed, "encoder": encoder, "decoder": decoder,
            "enc_norm": norm_params(cfg, (d,), device),
            "final_norm": norm_params(cfg, (d,), device)}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, enc_len: int,
               device) -> dict:
    nl, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd

    def mk(n):
        return torch.zeros((nl, batch, n, hkv, hd), dtype=CACHE_DTYPE,
                           device=device)
    return {"k": mk(max_len), "v": mk(max_len), "xk": mk(enc_len),
            "xv": mk(enc_len)}


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def encode(cfg: ArchConfig, params: dict, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames: (B, T_enc, d_model) stub embeddings → encoder states, through
    non-causal self-attention (roped q and k)."""
    b, t, _ = frames.shape
    positions = torch.arange(t, device=frames.device)[None].expand(b, t)
    x = frames.to(torch.bfloat16)
    for p in unstack(params["encoder"]):
        h = L.apply_norm(cfg, p["ln1"], x)
        a, _ = L.attention(cfg, p["attn"], h, positions=positions,
                           mode="full", causal=False)
        x = x + a
        x = x + L.mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x))
    return L.apply_norm(cfg, params["enc_norm"], x)


def _cross_kv(cfg: ArchConfig, p: dict, enc: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    b, te, _ = enc.shape
    hkv, hd = cfg.n_kv_heads, cfg.hd
    ec = enc.to(torch.bfloat16)
    k = (ec @ p["wk"].to(torch.bfloat16)).reshape(b, te, hkv, hd)
    v = (ec @ p["wv"].to(torch.bfloat16)).reshape(b, te, hkv, hd)
    return k, v


def decode(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
           enc: torch.Tensor | None = None, mode: str = "train",
           cache: dict | None = None, lengths: torch.Tensor | None = None,
           logits_tail: int | None = None, remat: bool = False,
           return_hidden: bool = False
           ) -> tuple[torch.Tensor, dict | None]:
    """Decoder pass.  mode="train"/"prefill" needs ``enc`` (encoder states)
    and prefill returns the cache it built; mode="decode" reads the cached
    cross K/V, writes the new token's k/v into ``cache`` in place and
    returns it.  ``remat`` (train mode under autograd): checkpoint every
    decoder layer.  ``return_hidden``: the final-normed hidden states in
    place of the logits."""
    b, t = tokens.shape
    x = L.embed(params["embed"], tokens).to(torch.bfloat16)
    if mode == "decode":
        if cache is None or lengths is None:
            raise ValueError("decode mode needs cache and lengths")
        positions = (lengths - 1)[:, None]
    else:
        if enc is None:
            raise ValueError(f"mode {mode!r} needs the encoder states")
        positions = torch.arange(t, device=tokens.device)[None].expand(b, t)
    layers = unstack(params["decoder"])

    def layer(i, x, lc=None):
        p = layers[i]
        h = L.apply_norm(cfg, p["ln1"], x)
        a, kv = L.attention(cfg, p["attn"], h, positions=positions,
                            mode=mode, causal=True,
                            cache=None if lc is None
                            else {"k": lc["k"], "v": lc["v"]},
                            lengths=lengths)
        x = x + a
        hx = L.apply_norm(cfg, p["lnx"], x)
        if mode == "decode":
            xk, xv = lc["xk"], lc["xv"]
        else:
            xk, xv = _cross_kv(cfg, p["xattn"], enc)
        c, _ = L.attention(cfg, p["xattn"], hx, positions=positions,
                           mode=mode, causal=False, kv_override=(xk, xv))
        x = x + c
        x = x + L.mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x))
        return x, (("k", kv["k"]), ("v", kv["v"]), ("xk", xk), ("xv", xv))

    built: dict[str, list] = {"k": [], "v": [], "xk": [], "xv": []}
    groups = remat_groups(cfg.n_layers, remat and mode == "train", 1)
    if groups is not None:
        x = run_remat(groups, lambda i, x: layer(i, x)[0], x)
    else:
        for i in range(cfg.n_layers):
            lc = (None if cache is None
                  else {k: v[i] for k, v in cache.items()})
            x, entries = layer(i, x, lc)
            if mode == "prefill":
                for k, val in entries:
                    built[k].append(val)
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


def forward(cfg: ArchConfig, params: dict, frames: torch.Tensor,
            tokens: torch.Tensor, *, mode: str = "train",
            cache: dict | None = None, lengths: torch.Tensor | None = None,
            logits_tail: int | None = None, remat: bool = False,
            return_hidden: bool = False
            ) -> tuple[torch.Tensor, dict | None]:
    """Full enc-dec pass (train / prefill).  Decode uses ``decode``
    directly.  ``remat`` checkpoints the decoder layers (the encoder is not
    rematted, as in the reference)."""
    enc = encode(cfg, params, frames)
    return decode(cfg, params, tokens, enc=enc, mode=mode, cache=cache,
                  lengths=lengths, logits_tail=logits_tail, remat=remat,
                  return_hidden=return_hidden)
