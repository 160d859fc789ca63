"""The decoder-only LM of the dense, SSM, hybrid and MoE families, ported
from ``repro.models.transformer``, and the port's own ``hybrid_moe`` family
(granite-4.0-h-small), which the JAX package does not have.

Parameters are stacked along a leading L axis as in the JAX package (so
``convert.from_jax`` maps them one to one); a Python loop over layers takes
the place of ``lax.scan``.  An ``ssm`` layer is a Mamba-2 mixer alone; a
``hybrid`` layer runs attention and the mixer in parallel on the same input
and averages them; a ``moe`` layer has a routed expert FFN in place of the
MLP, lowered as ``moe_impl`` says.  Non-uniform attention (gemma3's
local:global) rides a per-layer window list: global layers get ``kv_len``.

A ``hybrid_moe`` layer is a Mamba-2 mixer or attention, as ``cfg.mixers``
says, then a routed MoE with a shared expert, each branch scaled by
``cfg.residual_multiplier`` (μP)::

    h = x + r · mixer(norm(x));   y = h + r · (moe(norm(h)) + shared(norm(h)))

Its parameters are stacked per kind: ``ln1``, ``ln2``, ``moe`` and
``shared_mlp`` over all L layers, ``attn`` over the attention layers and
``ssm`` over the Mamba layers, in layer order; its cache likewise holds
``k``/``v`` for the attention layers alone and ``h``/``conv`` for the Mamba
layers alone (``mixer_slots`` maps a layer to its slot in its kind's
stacks).

Training remats groups of layers (``remat``, ``remat_group``) with
``torch.utils.checkpoint`` where the reference uses ``jax.checkpoint``.  The
reference also pins the checkpointed carry with ``_pinned``, an XLA
scheduling barrier that keeps XLA from hoisting an fp32 copy of the residual
stack out of its scan; eager PyTorch schedules nothing, so it has no
counterpart here: the carry between groups is simply the bf16 ``x``.

Given a telemetry recorder (the serving engine passes its own), ``forward``
spans its parts on it, each wall-clocked on the host: ``model.embed``, then
per layer ``layer.norm`` (ln1, and ln2 where the layer has one),
``layer.attention``, ``layer.ssm``, ``layer.moe`` and ``layer.shared_mlp``
(hybrid_moe) or ``layer.mlp`` with the attr ``layer`` (the layer's index;
``layer.moe`` also ``impl``, its lowering, and ``layer.ssm`` its path:
``ops.ssd_decode_impl`` in decode, ``layers.mamba_prefill_impl`` otherwise),
then ``model.head``.  They time the host's enqueue; the device's time under
each is the profiler's, joined by launch time.
Training and the sharded steps pass none.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.telemetry import wall_span as _span
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


def norm_params(cfg: ArchConfig, shape, device) -> dict:
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
    by 1 + w) or 1/0 (layernorm).  The layers hold what the family needs:
    ``ln1`` always, then ``ssm`` alone (ssm) or ``attn``, ``ssm`` (hybrid),
    ``ln2`` and ``mlp`` (``moe`` for the MoE family)."""
    d, nl = cfg.d_model, cfg.n_layers
    hq, hkv, hd, ff = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff

    def proj(*shape):
        return _normal((nl, *shape), 1.0 / math.sqrt(shape[0]), gen, device,
                       dtype)

    emb = embed_params(cfg, gen, device, dtype)
    layers = {"ln1": norm_params(cfg, (nl, d), device)}
    if cfg.family == "hybrid_moe":
        return {"embed": emb,
                "layers": _hybrid_moe_params(cfg, layers, gen, device, dtype),
                "final_norm": norm_params(cfg, (d,), device)}
    if cfg.family == "ssm":
        layers["ssm"] = _ssm_params(cfg, proj, device, dtype)
    else:
        layers["attn"] = {"wq": proj(d, hq * hd), "wk": proj(d, hkv * hd),
                          "wv": proj(d, hkv * hd), "wo": proj(hq * hd, d)}
        if cfg.family == "hybrid":
            layers["ssm"] = _ssm_params(cfg, proj, device, dtype)
        layers["ln2"] = norm_params(cfg, (nl, d), device)
        if cfg.family == "moe":
            layers["moe"] = _moe_params(cfg, gen, device, dtype)
        elif cfg.act in ("swiglu", "geglu"):
            layers["mlp"] = {"w_gate": proj(d, ff), "w_up": proj(d, ff),
                             "w_down": proj(ff, d)}
        else:
            layers["mlp"] = {"w_up": proj(d, ff), "w_down": proj(ff, d)}
    return {"embed": emb, "layers": layers,
            "final_norm": norm_params(cfg, (d,), device)}


def _ssm_params(cfg: ArchConfig, proj, device, dtype,
                nl: int | None = None) -> dict:
    """One Mamba-2 mixer per layer (``nl`` of them, every layer's by
    default), as ``repro.models.layers.ssm_params``: A_log = log(linspace(1,
    16, nh)), D = 1, dt_bias = norm = 0 (and the conv bias, where the
    configuration has one), all in the parameter dtype (they are not norm
    weights); the rest N(0, 1/fan_in) with the conv's fan_in its width."""
    s, d = cfg.ssm, cfg.d_model
    nl = cfg.n_layers if nl is None else nl
    di, n, nh = s.d_inner(d), s.d_state, s.n_heads(d)

    def const(values):
        return values.to(device=device, dtype=dtype).expand(nl, -1).clone()

    out = {"w_in": proj(d, 2 * di + 2 * n + nh),       # z, x, B, C, dt
           "conv": proj(s.conv_width, di + 2 * n),
           "A_log": const(torch.log(torch.linspace(1.0, 16.0, nh))),
           "D": const(torch.ones(nh)),
           "dt_bias": const(torch.zeros(nh)),
           "norm": const(torch.zeros(di)),
           "w_out": proj(di, d)}
    if s.conv_bias:
        out["conv_b"] = const(torch.zeros(di + 2 * n))
    return out


def _hybrid_moe_params(cfg: ArchConfig, layers: dict, gen, device, dtype
                       ) -> dict:
    """The ``hybrid_moe`` stacks: ``layers``' ``ln1``, then ``ln2``, the
    routed experts and the shared expert over all L layers, ``attn`` over
    the attention layers and ``ssm`` over the Mamba layers."""
    d, nl, fs = cfg.d_model, cfg.n_layers, cfg.moe.d_ff_shared
    n_attn, n_mamba = cfg.n_mixer_layers("A"), cfg.n_mixer_layers("M")

    def proj(*shape):
        return stacked_normal((n_mamba,), shape, gen, device, dtype)

    layers["ln2"] = norm_params(cfg, (nl, d), device)
    layers["moe"] = _moe_params(cfg, gen, device, dtype)
    layers["shared_mlp"] = {
        "w_gate": stacked_normal((nl,), (d, fs), gen, device, dtype),
        "w_up": stacked_normal((nl,), (d, fs), gen, device, dtype),
        "w_down": stacked_normal((nl,), (fs, d), gen, device, dtype)}
    layers["attn"] = attn_params(cfg, (n_attn,), gen, device, dtype)
    layers["ssm"] = _ssm_params(cfg, proj, device, dtype, n_mamba)
    return layers


@functools.cache
def mixer_slots(cfg: ArchConfig) -> tuple[tuple[str, int], ...]:
    """``hybrid_moe``: each layer's mixer ("M" or "A") and its index into
    that kind's stacks (the count of earlier layers of the same kind)."""
    seen = {m: 0 for m in cfg.mixers}
    out = []
    for m in cfg.mixers:
        out.append((m, seen[m]))
        seen[m] += 1
    return tuple(out)


def layer_params(cfg: ArchConfig, stacked: dict) -> list[dict]:
    """Every layer's parameters, views into the stacked tree (``unstack``);
    a ``hybrid_moe`` layer gets its own kind's mixer stack entry, ``attn``
    or ``ssm``, beside the leaves every layer has."""
    if cfg.mixers is None:
        return unstack(stacked)
    kinds = {"A": "attn", "M": "ssm"}
    per_kind = {m: unstack(stacked[kinds[m]]) for m in set(cfg.mixers)}
    common = unstack({k: v for k, v in stacked.items()
                      if k not in kinds.values()})
    return [{**common[i], kinds[m]: per_kind[m][j]}
            for i, (m, j) in enumerate(mixer_slots(cfg))]


def layer_cache(cfg: ArchConfig, cache: dict, i: int) -> dict:
    """Layer ``i``'s views of the stacked decode cache: every leaf's i-th
    entry, or for a ``hybrid_moe`` layer its kind's (``k``/``v`` or
    ``h``/``conv``) at its slot."""
    if cfg.mixers is None:
        return {k: v[i] for k, v in cache.items()}
    m, j = mixer_slots(cfg)[i]
    return {k: cache[k][j] for k in (("k", "v") if m == "A"
                                     else ("h", "conv"))}


def stacked_normal(lead: tuple, shape: tuple, gen: torch.Generator, device,
                   dtype) -> torch.Tensor:
    """A (*lead, *shape) stack of N(0, 1/fan_in) weights, the fan-in
    ``shape[-2]``, filled one layer at a time into a tensor of ``dtype`` so
    that the fp32 draw is one layer's (qwen3-moe-30b-a3b's whole
    (48, 128, 2048, 768) expert stack in fp32 would be 38.7 GB, twice over;
    llama-3.2-vision-11b's (8, 4, 4096, 14336) MLP stack 7.5 GB)."""
    out = torch.empty((*lead, *shape), device=device, dtype=dtype)
    flat = out.view(-1, *shape)
    for i in range(flat.shape[0]):
        flat[i] = _normal(shape, 1.0 / math.sqrt(shape[-2]), gen, device,
                          dtype)
    return out


def attn_params(cfg: ArchConfig, lead: tuple, gen: torch.Generator, device,
                dtype) -> dict:
    """A stack of ``repro.models.layers.attn_params``, drawn layer by
    layer."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    shapes = {"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
              "wo": (hq * hd, d)}
    return {k: stacked_normal(lead, s, gen, device, dtype)
            for k, s in shapes.items()}


def mlp_params(cfg: ArchConfig, lead: tuple, gen: torch.Generator, device,
               dtype) -> dict:
    """A stack of ``repro.models.layers.mlp_params``, drawn layer by
    layer."""
    d, ff = cfg.d_model, cfg.d_ff
    names = (("w_gate", "w_up") if cfg.act in ("swiglu", "geglu")
             else ("w_up",))
    out = {k: stacked_normal(lead, (d, ff), gen, device, dtype)
           for k in names}
    out["w_down"] = stacked_normal(lead, (ff, d), gen, device, dtype)
    return out


def embed_params(cfg: ArchConfig, gen: torch.Generator, device, dtype
                 ) -> dict:
    """Embedding and untied head, N(0, 0.02²)."""
    emb = {"embedding": _normal((cfg.vocab, cfg.d_model), 0.02, gen, device,
                                dtype)}
    if not cfg.tie_embeddings:
        emb["head"] = _normal((cfg.d_model, cfg.vocab), 0.02, gen, device,
                              dtype)
    return emb


def _moe_params(cfg: ArchConfig, gen: torch.Generator, device, dtype
                ) -> dict:
    """The routed experts of every layer, as ``repro.models.layers.
    moe_params``: each of router (d, E), w_gate and w_up (E, d, f) and
    w_down (E, f, d) N(0, 1/fan_in) with the fan-in its second-last axis,
    drawn layer by layer."""
    m, d, nl = cfg.moe, cfg.d_model, cfg.n_layers
    e, f = m.num_experts, m.d_ff_expert

    def stack(*shape):
        return stacked_normal((nl,), shape, gen, device, dtype)

    return {"router": stack(d, e), "w_gate": stack(e, d, f),
            "w_up": stack(e, d, f), "w_down": stack(e, f, d)}


def unstack(stacked: dict) -> list[dict]:
    """Every layer's parameters, views into the stacked tree, by one
    ``unbind`` per leaf.  Under autograd the layers' gradients of a leaf are
    then gathered by one stack, where a view per layer (``leaf[i]``) would
    add a zero-filled gradient of the whole stack per layer."""
    leaves = {k: unstack(v) if isinstance(v, dict) else torch.unbind(v)
              for k, v in stacked.items()}
    n = len(next(iter(leaves.values())))
    return [{k: v[i] for k, v in leaves.items()} for i in range(n)]


def remat_groups(n_layers: int, remat: bool, remat_group: int
                 ) -> list[range] | None:
    """The layer groups each checkpointed as a whole (the reference's rule:
    ``remat_group`` applies only when it divides ``n_layers``, else every
    layer is its own group), or None without remat or outside autograd."""
    if not remat or not torch.is_grad_enabled():
        return None
    g = (remat_group if remat_group > 1 and n_layers % remat_group == 0
         else 1)
    return [range(lo, lo + g) for lo in range(0, n_layers, g)]


def run_remat(groups: list[range], layer, x: torch.Tensor) -> torch.Tensor:
    """``x = layer(i, x)`` for every layer, each group under
    ``torch.utils.checkpoint``: the backward pass recomputes a group's
    activations from its input instead of keeping them."""
    def run(x, group):
        for i in group:
            x = layer(i, x)
        return x

    for group in groups:
        x = checkpoint(run, x, group, use_reentrant=False)
    return x


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
    """Stacked (leading L) decode cache: k/v (L, B, S, Hkv, hd) in bf16
    unless the family is ``ssm``; for ``ssm`` and ``hybrid`` the SSM state h
    (L, B, nh, hd, n) in fp32 and the conv context (L, B, cw-1, di+2n) in
    bf16.  ``hybrid_moe`` stacks k/v over its attention layers alone and h,
    conv over its Mamba layers alone."""
    n_kv = n_ssm = cfg.n_layers
    if cfg.mixers is not None:
        n_kv, n_ssm = cfg.n_mixer_layers("A"), cfg.n_mixer_layers("M")
    cache = {}
    if cfg.family != "ssm":
        shape = (n_kv, batch, max_len, cfg.n_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(shape, dtype=CACHE_DTYPE, device=device)
        cache["v"] = torch.zeros(shape, dtype=CACHE_DTYPE, device=device)
    if cfg.family in ("ssm", "hybrid", "hybrid_moe"):
        s = cfg.ssm
        di, n, nh = s.d_inner(cfg.d_model), s.d_state, s.n_heads(cfg.d_model)
        cache["h"] = torch.zeros((n_ssm, batch, nh, s.head_dim, n),
                                 dtype=torch.float32, device=device)
        cache["conv"] = torch.zeros((n_ssm, batch, s.conv_width - 1,
                                     di + 2 * n), dtype=CACHE_DTYPE,
                                    device=device)
    return cache


# --------------------------------------------------------------------------
# Layer application
# --------------------------------------------------------------------------

def apply_layer(cfg: ArchConfig, p: dict, x: torch.Tensor, *, mode: str,
                positions: torch.Tensor, window: int | None,
                layer_cache: dict | None, lengths: torch.Tensor | None,
                moe_impl: str = "dense", telemetry=None, index: int = 0
                ) -> tuple[torch.Tensor, dict]:
    """One layer; returns its output and its cache entries (the prompt's
    for prefill, the updated views of ``layer_cache`` for decode).  Under
    the sharded step ``p``'s leaves are DTensors, gathered here (inside the
    layer's remat checkpoint) to the local tensors the layer computes
    with.  With ``telemetry``, its parts are spans with ``layer=index``."""
    p = shard_ctx.gather_layer(p)

    def views(*keys):
        return (None if layer_cache is None else
                {k: layer_cache[k] for k in keys})

    def span(name, **attrs):
        return _span(telemetry, name, layer=index, **attrs)

    with span("layer.norm"):
        h = L.apply_norm(cfg, p["ln1"], x)
    a = new_cache = None
    if "attn" in p:
        with span("layer.attention"):
            a, new_cache = L.attention(
                cfg, p["attn"], h, positions=positions, mode=mode,
                causal=True, window=window, cache=views("k", "v"),
                lengths=lengths)
    if "ssm" in p:
        impl = (ops.ssd_decode_impl(h) if mode == "decode"
                else L.mamba_prefill_impl(p["ssm"], h))
        with span("layer.ssm", impl=impl):
            s, sc = L.mamba_block(cfg, p["ssm"], h, mode=mode,
                                  cache=views("h", "conv"))
        if cfg.family == "ssm":
            return x + s, sc
        if a is None:                       # a hybrid_moe Mamba layer
            a, new_cache = s, sc
        else:
            new_cache = {**new_cache, **sc}
            a = (a + s) * 0.5               # parallel heads, mean-fused
    x = x + _residual(cfg, a)
    with span("layer.norm"):
        h2 = L.apply_norm(cfg, p["ln2"], x)
    if "moe" in p:
        with span("layer.moe", impl=moe_impl):
            y = L.moe_apply(cfg, p["moe"], h2, impl=moe_impl)
        if "shared_mlp" in p:
            with span("layer.shared_mlp"):
                y = y + L.mlp(cfg, p["shared_mlp"], h2, cfg.moe.d_ff_shared)
    else:
        with span("layer.mlp"):
            y = L.mlp(cfg, p["mlp"], h2)
    return x + _residual(cfg, y), new_cache


def _residual(cfg: ArchConfig, y: torch.Tensor) -> torch.Tensor:
    """A branch as added to the residual stream: scaled by
    ``cfg.residual_multiplier`` (μP) where it is not 1."""
    r = cfg.residual_multiplier
    return y if r == 1.0 else y * r


# --------------------------------------------------------------------------
# Full forward pass
# --------------------------------------------------------------------------

def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            mode: str = "train", cache: dict | None = None,
            lengths: torch.Tensor | None = None,
            moe_impl: str = "dense", remat: bool = False,
            remat_group: int = 1, logits_tail: int | None = None,
            return_hidden: bool = False, telemetry=None
            ) -> tuple[torch.Tensor, dict | None]:
    """tokens: (B, T) integer.

    mode="train"/"prefill": full sequence; prefill returns the built cache
    (k/v (L, B, T, Hkv, hd); h (L, B, nh, hd, n) and conv (L, B, cw-1, C)
    for the SSM families).  mode="decode": T == 1, needs ``cache`` +
    ``lengths`` (new token position = lengths-1); the cache is updated in
    place and returned.  ``moe_impl``: the MoE layers' lowering
    (``layers.moe_apply``).  ``logits_tail``: only unembed the last N
    positions.  ``remat`` (train mode under autograd): checkpoint every
    ``remat_group`` layers (every layer unless it divides ``n_layers``).
    ``return_hidden``: the final-normed hidden states (B, T, d) in place of
    the logits.  ``telemetry``: a recorder to span the parts on.
    """
    b, t = tokens.shape
    with _span(telemetry, "model.embed"):
        x = L.embed(params["embed"], tokens, cfg.vocab).to(L.COMPUTE_DTYPE)
        if cfg.embedding_multiplier != 1.0:
            x = x * cfg.embedding_multiplier
        x = shard_ctx.constrain_act(x)
    if mode == "decode":
        if cache is None or lengths is None:
            raise ValueError("decode mode needs cache and lengths")
        positions = (lengths - 1)[:, None]
        # the whole cache's length (a rank may hold a share of it)
        kv_len = shard_ctx.kv_len(cache["k"].shape[2]) if "k" in cache else t
    else:
        # under a sequence split, ``tokens`` are this rank's slice of the
        # sequence: global positions, and the whole sequence's length
        positions = (torch.arange(t, device=tokens.device)
                     + shard_ctx.seq_offset(t))[None].expand(b, t)
        kv_len = t * shard_ctx.seq_rank_size()[1]
    wsched = window_schedule(cfg, kv_len)
    layers = layer_params(cfg, params["layers"])

    def layer(i, x, lc=None):
        # a window of -1 means "no window"
        w = None if wsched is None else (NO_WINDOW if wsched[i] < 0
                                         else wsched[i])
        y, c = apply_layer(cfg, layers[i], x, mode=mode,
                           positions=positions, window=w, layer_cache=lc,
                           lengths=lengths, moe_impl=moe_impl,
                           telemetry=telemetry, index=i)
        return shard_ctx.constrain_act(y), c

    built: dict[str, list] = {}
    groups = remat_groups(cfg.n_layers, remat and mode == "train",
                          remat_group)
    if groups is not None:
        x = run_remat(groups, lambda i, x: layer(i, x)[0], x)
    else:
        for i in range(cfg.n_layers):
            lc = None if cache is None else layer_cache(cfg, cache, i)
            x, lcache = layer(i, x, lc)
            if mode == "prefill":
                for k, v in lcache.items():
                    built.setdefault(k, []).append(v)
    new_cache = None
    if mode == "prefill":
        new_cache = {k: torch.stack(v) for k, v in built.items()}
    elif mode == "decode":
        new_cache = cache
    with _span(telemetry, "model.head"):
        x = L.apply_norm(cfg, params["final_norm"], x)
        if logits_tail is not None:
            x = L.seq_tail(x, logits_tail)
        if return_hidden:
            return x, new_cache
        return (shard_ctx.constrain_logits(
            L.unembed(cfg, params["embed"], x)), new_cache)
