"""The port's model API, ``repro.models.model.Model``, for every family of
the zoo: dense, SSM, hybrid, MoE, the encoder-decoder (audio) and the VLM.

``build_model(cfg)`` returns a ``Model`` exposing ``init``, ``init_cache``,
their abstract counterparts ``param_specs``, ``cache_specs`` and
``input_specs`` (``meta`` tensors, for the dry-run), the three step kinds ``apply_train / apply_prefill / apply_decode``, and the
analytic cost bridge to the HiDP planner: ``step_flops``, ``param_bytes`` and
``block_costs`` (a ``ModelDAG``), copies of the JAX package's arithmetic.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import device as _device
from repro_torch.core.dag import Block, ModelDAG
from . import encdec, layers, transformer, vlm
from .config import ArchConfig, ShapeConfig


# --------------------------------------------------------------------------
# Analytic per-layer FLOPs (fwd, per token)
# --------------------------------------------------------------------------

def _attn_proj_flops(cfg: ArchConfig) -> float:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return 2.0 * d * hq * hd + 2 * (2.0 * d * hkv * hd) + 2.0 * hq * hd * d


def _attn_ctx_flops(cfg: ArchConfig, ctx: float) -> float:
    """QK^T + PV flops per token at effective context ``ctx``."""
    return 4.0 * cfg.n_heads * cfg.hd * ctx


def _mlp_flops(cfg: ArchConfig, d_ff: int | None = None) -> float:
    ff = d_ff if d_ff is not None else cfg.d_ff
    mult = 3 if cfg.act in ("swiglu", "geglu") else 2
    return 2.0 * mult * cfg.d_model * ff


def _moe_flops(cfg: ArchConfig) -> float:
    """The router, the top-k experts and the shared expert, where there is
    one."""
    m = cfg.moe
    router = 2.0 * cfg.d_model * m.num_experts
    expert = m.top_k * 2.0 * 3 * cfg.d_model * m.d_ff_expert
    if m.d_ff_shared:
        expert += 2.0 * 3 * cfg.d_model * m.d_ff_shared
    return router + expert


def _ssm_flops(cfg: ArchConfig, decode: bool) -> float:
    s = cfg.ssm
    d = cfg.d_model
    di, n, nh, hd = s.d_inner(d), s.d_state, s.n_heads(d), s.head_dim
    proj = 2.0 * d * (2 * di + 2 * n + nh) + 2.0 * di * d
    conv = 2.0 * s.conv_width * (di + 2 * n)
    if decode:
        ssd = 2.0 * nh * hd * n * 2            # state update + readout
    else:
        c = s.chunk
        intra = 2.0 * c * n + 2.0 * c * nh * hd      # CB^T row + L·x̄ combine
        inter = 4.0 * nh * hd * n                    # states + y_off
        ssd = intra + inter
    return proj + conv + ssd


def _eff_ctx(T: float, window: float | None, causal: bool = True) -> float:
    base = T / 2 if causal else T
    if window is None:
        return base
    return min(float(window), base)


def layer_flops_per_token(cfg: ArchConfig, ctx: float, *,
                          decode: bool, window: int | None,
                          mixer: str | None = None) -> float:
    """One layer, one token, forward.  ``mixer``: a ``hybrid_moe`` layer's
    ("M": the Mamba-2 mixer; "A": attention at ``ctx``), before its MoE."""
    if cfg.family == "hybrid_moe":
        f = (_ssm_flops(cfg, decode) if mixer == "M"
             else _attn_proj_flops(cfg) + _attn_ctx_flops(cfg, ctx))
        return f + _moe_flops(cfg)
    if cfg.family == "ssm":
        return _ssm_flops(cfg, decode)
    f = _attn_proj_flops(cfg) + _attn_ctx_flops(cfg, ctx)
    if cfg.family == "hybrid":
        f += _ssm_flops(cfg, decode)
    if cfg.family == "moe":
        f += _moe_flops(cfg)
    else:
        f += _mlp_flops(cfg)
    return f


def _mixers(cfg: ArchConfig) -> list[str | None]:
    """Each layer's mixer letter (``hybrid_moe``), else None a layer."""
    return list(cfg.mixers) if cfg.mixers else [None] * cfg.n_layers


def _per_layer_windows(cfg: ArchConfig) -> list[int | None]:
    out: list[int | None] = []
    for i in range(cfg.n_layers):
        w = cfg.sliding_window
        if w is not None and cfg.local_global is not None:
            if (i % (cfg.local_global + 1)) == cfg.local_global:
                w = None                      # global layer
        out.append(w)
    return out


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # ------------------------------------------------------------------ params
    def init(self, generator: torch.Generator, device="cuda",
             dtype: torch.dtype = torch.float32) -> dict:
        """Seeded parameters on ``device``; matmul weights, embeddings, the
        SSM mixer's A_log/D/dt_bias/norm and the VLM's gates in ``dtype``,
        norm weights fp32.  ``generator`` must live on ``device``."""
        dev = _device.resolve(device)
        if self.cfg.family == "audio":
            return encdec.init_params(self.cfg, generator, dev, dtype)
        if self.cfg.family == "vlm":
            return vlm.init_params(self.cfg, generator, dev, dtype)
        return transformer.init_params(self.cfg, generator, dev, dtype)

    def param_specs(self, dtype: torch.dtype = torch.float32) -> dict:
        """The parameter tree as ``meta`` tensors: the shapes and dtypes of
        ``init``'s, no storage (the dry-run's abstract parameters)."""
        meta = torch.device("meta")
        if self.cfg.family == "audio":
            return encdec.init_params(self.cfg, None, meta, dtype)
        if self.cfg.family == "vlm":
            return vlm.init_params(self.cfg, None, meta, dtype)
        return transformer.init_params(self.cfg, None, meta, dtype)

    def init_cache(self, batch: int, max_len: int, device="cuda",
                   enc_len: int | None = None) -> dict:
        """The decode cache; the audio family's cross cache holds
        ``enc_len`` encoder rows (``max_len // 2`` by default)."""
        dev = _device.resolve(device)
        if self.cfg.family == "audio":
            return encdec.init_cache(self.cfg, batch, max_len,
                                     enc_len or max_len // 2, dev)
        if self.cfg.family == "vlm":
            return vlm.init_cache(self.cfg, batch, max_len, dev)
        return transformer.init_cache(self.cfg, batch, max_len, dev)

    # ------------------------------------------------------------------- steps
    # ``moe_impl`` is the MoE layers' lowering (``layers.moe_apply``).  The
    # inference steps default to "routed", each token through its top-k
    # experts alone, so the serving engine, which passes none, serves it;
    # training defaults to "dense", and the training loop and the sharded
    # steps pass their plan's lowering.  The audio family reads
    # ``batch["frames"]`` (B, T_enc, d) and the VLM ``batch["vision"]``
    # (B, Nv, d) in train and prefill.  ``telemetry`` (the serving engine's
    # recorder) spans the decoder-only families' parts
    # (``transformer.forward``); the audio family and the VLM ignore it.
    def apply_train(self, params: dict, batch: dict, *, remat: bool = True,
                    moe_impl: str = "dense", remat_group: int = 1,
                    return_hidden: bool = False) -> torch.Tensor:
        """Logits (B, T, V) fp32 over the whole sequence, or the final-normed
        hidden states (B, T, d) with ``return_hidden`` (chunked CE unembeds
        them in slices, ``unembed_hidden``).  ``remat`` checkpoints every
        ``remat_group`` layers under autograd (the audio family's decoder
        layers, the VLM's groups); without autograd it changes nothing."""
        cfg = self.cfg
        if cfg.family == "hybrid_moe":
            raise NotImplementedError("training the hybrid_moe family is not "
                                      "ported: it serves only")
        if cfg.family == "audio":
            out, _ = encdec.forward(cfg, params, batch["frames"],
                                    batch["tokens"], mode="train",
                                    remat=remat, return_hidden=return_hidden)
        elif cfg.family == "vlm":
            out, _ = vlm.forward(cfg, params, batch["tokens"],
                                 vision=batch["vision"], mode="train",
                                 remat=remat, return_hidden=return_hidden)
        else:
            out, _ = transformer.forward(cfg, params, batch["tokens"],
                                         mode="train", remat=remat,
                                         remat_group=remat_group,
                                         moe_impl=moe_impl,
                                         return_hidden=return_hidden)
        return out

    def unembed_hidden(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """(B, T, d) → (B, T, V) fp32 logits (the shared head)."""
        return layers.unembed(self.cfg, params["embed"], x)

    def apply_prefill(self, params: dict, batch: dict, *,
                      moe_impl: str = "routed", telemetry=None
                      ) -> tuple[torch.Tensor, dict]:
        """Last-position logits (B, 1, V) and the prompt's cache."""
        cfg = self.cfg
        lengths = batch.get("lengths")
        if cfg.family == "audio":
            return encdec.forward(cfg, params, batch["frames"],
                                  batch["tokens"], mode="prefill",
                                  lengths=lengths, logits_tail=1)
        if cfg.family == "vlm":
            return vlm.forward(cfg, params, batch["tokens"],
                               vision=batch["vision"], mode="prefill",
                               lengths=lengths, logits_tail=1)
        return transformer.forward(cfg, params, batch["tokens"],
                                   mode="prefill", lengths=lengths,
                                   moe_impl=moe_impl, logits_tail=1,
                                   telemetry=telemetry)

    def apply_decode(self, params: dict, cache: dict, batch: dict, *,
                     moe_impl: str = "routed", telemetry=None
                     ) -> tuple[torch.Tensor, dict]:
        """One token per sequence at position ``lengths-1``; ``cache`` is
        updated in place and returned."""
        cfg = self.cfg
        lengths = batch["lengths"]
        if cfg.family == "audio":
            return encdec.decode(cfg, params, batch["tokens"], mode="decode",
                                 cache=cache, lengths=lengths)
        if cfg.family == "vlm":
            return vlm.forward(cfg, params, batch["tokens"], mode="decode",
                               cache=cache, lengths=lengths)
        return transformer.forward(cfg, params, batch["tokens"],
                                   mode="decode", cache=cache,
                                   lengths=lengths, moe_impl=moe_impl,
                                   telemetry=telemetry)

    # ----------------------------------------------------------- input specs
    def input_specs(self, shape: ShapeConfig) -> dict:
        """``meta`` stand-ins for every model input of ``shape``'s step
        (int32 tokens, targets and lengths; bf16 frames and vision)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def meta(shp, dtype=torch.bfloat16):
            return torch.empty(tuple(int(s) for s in shp), dtype=dtype,
                               device="meta")
        i32 = torch.int32
        if shape.kind == "decode":      # one new token against a cache of S
            return {"tokens": meta((B, 1), i32), "lengths": meta((B,), i32)}
        specs = {"tokens": meta((B, S), i32)}
        specs["targets" if shape.kind == "train" else "lengths"] = meta(
            (B, S) if shape.kind == "train" else (B,), i32)
        if cfg.family == "audio":
            specs["frames"] = meta((B, S // 2, cfg.d_model))
        if cfg.family == "vlm":
            specs["vision"] = meta((B, cfg.n_vision_tokens, cfg.d_model))
        return specs

    def cache_specs(self, shape: ShapeConfig) -> dict:
        """The decode cache of ``shape`` as ``meta`` tensors."""
        B, S = shape.global_batch, shape.seq_len
        meta = torch.device("meta")
        if self.cfg.family == "audio":
            return encdec.init_cache(self.cfg, B, S, S // 2, meta)
        if self.cfg.family == "vlm":
            return vlm.init_cache(self.cfg, B, S, meta)
        return transformer.init_cache(self.cfg, B, S, meta)

    # ------------------------------------------------------------ cost model
    def step_flops(self, shape: ShapeConfig) -> float:
        """Analytic useful FLOPs for one step (the JAX package's
        MODEL_FLOPS).  Train = 3× forward (6ND convention); remat overhead
        NOT included.  MoE layers count the router and the top-k experts
        (``_moe_flops``); the audio family adds its encoder and the
        decoder's cross-attention, the VLM its cross layers."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        decode = shape.kind == "decode"
        T = 1 if decode else S
        tokens = B * T
        total = 0.0
        for w, m in zip(_per_layer_windows(cfg), _mixers(cfg)):
            ctx = _eff_ctx(S if decode else S, w, causal=True)
            total += tokens * layer_flops_per_token(cfg, ctx, decode=decode,
                                                    window=w, mixer=m)
        if cfg.family == "audio":
            enc_tokens = B * (S // 2 if not decode else S // 2)
            enc_layer = (_attn_proj_flops(cfg)
                         + _attn_ctx_flops(cfg, (S // 2) if not decode
                                           else S // 2)
                         + _mlp_flops(cfg))
            if not decode:
                total += enc_tokens * enc_layer * cfg.encoder_layers
            # decoder cross-attention (per decoder layer, context = enc len)
            total += tokens * cfg.n_layers * (
                _attn_ctx_flops(cfg, S // 2) + _attn_proj_flops(cfg) / 2)
        if cfg.family == "vlm":
            ng = vlm.n_groups(cfg)
            total += tokens * ng * (
                _attn_ctx_flops(cfg, cfg.n_vision_tokens)
                + _attn_proj_flops(cfg) / 2 + _mlp_flops(cfg))
        # head (+ embed lookup is gather, ~0 flops)
        head_positions = tokens if shape.kind == "train" else B
        total += head_positions * 2.0 * cfg.d_model * cfg.vocab
        if shape.kind == "train":
            total *= 3.0
        return total

    def param_bytes(self, dtype_bytes: int = 2) -> float:
        return self.cfg.params_total() * dtype_bytes

    # -------------------------------------------------- HiDP planner bridge
    def block_costs(self, shape: ShapeConfig) -> ModelDAG:
        """The model as a partitionable block DAG (embed, L layers, head) for
        the HiDP global/local DP.  A ``hybrid_moe`` model's blocks differ by
        layer: a Mamba layer is an "ssm" block, which the decode step cannot
        split by data (its state is recurrent), and an attention layer a
        "moe" block; each carries its own FLOPs and parameters."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        decode = shape.kind == "decode"
        T = 1 if decode else S
        tokens = B * T
        act_bytes = float(tokens * cfg.d_model * 2)          # bf16 edge
        mult = 3.0 if shape.kind == "train" else 1.0
        blocks: list[Block] = []
        blocks.append(Block(
            name="embed", kind="embed", flops=tokens * 1e3,  # gather ≈ free
            param_bytes=cfg.vocab * cfg.d_model * 2.0,
            bytes_in=float(tokens * 4), bytes_out=act_bytes,
            data_splittable=True))
        windows = _per_layer_windows(cfg)
        per_layer_params = ((cfg.params_total()
                             - (1 if cfg.tie_embeddings else 2)
                             * cfg.vocab * cfg.d_model)
                            / cfg.n_layers * 2.0)
        kinds = {"moe": "moe", "ssm": "ssm", "hybrid": "ssm"}
        # Decode-step data splitting = context parallelism over the KV cache:
        # legal when the per-layer state is a positional cache (attention),
        # illegal for recurrent SSM state.
        decode_splittable = cfg.family not in ("ssm", "hybrid")
        for i, (w, m) in enumerate(zip(windows, _mixers(cfg))):
            ctx = _eff_ctx(S, w)
            f = tokens * layer_flops_per_token(cfg, ctx, decode=decode,
                                               window=w, mixer=m) * mult
            kind = kinds.get(cfg.family, "attn")
            splittable, pbytes = decode_splittable, per_layer_params
            if m is not None:
                kind = "ssm" if m == "M" else "moe"
                splittable = m == "A"
                pbytes = cfg.hybrid_moe_layer_params(m) * 2.0
            blocks.append(Block(
                name=f"layer{i}", kind=kind,
                flops=f, param_bytes=pbytes,
                bytes_in=act_bytes, bytes_out=act_bytes,
                data_splittable=splittable if decode else True))
        head_tokens = tokens if shape.kind == "train" else B
        blocks.append(Block(
            name="head", kind="dense",
            flops=head_tokens * 2.0 * cfg.d_model * cfg.vocab * mult,
            param_bytes=(0.0 if cfg.tie_embeddings
                         else cfg.vocab * cfg.d_model * 2.0),
            bytes_in=act_bytes, bytes_out=float(head_tokens * cfg.vocab * 4),
            data_splittable=True))
        return ModelDAG(name=f"{cfg.name}:{shape.name}", blocks=tuple(blocks),
                        input_bytes=float(tokens * 4),
                        output_bytes=blocks[-1].bytes_out)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
