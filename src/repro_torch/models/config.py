"""Architecture configuration system.

The port's own copy of the JAX package's ``ArchConfig``/``MoESpec``/``SSMSpec``,
``ShapeConfig`` and ``SHAPES``: plain dataclasses, kept field for field equal
to their counterparts so ``--arch`` resolves to the same configuration in both
packages.  ``reduced()`` produces the small same-family config the CPU tests
and the reduced serving CLI use.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128
    conv_width: int = 4

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None           # default d_model // n_heads
    act: str = "swiglu"                   # swiglu | geglu | gelu
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # attention pattern
    sliding_window: int | None = None     # SWA width (mixtral, gemma3 local)
    local_global: int | None = None       # N local layers per 1 global (gemma3)
    # mixture-of-experts / state-space extensions
    moe: MoESpec | None = None
    ssm: SSMSpec | None = None
    # encoder-decoder (whisper): encoder layer count (decoder = n_layers)
    encoder_layers: int | None = None
    # vision-language (llama-3.2-vision): one cross-attn layer per group of
    # ``cross_attn_every`` self-attn layers; stub frontend supplies
    # ``n_vision_tokens`` precomputed patch embeddings.
    cross_attn_every: int | None = None
    n_vision_tokens: int = 1601
    # notes for DESIGN/EXPERIMENTS
    source: str = ""

    # ------------------------------------------------------------------ derived
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else (
            self.d_model // max(self.n_heads, 1))

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (DESIGN.md §4)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def params_active(self) -> float:
        """Active parameters per token (MoE counts top_k experts only)."""
        return self._param_count(active_only=True)

    def params_total(self) -> float:
        return self._param_count(active_only=False)

    def _param_count(self, active_only: bool) -> float:
        d, hd = self.d_model, self.hd
        n_q, n_kv = self.n_heads, self.n_kv_heads
        attn = d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d
        if self.act in ("swiglu", "geglu"):
            ffn_dense = 3 * d * self.d_ff
        else:
            ffn_dense = 2 * d * self.d_ff
        per_layer = 0.0
        if self.family == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            # in_proj (z,x,B,C,dt) + conv + out_proj (mamba2 fused projection)
            per_layer = d * (2 * di + 2 * s.d_state + nh) + \
                s.conv_width * (di + 2 * s.d_state) + di * d + nh
        elif self.family == "hybrid":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            ssm_p = d * (2 * di + 2 * s.d_state + nh) + \
                s.conv_width * (di + 2 * s.d_state) + di * d + nh
            per_layer = attn + ssm_p + ffn_dense
        elif self.moe is not None:
            e = self.moe.top_k if active_only else self.moe.num_experts
            moe_ffn = e * 3 * d * self.moe.d_ff_expert + d * self.moe.num_experts
            per_layer = attn + moe_ffn
        else:
            per_layer = attn + ffn_dense
        total = self.n_layers * per_layer
        if self.encoder_layers:
            # encoder self-attn+ffn, decoder already counted; add cross-attn
            total += self.encoder_layers * (attn + ffn_dense)
            total += self.n_layers * attn          # cross-attention blocks
        if self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * (attn + ffn_dense)  # extra cross layers
        emb = self.vocab * d
        total += emb if self.tie_embeddings else 2 * emb
        return float(total)

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        kw: dict = dict(
            n_layers=min(self.n_layers, 2 if self.family != "vlm" else 4),
            d_model=64, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 1,
            d_ff=128, vocab=256, head_dim=16,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(self.moe, num_experts=4,
                                            top_k=min(self.moe.top_k, 2),
                                            d_ff_expert=64)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=8, head_dim=16,
                                            chunk=8)
        if self.encoder_layers:
            kw["encoder_layers"] = 2
        if self.cross_attn_every:
            kw["cross_attn_every"] = 2
            kw["n_vision_tokens"] = 16
        if self.local_global:
            kw["local_global"] = 2
            kw["n_layers"] = 6
        if self.sliding_window:
            kw["sliding_window"] = 16
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# Input shapes (the assigned 4-shape set for LM-family archs)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """The 40-cell applicability matrix (skips recorded in DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: long_500k requires "
                       "sub-quadratic attention (DESIGN.md §4)")
    return True, ""
