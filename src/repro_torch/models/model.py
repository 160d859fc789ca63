"""The port's model API, ``repro.models.model.Model`` for the dense, SSM and
hybrid families.

``build_model(cfg)`` returns a ``Model`` exposing ``init``, ``init_cache``,
the three step kinds ``apply_train / apply_prefill / apply_decode``, and the
analytic cost bridge to the HiDP planner: ``step_flops``, ``param_bytes`` and
``block_costs`` (a ``ModelDAG``), copies of the JAX package's arithmetic.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import device as _device
from repro_torch.core.dag import Block, ModelDAG
from . import transformer
from .config import ArchConfig, ShapeConfig

FAMILIES = ("dense", "ssm", "hybrid")
# the slice that ports each family the port does not serve yet
_LATER = {"moe": "the MoE slice", "audio": "the encoder-decoder/VLM slice",
          "vlm": "the encoder-decoder/VLM slice"}


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
    m = cfg.moe
    router = 2.0 * cfg.d_model * m.num_experts
    expert = m.top_k * 2.0 * 3 * cfg.d_model * m.d_ff_expert
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
                          decode: bool, window: int | None) -> float:
    """One layer, one token, forward."""
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

    def __post_init__(self):
        if self.cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{self.cfg.name}: the {self.cfg.family!r} family is ported "
                f"with {_LATER[self.cfg.family]}; this port serves "
                f"{', '.join(FAMILIES)}")

    # ------------------------------------------------------------------ params
    def init(self, generator: torch.Generator, device="cuda",
             dtype: torch.dtype = torch.float32) -> dict:
        """Seeded parameters on ``device``; matmul weights, embeddings and
        the SSM mixer's A_log/D/dt_bias/norm in ``dtype``, norm weights
        fp32.  ``generator`` must live on ``device``."""
        dev = _device.resolve(device)
        return transformer.init_params(self.cfg, generator, dev, dtype)

    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        return transformer.init_cache(self.cfg, batch, max_len,
                                      _device.resolve(device))

    # ------------------------------------------------------------------- steps
    def apply_train(self, params: dict, batch: dict) -> torch.Tensor:
        """Logits (B, T, V) fp32 over the whole sequence."""
        out, _ = transformer.forward(self.cfg, params, batch["tokens"],
                                     mode="train")
        return out

    def apply_prefill(self, params: dict, batch: dict
                      ) -> tuple[torch.Tensor, dict]:
        """Last-position logits (B, 1, V) and the prompt's cache
        (``transformer.forward``)."""
        return transformer.forward(self.cfg, params, batch["tokens"],
                                   mode="prefill",
                                   lengths=batch.get("lengths"),
                                   logits_tail=1)

    def apply_decode(self, params: dict, cache: dict, batch: dict
                     ) -> tuple[torch.Tensor, dict]:
        """One token per sequence at position ``lengths-1``; ``cache`` is
        updated in place and returned."""
        return transformer.forward(self.cfg, params, batch["tokens"],
                                   mode="decode", cache=cache,
                                   lengths=batch["lengths"])

    # ------------------------------------------------------------ cost model
    def step_flops(self, shape: ShapeConfig) -> float:
        """Analytic useful FLOPs for one step (the JAX package's
        MODEL_FLOPS).  Train = 3× forward (6ND convention); remat overhead
        NOT included.  The MoE, audio and VLM terms come with those
        families."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        decode = shape.kind == "decode"
        T = 1 if decode else S
        tokens = B * T
        total = 0.0
        for w in _per_layer_windows(cfg):
            ctx = _eff_ctx(S if decode else S, w, causal=True)
            total += tokens * layer_flops_per_token(cfg, ctx, decode=decode,
                                                    window=w)
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
        the HiDP global/local DP."""
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
        for i, w in enumerate(windows):
            ctx = _eff_ctx(S, w)
            f = tokens * layer_flops_per_token(cfg, ctx, decode=decode,
                                               window=w) * mult
            blocks.append(Block(
                name=f"layer{i}", kind=kinds.get(cfg.family, "attn"),
                flops=f, param_bytes=per_layer_params,
                bytes_in=act_bytes, bytes_out=act_bytes,
                data_splittable=decode_splittable if decode else True))
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
