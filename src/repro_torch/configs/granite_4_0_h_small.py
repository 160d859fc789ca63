"""granite-4.0-h-small — hybrid Mamba-2 / attention decoder with a 72-expert
MoE and a shared expert in every layer [hf: ibm-granite/granite-4.0-h-small,
config.json, ``granitemoehybrid``; 32B total, 9B active].

40L d_model=4096, vocab=100352, tied head.  ``layer_types``: a Mamba-2 mixer
in 36 layers, GQA attention (32 query, 8 KV heads of 128, no positional
embedding, scale ``attention_multiplier`` 1/128) at layers 5, 15, 25 and 35.
Mamba-2: 128 heads of 64 (expand 2), d_state 128, one group, conv width 4
with a bias, chunk 256.  After the mixer every layer has 72 SwiGLU experts of
768 (``intermediate_size``), top-10, and a shared SwiGLU expert of 1536.
μP: embedding x12, residual branches x0.22, logits / 16.  One RMSNorm
epsilon, 1e-5, for the layer norms and the Mamba gated norm.  Port-only: the
JAX package has no such family, so the id is outside ``ARCH_IDS``."""

from repro_torch.models.config import ArchConfig, MoESpec, SSMSpec

_PERIOD = "MMMMMAMMMM"

CONFIG = ArchConfig(
    name="granite-4.0-h-small",
    family="hybrid_moe",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=0,                      # no dense MLP: routed and shared experts
    vocab=100352,
    head_dim=128,
    act="swiglu",
    norm_eps=1e-5,
    tie_embeddings=True,
    moe=MoESpec(num_experts=72, top_k=10, d_ff_expert=768, d_ff_shared=1536),
    ssm=SSMSpec(d_state=128, head_dim=64, expand=2, chunk=256, conv_width=4,
                conv_bias=True, norm_eps=1e-5),
    source="hf: ibm-granite/granite-4.0-h-small",
    mixers=_PERIOD * 4,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    attn_scale=0.0078125,
    rope=False,
)
