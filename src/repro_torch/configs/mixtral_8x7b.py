"""mixtral-8x7b — MoE, 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf].  32L d_model=4096 32H (GQA kv=8) expert d_ff=14336
vocab=32000, window 4096."""

from repro_torch.models.config import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    head_dim=128,
    act="swiglu",
    sliding_window=4096,
    moe=MoESpec(num_experts=8, top_k=2, d_ff_expert=14336),
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088; hf",
)
