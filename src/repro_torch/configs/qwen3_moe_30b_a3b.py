"""qwen3-moe-30b-a3b — fine-grained MoE, 128 experts top-8
[hf:Qwen/Qwen3-30B-A3B; hf].  48L d_model=2048 32H (GQA kv=4) expert
d_ff=768 vocab=151936."""

from repro_torch.models.config import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab=151936,
    head_dim=128,
    act="swiglu",
    moe=MoESpec(num_experts=128, top_k=8, d_ff_expert=768),
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
