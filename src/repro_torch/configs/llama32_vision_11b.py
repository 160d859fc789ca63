"""llama-3.2-vision-11b — VLM backbone with cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; one cross-attention
layer per 5 self-attention layers (8 cross layers).  The vision tower is a
STUB: ``input_specs()`` supplies (batch, 1601, d_model) precomputed patch
embeddings; their KV is computed once at prefill and static during decode.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    head_dim=128,
    act="swiglu",
    cross_attn_every=5,
    n_vision_tokens=1601,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
