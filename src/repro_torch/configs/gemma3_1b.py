"""gemma3-1b — dense, 5:1 local:global attention, 128k-class context
[hf:google/gemma-3-1b-pt; unverified].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144. head_dim=256 (Gemma
family uses wide heads decoupled from d_model); local layers are 512-token
sliding-window, every 6th layer is global.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab=262144,
    head_dim=256,
    act="geglu",
    tie_embeddings=True,
    sliding_window=512,
    local_global=5,               # 5 local layers per 1 global
    rope_theta=1_000_000.0,
    source="hf:google/gemma-3-1b-pt; unverified",
)
