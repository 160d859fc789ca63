"""gemma-2b — dense, GeGLU, MQA [arXiv:2403.08295; hf].

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000, head_dim=256."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=256000,
    head_dim=256,
    act="geglu",
    tie_embeddings=True,
    source="arXiv:2403.08295; hf",
)
