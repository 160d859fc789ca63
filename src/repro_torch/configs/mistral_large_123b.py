"""mistral-large-123b — dense [hf:mistralai/Mistral-Large-Instruct-2407;
unverified].  88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32768,
    head_dim=128,
    act="swiglu",
    rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
)
