"""minicpm-2b — dense llama-like, trained with the WSD schedule
[arXiv:2404.06395; hf].  40L d_model=2304 36H (full MHA kv=36) d_ff=5760
vocab=122753.  The WSD (warmup-stable-decay) schedule is implemented in
training/optimizer.py and selected by this config."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    head_dim=64,
    act="swiglu",
    tie_embeddings=True,
    source="arXiv:2404.06395; hf",
)

# training-schedule marker consumed by training/optimizer.py
LR_SCHEDULE = "wsd"
