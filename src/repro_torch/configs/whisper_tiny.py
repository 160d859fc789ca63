"""whisper-tiny — audio encoder-decoder backbone [arXiv:2212.04356;
unverified].  4L (enc) + 4L (dec) d_model=384 6H d_ff=1536 vocab=51865.

The conv frontend is a STUB per the assignment: ``input_specs()`` supplies
precomputed frame embeddings of shape (batch, seq//2, d_model) — the shape the
stride-2 conv stem would produce.  LayerNorm + GELU per the Whisper family.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                  # decoder layers
    encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    head_dim=64,
    act="gelu",
    norm="layernorm",
    source="arXiv:2212.04356; unverified",
)
