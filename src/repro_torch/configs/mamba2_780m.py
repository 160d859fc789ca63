"""mamba2-780m — attention-free SSM with SSD (state-space duality)
[arXiv:2405.21060; unverified].  48L d_model=1536 vocab=50280, d_state=128,
expand=2 (d_inner=3072, 48 SSD heads of head_dim 64)."""

from repro_torch.models.config import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,                  # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMSpec(d_state=128, head_dim=64, expand=2, chunk=128),
    source="arXiv:2405.21060; unverified",
)
