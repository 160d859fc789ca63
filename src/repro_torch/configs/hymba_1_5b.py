"""hymba-1.5b — hybrid parallel attention+Mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Simplifications recorded in DESIGN.md: meta-tokens and the mixed
local/global attention schedule of the released model are not modelled; every
layer runs full attention in parallel with an SSD head (outputs mean-fused),
which is the architectural contribution the assignment exercises.
"""

from repro_torch.models.config import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,
    act="swiglu",
    sliding_window=1024,          # hybrid: SWA attention branch + SSM branch
    ssm=SSMSpec(d_state=16, head_dim=64, expand=2, chunk=128),
    source="arXiv:2411.13676; hf",
)
