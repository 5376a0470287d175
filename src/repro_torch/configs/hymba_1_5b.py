"""hymba-1.5b [hybrid]: parallel attn+mamba heads, SWA attention + global SSM,
ssm_state=16. [arXiv:2411.13676; hf]

Sub-quadratic: SWA bounds attention cost; the SSM carries global context, so
long_500k decode runs with O(1) state. (Upstream hymba keeps 3 full-attention
layers + meta tokens; we use SWA everywhere for scanned-layer homogeneity —
noted in DESIGN.md.)"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    ssm_d_inner=3200,
    sliding_window=1024,
)
