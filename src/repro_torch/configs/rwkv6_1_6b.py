"""rwkv6-1.6b "Finch" [ssm]: attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]

Sub-quadratic by construction (O(1) recurrent state) — runs long_500k."""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="rwkv6-1.6b",
    family="rwkv",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # d_model / rwkv_head_dim; bookkeeping only
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    rope=False,
    rwkv_head_dim=64,
)
