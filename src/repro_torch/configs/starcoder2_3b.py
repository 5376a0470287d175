"""starcoder2-3b [dense]: GQA kv=2, RoPE, non-gated GELU MLP, biases.
[arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    act="gelu",
    mlp_gated=False,
    attn_bias=True,
)
