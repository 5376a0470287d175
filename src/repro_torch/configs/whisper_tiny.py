"""whisper-tiny [audio]: enc-dec, conv frontend STUBBED (precomputed frame
embeddings per assignment). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="whisper-tiny",
    family="enc_dec",
    n_layers=4,
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    act="gelu",
    mlp_gated=False,
    attn_bias=True,
    rope=False,  # sinusoidal positions
    n_frames=1500,
)
