"""Architecture and run configuration dataclasses: a copy of the
reference's ``configs/base.py`` (data only)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | enc_dec | vlm | hybrid | rwkv
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    act: str = "silu"
    mlp_gated: bool = True
    attn_bias: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    qk_norm: bool = False
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 1
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_k_dense: int = 0
    moe_every: int = 1  # 2 = alternate dense/MoE layers (llama4-style)
    capacity_factor: float = 1.25
    norm_topk: bool = True
    router_aux_weight: float = 0.01
    # --- MLA (deepseek) ---
    kv_lora: int = 0
    q_lora: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_d_inner: int = 0
    ssm_conv: int = 4
    sliding_window: int = 0  # 0 = full attention
    # --- RWKV ---
    rwkv_head_dim: int = 64
    # --- enc-dec / modality stubs ---
    n_enc_layers: int = 0
    n_frames: int = 0  # audio frontend stub: precomputed frame embeddings
    n_patches: int = 0  # vlm frontend stub: precomputed patch embeddings
    param_dtype: str = "bfloat16"

    @property
    def d_head(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab padded for TP divisibility (production practice: pad the
        embedding table, never the tokenizer). Exact when already 16-aligned."""
        if self.vocab % 16 == 0:
            return self.vocab
        return -(-self.vocab // 512) * 512

    @property
    def sub_quadratic(self) -> bool:
        """True if long_500k is runnable (SSM / hybrid / linear-attn)."""
        return self.family in ("hybrid", "rwkv")

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class RunConfig:
    seq_len: int
    global_batch: int
    mode: str = "train"  # train | prefill | decode
    attn_impl: str = "chunked"  # naive | chunked
    attn_chunk: int = 512
    loss_chunk: int = 0  # 0 = unchunked
    ssm_chunk: int = 128
    wkv_chunk: int = 64
    microbatches: int = 1
    remat: str = "full"  # none | full | dots
    sharding: str = "tp"  # tp | fsdp_tp
    seq_parallel: bool = False
    scan_unroll: int = 1
    extension_level: str = "v4"  # v0..v4 (MARVEL processor version analogue)
    moment_dtype: str = "float32"
    fuse_gate_up: bool = False  # hillclimb: fuse wg/wu into one GEMM
    moe_groups: int = 1  # GShard groups; launcher sets = # batch shards

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)

