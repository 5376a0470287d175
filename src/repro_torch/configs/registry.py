"""Arch registry: ``--arch <id>`` resolution and reduced smoke variants (a
copy of the reference's ``configs/registry.py`` for the families the port
serves).

The port serves the ``enc_dec``, ``vlm``, ``dense``, ``rwkv`` and ``hybrid``
families so far; :func:`get_arch` names the reference's other archs (the
``moe`` family) and refuses them with the reason.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

# the reference's arch ids and the family of each
ARCH_FAMILIES = {
    "whisper-tiny": "enc_dec",
    "llama4-maverick-400b-a17b": "moe",
    "deepseek-v2-236b": "moe",
    "internvl2-26b": "vlm",
    "granite-3-2b": "dense",
    "granite-34b": "dense",
    "qwen3-8b": "dense",
    "starcoder2-3b": "dense",
    "hymba-1.5b": "hybrid",
    "rwkv6-1.6b": "rwkv",
}
SERVED_FAMILIES = ("enc_dec", "vlm", "dense", "rwkv", "hybrid")
# the configs copied, in the reference's order
ARCH_IDS = ["whisper-tiny", "internvl2-26b", "granite-3-2b", "granite-34b",
            "qwen3-8b", "starcoder2-3b", "hymba-1.5b", "rwkv6-1.6b"]


def _module_name(arch_id: str) -> str:
    return "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_")


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_FAMILIES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(ARCH_FAMILIES)}")
    family = ARCH_FAMILIES[arch_id]
    if family not in SERVED_FAMILIES or arch_id not in ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch_id!r} ({family} family) is not served by the port "
            f"yet; it serves {ARCH_IDS} ({', '.join(SERVED_FAMILIES)})")
    return importlib.import_module(_module_name(arch_id)).ARCH


def list_archs() -> list[str]:
    return list(ARCH_IDS)


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests (small widths and
    depth), as the reference's."""
    kw = dict(
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=32,
        d_ff=256,
        vocab=512,
    )
    if cfg.family == "hybrid":
        kw.update(ssm_d_inner=256, ssm_state=8, sliding_window=32)
    if cfg.family == "rwkv":
        kw.update(rwkv_head_dim=32, d_model=128, d_ff=256)
    if cfg.family == "enc_dec":
        kw.update(n_enc_layers=2, n_frames=16)
    if cfg.family == "vlm":
        kw.update(n_patches=8)
    return cfg.replace(**kw)
