"""zol: causal attention with an online softmax, streamed over KV tiles.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::_kernel``
(its ``pl.pallas_call`` at ``flash_attention.py:87``); the CUDA kernel is
``csrc/flash_attention.cu``, whose header says what bounds it on the H100
and how its design answers that.

The kernel reads the model's grouped layouts in place: q is
``(B, Sq, K, G, d)`` (K KV heads of G query heads each), k and v are
``(B, Skv, K, d)``, and the output comes back in q's layout and type.  Each
query head reads its KV head by index (the reference wrapper's
``jnp.repeat`` of KV per group is not materialised), ragged S is masked by
position (no padded copies), and KV tiles above the diagonal are skipped.

The kernel has two forms, chosen by :func:`flash_form` from the type,
head size and alignment alone: ``"wgmma"`` (bf16 at d = 64 or 128, on
tensor cores, TMA-fed) and ``"fma"`` (CUDA-core f32 FMAs: f32 attention,
which tensor cores would compute in TF32, and every other head size).

:func:`flash_attention` is the wrapper: CPU tensors run the plain version
(:func:`~repro_torch.kernels.ref.flash_attention_plain` on the
``(B*K*G, S, d)`` view the reference kernel takes), CUDA tensors launch the
kernel (``flash_attention.launches`` counts the launches,
``flash_attention.launches_by_form`` them per form).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, runs_plain
from repro_torch.kernels.ref import flash_attention_plain as _plain_bh

_TYPES = (torch.float32, torch.bfloat16)
D_MAX = 128  # the widest head the kernel stages (csrc/flash_attention.cu)
_INT32_MAX = 2**31 - 1
_GRID_Y_MAX = 65535
FORMS = ("fma", "wgmma")
WGMMA_D = (64, 128)  # the head sizes of the wgmma form
WGMMA_BQ = 128  # its queries per block


def flash_form(d: int, skv: int, dtype, aligned: bool = True) -> str:
    """The form a CUDA launch takes: bf16 with d = 64 or 128, a KV
    length of at least one and 16-byte aligned bases (what TMA reads) go to
    the tensor cores (``"wgmma"``); everything else, f32 above all, to
    ``"fma"``."""
    if dtype != torch.bfloat16 or d not in WGMMA_D or skv < 1 or not aligned:
        return "fma"
    return "wgmma"


def launch_form(q, k, v) -> str:
    """:func:`flash_form` of the operands as :func:`_launch` reads them."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v)
                  if t.is_contiguous())
    return flash_form(q.shape[-1], k.shape[1], q.dtype, aligned)


def to_bh(q, k, v):
    """Grouped layouts -> the reference kernel's (B*K*G, S, d) operands, KV
    repeated per group."""
    b, sq, kh, g, d = q.shape
    skv = k.shape[1]
    qf = q.permute(0, 2, 3, 1, 4).reshape(b * kh * g, sq, d)
    kf = k.permute(0, 2, 1, 3).reshape(b * kh, skv, d).repeat_interleave(
        g, dim=0)
    vf = v.permute(0, 2, 1, 3).reshape(b * kh, skv, -1).repeat_interleave(
        g, dim=0)
    return qf, kf, vf


def from_bh(out, q_shape):
    """(B*K*G, Sq, d) -> q's (B, Sq, K, G, d) layout."""
    b, sq, kh, g, d = q_shape
    return out.reshape(b, kh, g, sq, d).permute(0, 3, 1, 2, 4)


def flash_attention_plain(q, k, v, causal=True):
    """The kernel's function on the grouped layouts, in plain PyTorch."""
    return from_bh(_plain_bh(*to_bh(q, k, v), causal=causal), q.shape)


def _launch(q, k, v, causal, form=None):
    b, sq, kh, g, d = q.shape
    skv = k.shape[1]
    dt = q.dtype
    form = form or launch_form(q, k, v)
    if dt not in _TYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {dt}")
    if not 1 <= d <= D_MAX:
        raise ValueError(f"head dim {d} outside the kernel's 1..{D_MAX}")
    rows = b * kh * g if form == "fma" else -(-sq // WGMMA_BQ)
    if rows > _GRID_Y_MAX:
        raise ValueError(f"{rows} grid rows exceed the kernel's grid")
    if max(q.numel(), k.numel()) > _INT32_MAX:
        raise ValueError("operands exceed the kernel's 32-bit indexing")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_operand(q, "q", dt, (b, sq, kh, g, d))
    check_operand(k, "k", dt, (b, skv, kh, d))
    check_operand(v, "v", dt, (b, skv, kh, d))
    if form != "fma" and launch_form(q, k, v) != form:
        raise ValueError(f"the {form} form cannot take {dt} heads of {d} "
                         f"over {skv} keys")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        status = build.lib().marvel_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, kh, g, d, 1.0 / math.sqrt(d), int(causal),
            int(dt == torch.bfloat16), FORMS.index(form),
            build.stream_ptr(q.device))
    build.check("flash_attention", status)
    return out


def flash_attention(q, k, v, causal=True):
    """q: (B, Sq, K, G, d); k, v: (B, Skv, K, d), one type -> (B, Sq, K, G,
    d) in q.dtype: ``softmax(q k^T / sqrt(d) [causal mask]) v`` with the
    reference kernel's rounding (f32 scores and sums, the probabilities in
    v.dtype for the PV product)."""
    if k.shape != v.shape or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"k {tuple(k.shape)} {k.dtype} and v "
                         f"{tuple(v.shape)} {v.dtype} must match q's type "
                         f"{q.dtype} and each other")
    if runs_plain(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal)
    out = _launch(q, k, v, causal)
    flash_attention.launches += 1
    flash_attention.launches_by_form[launch_form(q, k, v)] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_form = dict.fromkeys(FORMS, 0)
