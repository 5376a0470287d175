"""Plain PyTorch baselines: the oracles the dispatch wrappers fall back to
when a site is outside a kernel's guards, the v0 arithmetic of the model
sites, the plain versions of the LM kernels (``residual_rmsnorm``,
``flash_attention``) with the int8-KV dequant, and of the rnn_lm kernels
(``mac_matmul_int8``, the chunked ``wkv_chunk`` and its token-by-token
oracle).

Every float product and convolution here runs under :func:`full_f32`: on a
CUDA tensor, cuDNN would otherwise run a float32 convolution in TF32 (its
default), a 10-bit mantissa where the reference computes in f32, and cuBLAS
may reduce a bf16 product in bf16 where the reference accumulates in f32."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import (
    conv_out_size, full_f32, same_pads,
)
from repro_torch.models.layers import ACTS, NEG_INF


def conv_nhwc(x, w, *, stride=1, padding="SAME", groups=1):
    """NHWC x HWIO -> NHWC convolution in x's dtype, with XLA's padding
    rules (SAME puts the smaller half low; explicit ``((lo, hi), (lo, hi))``
    pairs are taken as given).  A degenerate VALID output is empty."""
    n, h, w_in, _ = x.shape
    kh, kw, _, cout = w.shape
    if isinstance(padding, str):
        (top, bottom), (left, right) = (same_pads(h, kh, stride, padding),
                                        same_pads(w_in, kw, stride, padding))
    else:
        (top, bottom), (left, right) = padding
    ho = (h + top + bottom - kh) // stride + 1
    wo = (w_in + left + right - kw) // stride + 1
    if ho <= 0 or wo <= 0:
        return x.new_zeros((n, max(ho, 0), max(wo, 0), cout))
    xc = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    with full_f32():
        y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def matmul_epilogue_ref(x, w, b=None, act="none", scale=None, shift=None,
                        residual=None):
    with full_f32():
        y = x.float() @ w.float()
    if b is not None:
        y = y + b.float()
    if scale is not None:
        y = y * scale.float()
    if shift is not None:
        y = y + shift.float()
    if residual is not None:
        y = y + residual.float()
    return ACTS[act](y).to(x.dtype)


def fused_conv_ref(x, w, b=None, *, stride=1, padding="SAME", groups=1,
                   act="none", scale=None, shift=None, residual=None):
    """Fused-conv oracle: conv + bias + folded-BN affine (+ residual-add
    accumulate, the acc_mac epilogue) + act in f32."""
    y = conv_nhwc(x.float(), w.float(), stride=stride, padding=padding,
                  groups=groups)
    if b is not None:
        y = y + b.float()
    if scale is not None:
        y = y * scale.float()
    if shift is not None:
        y = y + shift.float()
    if residual is not None:
        y = y + residual.float()
    return ACTS[act](y).to(x.dtype)


def depthwise_conv_ref(x, w, b=None, *, stride=1, padding="SAME",
                       act="none", scale=None, shift=None):
    """Depthwise-conv oracle (groups == channels); w is (KH, KW, 1, C) HWIO
    or the squeezed (KH, KW, C) tap stack the kernel takes."""
    if w.ndim == 3:
        w = w[:, :, None, :]
    return fused_conv_ref(x, w, b, stride=stride, padding=padding,
                          groups=x.shape[-1], act=act, scale=scale,
                          shift=shift)


def sep_block_ref(x, w_dw, w_pw, *, stride=1, padding="SAME", dw_scale=None,
                  dw_shift=None, dw_act="relu", pw_bias=None, pw_scale=None,
                  pw_shift=None, pw_act="none"):
    """Separable-block oracle: depthwise (+epilogue) -> 1x1 pointwise
    (+epilogue), the unfused two-pass form of the sep_block kernel."""
    y = depthwise_conv_ref(x, w_dw, None, stride=stride, padding=padding,
                           act=dw_act, scale=dw_scale, shift=dw_shift)
    return fused_conv_ref(y, w_pw, pw_bias, stride=1, padding="SAME",
                          groups=1, act=pw_act, scale=pw_scale,
                          shift=pw_shift)


def pool_taps(xf, k, stride):
    """The k*k strided tap views of a VALID window (row-major tap order)."""
    ho = conv_out_size(xf.shape[1], k, stride, "VALID")
    wo = conv_out_size(xf.shape[2], k, stride, "VALID")
    for kh in range(k):
        for kw in range(k):
            yield xf[:, kh:kh + (ho - 1) * stride + 1:stride,
                     kw:kw + (wo - 1) * stride + 1:stride, :]


def avg_out_dtype(dtype: torch.dtype) -> torch.dtype:
    """Integer means are not integers: avg pools of int input return f32."""
    return torch.float32 if not dtype.is_floating_point else dtype


def pool_ref(x, *, op, k=2, stride=2):
    """Pooling oracle: windowed max/avg (VALID) or the global-avg reduction,
    accumulated in f32.  Integer-typed avg pools return f32; max pools keep
    the input dtype."""
    xf = x.float()
    if op == "global_avg":
        return xf.mean(dim=(1, 2)).to(avg_out_dtype(x.dtype))
    if op not in ("max", "avg"):
        raise ValueError(f"unknown pool op {op!r}")
    taps = pool_taps(xf, k, stride)
    acc = next(taps)
    for t in taps:
        acc = torch.maximum(acc, t) if op == "max" else acc + t
    if op == "max":
        return acc.to(x.dtype)
    return (acc / float(k * k)).to(avg_out_dtype(x.dtype))


# ---------------------------------------------------------------------------
# the LM kernels' plain versions
# ---------------------------------------------------------------------------


def residual_rmsnorm_plain(res, x, scale, eps=1e-6):
    """The add2i kernel's function (``src/repro/kernels/residual_rmsnorm.py::
    _kernel``): ``r = f32(res) + f32(x)``; returns ``(r`` in res.dtype,
    ``r * rsqrt(mean(r**2) + eps) * scale`` in res.dtype), the norm taken on
    the unrounded f32 ``r``."""
    r = res.float() + x.float()
    var = r.square().mean(dim=-1, keepdim=True)
    y = r * torch.rsqrt(var + eps) * scale.float()
    return r.to(res.dtype), y.to(res.dtype)


def flash_attention_plain(q, k, v, causal=True):
    """The zol kernel's function (``src/repro/kernels/flash_attention.py::
    _kernel``) on ``(BH, Sq, d)`` / ``(BH, Skv, d)``: f32 scores scaled by
    ``1/sqrt(d)`` after the product, masked with -1e30 (query i sees keys
    ``<= i``), softmax with the probabilities rounded to ``v.dtype`` before
    the PV product and the denominator summed from the unrounded ones,
    ``acc / max(l, 1e-30)`` in ``q.dtype``.  One block spans the whole KV
    row, so it differs from the kernel's blocked online softmax only in
    rounding."""
    sq, skv, d = q.shape[1], k.shape[1], q.shape[-1]
    with full_f32():
        s = torch.einsum("bqd,bkd->bqk", q.float(), k.float())
    s = s * (1.0 / math.sqrt(d))
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True)
    with full_f32():
        acc = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    return (acc / torch.clamp_min(den, 1e-30)).to(q.dtype)


def dequant_kv(codes, scales, dtype):
    """int8 KV codes with per-(position, head) f32 scale planes -> ``dtype``
    (the rank-1 dequant the reference applies at the attention boundary)."""
    return (codes.float() * scales[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# the rnn_lm kernels' plain versions
# ---------------------------------------------------------------------------


def mac_matmul_int8_ref(x_int8, w_int8, scale, out_dtype=torch.float32):
    """The mac kernel's function (``src/repro/kernels/mac_matmul.py::
    _kernel``): ``x @ w`` summed exactly (float64 holds every int32 sum of
    int8 products exactly, and cuBLAS has no int32 product), then
    ``f32(acc) * scale`` per output column."""
    with full_f32():
        acc = x_int8.double() @ w_int8.double()
    return (acc.float() * scale.float().reshape(1, -1)).to(out_dtype)


def wkv_chunk_ref(r, k, v, lw, u, s0, chunk):
    """Chunked WKV (``src/repro/models/rwkv.py::_wkv_chunk_ref``).
    r, k, v: (B, S, H, N); lw: (B, S, H, N) log-decay (< 0); u: (H, N);
    s0: (B, H, N, N); S % chunk == 0.  Returns (out (B, S, H, N) f32,
    s_final (B, H, N, N) f32).

    Per chunk, in log space: the from-state term ``(r * exp(cum_excl)) @ s``,
    the intra-chunk term ``A @ v`` with ``A[t, s] = sum_i r[t, i] k[s, i]
    exp(cum_excl[t, i] - cum[s, i])`` for s < t (every exponent <= 0), the
    diagonal bonus ``(r . u*k) v``, and the state decayed to the chunk's
    end: ``exp(cum[-1]) * s + (k * exp(cum[-1] - cum))^T v``."""
    b, s_len, h, n = r.shape
    s = s0.float()
    tri = (torch.arange(chunk, device=r.device)[:, None]
           > torch.arange(chunk, device=r.device)[None, :])
    uf = u.float()
    outs = []
    with full_f32():
        for c0 in range(0, s_len, chunk):
            rc, kc, vc, lwc = (t[:, c0:c0 + chunk].float()
                               for t in (r, k, v, lw))  # (B, c, H, N)
            cum = torch.cumsum(lwc, dim=1)  # inclusive
            cum_excl = cum - lwc
            o_state = torch.einsum("bthi,bhij->bthj", rc * torch.exp(cum_excl),
                                   s)
            diff = cum_excl[:, :, None] - cum[:, None, :]  # (B, t, s, H, N)
            dec = torch.exp(torch.where(tri[None, :, :, None, None], diff,
                                        NEG_INF))
            a = (rc[:, :, None] * kc[:, None] * dec).sum(-1)  # (B, t, s, H)
            o_intra = torch.einsum("btsh,bshj->bthj", a, vc)
            bonus = (rc * (uf * kc)).sum(-1)  # (B, t, H)
            o_diag = bonus[..., None] * vc
            dec_end = torch.exp(cum[:, -1:] - cum)
            s = torch.exp(cum[:, -1])[..., None] * s + torch.einsum(
                "bthi,bthj->bhij", kc * dec_end, vc)
            outs.append(o_state + o_intra + o_diag)
    return torch.cat(outs, dim=1), s


def wkv_ref_sequential(r, k, v, lw, u, s0):
    """Token-by-token WKV recurrence, the ground-truth oracle
    (``src/repro/kernels/ref.py::wkv_ref_sequential``):
    ``o_t = r_t (S + u*k_t v_t^T)``, ``S <- exp(lw_t) S + k_t v_t^T``."""
    s = s0.float()
    uf = u.float()[None, :, :, None]
    outs = []
    with full_f32():
        for t in range(r.shape[1]):
            rt, kt, vt, lwt = (a[:, t].float() for a in (r, k, v, lw))
            kv = kt[..., :, None] * vt[..., None, :]  # (B, H, N, N)
            outs.append(torch.einsum("bhi,bhij->bhj", rt, s + uf * kv))
            s = torch.exp(lwt)[..., None] * s + kv
    return torch.stack(outs, dim=1), s
