"""Plain PyTorch baselines for the CNN kernels: the oracles the dispatch
wrappers fall back to when a site is outside a kernel's guards, and the v0
arithmetic of the model sites.

Every f32 product and convolution here runs under :func:`full_f32`: on a
CUDA tensor, cuDNN would otherwise run a float32 convolution in TF32 (its
default), a 10-bit mantissa where the reference computes in f32."""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import conv_out_size, same_pads
from repro_torch.models.layers import ACTS


# the two TF32 switches and their full-f32 value (PyTorch >= 2.9)
_TF32_SWITCHES = ((torch.backends.cudnn.conv, "fp32_precision", "ieee"),
                  (torch.backends.cuda.matmul, "fp32_precision", "ieee"))


_f32_lock = threading.RLock()  # the switches are process-global


@contextlib.contextmanager
def full_f32():
    """Run float32 convolutions (cuDNN) and matrix products (cuBLAS) in full
    f32 whatever the caller's global TF32 settings, and put those settings
    back on exit.  CPU arithmetic is unaffected."""
    with _f32_lock:
        saved = [getattr(ns, attr) for ns, attr, _ in _TF32_SWITCHES]
        try:
            for ns, attr, value in _TF32_SWITCHES:
                setattr(ns, attr, value)
            yield
        finally:
            for (ns, attr, _), value in zip(_TF32_SWITCHES, saved):
                setattr(ns, attr, value)


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
