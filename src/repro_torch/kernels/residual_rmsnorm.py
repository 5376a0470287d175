"""add2i: the residual add and the RMSNorm of its result in one kernel.

Replaces the TPU kernel ``src/repro/kernels/residual_rmsnorm.py::_kernel``
(its ``pl.pallas_call`` at ``residual_rmsnorm.py:43``); the CUDA kernel is
``csrc/residual_rmsnorm.cu``, whose header says what bounds it on the H100
and how its design answers that.  Both outputs come from one read of the
two inputs: ``r = res + x`` in f32, returned in ``res.dtype``, and
``r * rsqrt(mean(r**2) + eps) * scale`` normalised from the unrounded f32
``r``.

:func:`residual_rmsnorm` is the wrapper: CPU tensors run
:func:`~repro_torch.kernels.ref.residual_rmsnorm_plain`, CUDA tensors launch
the kernel (``residual_rmsnorm.launches`` counts the launches).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, runs_plain
from repro_torch.kernels.ref import residual_rmsnorm_plain

_TYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2**31 - 1


def _launch(res2, x2, scale, eps):
    """The kernel on (R, D) rows of one type (f32 or bf16) and a (D,)
    scale; returns (newres, normed) in that type."""
    r, d = res2.shape
    dt = res2.dtype
    if dt not in _TYPES:
        raise TypeError(f"residual_rmsnorm takes float32 or bfloat16 rows, "
                        f"got {dt}")
    if r * d > _INT32_MAX:
        raise ValueError(f"{r} rows of {d} exceed the kernel's 32-bit "
                         f"indexing")
    res2, x2 = res2.contiguous(), x2.contiguous()
    sc = scale.float().contiguous()
    check_operand(res2, "res", dt, (r, d))
    check_operand(x2, "x", dt, (r, d))
    check_operand(sc, "scale", torch.float32, (d,))
    newres = torch.empty_like(res2)
    normed = torch.empty_like(res2)
    with torch.cuda.device(res2.device):
        status = build.lib().marvel_residual_rmsnorm(
            res2.data_ptr(), x2.data_ptr(), sc.data_ptr(), newres.data_ptr(),
            normed.data_ptr(), r, d, float(eps), int(dt == torch.bfloat16),
            build.stream_ptr(res2.device))
    build.check("residual_rmsnorm", status)
    return newres, normed


def residual_rmsnorm(res, x, scale, eps=1e-6):
    """res, x: (..., D) of one type; scale: (D,) -> ``(res + x,
    rmsnorm(res + x) * scale)``, both in res.dtype."""
    if x.shape != res.shape or x.dtype != res.dtype:
        raise ValueError(f"res {tuple(res.shape)} {res.dtype} and x "
                         f"{tuple(x.shape)} {x.dtype} must match")
    if runs_plain(res, x, scale):
        return residual_rmsnorm_plain(res, x, scale, eps)
    d = res.shape[-1]
    newres, normed = _launch(res.reshape(-1, d), x.reshape(-1, d), scale, eps)
    residual_rmsnorm.launches += 1
    return newres.reshape(res.shape), normed.reshape(res.shape)


residual_rmsnorm.launches = 0
