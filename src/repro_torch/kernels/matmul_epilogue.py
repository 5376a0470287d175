"""fusedmac: GEMM + bias + folded-BN affine (+ residual) + act in one kernel.

Replaces the TPU kernel ``src/repro/kernels/matmul_epilogue.py::_kernel``
(its ``pl.pallas_call`` at ``matmul_epilogue.py:105``); the CUDA kernel is
``csrc/matmul_epilogue.cu``, whose header says what bounds it on the H100
and how its tiling answers that.  The whole epilogue folds into one
per-column pair ``act(acc*es + eb [+ residual])`` with ``es = scale`` and
``eb = b*es + shift``, so the GEMM output is written to device memory once.
Operands are f32 (the CNNs) or bf16 (the LMs): the kernel reads bf16 in
place and sums in f32, so a bf16 weight is never copied to f32.

:func:`matmul_epilogue` is the wrapper: CPU tensors run
:func:`matmul_epilogue_plain`'s arithmetic, CUDA tensors launch the kernel
(``matmul_epilogue.launches`` counts the launches).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (
    ACT_CODES, check_operand, runs_plain, split_k,
)
from repro_torch.kernels.ref import full_f32
from repro_torch.models.layers import ACTS

_INT32_MAX = 2**31 - 1
BM, BN, BK = 64, 64, 16  # the kernel's tile (csrc/matmul_epilogue.cu)


def _prepare(x, w, b, scale, shift, residual):
    n_out = w.shape[1]
    x2 = x.reshape(-1, x.shape[-1])
    f32 = dict(dtype=torch.float32, device=x.device)
    es = torch.ones(n_out, **f32) if scale is None else scale.float()
    eb = torch.zeros(n_out, **f32) if b is None else b.float() * es
    if shift is not None:
        eb = eb + shift.float()
    r2 = None if residual is None else residual.reshape(-1, n_out)
    return x2, es, eb, r2


def _plain(x2, w, es, eb, r2, act):
    with full_f32():
        y = (x2.float() @ w.float()) * es + eb
    if r2 is not None:
        y = y + r2.float()
    return ACTS[act](y)


_OPERAND_TYPES = (torch.float32, torch.bfloat16)


def _launch(x2, w, es, eb, r2, act):
    """The kernel on (M, K) @ (K, N) operands: read as they are when both are
    f32 or both bf16, else taken to f32 first; the residual likewise; the
    output is f32."""
    m, k = x2.shape
    n = w.shape[1]
    if max(m * n, m * k, k * n) > _INT32_MAX:
        raise ValueError(f"GEMM ({m}x{k}) @ ({k}x{n}) exceeds the kernel's "
                         f"32-bit indexing")
    if x2.dtype != w.dtype or x2.dtype not in _OPERAND_TYPES:
        x2, w = x2.float(), w.float()
    if r2 is not None and r2.dtype not in _OPERAND_TYPES:
        r2 = r2.float()
    dt = x2.dtype
    x2, w, es, eb = (x2.contiguous(), w.contiguous(), es.contiguous(),
                     eb.contiguous())
    r2 = None if r2 is None else r2.contiguous()
    check_operand(x2, "x", dt, (m, k))
    check_operand(w, "w", dt, (k, n))
    check_operand(es, "es", torch.float32, (n,))
    check_operand(eb, "eb", torch.float32, (n,))
    if r2 is not None:
        check_operand(r2, "residual", r2.dtype, (m, n))
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    k_iters = -(-k // BK)
    splits = split_k(-(-m // BM) * -(-n // BN), k_iters,
                     build.sm_count(x2.device))
    per = -(-k_iters // splits) * BK
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=x2.device)
          if splits > 1 else None)
    with torch.cuda.device(x2.device):
        status = build.lib().marvel_matmul_epilogue(
            x2.data_ptr(), w.data_ptr(), es.data_ptr(), eb.data_ptr(),
            None if r2 is None else r2.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), m, n, k, splits, per,
            ACT_CODES[act], int(dt == torch.bfloat16),
            int(r2 is not None and r2.dtype == torch.bfloat16),
            build.stream_ptr(x2.device))
    build.check("matmul_epilogue", status)
    return out


def matmul_epilogue_plain(x, w, b=None, act="none", scale=None, shift=None,
                          residual=None):
    """The plain PyTorch version of the kernel's function (f32 product, the
    same folded epilogue), on whatever device x lies."""
    x2, es, eb, r2 = _prepare(x, w, b, scale, shift, residual)
    y = _plain(x2, w, es, eb, r2, act)
    return y.to(x.dtype).reshape(*x.shape[:-1], w.shape[1])


def matmul_epilogue(x, w, b=None, act="none", scale=None, shift=None,
                    residual=None):
    """x: (..., K); w: (K, N); b/scale/shift: (N,) or None; residual:
    optional (..., N) skip tensor -> ``act((x@w + b)*scale + shift [+
    residual])`` in x.dtype, accumulated in f32.  An empty GEMM takes the
    exact plain path on any device."""
    x2, es, eb, r2 = _prepare(x, w, b, scale, shift, residual)
    if 0 in x2.shape or 0 in w.shape or runs_plain(x2, w, r2):
        y = _plain(x2, w, es, eb, r2, act)
    else:
        y = _launch(x2, w, es, eb, r2, act)
        matmul_epilogue.launches += 1
    return y.to(x.dtype).reshape(*x.shape[:-1], w.shape[1])


matmul_epilogue.launches = 0
