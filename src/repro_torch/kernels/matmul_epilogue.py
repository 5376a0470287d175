"""fusedmac: GEMM + bias + folded-BN affine (+ residual) + act in one kernel.

Replaces the TPU kernel ``src/repro/kernels/matmul_epilogue.py::_kernel``
(its ``pl.pallas_call`` at ``matmul_epilogue.py:105``); the CUDA kernel is
``csrc/matmul_epilogue.cu``, whose header says what bounds it on the H100
and how its tiling answers that.  The whole epilogue folds into one
per-column pair ``act(acc*es + eb [+ residual])`` with ``es = scale`` and
``eb = b*es + shift``, so the GEMM output is written to device memory once.

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


def _launch(x2, w, es, eb, r2, act):
    m, k = x2.shape
    n = w.shape[1]
    if max(m * n, m * k, k * n) > _INT32_MAX:
        raise ValueError(f"GEMM ({m}x{k}) @ ({k}x{n}) exceeds the kernel's "
                         f"32-bit indexing")
    xf = x2.float().contiguous()
    wf = w.float().contiguous()
    es, eb = es.contiguous(), eb.contiguous()
    rf = None if r2 is None else r2.float().contiguous()
    check_operand(xf, "x", torch.float32, (m, k))
    check_operand(wf, "w", torch.float32, (k, n))
    check_operand(es, "es", torch.float32, (n,))
    check_operand(eb, "eb", torch.float32, (n,))
    if rf is not None:
        check_operand(rf, "residual", torch.float32, (m, n))
    out = torch.empty((m, n), dtype=torch.float32, device=xf.device)
    k_iters = -(-k // BK)
    splits = split_k(-(-m // BM) * -(-n // BN), k_iters,
                     build.sm_count(xf.device))
    per = -(-k_iters // splits) * BK
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=xf.device)
          if splits > 1 else None)
    with torch.cuda.device(xf.device):
        status = build.lib().marvel_matmul_epilogue(
            xf.data_ptr(), wf.data_ptr(), es.data_ptr(), eb.data_ptr(),
            None if rf is None else rf.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), m, n, k, splits, per,
            ACT_CODES[act], build.stream_ptr(xf.device))
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
