"""mac: the int8 x int8 -> int32 GEMM with the per-column dequant scale.

Replaces the TPU kernel ``src/repro/kernels/mac_matmul.py::_kernel`` (its
``pl.pallas_call`` at ``mac_matmul.py:58``); the CUDA kernel is
``csrc/mac_matmul.cu``, whose header says what bounds it on the H100 and how
its design answers that: a skinny form for M <= 8 rows (the decode shapes)
and a tiled form above, both splitting K when the output alone leaves the
card idle.  The int32 sums are exact, so kernel and plain version agree bit
for bit.

:func:`mac_matmul_int8` is the wrapper: CPU tensors run
:func:`~repro_torch.kernels.ref.mac_matmul_int8_ref`, CUDA tensors launch
the kernel (``mac_matmul_int8.launches`` counts the launches).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, runs_plain, split_k
from repro_torch.kernels.ref import mac_matmul_int8_ref

SKINNY_ROWS = 8  # M at or below this takes the skinny form
SKINNY_COLS = 128  # its output columns per block
BM, BN, BK = 64, 64, 32  # the tiled form's tile (csrc/mac_matmul.cu)
K_MAX = (2**31 - 1) // 127**2  # the longest exact int32 sum
_INT32_MAX = 2**31 - 1


def splits_for(m: int, k: int, n: int, sms: int) -> tuple[int, int]:
    """(slices of K, rows of K per slice, a multiple of BK) of one launch."""
    if m <= SKINNY_ROWS:
        tiles = -(-n // SKINNY_COLS)
    else:
        tiles = -(-m // BM) * -(-n // BN)
    k_iters = max(1, -(-k // BK))
    splits = split_k(tiles, k_iters, sms)
    return splits, -(-k_iters // splits) * BK


def _launch(x_int8, w_int8, scale):
    m, k = x_int8.shape
    n = w_int8.shape[1]
    if k > K_MAX:
        raise ValueError(f"K = {k} overflows the kernel's int32 sums")
    if max(m * k, k * n, m * n) > _INT32_MAX:
        raise ValueError("operands exceed the kernel's 32-bit indexing")
    x_int8, w_int8 = x_int8.contiguous(), w_int8.contiguous()
    sc = scale.float().reshape(-1).contiguous()
    check_operand(x_int8, "x_int8", torch.int8, (m, k))
    check_operand(w_int8, "w_int8", torch.int8, (k, n))
    check_operand(sc, "scale", torch.float32, (n,))
    out = torch.empty((m, n), dtype=torch.float32, device=x_int8.device)
    splits, per = splits_for(m, k, n, build.sm_count(x_int8.device))
    ws = (torch.empty((m, n), dtype=torch.int32, device=x_int8.device)
          if splits > 1 else None)
    with torch.cuda.device(x_int8.device):
        status = build.lib().marvel_mac_matmul_int8(
            x_int8.data_ptr(), w_int8.data_ptr(), sc.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(), m, k, n,
            splits, per, build.stream_ptr(x_int8.device))
    build.check("mac_matmul_int8", status)
    return out


def mac_matmul_int8(x_int8, w_int8, scale):
    """x: (M, K) int8, w: (K, N) int8, scale: (N,) or (1, N) f32 -> (M, N)
    f32: ``f32(x @ w) * scale``, the product summed exactly in int32."""
    if (x_int8.dim() != 2 or w_int8.dim() != 2
            or x_int8.shape[1] != w_int8.shape[0]):
        raise ValueError(f"x {tuple(x_int8.shape)} and w "
                         f"{tuple(w_int8.shape)} do not multiply")
    if x_int8.dtype != torch.int8 or w_int8.dtype != torch.int8:
        raise TypeError(f"mac_matmul_int8 takes int8 operands, got "
                        f"{x_int8.dtype} and {w_int8.dtype}")
    if runs_plain(x_int8, w_int8, scale):
        return mac_matmul_int8_ref(x_int8, w_int8, scale)
    out = _launch(x_int8, w_int8, scale)
    mac_matmul_int8.launches += 1
    return out


mac_matmul_int8.launches = 0
