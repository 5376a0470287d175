"""mac: the int8 x int8 -> int32 GEMM with the per-column dequant scale.

Replaces the TPU kernel ``src/repro/kernels/mac_matmul.py::_kernel`` (its
``pl.pallas_call`` at ``mac_matmul.py:58``); the CUDA kernel is
``csrc/mac_matmul.cu``, whose header says what bounds it on the H100 and how
its design answers that: the GEMM is the 1x1 conv of a 1 x M image of K
channels, so it runs the conv's int8 tensor-core kernel
(``csrc/fused_conv.cu``), in the tile and split of K that :func:`mac_plan`
picks, split K summed in the same launch.  The int32 sums are exact, so
kernel and plain version agree bit for bit.

:func:`mac_matmul_int8` is the wrapper: CPU tensors run
:func:`~repro_torch.kernels.ref.mac_matmul_int8_ref`, CUDA tensors launch
the kernel (``mac_matmul_int8.launches`` counts the launches).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, runs_plain, split_k
from repro_torch.kernels.fused_conv import (
    aligned, imma_plan, split_operands,
)
from repro_torch.kernels.ref import mac_matmul_int8_ref

K_MAX = (2**31 - 1) // 127**2  # the longest exact int32 sum
_INT32_MAX = 2**31 - 1
# (M, K, N) -> (tile, slices) where tools/sweep_cnn_kernels.py --only mac
# timed a plan more than 3% faster than the rule's on the H100 (or the
# rule's plan untimed) (PERF.md)
MAC_TUNED = {(1, 256, 128): (3, 1), (8, 2048, 7168): (4, 8),
             (8, 7168, 2048): (2, 16)}


def mac_plan(m: int, n: int, k: int, sms: int) -> tuple[int, int]:
    """(tile, slices of K) of an (M, K) @ (K, N) launch:
    :func:`~repro_torch.kernels.fused_conv.imma_plan` with
    :data:`MAC_TUNED` (x's rows are K bytes: a K not a multiple of 4 takes
    a tile of ``BYTE_TILES``).  Cached per shape and split policy."""
    return _mac_plan(m, n, k, sms, split_k)


@functools.lru_cache(maxsize=4096)
def _mac_plan(m, n, k, sms, split_k):
    return imma_plan(m, n, k, sms, split_k, MAC_TUNED)


def _launch(x_int8, w_int8, scale):
    m, k = x_int8.shape
    n = w_int8.shape[1]
    if k > K_MAX:
        raise ValueError(f"K = {k} overflows the kernel's int32 sums")
    if max(m * k, k * n, m * n) > _INT32_MAX:
        raise ValueError("operands exceed the kernel's 32-bit indexing")
    x_int8, w_int8 = aligned(x_int8), aligned(w_int8)
    sc = scale.float().reshape(-1).contiguous()
    check_operand(x_int8, "x_int8", torch.int8, (m, k))
    check_operand(w_int8, "w_int8", torch.int8, (k, n))
    check_operand(sc, "scale", torch.float32, (n,))
    out = torch.empty((m, n), dtype=torch.float32, device=x_int8.device)
    tile, splits = mac_plan(m, n, k, build.sm_count(x_int8.device))
    per, ws, counters = split_operands(x_int8.device, m, n, k, tile, splits)
    with torch.cuda.device(x_int8.device):
        status = build.lib().marvel_mac_matmul_int8(
            x_int8.data_ptr(), w_int8.data_ptr(), sc.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), m, k, n,
            tile, splits, per, build.stream_ptr(x_int8.device))
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
