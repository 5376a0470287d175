"""pool kernels: windowed int8/f32 max/avg pooling + the global-avg reduce.

Replace the TPU kernels ``src/repro/kernels/pooling.py::_pool_kernel``
(``pl.pallas_call`` at ``pooling.py:123``, reached through ``maxpool2d`` /
``avgpool2d``) and ``pooling.py::_gap_kernel`` (``pooling.py:160``); the
CUDA kernels are in ``csrc/pooling.cu``, whose header says what bounds them
on the H100 (bytes: both are memory-bound reductions) and how they are laid
out for it.

Both accumulate in f32, which is exact for int8 inputs, so one kernel body
serves int8 and f32 models.  Max pooling keeps the input dtype and
propagates NaN (``torch.maximum``); average pooling of an integer input
returns f32.  The windowed kernel walks the taps in row-major order and
multiplies the sum by ``1/(k*k)``; the plain versions below repeat that
arithmetic.

:func:`pool_plan` picks each launch's form and geometry: the vector forms
(a thread per 16-byte channel group) where C and the input's address allow,
else the scalar forms; the global-average pool sums large H*W over thread
rows ("rows").  :func:`windowed_pool` and :func:`global_avgpool` are the
wrappers: CPU tensors run the plain versions, CUDA tensors launch the
kernels in the planned form (each wrapper's ``launches`` counts them, and
``launches_by_form`` per form).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, conv_out_size, runs_plain
from repro_torch.kernels.ref import avg_out_dtype, pool_taps

# window sizes the fast path covers (the paper CNNs: 2x2 stride-2 VGG /
# DenseNet pools, 3x3 stride-2 ResNet / DenseNet stem pools)
SUPPORTED_WINDOWS = (2, 3)
SUPPORTED_STRIDES = (2,)
KERNEL_DTYPES = (torch.float32, torch.int8)

FORMS = ("vector", "scalar")  # windowed_pool
GAP_FORMS = ("vector", "rows", "scalar")  # global_avgpool
FORM_CODES = {"scalar": 0, "vector": 1, "rows": 2}  # csrc/pooling.cu::Form
# the global-average pool's vector form (a thread sums all H*W pixels of
# its channel group) up to this many pixels, the rows form above: at N = 8,
# C = 1024 on the H100 the vector form wins at H*W = 1 and 4, the rows form
# from 9 on (tools/bisect_pool_kernel.py's form sweep; PERF.md)
GAP_VECTOR_MAX_HW = 4
GAP_C, GAP_R = 32, 8  # the rows form's block: channel groups x pixel rows
MAX_GRID_YZ = 65535  # CUDA's limit on a grid's y and z extents
H100_SMS = 132


class PoolPlan(NamedTuple):
    form: str  # FORMS / GAP_FORMS
    block: tuple[int, int]  # threads (x, y)
    grid: tuple[int, int, int]  # blocks (x, y, z)


def group_width(dtype) -> int:
    """Channels in one 16-byte group: 4 f32 or 16 int8."""
    return 16 // (4 if dtype == torch.float32 else 1)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def _threads(total: int, sms: int) -> int:
    """Threads a block: 256, halved (down to one warp) while the launch
    would have fewer blocks than SMs, so that small launches still spread
    over the card."""
    t = 256
    while t > 32 and _cdiv(total, t) < sms:
        t //= 2
    return t


def pool_plan(shape, dtype, op, k=2, stride=2, ptr_aligned=True,
              sms=H100_SMS) -> PoolPlan:
    """Form and launch geometry of one pool launch on an NHWC input of
    ``shape`` (a pure function: the wrappers launch what it says).

    Windowed (``op`` max / avg): the vector form, block (channel groups,
    output columns) and grid (groups, columns, rows n*Ho + oh), where C is
    a multiple of the 16-byte group, the input 16-byte aligned and the rows
    fit the grid; else the scalar form, one thread per output element.
    ``global_avg``: the vector form (a thread per (n, group)) up to
    ``GAP_VECTOR_MAX_HW`` pixels, the rows form (block GAP_C groups x GAP_R
    pixel rows) above, the scalar form (rows, one channel a thread) where C
    or the address does not allow 16-byte groups."""
    n, h, w, c = shape
    v = group_width(dtype)
    vec = ptr_aligned and c % v == 0
    if op == "global_avg":
        if n > MAX_GRID_YZ:
            raise ValueError(f"global_avgpool takes at most {MAX_GRID_YZ} "
                             f"images, got {n}")
        if not vec:
            return PoolPlan("scalar", (GAP_C, GAP_R), (_cdiv(c, GAP_C), n, 1))
        g = c // v
        if h * w > GAP_VECTOR_MAX_HW:
            return PoolPlan("rows", (GAP_C, GAP_R), (_cdiv(g, GAP_C), n, 1))
        t = min(_threads(n * g, sms), max(32, _pow2_ceil(g)))
        return PoolPlan("vector", (t, 1), (_cdiv(g, t), n, 1))
    ho = conv_out_size(h, k, stride, "VALID")
    wo = conv_out_size(w, k, stride, "VALID")
    rows = n * ho
    if vec and rows <= MAX_GRID_YZ:
        g = c // v
        t = _threads(rows * wo * g, sms)
        bx = min(_pow2_ceil(g), t)
        by = min(t // bx, _pow2_ceil(wo))
        if _cdiv(wo, by) <= MAX_GRID_YZ:
            return PoolPlan("vector", (bx, by),
                            (_cdiv(g, bx), _cdiv(wo, by), rows))
    total = rows * wo * c
    t = _threads(total, sms)
    return PoolPlan("scalar", (t, 1), (_cdiv(total, t), 1, 1))


def fast_path_supported(x, *, op, k=2, stride=2) -> bool:
    """Would ops._cuda_pool run a pool kernel on this site (vs the plain
    reference)?  ONE predicate shared by the dispatch wrapper and the
    profiler's pool-credit mirror.  It keeps the reference's window, stride
    and shape rules and drops its VMEM slab cap (``pooling.py:44-62``):
    that cap is about the TPU's on-chip memory, and these kernels stream
    from device memory with no per-image slab."""
    if len(getattr(x, "shape", ())) != 4 or 0 in x.shape:
        return False
    if op == "global_avg":
        return True
    return (
        op in ("max", "avg")
        and k in SUPPORTED_WINDOWS and stride in SUPPORTED_STRIDES
        and conv_out_size(x.shape[1], k, stride, "VALID") > 0
        and conv_out_size(x.shape[2], k, stride, "VALID") > 0
    )


def windowed_pool_plain(x, *, k=2, stride=2, op="max"):
    """Plain version of the windowed kernel (same tap order and rescale)."""
    taps = pool_taps(x.float(), k, stride)
    acc = next(taps)
    for t in taps:
        acc = torch.maximum(acc, t) if op == "max" else acc + t
    if op == "max":
        return acc.to(x.dtype)
    return (acc * (1.0 / (k * k))).to(avg_out_dtype(x.dtype))


def global_avgpool_plain(x):
    """Plain version of the GAP kernel: f32 sum over H*W times 1/(H*W)."""
    hw = x.shape[1] * x.shape[2]
    return (x.float().sum(dim=(1, 2)) * (1.0 / hw)).to(avg_out_dtype(x.dtype))


def _check_input(x):
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"pool kernels take {KERNEL_DTYPES}, got {x.dtype}")
    x = x.contiguous()
    check_operand(x, "x", x.dtype, tuple(x.shape))
    if x.numel() > 2**31 - 1:
        raise ValueError("pool input exceeds the kernel's 32-bit indexing")
    return x


def _plan(x, op, k=2, stride=2) -> PoolPlan:
    return pool_plan(tuple(x.shape), x.dtype, op, k, stride,
                     ptr_aligned=x.data_ptr() % 16 == 0,
                     sms=build.sm_count(x.device))


def _launch_windowed(x, k, stride, op):
    """Launch the windowed kernel in its planned form: (output, form)."""
    x = _check_input(x)
    n, h, w_in, c = x.shape
    ho = conv_out_size(h, k, stride, "VALID")
    wo = conv_out_size(w_in, k, stride, "VALID")
    if ho <= 0 or wo <= 0:
        raise ValueError(f"degenerate pool output {ho}x{wo}")
    plan = _plan(x, op, k, stride)
    out_dtype = x.dtype if op == "max" else avg_out_dtype(x.dtype)
    out = torch.empty((n, ho, wo, c), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = build.lib().marvel_windowed_pool(
            x.data_ptr(), out.data_ptr(), int(x.dtype == torch.int8),
            n, h, w_in, c, ho, wo, k, stride, int(op == "avg"),
            FORM_CODES[plan.form], *plan.block, *plan.grid,
            build.stream_ptr(x.device))
    build.check("windowed_pool", status)
    return out, plan.form


def _launch_gap(x):
    """Launch the global-average kernel in its planned form: (output,
    form)."""
    x = _check_input(x)
    n, h, w_in, c = x.shape
    plan = _plan(x, "global_avg")
    out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = build.lib().marvel_global_avgpool(
            x.data_ptr(), out.data_ptr(), int(x.dtype == torch.int8),
            h * w_in, c, FORM_CODES[plan.form], *plan.block, *plan.grid[:2],
            build.stream_ptr(x.device))
    build.check("global_avgpool", status)
    return out, plan.form


def windowed_pool(x, *, k=2, stride=2, op="max"):
    """x: (N, H, W, C) int8/f32 -> (N, Ho, Wo, C) VALID max or avg pool
    (window 2 or 3, stride 2)."""
    if op not in ("max", "avg") or k not in SUPPORTED_WINDOWS \
            or stride not in SUPPORTED_STRIDES:
        raise ValueError(f"no pool kernel for op={op!r} k={k} stride={stride}")
    if runs_plain(x):
        return windowed_pool_plain(x, k=k, stride=stride, op=op)
    out, form = _launch_windowed(x, k, stride, op)
    windowed_pool.launches += 1
    windowed_pool.launches_by_form[form] += 1
    return out


def global_avgpool(x):
    """x: (N, H, W, C) -> (N, C) mean over the spatial extent (f32
    accumulate; integer inputs return f32)."""
    if runs_plain(x):
        return global_avgpool_plain(x)
    out, form = _launch_gap(x)
    global_avgpool.launches += 1
    global_avgpool.launches_by_form[form] += 1
    return out


windowed_pool.launches = 0
windowed_pool.launches_by_form = dict.fromkeys(FORMS, 0)
global_avgpool.launches = 0
global_avgpool.launches_by_form = dict.fromkeys(GAP_FORMS, 0)
