"""add2i: the residual add and the RMSNorm of its result in one kernel.

Replaces the TPU kernel ``src/repro/kernels/residual_rmsnorm.py::_kernel``
(its ``pl.pallas_call`` at ``residual_rmsnorm.py:43``); the CUDA kernel is
``csrc/residual_rmsnorm.cu``, whose header says what bounds it on the H100
and how its design answers that.  Both outputs come from one read of the
two inputs: ``r = res + x`` in f32, returned in ``res.dtype``, and
``r * rsqrt(mean(r**2) + eps) * scale`` normalised from the unrounded f32
``r``.  The scale is read in its own type (f32 or bf16) and widened in the
kernel, so one call is one device kernel.

:func:`norm_plan` picks each launch's form and geometry: the ``rows`` form
(a group of threads a row, the row held in registers, narrow rows packed
several to a block) where the width and the addresses allow it, else the
two-pass ``scalar`` form.  :func:`residual_rmsnorm` is the wrapper: CPU
tensors run :func:`~repro_torch.kernels.ref.residual_rmsnorm_plain`, CUDA
tensors launch the kernel in the planned form (``residual_rmsnorm.launches``
counts the launches, ``residual_rmsnorm.launches_by_form`` them per form).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, runs_plain
from repro_torch.kernels.ref import residual_rmsnorm_plain

_TYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2**31 - 1

FORMS = ("rows", "scalar")
FORM_CODES = {"scalar": 0, "rows": 1}  # csrc/residual_rmsnorm.cu::Form
VECTOR_BYTES = 16
ROWS_MAX_D = 8192  # the widest row the rows form holds in registers
ROWS_MAX_THREADS = 256  # a rows-form block (csrc: ROWS_MAX_THREADS)
ROWS_MIN_GROUP = 8  # threads a row, at least
VECS_MAX = 8  # 16-byte vectors a thread holds (csrc: ROWS_MAX_NV)
VECS_TARGET = 4  # vectors a thread aims at: 8 loads in flight at once
ROWS_BLOCK = 64  # threads a block aims at, narrow rows packed to fill it
SCALAR_THREADS = 256  # the scalar form's block, one a row
H100_SMS = 132


class NormPlan(NamedTuple):
    form: str  # FORMS
    threads: int  # threads a row
    rows_per_block: int
    vecs: int  # 16-byte vectors a thread holds (rows form)
    grid: int  # blocks
    cluster: int  # blocks a cluster (1: no cluster)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def _pow2_floor(v: int) -> int:
    return 1 << (max(1, v).bit_length() - 1)


def norm_plan(rows, d, dtype, scale_dtype, aligned=True,
              sms=H100_SMS) -> NormPlan:
    """Form and launch geometry of one launch on ``rows`` rows of ``d``
    elements of ``dtype`` with a (d,) scale of ``scale_dtype`` (a pure
    function: the wrapper launches what it says).  ``aligned``: every
    pointer (res, x, scale, the outputs) on a 16-byte boundary.

    The rows form where d is a multiple of the 16-byte vector, at most
    ``ROWS_MAX_D`` and the pointers aligned.  Threads a row t: a power of
    two (8 to 256) that gives each thread about ``VECS_TARGET`` vectors;
    with no more rows than SMs (a decode step) at least a warp, else
    halved while the last round would leave over an eighth of the group
    idle and a thread would hold at most ``VECS_MAX``.  Rows a block as
    many as fill ``ROWS_BLOCK`` threads while the grid keeps two blocks an
    SM.  Else the scalar form, one block a row.  (The rule and its
    constants: ``tools/time_rmsnorm_kernels.py --sweep`` on the H100.)"""
    if dtype not in _TYPES or scale_dtype not in _TYPES:
        raise TypeError(f"residual_rmsnorm takes float32 or bfloat16 rows "
                        f"and scale, got {dtype} and {scale_dtype}")
    per_vec = VECTOR_BYTES // (4 if dtype == torch.float32 else 2)
    if not aligned or d % per_vec or d > ROWS_MAX_D:
        return NormPlan("scalar", SCALAR_THREADS, 1, 0, rows, 1)
    nv = d // per_vec
    t = max(_pow2_ceil(_cdiv(nv, VECS_TARGET)), ROWS_MIN_GROUP)
    if rows <= sms:
        t = max(t, 32)
    else:
        while (t // 2 >= ROWS_MIN_GROUP and _cdiv(nv, t // 2) <= VECS_MAX
               and 8 * (t * _cdiv(nv, t) - nv) > t * _cdiv(nv, t)):
            t //= 2
    t = min(t, ROWS_MAX_THREADS)
    rpb = max(1, min(ROWS_BLOCK // t, _pow2_floor(rows // (2 * sms))))
    return NormPlan("rows", t, rpb, _cdiv(nv, t), _cdiv(rows, rpb), 1)


def _launch(res2, x2, scale, eps):
    """The kernel on (R, D) rows of one type (f32 or bf16) and a (D,)
    scale of f32 or bf16, in the form :func:`norm_plan` gives; returns
    (newres, normed) in the rows' type and the form."""
    r, d = res2.shape
    dt = res2.dtype
    if r * d > _INT32_MAX:
        raise ValueError(f"{r} rows of {d} exceed the kernel's 32-bit "
                         f"indexing")
    res2, x2 = res2.contiguous(), x2.contiguous()
    check_operand(res2, "res", dt, (r, d))
    check_operand(x2, "x", dt, (r, d))
    check_operand(scale, "scale", scale.dtype, (d,))
    # the outputs are fresh allocations, 16-byte aligned
    aligned = all(t.data_ptr() % VECTOR_BYTES == 0 for t in (res2, x2, scale))
    plan = norm_plan(r, d, dt, scale.dtype, aligned,
                     build.sm_count(res2.device))
    newres = torch.empty_like(res2)
    normed = torch.empty_like(res2)
    with torch.cuda.device(res2.device):
        status = build.lib().marvel_residual_rmsnorm(
            res2.data_ptr(), x2.data_ptr(), scale.data_ptr(),
            newres.data_ptr(), normed.data_ptr(), r, d, float(eps),
            int(dt == torch.bfloat16), int(scale.dtype == torch.bfloat16),
            FORM_CODES[plan.form], plan.threads, plan.rows_per_block,
            plan.vecs, plan.grid, plan.cluster,
            build.stream_ptr(res2.device))
    build.check("residual_rmsnorm", status)
    return newres, normed, plan.form


def residual_rmsnorm(res, x, scale, eps=1e-6):
    """res, x: (..., D) of one type; scale: (D,) -> ``(res + x,
    rmsnorm(res + x) * scale)``, both in res.dtype."""
    if x.shape != res.shape or x.dtype != res.dtype:
        raise ValueError(f"res {tuple(res.shape)} {res.dtype} and x "
                         f"{tuple(x.shape)} {x.dtype} must match")
    if runs_plain(res, x, scale):
        return residual_rmsnorm_plain(res, x, scale, eps)
    d = res.shape[-1]
    newres, normed, form = _launch(res.reshape(-1, d), x.reshape(-1, d),
                                   scale, eps)
    residual_rmsnorm.launches += 1
    residual_rmsnorm.launches_by_form[form] += 1
    return newres.reshape(res.shape), normed.reshape(res.shape)


residual_rmsnorm.launches = 0
residual_rmsnorm.launches_by_form = dict.fromkeys(FORMS, 0)
