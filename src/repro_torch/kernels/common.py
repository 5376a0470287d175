"""Shared kernel plumbing: conv geometry, epilogue acts, eligibility
predicates, the device rule every kernel wrapper follows, and
:func:`full_f32`, the precision guard of every plain product.

The device rule: a wrapper given CPU tensors runs its kernel's plain
PyTorch version (the analogue of the reference's Pallas interpret mode); a
wrapper given CUDA tensors launches the hand-written kernel or raises.
There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import contextlib
import threading

import torch

# activation codes shared with csrc/*.cu (the epilogue switch)
ACT_CODES = {"none": 0, "relu": 1, "relu6": 2, "silu": 3, "gelu": 4}

# the epilogue activations the int8 conv kernel implements in-register;
# ops.py guards send anything else to the plain reference
EPILOGUE_ACTS = {
    "none": lambda x: x,
    "relu": lambda x: torch.clamp_min(x, 0.0),
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
}


def conv_out_size(size: int, k: int, stride: int, padding: str) -> int:
    """Spatial output size of a conv (may be <= 0 for degenerate VALID)."""
    if padding == "SAME":
        return -(-size // stride)
    return (size - k) // stride + 1


def same_pads(size: int, k: int, stride: int, padding: str) -> tuple[int, int]:
    """(low, high) zero padding of one spatial axis.  SAME puts the smaller
    half low (low = total // 2), as XLA does."""
    if padding != "SAME":
        return 0, 0
    out = conv_out_size(size, k, stride, padding)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_kernel_eligible(x, w, *, stride, padding, groups, act) -> bool:
    """Would ops._cuda_fused_conv run the implicit-GEMM kernel on this site
    (vs the plain reference)?  ONE predicate shared by the dispatch wrapper
    and the profiler's credit mirrors, so they cannot drift."""
    if (groups != 1 or len(getattr(x, "shape", ())) != 4
            or len(getattr(w, "shape", ())) != 4
            or padding not in ("SAME", "VALID") or act not in EPILOGUE_ACTS):
        return False
    return (conv_out_size(x.shape[1], w.shape[0], stride, padding) > 0
            and conv_out_size(x.shape[2], w.shape[1], stride, padding) > 0)


def depthwise_kernel_eligible(x, w, *, stride, padding, act) -> bool:
    """Would ops._cuda_depthwise_conv run the depthwise kernel on this site
    (vs the plain reference)?  True depthwise means HWIO weights
    (KH, KW, 1, C) over a (N, H, W, C) x (channel multiplier 1; grouped but
    not depthwise stays on the reference), SAME or VALID padding, an act
    the epilogue implements and a non-empty output.  ONE predicate shared
    by the dispatch wrapper and the profiler's dw credit mirror."""
    xs, ws = tuple(getattr(x, "shape", ())), tuple(getattr(w, "shape", ()))
    if (len(xs) != 4 or len(ws) != 4 or ws[2] != 1 or ws[3] != xs[-1]
            or padding not in ("SAME", "VALID") or act not in EPILOGUE_ACTS):
        return False
    return (conv_out_size(xs[1], ws[0], stride, padding) > 0
            and conv_out_size(xs[2], ws[1], stride, padding) > 0)


def sep_kernel_eligible(x, w_dw, w_pw, *, stride, padding, dw_act,
                        pw_act) -> bool:
    """Would ops._cuda_sep_block run the fused separable-block kernel (vs
    decomposing into its two stage wrappers)?  The depthwise stage must be
    kernel-eligible and the pointwise weights a (1, 1, C, Cout) 1x1 over
    x's channels, with an epilogue act.  Shared with the profiler's
    ``sep_intermediate`` mirror."""
    ps = tuple(getattr(w_pw, "shape", ()))
    pw_1x1 = (len(ps) == 4 and ps[0] == ps[1] == 1
              and ps[2] == tuple(getattr(x, "shape", (0,)))[-1])
    return (pw_1x1 and pw_act in EPILOGUE_ACTS
            and depthwise_kernel_eligible(x, w_dw, stride=stride,
                                          padding=padding, act=dw_act))


def conv_residual_fusable(x, w, res, *, stride, padding, groups, act) -> bool:
    """Is ``res`` an exactly-output-shaped skip tensor on a kernel-eligible
    conv site (the acc_mac epilogue's contract)?"""
    if not conv_kernel_eligible(x, w, stride=stride, padding=padding,
                                groups=groups, act=act):
        return False
    return tuple(getattr(res, "shape", ())) == (
        x.shape[0],
        conv_out_size(x.shape[1], w.shape[0], stride, padding),
        conv_out_size(x.shape[2], w.shape[1], stride, padding),
        w.shape[-1],
    )


def gemm_residual_fusable(x, w, res) -> bool:
    """Is ``res`` an exactly-output-shaped skip tensor for the GEMM-epilogue
    kernel (matmul_epilogue's acc_mac contract)?"""
    return (len(getattr(w, "shape", ())) == 2
            and tuple(getattr(res, "shape", ())) == (*x.shape[:-1], w.shape[1]))


def split_k(tiles: int, k_iters: int, sms: int) -> int:
    """How many slices of K a GEMM-shaped kernel with ``tiles`` output
    tiles and ``k_iters`` K steps splits into: enough blocks for about two
    waves over ``sms`` multiprocessors, each slice at least 4 K steps, and
    no empty slice.  1 when the tiles alone fill the card."""
    if tiles >= sms:
        return 1
    want = max(1, min(-(-2 * sms // tiles), k_iters // 4))
    per = -(-k_iters // want)
    return -(-k_iters // per)


def runs_plain(*tensors) -> bool:
    """True when the wrapper must run the plain version: every tensor lies
    on the CPU.  CUDA tensors go to the kernel; anything else raises."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise RuntimeError(
        f"kernel wrappers take all-CPU (plain version) or all-CUDA (kernel) "
        f"tensors; got devices {sorted(devs)}"
    )


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype,
                  shape: tuple[int, ...]) -> None:
    """Validate one kernel operand before its pointer crosses to CUDA."""
    if not t.is_cuda:
        raise RuntimeError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# the two TF32 switches and their full-f32 value (PyTorch >= 2.9), and
# cuBLAS's bf16 reduced-precision reduction (on by default)
_TF32_SWITCHES = ((torch.backends.cudnn.conv, "fp32_precision", "ieee"),
                  (torch.backends.cuda.matmul, "fp32_precision", "ieee"),
                  (torch.backends.cuda.matmul,
                   "allow_bf16_reduced_precision_reduction", False))


_f32_lock = threading.RLock()  # the switches are process-global


@contextlib.contextmanager
def full_f32():
    """Run float32 convolutions (cuDNN) and matrix products (cuBLAS) in full
    f32, and bf16 products with f32 sums, whatever the caller's global
    settings, and put those settings back on exit.  CPU arithmetic is
    unaffected."""
    with _f32_lock:
        saved = [getattr(ns, attr) for ns, attr, _ in _TF32_SWITCHES]
        try:
            for ns, attr, value in _TF32_SWITCHES:
                setattr(ns, attr, value)
            yield
        finally:
            for (ns, attr, _), value in zip(_TF32_SWITCHES, saved):
                setattr(ns, attr, value)
