"""The ten kernel entry points as ``torch.library`` ops under ``marvel::``.

A traced program (``make_fx``: :mod:`repro_torch.core.rewrite` and the
per-bucket rewritten graphs of ``repro_torch.marvel``) sees each kernel as
one opaque node instead of the ATen ops of its wrapper.  Each op's real
implementation calls its module's entry point **by attribute at call
time** (``fused_conv.fused_conv_int8``, ...), so whatever is patched onto
the module — a launch recorder, a planted fault, a counting wrapper — is
what runs, the launch counters on the entry points keep counting, and every
choice that reads a pointer (the pools' alignment test) stays inside the
op.  Nothing falls back to the plain version when a kernel fails.

Each fake implementation gives the output's shape, dtype and layout: the
entry point's plain version run on the fake tensors, made contiguous on a
CUDA device, where every kernel writes a fresh contiguous output.

The dispatch wrappers (``kernels/ops.py``) reach a kernel through
:func:`launch`: the op while a dispatch mode records (a trace, a profile),
else the entry point itself, since the op's round trip through the
dispatcher costs 19-31 µs of host time a call on the H100
(``tools/time_baked_graph.py``) and an eager forward has nothing to record.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.kernels import depthwise_conv as dw
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_conv as fc
from repro_torch.kernels import mac_matmul as mm
from repro_torch.kernels import matmul_epilogue as me
from repro_torch.kernels import pooling as pk
from repro_torch.kernels import ref
from repro_torch.kernels import residual_rmsnorm as rr
from repro_torch.kernels import wkv_chunk as wk


def _like_kernel(t: Tensor) -> Tensor:
    """A plain version's fake output as the kernel leaves it: on the CPU
    the plain version is what runs; on a card the kernel's output is
    contiguous."""
    return t if t.device.type == "cpu" else t.contiguous()


def _fused_conv_int8(x_int8: Tensor, w_int8: Tensor, eff_scale: Tensor,
                     eff_bias: Tensor, residual: Optional[Tensor] = None,
                     stride: int = 1, padding: str = "SAME",
                     act: str = "none") -> Tensor:
    return fc.fused_conv_int8(x_int8, w_int8, eff_scale, eff_bias, residual,
                              stride=stride, padding=padding, act=act)


def _fused_conv_int8_fake(x_int8, w_int8, eff_scale, eff_bias,
                          residual=None, stride=1, padding="SAME",
                          act="none"):
    return _like_kernel(fc.fused_conv_int8_plain(
        x_int8, w_int8, eff_scale, eff_bias, residual, stride=stride,
        padding=padding, act=act))


def _matmul_epilogue(x: Tensor, w: Tensor, b: Optional[Tensor] = None,
                     act: str = "none", scale: Optional[Tensor] = None,
                     shift: Optional[Tensor] = None,
                     residual: Optional[Tensor] = None) -> Tensor:
    return me.matmul_epilogue(x, w, b, act=act, scale=scale, shift=shift,
                              residual=residual)


def _matmul_epilogue_fake(x, w, b=None, act="none", scale=None, shift=None,
                          residual=None):
    return _like_kernel(me.matmul_epilogue_plain(
        x, w, b, act=act, scale=scale, shift=shift, residual=residual))


def _windowed_pool(x: Tensor, k: int = 2, stride: int = 2,
                   op: str = "max") -> Tensor:
    return pk.windowed_pool(x, k=k, stride=stride, op=op)


def _windowed_pool_fake(x, k=2, stride=2, op="max"):
    return _like_kernel(pk.windowed_pool_plain(x, k=k, stride=stride, op=op))


def _global_avgpool(x: Tensor) -> Tensor:
    return pk.global_avgpool(x)


def _global_avgpool_fake(x):
    return _like_kernel(pk.global_avgpool_plain(x))


def _depthwise_conv_int8(x_int8: Tensor, w_int8: Tensor, eff_scale: Tensor,
                         eff_bias: Tensor, stride: int = 1,
                         padding: str = "SAME", act: str = "none") -> Tensor:
    return dw.depthwise_conv_int8(x_int8, w_int8, eff_scale, eff_bias,
                                  stride=stride, padding=padding, act=act)


def _depthwise_conv_int8_fake(x_int8, w_int8, eff_scale, eff_bias, stride=1,
                              padding="SAME", act="none"):
    return _like_kernel(dw.depthwise_conv_int8_plain(
        x_int8, w_int8, eff_scale, eff_bias, stride=stride, padding=padding,
        act=act))


def _sep_block_int8(x_int8: Tensor, w_dw_int8: Tensor, dw_scale: Tensor,
                    dw_bias: Tensor, w_pw_int8: Tensor, pw_scale: Tensor,
                    pw_bias: Tensor, stride: int = 1, padding: str = "SAME",
                    dw_act: str = "relu", pw_act: str = "none") -> Tensor:
    return dw.sep_block_int8(x_int8, w_dw_int8, dw_scale, dw_bias,
                             w_pw_int8, pw_scale, pw_bias, stride=stride,
                             padding=padding, dw_act=dw_act, pw_act=pw_act)


def _sep_block_int8_fake(x_int8, w_dw_int8, dw_scale, dw_bias, w_pw_int8,
                         pw_scale, pw_bias, stride=1, padding="SAME",
                         dw_act="relu", pw_act="none"):
    return _like_kernel(dw.sep_block_int8_plain(
        x_int8, w_dw_int8, dw_scale, dw_bias, w_pw_int8, pw_scale, pw_bias,
        stride=stride, padding=padding, dw_act=dw_act, pw_act=pw_act))


def _residual_rmsnorm(res: Tensor, x: Tensor, scale: Tensor,
                      eps: float = 1e-6) -> tuple[Tensor, Tensor]:
    return rr.residual_rmsnorm(res, x, scale, eps=eps)


def _residual_rmsnorm_fake(res, x, scale, eps=1e-6):
    return tuple(_like_kernel(t) for t in ref.residual_rmsnorm_plain(
        res, x, scale, eps))


def _flash_attention(q: Tensor, k: Tensor, v: Tensor,
                     causal: bool = True) -> Tensor:
    return fa.flash_attention(q, k, v, causal=causal)


def _flash_attention_fake(q, k, v, causal=True):
    return _like_kernel(fa.flash_attention_plain(q, k, v, causal=causal))


def _wkv_chunk(r: Tensor, k: Tensor, v: Tensor, lw: Tensor, u: Tensor,
               s0: Tensor, chunk: int = 64) -> tuple[Tensor, Tensor]:
    return wk.wkv_chunk(r, k, v, lw, u, s0, chunk=chunk)


def _wkv_chunk_fake(r, k, v, lw, u, s0, chunk=64):
    return tuple(_like_kernel(t) for t in ref.wkv_chunk_ref(
        r, k, v, lw, u, s0, chunk))


def _mac_matmul_int8(x_int8: Tensor, w_int8: Tensor, scale: Tensor) -> Tensor:
    return mm.mac_matmul_int8(x_int8, w_int8, scale)


def _mac_matmul_int8_fake(x_int8, w_int8, scale):
    return _like_kernel(ref.mac_matmul_int8_ref(x_int8, w_int8, scale))


def _op(impl, fake):
    """``impl`` (named ``_<op>``) registered as ``marvel::<op>``."""
    op = torch.library.custom_op(f"marvel::{impl.__name__[1:]}", impl,
                                 mutates_args=())
    op.register_fake(fake)
    return op


fused_conv_int8 = _op(_fused_conv_int8, _fused_conv_int8_fake)
matmul_epilogue = _op(_matmul_epilogue, _matmul_epilogue_fake)
windowed_pool = _op(_windowed_pool, _windowed_pool_fake)
global_avgpool = _op(_global_avgpool, _global_avgpool_fake)
depthwise_conv_int8 = _op(_depthwise_conv_int8, _depthwise_conv_int8_fake)
sep_block_int8 = _op(_sep_block_int8, _sep_block_int8_fake)
residual_rmsnorm = _op(_residual_rmsnorm, _residual_rmsnorm_fake)
flash_attention = _op(_flash_attention, _flash_attention_fake)
wkv_chunk = _op(_wkv_chunk, _wkv_chunk_fake)
mac_matmul_int8 = _op(_mac_matmul_int8, _mac_matmul_int8_fake)

# name -> (module, entry point), in chip_smoke.py's order of the kernels
ENTRY_POINTS = {
    "fused_conv": (fc, "fused_conv_int8"),
    "matmul_epilogue": (me, "matmul_epilogue"),
    "windowed_pool": (pk, "windowed_pool"),
    "global_avgpool": (pk, "global_avgpool"),
    "depthwise_conv": (dw, "depthwise_conv_int8"),
    "sep_block": (dw, "sep_block_int8"),
    "residual_rmsnorm": (rr, "residual_rmsnorm"),
    "flash_attention": (fa, "flash_attention"),
    "wkv_chunk": (wk, "wkv_chunk"),
    "mac_matmul_int8": (mm, "mac_matmul_int8"),
}


def launch(name: str, *args, **kwargs):
    """Run kernel ``name``: through its ``marvel::`` op while a dispatch
    mode is active (a ``make_fx`` trace records it as one node), else
    through its module's entry point, looked up now."""
    if _get_current_dispatch_mode() is not None:
        return OPS[name](*args, **kwargs)
    mod, attr = ENTRY_POINTS[name]
    return getattr(mod, attr)(*args, **kwargs)


# name -> op
OPS = {"fused_conv": fused_conv_int8, "matmul_epilogue": matmul_epilogue,
       "windowed_pool": windowed_pool, "global_avgpool": global_avgpool,
       "depthwise_conv": depthwise_conv_int8, "sep_block": sep_block_int8,
       "residual_rmsnorm": residual_rmsnorm,
       "flash_attention": flash_attention, "wkv_chunk": wkv_chunk,
       "mac_matmul_int8": mac_matmul_int8}

