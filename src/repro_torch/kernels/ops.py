"""Dispatch wrappers + registration: the ``cuda`` backend.

Importing this module registers each kernel under its MARVEL pattern
name, so ``marvel.compile(..., backend="cuda")`` — or an ambient
``dispatch.use_table(resolve_table(level, "cuda", model_class="cnn"))`` —
swaps them in without any model-code change.  The wrappers keep the
reference's guards (``src/repro/kernels/ops.py``): a site outside a
kernel's contract runs the plain reference, which is decided from shapes
and arguments alone, never by catching a kernel failure.

Each wrapper calls its kernel through :func:`repro_torch.kernels.library.
launch`: one opaque ``marvel::`` node in a traced program, the entry point
itself in an eager call.

Registrations carry ``platforms=("cuda",)``: ``backend="auto"`` picks a
kernel only on a CUDA device.  Forced with ``backend="cuda"`` on CPU
tensors, each kernel wrapper runs its plain version — the analogue of the
reference's interpret mode, and what the CPU tests use.
"""
from __future__ import annotations

import torch

from repro_torch.core import dispatch
from repro_torch.kernels import library
from repro_torch.kernels import pooling as pk
from repro_torch.kernels import ref
from repro_torch.kernels.common import (
    conv_kernel_eligible, conv_residual_fusable, depthwise_kernel_eligible,
    gemm_residual_fusable, sep_kernel_eligible,
)
from repro_torch.models.layers import _flash_attention_ref

# the reference's flash KV tile (its tuning default, bk = 128): its
# guards decide from it whether ragged KV could reach padded keys
FLASH_BK = 128


def _quant_int8(a, axes=None):
    """Symmetric int8 quantization: (int8 values, f32 scale).  ``axes=None``
    is per-tensor (activations, over the whole batch); a reduction-axes
    tuple is per-channel (weights).  The scale is ``max(absmax, 1e-8)/127``
    and the codes are ``round(a / s)`` — a division, rounded half to even —
    clipped to +-127, bit for bit the reference's codes."""
    af = a.float()
    amax = af.abs().amax() if axes is None else af.abs().amax(dim=axes)
    s = torch.clamp_min(amax, 1e-8) / 127.0
    return torch.clamp(torch.round(af / s), -127, 127).to(torch.int8), s


def _quant_rows(x2):
    """Dynamic per-row int8 activation quantization of (M, K) rows: the
    scale ``max(absmax, 1e-8) / 127`` per row and the codes ``round(x /
    s)`` (half to even) clipped to +-127, bit for bit the reference's."""
    xf = x2.float()
    xs = torch.clamp_min(xf.abs().amax(dim=1, keepdim=True), 1e-8) / 127.0
    return torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8), xs


def _cuda_mac_matmul_int8(x, quant):
    """mac: int8 weights ``{"w_int8", "scale"}`` against int8 activations
    quantized per row on the fly, the dequant folded after the kernel."""
    w_int8, scale = quant["w_int8"], quant["scale"]
    x2 = x.reshape(-1, x.shape[-1])
    x_int8, xs = _quant_rows(x2)
    out = library.launch("mac_matmul_int8", x_int8, w_int8,
                         scale.reshape(-1)) * xs
    return out.reshape(*x.shape[:-1], w_int8.shape[-1]).to(x.dtype)


def _cuda_fused_conv(x, w, b=None, *, stride=1, padding="SAME", groups=1,
                     act="none", scale=None, shift=None, residual=None):
    """conv_mac: quantize to int8 on the fly, run the implicit-GEMM kernel.

    Grouped convs, exotic paddings, acts the epilogue lacks and mis-shaped
    residuals stay on the plain reference (still one dispatch site)."""
    eligible = conv_kernel_eligible(x, w, stride=stride, padding=padding,
                                    groups=groups, act=act)
    res_ok = residual is None or conv_residual_fusable(
        x, w, residual, stride=stride, padding=padding, groups=groups,
        act=act,
    )
    if not eligible or not res_ok:
        return ref.fused_conv_ref(
            x, w, b, stride=stride, padding=padding, groups=groups, act=act,
            scale=scale, shift=shift, residual=residual,
        )
    # dynamic per-tensor activation quant + per-output-channel weight quant
    x_int8, xs = _quant_int8(x)
    w_int8, ws = _quant_int8(w, axes=(0, 1, 2))
    cout = w.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    dq = xs * ws  # per-channel dequant, (Cout,)
    bias = torch.zeros(cout, **f32) if b is None else b.float()
    s = torch.ones(cout, **f32) if scale is None else scale.float()
    t = torch.zeros(cout, **f32) if shift is None else shift.float()
    # act((acc*dq + bias)*s + t + res) = act(acc*(dq*s) + (bias*s + t) + res)
    out = library.launch("fused_conv", x_int8, w_int8, dq * s, bias * s + t,
                         residual, stride=stride, padding=padding, act=act)
    return out.to(x.dtype)


def _cuda_depthwise_conv(x, w, b=None, *, stride=1, padding="SAME",
                         act="none", scale=None, shift=None):
    """dw_mac: quantize to int8 on the fly, run the per-channel MAC kernel.

    Non-depthwise weight shapes, exotic paddings, acts the epilogue lacks
    and degenerate outputs stay on the plain reference (still one dispatch
    site)."""
    if getattr(w, "ndim", 0) == 3:  # the squeezed (KH, KW, C) tap stack:
        w = w[:, :, None, :]  # normalize to HWIO
    if not depthwise_kernel_eligible(x, w, stride=stride, padding=padding,
                                     act=act):
        groups = 1  # grouped but not depthwise: groups from the HWIO shape
        if (x.ndim == 4 and getattr(w, "ndim", 0) == 4 and w.shape[2]
                and x.shape[-1] % w.shape[2] == 0):
            groups = x.shape[-1] // w.shape[2]
        return ref.fused_conv_ref(
            x, w, b, stride=stride, padding=padding, groups=groups, act=act,
            scale=scale, shift=shift,
        )
    c = x.shape[-1]
    x_int8, xs = _quant_int8(x)
    w_int8, ws = _quant_int8(w[:, :, 0, :], axes=(0, 1))  # (KH, KW, C)
    f32 = dict(dtype=torch.float32, device=x.device)
    dq = xs * ws  # per-channel dequant, (C,)
    bias = torch.zeros(c, **f32) if b is None else b.float()
    s = torch.ones(c, **f32) if scale is None else scale.float()
    t = torch.zeros(c, **f32) if shift is None else shift.float()
    # same fold as fused_conv: act(acc*(dq*s) + (bias*s + t))
    out = library.launch("depthwise_conv", x_int8, w_int8, dq * s,
                         bias * s + t, stride=stride, padding=padding,
                         act=act)
    return out.to(x.dtype)


def _cuda_sep_block(x, w_dw, w_pw, *, stride=1, padding="SAME",
                    dw_scale=None, dw_shift=None, dw_act="relu",
                    pw_bias=None, pw_scale=None, pw_shift=None,
                    pw_act="none"):
    """sep_block: fused depthwise -> pointwise, one device-memory write.

    A site the fused kernel declines (non-depthwise dw weights, non-1x1
    pointwise, exotic padding or acts, degenerate output) decomposes into
    the two stage wrappers, so the depthwise and conv kernels still run
    where they can."""
    if not sep_kernel_eligible(x, w_dw, w_pw, stride=stride,
                               padding=padding, dw_act=dw_act,
                               pw_act=pw_act):
        y = _cuda_depthwise_conv(x, w_dw, None, stride=stride,
                                 padding=padding, act=dw_act, scale=dw_scale,
                                 shift=dw_shift)
        return _cuda_fused_conv(y, w_pw, pw_bias, stride=1, padding="SAME",
                                groups=1, act=pw_act, scale=pw_scale,
                                shift=pw_shift)
    c, cout = x.shape[-1], w_pw.shape[-1]
    x_int8, xs = _quant_int8(x)
    wd_int8, wds = _quant_int8(w_dw[:, :, 0, :], axes=(0, 1))
    wp_int8, wps = _quant_int8(w_pw.reshape(c, cout), axes=(0,))
    f32 = dict(dtype=torch.float32, device=x.device)
    ds = torch.ones(c, **f32) if dw_scale is None else dw_scale.float()
    dt = torch.zeros(c, **f32) if dw_shift is None else dw_shift.float()
    pb = torch.zeros(cout, **f32) if pw_bias is None else pw_bias.float()
    ps = torch.ones(cout, **f32) if pw_scale is None else pw_scale.float()
    pt = torch.zeros(cout, **f32) if pw_shift is None else pw_shift.float()
    # the reference's folds, in its order: dw_act(acc_dw*(xs*wds*ds) + dt);
    # the pointwise stage contracts that f32 tile against the int8 weights,
    # so its fold is pw_act(acc_pw*(wps*ps) + (pb*ps + pt))
    out = library.launch(
        "sep_block", x_int8, wd_int8, xs * wds * ds, dt, wp_int8, wps * ps,
        pb * ps + pt, stride=stride, padding=padding, dw_act=dw_act,
        pw_act=pw_act,
    )
    return out.to(x.dtype)


def _cuda_matmul_epilogue(x, w, b=None, act="none", scale=None, shift=None,
                          residual=None):
    if residual is not None and not gemm_residual_fusable(x, w, residual):
        # mis-shaped skip tensor: stay on the algorithmically-fused oracle
        return ref.matmul_epilogue_ref(x, w, b, act=act, scale=scale,
                                       shift=shift, residual=residual)
    return library.launch("matmul_epilogue", x, w, b, act=act, scale=scale,
                          shift=shift, residual=residual)


def _cuda_pool(x, *, op, k=2, stride=2):
    """pool: windowed max/avg pooling + the global-avg reduce; forms outside
    the fast path run the plain reference."""
    if not pk.fast_path_supported(x, op=op, k=k, stride=stride):
        return ref.pool_ref(x, op=op, k=k, stride=stride)
    if op == "global_avg":
        return library.launch("global_avgpool", x)
    return library.launch("windowed_pool", x, k=k, stride=stride,
                          op=op)


def _cuda_residual_rmsnorm(res, x, scale, eps=1e-6):
    return library.launch("residual_rmsnorm", res, x, scale, eps=eps)


def _cuda_flash_attention(q, k, v, *, causal=True, q_offset=0,
                          impl="chunked", chunk=512, window=None, kv_len=None,
                          k_scale=None, v_scale=None):
    """zol: the causal self-attention fast path runs the kernel; decode
    (``Sq == 1``), ragged decode (``kv_len``), windows, ``dh != dv`` and
    non-causal attention over KV the reference's tile does not divide run
    the plain reference, exactly as the reference wrapper routes them (it
    also dequantizes int8 KV)."""
    b, sq, kh, g, dh = q.shape
    dv = v.shape[-1]
    skv = k.shape[1]
    bk = min(FLASH_BK, skv)
    pad_unsafe = (not causal) and (skv % bk != 0)
    if (window is not None or kv_len is not None or sq == 1 or dh != dv
            or pad_unsafe):
        return _flash_attention_ref(
            q, k, v, causal=causal, q_offset=q_offset, impl=impl,
            chunk=chunk, window=window, kv_len=kv_len, k_scale=k_scale,
            v_scale=v_scale)
    if k_scale is not None:
        # int8 KV: the rank-1 dequant at the kernel boundary
        k = ref.dequant_kv(k, k_scale, q.dtype)
        v = ref.dequant_kv(v, v_scale, q.dtype)
    return library.launch("flash_attention", q, k, v, causal=causal)


def _cuda_wkv_chunk(r, k, v, lw, u, s0, chunk):
    """zol (rnn_lm): the chunked WKV recurrence (S % chunk == 0)."""
    return library.launch("wkv_chunk", r, k, v, lw, u, s0, chunk=chunk)


def register():
    cuda = ("cuda",)
    dispatch.register_impl("mac_matmul_int8", "cuda", _cuda_mac_matmul_int8,
                           platforms=cuda)
    dispatch.register_impl("fused_conv", "cuda", _cuda_fused_conv,
                           platforms=cuda)
    dispatch.register_impl("matmul_epilogue", "cuda", _cuda_matmul_epilogue,
                           platforms=cuda)
    dispatch.register_impl("pool", "cuda", _cuda_pool, platforms=cuda)
    dispatch.register_impl("depthwise_conv", "cuda", _cuda_depthwise_conv,
                           platforms=cuda)
    dispatch.register_impl("sep_block", "cuda", _cuda_sep_block,
                           platforms=cuda)
    dispatch.register_impl("residual_rmsnorm", "cuda", _cuda_residual_rmsnorm,
                           platforms=cuda)
    dispatch.register_impl("flash_attention", "cuda", _cuda_flash_attention,
                           platforms=cuda)
    dispatch.register_impl("wkv_chunk", "cuda", _cuda_wkv_chunk,
                           platforms=cuda)


register()
