"""Op-pattern profiler — the paper's instruction-accurate-simulator step.

Two sources feed one profile, as in the reference's ``core/profiler.py``:

  1. *instruction level* — the ATen ops the baseline issues, counted by a
     ``TorchDispatchMode``: ``conv`` (convolutions), ``dot`` (matrix
     products) and ``mul(mac)`` (both), the counts ``classify`` and
     ``extensions_for_class`` read;
  2. *pattern-site level* — the dispatch layer records every fusable call
     site with its tensor bytes, plus the reference's pseudo-sites
     (``acc_mac``, ``acc_flops``, ``conv_epilogue``, ``dw_mac_flops``,
     ``dw_epilogue``, ``sep_intermediate``, ``pool_flops``,
     ``pool_epilogue``, ``pool_int8``, ``attn_scores``, ``attn_flops``,
     ``wkv_flops``, ``rmsnorm_epilogue``).

A model's stack of layers runs through :func:`scan`, the port's
``lax.scan``: while a profile records, its body runs once, as the
reference's profiler traces a scan body once, so site counts are per
program site and ``loop_iters`` adds the trip count.

The model runs on fake tensors (meta-backed: shapes and dtypes, no data),
so nothing is computed and no device is touched.  FLOP and byte totals for
the cost model come with the cost-model slice.
"""
from __future__ import annotations

import contextlib
import threading
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import dispatch
from repro_torch.kernels import pooling as _pk
from repro_torch.kernels.common import (
    conv_out_size, conv_residual_fusable, depthwise_kernel_eligible,
    gemm_residual_fusable, sep_kernel_eligible,
)

# ---------------------------------------------------------------------------
# dispatch-level site recording
# ---------------------------------------------------------------------------

_tls = threading.local()


def _sink() -> list | None:
    return getattr(_tls, "sink", None)


def scan(body, carry, layers):
    """``carry = body(p, carry)`` for each layer's params ``p`` in order.
    While a profile records on this thread, the body runs once, on the
    first layer (the reference traces a scan body once), and the trip count
    goes to the profile's ``loop_iters``."""
    if _sink() is not None:
        _tls.loop_iters = getattr(_tls, "loop_iters", 0) + len(layers)
        return body(layers[0], carry)
    for p in layers:
        carry = body(p, carry)
    return carry


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _acc_mac_fusable(pattern, x, w, res, kwargs) -> bool:
    """True iff this site's kernel would fuse the skip-add — the SAME
    predicates the ops.py wrappers use, so the credit cannot drift."""
    if not all(isinstance(t, torch.Tensor) for t in (x, w, res)):
        return False
    if pattern == "matmul_epilogue":
        return gemm_residual_fusable(x, w, res)
    return conv_residual_fusable(
        x, w, res, stride=kwargs.get("stride", 1),
        padding=kwargs.get("padding", "SAME"),
        groups=kwargs.get("groups", 1), act=kwargs.get("act", "none"),
    )


def _n_post(args, kwargs, act) -> int:
    """Post-ops an unfused conv epilogue runs: bias, scale, shift, act
    (relu6 is two)."""
    return (int(len(args) > 2 and args[2] is not None)
            + int(kwargs.get("scale") is not None)
            + int(kwargs.get("shift") is not None)
            + (2 if act == "relu6" else int(act != "none")))


def _out_hw(x, w, stride, padding) -> tuple[int, int]:
    return (conv_out_size(x.shape[1], w.shape[0], stride, padding),
            conv_out_size(x.shape[2], w.shape[1], stride, padding))


def _record_pseudo_sites(s: list, pattern: str, args, kwargs) -> None:
    res = kwargs.get("residual")
    if (pattern in ("fused_conv", "matmul_epilogue") and res is not None
            and len(args) >= 2
            and _acc_mac_fusable(pattern, args[0], args[1], res, kwargs)):
        # acc_mac: unfused, the pre-add output round-trips device memory
        # once (an f32 write + read) just to be added to the skip tensor
        s.append(("acc_mac", int(2 * 4 * res.numel())))
        s.append(("acc_flops", int(res.numel())))
    if pattern == "fused_conv" and len(args) >= 2:
        # what an unfused conv epilogue round-trips: each post-op (bias,
        # scale, shift, act; relu6 is two) re-reads and re-writes the output
        x, w = args[0], args[1]
        padding = kwargs.get("padding", "SAME")
        if (x.ndim == 4 and padding in ("SAME", "VALID")
                and kwargs.get("groups", 1) == 1):
            ho, wo = _out_hw(x, w, kwargs.get("stride", 1), padding)
            n_post = _n_post(args, kwargs, kwargs.get("act", "none"))
            if ho > 0 and wo > 0:
                s.append(("conv_epilogue", int(
                    2 * 4 * x.shape[0] * ho * wo * w.shape[-1] * n_post)))
    if pattern == "depthwise_conv" and len(args) >= 2:
        # dw_mac: the per-channel MAC flops and the epilogue round-trips the
        # kernel keeps in-register, credited where the kernel would run
        x, w = args[0], args[1]
        stride = kwargs.get("stride", 1)
        padding = kwargs.get("padding", "SAME")
        act = kwargs.get("act", "none")
        if depthwise_kernel_eligible(x, w, stride=stride, padding=padding,
                                     act=act):
            kh, kw_, _, c = w.shape
            ho, wo = _out_hw(x, w, stride, padding)
            pix = x.shape[0] * ho * wo * c
            s.append(("dw_mac_flops", int(2 * pix * kh * kw_)))
            s.append(("dw_epilogue",
                      int(2 * 4 * pix * _n_post(args, kwargs, act))))
    if pattern == "sep_block" and len(args) >= 3:
        # what the unfused separable block spills: the (N, Ho, Wo, C) f32
        # depthwise output, written once and read once; a site the fused
        # kernel declines decomposes and does round-trip it
        x, w_dw, w_pw = args[0], args[1], args[2]
        stride = kwargs.get("stride", 1)
        padding = kwargs.get("padding", "SAME")
        if sep_kernel_eligible(x, w_dw, w_pw, stride=stride, padding=padding,
                               dw_act=kwargs.get("dw_act", "relu"),
                               pw_act=kwargs.get("pw_act", "none")):
            ho, wo = _out_hw(x, w_dw, stride, padding)
            s.append(("sep_intermediate",
                      int(2 * 4 * x.shape[0] * ho * wo * x.shape[-1])))
    if pattern == "flash_attention" and len(args) >= 2:
        # what a non-streaming attention spills: the Sq x Skv f32 scores,
        # written and read; and the QK^T + PV flops of the site
        q, k = args[0], args[1]
        b, sq, kh, g, dh = q.shape
        skv = k.shape[1]
        s.append(("attn_scores", int(2 * 4 * b * kh * g * sq * skv)))
        s.append(("attn_flops", int(2 * 2 * b * kh * g * sq * skv * dh)))
    if pattern == "wkv_chunk" and len(args) >= 4 and args[0].ndim == 4:
        # the recurrence's weight-less contractions: the r.S readout and
        # the k v^T state update, (N, N) per head per token
        b, s_len, h, n = args[0].shape
        s.append(("wkv_flops", int(4 * b * s_len * h * n * n)))
    if pattern == "residual_rmsnorm" and args:
        # what the unfused form round-trips: the res + x sum, written by
        # the add and read by the norm, in f32
        s.append(("rmsnorm_epilogue", int(2 * 4 * args[0].numel())))
    if pattern == "pool" and args and isinstance(args[0], torch.Tensor):
        x = args[0]
        op = kwargs.get("op")
        k = kwargs.get("k", 2)
        stride = kwargs.get("stride", 2)
        if x.ndim == 4 and 0 not in x.shape:
            n, h, w_in, c = x.shape
            if op == "global_avg":
                ho = wo = 1
                window = h * w_in
            else:
                ho = conv_out_size(h, k, stride, "VALID")
                wo = conv_out_size(w_in, k, stride, "VALID")
                window = k * k
            supported = _pk.fast_path_supported(x, op=op, k=k, stride=stride)
            out_elems = n * ho * wo * c
            if ho > 0 and wo > 0 and supported:
                s.append(("pool_flops", int(out_elems * window)))
                if op in ("avg", "global_avg"):
                    s.append(("pool_epilogue", int(2 * 4 * out_elems)))
                if x.dtype.is_floating_point:
                    in_bytes = x.numel() * x.element_size()
                    s.append(("pool_int8",
                              int(0.75 * (in_bytes + 4 * out_elems))))


@contextlib.contextmanager
def _recording(sink: list):
    _tls.sink = sink
    _tls.loop_iters = 0
    orig_call = dispatch.call

    def recording_call(pattern, baseline, *args, **kwargs):
        s = _sink()
        if s is not None:
            # the residual is an accumulator input (acc_mac), not epilogue
            # payload: keep it out of the generic site bytes
            kw_payload = {k: v for k, v in kwargs.items() if k != "residual"}
            nbytes = sum(t.numel() * t.element_size()
                         for t in _leaves((args, kw_payload)))
            s.append((pattern, int(nbytes)))
            _record_pseudo_sites(s, pattern, args, kwargs)
        return orig_call(pattern, baseline, *args, **kwargs)

    dispatch.call = recording_call
    try:
        yield
    finally:
        dispatch.call = orig_call
        _tls.sink = None


# ---------------------------------------------------------------------------
# instruction-level counting
# ---------------------------------------------------------------------------

CONV_OPS = {"aten.convolution"}
DOT_OPS = {"aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm", "aten.dot",
           "aten.mv"}


class _OpCounter(TorchDispatchMode):
    def __init__(self, counts: Counter):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name in CONV_OPS or name in DOT_OPS:
            self.counts["mul(mac)"] += 1
            self.counts["conv" if name in CONV_OPS else "dot"] += 1
        return func(*args, **(kwargs or {}))


@dataclass
class PatternProfile:
    # instruction level
    counts: Counter = field(default_factory=Counter)
    # pattern-site level (bytes per fusable call site, pseudo-sites too)
    site_counts: Counter = field(default_factory=Counter)
    site_bytes: Counter = field(default_factory=Counter)
    loop_iters: float = 0.0


def site_shapes(fn: Callable, *patterns: str) -> list[tuple]:
    """``(pattern, shape, dtype)`` of the first two tensor arguments of
    every call ``fn()`` makes to the given dispatch patterns, once per
    program site (a layer stack's body runs once), over fake tensors: the
    shapes a model hands its kernels, with nothing computed.  ``fn`` makes
    its own inputs and parameters (they are faked as they are made)."""
    seen: list[tuple] = []
    with _recording([]):
        inner = dispatch.call

        def shapes(pattern, baseline, *args, **kwargs):
            if pattern in patterns:
                seen.append((pattern, *((tuple(a.shape), a.dtype)
                                        for a in args[:2])))
            return inner(pattern, baseline, *args, **kwargs)

        dispatch.call = shapes
        try:
            with FakeTensorMode(allow_non_fake_inputs=True), \
                    dispatch.use_table(dispatch.EMPTY_TABLE):
                fn()
        finally:
            dispatch.call = inner
    return seen


def profile_fn(fn: Callable, *args, **kwargs) -> PatternProfile:
    """Run ``fn`` on the baseline over fake tensors (nothing executes) and
    profile it.  Tensor and numpy arguments become fake tensors of the same
    shape, dtype and device; tensors ``fn`` closes over are faked on use."""
    prof = PatternProfile()
    sink: list[tuple[str, int]] = []
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = [mode.from_tensor(torch.as_tensor(a))
                if isinstance(a, (torch.Tensor, np.ndarray)) else a
                for a in args]
        with _recording(sink), dispatch.use_table(dispatch.EMPTY_TABLE), \
                _OpCounter(prof.counts):
            fn(*fake, **kwargs)
            prof.loop_iters = float(_tls.loop_iters)
    for pattern, nbytes in sink:
        prof.site_counts[pattern] += 1
        prof.site_bytes[pattern] += nbytes
    return prof
