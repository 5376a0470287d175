"""Op-pattern profiler — the paper's instruction-accurate-simulator step.

Two sources feed one profile, as in the reference's ``core/profiler.py``:

  1. *instruction level* — the ATen ops the baseline issues, seen by a
     ``TorchDispatchMode`` and mapped one by one onto the reference's jaxpr
     equation classes (:data:`OP_CLASSES`): matrix products and
     convolutions, elementwise mul, elementwise add/sub, transparent layout
     plumbing, activations, and everything else.  From them come the
     instruction counts (``conv``, ``dot``, ``mul(mac)``, ``mul_add(mac)``,
     ``fusedmac``, ``add``, ``addi``, ``addi_addi(add2i)``,
     ``loop(blt)``, ``other:<op>``), the literal add immediates
     (``addi_values``), the conv inner-loop address bumps
     (``conv_strides``) and the FLOP and byte totals of the cost model
     (``flops``, ``matmul_flops``, ``conv_flops``, ``hbm_bytes``,
     ``weight_bytes``);
  2. *pattern-site level* — the dispatch layer records every fusable call
     site with its tensor bytes, plus the reference's pseudo-sites
     (``acc_mac``, ``acc_flops``, ``conv_epilogue``, ``dw_mac_flops``,
     ``dw_epilogue``, ``sep_intermediate``, ``pool_flops``,
     ``pool_epilogue``, ``pool_int8``, ``attn_scores``, ``attn_flops``,
     ``wkv_flops``, ``rmsnorm_epilogue``).

A model's stack of layers runs through :func:`scan`, the port's
``lax.scan``: while a profile records, its body runs once, as the
reference's profiler traces a scan body once, so site counts are per
program site; ``loop_iters`` and ``loop(blt)`` add the trip count, and
every instruction count, FLOP and byte recorded inside the body is
multiplied by it, as the reference's walk multiplies a scan body's.  The
two sites whose baselines are Python loops where the reference scans are
credited from their shapes: an attention site adds its chunk trips, and a
wkv site is counted as the reference's scan body (:func:`_wkv_eqns`) times
its chunks, its own baseline unrecorded.  The SSM's chunk loop runs through
:func:`scan_chunks`, which counts its first trip times the trips; the
functions the reference calls jitted count as one equation
(:func:`jitted`).

The model runs on fake tensors (meta-backed: shapes and dtypes, no data),
so nothing is computed and no device is touched.
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
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

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


def _mult() -> float:
    return getattr(_tls, "mult", 1.0)


def scan(body, carry, layers):
    """``carry = body(p, carry)`` for each layer's params ``p`` in order.
    While a profile records on this thread, the body runs once, on the
    first layer (the reference traces a scan body once): the trip count
    goes to the profile's ``loop_iters`` and multiplies what the body's ops
    record.  While :mod:`~repro_torch.core.rewrite` traces, the body's
    nodes are tagged, as the reference's rewrite does not enter a scan."""
    if _sink() is not None:
        outer = _mult()
        _tls.loop_iters = getattr(_tls, "loop_iters", 0) + outer * len(layers)
        _tls.mult = outer * len(layers)
        try:
            return body(layers[0], carry)
        finally:
            _tls.mult = outer
    from repro_torch.core import rewrite

    with rewrite.scan_body():
        for p in layers:
            carry = body(p, carry)
    return carry


def _add_trips(n: float) -> None:
    _tls.loop_iters = getattr(_tls, "loop_iters", 0) + _mult() * n


def _counter():
    return getattr(_tls, "counter", None) if _sink() is not None else None


def scan_chunks(body, carry, xs, n: int):
    """The reference's ``lax.scan`` of ``body(carry, *chunk) -> (carry,
    y)`` over ``n`` equal chunks of axis 1 of each tensor of ``xs``;
    returns ``(carry, the ys joined on axis 1)``.  While a profile records
    on this thread, the first trip's ops are counted ``n`` times (the
    reference's walk multiplies the body it traces once) and the trips go
    to ``loop_iters``; the other trips and the join run unrecorded (the
    scan stacks its outputs with no equation).  While
    :mod:`~repro_torch.core.rewrite` traces, the loop's nodes are tagged,
    as the reference's rewrite does not enter a scan."""
    size = xs[0].shape[1] // n
    chunk = lambda i: [t[:, i * size:(i + 1) * size] for t in xs]  # noqa: E731
    counter = _counter()
    if counter is not None:
        outer = _mult()
        _add_trips(n)
        _tls.mult = outer * n
        try:
            carry, y = body(carry, *chunk(0))
        finally:
            _tls.mult = outer
        ys = [y]
        counter.quiet += 1
        try:
            for i in range(1, n):
                carry, y = body(carry, *chunk(i))
                ys.append(y)
            return carry, torch.cat(ys, dim=1)
        finally:
            counter.quiet -= 1
    from repro_torch.core import rewrite

    ys = []
    with rewrite.scan_body():
        for i in range(n):
            carry, y = body(carry, *chunk(i))
            ys.append(y)
        return carry, torch.cat(ys, dim=1)


def jitted(fn, *args):
    """``fn(*args)`` for a function the reference calls jitted
    (``jax.nn.silu``, ``jax.nn.softplus``): its walk counts one ``jit``
    equation that moves the inputs and the output and does not enter it,
    and so does a recording profile here."""
    counter = _counter()
    if counter is None:
        return fn(*args)
    counter.quiet += 1
    try:
        out = fn(*args)
    finally:
        counter.quiet -= 1
    counter._account("aten.jit", list(args), [out])
    return out


def _attention_trips(q, k, kwargs) -> int:
    """The KV chunks (or query blocks) an attention site's baseline loops
    over: the trips of the reference's ``lax.scan`` in the same form
    (``models/layers.py``); the naive form has none."""
    if kwargs.get("window") is not None:
        return -(-q.shape[1] // kwargs["window"])
    if kwargs.get("impl", "chunked") == "naive":
        return 0
    skv = k.shape[1]
    return -(-skv // min(kwargs.get("chunk", 512), skv))


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
    _tls.mult = 1.0
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
        counter = getattr(_tls, "counter", None)
        run = lambda: orig_call(pattern, baseline, *args, **kwargs)  # noqa: E731
        if counter is not None:
            if pattern == "pool":
                return counter.pool(kwargs.get("op"), args[0], run)
            if pattern == "wkv_chunk":
                return counter.wkv(args, kwargs, run)
            if pattern == "flash_attention":
                # the baseline's Python loop issues its body every trip, as
                # the reference counts its scan body times the trips: only
                # the trips themselves are added
                _add_trips(_attention_trips(args[0], args[1], kwargs))
        return run()

    dispatch.call = recording_call
    try:
        yield
    finally:
        dispatch.call = orig_call
        _tls.sink = None


# ---------------------------------------------------------------------------
# instruction-level counting
# ---------------------------------------------------------------------------

# Each ATen op the baseline issues, mapped onto the class of the
# reference's jaxpr equation that does the same work (its ``_walk``):
#   matmul       dot_general / conv_general_dilated: the reference's
#                _dot_flops / _conv_flops arithmetic; ``aten.addmm`` and a
#                convolution carrying a bias are the matmul eqn plus an add
#   mul, add     elementwise mul; elementwise add / sub (flops: output bytes
#                / 4, the reference's count)
#   act          the activations a fusedmac chain ends in (``max`` with a
#                literal for relu; ``clamp`` / ``hardtanh`` for relu6 are the
#                reference's ``max`` then ``min``, two eqns)
#   transparent  layout plumbing with no RV32 instruction and no device-
#                memory traffic: views, permutes, contiguous / clone copies
#                made for layout, dtype casts, fills standing for broadcast
#                literals, and ``constant_pad_nd`` (the reference's conv
#                carries its padding inside the eqn)
#   other        everything else: bytes only, counted as ``other:<op>``
OP_CLASSES = {
    "matmul": ("aten.convolution", "aten.mm", "aten.bmm", "aten.addmm",
               "aten.baddbmm", "aten.dot", "aten.mv"),
    "mul": ("aten.mul",),
    "add": ("aten.add", "aten.sub", "aten.rsub"),
    "act": ("aten.sigmoid", "aten.tanh", "aten.erf", "aten.maximum",
            "aten.clamp_min", "aten.relu", "aten.clamp", "aten.hardtanh",
            "aten.exp", "aten.rsqrt"),
    "transparent": (
        "aten.view", "aten._unsafe_view", "aten._reshape_alias",
        "aten.permute", "aten.transpose", "aten.t",
        "aten.expand", "aten.squeeze", "aten.unsqueeze", "aten.slice",
        "aten.select", "aten.split", "aten.split_with_sizes", "aten.unbind",
        "aten.alias", "aten.detach", "aten.as_strided", "aten.clone",
        "aten._to_copy", "aten.lift_fresh",
        "aten.constant_pad_nd", "aten.zeros", "aten.zeros_like",
        "aten.ones", "aten.ones_like", "aten.full", "aten.full_like",
        "aten.empty", "aten.empty_like", "aten.empty_strided",
        "aten.new_zeros", "aten.new_ones", "aten.new_full",
        "aten.new_empty", "aten.scalar_tensor"),
}
_CLASS_OF = {op: cls for cls, ops in OP_CLASSES.items() for op in ops}
# ops that are more than one reference eqn: relu6's clamp is max then min
_EQNS = {"aten.clamp": 2, "aten.hardtanh": 2}
# a matmul op that also adds its bias (the reference's dot + add)
_BIASED = {"aten.addmm": 0, "aten.baddbmm": 0, "aten.convolution": 2}
# layout ops that are eqns with bytes in the reference (jnp.split)
_MOVES = ("aten.split", "aten.split_with_sizes")
# where each matmul op takes its weight-like right operand
_RHS = {"aten.addmm": 2, "aten.baddbmm": 2}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _einsum_weight(spec: str, a: torch.Tensor, b: torch.Tensor
                   ) -> torch.Tensor:
    """The operand of a two-operand einsum that ``jnp.einsum``'s lowering
    passes second to ``dot_general`` (the reference's weight): it takes the
    second operand as lhs and emits ``dot_general(first, second)`` when the
    batch, first-only and second-only names already spell the output,
    else ``dot_general(second, first)``."""
    ins, out = spec.replace(" ", "").split("->")
    names = []
    for t, sub in zip((a, b), ins.split(",")):
        fill = "".join(chr(ord("A") + i)
                       for i in range(t.ndim - len(sub.replace("...", ""))))
        names.append(sub.replace("...", fill))
    out = out.replace("...", fill if "..." in out else "")
    first, second = names
    batch = [c for c in out if c in first and c in second]
    shared = set(first) & set(second)
    only_first = "".join(c for c in first if c not in shared)
    only_second = "".join(c for c in second if c not in shared)
    if "".join(batch) + only_first + only_second == out:
        return b
    return a


class _EinsumOrder(TorchFunctionMode):
    """Tells the op counter which operand of a two-operand ``einsum`` the
    reference counts as the weight of the product it issues."""

    def __init__(self, counter: "_OpCounter"):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ops = args[1:]
        if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = tuple(ops[0])
        if func is not torch.einsum or len(ops) != 2:
            return func(*args, **kwargs)
        self.counter.weight_next = _nbytes(_einsum_weight(args[0], *ops))
        try:
            return func(*args, **kwargs)
        finally:
            self.counter.weight_next = None


def _gelu_tanh_eqns(x: torch.Tensor):
    """``jax.nn.gelu(approximate=True)``'s equations, in its order (the
    reference's model has them inline where the port calls one op)."""
    cdf = 0.5 * (1.0 + torch.tanh(0.7978845608 * (x + 0.044715 * x**3)))
    return x * cdf


def _matmul_flops(name: str, args, out: torch.Tensor) -> float:
    if name == "aten.convolution":
        # 2 * out_elems * (kernel_elems / out_channels), the reference's
        w = args[1]
        return 2.0 * out.numel() * (w.numel() / max(out.shape[1], 1))
    if name in ("aten.mm", "aten.addmm"):
        a, b = (args[1], args[2]) if name == "aten.addmm" else args[:2]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("aten.bmm", "aten.baddbmm"):
        a, b = (args[1], args[2]) if name == "aten.baddbmm" else args[:2]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "aten.mv":
        return 2.0 * args[0].shape[0] * args[0].shape[1]
    return 2.0 * args[0].shape[0]  # aten.dot


def _wkv_eqns(r, k, v, lw, u, s0, chunk) -> None:
    """The equations of the reference's wkv scan body
    (``src/repro/models/rwkv.py::_wkv_chunk_ref``), issued on the first
    chunk of the site's (fake) tensors so the counter sees their classes
    and shapes: the profile's account of one trip.  Its three-operand
    einsum is contracted as the reference's is: the outer product r_t k_s
    per (b, h, i) as a product over a unit depth, then the sum over i
    against the decays."""
    rc, kc, vc, lwc = (t[:, :chunk].float() for t in (r, k, v, lw))
    s = s0.float()
    cum = torch.cumsum(lwc, dim=1)
    cum_excl = cum - lwc
    o_state = torch.einsum("bthi,bhij->bthj", rc * torch.exp(cum_excl), s)
    diff = cum_excl[:, :, None] - cum[:, None, :]
    pos = torch.arange(chunk, device=r.device)
    tri = pos[:, None] > pos[None, :]
    dec = torch.exp(torch.where(tri[None, :, :, None, None], diff, -1e30))
    outer = torch.matmul(rc.permute(0, 2, 3, 1)[..., None],
                         kc.permute(0, 2, 3, 1)[..., None, :])
    a = torch.einsum("bhits,btshi->btsh", outer, dec)
    o_intra = torch.einsum("btsh,bshj->bthj", a, vc)
    bonus = torch.einsum("bthi,bthi->bth", rc, u.float() * kc)
    o_diag = bonus[..., None] * vc
    # the reference's cum[:, -1] is a dynamic_slice, an eqn with bytes
    last = torch.full((1,), chunk - 1, dtype=torch.int64, device=r.device)
    dec_end = torch.exp(torch.index_select(cum, 1, last) - cum)
    s_decayed = torch.exp(torch.index_select(cum, 1, last)[:, 0])[..., None] * s
    s_decayed + torch.einsum("bthi,bthj->bhij", kc * dec_end, vc)
    o_state + o_intra + o_diag


class _Pending:
    """A product waiting for its first non-transparent consumer: the
    reference's ``_next_consumer`` over the dataflow.  ``stage`` is
    ``"add"`` (a mac if that consumer adds) or ``"act"`` (a fusedmac if
    the add's consumer is an activation)."""

    __slots__ = ("stage", "mult", "matmul", "done")

    def __init__(self, stage: str, mult: float, matmul: bool = False):
        self.stage, self.mult, self.matmul = stage, mult, matmul
        self.done = False


class _OpCounter(TorchDispatchMode):
    """The reference's ``_walk`` over the ATen ops as they are issued."""

    def __init__(self, prof: "PatternProfile"):
        super().__init__()
        self.prof = prof
        self.pending = WeakIdKeyDictionary()  # tensor -> [_Pending]
        self.unpadded = WeakIdKeyDictionary()  # padded tensor -> its source
        self.pad_bytes = WeakIdKeyDictionary()  # padded tensor -> pad's bytes
        self.prev_addi = False
        self.quiet = 0
        self.weight_next: int | None = None  # set by _EinsumOrder

    def pool(self, op, x, run):
        """A pool site's baseline as the reference's eqns: one windowed
        (or global) reduce, then for the averages a division by the window
        (the port's baseline slices taps and adds them)."""
        self.quiet += 1
        try:
            out = run()
        finally:
            self.quiet -= 1
        reduce = {"max": "reduce_window_max", "avg": "reduce_window_sum",
                  "global_avg": "reduce_sum"}[op]
        self._account(f"aten.{reduce}", [x], [out])
        if op != "max":
            self._account("aten.div", [out], [out])
        return out

    def wkv(self, args, kwargs, run):
        """A wkv site's baseline as the reference's ``lax.scan`` over its
        chunks: the baseline runs unrecorded, then :func:`_wkv_eqns` issues
        the reference's body once on chunk-shaped tensors, its ops counted
        times the trips, and the trips go to ``loop_iters``."""
        self.quiet += 1
        try:
            out = run()
        finally:
            self.quiet -= 1
        r, chunk = args[0], (args[6] if len(args) > 6 else kwargs["chunk"])
        trips = r.shape[1] // chunk
        outer = _mult()
        _add_trips(trips)
        _tls.mult = outer * trips
        try:
            _wkv_eqns(*args[:6], chunk)
        finally:
            _tls.mult = outer
        return out

    def _watch(self, tensors, rec: _Pending) -> None:
        for t in tensors:
            self.pending.setdefault(t, []).append(rec)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket)
        if (name == "aten.gelu" and kwargs.get("approximate") == "tanh"
                and not self.quiet):
            self.quiet += 1
            try:
                out = func(*args, **kwargs)
            finally:
                self.quiet -= 1
            with self:  # re-entered: the expansion's ops are recorded
                _gelu_tanh_eqns(args[0])
            return out
        out = func(*args, **kwargs)
        if name.startswith("aten.") and not self.quiet:  # not prim.device
            self._account(name, tree_leaves((args, kwargs)), tree_leaves(out),
                          args)
        return out

    def _account(self, name, leaves, outs, args=()):
        cls = _CLASS_OF.get(name, "other")
        ins = [t for t in leaves if isinstance(t, torch.Tensor)]
        outs = [t for t in outs if isinstance(t, torch.Tensor)]
        out = outs[0] if outs else None
        waiting = {id(r): r for t in ins for r in self.pending.get(t, ())
                   if not r.done}
        if cls == "transparent":
            for rec in waiting.values():
                self._watch(outs, rec)
            if name == "aten.constant_pad_nd":
                # the reference's jnp.pad moves its bytes (a pad of width 0
                # is no eqn), its conv's own padding none: a conv that
                # consumes the pad takes them back
                self.unpadded[out] = self.unpadded.get(args[0], args[0])
                if out.numel() != ins[0].numel():
                    self.pad_bytes[out] = _mult() * (_nbytes(ins[0])
                                                     + _nbytes(out))
                    self.prof.hbm_bytes += self.pad_bytes[out]
            elif name in _MOVES or (name == "aten._to_copy"
                                    and out.dtype != ins[0].dtype):
                # the reference's split and convert_element_type eqns
                # are not layout plumbing: they move their bytes
                self.prof.hbm_bytes += _mult() * sum(
                    _nbytes(t) for t in (ins[0], *outs))
            self.prev_addi = False
            return

        prof, mult = self.prof, _mult()
        c = prof.counts
        for rec in waiting.values():
            rec.done = True
            if rec.stage == "add" and cls == "add":
                c["mul_add(mac)"] += rec.mult
                if rec.matmul:
                    self._watch(outs, _Pending("act", rec.mult))
            elif rec.stage == "act" and cls == "act":
                c["fusedmac"] += rec.mult
        if name == "aten.convolution":  # the unpadded input, as the reference
            prof.hbm_bytes -= self.pad_bytes.pop(ins[0], 0.0)
            ins[0] = self.unpadded.get(ins[0], ins[0])
        in_bytes = sum(_nbytes(t) for t in ins)
        out_bytes = sum(_nbytes(t) for t in outs)
        prof.hbm_bytes += mult * _EQNS.get(name, 1) * (in_bytes + out_bytes)
        is_addi = False
        if cls == "matmul":
            fl = _matmul_flops(name, args, out)
            prof.flops += mult * fl
            prof.matmul_flops += mult * fl
            w = self.weight_next
            if w is None:
                w = _nbytes(args[_RHS.get(name, 1)])
            self.weight_next = None
            prof.weight_bytes += mult * w
            c["mul(mac)"] += mult
            c["conv" if name == "aten.convolution" else "dot"] += mult
            if name == "aten.convolution":
                prof.conv_flops += mult * fl
                lhs = ins[0]
                if lhs.ndim == 4:  # NCHW: a row of the NHWC input is W*C
                    row = int(lhs.shape[3] * lhs.shape[1]) or 1
                    prof.conv_strides[(1, row)] += mult * fl / 2.0
            bias = _BIASED.get(name)
            if bias is not None and args[bias] is not None:
                prof.flops += mult * out_bytes / 4  # the bias add
                c["add"] += mult
                c["mul_add(mac)"] += mult
                self._watch(outs, _Pending("act", mult))
            else:
                self._watch(outs, _Pending("add", mult, matmul=True))
        elif cls == "mul":
            prof.flops += mult * out_bytes / 4
            c["mul"] += mult
            self._watch(outs, _Pending("add", mult))
        elif cls == "add":
            prof.flops += mult * out_bytes / 4
            c["add"] += mult
            literals = [a for a in leaves if isinstance(a, (int, float))
                        and not isinstance(a, bool)]
            if literals:
                is_addi = True
                c["addi"] += mult
                for v in literals:
                    if isinstance(v, int):
                        prof.addi_values[v] += int(mult)
                if self.prev_addi:
                    c["addi_addi(add2i)"] += mult
        else:
            c[f"other:{name.removeprefix('aten.')}"] += mult * _EQNS.get(
                name, 1)
        self.prev_addi = is_addi


@dataclass
class PatternProfile:
    # instruction level (Fig 3 analogue)
    counts: Counter = field(default_factory=Counter)
    # literal operand values of scalar integer adds (Fig 4 analogue:
    # immediate-value distribution that sized the paper's 5/10-bit split)
    addi_values: Counter = field(default_factory=Counter)
    # (i1, i2) address-bump immediates of conv inner loops: (element step,
    # row stride) in int8 elements — what TVM's addi;addi pairs encode
    conv_strides: Counter = field(default_factory=Counter)
    # pattern-site level (bytes per fusable call site, pseudo-sites too)
    site_counts: Counter = field(default_factory=Counter)
    site_bytes: Counter = field(default_factory=Counter)
    flops: float = 0.0
    matmul_flops: float = 0.0
    conv_flops: float = 0.0  # conv share of matmul_flops
    hbm_bytes: float = 0.0
    weight_bytes: float = 0.0
    loop_iters: float = 0.0

    def as_costmodel_inputs(self) -> dict:
        """The cost model's inputs, the reference's keys and sources."""
        sb = self.site_bytes
        return {
            "flops": self.flops,
            "matmul_flops": self.matmul_flops,
            "conv_flops": self.conv_flops,
            "hbm_bytes": self.hbm_bytes,
            "weight_bytes": self.weight_bytes,
            "residual_norm_bytes": float(sb["residual_rmsnorm"]),
            "epilogue_bytes": 0.5 * float(sb["matmul_epilogue"]),
            # the conv bias/BN/act round-trips fused_conv keeps in-register
            "conv_epilogue_bytes": float(sb["conv_epilogue"]),
            # the depthwise share of matmul_flops (dw_mac lands at v2) and
            # the dw epilogue round-trips its kernel fuses
            "dw_flops": float(sb["dw_mac_flops"]),
            "dw_epilogue_bytes": float(sb["dw_epilogue"]),
            # the separable-block intermediate the fused kernel never writes
            "sep_intermediate_bytes": float(sb["sep_intermediate"]),
            # acc_mac: the skip-add round-trip fused into the epilogues,
            # and its standalone adds' rv32 issue slots
            "acc_bytes_saved": float(sb["acc_mac"]),
            "acc_flops": float(sb["acc_flops"]),
            # pool: window work (rv32 slots) and the bytes the int8 pooling
            # unit keeps off device memory at v2+
            "pool_flops": float(sb["pool_flops"]),
            "pool_saved_bytes": float(sb["pool_epilogue"] + sb["pool_int8"]),
            "attn_score_bytes": float(sb["attn_scores"]),
            # weight-less matmul shares (attention, wkv state), subsets of
            # matmul_flops that join the int8 rate only at v4
            "attn_flops": float(sb["attn_flops"]),
            "wkv_flops": float(sb["wkv_flops"]),
            # the res + x intermediate the add2i kernel keeps in-register
            "rmsnorm_epilogue_bytes": float(sb["rmsnorm_epilogue"]),
            "loop_iters": self.loop_iters,
        }

    def normalized_counts(self) -> dict:
        total = sum(self.counts.values()) or 1
        return {k: v / total for k, v in self.counts.items()}


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
                _OpCounter(prof) as counter, _EinsumOrder(counter):
            _tls.counter = counter
            try:
                fn(*fake, **kwargs)
            finally:
                _tls.counter = None
            prof.loop_iters = float(_tls.loop_iters)
            if prof.loop_iters:
                prof.counts["loop(blt)"] += prof.loop_iters
    for pattern, nbytes in sink:
        prof.site_counts[pattern] += 1
        prof.site_bytes[pattern] += nbytes
    return prof
