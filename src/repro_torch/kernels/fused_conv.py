"""conv_mac: int8 implicit-GEMM conv with the full epilogue fused.

Replaces the TPU kernel ``src/repro/kernels/fused_conv.py::_kernel`` (its
``pl.pallas_call`` at ``fused_conv.py:134``); the CUDA kernel is
``csrc/fused_conv.cu`` (int8 tensor-core tiles, ``csrc/imma.cuh``), whose
header says what bounds it on the H100 and how its design answers that.
The int8 x int8 -> int32 sums are exact; the per-channel dequant scale,
bias, BN affine and act are pre-folded by the caller into one
``(eff_scale, eff_bias)`` pair applied in f32, with the optional residual
(the ``acc_mac`` epilogue) added before the act.

The same kernel runs ``mac_matmul_int8`` (a GEMM is a 1x1 conv), so its
tiles (:data:`IMMA_TILES`) and their planner (:func:`imma_plan`) live
here: :func:`conv_plan` picks a launch's tile and split of K from its
shape; split K is summed in the same launch on the tile counters of
``matmul_epilogue._counters``.

:func:`fused_conv_int8` is the wrapper: CPU tensors run
:func:`fused_conv_int8_plain`, CUDA tensors launch the kernel
(``fused_conv_int8.launches`` counts the launches).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.common import (
    ACT_CODES, EPILOGUE_ACTS, check_operand, conv_out_size, runs_plain,
    same_pads, split_k,
)
from repro_torch.kernels.matmul_epilogue import _counters

_INT32_MAX = 2**31 - 1
BK = 64  # the K step of the kernel's staging ring (csrc/imma.cuh)
# the kernel's tiles, by the index it takes (csrc/fused_conv.cu): (rows,
# columns, a warp's rows, a warp's columns, stages of the ring); within one
# column width the tallest first
IMMA_TILES = ((128, 128, 64, 32, 5), (64, 128, 32, 32, 4),
              (16, 128, 16, 32, 4), (32, 64, 16, 32, 4), (16, 64, 16, 32, 4),
              (32, 32, 16, 32, 4), (16, 32, 16, 32, 4))
# the tiles built with a patch tile of byte loads, for contractions whose
# rows (Cin, or the GEMM's K) are not a multiple of 4 bytes: 32 rows by 64
# columns, or by 32 for N <= 32
BYTE_TILES = (3, 5)
# (M, K, N) -> (tile, slices) where tools/sweep_cnn_kernels.py --only conv
# timed a plan more than 3% faster than the rule's on the H100 (or the
# rule's plan untimed), among 32-wide tiles for N <= 32 (PERF.md): the
# batch-8 launches of ResNet50 and DenseNet121 at v4, MobileNetV2 at v2
CONV_TUNED = {(8, 1152, 32): (5, 6), (32, 576, 160): (3, 3),
              (32, 960, 160): (3, 8), (32, 960, 320): (3, 8),
              (32, 4608, 512): (3, 12), (72, 1152, 32): (5, 6),
              (128, 512, 1024): (3, 3), (128, 576, 96): (3, 3),
              (128, 2304, 256): (3, 12), (392, 1152, 32): (5, 6),
              (1800, 576, 64): (3, 3), (1800, 1152, 32): (5, 6)}


def imma_plan(m: int, n: int, k: int, sms: int, split_k, tuned=None,
              row: int | None = None) -> tuple[int, int]:
    """(tile, slices of K) of an int8 tensor-core launch of an (M, K) @
    (K, N) contraction whose A rows are gathered ``row`` bytes at a time
    (Cin for a conv, K for a GEMM; default K): ``tuned``'s where a sweep
    timed this shape, else the rule, fitted to the same sweep on the H100
    (tools/sweep_cnn_kernels.py --only conv,mac; PERF.md): 32 rows by 64
    columns, or by 32 for N <= 32; 16 rows for M <= 16; and where the
    32-row grid has 8 tiles an SM or more, the tallest 128-wide tile whose
    grid still has a tile for every SM.  A ``row`` not a multiple of 4
    (byte loads) takes one of :data:`BYTE_TILES`.  K is split as
    ``split_k`` splits the tile grid.  Either way the plan splits exactly
    where ``split_k`` splits its tile grid (only grids of fewer tiles than
    SMs, so every split launch has tile counters), into slices of whole
    64-deep steps, none empty, and N <= 32 runs in 32-wide tiles."""
    k_iters = max(1, -(-k // BK))
    byte_gather = (k if row is None else row) % 4 != 0

    def grid(t):
        bm, bn = IMMA_TILES[t][:2]
        return -(-m // bm) * -(-n // bn)

    def tile_of(bm, bn):
        return IMMA_TILES.index(next(t for t in IMMA_TILES
                                     if t[:2] == (bm, bn)))

    hit = (tuned or {}).get((m, k, n))
    if hit is not None:
        t, s = hit
        if ((split_k(grid(t), k_iters, sms) > 1) == (s > 1) and s <= k_iters
                and (t in BYTE_TILES or not byte_gather)
                and (n > 32 or IMMA_TILES[t][1] == 32)):
            return t, -(-k_iters // -(-k_iters // s))
    bn = 32 if n <= 32 else 64
    if byte_gather:
        t = BYTE_TILES[1] if bn == 32 else BYTE_TILES[0]
    else:
        t = tile_of(16 if m <= 16 else 32, bn)
        if grid(t) >= 8 * sms:
            wide = [i for i, (bm, tbn, *_) in enumerate(IMMA_TILES)
                    if tbn == 128 and bm <= -(-m // 16) * 16]
            t = next((i for i in wide if grid(i) >= sms), wide[-1])
    return t, split_k(grid(t), k_iters, sms)


def conv_plan(m: int, n: int, k: int, sms: int,
              cin: int | None = None) -> tuple[int, int]:
    """(tile, slices of K) of a conv launch with M output pixels, N = Cout,
    K = KH*KW*Cin and ``cin`` input channels (default K): :func:`imma_plan`
    with :data:`CONV_TUNED`, through this module's ``split_k`` (a policy
    that never splits keeps every launch in one slice).  Cached per shape
    and split policy."""
    return _conv_plan(m, n, k, sms, split_k, k if cin is None else cin)


@functools.lru_cache(maxsize=4096)
def _conv_plan(m, n, k, sms, split_k, cin):
    return imma_plan(m, n, k, sms, split_k, CONV_TUNED, row=cin)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned base (a fresh copy where a
    view's offset breaks it): the kernel picks its copy width from the row
    length alone, so the plan's tile always matches it."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def split_operands(device, m: int, n: int, k: int, tile: int, splits: int):
    """(K per slice, int32 partials or None, tile counters or None) of a
    launch of an (M, K) @ (K, N) contraction in ``tile`` with ``splits``
    slices of K."""
    bm, bn = IMMA_TILES[tile][:2]
    per = -(-(-(-k // BK)) // splits) * BK
    if splits == 1:
        return per, None, None
    tiles = -(-m // bm) * -(-n // bn)
    counters = _counters(device)
    if tiles > counters.numel():
        raise ValueError(f"{tiles} split tiles exceed the {counters.numel()} "
                         f"tile counters")
    ws = torch.empty(tiles * splits * bm * bn, dtype=torch.int32,
                     device=device)
    return per, ws, counters


def _geometry(x_int8, w_int8, stride, padding):
    n, h, w_in, cin = x_int8.shape
    kh, kw, wcin, cout = w_int8.shape
    if wcin != cin:
        raise ValueError(f"weights take {wcin} input channels, x has {cin}")
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    ho = conv_out_size(h, kh, stride, padding)
    wo = conv_out_size(w_in, kw, stride, padding)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"degenerate conv output {ho}x{wo}")
    return ho, wo, same_pads(h, kh, stride, padding), same_pads(
        w_in, kw, stride, padding)


def fused_conv_int8_plain(x_int8, w_int8, eff_scale, eff_bias, residual=None,
                          *, stride=1, padding="SAME", act="none"):
    """The plain PyTorch version: an exact integer conv (float64 holds every
    int32 sum exactly; float32 would not once K*127^2 passes 2^24), rounded
    to f32 as the kernel's int32 accumulator is, then the f32 epilogue."""
    _, _, (top, bottom), (left, right) = _geometry(x_int8, w_int8, stride,
                                                   padding)
    xc = F.pad(x_int8.permute(0, 3, 1, 2).double(), (left, right, top, bottom))
    acc = F.conv2d(xc, w_int8.permute(3, 2, 0, 1).double(), stride=stride)
    y = acc.permute(0, 2, 3, 1).float() * eff_scale.float() + eff_bias.float()
    if residual is not None:
        y = y + residual.float()
    return EPILOGUE_ACTS[act](y)


def _launch(x_int8, w_int8, eff_scale, eff_bias, residual, stride, padding,
            act):
    n, h, w_in, cin = x_int8.shape
    kh, kw, _, cout = w_int8.shape
    ho, wo, (top, _), (left, _) = _geometry(x_int8, w_int8, stride, padding)
    if max(x_int8.numel(), n * ho * wo * cout, w_int8.numel()) > _INT32_MAX:
        raise ValueError("conv exceeds the kernel's 32-bit indexing")
    x_int8, w_int8 = aligned(x_int8), aligned(w_int8)
    es, eb = eff_scale.float().contiguous(), eff_bias.float().contiguous()
    check_operand(x_int8, "x_int8", torch.int8, (n, h, w_in, cin))
    check_operand(w_int8, "w_int8", torch.int8, (kh, kw, cin, cout))
    check_operand(es, "eff_scale", torch.float32, (cout,))
    check_operand(eb, "eff_bias", torch.float32, (cout,))
    rf = None
    if residual is not None:
        rf = residual.float().contiguous()
        check_operand(rf, "residual", torch.float32, (n, ho, wo, cout))
    out = torch.empty((n, ho, wo, cout), dtype=torch.float32,
                      device=x_int8.device)
    m, k_red = n * ho * wo, kh * kw * cin
    tile, splits = conv_plan(m, cout, k_red, build.sm_count(x_int8.device),
                             cin)
    per, ws, counters = split_operands(x_int8.device, m, cout, k_red, tile,
                                       splits)
    with torch.cuda.device(x_int8.device):
        status = build.lib().marvel_fused_conv(
            x_int8.data_ptr(), w_int8.data_ptr(), es.data_ptr(),
            eb.data_ptr(), None if rf is None else rf.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), n, h, w_in,
            cin, kh, kw, cout, ho, wo, stride, top, left, tile, splits, per,
            ACT_CODES[act], build.stream_ptr(x_int8.device))
    build.check("fused_conv", status)
    return out


def fused_conv_int8(x_int8, w_int8, eff_scale, eff_bias, residual=None, *,
                    stride=1, padding="SAME", act="none"):
    """x: (N, H, W, Cin) int8; w: (KH, KW, Cin, Cout) int8; eff_scale /
    eff_bias: (Cout,) f32; residual: optional (N, Ho, Wo, Cout) ->
    ``act(acc*eff_scale + eff_bias [+ residual])`` as (N, Ho, Wo, Cout)
    f32.  Acts: none, relu, relu6."""
    if act not in EPILOGUE_ACTS:
        raise ValueError(f"fused_conv epilogue has no act {act!r}")
    if runs_plain(x_int8, w_int8, eff_scale, eff_bias, residual):
        return fused_conv_int8_plain(x_int8, w_int8, eff_scale, eff_bias,
                                     residual, stride=stride,
                                     padding=padding, act=act)
    out = _launch(x_int8, w_int8, eff_scale, eff_bias, residual, stride,
                  padding, act)
    fused_conv_int8.launches += 1
    return out


fused_conv_int8.launches = 0
