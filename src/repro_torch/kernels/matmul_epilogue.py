"""fusedmac: GEMM + bias + folded-BN affine (+ residual) + act in one kernel.

Replaces the TPU kernel ``src/repro/kernels/matmul_epilogue.py::_kernel``
(its ``pl.pallas_call`` at ``matmul_epilogue.py:105``); the CUDA kernel is
``csrc/matmul_epilogue.cu``, whose header says what bounds it on the H100
and how its tiling answers that.  The whole epilogue folds into one
per-column pair ``act(acc*es + eb [+ residual])`` with ``es = scale`` and
``eb = b*es + shift``, so the GEMM output is written to device memory once.
Operands are f32 (the CNNs) or bf16 (the LMs): the kernel reads bf16 in
place and sums in f32, so a bf16 weight is never copied or transposed.

The kernel has three forms, chosen by :func:`gemm_form` from the operands'
shapes, type and alignment alone (a plain predicate, no fallback):
``"fma"`` (CUDA-core f32 FMA tiles: every f32 GEMM, and bf16 operands the
tensor-core forms cannot take), ``"wgmma"`` (bf16 on tensor cores, TMA-fed,
M > :data:`DECODE_M_MAX`) and ``"decode"`` (bf16, M <= DECODE_M_MAX, bound
by reading w once).  The fma form writes f32, converted to x.dtype here;
the tensor-core forms write bf16 themselves.  The fma form's tile comes
from :func:`fma_tile` and its split of K from :func:`split_plan`, both
pure functions of the shape; it sums its K slices in the same launch,
counting them in on :func:`_counters`.

:func:`matmul_epilogue` is the wrapper: CPU tensors run
:func:`matmul_epilogue_plain`'s arithmetic, CUDA tensors launch the kernel
(``matmul_epilogue.launches`` counts the launches,
``matmul_epilogue.launches_by_form`` them per form).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (
    ACT_CODES, check_operand, runs_plain, split_k,
)
from repro_torch.kernels.ref import full_f32
from repro_torch.models.layers import ACTS

_INT32_MAX = 2**31 - 1
# each form's (rows, columns, K step) of one block's tile
# (csrc/matmul_epilogue.cu); the decode form's rows are all M, the fma
# form's rows one of FMA_TILES' (fma_tile)
TILES = {"fma": (None, 64, 32), "wgmma": (128, 128, 64),
         "decode": (None, 64, 64)}
FORMS = tuple(TILES)
# the fma form's tiles, by the index the kernel takes: (rows, rows a
# thread, stages of the cp.async ring, K step), 64 columns, each thread 4
# of them
FMA_TILES = ((128, 8, 3, 32), (64, 4, 4, 32), (32, 4, 4, 32), (16, 1, 6, 32),
             (64, 4, 6, 16), (32, 2, 8, 16), (16, 1, 8, 16))
FMA_MAX_SPLITS = 16  # the most slices of K a plan takes
DECODE_M_MAX = 16  # the decode form's widest M (wgmma n16)
WIDE_BN = 256  # the wgmma form's wide tile
WIDE_K_MIN = 8192  # ... for K at least this long


def wgmma_tile_n(m: int, k: int, n: int, sms: int) -> int:
    """The wgmma form's tile width: 256 columns where K is long and the
    128 x 256 tiles still number at least one per SM, else 128.  The wide
    tile runs one block an SM, whose epilogue nothing overlaps: on the H100
    it is faster only when the K loop is long (qwen3-8b's down projection,
    K = 12288: 0.30 against 0.40 ms; at K = 4096 0.15 against 0.13 ms and
    0.68 against 0.44 ms; PERF.md)."""
    wide = (k >= WIDE_K_MIN
            and -(-m // 128) * -(-n // WIDE_BN) >= sms)
    return WIDE_BN if wide else 128


def gemm_form(m: int, k: int, n: int, dtype, aligned: bool = True) -> str:
    """The form a CUDA launch of an (M, K) @ (K, N) GEMM takes: bf16
    operands with K and N multiples of 8 and 16-byte aligned bases (what TMA
    reads) go to the tensor cores, as ``"decode"`` up to M = DECODE_M_MAX
    rows and ``"wgmma"`` above; everything else, f32 above all (tensor
    cores would compute it in TF32), to ``"fma"``."""
    if dtype != torch.bfloat16 or k % 8 or n % 8 or not aligned:
        return "fma"
    return "decode" if m <= DECODE_M_MAX else "wgmma"


def launch_form(x2, w) -> str:
    """:func:`gemm_form` of the operands as :func:`_launch` will read them
    (a non-contiguous operand is copied, and a fresh copy is aligned)."""
    dt = x2.dtype if x2.dtype == w.dtype else torch.float32
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2, w)
                  if t.is_contiguous())
    return gemm_form(x2.shape[0], x2.shape[1], w.shape[1], dt, aligned)


# the fma form's cost model, in microseconds, fitted by least squares to
# every tile and split that tools/sweep_cnn_kernels.py timed on the H100
# at the CNN forwards' shapes (PERF.md): a launch, plus each K step
# of a slice at its tile's cost times the blocks an SM then runs (counted
# from two at once); for a split launch, its count-in, each round trip of
# the last block's sum (it loads 8 / TM slices at a time) and each slice
FMA_LAUNCH_US = 5.044
FMA_STEP_US = (2.321, 1.502, 1.193, 0.953, 0.914, 0.699, 0.574)
FMA_SPLIT_US = (0.383, 0.345, 0.116)
FMA_BLOCKS_AN_SM = 2
# (M, K, N) -> (tile, slices) where the same sweep timed a plan more than
# 3% faster than the model's (PERF.md); the model plans every other shape
FMA_TUNED = {(72, 384, 128): (3, 12), (128, 96, 576): (5, 3),
             (128, 1024, 256): (5, 16), (128, 1024, 512): (1, 8),
             (392, 480, 128): (5, 8), (512, 128, 512): (1, 2),
             (1800, 64, 128): (5, 1), (1800, 64, 256): (1, 1)}


def _fma_cost(m: int, n: int, k: int, sms: int, tile: int,
              splits: int) -> float:
    """The cost model's time of one fma launch in ``tile`` with ``splits``
    slices of K (32-deep steps)."""
    bm, tm, stages, bk = FMA_TILES[tile]
    blocks = -(-m // bm) * -(-n // TILES["fma"][1]) * splits
    per = -(-(-(-k // 32)) // splits) * 32
    steps = -(-min(k, per) // bk)
    threads = (bm // tm) * 16
    smem = stages * (bm * bk + bk * TILES["fma"][1]) * 4
    resident = min(FMA_BLOCKS_AN_SM, 2048 // threads, (227 << 10) // smem)
    load = max(1.0, blocks / (sms * resident))
    t = FMA_LAUNCH_US + FMA_STEP_US[tile] * steps * load
    if splits > 1:
        batch = 1 if tm >= 8 else 8 // tm
        t += (FMA_SPLIT_US[0] + FMA_SPLIT_US[1] * -(-splits // batch)
              + FMA_SPLIT_US[2] * splits)
    return t


def fma_plan(m: int, n: int, k: int, sms: int) -> tuple[int, int]:
    """(tile, slices of K) of an fma launch: :data:`FMA_TUNED`'s where the
    sweep timed this shape, else the pair the cost model rates fastest.  A
    tile may split K only into at most :data:`FMA_MAX_SPLITS` slices of
    whole 32-deep steps, none empty, and only where
    :func:`~repro_torch.kernels.common.split_k` splits its tile grid
    (fewer tiles than SMs, so every split launch has tile counters; a
    policy that never splits keeps every launch in one slice).  Cached per
    shape and split policy."""
    return _fma_plan(m, n, k, sms, split_k)


@functools.lru_cache(maxsize=4096)
def _fma_plan(m, n, k, sms, split_k) -> tuple[int, int]:
    k_iters = -(-k // 32)

    def may_split(tile):
        tiles = -(-m // FMA_TILES[tile][0]) * -(-n // TILES["fma"][1])
        # asked for a K long enough to split, split_k splits exactly the
        # grids of fewer tiles than SMs
        return split_k(tiles, 4 * FMA_MAX_SPLITS, sms) > 1

    tuned = FMA_TUNED.get((m, k, n))
    if tuned is not None and (tuned[1] == 1 or may_split(tuned[0])):
        return tuned
    best = None
    for t in range(len(FMA_TILES)):
        top = min(FMA_MAX_SPLITS, k_iters) if may_split(t) else 1
        for want in range(1, top + 1):
            splits = -(-k_iters // -(-k_iters // want))
            cost = _fma_cost(m, n, k, sms, t, splits)
            if best is None or cost < best[0]:
                best = (cost, t, splits)
    return best[1], best[2]


def fma_tile(m: int, n: int, k: int, sms: int) -> int:
    """The fma form's tile (an index into :data:`FMA_TILES`)."""
    return fma_plan(m, n, k, sms)[0]


def counter_slots(sms: int) -> int:
    """Tile counters the fma form's split-K needs at most: it splits only
    grids of fewer tiles than SMs."""
    return sms


def split_plan(form: str, m: int, n: int, k: int, sms: int):
    """(slices of K, K per slice, (tile rows, tile columns)) of a launch:
    the form's output tiles and K steps through
    :func:`~repro_torch.kernels.common.split_k`; the slices cover K, each a
    whole number of K steps and none empty.  The wgmma form splits only
    below half the SMs' worth of tiles: a wave it fills half of still runs
    faster than the workspace's round trip.  The fma form takes
    :func:`fma_plan`'s tile and slices, summed in the launch."""
    bm, bn, bk = TILES[form]
    if form == "fma":
        tile, splits = fma_plan(m, n, k, sms)
        k_iters = -(-k // bk)
        return splits, -(-k_iters // splits) * bk, (FMA_TILES[tile][0], bn)
    if form == "wgmma":
        bn = wgmma_tile_n(m, k, n, sms)
    tiles = -(-n // bn) * (1 if bm is None else -(-m // bm))
    k_iters = -(-k // bk)
    splits = split_k(tiles, k_iters, sms // 2 if form == "wgmma" else sms)
    return splits, -(-k_iters // splits) * bk, (bm, bn)


_COUNTERS: dict = {}


def _counters(device):
    """The fma form's split-K tile counters on ``device``: int32 zeros,
    allocated once (a launch leaves them 0), so no launch clears them and
    their address stays fixed."""
    key = device.index if device.index is not None else \
        torch.cuda.current_device()
    buf = _COUNTERS.get(key)
    if buf is None:
        buf = torch.zeros(counter_slots(build.sm_count(device)),
                          dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def _prepare(x, w, b, scale, shift, residual):
    n_out = w.shape[1]
    x2 = x.reshape(-1, x.shape[-1])
    f32 = dict(dtype=torch.float32, device=x.device)
    es = torch.ones(n_out, **f32) if scale is None else scale.float()
    eb = torch.zeros(n_out, **f32) if b is None else b.float() * es
    if shift is not None:
        eb = eb + shift.float()
    r2 = None if residual is None else residual.reshape(-1, n_out)
    return x2, es, eb, r2


def _plain(x2, w, es, eb, r2, act):
    with full_f32():
        y = (x2.float() @ w.float()) * es + eb
    if r2 is not None:
        y = y + r2.float()
    return ACTS[act](y)


_OPERAND_TYPES = (torch.float32, torch.bfloat16)


def _launch(x2, w, es, eb, r2, act, form=None):
    """The kernel on (M, K) @ (K, N) operands, in ``form`` (default
    :func:`launch_form`): read as they are when both are f32 or both bf16,
    else taken to f32 first; the residual likewise; the output is f32 from
    the fma form, bf16 from the tensor-core forms."""
    m, k = x2.shape
    n = w.shape[1]
    if max(m * n, m * k, k * n) > _INT32_MAX:
        raise ValueError(f"GEMM ({m}x{k}) @ ({k}x{n}) exceeds the kernel's "
                         f"32-bit indexing")
    form = form or launch_form(x2, w)
    if x2.dtype != w.dtype or x2.dtype not in _OPERAND_TYPES:
        x2, w = x2.float(), w.float()
    if r2 is not None and r2.dtype not in _OPERAND_TYPES:
        r2 = r2.float()
    dt = x2.dtype
    x2, w, es, eb = (x2.contiguous(), w.contiguous(), es.contiguous(),
                     eb.contiguous())
    r2 = None if r2 is None else r2.contiguous()
    check_operand(x2, "x", dt, (m, k))
    check_operand(w, "w", dt, (k, n))
    check_operand(es, "es", torch.float32, (n,))
    check_operand(eb, "eb", torch.float32, (n,))
    if r2 is not None:
        check_operand(r2, "residual", r2.dtype, (m, n))
    if form != "fma" and gemm_form(m, k, n, dt, x2.data_ptr() % 16 == 0
                                   and w.data_ptr() % 16 == 0) != form:
        raise ValueError(f"the {form} form cannot take ({m}x{k}) @ ({k}x{n}) "
                         f"{dt} operands")
    out = torch.empty((m, n), dtype=torch.float32 if form == "fma" else dt,
                      device=x2.device)
    sms = build.sm_count(x2.device)
    splits, per, (bm, bn) = split_plan(form, m, n, k, sms)
    # the kernel's form codes: FORMS' order, and 3 for the wgmma form's
    # 128x256 tiles
    code = 3 if form == "wgmma" and bn == WIDE_BN else FORMS.index(form)
    tile, counters, ws = 0, None, None
    if form == "fma":
        tile = fma_tile(m, n, k, sms)
        if splits > 1:
            tiles = -(-m // bm) * -(-n // bn)
            counters = _counters(x2.device)
            if tiles > counters.numel():
                raise ValueError(f"{tiles} split tiles exceed the "
                                 f"{counters.numel()} tile counters")
            ws = torch.empty(tiles * splits * bm * bn, dtype=torch.float32,
                             device=x2.device)
    elif splits > 1:
        ws = torch.empty((splits, m, n), dtype=torch.float32,
                         device=x2.device)
    with torch.cuda.device(x2.device):
        status = build.lib().marvel_matmul_epilogue(
            x2.data_ptr(), w.data_ptr(), es.data_ptr(), eb.data_ptr(),
            None if r2 is None else r2.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), m, n, k,
            splits, per, ACT_CODES[act], int(dt == torch.bfloat16),
            int(r2 is not None and r2.dtype == torch.bfloat16),
            code, tile, build.stream_ptr(x2.device))
    build.check("matmul_epilogue", status)
    return out


def matmul_epilogue_plain(x, w, b=None, act="none", scale=None, shift=None,
                          residual=None):
    """The plain PyTorch version of the kernel's function (f32 product, the
    same folded epilogue), on whatever device x lies."""
    x2, es, eb, r2 = _prepare(x, w, b, scale, shift, residual)
    y = _plain(x2, w, es, eb, r2, act)
    return y.to(x.dtype).reshape(*x.shape[:-1], w.shape[1])


def matmul_epilogue(x, w, b=None, act="none", scale=None, shift=None,
                    residual=None):
    """x: (..., K); w: (K, N); b/scale/shift: (N,) or None; residual:
    optional (..., N) skip tensor -> ``act((x@w + b)*scale + shift [+
    residual])`` in x.dtype, accumulated in f32.  An empty GEMM takes the
    exact plain path on any device."""
    x2, es, eb, r2 = _prepare(x, w, b, scale, shift, residual)
    if 0 in x2.shape or 0 in w.shape or runs_plain(x2, w, r2):
        y = _plain(x2, w, es, eb, r2, act)
    else:
        y = _launch(x2, w, es, eb, r2, act)
        matmul_epilogue.launches += 1
        matmul_epilogue.launches_by_form[launch_form(x2, w)] += 1
    return y.to(x.dtype).reshape(*x.shape[:-1], w.shape[1])


matmul_epilogue.launches = 0
matmul_epilogue.launches_by_form = dict.fromkeys(FORMS, 0)
