#!/usr/bin/env python3
"""The port's quickest proof on one CUDA card: build the kernels, hold each
against its plain PyTorch version, then serve ResNet50 and MobileNetV2 at v4.

    python3 chip_smoke.py

Phases (any failure ends the run with a traceback and a non-zero exit):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels of ``src/repro_torch/csrc`` (one nvcc call);
3a. before the script sets any TF32 flag: ResNet50 at v0 (the plain
   baselines) on the card with both TF32 flags on (cuDNN's default) must
   match the same forward on the CPU within relative L2 1e-4 and leave the
   flags as they were; the same forward with the baselines' full-f32 guard
   taken out is printed beside it, to show what TF32 does;
3. compile ResNet50 (full width, 64x64x3, random weights from seed 0) at v4
   with ``repro_torch.marvel.compile`` and run one batch-8 forward that
   records every kernel launch's inputs; each recorded call, plus the extra
   cases VGG16's 2x2/2 max pool and a conv with ``residual=``, is run
   through the kernel's wrapper and its plain version on the same inputs,
   compared within the stated tolerance and timed (device time from CUDA
   events, median of trials after warmup, L2 left warm) beside the one
   PyTorch call that computes the core op (``library_ms``, a yardstick the
   port never calls) and the bound (max of bytes / 3.35 TB/s and operations
   / the peak rate of their type);
3b. the same recorded batch-8 forward for MobileNetV2 at v4 (the slice's
   main path: every kernel timed), MobileNetV2 at v2 (the standalone
   depthwise kernel timed), MobileNetV1 at v4 and DenseNet121 at v4 (its
   pools timed: the first avg launches).  Every launch of every forward is
   held against its plain version; each forward runs with every launch
   counter set to 0 just before and read just after, and must launch each
   kernel as often as the reference dispatches it.  The per-launch
   tolerance must flag at least one separable-block launch when its
   contraction runs on TF32 operands (a planted fault).  The logits of the
   v2, MobileNetV1 and DenseNet121 forwards must match the same program on
   the CPU within the limits of ``E2E_LIMIT`` (noise responses printed
   beside), and a planted dropped act in the depthwise stage must exceed
   the limit of each mobile net's forward;
4. serve 32 ResNet50 requests through the async engine with every launch
   counter set to 0 just before: each batch must launch 20 fused_conv, 34
   matmul_epilogue, 1 windowed pool and 1 global-average pool kernels, take
   no plain fallback and add no bucket; one batch's logits must match the
   same program on the CPU (plain versions) within relative L2 2e-2 (the
   int8 path's response to 1-ulp noise, on the input and on every site's
   input, is printed beside it);
4b. the same for 32 MobileNetV2 requests at v4: 17 sep_block, 18
   matmul_epilogue, 1 fused_conv and 1 global-average pool launches per
   batch, logits within relative L2 1e-1 of the CPU program (its logits are
   ~1e-3 and cancel in the head, so one flipped int8 code moves them by a
   few 1e-2; the per-site noise response printed beside it shows how far).
   Planted faults in the separable block (its depthwise act dropped; its
   contraction on TF32 operands) are read against the same limit, and the
   first must exceed it;
5. the ``{"kernels": [...]}`` line and the ``{"ok": true, ...}`` last line.

After phase 3a, TF32 is off for every f32 product and convolution of the
plain versions and yardsticks (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32``), so they run in full f32.
"""
from __future__ import annotations

import asyncio
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "f32": 67e12}
BATCH = 8
N_REQUESTS = 32
F32_EPS = 1.1920929e-07
# logits on the card vs the same program on the CPU, per forward: two to
# three times the card's response to 1e-7 noise on every site's input
# (PERF.md)
E2E_LIMIT = {"resnet50 v4": 2e-2, "mobilenetv2 v4": 1e-1,
             "mobilenetv2 v2": 2e-1, "mobilenetv1 v4": 2e-2,
             "densenet121 v4": 1e-2}
V0_LIMIT = 1e-4  # the v0 forward on the card vs the CPU


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Device time of one call: the median over ``trials`` of the CUDA-event
    time of ``reps`` back-to-back calls, divided by ``reps``.  Each trial
    first queues a sleep kernel, so the host has enqueued the calls before
    the device reaches them and the events see device time, not the
    wrapper's Python overhead."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(nbytes: float, ops: dict[str, float]):
    """(bound ms, what bounds it, bytes ms, operations ms) of one call whose
    operations are ``{type: count}`` at the peak rate of each type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items()) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, t_bytes, t_ops


def f32_tol(k: int) -> float:
    """tol_from_acc(float32, K): f32 sums over K in another order."""
    return max(max(32, k) * F32_EPS * 8, 1e-5)


# ---------------------------------------------------------------------------
# one case per kernel call: wrapper vs plain, times, bound
# ---------------------------------------------------------------------------


def one_slice_ms(module, fn) -> float:
    """Time ``fn`` with the module's split-K policy forced to one slice of
    K: the GEMM-shaped kernels as they would run without split-K."""
    policy = module.split_k
    module.split_k = lambda tiles, k_iters, sms: 1
    try:
        return time_ms(fn)
    finally:
        module.split_k = policy


def untimed(label, err, tol, b):
    return label, err, tol, None, None, None, b


def conv_case(args, timed=True):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_conv as fc

    x, w, es, eb, res, stride, padding, act = args
    kw = dict(stride=stride, padding=padding, act=act)
    got = fc.fused_conv_int8(x, w, es, eb, res, **kw)
    want = fc.fused_conv_int8_plain(x, w, es, eb, res, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    err = (got - want).abs().max().item()
    m = got.numel() // got.shape[-1]
    k_red = w.shape[0] * w.shape[1] * w.shape[2]
    nbytes = (x.numel() + w.numel() + 8 * w.shape[-1] + 4 * got.numel()
              + (0 if res is None else 4 * res.numel()))
    b = bound(nbytes, {"int8": 2 * m * w.shape[-1] * k_red})
    label = (f"fused_conv x{tuple(x.shape)} w{tuple(w.shape)} s{stride} "
             f"{padding} {act}{' +res' if res is not None else ''}")
    tol = "rtol=atol=1e-5 (int32 sums exact)"
    if not timed:
        return untimed(label, err, tol, b)
    launch = lambda: fc._launch(x, w, es, eb, res, stride, padding, act)  # noqa: E731
    ms = time_ms(launch)
    ms1 = one_slice_ms(fc, launch)
    plain = time_ms(lambda: fc.fused_conv_int8_plain(x, w, es, eb, res, **kw),
                    reps=5)
    # yardstick: the conv alone in f32 (no epilogue), channels-last cuDNN
    kh = w.shape[0]
    xf = x.permute(0, 3, 1, 2).float().contiguous(
        memory_format=torch.channels_last)
    wf = w.permute(3, 2, 0, 1).float().contiguous(
        memory_format=torch.channels_last)
    lib_out = F.conv2d(xf, wf, stride=stride, padding=kh // 2)
    lib = (time_ms(lambda: F.conv2d(xf, wf, stride=stride, padding=kh // 2))
           if tuple(lib_out.permute(0, 2, 3, 1).shape) == tuple(got.shape)
           else None)
    return (f"{label} (one K slice: {ms1:.4f} ms)", err, tol, ms, plain, lib,
            b)


def gemm_case(args, timed=True):
    import torch
    from repro_torch.kernels import matmul_epilogue as me

    x2, w, es, eb, r2, act = args
    kw = dict(act=act, scale=es, shift=eb, residual=r2)
    got = me.matmul_epilogue(x2, w, **kw)
    want = me.matmul_epilogue_plain(x2, w, **kw)
    m, k = x2.shape
    n = w.shape[1]
    t = f32_tol(k)
    torch.testing.assert_close(got, want, rtol=t, atol=t)
    err = (got - want).abs().max().item()
    nbytes = 4 * (m * k + k * n + 2 * n + m * n
                  + (0 if r2 is None else m * n))
    b = bound(nbytes, {"f32": 2 * m * n * k})
    label = (f"matmul_epilogue M={m} K={k} N={n} {act}"
             f"{' +res' if r2 is not None else ''}")
    tol = f"rtol=atol={t:.2e} (f32 sum order, K={k})"
    if not timed:
        return untimed(label, err, tol, b)
    launch = lambda: me._launch(x2, w, es, eb, r2, act)  # noqa: E731
    ms = time_ms(launch)
    ms1 = one_slice_ms(me, launch)
    plain = time_ms(lambda: me.matmul_epilogue_plain(x2, w, **kw))
    lib = time_ms(lambda: torch.matmul(x2, w))
    return (f"{label} (one K slice: {ms1:.4f} ms)", err, tol, ms, plain, lib,
            b)


def pool_case(args, timed=True):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import pooling as pk

    x, k, stride, op = args
    got = pk.windowed_pool(x, k=k, stride=stride, op=op)
    want = pk.windowed_pool_plain(x, k=k, stride=stride, op=op)
    if op == "max":
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        tol = "equal"
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        tol = "rtol=1e-6"
    err = (got.float() - want.float()).abs().max().item()
    nbytes = x.numel() * x.element_size() + got.numel() * got.element_size()
    b = bound(nbytes, {"f32": got.numel() * k * k})
    label = f"windowed_pool {op} {k}x{k}/{stride} x{tuple(x.shape)}"
    if not timed:
        return untimed(label, err, tol, b)
    ms = time_ms(lambda: pk._launch_windowed(x, k, stride, op))
    plain = time_ms(lambda: pk.windowed_pool_plain(x, k=k, stride=stride,
                                                   op=op))
    xc = x.permute(0, 3, 1, 2)  # NHWC storage = channels-last NCHW view
    pool = F.max_pool2d if op == "max" else F.avg_pool2d
    lib = time_ms(lambda: pool(xc, k, stride))
    return label, err, tol, ms, plain, lib, b


def gap_case(args, timed=True):
    import torch
    from repro_torch.kernels import pooling as pk

    (x,) = args
    got = pk.global_avgpool(x)
    want = pk.global_avgpool_plain(x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    err = (got - want).abs().max().item()
    nbytes = x.numel() * x.element_size() + 4 * got.numel()
    b = bound(nbytes, {"f32": x.numel()})
    label, tol = (f"global_avgpool x{tuple(x.shape)}",
                  "rtol=atol=1e-6 (sum order)")
    if not timed:
        return untimed(label, err, tol, b)
    ms = time_ms(lambda: pk._launch_gap(x))
    plain = time_ms(lambda: pk.global_avgpool_plain(x))
    lib = time_ms(lambda: x.mean(dim=(1, 2)))
    return label, err, tol, ms, plain, lib, b


def dw_case(args, timed=True):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import depthwise_conv as dw

    x, w, es, eb, stride, padding, act = args
    kw = dict(stride=stride, padding=padding, act=act)
    got = dw.depthwise_conv_int8(x, w, es, eb, **kw)
    want = dw.depthwise_conv_int8_plain(x, w, es, eb, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    err = (got - want).abs().max().item()
    kh, kw_, c = w.shape
    nbytes = x.numel() + w.numel() + 8 * c + 4 * got.numel()
    b = bound(nbytes, {"int8": 2 * got.numel() * kh * kw_})
    label = (f"depthwise_conv x{tuple(x.shape)} k{kh}x{kw_} s{stride} "
             f"{padding} {act}")
    tol = "rtol=atol=1e-5 (int32 sums exact)"
    if not timed:
        return untimed(label, err, tol, b)
    ms = time_ms(lambda: dw._launch_dw(x, w, es, eb, stride, padding, act))
    plain = time_ms(lambda: dw.depthwise_conv_int8_plain(x, w, es, eb, **kw),
                    reps=5)
    # yardstick: the depthwise conv alone in f32, channels-last cuDNN
    xf = x.permute(0, 3, 1, 2).float().contiguous(
        memory_format=torch.channels_last)
    wf = w.permute(2, 0, 1).unsqueeze(1).float().contiguous(
        memory_format=torch.channels_last)
    conv = lambda: F.conv2d(xf, wf, stride=stride, padding=kh // 2,  # noqa: E731
                            groups=c)
    lib = (time_ms(conv) if tuple(conv().permute(0, 2, 3, 1).shape)
           == tuple(got.shape) else None)
    return label, err, tol, ms, plain, lib, b


def sep_case(args, timed=True):
    import torch
    from repro_torch.kernels import depthwise_conv as dw

    (x, wd, ds, db, wp, ps, pb, stride, padding, dw_act, pw_act) = args
    kw = dict(stride=stride, padding=padding, dw_act=dw_act, pw_act=pw_act)
    ops = (x, wd, ds, db, wp, ps, pb)
    got = dw.sep_block_int8(*ops, **kw)
    want = dw.sep_block_int8_plain(*ops, **kw)
    c, cout = wp.shape
    t = f32_tol(c)
    torch.testing.assert_close(got, want, rtol=t, atol=t)
    err = (got - want).abs().max().item()
    kh, kw_, _ = wd.shape
    m = got.numel() // cout
    nbytes = (x.numel() + wd.numel() + 8 * c + wp.numel() + 8 * cout
              + 4 * got.numel())
    b = bound(nbytes, {"int8": 2 * m * c * kh * kw_, "f32": 2 * m * c * cout})
    label = (f"sep_block x{tuple(x.shape)} C={c} Cout={cout} s{stride} "
             f"{padding} {dw_act}/{pw_act}")
    tol = f"rtol=atol={t:.2e} (f32 contraction over C={c}, sum order)"
    if not timed:
        return untimed(label, err, tol, b)
    ms = time_ms(lambda: dw._launch_sep(*ops, stride, padding, dw_act,
                                        pw_act))
    ms1 = one_slice_ms(dw, lambda: dw._launch_sep(*ops, stride, padding,
                                                  dw_act, pw_act))
    plain = time_ms(lambda: dw.sep_block_int8_plain(*ops, **kw), reps=5)
    return (f"{label} (one C slice: {ms1:.4f} ms)", err, tol, ms, plain,
            None, b)


KERNELS = {
    # name: (case fn, source, replaces, the forward its times are summed over)
    "fused_conv": (conv_case, "src/repro_torch/csrc/fused_conv.cu",
                   "src/repro/kernels/fused_conv.py:134", "resnet50 v4"),
    "matmul_epilogue": (gemm_case, "src/repro_torch/csrc/matmul_epilogue.cu",
                        "src/repro/kernels/matmul_epilogue.py:105",
                        "resnet50 v4"),
    "windowed_pool": (pool_case, "src/repro_torch/csrc/pooling.cu",
                      "src/repro/kernels/pooling.py:123", "resnet50 v4"),
    "global_avgpool": (gap_case, "src/repro_torch/csrc/pooling.cu",
                       "src/repro/kernels/pooling.py:160", "resnet50 v4"),
    "depthwise_conv": (dw_case, "src/repro_torch/csrc/depthwise_conv.cu",
                       "src/repro/kernels/depthwise_conv.py:107",
                       "mobilenetv2 v2"),
    "sep_block": (sep_case, "src/repro_torch/csrc/depthwise_conv.cu",
                  "src/repro/kernels/depthwise_conv.py:197",
                  "mobilenetv2 v4"),
}

# launches per batch-8 forward, as the reference dispatches them
PER_FORWARD = {
    "resnet50 v4": {"fused_conv": 20, "matmul_epilogue": 34,
                    "windowed_pool": 1, "global_avgpool": 1},
    "mobilenetv2 v4": {"sep_block": 17, "matmul_epilogue": 18,
                       "fused_conv": 1, "global_avgpool": 1},
    "mobilenetv2 v2": {"depthwise_conv": 17, "fused_conv": 18,
                       "global_avgpool": 1},
    "mobilenetv1 v4": {"sep_block": 13, "fused_conv": 1,
                       "matmul_epilogue": 1, "global_avgpool": 1},
    "densenet121 v4": {"fused_conv": 59, "matmul_epilogue": 62,
                       "windowed_pool": 4, "global_avgpool": 1},
}


def wrappers():
    from repro_torch.kernels import depthwise_conv as dw
    from repro_torch.kernels import fused_conv as fc
    from repro_torch.kernels import matmul_epilogue as me
    from repro_torch.kernels import pooling as pk

    return {"fused_conv": fc.fused_conv_int8,
            "matmul_epilogue": me.matmul_epilogue,
            "windowed_pool": pk.windowed_pool,
            "global_avgpool": pk.global_avgpool,
            "depthwise_conv": dw.depthwise_conv_int8,
            "sep_block": dw.sep_block_int8}


@contextlib.contextmanager
def counted():
    """Every launch counter set to 0 on entry; yields the dict the counts
    are read into on exit."""
    fns = wrappers()
    for fn in fns.values():
        fn.launches = 0
    counts: dict[str, int] = {}
    try:
        yield counts
    finally:
        counts.update({k: fn.launches for k, fn in fns.items()})


def record_launches(prog, x) -> tuple[dict[str, dict], dict[str, int]]:
    """One forward with every kernel launcher wrapped to record its inputs:
    ({kernel: {shape signature: [count, args]}}, launch counts of the
    forward, every counter set to 0 just before it)."""
    from repro_torch.kernels import depthwise_conv as dw
    from repro_torch.kernels import fused_conv as fc
    from repro_torch.kernels import matmul_epilogue as me
    from repro_torch.kernels import pooling as pk

    seen: dict[str, dict] = {k: {} for k in KERNELS}
    patched = [(fc, "_launch", "fused_conv"), (me, "_launch", "matmul_epilogue"),
               (pk, "_launch_windowed", "windowed_pool"),
               (pk, "_launch_gap", "global_avgpool"),
               (dw, "_launch_dw", "depthwise_conv"),
               (dw, "_launch_sep", "sep_block")]
    originals = []
    for mod, attr, name in patched:
        orig = getattr(mod, attr)
        originals.append((mod, attr, orig))

        def rec(*args, _orig=orig, _name=name):
            sig = tuple((tuple(a.shape), str(a.dtype))
                        if hasattr(a, "shape") else a for a in args)
            entry = seen[_name].setdefault(
                sig, [0, tuple(a.clone() if hasattr(a, "clone") else a
                               for a in args)])
            entry[0] += 1
            return _orig(*args)

        setattr(mod, attr, rec)
    try:
        with counted() as counts:
            prog(x)
    finally:
        for mod, attr, orig in originals:
            setattr(mod, attr, orig)
    return seen, counts


def hold(recorded, names, timed, extras=None):
    """Hold every recorded call of the ``names`` kernels (and ``extras``)
    against its plain version; with ``timed``, sum each launch's times over
    the forward."""
    extras = extras or {}
    results = {}
    for name in names:
        case_fn = KERNELS[name][0]
        rows = list(recorded[name].values())
        rows += [(0, args) for args in extras.get(name, [])]
        agg = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "t_bytes": 0.0, "t_ops": 0.0,
               "per_forward": sum(c for c, _ in rows)}
        for cnt, args in rows:
            label, err, tol, ms, plain, lib, (b_ms, by, tb, to) = case_fn(
                args, timed)
            times = ("" if ms is None else
                     f" ms={ms:.4f} plain_ms={plain:.4f} library_ms="
                     f"{'null' if lib is None else f'{lib:.4f}'}")
            log(f"  {label}: x{cnt}/forward max_abs_err={err:.3e} [{tol}]"
                f"{times} bound_ms={b_ms:.5f} ({by})")
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            if ms is not None:
                agg["ms"] += cnt * ms
                agg["plain_ms"] += cnt * plain
                agg["library_ms"] = (
                    None if lib is None or agg["library_ms"] is None
                    else agg["library_ms"] + cnt * lib)
            agg["t_bytes"] += cnt * tb
            agg["t_ops"] += cnt * to
        results[name] = agg
    return results


def check_counts(label, counts, batches=1):
    want = PER_FORWARD[label]
    for k in KERNELS:
        assert counts[k] == want.get(k, 0) * batches, (
            label, k, counts[k], want.get(k, 0), batches)


def extra_cases(dev):
    """Cases the ResNet50 path does not emit: VGG16's 2x2/2 max pool and a
    fused_conv with a residual operand (ResNet50 carries every residual on
    the GEMM)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randint(-127, 128, (BATCH, 8, 8, 128), generator=g,
                      dtype=torch.int8).to(dev)
    w = torch.randint(-127, 128, (3, 3, 128, 128), generator=g,
                      dtype=torch.int8).to(dev)
    es = (torch.rand(128, generator=g) * 1e-4).to(dev)
    eb = torch.randn(128, generator=g).to(dev)
    res = torch.randn((BATCH, 8, 8, 128), generator=g).to(dev)
    vgg = torch.randn((BATCH, 64, 64, 64), generator=g).to(dev)
    return {"fused_conv": [(x, w, es, eb, res, 1, "SAME", "relu")],
            "windowed_pool": [(vgg, 2, 2, "max")]}


def rel_l2(got, want) -> float:
    import torch

    return (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()


def model(name, dev):
    import torch
    from repro_torch.models.cnn import get_cnn

    init, apply, in_shape = get_cnn(name)
    return init(torch.Generator().manual_seed(0), device=dev), apply, in_shape


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def tf32_phase(dev):
    """3a: the v0 forward on the card with both TF32 flags on, against the
    CPU; the flags must come back as they were."""
    import numpy as np
    import torch
    from repro_torch import marvel
    from repro_torch.kernels import ref

    params, apply, in_shape = model("resnet50", "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (BATCH, *in_shape)).astype(np.float32))
    want = marvel.compile(apply, x, params=params, level="v0",
                          device="cpu")(x)
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    for f in flags:
        f.allow_tf32 = True
    prog = marvel.compile(apply, x, params=params, level="v0", device=dev)
    got = prog(x).cpu()
    assert [f.allow_tf32 for f in flags] == [True, True], "flags changed"
    rel = rel_l2(got, want)
    real_guard = ref.full_f32
    ref.full_f32 = contextlib.nullcontext  # the baselines as they were
    try:
        unguarded = rel_l2(prog(x).cpu(), want)
    finally:
        ref.full_f32 = real_guard
    log(f"resnet50 v0 on the card with TF32 flags on: relative L2 vs the CPU "
        f"{rel:.3e} (limit {V0_LIMIT:g}); without the full-f32 guard "
        f"{unguarded:.3e}")
    assert got.shape == (BATCH, 2) and torch.isfinite(got).all()
    assert rel <= V0_LIMIT, rel


def site_noise_response(prog, batch, got, seeds: int = 3) -> float:
    """The card program's largest response, over ``seeds`` draws, to 1e-7
    relative noise on the input of every dispatch site: the size of a
    sum-order difference in each layer, carried through the int8 path."""
    import torch
    from repro_torch.core import dispatch

    g = torch.Generator(device="cpu").manual_seed(3)
    orig = dispatch.call

    def noisy(pattern, baseline, x, *args, **kwargs):
        n = torch.randn(x.shape, generator=g).to(x.device)
        return orig(pattern, baseline, x * (1 + 1e-7 * n), *args, **kwargs)

    worst = 0.0
    dispatch.call = noisy
    try:
        for _ in range(seeds):
            worst = max(worst, rel_l2(prog(batch).cpu(), got))
    finally:
        dispatch.call = orig
    return worst


def tf32_round(t):
    """f32 rounded to TF32's 10-bit mantissa (to nearest, ties away)."""
    import torch

    return torch.bitwise_and(t.view(torch.int32) + 0x1000, -0x2000).view(
        torch.float32)


def sep_tf32_launch(x, wd, ds, db, wp, ps, pb, stride, padding, dw_act,
                    pw_act):
    """A wrong separable block: the plain version with its contraction on
    TF32 operands (f32 accumulation), as tensor cores would run it."""
    from repro_torch.kernels import depthwise_conv as dw
    from repro_torch.kernels import ref
    from repro_torch.kernels.common import EPILOGUE_ACTS

    acc = dw._dw_acc(x, wd, stride, padding)
    d = EPILOGUE_ACTS[dw_act](acc * ds + db)
    n, ho, wo, c = d.shape
    with ref.full_f32():
        y = tf32_round(d.reshape(-1, c)) @ wp.float()
    return EPILOGUE_ACTS[pw_act](y * ps + pb).reshape(n, ho, wo, -1)


def planted_faults(label):
    """Wrong launchers the logits check of ``label`` is read against:
    {fault: (launcher attribute of kernels.depthwise_conv, replacement,
    must the check catch it)}."""
    from repro_torch.kernels import depthwise_conv as dw

    sep, dwl = dw._launch_sep, dw._launch_dw
    if not label.startswith("mobilenet"):
        return {}
    if label == "mobilenetv2 v2":
        return {"depthwise_conv with its act dropped": (
            "_launch_dw", lambda *a: dwl(*a[:6], "none"), True)}
    return {
        "sep_block with its depthwise act dropped": (
            "_launch_sep", lambda *a: sep(*a[:9], "none", a[10]), True),
        "sep_block contracting in TF32": ("_launch_sep", sep_tf32_launch,
                                          False),
    }


def tf32_fault_holds(label, recorded) -> None:
    """The per-launch holds' power against a TF32 contraction: how many of
    the forward's recorded separable-block launches the stated tolerance
    flags when the contraction runs on TF32 operands; at least one must."""
    import torch
    from repro_torch.kernels import depthwise_conv as dw

    flagged = total = 0
    for cnt, args in recorded["sep_block"].values():
        x, wd, ds, db, wp, ps, pb, stride, padding, dw_act, pw_act = args
        want = dw.sep_block_int8_plain(
            x, wd, ds, db, wp, ps, pb, stride=stride, padding=padding,
            dw_act=dw_act, pw_act=pw_act)
        t = f32_tol(wp.shape[0])
        ok = torch.allclose(sep_tf32_launch(*args), want, rtol=t, atol=t)
        flagged += cnt * (not ok)
        total += cnt
    log(f"{label}: planted fault 'sep_block contracting in TF32': the "
        f"per-launch tolerance flags {flagged} of {total} launches")
    assert flagged > 0, "the per-launch holds miss a TF32 contraction"


def e2e_check(label, prog, apply, params_cpu, batch):
    """The card program's batch logits against the same program on the CPU
    (plain versions), beside the card's own response to 1e-7 noise; for
    the mobile nets, also the readings of planted faults."""
    import torch
    from repro_torch import marvel
    from repro_torch.kernels import depthwise_conv as dw

    cpu_prog = marvel.compile(apply, batch[:1].cpu(), params=params_cpu,
                              level=prog.level, backend="cuda", device="cpu")
    got = prog(batch).cpu()
    want = cpu_prog(batch.cpu())
    assert got.shape == (BATCH, 2) and torch.isfinite(got).all()
    rel = rel_l2(got, want)
    # the int8 path's own noise floor: on-the-fly per-tensor quantization
    # turns a 1-ulp change of an activation into a flipped int8 code now and
    # then, and the quantized layers amplify that; so kernels that sum in
    # another order than the CPU's cannot agree to 1e-3
    g = torch.Generator(device="cpu").manual_seed(2)
    noise = 1e-7 * torch.randn(batch.shape, generator=g).to(batch.device)
    floor = rel_l2(prog(batch * (1 + noise)).cpu(), got)
    sites = site_noise_response(prog, batch, got)
    limit = E2E_LIMIT[label]
    log(f"{label}: logits vs CPU plain path: relative L2 {rel:.3e} (limit "
        f"{limit:g}); response of the card's logits to 1e-7 relative input "
        f"noise {floor:.3e}, to 1e-7 relative noise on every site's input "
        f"(max of 3) {sites:.3e}")
    for fault, (attr, launch, caught) in planted_faults(label).items():
        real = getattr(dw, attr)
        setattr(dw, attr, launch)
        try:
            bad = rel_l2(prog(batch).cpu(), want)
        finally:
            setattr(dw, attr, real)
        log(f"{label}: planted fault '{fault}': relative L2 vs CPU "
            f"{bad:.3e} (limit {limit:g}, must be caught: {caught})")
        assert bad > limit or not caught, (fault, bad)
    assert rel <= limit, rel


def serve_phase(label, prog, apply, in_shape, params_cpu, card):
    """Serve N_REQUESTS through the async engine with the counts from 0;
    check the launches per batch, fallbacks, bucket misses and the logits
    against the same program on the CPU.  Returns the counts and the
    batch-8 forward's median wall time."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import random_images

    images = random_images(in_shape, N_REQUESTS)
    batch = torch.from_numpy(np.stack(images[:BATCH])).to(prog.device)
    engine = prog.serve(mode="async", max_batch=BATCH)
    fallbacks = []
    real_refs = {n: getattr(ref, n) for n in
                 ("fused_conv_ref", "matmul_epilogue_ref", "pool_ref",
                  "conv_nhwc")}
    for n, fn in real_refs.items():
        setattr(ref, n, lambda *a, _n=n, _f=fn, **k:
                fallbacks.append(_n) or _f(*a, **k))

    async def serve():
        async with engine:
            engine.warmup(in_shape)
            misses = prog.cache_misses
            batches0 = engine.batches_run
            with counted() as launches:
                t0 = time.perf_counter()
                done = await engine.submit_wave(images)
                dt = time.perf_counter() - t0
            return (done, dt, launches, engine.batches_run - batches0,
                    prog.cache_misses - misses, engine.metrics())

    try:
        done, dt, launches, n_batches, new_misses, metrics = asyncio.run(serve())
    finally:
        for n, fn in real_refs.items():
            setattr(ref, n, fn)
    assert len(done) == N_REQUESTS and all(r.done and r.error is None
                                           for r in done), "requests failed"
    assert metrics["errors"] == 0, metrics
    assert not fallbacks, f"plain fallbacks on the main path: {fallbacks}"
    assert new_misses == 0, f"{new_misses} bucket misses after warmup"
    check_counts(label, launches, n_batches)
    log(f"{label}: served {N_REQUESTS} requests in {n_batches} batches in "
        f"{dt * 1e3:.1f} ms: {N_REQUESTS / dt:.1f} req/s, "
        f"p50 {metrics['p50_latency_ms']:.2f} ms, "
        f"p99 {metrics['p99_latency_ms']:.2f} ms on {card}")
    log(f"{label}: launches on the main path: {launches}")

    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    e2e_check(label, prog, apply, params_cpu, batch)
    return launches, statistics.median(walls)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    # the package comes from this checkout's src/; without it, stop here
    # before printing anything
    from repro_torch.kernels import build

    dev = torch.device("cuda")

    # 1) the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2) build
    t0 = time.perf_counter()
    build.lib()
    how = ("reused an existing build" if build.build_seconds is None
           else f"nvcc {build.build_seconds:.1f} s")
    log(f"kernels ready in {time.perf_counter() - t0:.1f} s ({how}) -> "
        f"{build.library_path().name}")

    # 3a) the plain baselines in full f32 whatever the TF32 flags
    tf32_phase(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 3) compile ResNet50 at v4 and hold every main-path call's kernel
    # against its plain version
    from repro_torch import marvel
    from repro_torch.launch.serve import random_images

    params, apply, in_shape = model("resnet50", dev)
    x0 = torch.zeros((1, *in_shape), device=dev)
    prog = marvel.compile(apply, x0, params=params, level="v4")
    assert prog.model_class == "cnn", prog.model_class
    table = prog.resolved_extensions
    for pat in ("fused_conv", "matmul_epilogue", "pool"):
        assert table.get(pat) == "cuda", table
    log(f"compiled: {prog.summary()}")

    batch = torch.from_numpy(np.stack(
        random_images(in_shape, BATCH))).to(dev)
    recorded, counts = record_launches(prog, batch)
    check_counts("resnet50 v4", counts)
    results = hold(recorded, ("fused_conv", "matmul_epilogue",
                              "windowed_pool", "global_avgpool"),
                   timed=True, extras=extra_cases(dev))
    del recorded

    # 3b) the slice's forwards: every launch held against its plain version,
    # MobileNetV2 at v4 (all its kernels timed: the slice's main path) and
    # v2 (the depthwise kernel timed), DenseNet121's pools timed (the first
    # avg launches); the logits of each against the CPU program
    progs, path_counts, mbv2_times = {}, {}, {}
    for label, timed_names in (
            ("mobilenetv2 v4", ("sep_block", "matmul_epilogue", "fused_conv",
                                "global_avgpool")),
            ("mobilenetv2 v2", ("depthwise_conv",)),
            ("mobilenetv1 v4", ()),
            ("densenet121 v4", ("windowed_pool",))):
        name, level = label.split()
        p, a, shape = model(name, dev)
        mprog = marvel.compile(a, torch.zeros((1, *shape), device=dev),
                               params=p, level=level)
        log(f"compiled {label}: {mprog.summary()}")
        xb = torch.from_numpy(np.stack(random_images(shape, BATCH))).to(dev)
        rec, counts = record_launches(mprog, xb)
        check_counts(label, counts)
        path_counts[label] = counts
        log(f"{label}: launches per forward {counts}")
        res = hold(rec, timed_names, timed=True)
        hold(rec, [k for k in KERNELS if counts[k] and k not in timed_names],
             timed=False)
        if counts["sep_block"]:
            tf32_fault_holds(label, rec)
        del rec
        if label == "mobilenetv2 v4":
            mbv2_times = res
            progs[label] = (mprog, a, shape)
        else:
            e2e_check(label, mprog, a, model(name, "cpu")[0], xb)
        results.update({k: v for k, v in res.items()
                        if KERNELS[k][3] == label})

    # 4) the main paths: serve through the async engine, counts from 0
    params_cpu, _, _ = model("resnet50", "cpu")
    launches, wall = serve_phase("resnet50 v4", prog, apply, in_shape,
                                 params_cpu, card)
    kernel_ms = sum(results[k]["ms"] for k in PER_FORWARD["resnet50 v4"])
    log(f"resnet50 v4: batch-{BATCH} forward {wall:.2f} ms wall (median of "
        f"5), of which its kernels' device time {kernel_ms:.3f} ms")

    # 4b) MobileNetV2 at v4, the slice's serving path
    mprog, mapply, mshape = progs["mobilenetv2 v4"]
    mparams_cpu, _, _ = model("mobilenetv2", "cpu")
    mlaunches, mwall = serve_phase("mobilenetv2 v4", mprog, mapply, mshape,
                                   mparams_cpu, card)
    mkernel_ms = sum(r["ms"] for r in mbv2_times.values())
    log(f"mobilenetv2 v4: batch-{BATCH} forward {mwall:.2f} ms wall (median "
        f"of 5), of which its kernels' device time {mkernel_ms:.3f} ms ("
        + ", ".join(f"{k} {r['ms']:.4f}" for k, r in mbv2_times.items())
        + ")")

    # 5) the kernels line, then the device line
    path_launches = {k: launches[k] for k in PER_FORWARD["resnet50 v4"]}
    path_launches["sep_block"] = mlaunches["sep_block"]
    path_launches["depthwise_conv"] = path_counts["mobilenetv2 v2"][
        "depthwise_conv"]
    paths = {"sep_block": "mobilenetv2 v4 serve",
             "depthwise_conv": "mobilenetv2 v2 forward"}
    kernels = []
    for name, (_, source, replaces, forward) in KERNELS.items():
        agg = results[name]
        bound_ms = max(agg["t_bytes"], agg["t_ops"])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path_launches[name],
            "max_abs_err": agg["max_abs_err"], "ms": agg["ms"],
            "plain_ms": agg["plain_ms"], "bound_ms": bound_ms,
            "bound_by": "bytes" if agg["t_bytes"] >= agg["t_ops"]
            else "operations",
            "library_ms": agg["library_ms"],
            "forward": f"{forward} batch {BATCH}",
            "path": paths.get(name, "resnet50 v4 serve"),
        })
    log("(kernel times are per batch-8 forward, the one each entry names: "
        "the sum over its launches of each launch's median)")
    print(json.dumps({"kernels": kernels}), flush=True)
    assert all(math.isfinite(k["ms"]) and k["launches"] > 0 for k in kernels)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
