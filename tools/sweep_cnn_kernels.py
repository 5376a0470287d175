#!/usr/bin/env python3
"""Sweep the tile choices of the CNN path's kernels on the card: the f32
GEMM's ``fma`` form (every tile of ``FMA_TILES`` at every split of K),
``depthwise_conv_int8`` (bands of output rows and groups of channels),
``sep_block_int8`` (every tile of ``SEP_TILES`` at every split of C) and
the int8 tensor-core kernel (every tile of ``fused_conv.IMMA_TILES`` at
every split of K its plan may take), at every distinct shape the CNN
forwards give them at batch 8 (the int8 conv: the launches of ResNet50 and
DenseNet121 at v4 and MobileNetV2 at v2, recorded on the card;
``mac_matmul_int8``: ``chip_smoke.MAC_CASES``).  Every configuration is
held against the plain version (the GEMM and the separable block within
``chip_smoke.gemm_hold_tol`` / ``sep_tol``, the int8 conv within 1e-5,
the depthwise and mac sums exactly) and timed as ``chip_smoke.py`` times a
kernel, beside the configuration the wrappers pick and the library call
(``torch.matmul``, cuDNN's depthwise or f32 conv, ``torch._int_mm``, for
the separable block the unfused pair ``chip_smoke.sep_pair_ms``).

    python3 tools/sweep_cnn_kernels.py [--out build/sweep_cnn_kernels.json]
                                       [--only gemm,depthwise,sep,conv,mac]

Needs a CUDA card; prints one line per shape and writes every reading to
the JSON file.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

BATCH = 8
GEMM_MODELS = ("resnet50", "mobilenetv2", "densenet121", "mobilenetv1")
DW_MODELS = ("mobilenetv2", "mobilenetv1")
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)


def site_counts(model, pattern):
    """{(x shape, w shape): launches} of a batch-8 forward's sites."""
    import torch
    from repro_torch.core import profiler
    from repro_torch.models.cnn import get_cnn

    init, apply, in_shape = get_cnn(model)
    gen = torch.Generator().manual_seed(0)
    sites = profiler.site_shapes(
        lambda: apply(init(gen), torch.zeros((BATCH, *in_shape))), pattern)
    counts: dict = {}
    for _, (xs, _), (ws, _) in sites:
        counts[(xs, ws)] = counts.get((xs, ws), 0) + 1
    return counts


def sweep_gemm(dev, sms, every=1):
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import matmul_epilogue as me

    shapes: dict = {}
    for model in GEMM_MODELS:
        for i, ((xs, ws), cnt) in enumerate(
                site_counts(model, "matmul_epilogue").items()):
            if model == "densenet121" and i % every:
                continue
            m = int(np.prod(xs[:-1]))
            key = (m, ws[0], ws[1])
            shapes.setdefault(key, {})[model] = cnt
    rows = []
    rng = np.random.default_rng(0)
    plan, tile_of, slots = me.split_plan, me.fma_tile, me.counter_slots
    me.counter_slots = lambda s: 8 * s
    me._COUNTERS.clear()
    try:
        for (m, k, n), users in sorted(shapes.items()):
            x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(dev)
            w = torch.from_numpy(rng.standard_normal((k, n), np.float32)
                                 / np.float32(np.sqrt(k))).to(dev)
            es = torch.from_numpy(0.5 + rng.random(n, np.float32)).to(dev)
            eb = torch.from_numpy(rng.standard_normal(n, np.float32)).to(dev)
            want = me._plain(x, w, es, eb, None, "relu")
            tol = cs.gemm_hold_tol(x, w, es, eb, None, want, torch.float32)
            picked = (tile_of(m, n, k, sms), plan("fma", m, n, k, sms)[0])
            launch = lambda: me._launch(x, w, es, eb, None, "relu")  # noqa: E731
            lib = cs.time_ms(lambda: torch.matmul(x, w), trials=3)
            times = {}
            k_iters = -(-k // 32)
            for t, (bm, *_) in enumerate(me.FMA_TILES):
                tiles = -(-m // bm) * -(-n // 64)
                for s in SPLITS:
                    per = -(-k_iters // s)
                    if s > k_iters or (s - 1) * per >= k_iters:
                        continue
                    if s > 1 and tiles > me.counter_slots(sms):
                        continue
                    me.fma_tile = lambda *a, _t=t: _t
                    me.split_plan = (lambda form, *a, _s=s, _p=per * 32,
                                     _b=bm: (_s, _p, (_b, 64)))
                    got = launch()
                    again = launch()
                    err, ratio = cs.held(got, want, tol)
                    assert ratio <= 1.0, (m, k, n, t, s, err, ratio)
                    assert torch.equal(got, again), (m, k, n, t, s)
                    times[f"{t}/{s}"] = cs.time_ms(launch, trials=3)
            me.fma_tile, me.split_plan = tile_of, plan
            ms = cs.time_ms(launch, trials=3)
            best = min(times, key=times.get)
            row = {"m": m, "k": k, "n": n, "users": users,
                   "picked": f"{picked[0]}/{picked[1]}", "picked_ms": ms,
                   "best": best, "best_ms": times[best], "library_ms": lib,
                   "times": times}
            rows.append(row)
            print(f"gemm M={m} K={k} N={n} {users}: picked {row['picked']} "
                  f"{ms:.4f} ms, best {best} {times[best]:.4f} ms, "
                  f"torch.matmul {lib:.4f} ms", flush=True)
    finally:
        me.fma_tile, me.split_plan, me.counter_slots = tile_of, plan, slots
        me._COUNTERS.clear()
    return rows


def sweep_dw(dev, sms):
    import numpy as np
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import depthwise_conv as dw

    shapes: dict = {}
    for model in DW_MODELS:
        for (xs, ws), cnt in site_counts(model, "depthwise_conv").items():
            shapes.setdefault((xs, ws), {})[model] = cnt
    rows = []
    rng = np.random.default_rng(1)
    pick = dw.dw_tile
    try:
        for (xs, ws), users in sorted(shapes.items()):
            # the sites' stride is not in the shapes: the models' 2-stride
            # blocks are recorded by the profiler's own call order; time both
            for stride in (1, 2):
                n, h, w_in, c = xs
                kh, kw = ws[0], ws[1]
                x = torch.from_numpy(rng.integers(-127, 128, xs, np.int8)).to(dev)
                w = torch.from_numpy(rng.integers(-127, 128, (kh, kw, c),
                                                  np.int8)).to(dev)
                es = torch.from_numpy(rng.random(c, np.float32) * 1e-3).to(dev)
                eb = torch.from_numpy(rng.standard_normal(c, np.float32)).to(dev)
                args = (x, w, es, eb, stride, "SAME", "relu6")
                want = dw.depthwise_conv_int8_plain(
                    x, w, es, eb, stride=stride, padding="SAME", act="relu6")
                ho = want.shape[1]
                picked = pick(n, ho, want.shape[2], c, kh, kw, stride, sms)
                times = {}
                for cg in (16, 32, 64):
                    for th in (1, 2, 4, 8):
                        if th > ho or dw.dw_smem(th, cg, want.shape[2], kh, kw,
                                                 stride) > dw.DW_SMEM_MAX:
                            continue
                        dw.dw_tile = lambda *a, _t=(th, cg): _t
                        got = dw._launch_dw(*args)
                        torch.testing.assert_close(got, want, rtol=1e-5,
                                                   atol=1e-5)
                        times[f"{th}/{cg}"] = cs.time_ms(
                            lambda: dw._launch_dw(*args), trials=3)
                dw.dw_tile = pick
                ms = cs.time_ms(lambda: dw._launch_dw(*args), trials=3)
                xf = x.permute(0, 3, 1, 2).float().contiguous(
                    memory_format=torch.channels_last)
                wf = w.permute(2, 0, 1).unsqueeze(1).float().contiguous(
                    memory_format=torch.channels_last)
                lib = cs.time_ms(lambda: F.conv2d(
                    xf, wf, stride=stride, padding=kh // 2, groups=c),
                    trials=3)
                best = min(times, key=times.get)
                row = {"x": list(xs), "k": [kh, kw], "stride": stride,
                       "users": users, "picked": f"{picked[0]}/{picked[1]}",
                       "picked_ms": ms, "best": best,
                       "best_ms": times[best], "library_ms": lib,
                       "times": times}
                rows.append(row)
                print(f"depthwise x{tuple(xs)} k{kh}x{kw} s{stride} {users}: "
                      f"picked {row['picked']} {ms:.4f} ms, best {best} "
                      f"{times[best]:.4f} ms, cuDNN {lib:.4f} ms", flush=True)
    finally:
        dw.dw_tile = pick
    return rows


def sep_shapes(model):
    """{(x shape, Cout, stride): launches} of a batch-8 forward's separable
    blocks at v4, recorded over fake tensors."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import dispatch
    from repro_torch.models.cnn import get_cnn

    init, apply, in_shape = get_cnn(model)
    counts: dict = {}
    inner = dispatch.call

    def record(pattern, baseline, *args, **kwargs):
        if pattern == "sep_block":
            key = (tuple(args[0].shape), args[2].shape[-1],
                   kwargs.get("stride", 1))
            counts[key] = counts.get(key, 0) + 1
        return inner(pattern, baseline, *args, **kwargs)

    dispatch.call = record
    try:
        with FakeTensorMode(allow_non_fake_inputs=True), \
                dispatch.use_table(dispatch.EMPTY_TABLE):
            apply(init(torch.Generator().manual_seed(0)),
                  torch.zeros((BATCH, *in_shape)))
    finally:
        dispatch.call = inner
    return counts


def sweep_sep(dev, sms):
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import depthwise_conv as dw
    from repro_torch.kernels import matmul_epilogue as me

    shapes: dict = {}
    for model in DW_MODELS:
        for key, cnt in sep_shapes(model).items():
            shapes.setdefault(key, {})[model] = cnt
    rows = []
    rng = np.random.default_rng(2)
    plan = dw.sep_plan
    try:
        for (xs, cout, stride), users in sorted(shapes.items()):
            n, h, w_in, c = xs
            x = torch.from_numpy(rng.integers(-127, 128, xs, np.int8)).to(dev)
            wd = torch.from_numpy(rng.integers(-127, 128, (3, 3, c),
                                               np.int8)).to(dev)
            ds = torch.from_numpy(rng.random(c, np.float32) * 1e-5).to(dev)
            db = torch.from_numpy(rng.standard_normal(c, np.float32)).to(dev)
            wp = torch.from_numpy(rng.integers(-127, 128, (c, cout),
                                               np.int8)).to(dev)
            ps = torch.from_numpy(rng.random(cout, np.float32) * 1e-3).to(dev)
            pb = torch.from_numpy(rng.standard_normal(cout, np.float32)).to(dev)
            args = (x, wd, ds, db, wp, ps, pb, stride, "SAME", "relu6", "none")
            want = dw.sep_block_int8_plain(*args[:7], stride=stride,
                                           padding="SAME", dw_act="relu6",
                                           pw_act="none")
            tol = cs.sep_tol(args, want)
            m = want.numel() // cout
            picked = plan(m, c, cout, sms)
            chunks = -(-c // dw.SEP_C)
            times = {}
            for bm, bn in dw.SEP_TILES:
                tiles = -(-m // bm) * -(-cout // bn)
                for want_s in (1, 2, 3, 4, 6, 8, 12, 16, 32):
                    per = -(-chunks // want_s)
                    splits = -(-chunks // per)
                    if splits != want_s or (splits > 1 and tiles >
                                            me.counter_slots(sms)):
                        continue
                    dw.sep_plan = lambda *a, _p=(bm, bn, splits, per): _p
                    got = dw._launch_sep(*args)
                    err, ratio = cs.held(got, want, tol)
                    assert ratio <= 1.0, (xs, cout, bm, bn, splits, ratio)
                    assert torch.equal(got, dw._launch_sep(*args))
                    times[f"{bm}x{bn}/{splits}"] = cs.time_ms(
                        lambda: dw._launch_sep(*args), trials=3)
            dw.sep_plan = plan
            ms = cs.time_ms(lambda: dw._launch_sep(*args), trials=3)
            lib = cs.sep_pair_ms(args)
            best = min(times, key=times.get)
            row = {"x": list(xs), "cout": cout, "stride": stride,
                   "users": users,
                   "picked": f"{picked[0]}x{picked[1]}/{picked[2]}",
                   "picked_ms": ms, "best": best, "best_ms": times[best],
                   "library_ms": lib, "times": times}
            rows.append(row)
            print(f"sep_block x{tuple(xs)} Cout={cout} s{stride} {users}: "
                  f"picked {row['picked']} {ms:.4f} ms, best {best} "
                  f"{times[best]:.4f} ms, cuDNN + torch.matmul {lib:.4f} ms",
                  flush=True)
    finally:
        dw.sep_plan = plan
    return rows


def imma_configs(m, n, k, sms, row):
    """(tile, slices) pairs an int8 tensor-core plan may take at this
    shape: every tile (those of ``BYTE_TILES`` where rows of ``row`` bytes
    take byte loads), split exactly where ``split_k`` splits its grid, into
    whole 64-deep steps, none empty."""
    from repro_torch.kernels import common
    from repro_torch.kernels import fused_conv as fc

    k_iters = max(1, -(-k // fc.BK))
    for t, (bm, bn, *_) in enumerate(fc.IMMA_TILES):
        if row % 4 and t not in fc.BYTE_TILES:
            continue
        grid = -(-m // bm) * -(-n // bn)
        may = common.split_k(grid, k_iters, sms) > 1
        for s in (SPLITS + (24, 32)) if may else (1,):
            if s == 1 and may or s > k_iters:
                continue
            if -(-k_iters // -(-k_iters // s)) == s:
                yield t, s


def sweep_imma(name, cases, module, plan_attr, launch, sms, lib_ms):
    """Time every config of ``imma_configs`` on each case ((M, N, K, bytes
    a row of A), the launch's arguments, its users); ``launch(args,
    check)`` runs the wrapper's launch, with ``check`` held against the
    plain version and a second launch."""
    import chip_smoke as cs

    rows = []
    plan = getattr(module, plan_attr)
    try:
        for (m, n, k, row), args, users in cases:
            picked = (plan(m, n, k, sms, row) if plan_attr == "conv_plan"
                      else plan(m, n, k, sms))
            times = {}
            for t, s in imma_configs(m, n, k, sms, row):
                setattr(module, plan_attr, lambda *a, _p=(t, s): _p)
                launch(args, check=True)
                times[f"{t}/{s}"] = cs.time_ms(lambda: launch(args),
                                               trials=3)
            setattr(module, plan_attr, plan)
            ms = cs.time_ms(lambda: launch(args), trials=3)
            best = min(times, key=times.get)
            row = {"m": m, "k": k, "n": n, "users": users,
                   "picked": f"{picked[0]}/{picked[1]}", "picked_ms": ms,
                   "best": best, "best_ms": times[best],
                   "library_ms": lib_ms(args), "times": times}
            rows.append(row)
            print(f"{name} M={m} K={k} N={n} {users}: picked "
                  f"{row['picked']} {ms:.4f} ms, best {best} "
                  f"{times[best]:.4f} ms, library {row['library_ms']:.4f} "
                  f"ms", flush=True)
    finally:
        setattr(module, plan_attr, plan)
    tuned = {(r["m"], r["k"], r["n"]): tuple(map(int, r["best"].split("/")))
             for r in rows if r["best_ms"] < 0.97 * r["picked_ms"]}
    print(f"{name}: shapes where a plan beat the rule's by more than 3%: "
          f"{tuned}", flush=True)
    return rows


def sweep_conv(dev, sms):
    import numpy as np
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch import marvel
    from repro_torch.kernels import fused_conv as fc
    from repro_torch.launch.serve import random_images

    shapes: dict = {}
    for label in ("resnet50 v4", "densenet121 v4", "mobilenetv2 v2"):
        name, level = label.split()
        params, apply, shape = cs.model(name, dev)
        prog = marvel.compile(apply, torch.zeros((1, *shape), device=dev),
                              params=params, level=level)
        batch = torch.from_numpy(np.stack(random_images(
            shape, BATCH))).to(dev)
        rec, _, _ = cs.record_launches(prog, batch)
        for cnt, args, _ in rec["fused_conv"].values():
            x, w = args[0], args[1]
            m = x.shape[0] * fc.conv_out_size(
                x.shape[1], w.shape[0], args[5], args[6]) * fc.conv_out_size(
                x.shape[2], w.shape[1], args[5], args[6])
            key = (m, w.shape[-1], w.shape[0] * w.shape[1] * w.shape[2],
                   w.shape[2])
            entry = shapes.setdefault(key, [args, {}])
            entry[1][label] = entry[1].get(label, 0) + cnt

    def launch(args, check=False):
        got = fc._launch(*args)
        if check:
            x, w, es, eb, res, stride, padding, act = args
            want = fc.fused_conv_int8_plain(x, w, es, eb, res, stride=stride,
                                            padding=padding, act=act)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            assert torch.equal(got, fc._launch(*args))
        return got

    def lib_ms(args):
        x, w, _, _, _, stride, _, _ = args
        xf = x.permute(0, 3, 1, 2).float().contiguous(
            memory_format=torch.channels_last)
        wf = w.permute(3, 2, 0, 1).float().contiguous(
            memory_format=torch.channels_last)
        return cs.time_ms(lambda: F.conv2d(xf, wf, stride=stride,
                                           padding=w.shape[0] // 2), trials=3)

    cases = [(key, args, users)
             for key, (args, users) in sorted(shapes.items())]
    return sweep_imma("conv", cases, fc, "conv_plan", launch, sms, lib_ms)


def sweep_mac(dev, sms):
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import mac_matmul as mm

    rng = np.random.default_rng(9)
    cases = []
    for m, k, n in cs.MAC_CASES:
        x = torch.from_numpy(rng.integers(-127, 128, (m, k), np.int8)).to(dev)
        w = torch.from_numpy(rng.integers(-127, 128, (k, n), np.int8)).to(dev)
        sc = torch.from_numpy((rng.random(n) * 0.02).astype(np.float32)).to(
            dev)
        cases.append(((m, n, k, k), (x, w, sc), {"mac cases": 1}))

    def launch(args, check=False):
        got = mm._launch(*args)
        if check:
            assert torch.equal(got, mm.mac_matmul_int8_ref(*args))
            assert torch.equal(got, mm._launch(*args))
        return got

    def lib_ms(args):
        return cs.time_ms(cs.int_mm_yardstick(*args)[0], trials=3)

    return sweep_imma("mac", cases, mm, "mac_plan", launch, sms, lib_ms)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "sweep_cnn_kernels.json"))
    ap.add_argument("--densenet-every", type=int, default=1,
                    help="time every n-th distinct DenseNet121 GEMM shape")
    ap.add_argument("--only", default="gemm,depthwise,sep,conv,mac",
                    help="comma-separated kernels to sweep")
    args = ap.parse_args()
    only = set(args.only.split(","))
    import torch

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    build.lib()
    sms = build.sm_count(dev)
    result = {"card": card}
    if "gemm" in only:
        result["gemm"] = sweep_gemm(dev, sms, args.densenet_every)
    if "depthwise" in only:
        result["depthwise"] = sweep_dw(dev, sms)
    if "sep" in only:
        result["sep"] = sweep_sep(dev, sms)
    if "conv" in only:
        result["conv"] = sweep_conv(dev, sms)
    if "mac" in only:
        result["mac"] = sweep_mac(dev, sms)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
