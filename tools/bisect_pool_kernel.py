#!/usr/bin/env python3
"""Time the pool kernels (``csrc/pooling.cu``: the windowed pool and the
global-average pool) side by side on the card: what a launch's time is
made of, and where the global-average pool's vector form stops paying.
Each variant is built from a copy of the source (the repository's source
is not touched) into its own library and timed through the wrappers at
every pool launch shape of the paper CNNs' batch-8 v4 forwards, in two
rounds of turns, as ``chip_smoke.py`` times a kernel.

    python3 tools/bisect_pool_kernel.py [--out build/bisect_pool]

Variants:
    base    the source as it is, each launch in its planned form
    scalar  the same build with every launch planned as for an unaligned
            input: the scalar forms
    empty   every kernel returns at its start: the floor of a launch
Only ``base`` and ``scalar`` compute the right numbers: ``empty`` is
timed, not held.  Then the global-average pool's vector and rows forms
at (8, H, W, 1024) for H*W from 1 to 256, the sweep that sets
``pooling.GAP_VECTOR_MAX_HW``.  Needs a CUDA card and nvcc; prints the
card and one JSON line per variant and round (µs a launch per shape).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")

KERNEL_START = re.compile(r"(__global__ void \w+\([^)]*\)\s*\{)")
VARIANTS = {"base": False, "empty": True}
# every pool launch of the paper CNNs at batch 8, v4: (forward, x shape,
# op, window)
SITES = [("vgg16", (8, 64, 64, 64), "max", 2),
         ("vgg16", (8, 32, 32, 128), "max", 2),
         ("vgg16", (8, 16, 16, 256), "max", 2),
         ("vgg16", (8, 8, 8, 512), "max", 2),
         ("vgg16", (8, 4, 4, 512), "max", 2),
         ("resnet50", (8, 32, 32, 64), "max", 3),
         ("resnet50", (8, 2, 2, 2048), "global_avg", 0),
         ("densenet121", (8, 32, 32, 64), "max", 3),
         ("densenet121", (8, 15, 15, 128), "avg", 2),
         ("densenet121", (8, 7, 7, 256), "avg", 2),
         ("densenet121", (8, 3, 3, 512), "avg", 2),
         ("densenet121", (8, 1, 1, 1024), "global_avg", 0),
         ("mobilenetv2", (8, 2, 2, 1280), "global_avg", 0),
         ("mobilenetv1", (8, 2, 2, 1024), "global_avg", 0)]
GAP_SWEEP = [(1, 1), (2, 2), (3, 3), (4, 4), (5, 5), (7, 7), (8, 8),
             (11, 13), (16, 16)]


def build_variant(out_dir, name, empty):
    from repro_torch.kernels import build

    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    src = open(os.path.join(CSRC, "pooling.cu")).read()
    if empty:
        src, hits = KERNEL_START.subn(r"\1\n  return;", src)
        if hits != 4:
            raise RuntimeError(f"variant {name}: found {hits} kernels, not 4")
    with open(os.path.join(d, "pooling.cu"), "w") as f:
        f.write(src)
    cmd = ["nvcc" if shutil.which("nvcc") else "/usr/local/cuda/bin/nvcc",
           *build.NVCC_FLAGS, "-shared", "-o", os.path.join(d, "lib.so"),
           os.path.join(d, "pooling.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def label(forward, shape, op, k):
    win = "" if op == "global_avg" else f" {k}x{k}/2"
    return f"{forward} {op}{win} {'x'.join(map(str, shape))}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "bisect_pool"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bisect_pool_kernel: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import pooling as pk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    procs = {n: build_variant(args.out, n, e) for n, e in VARIANTS.items()}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
    libs = {}
    for name in VARIANTS:
        lib = ctypes.CDLL(os.path.join(args.out, name, "lib.so"))
        for fn in ("marvel_windowed_pool", "marvel_global_avgpool"):
            getattr(lib, fn).argtypes = list(build.SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)

    def launch(shape, op, k):
        x = torch.randn(shape, generator=gen).to(dev)
        if op == "global_avg":
            return lambda: pk._launch_gap(x)
        return lambda: pk._launch_windowed(x, k, 2, op)

    launches = {label(*s): launch(*s[1:]) for s in SITES}
    plan = pk._plan
    kept = build._lib

    def scalar_plan(x, op, k=2, stride=2):
        return pk.pool_plan(tuple(x.shape), x.dtype, op, k, stride,
                            ptr_aligned=False)

    def row(fns):
        return {name: round(cs.time_ms(fn, trials=5) * 1e3, 2)
                for name, fn in fns.items()}

    try:
        for rnd in (1, 2):
            for name in ("base", "scalar", "empty"):
                build._lib = libs["base" if name == "scalar" else name]
                pk._plan = scalar_plan if name == "scalar" else plan
                print(json.dumps({"round": rnd, "variant": name,
                                  "us": row(launches), "card": card}),
                      flush=True)
        build._lib, pk._plan = libs["base"], plan
        keep_hw = pk.GAP_VECTOR_MAX_HW
        sweep = {f"8x{h}x{w}x1024": launch((8, h, w, 1024), "global_avg", 0)
                 for h, w in GAP_SWEEP}
        for rnd in (1, 2):
            for form, max_hw in (("vector", 10**9), ("rows", 0)):
                pk.GAP_VECTOR_MAX_HW = max_hw
                print(json.dumps({"round": rnd, "gap_form": form,
                                  "us": row(sweep), "card": card}),
                      flush=True)
        pk.GAP_VECTOR_MAX_HW = keep_hw
    finally:
        build._lib, pk._plan = kept, plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
