#!/usr/bin/env python3
"""Time variants of the int8 tensor-core kernel (``csrc/fused_conv.cu``,
which runs ``fused_conv_int8`` and ``mac_matmul_int8``) side by side on the
card: what a launch's time is made of.  Each variant is built from a copy
of the source with one part removed or changed (the repository's source is
not touched), into its own library, and timed through the wrappers (their
own plans) at shapes of the CNN path and the mac cases, in two rounds of
turns, as ``chip_smoke.py`` times a kernel.

    python3 tools/bisect_imma_kernel.py [--out build/bisect_imma]

Variants:
    base    the source as it is
    empty   returns at its start: the floor of a launch of this kernel
    noloop  stages and multiplies no K step
    noepi   returns before its epilogue (after split K's sum)
    divide  FastDiv's divisions done as integer divides
    act     the epilogue's act through ``marvel::apply_act`` (its switch
            over silu and gelu) instead of the clamp
    sb8     split K's last block loads twice as many slices a round trip
Only ``base`` computes the right numbers: the others are timed, not held.
Needs a CUDA card and nvcc; prints the card and one JSON line per variant
and round (µs a launch per shape).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")

N_KT = "  const int n_kt = max(0, (k_end - k_begin + BK - 1) / BK);\n"
EPILOGUE = "  // the epilogue on the register tile: rows g and g+8 of each m16 tile,"
CLAMP = """            if (p.act != marvel::kNone) {
              v = fmaxf(v, 0.0f);
              if (p.act == marvel::kRelu6) v = fminf(v, 6.0f);
            }
            y[c] = v;"""
VARIANTS = {
    "base": [],
    "empty": [(N_KT, N_KT + "  if (q.M > 0) return;\n")],
    "noloop": [(N_KT, "  const int n_kt = q.M < 0 ? 1 : 0;\n")],
    "noepi": [(EPILOGUE, "  if (q.M > 0) {\n    if (acc[0][0][0] == 123457)"
               " p.out[0] = 1.0f;\n    return;\n  }\n" + EPILOGUE)],
    "divide": [("return d == 1 ? n : (int)(__umulhi((uint32_t)n, mul) >> "
                "shr);", "return n / (int)d;")],
    "act": [(CLAMP, "            y[c] = marvel::apply_act(v, p.act);")],
    "sb8": [("constexpr int SB = V >= 16 ? 1 : 16 / V;",
             "constexpr int SB = V >= 32 ? 1 : 32 / V;")],
}
# conv: (x shape, kernel size, Cout, stride); mac: (M, K, N)
CONV = {"8192x32x16 1x1": ((8, 32, 32, 32), 1, 16, 1),
        "8192x27x32 stem 3x3": ((8, 64, 64, 3), 3, 32, 2),
        "512x256x512 1x1/2": ((8, 16, 16, 256), 1, 512, 2),
        "1800x576x64 3x3": ((8, 15, 15, 64), 3, 64, 1),
        "72x1152x32 3x3": ((8, 3, 3, 128), 3, 32, 1),
        "32x4608x512 3x3": ((8, 2, 2, 512), 3, 512, 1)}
MAC = {"mac 8x2048x7168": (8, 2048, 7168),
       "mac 2048x2048x7168": (2048, 2048, 7168)}


def build_variant(out_dir, name, edits):
    from repro_torch.kernels import build

    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    src = open(os.path.join(CSRC, "fused_conv.cu")).read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name}: its edit no longer applies")
        src = src.replace(old, new)
    with open(os.path.join(d, "fused_conv.cu"), "w") as f:
        f.write(src)
    for dep in ("cp_async.cuh", "imma.cuh", "epilogue.cuh", "mac_matmul.cu"):
        shutil.copy(os.path.join(CSRC, dep), d)
    cmd = ["nvcc" if shutil.which("nvcc") else "/usr/local/cuda/bin/nvcc",
           *build.NVCC_FLAGS, "-shared", "-o", os.path.join(d, "lib.so"),
           os.path.join(d, "fused_conv.cu"), os.path.join(d, "mac_matmul.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "bisect_imma"))
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bisect_imma_kernel: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_conv as fc
    from repro_torch.kernels import mac_matmul as mm

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
        for fn in ("marvel_fused_conv", "marvel_mac_matmul_int8"):
            getattr(lib, fn).argtypes = list(build.SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def codes(shape):
        return torch.from_numpy(rng.integers(-127, 128, shape,
                                             np.int8)).to(dev)

    launches = {}
    for label, (xs, k, cout, stride) in CONV.items():
        conv_args = (codes(xs), codes((k, k, xs[-1], cout)),
                     torch.rand(cout, device=dev) * 1e-3,
                     torch.randn(cout, device=dev), None, stride, "SAME",
                     "relu")
        launches[label] = lambda a=conv_args: fc._launch(*a)
    for label, (m, k, n) in MAC.items():
        mac_args = (codes((m, k)), codes((k, n)),
                    torch.rand(n, device=dev))
        launches[label] = lambda a=mac_args: mm._launch(*a)
    kept = build._lib
    try:
        for rnd in (1, 2):
            for name, lib in libs.items():
                build._lib = lib
                row = {label: round(cs.time_ms(fn, trials=5) * 1e3, 2)
                       for label, fn in launches.items()}
                print(json.dumps({"round": rnd, "variant": name,
                                  "us": row, "card": card}), flush=True)
    finally:
        build._lib = kept
    return 0


if __name__ == "__main__":
    sys.exit(main())
