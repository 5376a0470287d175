#!/usr/bin/env python3
"""Time the fused residual-add + RMSNorm kernel (``residual_rmsnorm``) of one
source tree on the card at every norm launch shape of the LM paths, as
``chip_smoke.py`` times it: each shape's launch through that tree's
``chip_smoke.py::rmsnorm_case`` (held against the plain version, then the
median of CUDA-event timings of back-to-back launches), on synthetic bf16
rows from seed 0 with a bf16 scale (the models pass it in their parameter
type), and the time summed over the forward's launches.  No model weights.

    python3 tools/time_rmsnorm_kernels.py [--tree DIR] [--tag NAME]
        [--variants base,empty,cluster] [--sweep] [--out DIR]

``--tree`` is the root of the checkout whose kernel is timed (default:
this one; its ``chip_smoke.py`` and ``src/`` are imported), so two trees
can be timed in turns in one run on one card.  The tree's
``csrc/residual_rmsnorm.cu`` alone is built with nvcc into ``--out`` (a
few seconds), not the whole kernel library.  Variants:

    base     the source as it is, each launch in its planned form
    empty    every kernel returns at its start: the launches' floor
             (timed, not held)
    cluster  the few-row alternative of ``tools/rmsnorm_cluster.cu``, each
             row split over a thread-block cluster of C blocks that add
             their partial sums through distributed shared memory, at
             C = 2, 4, 8 on the decode steps' rows (held, then timed); it
             includes this checkout's source, so only this tree takes it

Prints the card and one JSON line per variant and shape: µs a launch, and
for ``base`` the plain version, the bound and (where the tree's case times
it) the ``torch.add`` + ``F.rms_norm`` pair, each summed per forward.
``--sweep`` then times the rows form of ``base`` at every geometry it
takes for each shape (threads a row t, rows a block; vectors a thread and
the grid follow), each launch held first, two rounds: the sweep that sets
``norm_plan``'s rule.
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

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_START = re.compile(r"(__global__ void[^{;]*\{)")
# every norm launch shape of the LM paths: (forward, launches a forward,
# rows, D); whisper-tiny's prefill runs the encoder's 4 x 1500 frames and
# the decoder's 4 x 448 tokens, its decode state the encoder over 8 slots
SHAPES = [("qwen3-8b prefill B=4 S=512", 36, 2048, 4096),
          ("hymba-1.5b prefill B=1 S=2048", 32, 2048, 1600),
          ("whisper-tiny prefill encoder B=4 F=1500", 4, 6000, 384),
          ("whisper-tiny prefill decoder B=4 S=448", 4, 1792, 384),
          ("whisper-tiny decode state, 8 slots", 4, 12000, 384),
          ("qwen3-8b decode step, 8 slots", 36, 8, 4096),
          ("hymba-1.5b decode step, 8 slots", 32, 8, 1600),
          ("whisper-tiny decode step, 8 slots", 4, 8, 384)]
CLUSTER_SIZES = (2, 4, 8)
CLUSTER_MAX_ROWS = 16  # the cluster alternative is for few rows


def nvcc_build(src_text, out_dir, name, flags, includes=()):
    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    src = os.path.join(d, "kernel.cu")
    with open(src, "w") as f:
        f.write(src_text)
    cmd = ["nvcc" if shutil.which("nvcc") else "/usr/local/cuda/bin/nvcc",
           *flags, "-Xptxas", "-v", *(f"-I{i}" for i in includes),
           "-shared", "-o", os.path.join(d, "lib.so"), src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def cluster_plan(rr, c):
    """The cluster alternative's geometry in the tree's NormPlan: C blocks
    a row, each holding a slice of the row's vectors."""
    def plan(rows, d, dtype, scale_dtype, aligned=True, sms=None):
        per_vec = rr.VECTOR_BYTES // (4 if dtype == rr.torch.float32 else 2)
        per_block = rr._cdiv(d // per_vec, c)
        t = min(max(rr._pow2_ceil(rr._cdiv(per_block, rr.VECS_TARGET)),
                    rr.ROWS_MIN_GROUP), rr.ROWS_MAX_THREADS)
        return rr.NormPlan("rows", t, 1, rr._cdiv(per_block, t), rows * c, c)
    return plan


def sweep_plans(rr, rows, d):
    """Every rows-form geometry of bf16 rows of d: t threads a row (a power
    of two, at most VECS_MAX vectors a thread) and every power-of-two count
    of rows a block that fits a block."""
    nv = d * 2 // rr.VECTOR_BYTES
    t = rr.ROWS_MIN_GROUP
    while t <= rr.ROWS_MAX_THREADS:
        if rr._cdiv(nv, t) <= rr.VECS_MAX:
            rpb = 1
            while t * rpb <= rr.ROWS_MAX_THREADS and rpb <= rows:
                yield rr.NormPlan("rows", t, rpb, rr._cdiv(nv, t),
                                  rr._cdiv(rows, rpb), 1)
                rpb *= 2
        t *= 2


def geometry(plan):
    return f"t={plan.threads} rpb={plan.rows_per_block}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(HERE))
    ap.add_argument("--tag", default="")
    ap.add_argument("--variants", default="base")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    variants = args.variants.split(",")
    out = args.out or os.path.join(tree, "build", "time_rmsnorm",
                                   args.tag or "run")
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("time_rmsnorm_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import residual_rmsnorm as rr

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    csrc = os.path.join(tree, "src", "repro_torch", "csrc")
    with open(os.path.join(csrc, "residual_rmsnorm.cu")) as f:
        src = f.read()
    texts = {"base": src}
    if "empty" in variants:
        texts["empty"], hits = KERNEL_START.subn(r"\1\n  return;", src)
        if hits < 1:
            raise RuntimeError("variant empty: no __global__ kernel found")
    if "cluster" in variants:
        with open(os.path.join(HERE, "rmsnorm_cluster.cu")) as f:
            texts["cluster"] = f.read()
    procs = {n: nvcc_build(t, out, n, build.NVCC_FLAGS, (csrc,))
             for n, t in texts.items()}
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        # ptxas's registers and spills of every kernel of the variant
        print(json.dumps({"tag": args.tag, "variant": name, "ptxas": [
            ln.strip() for ln in err.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]}),
              flush=True)
        lib = ctypes.CDLL(os.path.join(out, name, "lib.so"))
        entry = ("marvel_residual_rmsnorm_cluster" if name == "cluster"
                 else "marvel_residual_rmsnorm")
        fn = getattr(lib, entry)
        fn.argtypes = list(build.SIGNATURES["marvel_residual_rmsnorm"])
        fn.restype = ctypes.c_int
        libs[name] = type("Lib", (), {"marvel_residual_rmsnorm": fn})()

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)

    def operands(rows, d):
        res, x = (torch.randn((rows, d), generator=gen).to(
            dev, torch.bfloat16) for _ in range(2))
        scale = (0.5 + torch.rand(d, generator=gen)).to(dev, torch.bfloat16)
        return res, x, scale, 1e-6

    shapes = [(s, operands(s[2], s[3])) for s in SHAPES]
    kept_lib, kept_plan = build._lib, getattr(rr, "norm_plan", None)
    try:
        for name in variants:
            sizes = CLUSTER_SIZES if name == "cluster" else (None,)
            for c in sizes:
                build._lib = libs[name]
                if c is not None:
                    rr.norm_plan = cluster_plan(rr, c)
                for (fwd, n, rows, d), a in shapes:
                    if c is not None and rows > CLUSTER_MAX_ROWS:
                        continue
                    line = {"tag": args.tag, "variant": name, "forward": fwd,
                            "rows": rows, "D": d, "launches": n,
                            "card": card}
                    if c is not None:
                        line["cluster"] = c
                    if name == "empty":
                        us = cs.time_ms(lambda a=a: rr._launch(*a)) * 1e3
                    else:
                        _, err, _, ms, plain, _, b, *more = cs.rmsnorm_case(
                            a, True)
                        us = ms * 1e3
                        line.update(max_abs_err=err, plain_ms=n * plain,
                                    bound_ms=n * b[0])
                        if more:
                            line["pair_ms"] = n * more[0]["pair_ms"]
                    line.update(us_a_launch=us, ms=n * us / 1e3)
                    print(json.dumps(line), flush=True)
                rr.norm_plan = kept_plan
        if args.sweep:
            build._lib = libs["base"]
            sms = build.sm_count(dev)
            for rnd in (1, 2):
                for (fwd, n, rows, d), a in shapes:
                    us = {}
                    for plan in sweep_plans(rr, rows, d):
                        rr.norm_plan = lambda *_, p=plan: p
                        cs.rmsnorm_case(a, False)
                        us[geometry(plan)] = cs.time_ms(
                            lambda a=a: rr._launch(*a)) * 1e3
                    rr.norm_plan = kept_plan
                    planned = kept_plan(rows, d, torch.bfloat16,
                                        torch.bfloat16, True, sms)
                    print(json.dumps({
                        "tag": args.tag, "sweep": rnd, "forward": fwd,
                        "rows": rows, "D": d, "planned": geometry(planned),
                        "us": us, "card": card}), flush=True)
    finally:
        build._lib, rr.norm_plan = kept_lib, kept_plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
