#!/usr/bin/env python3
"""Time the CNN path's kernels of one source tree on the card, per
forward, as ``chip_smoke.py`` times them: the f32 GEMM
(``matmul_epilogue``, fma form) in one recorded batch-8 forward of
ResNet50, MobileNetV2 and DenseNet121 at v4, the int8 depthwise kernel in
MobileNetV2 at v2, the fused separable block (``sep_block``) in
MobileNetV2 and MobileNetV1 at v4, the int8 conv (``fused_conv``) in
ResNet50 and DenseNet121 at v4 and MobileNetV2 at v2, the windowed pool in
VGG16, ResNet50 and DenseNet121 at v4 and the global-average pool in
ResNet50, MobileNetV1, MobileNetV2 and DenseNet121 at v4; every launch held
against its plain version, the first launch of each shape timed beside its
library call, the times summed over the forward's launches.  The bound is
the sum over the launches of each launch's bound (the larger of its bytes
and its operations time), with the sums of the two terms beside it.

    python3 tools/time_cnn_kernels.py [--tree DIR] [--tag NAME]
                                      [--only KERNEL[,KERNEL]]

``--tree`` is the root of the checkout whose kernels are timed (default:
this one), so two trees can be timed in turns in one run on one card
(its ``chip_smoke.py`` and ``src/`` are the ones imported).  Prints the
card and one JSON line per forward.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

FORWARDS = {"resnet50 v4": ("matmul_epilogue", "fused_conv", "windowed_pool",
                            "global_avgpool"),
            "mobilenetv2 v4": ("matmul_epilogue", "sep_block",
                               "global_avgpool"),
            "densenet121 v4": ("matmul_epilogue", "fused_conv",
                               "windowed_pool", "global_avgpool"),
            "mobilenetv2 v2": ("depthwise_conv", "fused_conv"),
            "mobilenetv1 v4": ("sep_block", "global_avgpool"),
            "vgg16 v4": ("windowed_pool",)}


def forward_bound(cs, rec, kernel):
    """(sum of the launches' bounds, of their bytes terms, of their
    operations terms) in ms: each shape's bound from its case function
    (the same in every tree), times its launches."""
    total = [0.0, 0.0, 0.0]
    for cnt, args, _ in rec[kernel].values():
        b_ms, _, tb, to = cs.KERNELS[kernel][0](args, False)[6]
        for i, v in enumerate((b_ms, tb, to)):
            total[i] += cnt * v
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    ap.add_argument("--only", default="",
                    help="comma-separated kernels to time (default: all)")
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_cnn_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import marvel
    from repro_torch.launch.serve import random_images

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    for label, kernels in FORWARDS.items():
        kernels = [k for k in kernels if not only or k in only]
        if not kernels:
            continue
        name, level = label.split()
        params, apply, shape = cs.model(name, dev)
        prog = marvel.compile(apply, torch.zeros((1, *shape), device=dev),
                              params=params, level=level)
        batch = torch.from_numpy(np.stack(random_images(
            shape, cs.BATCH))).to(dev)
        rec, counts, _ = cs.record_launches(prog, batch)
        for kernel in kernels:
            agg = cs.hold(rec, (kernel,), timed=True)[kernel]
            bound_ms, bytes_ms, ops_ms = forward_bound(cs, rec, kernel)
            print(json.dumps({
                "tag": args.tag, "tree": tree, "forward": label,
                "kernel": kernel, "launches": counts[kernel],
                "ms": agg["ms"], "library_ms": agg["library_ms"],
                "plain_ms": agg["plain_ms"], "bound_ms": bound_ms,
                "bound_bytes_ms": bytes_ms, "bound_ops_ms": ops_ms,
                "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
