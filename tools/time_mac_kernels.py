#!/usr/bin/env python3
"""Time ``mac_matmul_int8`` of one source tree on the card, per case, as
``chip_smoke.py`` times it: each of ``chip_smoke.MAC_CASES`` (the grid's
three cases and rwkv6-1.6b's GEMM shapes at 8 decode rows and a 2048-row
prefill), inputs from seed 9 as in its phase 8f, held exactly against the
plain int32 sum, timed beside ``torch._int_mm`` with the scale (operands
zero-padded to what it takes) and its bound (the larger of the bytes at
3.35 TB/s and the int8 operations at 1,979 TOP/s).

    python3 tools/time_mac_kernels.py [--tree DIR] [--tag NAME]

``--tree`` is the root of the checkout whose kernel is timed (default:
this one), so two trees can be timed in turns in one run on one card (its
``chip_smoke.py`` and ``src/`` are the ones imported).  Prints the card,
one JSON line per case and one for the seven together, whose bound is the
sum of the cases' bounds.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_mac_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    total = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                           "bound_bytes_ms", "bound_ops_ms"), 0.0)
    for m, k, n in cs.MAC_CASES:
        x = torch.from_numpy(rng.integers(-127, 128, (m, k), np.int8)).to(dev)
        w = torch.from_numpy(rng.integers(-127, 128, (k, n), np.int8)).to(dev)
        sc = torch.from_numpy((rng.random(n) * 0.02).astype(np.float32)).to(
            dev)
        label, _, _, ms, plain, lib, (b_ms, by, tb, to) = cs.mac_case(
            (x, w, sc), True)
        row = {"ms": ms, "plain_ms": plain, "library_ms": lib,
               "bound_ms": b_ms, "bound_bytes_ms": tb, "bound_ops_ms": to}
        for key, v in row.items():
            total[key] += v
        print(json.dumps({"tag": args.tag, "tree": tree, "case": [m, k, n],
                          "label": label, **row, "bound_by": by,
                          "card": card}), flush=True)
    print(json.dumps({"tag": args.tag, "tree": tree,
                      "case": f"{len(cs.MAC_CASES)} cases", **total,
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
