#!/usr/bin/env python3
"""Time the rnn_lm path's wkv recurrence (``wkv_chunk``) of one source tree
on the card, per forward, as ``chip_smoke.py`` times it: one recorded
prefill of rwkv6-1.6b at full width and depth (B = 4, S = 512, random bf16
weights from seed 0) at v4, every one of its 24 launches held against the
plain version, the first launch of the shape timed, the time summed over
the forward's launches.

    python3 tools/time_wkv_kernels.py [--tree DIR] [--tag NAME]

``--tree`` is the root of the checkout whose kernel is timed (default:
this one), so two trees can be timed in turns in one run on one card (its
``chip_smoke.py`` and ``src/`` are the ones imported).  Prints the card
and one JSON line.
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
        print("time_wkv_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.models import transformer as T

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_arch(cs.RWKV_ARCH)
    b, s = cs.RWKV_PREFILL
    run = RunConfig(seq_len=s, global_batch=b, mode="prefill")
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prog = cs.lm_program(params, cfg, run, np.ones((1, 8), np.int32), dev)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        1, cfg.vocab, (b, s)).astype(np.int32)).to(dev)
    rec, counts, _ = cs.record_launches(prog, tokens)
    agg = cs.hold(rec, ("wkv_chunk",), timed=True)["wkv_chunk"]
    print(json.dumps({
        "tag": args.tag, "tree": tree, "forward": f"{cs.RWKV_ARCH} v4 "
        f"prefill B={b} S={s}", "kernel": "wkv_chunk",
        "launches": counts["wkv_chunk"], "ms": agg["ms"],
        "plain_ms": agg["plain_ms"],
        "bound_ms": agg.get("bound_ms", max(agg["t_bytes"], agg["t_ops"])),
        "card": card}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
