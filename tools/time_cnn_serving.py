#!/usr/bin/env python3
"""Time the served CNN path of one source tree on the card: the batch-8
forward of a v4 program and waves of requests through its async engine.

    python3 tools/time_cnn_serving.py [--tree DIR] [--tag NAME]
                                      [--models NAME[,NAME]] [--waves N]

``--tree`` is the root of the checkout whose package is timed (default:
this one), so two trees can be timed in turns on one card (parent,
change, change, parent: one process each).  For each model, compiled at
v4 with random weights from seed 0 as ``repro_torch.launch.serve`` does:

* the batch-8 forward's wall time (host clock, each call ended by a
  synchronize), the median of 15 calls;
* ``--waves`` waves of 32 requests through ``prog.serve(mode="async",
  max_batch=8)`` after its warmup: requests per second of each wave.

Prints the card and one JSON line per model.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import subprocess
import sys
import time

BATCH = 8
REQUESTS = 32


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    ap.add_argument("--models", default="resnet50,mobilenetv2")
    ap.add_argument("--waves", type=int, default=5)
    opts = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(opts.tree), "src"))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_cnn_serving: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import marvel
    from repro_torch.launch.serve import random_images
    from repro_torch.models.cnn import get_cnn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    for name in opts.models.split(","):
        init, apply, shape = get_cnn(name)
        params = init(torch.Generator().manual_seed(0), device=dev)
        prog = marvel.compile(apply, np.zeros((1, *shape), np.float32),
                              params=params, level="v4")
        xb = torch.from_numpy(np.stack(random_images(shape, BATCH))).to(dev)
        prog(xb)
        walls = []
        for _ in range(15):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prog(xb)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        engine = prog.serve(mode="async", max_batch=BATCH)

        async def waves():
            rates = []
            async with engine:
                engine.warmup(shape)
                for _ in range(opts.waves):
                    images = random_images(shape, REQUESTS)
                    t0 = time.perf_counter()
                    await engine.submit_wave(images)
                    rates.append(REQUESTS / (time.perf_counter() - t0))
            return rates

        rates = asyncio.run(waves())
        print(json.dumps({"tag": opts.tag, "model": name, "card": card,
                          "forward_ms": statistics.median(walls),
                          "req_per_s": rates,
                          "req_per_s_median": statistics.median(rates)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
