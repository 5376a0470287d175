"""Serving launcher: the CNN async serving tier on the CUDA card.

    python -m repro_torch.launch.serve --cnn resnet50 --requests 32

compiles the model at v4 (``marvel.compile``: profile -> classify -> the
class's extension table -> the hand-written CUDA kernels), serves a seeded
request wave through :class:`~repro_torch.runtime.cnn_server.AsyncCnnEngine`
and prints the serving metrics.  It runs on the card; ``--device cpu`` runs
the kernels' plain versions on the CPU instead.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import time

import numpy as np
import torch


def random_images(in_shape, n: int, seed: int = 0) -> list[np.ndarray]:
    """A deterministic request wave (shared by the launcher and tests)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(in_shape).astype(np.float32)
            for _ in range(n)]


def serve_cnn(args) -> dict:
    from repro_torch import marvel
    from repro_torch.models.cnn import get_cnn

    init, apply, in_shape = get_cnn(args.cnn)
    dev = marvel.resolve_device(args.device)
    params = init(torch.Generator().manual_seed(0), device=dev)
    x = np.zeros((1, *in_shape), np.float32)
    prog = marvel.compile(apply, x, params=params, level="v4", device=dev)
    engine = prog.serve(mode="async", max_batch=args.max_batch,
                        max_delay_ms=args.max_delay_ms)

    async def main() -> dict:
        async with engine:
            engine.warmup(in_shape)
            t0 = time.perf_counter()
            results = await engine.submit_wave(
                random_images(in_shape, args.requests))
            dt = time.perf_counter() - t0
            print(f"served {len(results)} requests in {engine.batches_run} "
                  f"batches on {dev} in {dt * 1e3:.1f} ms "
                  f"({dt / args.requests * 1e6:.0f} us/request)")
            return engine.metrics()

    metrics = asyncio.run(main())
    print(json.dumps(metrics, indent=1))
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cnn", required=True,
                    help="CNN to serve (lenet5, mobilenetv1, vgg16, resnet50, "
                         "mobilenetv2, densenet121)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=2.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    serve_cnn(ap.parse_args(argv))


if __name__ == "__main__":
    main()
