"""Serving launcher: the CNN and LM async serving tiers on the CUDA card.

    python -m repro_torch.launch.serve --cnn resnet50 --requests 32
    python -m repro_torch.launch.serve --arch qwen3-8b --lm --requests 32 \
        --kv-quant int8
    python -m repro_torch.launch.serve --arch rwkv6-1.6b --lm --requests 32

compiles the model at v4 (``marvel.compile``: profile -> classify -> the
class's extension table -> the hand-written CUDA kernels), serves a seeded
request wave through :class:`~repro_torch.runtime.cnn_server.AsyncCnnEngine`
(``--cnn``) or the continuous-batching
:class:`~repro_torch.runtime.lm_server.AsyncLmEngine` (``--arch ... --lm``,
random bf16 weights drawn on the card from seed 0; ``--smoke`` takes the
2-layer, 128-wide variant) and prints the serving metrics.  It runs on the
card; ``--device cpu`` runs the kernels' plain versions on the CPU instead.
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


def lm_prompts(vocab: int, n: int) -> list[list[int]]:
    """The launcher's deterministic prompt wave (the reference's)."""
    return [[(uid * 7 + i) % (vocab - 1) + 1 for i in range(5)]
            for uid in range(n)]


def build_lm(arch: str, *, smoke: bool, device, slots: int):
    """(program, cfg, run) of ``arch`` at v4 with random weights from seed
    0, drawn on ``device``."""
    from repro_torch import marvel
    from repro_torch.configs import RunConfig, get_arch, smoke_variant
    from repro_torch.models import transformer as T

    cfg = get_arch(arch)
    if smoke:
        cfg = smoke_variant(cfg)
    dev = marvel.resolve_device(device)
    run = RunConfig(seq_len=32, global_batch=slots, mode="decode",
                    attn_chunk=16)
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    tokens = np.ones((1, 8), np.int32)
    prog = marvel.compile(lambda p, t: T.forward_lm(p, t, cfg, run)[0],
                          tokens, params=params, level="v4", device=dev)
    return prog, cfg, run


def serve_lm(args) -> dict:
    prog, cfg, run = build_lm(args.arch, smoke=args.smoke,
                              device=args.device, slots=args.slots)
    engine = prog.serve(mode="lm", cfg=cfg, run=run, slots=args.slots,
                        max_len=args.max_len, kv_quant=args.kv_quant)
    prompts = lm_prompts(cfg.vocab, args.requests)

    async def main() -> dict:
        async with engine:
            engine.warmup()
            warm = engine.engine.compile_misses
            t0 = time.perf_counter()
            results = await engine.submit_wave(
                prompts, max_new_tokens=args.max_new)
            dt = time.perf_counter() - t0
            toks = sum(len(r.generated) for r in results)
            m = engine.metrics()
            print(f"served {len(results)} sequences ({toks} tokens) of "
                  f"{cfg.name} on {prog.device} in {dt:.2f} s: "
                  f"{toks / dt:.1f} tok/s, "
                  f"{m['compile_misses'] - warm} new buckets after warmup, "
                  f"kv_quant={m['kv_quant']}")
            print("sample generation:", results[0].generated)
            return m

    metrics = asyncio.run(main())
    print(json.dumps(metrics, indent=1, default=str))
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--cnn",
                      help="CNN to serve (lenet5, mobilenetv1, vgg16, "
                           "resnet50, mobilenetv2, densenet121)")
    what.add_argument("--arch",
                      help="LM to serve with --lm (qwen3-8b, granite-3-2b, "
                           "starcoder2-3b, rwkv6-1.6b)")
    ap.add_argument("--lm", action="store_true",
                    help="serve --arch through the continuous-batching tier")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's 2-layer, 128-wide smoke variant")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=2.0)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--kv-quant", choices=("int8",), default=None,
                    help="int8 KV cache (attention families; rwkv's "
                         "recurrent state refuses it)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.arch is not None:
        if not args.lm:
            ap.error("--arch serves through the LM tier: add --lm")
        return serve_lm(args)
    return serve_cnn(args)


if __name__ == "__main__":
    main()
