"""Serving launcher: the CNN and LM serving tiers on the CUDA card.

    python -m repro_torch.launch.serve --cnn resnet50 --requests 32
    python -m repro_torch.launch.serve --arch qwen3-8b --lm --requests 32 \
        --kv-quant int8
    python -m repro_torch.launch.serve --arch rwkv6-1.6b --lm --requests 32
    python -m repro_torch.launch.serve --arch hymba-1.5b --lm --requests 32 \
        --kv-quant int8

compiles the model at v4 (``marvel.compile``: profile -> classify -> the
class's extension table -> the hand-written CUDA kernels), serves a seeded
request wave through :class:`~repro_torch.runtime.cnn_server.AsyncCnnEngine`
(``--cnn``) or the continuous-batching
:class:`~repro_torch.runtime.lm_server.AsyncLmEngine` (``--arch ... --lm``,
random bf16 weights drawn on the card from seed 0; ``--smoke`` takes the
2-layer, 128-wide variant) and prints the serving metrics.  It runs on the
card; ``--device cpu`` runs the kernels' plain versions on the CPU instead.

Supervised tiers (a fault-tolerant control plane over N workers, the
Prometheus snapshot printed on exit)::

    python -m repro_torch.launch.serve --cnn resnet50 --supervised --workers 2
    python -m repro_torch.launch.serve --arch qwen3-8b --lm --supervised \
        --workers 2 --kv-quant int8

``--isolation process`` makes each worker its own OS process (spawned; the
workers share the card): a ``kill -9`` costs one worker, never the fleet.
``--arch`` without ``--lm`` runs the legacy wave loop
(:class:`~repro_torch.runtime.server.ServeEngine`, the plain versions), as
the reference's launcher does.  The enc_dec family (whisper-tiny) is served
there alone, each lane against its own frames drawn from the seed, and so is
the vlm family (internvl2-26b), which decodes from tokens alone, as the
reference's wave loop does (it passes no patches)::

    python -m repro_torch.launch.serve --arch whisper-tiny --requests 8
    python -m repro_torch.launch.serve --arch internvl2-26b --requests 8

granite-34b is served by every tier, as the other dense archs are.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import time

import numpy as np
import torch

# an LM worker's heartbeat waits behind its decode step in flight (a
# full-width qwen3-8b step takes ~107 ms of wall time on the H100), so the
# supervised LM tier floors the beats above a step and allows a longer hang;
# the CNN tier keeps the supervisor's defaults
LM_SUPERVISOR = dict(heartbeat_floor_ms=250.0, hang_timeout_ms=10_000.0)


def random_images(in_shape, n: int, seed: int = 0) -> list[np.ndarray]:
    """A deterministic request wave (shared by the launcher and tests)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(in_shape).astype(np.float32)
            for _ in range(n)]


def serve_cnn_supervised(args, prog, in_shape) -> dict:
    """The fault-tolerant path: a Supervisor routing over ``--workers``
    workers; prints the Prometheus snapshot and returns the metrics."""
    from repro_torch.runtime.supervisor import Supervisor

    async def main() -> dict:
        sup = Supervisor()
        reg_kwargs = dict(workers=args.workers, warmup=in_shape,
                          max_batch=args.max_batch,
                          max_delay_ms=args.max_delay_ms)
        if args.isolation == "process":
            # no parent-side program: each actor compiles its own copy
            from repro_torch.runtime.actor import cnn_program_factory

            reg_kwargs.update(isolation="process",
                              program_factory=cnn_program_factory,
                              factory_kwargs=dict(model=args.cnn,
                                                  device=args.device))
        sup.register(args.cnn, prog, **reg_kwargs)
        async with sup:
            t0 = time.perf_counter()
            results = await sup.submit_wave(
                random_images(in_shape, args.requests))
            dt = time.perf_counter() - t0
            m = sup.metrics()
            print(f"served {len(results)} requests across "
                  f"{m['aggregate']['healthy_workers']} supervised "
                  f"{args.isolation} worker(s) in {dt * 1e3:.1f} ms "
                  f"({dt / args.requests * 1e6:.0f} us/request)")
            print(sup.prometheus(), end="")
            return m

    return asyncio.run(main())


def serve_cnn(args) -> dict:
    from repro_torch import marvel
    from repro_torch.models.cnn import get_cnn
    from repro_torch.runtime.actor import cnn_program_factory

    _, _, in_shape = get_cnn(args.cnn)
    if args.supervised and args.isolation == "process":
        return serve_cnn_supervised(args, None, in_shape)
    dev = marvel.resolve_device(args.device)
    prog = cnn_program_factory(model=args.cnn, device=dev)
    if args.supervised:
        return serve_cnn_supervised(args, prog, in_shape)
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


def serve_lm_supervised(args, engine_kwargs) -> dict:
    """The supervised LM tier: ``--workers`` continuous-batching workers,
    in-process or (``--isolation process``) each its own OS process that
    builds its program from ``lm_program_factory``; prints the Prometheus
    snapshot and returns the metrics."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.runtime.actor import lm_program_factory
    from repro_torch.runtime.supervisor import Supervisor

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    prompts = lm_prompts(cfg.vocab, args.requests)
    factory_kwargs = dict(arch=args.arch, smoke=args.smoke,
                          global_batch=args.slots, device=args.device)

    async def main() -> dict:
        sup = Supervisor(**LM_SUPERVISOR)
        if args.isolation == "process":
            # each actor rebuilds cfg/run child-side via the factory; only
            # the engine knobs cross the pipe
            sup.register(args.arch, None, workers=args.workers, mode="lm",
                         warmup=(), isolation="process",
                         program_factory=lm_program_factory,
                         factory_kwargs=factory_kwargs, **engine_kwargs)
        else:
            prog, ctx_kwargs = lm_program_factory(**factory_kwargs)
            sup.register(args.arch, prog, workers=args.workers, mode="lm",
                         warmup=(), **ctx_kwargs, **engine_kwargs)
        async with sup:
            t0 = time.perf_counter()
            results = await sup.submit_wave(prompts,
                                            max_new_tokens=args.max_new)
            dt = time.perf_counter() - t0
            toks = sum(len(r.generated) for r in results)
            m = sup.metrics()
            print(f"served {len(results)} sequences ({toks} tokens) across "
                  f"{m['aggregate']['healthy_workers']} supervised "
                  f"{args.isolation} LM worker(s) in {dt:.2f} s: "
                  f"{toks / dt:.1f} tok/s")
            print(sup.prometheus(), end="")
            return m

    return asyncio.run(main())


# the families whose forward takes a per-request input beside the tokens,
# which the continuous-batching tier does not take: what each needs
CONTINUOUS_TIER_REFUSED = {
    "enc_dec": "decodes against per-request audio frames",
    "vlm": "prefills per-request patch embeddings (patches=) ahead of its "
           "text",
}


def refuse_continuous_tier(arch: str) -> None:
    """The continuous-batching tier compiles the forward from tokens alone
    and builds its decode states without frames, so an enc_dec or vlm arch
    is refused with the reason (the reference's tier fails on both: it has
    no frames for enc_dec, and its vlm forward reaches the patch projection
    with ``patches=None``); the legacy wave loop serves them."""
    from repro_torch.configs import get_arch

    family = get_arch(arch).family
    if family in CONTINUOUS_TIER_REFUSED:
        raise ValueError(
            f"{arch} ({family} family) {CONTINUOUS_TIER_REFUSED[family]}, "
            "which the continuous-batching tier (--lm, --supervised) does "
            "not take; serve it through the legacy wave loop: --arch "
            f"{arch} without --lm")


def serve_lm(args) -> dict:
    """The continuous-batching LM tier (``--lm``), supervised with
    ``--supervised``."""
    from repro_torch.runtime.actor import lm_program_factory

    refuse_continuous_tier(args.arch)
    engine_kwargs = dict(slots=args.slots, max_len=args.max_len,
                         kv_quant=args.kv_quant)
    if args.supervised:
        return serve_lm_supervised(args, engine_kwargs)
    prog, ctx = lm_program_factory(args.arch, smoke=args.smoke,
                                   global_batch=args.slots,
                                   device=args.device)
    cfg = ctx["cfg"]
    engine = prog.serve(mode="lm", **ctx, **engine_kwargs)
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


def serve_wave_loop(args) -> dict:
    """The legacy wave loop: a caller-driven
    :class:`~repro_torch.runtime.server.ServeEngine` over the plain versions,
    random weights from seed 0 on the device; an enc_dec arch's frames (one
    (n_frames, d_model) bf16 draw per slot) follow from the same seed, and a
    vlm arch decodes from tokens alone (the reference's loop passes no
    patches)."""
    from repro_torch import marvel
    from repro_torch.configs import RunConfig, get_arch, smoke_variant
    from repro_torch.models import transformer as T
    from repro_torch.runtime.server import Request, ServeEngine

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    dev = marvel.resolve_device(args.device)
    run = RunConfig(seq_len=128, global_batch=args.slots, mode="decode",
                    attn_chunk=32, ssm_chunk=32, wkv_chunk=16)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(gen, cfg)
    frames = None
    if cfg.family == "enc_dec":
        frames = torch.randn((args.slots, cfg.n_frames, cfg.d_model),
                             generator=gen, device=dev).to(torch.bfloat16)
    engine = ServeEngine(params, cfg, run, batch_slots=args.slots,
                         max_len=128, frames=frames)
    t0 = time.time()
    for uid, prompt in enumerate(lm_prompts(cfg.vocab, args.requests)):
        engine.submit(Request(uid=uid, prompt=prompt,
                              max_new_tokens=args.max_new))
    engine.run_until_drained()
    dt = time.time() - t0
    print(f"served {args.requests} requests ({args.max_new} tokens each) "
          f"in {dt:.1f}s with {args.slots} slots on {dev}")
    metrics = engine.metrics()
    print(json.dumps(metrics, indent=1))
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--cnn",
                      help="CNN to serve (lenet5, mobilenetv1, vgg16, "
                           "resnet50, mobilenetv2, densenet121)")
    what.add_argument("--arch",
                      help="LM to serve (qwen3-8b, granite-3-2b, "
                           "granite-34b, starcoder2-3b, hymba-1.5b, "
                           "rwkv6-1.6b, whisper-tiny, internvl2-26b): the "
                           "legacy wave loop, or the continuous-batching "
                           "tier with --lm (not whisper-tiny or "
                           "internvl2-26b)")
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
                    help="int8 KV cache (attention families; hymba's "
                         "SSM state stays f32, rwkv's recurrent state "
                         "refuses it)")
    ap.add_argument("--supervised", action="store_true",
                    help="run the tier under the fault-tolerant supervisor "
                         "(prints Prometheus metrics on exit)")
    ap.add_argument("--workers", type=int, default=2,
                    help="supervised engine workers (with --supervised)")
    ap.add_argument("--isolation", choices=("inproc", "process"),
                    default="inproc",
                    help="supervised worker isolation: in-process engines "
                         "(default) or one spawned OS process per worker, "
                         "sharing the card (crash-only recovery)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.supervised and not (args.cnn or args.lm):
        ap.error("--supervised requires --cnn or --lm")
    if args.isolation == "process" and not args.supervised:
        ap.error("--isolation process requires --supervised")
    if args.cnn is not None:
        return serve_cnn(args)
    if args.lm:
        return serve_lm(args)
    return serve_wave_loop(args)


if __name__ == "__main__":
    main()
