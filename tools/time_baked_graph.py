#!/usr/bin/env python3
"""Host time of the two forms of a compiled CNN program on the card: the
bucket's chess_rewritten graph (``prog.baked_graph``, run as traced, its
ATen ops and ``marvel::`` ops through the dispatcher) and the program's
executable, the bound function run eagerly; and what a call through a
kernel's ``marvel::`` op costs against a call of its entry point.

    python3 tools/time_baked_graph.py [--models NAME[,NAME]] [--rounds N]
                                      [--trace NAME]

For each of the six CNNs compiled at v4 with int8 PTQ of its parameters
(full width, random weights from seed 0, batch 8):

* wall time of one forward (host clock, each call ended by a
  synchronize), both forms in turns (graph, eager, eager, graph) for
  ``--rounds`` rounds, the median of 7 calls each time;
* device-busy time of one forward (``torch.profiler``'s CUPTI trace: the
  summed durations of every kernel it launches, each counted once), so
  host time = wall - busy;
* with ``--trace NAME``, the 15 ops of each of that model's forms with the
  most host (self CPU) time and the 15 with the most device time, from the
  same profiler.

Then, per kernel op on the ResNet50 v4 batch-8 shapes of its first conv
and GEMM launch: the host microseconds a call through the ``marvel::`` op
takes against a call of the module's entry point directly (enqueue time
of 200 back-to-back calls, no synchronize inside).  Prints the card, one
JSON line per model and one for the op costs.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

MODELS = ("lenet5", "vgg16", "resnet50", "mobilenetv1", "mobilenetv2",
          "densenet121")
BATCH = 8


def wall_ms(fn, n: int = 7) -> float:
    import torch

    fn()
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def profiled(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        fn()
        torch.cuda.synchronize()
    return trace


def busy_ms(trace):
    """Summed device time of the trace's device events (each kernel once,
    not again under the host op that launched it)."""
    from torch.autograd import DeviceType

    total = sum(e.self_device_time_total for e in trace.events()
                if e.device_type == DeviceType.CUDA)
    return total / 1e3 if total > 0 else None


def host_us(fn, n: int = 200) -> float:
    """Host microseconds a call, over ``n`` back-to-back calls."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t


def op_costs(dev) -> dict:
    """Host µs a call: through the marvel:: op, and the entry point."""
    import torch
    from repro_torch.kernels import fused_conv as fc
    from repro_torch.kernels import library
    from repro_torch.kernels import matmul_epilogue as me

    g = torch.Generator().manual_seed(0)
    x8 = torch.randint(-127, 128, (BATCH, 64, 64, 3), generator=g,
                       dtype=torch.int8).to(dev)
    w8 = torch.randint(-127, 128, (7, 7, 3, 64), generator=g,
                       dtype=torch.int8).to(dev)
    es, eb = torch.rand(64).to(dev), torch.randn(64).to(dev)
    x = torch.randn((BATCH, 16, 16, 64)).to(dev)
    w = torch.randn((64, 64)).to(dev)
    conv = dict(stride=2, padding="SAME", act="relu")
    cases = {
        "fused_conv (8,64,64,3) x (7,7,3,64)": (
            lambda: library.fused_conv_int8(x8, w8, es, eb, None, **conv),
            lambda: fc.fused_conv_int8(x8, w8, es, eb, None, **conv)),
        "matmul_epilogue (2048,64) x (64,64)": (
            lambda: library.matmul_epilogue(x, w, None, act="relu",
                                            scale=es, shift=eb),
            lambda: me.matmul_epilogue(x, w, None, act="relu", scale=es,
                                       shift=eb)),
    }
    out = {}
    with torch.inference_mode():
        for label, (through_op, direct) in cases.items():
            out[label] = {"op_us": host_us(through_op),
                          "entry_us": host_us(direct)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--trace", default="")
    opts = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_baked_graph: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import marvel
    from repro_torch.kernels import build
    from repro_torch.kernels.common import full_f32
    from repro_torch.launch.serve import random_images
    from repro_torch.models.cnn import get_cnn

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    build.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    for name in opts.models.split(","):
        init, apply, shape = get_cnn(name)
        params = init(torch.Generator().manual_seed(0), device=dev)
        x0 = torch.zeros((1, *shape), device=dev)
        xb = torch.from_numpy(np.stack(random_images(shape, BATCH))).to(dev)
        prog = marvel.compile(apply, x0, params=params, level="v4",
                              quantize=True)
        graph = prog.baked_graph(xb)

        def run_graph():  # as the program runs its bucket
            with torch.inference_mode(), full_f32():
                return graph(xb)

        forms = {"graph": run_graph, "eager": lambda: prog(xb)}
        walls = {"graph": [], "eager": []}
        for _ in range(opts.rounds):
            for form in ("graph", "eager", "eager", "graph"):
                walls[form].append(wall_ms(forms[form]))
        row = {"model": name, "batch": BATCH, "card": card}
        for form, fn in forms.items():
            trace = profiled(fn)
            busy = busy_ms(trace)
            wall = statistics.median(walls[form])
            row[form] = {"wall_ms": wall, "walls_ms": walls[form],
                         "busy_ms": busy,
                         "host_ms": None if busy is None else wall - busy}
            if name == opts.trace:
                for key in ("self_cpu_time_total", "self_device_time_total"):
                    print(f"{name}, {form} form, by {key}:", flush=True)
                    print(trace.key_averages().table(sort_by=key,
                                                     row_limit=15),
                          flush=True)
        print(json.dumps(row), flush=True)
    print(json.dumps({"op_costs": op_costs(dev), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
