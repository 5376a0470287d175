#!/usr/bin/env python3
"""The six CNNs' reports from both packages, side by side, on the CPU: the
chess_rewrite stats of ``marvel.compile(..., level="v4")`` with the
baseline backend and with the kernels (the reference's ``pallas``, the
port's ``cuda``, whose wrappers run their plain versions on the CPU), and
the rv32 v0 -> v4 speedups, at batch 1 with the reference's own weights.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/report_parity.py \
        [--models NAME[,NAME]]

A comparison tool, like the tests: it imports the reference (JAX) beside
the port and runs on the CPU only.  Prints one JSON line per model.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

MODELS = ("lenet5", "mobilenetv1", "resnet50", "vgg16", "mobilenetv2",
          "densenet121")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default=",".join(MODELS))
    opts = ap.parse_args()

    import jax
    import numpy as np
    import torch
    from repro import marvel as jmarvel
    from repro.models import cnn as jcnn
    from repro_torch import marvel as tmarvel
    from repro_torch.models import cnn as tcnn

    for name in opts.models.split(","):
        init, japply, in_shape = jcnn.get_cnn(name)
        jp = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))
        tp = tcnn.params_from_jax(name, jp)
        _, tapply, _ = tcnn.get_cnn(name)
        x = np.zeros((1, *in_shape), np.float32)
        row = {"model": name}
        for jb, tb in (("ref", "ref"), ("pallas", "cuda")):
            jr = jmarvel.compile(japply, x, params=jp, level="v4",
                                 backend=jb, precompile=False,
                                 tuned="off").report
            tr = tmarvel.compile(tapply, torch.from_numpy(x), params=tp,
                                 level="v4", backend=tb, device="cpu",
                                 precompile=False).report
            row[f"reference {jb}"] = jr.rewrite_stats
            row[f"port {tb}"] = tr.rewrite_stats
            row["rv32_speedup_v4"] = {"reference": jr.rv32_speedup_v4,
                                      "port": tr.rv32_speedup_v4}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
