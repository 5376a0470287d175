"""int8 weight quantization (paper step 3, the TFLite analogue): a copy of
the reference's ``quant/ptq.py::quantize_weight`` and ``dequantize``.

Per-output-channel symmetric int8: ``w ≈ w_int8 * scale``.  The quantized
GEMM runs through the ``mac`` extension (``layers.mac_matmul(x, None,
quant=...)``), the dequant folded after the int8 product.  PTQ of a whole
parameter tree (``marvel.compile(quantize=True)``) comes with a later slice.
"""
from __future__ import annotations

import torch


def quantize_weight(w: torch.Tensor) -> dict:
    """w: (..., d_in, d_out) -> ``{"w_int8", "scale"}`` per output channel,
    ``scale`` of shape (..., 1, d_out) in f32."""
    wf = w.float()
    scale = torch.clamp_min(wf.abs().amax(dim=-2, keepdim=True), 1e-8) / 127.0
    w_int8 = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"w_int8": w_int8, "scale": scale}


def dequantize(q: dict) -> torch.Tensor:
    return q["w_int8"].float() * q["scale"]
