"""int8 weight quantization (paper step 3, the TFLite analogue): a copy of
the reference's ``quant/ptq.py::quantize_weight`` and ``dequantize``.

Per-output-channel symmetric int8: ``w ≈ w_int8 * scale``.  The quantized
GEMM runs through the ``mac`` extension (``layers.mac_matmul(x, None,
quant=...)``), the dequant folded after the int8 product.  PTQ of a whole
parameter tree (``marvel.compile(quantize=True)``) is :func:`quantize_tree`
/ :func:`fake_quantize_tree`, the reference's, over nested dicts, lists and
tuples of tensors.
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


def _map_weight_leaves(params, transform, predicate=None):
    """Shared PTQ traversal: apply ``transform`` to every eligible weight
    leaf (>= 2-D floating, predicate-approved), keep others as-is.  Leaves
    are visited in the order ``jax.tree_util`` flattens the same tree
    (dict keys sorted, ``None`` no leaf) and named by their path
    (``"blocks/0/dw/w"``), so ``{"quantized", "total"}`` and a predicate's
    names agree with the reference's."""
    counts = {"quantized": 0, "total": 0}

    def visit(node, path):
        if isinstance(node, dict):
            return {k: visit(node[k], path + (str(k),))
                    for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            out = [visit(v, path + (str(i),)) for i, v in enumerate(node)]
            return type(node)(out)
        if node is None:
            return None
        counts["total"] += 1
        eligible = (isinstance(node, torch.Tensor) and node.ndim >= 2
                    and node.dtype.is_floating_point
                    and (predicate is None or predicate("/".join(path),
                                                        node)))
        counts["quantized"] += int(eligible)
        return transform(node) if eligible else node

    return visit(params, ()), counts


def quantize_tree(params, predicate=None):
    """Quantize every >= 2-D floating leaf (weights); keep others as-is.

    Returns ``(tree, {"quantized": n, "total": m})`` where quantized leaves
    become ``{"w_int8", "scale"}`` dicts.  ``predicate(name, leaf) -> bool``
    can exclude leaves (e.g. norm scales)."""
    return _map_weight_leaves(params, quantize_weight, predicate)


def fake_quantize_tree(params, predicate=None):
    """int8 PTQ with the tree structure preserved: each eligible weight is
    quantized then dequantized in place (``w -> dequantize(quantize(w))``,
    in w's dtype and on w's device), so the result drops into any model
    apply unchanged while carrying exactly the int8 rounding error of the
    deployed artifact.  Returns ``(params_like_tree, {"quantized": n,
    "total": m})``."""
    return _map_weight_leaves(
        params, lambda w: dequantize(quantize_weight(w)).to(w.dtype),
        predicate)


def quantized_bytes(params) -> int:
    """Model size after PTQ (Table 10 DM analogue)."""
    q, _ = quantize_tree(params)
    total = 0

    def visit(node):
        nonlocal total
        if isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)
        elif isinstance(node, torch.Tensor):
            total += node.numel() * node.element_size()

    visit(q)
    return total
