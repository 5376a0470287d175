"""The paper's own model class: its six CNNs (LeNet-5*, MobileNetV1, VGG16,
ResNet50, MobileNetV2, DenseNet121).

Same graphs, layouts and dispatch sites as the reference's
``src/repro/models/cnn.py``: NHWC activations, HWIO weights, BN folded to a
per-channel affine (``scale``/``shift``), 64x64x3 inputs with a 2-class head
(LeNet-5*: 28x28x1, 10 classes).  Convs, dense layers and pools go through
the dispatch patterns, 1x1 stride-1 convs dispatch as ``matmul_epilogue``
GEMMs, ResNet50's skip-adds ride the conv/GEMM epilogues as ``residual=``
operands, and the mobile nets emit each depthwise-separable block as one
``sep_block`` site (fused at v3+, its two stage patterns below).

Parameters are plain nested dicts/lists of tensors.  ``init(gen)`` draws
them from a ``torch.Generator`` with the reference's shapes and
distributions; :func:`params_from_jax` carries the reference's own weights
across (as a numpy tree) so the two packages can be compared on the same
inputs.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.kernels import ref
from repro_torch.models.layers import ACTS, dense_init

# ---------------------------------------------------------------------------
# primitives (dispatch-routed)
# ---------------------------------------------------------------------------


def _conv_ref(x, w, b, *, stride, padding, groups, act, scale=None,
              shift=None, residual=None):
    y = ref.conv_nhwc(x, w, stride=stride, padding=padding, groups=groups)
    if b is not None:
        y = y + b
    if scale is not None:
        y = y * scale
    if shift is not None:
        y = y + shift
    if residual is not None:
        y = y + residual
    return ACTS[act](y)


def conv2d(x, w, b=None, *, stride=1, padding="SAME", groups=1, act="none",
           scale=None, shift=None, residual=None):
    """Conv + bias + folded-BN affine (+ residual-add) + act: one
    conv_mac/fusedmac site.  1x1 stride-1 convs are GEMMs over pixels and
    dispatch as ``matmul_epilogue`` (the (1, 1, Cin, Cout) kernel becomes a
    (Cin, Cout) matrix)."""
    if (groups == 1 and x.ndim == 4 and stride == 1
            and w.shape[0] == w.shape[1] == 1
            and padding in ("SAME", "VALID")):
        return dense(x, w.reshape(w.shape[2], w.shape[3]), b, act=act,
                     scale=scale, shift=shift, residual=residual)
    return dispatch.call(
        "fused_conv", _conv_ref, x, w, b,
        stride=stride, padding=padding, groups=groups, act=act,
        scale=scale, shift=shift, residual=residual,
    )


def _depthwise_ref(x, w, b, *, stride, padding, act, scale=None, shift=None):
    return _conv_ref(x, w, b, stride=stride, padding=padding,
                     groups=x.shape[-1], act=act, scale=scale, shift=shift)


def depthwise_conv2d(x, w, b=None, *, stride=1, padding="SAME", act="none",
                     scale=None, shift=None):
    """Depthwise conv (+ fused epilogue): one dw_mac site.  ``groups ==
    channels`` is implied by the (KH, KW, 1, C) weight shape."""
    return dispatch.call(
        "depthwise_conv", _depthwise_ref, x, w, b,
        stride=stride, padding=padding, act=act, scale=scale, shift=shift,
    )


def _sep_block_ref(x, w_dw, w_pw, *, stride, padding, dw_scale, dw_shift,
                   dw_act, pw_bias, pw_scale, pw_shift, pw_act):
    # the unfused form dispatches its two stage patterns, so below v3 the
    # depthwise (v2+) and conv (v1+) kernels still apply; the pointwise 1x1
    # goes through fused_conv, as in the reference, not matmul_epilogue
    y = depthwise_conv2d(x, w_dw, stride=stride, padding=padding, act=dw_act,
                         scale=dw_scale, shift=dw_shift)
    return dispatch.call(
        "fused_conv", _conv_ref, y, w_pw, pw_bias, stride=1, padding="SAME",
        groups=1, act=pw_act, scale=pw_scale, shift=pw_shift,
    )


def sep_block(x, w_dw, w_pw, *, stride=1, padding="SAME", dw_scale=None,
              dw_shift=None, dw_act="relu", pw_bias=None, pw_scale=None,
              pw_shift=None, pw_act="none"):
    """Depthwise-separable block (dw 3x3 -> 1x1 pw) as ONE dispatch site:
    fused at v3+ (the depthwise output never reaches device memory), the
    two-stage decomposition of :func:`_sep_block_ref` below."""
    return dispatch.call(
        "sep_block", _sep_block_ref, x, w_dw, w_pw,
        stride=stride, padding=padding, dw_scale=dw_scale, dw_shift=dw_shift,
        dw_act=dw_act, pw_bias=pw_bias, pw_scale=pw_scale, pw_shift=pw_shift,
        pw_act=pw_act,
    )


def _dense_ref(x, w, b, *, act, scale=None, shift=None, residual=None):
    with ref.full_f32():
        y = x @ w
    if b is not None:
        y = y + b
    if scale is not None:
        y = y * scale
    if shift is not None:
        y = y + shift
    if residual is not None:
        y = y + residual
    return ACTS[act](y)


def dense(x, w, b=None, *, act="none", scale=None, shift=None, residual=None):
    """GEMM + bias + optional folded-BN affine (+ residual-add) + act: one
    fusedmac site."""
    return dispatch.call("matmul_epilogue", _dense_ref, x, w, b, act=act,
                         scale=scale, shift=shift, residual=residual)


def _pool_ref(x, *, op, k=2, stride=2):
    # ref.pool_ref is the one source of truth for pool semantics, so the v0
    # baseline and the kernels' oracle cannot drift
    return ref.pool_ref(x, op=op, k=k, stride=stride)


def maxpool(x, k=2, stride=2):
    """Windowed max pool (VALID): one pool site."""
    return dispatch.call("pool", _pool_ref, x, op="max", k=k, stride=stride)


def avgpool_global(x):
    """Global average pool (N, H, W, C) -> (N, C): one pool site."""
    return dispatch.call("pool", _pool_ref, x, op="global_avg")


def avgpool2(x):
    """2x2 stride-2 average pool (VALID): one pool site."""
    return dispatch.call("pool", _pool_ref, x, op="avg", k=2, stride=2)


def _affine(x, s, b):  # folded batchnorm
    return x * s + b


# ---------------------------------------------------------------------------
# parameter init helpers
# ---------------------------------------------------------------------------


def _conv_init(gen, kh, kw, cin, cout, device, groups=1):
    fan_in = kh * kw * cin // groups
    w = torch.randn((kh, kw, cin // groups, cout), generator=gen)
    return (w / math.sqrt(fan_in)).to(device)


def _bn_init(c, device):
    return {"s": torch.ones(c, device=device),
            "b": torch.zeros(c, device=device)}


# ---------------------------------------------------------------------------
# LeNet-5* (paper Table 9)
# ---------------------------------------------------------------------------


def lenet5_init(gen, device="cpu"):
    return {
        "c1": {"w": _conv_init(gen, 6, 6, 1, 12, device),
               "b": torch.zeros(12, device=device)},
        "c2": {"w": _conv_init(gen, 6, 6, 12, 32, device),
               "b": torch.zeros(32, device=device)},
        "fc": {"w": dense_init(gen, (512, 10), device=device),
               "b": torch.zeros(10, device=device)},
    }


def lenet5_apply(p, x):
    """x: (B, 28, 28, 1) -> (B, 10)."""
    x = conv2d(x, p["c1"]["w"], p["c1"]["b"], stride=2, padding="VALID",
               act="relu")  # -> 12x12x12
    x = conv2d(x, p["c2"]["w"], p["c2"]["b"], stride=2, padding="VALID",
               act="relu")  # -> 4x4x32
    x = x.reshape(x.shape[0], -1)
    return dense(x, p["fc"]["w"], p["fc"]["b"])


# ---------------------------------------------------------------------------
# MobileNetV1 (depthwise separable; width 1.0, 64x64 input, 2-class head)
# ---------------------------------------------------------------------------

_MBV1_CFG = [  # (stride, cout) for each dw-separable block
    (1, 64), (2, 128), (1, 128), (2, 256), (1, 256),
    (2, 512), (1, 512), (1, 512), (1, 512), (1, 512), (1, 512),
    (2, 1024), (1, 1024),
]


def mobilenetv1_init(gen, device="cpu"):
    p = {"stem": {"w": _conv_init(gen, 3, 3, 3, 32, device),
                  "bn": _bn_init(32, device)}}
    cin = 32
    blocks = []
    for _, cout in _MBV1_CFG:
        blocks.append({
            "dw": {"w": _conv_init(gen, 3, 3, cin, cin, device, groups=cin),
                   "bn": _bn_init(cin, device)},
            "pw": {"w": _conv_init(gen, 1, 1, cin, cout, device),
                   "bn": _bn_init(cout, device)},
        })
        cin = cout
    p["blocks"] = blocks
    p["head"] = {"w": dense_init(gen, (cin, 2), device=device),
                 "b": torch.zeros(2, device=device)}
    return p


def mobilenetv1_apply(p, x):
    x = conv2d(x, p["stem"]["w"], stride=2, scale=p["stem"]["bn"]["s"],
               shift=p["stem"]["bn"]["b"], act="relu")
    for blk, (stride, _) in zip(p["blocks"], _MBV1_CFG):
        x = sep_block(x, blk["dw"]["w"], blk["pw"]["w"], stride=stride,
                      dw_scale=blk["dw"]["bn"]["s"],
                      dw_shift=blk["dw"]["bn"]["b"], dw_act="relu",
                      pw_scale=blk["pw"]["bn"]["s"],
                      pw_shift=blk["pw"]["bn"]["b"], pw_act="relu")
    x = avgpool_global(x)
    return dense(x, p["head"]["w"], p["head"]["b"])


# ---------------------------------------------------------------------------
# VGG16 (64x64 input)
# ---------------------------------------------------------------------------

_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512, "M"]


def vgg16_init(gen, device="cpu"):
    convs = []
    cin = 3
    for c in _VGG_CFG:
        if c == "M":
            continue
        convs.append({"w": _conv_init(gen, 3, 3, cin, c, device),
                      "b": torch.zeros(c, device=device)})
        cin = c
    return {
        "convs": convs,
        "fc1": {"w": dense_init(gen, (512 * 2 * 2, 512), device=device),
                "b": torch.zeros(512, device=device)},
        "fc2": {"w": dense_init(gen, (512, 2), device=device),
                "b": torch.zeros(2, device=device)},
    }


def vgg16_apply(p, x):
    ci = 0
    for c in _VGG_CFG:
        if c == "M":
            x = maxpool(x)
        else:
            blk = p["convs"][ci]
            x = conv2d(x, blk["w"], blk["b"], act="relu")
            ci += 1
    x = x.reshape(x.shape[0], -1)
    x = dense(x, p["fc1"]["w"], p["fc1"]["b"], act="relu")
    return dense(x, p["fc2"]["w"], p["fc2"]["b"])


# ---------------------------------------------------------------------------
# ResNet50 (bottlenecks; 64x64 input)
# ---------------------------------------------------------------------------

_R50_STAGES = [(3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)]


def resnet50_init(gen, device="cpu"):
    p = {"stem": {"w": _conv_init(gen, 7, 7, 3, 64, device),
                  "bn": _bn_init(64, device)}}
    cin = 64
    stages = []
    for n_blocks, width, stride in _R50_STAGES:
        blocks = []
        for b in range(n_blocks):
            s = stride if b == 0 else 1
            cout = width * 4
            blk = {
                "c1": {"w": _conv_init(gen, 1, 1, cin, width, device),
                       "bn": _bn_init(width, device)},
                "c2": {"w": _conv_init(gen, 3, 3, width, width, device),
                       "bn": _bn_init(width, device)},
                "c3": {"w": _conv_init(gen, 1, 1, width, cout, device),
                       "bn": _bn_init(cout, device)},
            }
            if s != 1 or cin != cout:
                blk["proj"] = {"w": _conv_init(gen, 1, 1, cin, cout, device),
                               "bn": _bn_init(cout, device)}
            blocks.append(blk)
            cin = cout
        stages.append(blocks)
    p["stages"] = stages
    p["head"] = {"w": dense_init(gen, (cin, 2), device=device),
                 "b": torch.zeros(2, device=device)}
    return p


def resnet50_apply(p, x):
    x = conv2d(x, p["stem"]["w"], stride=2, scale=p["stem"]["bn"]["s"],
               shift=p["stem"]["bn"]["b"], act="relu")
    x = maxpool(x, 3, 2)
    for stage, (_, _, stage_stride) in zip(p["stages"], _R50_STAGES):
        for bi, blk in enumerate(stage):
            s = stage_stride if bi == 0 else 1
            res = x
            y = conv2d(x, blk["c1"]["w"], scale=blk["c1"]["bn"]["s"],
                       shift=blk["c1"]["bn"]["b"], act="relu")
            y = conv2d(y, blk["c2"]["w"], stride=s, scale=blk["c2"]["bn"]["s"],
                       shift=blk["c2"]["bn"]["b"], act="relu")
            if "proj" in blk:
                res = conv2d(x, blk["proj"]["w"], stride=s,
                             scale=blk["proj"]["bn"]["s"],
                             shift=blk["proj"]["bn"]["b"])
            # the skip-add + relu ride inside the c3 site (acc_mac epilogue)
            x = conv2d(y, blk["c3"]["w"], scale=blk["c3"]["bn"]["s"],
                       shift=blk["c3"]["bn"]["b"], act="relu", residual=res)
    x = avgpool_global(x)
    return dense(x, p["head"]["w"], p["head"]["b"])


# ---------------------------------------------------------------------------
# MobileNetV2 (inverted residuals)
# ---------------------------------------------------------------------------

_MBV2_CFG = [  # (expand, cout, n, stride)
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
    (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]
# flattened per-block (expand, stride)
_MBV2_FLAT = [
    (expand, stride if b == 0 else 1)
    for expand, cout, n, stride in _MBV2_CFG
    for b in range(n)
]


def mobilenetv2_init(gen, device="cpu"):
    p = {"stem": {"w": _conv_init(gen, 3, 3, 3, 32, device),
                  "bn": _bn_init(32, device)}}
    cin = 32
    blocks = []
    for expand, cout, n, _ in _MBV2_CFG:
        for _ in range(n):
            mid = cin * expand
            blk = {}
            if expand != 1:
                blk["ex"] = {"w": _conv_init(gen, 1, 1, cin, mid, device),
                             "bn": _bn_init(mid, device)}
            blk["dw"] = {"w": _conv_init(gen, 3, 3, mid, mid, device,
                                         groups=mid),
                         "bn": _bn_init(mid, device)}
            blk["pw"] = {"w": _conv_init(gen, 1, 1, mid, cout, device),
                         "bn": _bn_init(cout, device)}
            blocks.append(blk)
            cin = cout
    p["blocks"] = blocks
    p["last"] = {"w": _conv_init(gen, 1, 1, cin, 1280, device),
                 "bn": _bn_init(1280, device)}
    p["head"] = {"w": dense_init(gen, (1280, 2), device=device),
                 "b": torch.zeros(2, device=device)}
    return p


def mobilenetv2_apply(p, x):
    x = conv2d(x, p["stem"]["w"], stride=2, scale=p["stem"]["bn"]["s"],
               shift=p["stem"]["bn"]["b"], act="relu6")
    for blk, (expand, stride) in zip(p["blocks"], _MBV2_FLAT):
        res = x
        y = x
        if expand != 1:
            y = conv2d(y, blk["ex"]["w"], scale=blk["ex"]["bn"]["s"],
                       shift=blk["ex"]["bn"]["b"], act="relu6")
        y = sep_block(y, blk["dw"]["w"], blk["pw"]["w"], stride=stride,
                      dw_scale=blk["dw"]["bn"]["s"],
                      dw_shift=blk["dw"]["bn"]["b"], dw_act="relu6",
                      pw_scale=blk["pw"]["bn"]["s"],
                      pw_shift=blk["pw"]["bn"]["b"], pw_act="none")
        # the skip-add is a plain add outside the sep_block site
        if stride == 1 and res.shape == y.shape:
            y = y + res
        x = y
    x = conv2d(x, p["last"]["w"], scale=p["last"]["bn"]["s"],
               shift=p["last"]["bn"]["b"], act="relu6")
    x = avgpool_global(x)
    return dense(x, p["head"]["w"], p["head"]["b"])


# ---------------------------------------------------------------------------
# DenseNet121 (growth 32)
# ---------------------------------------------------------------------------

_DN_CFG = [6, 12, 24, 16]
_GROWTH = 32


def densenet121_init(gen, device="cpu"):
    p = {"stem": {"w": _conv_init(gen, 7, 7, 3, 64, device),
                  "bn": _bn_init(64, device)}}
    cin = 64
    blocks = []
    for bi, n_layers in enumerate(_DN_CFG):
        layers_ = []
        for _ in range(n_layers):
            layers_.append({
                "bn1": _bn_init(cin, device),
                "c1": {"w": _conv_init(gen, 1, 1, cin, 4 * _GROWTH, device)},
                "bn2": _bn_init(4 * _GROWTH, device),
                "c2": {"w": _conv_init(gen, 3, 3, 4 * _GROWTH, _GROWTH,
                                       device)},
            })
            cin += _GROWTH
        block = {"layers": layers_}
        if bi < len(_DN_CFG) - 1:
            block["trans"] = {"bn": _bn_init(cin, device),
                              "w": _conv_init(gen, 1, 1, cin, cin // 2,
                                              device)}
            cin = cin // 2
        blocks.append(block)
    p["blocks"] = blocks
    p["bn_f"] = _bn_init(cin, device)
    p["head"] = {"w": dense_init(gen, (cin, 2), device=device),
                 "b": torch.zeros(2, device=device)}
    return p


def densenet121_apply(p, x):
    # the stem is the only post-conv BN + act chain; the dense layers are
    # pre-activation (BN-relu-conv), and that BN-relu and the channel concat
    # stay outside any dispatch site
    x = conv2d(x, p["stem"]["w"], stride=2, scale=p["stem"]["bn"]["s"],
               shift=p["stem"]["bn"]["b"], act="relu")
    x = maxpool(x, 3, 2)
    for block in p["blocks"]:
        for lyr in block["layers"]:
            y = ACTS["relu"](_affine(x, lyr["bn1"]["s"], lyr["bn1"]["b"]))
            y = conv2d(y, lyr["c1"]["w"])
            y = ACTS["relu"](_affine(y, lyr["bn2"]["s"], lyr["bn2"]["b"]))
            y = conv2d(y, lyr["c2"]["w"])
            x = torch.cat([x, y], dim=-1)
        if "trans" in block:
            x = ACTS["relu"](_affine(x, block["trans"]["bn"]["s"],
                                     block["trans"]["bn"]["b"]))
            x = conv2d(x, block["trans"]["w"])
            x = avgpool2(x)
    x = ACTS["relu"](_affine(x, p["bn_f"]["s"], p["bn_f"]["b"]))
    x = avgpool_global(x)
    return dense(x, p["head"]["w"], p["head"]["b"])


# ---------------------------------------------------------------------------
# registry + weights from the reference
# ---------------------------------------------------------------------------

CNN_MODELS = {
    "lenet5": (lenet5_init, lenet5_apply, (28, 28, 1)),
    "mobilenetv1": (mobilenetv1_init, mobilenetv1_apply, (64, 64, 3)),
    "resnet50": (resnet50_init, resnet50_apply, (64, 64, 3)),
    "vgg16": (vgg16_init, vgg16_apply, (64, 64, 3)),
    "mobilenetv2": (mobilenetv2_init, mobilenetv2_apply, (64, 64, 3)),
    "densenet121": (densenet121_init, densenet121_apply, (64, 64, 3)),
}


def get_cnn(name: str):
    """(init, apply, input shape) of a ported CNN."""
    if name not in CNN_MODELS:
        raise KeyError(f"unknown CNN {name!r}; known: {sorted(CNN_MODELS)}")
    return CNN_MODELS[name]


def _tree_map(fn, tree, like):
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError(f"param keys {sorted(getattr(tree, 'keys', list)())}"
                             f" differ from {sorted(like)}")
        return {k: _tree_map(fn, tree[k], like[k]) for k in like}
    if isinstance(like, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError(f"param list of {len(like)} expected")
        return [_tree_map(fn, t, lk) for t, lk in zip(tree, like)]
    return fn(tree, like)


def params_from_jax(name: str, tree, device="cpu"):
    """The reference's params for model ``name`` — a numpy pytree such as
    ``jax.tree_util.tree_map(np.asarray, init(PRNGKey(0)))`` — as this
    package's params, with the same nesting and HWIO layout, on ``device``.
    Raises if the tree's structure or shapes differ from the port's."""
    init, _, _ = get_cnn(name)
    like = init(torch.Generator().manual_seed(0), device="meta")

    def convert(a, lk):
        arr = np.asarray(a)
        if tuple(arr.shape) != tuple(lk.shape):
            raise ValueError(f"param shape {arr.shape} != {tuple(lk.shape)}")
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)

    return _tree_map(convert, tree, like)
