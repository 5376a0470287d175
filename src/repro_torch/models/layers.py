"""Model building blocks, the counterparts of the reference's
``models/layers.py``: the activation table and init distributions the CNNs
use, and the transformer layers of the LM families (norms, GEMM sites,
embeddings, RoPE and sinusoidal positions, attention with its int8 KV cache,
the encoder-decoder's cross-attention, MLP).

Every fusable compute pattern goes through :func:`repro_torch.core.
dispatch.call` under the reference's pattern name and argument order, so
the extension table can substitute a kernel without touching model code and
the profiler's site counts match the reference's.  Params are plain dicts of
tensors; the functions are pure except :func:`attention_decode`, which
writes the new K/V into the cache it is given (see its docstring).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import dispatch
from repro_torch.kernels.common import full_f32


def dense_init(gen: torch.Generator, shape, dtype=torch.float32, scale=None,
               device="cpu") -> torch.Tensor:
    """N(0, 1) * scale, scale = 1/sqrt(fan_in) by default (fan_in = the
    leading dim of a matrix, else the product of all but the last), drawn
    on the generator's device and returned on ``device`` in ``dtype``."""
    fan_in = shape[0] if len(shape) == 2 else math.prod(shape[:-1])
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return w.to(dtype=dtype, device=device)


ACTS = {
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": lambda x: torch.clamp_min(x, 0.0),
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "none": lambda x: x,
}


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def _rms_norm_ref(x, scale, eps):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rms_norm(x, scale, eps=1e-6):
    return dispatch.call("rms_norm", _rms_norm_ref, x, scale, eps)


def _residual_rmsnorm_ref(res, x, scale, eps):
    """Residual add + RMSNorm as one pattern (the add2i analogue): returns
    ``(new_residual, normed)``.  The baseline rounds ``res + x`` to the
    working type before it normalises, as the reference's baseline does;
    the kernel normalises the unrounded f32 sum."""
    new_res = res + x
    return new_res, _rms_norm_ref(new_res, scale, eps)


def residual_rmsnorm(res, x, scale, eps=1e-6):
    return dispatch.call("residual_rmsnorm", _residual_rmsnorm_ref, res, x,
                         scale, eps)


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm (RWKV's) in f32 with the population variance, cast back to
    x's dtype; not a dispatch site, as in the reference."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# matmul patterns (mac / fusedmac)
# ---------------------------------------------------------------------------


def _matmul_ref(x, w):
    with full_f32():
        return torch.matmul(x, w)


def mac_matmul(x, w, quant=None):
    """GEMM through the mac extension point; ``quant`` (``{"w_int8",
    "scale"}``) takes the int8-weight pattern, whose baseline runs the
    product in bf16 as the reference's does."""
    if quant is not None:
        def _quant_ref(x, q):
            with full_f32():
                acc = torch.matmul(x.to(torch.bfloat16),
                                   q["w_int8"].to(torch.bfloat16))
            return (acc * q["scale"]).to(x.dtype)

        return dispatch.call("mac_matmul_int8", _quant_ref, x, quant)
    return dispatch.call("mac_matmul", _matmul_ref, x, w)


def _matmul_epilogue_ref(x, w, b, act, residual=None):
    with full_f32():
        y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    if residual is not None:
        y = y + residual
    return ACTS[act](y)


def matmul_epilogue(x, w, b=None, act="none", residual=None):
    """fusedmac: GEMM + bias + activation as one pattern; ``residual`` (by
    keyword, so the profiler credits acc_mac) is added in the epilogue."""
    if residual is not None:
        return dispatch.call("matmul_epilogue", _matmul_epilogue_ref, x, w, b,
                             act, residual=residual)
    return dispatch.call("matmul_epilogue", _matmul_epilogue_ref, x, w, b, act)


# ---------------------------------------------------------------------------
# embeddings & RoPE
# ---------------------------------------------------------------------------


def embed_init(gen, vocab, d_model, dtype, device="cpu"):
    return {"table": dense_init(gen, (vocab, d_model), dtype, scale=1.0,
                                device=device)}


def embed_lookup(params, tokens):
    return F.embedding(tokens, params["table"])


def embed_logits(params, x):
    with full_f32():
        return torch.matmul(x, params["table"].t())


def rope_freqs(d_head, theta, device=None):
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def sinusoidal_positions(seq, d_model, dtype=torch.float32, device=None):
    """The (seq, d_model) sinusoidal table in the reference's op order (sin
    of the f32 angle ``pos * div`` in the even columns, cos in the odd),
    then cast to ``dtype``.  ``exp``, ``sin`` and ``cos`` are evaluated in
    f64 and rounded once to f32, as XLA folds the reference's table, which
    depends on no input, at compile time; PyTorch's f32 versions move the
    angles up to 1500 rad by up to 8e-6."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    expo = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
    div = torch.exp((expo * (-math.log(10000.0) / d_model)).double()).float()
    angle = (pos * div).double()
    pe = torch.zeros((seq, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle).float()
    pe[:, 1::2] = torch.cos(angle).float()
    return pe.to(dtype)


def apply_rope(x, positions, theta=10000.0):
    """x: (..., S, H, dh), rotate-half RoPE with f32 angles; positions:
    (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs  # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention — naive / chunked / local baselines; zol is the chunked pattern
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _naive_attention(q, k, v, *, causal, q_offset=0, kv_len=None):
    """q: (B, Sq, K, G, dh) grouped; k, v: (B, Skv, K, dh).  Materialises
    the Sq x Skv scores (the scores product in the operands' type, as the
    reference's einsum)."""
    sq, skv, dh = q.shape[1], k.shape[1], q.shape[-1]
    with full_f32():
        scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).float()
    scores = scores / math.sqrt(dh)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(skv, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask, scores, NEG_INF)
    if kv_len is not None:
        valid = torch.arange(skv, device=q.device)[None, :] < kv_len[:, None]
        scores = torch.where(valid[:, None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    with full_f32():
        return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def _chunked_attention(q, k, v, *, causal, q_offset=0, chunk=512,
                       kv_len=None):
    """Streaming-softmax attention over KV chunks of ``chunk`` keys, O(Sq *
    chunk) temporaries: the schedule a flash kernel pipelines.  Returns
    (out (B, Sq, K, G, dv), log-sum-exp (B, K, G, Sq))."""
    b, sq, kh, g, dh = q.shape
    dv = v.shape[-1]
    skv = k.shape[1]
    chunk = min(chunk, skv)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qpos = torch.arange(sq, device=q.device) + q_offset
    scale = 1.0 / math.sqrt(dh)
    acc = torch.zeros((b, kh, g, sq, dv), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, kh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    den = torch.zeros((b, kh, g, sq), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        kci = k[:, ci * chunk:(ci + 1) * chunk]
        vci = v[:, ci * chunk:(ci + 1) * chunk]
        kpos = ci * chunk + torch.arange(chunk, device=q.device)
        with full_f32():
            s = torch.einsum("bqkgd,bskd->bkgqs", q, kci).float() * scale
        mask = torch.ones((sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask = qpos[:, None] >= kpos[None, :]
        mask = mask & (kpos < skv)[None, :]
        if kv_len is not None:
            mask = mask[None] & (kpos[None, :] < kv_len[:, None])[:, None, :]
            s = torch.where(mask[:, None, None], s, NEG_INF)
        else:
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        den = den * corr + p.sum(dim=-1)
        with full_f32():
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vci.dtype), vci)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp_min(den[..., None], 1e-30)
    out = out.permute(0, 3, 1, 2, 4).to(q.dtype)  # (B, Sq, K, G, dv)
    lse = m + torch.log(torch.clamp_min(den, 1e-30))
    return out, lse


def _local_attention(q, k, v, *, window, q_offset=0):
    """Blocked sliding-window causal attention: each block of ``window``
    queries attends to its own and the previous block (exact for window <=
    block size)."""
    b, sq, kh, g, dh = q.shape
    blk = window
    n_blk = -(-sq // blk)
    pad = n_blk * blk - sq
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = 1.0 / math.sqrt(dh)
    qpos = torch.arange(blk, device=q.device)
    kpos = torch.arange(2 * blk, device=q.device) - blk
    mask = (qpos[:, None] >= kpos[None, :]) & (
        (qpos[:, None] - kpos[None, :]) < window)
    mask0 = mask & (kpos[None, :] >= 0)  # block 0 has no previous block
    k_prev, v_prev = torch.zeros_like(k[:, :blk]), torch.zeros_like(v[:, :blk])
    outs = []
    for bi in range(n_blk):
        sl = slice(bi * blk, (bi + 1) * blk)
        q_i, k_i, v_i = q[:, sl], k[:, sl], v[:, sl]
        kk = torch.cat([k_prev, k_i], dim=1)
        vv = torch.cat([v_prev, v_i], dim=1)
        with full_f32():
            s = torch.einsum("bqkgd,bskd->bkgqs", q_i, kk).float() * scale
        s = torch.where(mask if bi > 0 else mask0, s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(vv.dtype)
        with full_f32():
            outs.append(torch.einsum("bkgqs,bskd->bqkgd", p, vv))
        k_prev, v_prev = k_i, v_i
    return torch.cat(outs, dim=1)[:, :sq]


def quantize_kv_int8(x):
    """Per-(position, head) symmetric int8 for the KV cache: x (..., dh) ->
    (int8 codes, f32 scales (...,)); scale = max(amax, 1e-8) / 127, codes
    rounded half to even and clipped to +-127."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) / 127.0
    q = torch.round(xf / scale[..., None])
    return torch.clamp(q, -127.0, 127.0).to(torch.int8), scale


def _flash_attention_ref(q, k, v, *, causal, q_offset=0, impl="chunked",
                         chunk=512, window=None, kv_len=None, k_scale=None,
                         v_scale=None):
    if k_scale is not None:
        # int8 KV cache: dequantize inside the dispatched pattern, so the
        # cache stays int8 in device memory up to the kernel boundary
        k = (k.float() * k_scale[..., None]).to(q.dtype)
        v = (v.float() * v_scale[..., None]).to(q.dtype)
    if window is not None:
        return _local_attention(q, k, v, window=window, q_offset=q_offset)
    if impl == "naive":
        return _naive_attention(q, k, v, causal=causal, q_offset=q_offset,
                                kv_len=kv_len)
    return _chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                              chunk=chunk, kv_len=kv_len)[0]


def attention_core(q, k, v, **kw):
    """Grouped attention through the zol extension point.  q: (B, Sq, K, G,
    dh); k, v: (B, Skv, K, dh)."""
    return dispatch.call("flash_attention", _flash_attention_ref, q, k, v,
                         **kw)


# ---------------------------------------------------------------------------
# the attention layer (GQA, optional qk_norm / biases / RoPE)
# ---------------------------------------------------------------------------


def attn_init(gen, cfg, dtype, device="cpu"):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    shapes = {"wq": (d, h * dh), "wk": (d, kv * dh), "wv": (d, kv * dh),
              "wo": (h * dh, d)}
    p = {name: dense_init(gen, shape, dtype, device=device)
         for name, shape in shapes.items()}
    full = dict(dtype=dtype, device=device)
    if cfg.attn_bias:
        p["bq"] = torch.zeros(h * dh, **full)
        p["bk"] = torch.zeros(kv * dh, **full)
        p["bv"] = torch.zeros(kv * dh, **full)
        p["bo"] = torch.zeros(d, **full)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(dh, **full)
        p["k_norm"] = torch.ones(dh, **full)
    return p


def _project_qkv(p, x, cfg, positions):
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = matmul_epilogue(x, p["wq"], p.get("bq"))
    k = matmul_epilogue(x, p["wk"], p.get("bk"))
    v = matmul_epilogue(x, p["wv"], p.get("bv"))
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, kv, dh)
    v = v.reshape(b, s, kv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(p, x, cfg, *, positions=None, causal=True, window=None,
              attn_impl="chunked", chunk=512):
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = _project_qkv(p, x, cfg, positions)
    qg = q.reshape(b, s, kv, h // kv, dh)
    out = attention_core(qg, k, v, causal=causal, impl=attn_impl,
                         chunk=chunk, window=window)
    out = out.reshape(b, s, h * dh)
    return matmul_epilogue(out, p["wo"], p.get("bo"))


def cross_attention(p, x, enc_kv, cfg, attn_impl="chunked", chunk=512):
    """x: the decoder stream (B, S, d); enc_kv: (k, v) precomputed (B, Se,
    K, dh) by :func:`encoder_kv`; every query sees every frame."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = matmul_epilogue(x, p["wq"], p.get("bq")).reshape(b, s, h, dh)
    k, v = enc_kv
    qg = q.reshape(b, s, kv, h // kv, dh)
    out = attention_core(qg, k, v, causal=False, impl=attn_impl, chunk=chunk)
    out = out.reshape(b, s, h * dh)
    return matmul_epilogue(out, p["wo"], p.get("bo"))


def encoder_kv(p, enc_out, cfg):
    """The cross-attention's K and V of the encoder output (B, Se, d), each
    (B, Se, K, dh)."""
    b, se, _ = enc_out.shape
    kv, dh = cfg.n_kv_heads, cfg.d_head
    k = matmul_epilogue(enc_out, p["wk"], p.get("bk")).reshape(b, se, kv, dh)
    v = matmul_epilogue(enc_out, p["wv"], p.get("bv")).reshape(b, se, kv, dh)
    return k, v


def attention_decode(p, x, cache, cache_index, cfg, *, window=None):
    """Single-token decode.  x: (B, 1, d); cache: {"k", "v"} (B, Smax, K,
    dh), int8 with ``k_scale``/``v_scale`` (B, Smax, K) planes when the
    cache is quantized; cache_index: (B,) per-lane positions.

    Each lane's new K/V is written **in place** into ``cache`` at its
    position (clamped to the last row, as ``dynamic_update_slice`` clamps;
    ``% Smax`` with a rolling window), and attention runs over the lane's
    first ``kv_len = min(index + 1, Smax)`` rows, so stale rows of a
    previous occupant never contribute.  A step repeated at the same index
    (a retry, or a warmup on a live pool) rewrites the same rows, which the
    lane's real step rewrites before it reads them.  Returns (out, cache).
    """
    b = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    positions = cache_index[:, None] if cfg.rope else None
    q, k, v = _project_qkv(p, x, cfg, positions)
    smax = cache["k"].shape[1]
    idx = cache_index.long()
    slot = idx % smax if window is not None else idx.clamp(0, smax - 1)
    lanes = torch.arange(b, device=x.device)
    quantized = "k_scale" in cache
    attn_kw = {}
    if quantized:
        k_w, k_s = quantize_kv_int8(k)  # (B, 1, K) scales
        v_w, v_s = quantize_kv_int8(v)
        cache["k_scale"][lanes, slot] = k_s[:, 0]
        cache["v_scale"][lanes, slot] = v_s[:, 0]
        attn_kw = {"k_scale": cache["k_scale"], "v_scale": cache["v_scale"]}
    else:
        k_w, v_w = k, v
    cache["k"][lanes, slot] = k_w[:, 0]
    cache["v"][lanes, slot] = v_w[:, 0]
    kv_len = torch.clamp(idx + 1, max=smax)
    qg = q.reshape(b, 1, kv, h // kv, dh)
    out = attention_core(qg, cache["k"], cache["v"], causal=False,
                         impl="naive", kv_len=kv_len, **attn_kw)
    out = out.reshape(b, 1, h * dh)
    return matmul_epilogue(out, p["wo"], p.get("bo")), cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_init(gen, cfg, dtype, device="cpu", d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    names = (("wg", (d, f)), ("wu", (d, f)), ("wd", (f, d)))
    if not cfg.mlp_gated:
        names = names[1:]
    p = {name: dense_init(gen, shape, dtype, device=device)
         for name, shape in names}
    if not cfg.mlp_gated and cfg.attn_bias:
        p["bu"] = torch.zeros(f, dtype=dtype, device=device)
        p["bd"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def mlp(p, x, cfg, residual=None):
    """MLP block; ``residual`` (the pre-block stream) is added in the
    out-projection's GEMM epilogue (acc_mac), and the result is the new
    residual stream."""
    if cfg.mlp_gated:
        g = matmul_epilogue(x, p["wg"], None, cfg.act)  # fusedmac pattern
        u = mac_matmul(x, p["wu"])
        h = g * u
        if residual is not None:
            return matmul_epilogue(h, p["wd"], residual=residual)
        return mac_matmul(h, p["wd"])
    h = matmul_epilogue(x, p["wu"], p.get("bu"), cfg.act)
    return matmul_epilogue(h, p["wd"], p.get("bd"), residual=residual)
