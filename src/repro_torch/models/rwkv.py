"""RWKV-6 "Finch" (arXiv:2404.05892), the counterpart of the reference's
``models/rwkv.py``: attention-free, with a data-dependent decay.

The full-sequence WKV runs as a chunked linear-attention recurrence through
the ``wkv_chunk`` dispatch site (the ``zol`` rung of the ``rnn_lm`` ladder,
:mod:`repro_torch.kernels.wkv_chunk`); its baseline is the chunked plain
form :func:`repro_torch.kernels.ref.wkv_chunk_ref`.  Decode is the
token-by-token recurrence on an (N, N) state per head, with no position
axis.

The dispatch sites are the reference's, site for site: per layer eight
``mac_matmul`` (r, k, v, g, the two decay LoRA products, ``cm_k``,
``cm_r``); the output and down projections ``wo`` and ``cm_v`` through
``matmul_epilogue`` in the full-sequence form and through ``mac_matmul`` in
decode; one ``wkv_chunk`` in the full-sequence form.

The reference's simplifications are kept: token-shift mixing uses static
lerp coefficients, and the data-dependent decay runs through the low-rank
tanh path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import dispatch
from repro_torch.kernels.common import full_f32
from repro_torch.kernels.ref import wkv_chunk_ref
from repro_torch.models.layers import (
    dense_init, layer_norm, mac_matmul, matmul_epilogue,
)

DECAY_LORA = 64


def rwkv_layer_init(gen: torch.Generator, cfg, dtype, device="cpu") -> dict:
    """One layer's params with the reference's distributions; ``w0`` and
    ``u`` stay f32 whatever ``dtype`` is."""
    d, n = cfg.d_model, cfg.rwkv_head_dim
    h = d // n
    f = cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    ones = lambda: torch.ones(d, **kw)  # noqa: E731
    zeros = lambda: torch.zeros(d, **kw)  # noqa: E731
    half = lambda: torch.full((d,), 0.5, **kw)  # noqa: E731
    dense = lambda shape, scale=None: dense_init(  # noqa: E731
        gen, shape, dtype, scale=scale, device=device)
    p = {"ln1_s": ones(), "ln1_b": zeros(), "ln2_s": ones(), "ln2_b": zeros(),
         # time-mix
         "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_w": half(),
         "mu_g": half()}
    p["wr"] = dense((d, d))
    p["wk"] = dense((d, d))
    p["wv"] = dense((d, d))
    p["wg"] = dense((d, d))
    p["w0"] = torch.full((d,), -2.0, dtype=torch.float32, device=device)
    p["w_lora_a"] = dense((d, DECAY_LORA))
    p["w_lora_b"] = dense((DECAY_LORA, d), scale=0.1)
    p["u"] = (torch.randn((h, n), generator=gen, device=gen.device) * 0.1
              ).to(device=device, dtype=torch.float32)
    p["ln_x_s"], p["ln_x_b"] = ones(), zeros()
    p["wo"] = dense((d, d))
    # channel-mix
    p["mu_ck"], p["mu_cr"] = half(), half()
    p["cm_k"] = dense((d, f))
    p["cm_v"] = dense((f, d))
    p["cm_r"] = dense((d, d))
    return p


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu


def _shift(x):
    """x: (B, S, d) -> the previous-token stream (zeros at t = 0)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _decay(p, xw):
    """Data-dependent log-decay ``lw = -exp(w0 + tanh(xw A) B)`` (< 0), in
    f32."""
    lora = mac_matmul(torch.tanh(mac_matmul(xw, p["w_lora_a"])),
                      p["w_lora_b"])
    return -torch.exp(p["w0"] + lora.float())


def time_mix(p, x, cfg, s0=None, chunk=64):
    """WKV time-mixing over a full sequence, x: (B, S, d) -> (out, s_final).
    S is zero-padded to a multiple of ``chunk`` for the recurrence (zero k,
    v and lw leave the state as it is), and the padding dropped after."""
    b, s_len, d = x.shape
    n = cfg.rwkv_head_dim
    h = d // n
    xp = _shift(x)
    r = mac_matmul(_lerp(x, xp, p["mu_r"]), p["wr"])
    k = mac_matmul(_lerp(x, xp, p["mu_k"]), p["wk"])
    v = mac_matmul(_lerp(x, xp, p["mu_v"]), p["wv"])
    g = mac_matmul(_lerp(x, xp, p["mu_g"]), p["wg"])
    lw = _decay(p, _lerp(x, xp, p["mu_w"]))
    pad = (-s_len) % chunk
    r_, k_, v_, lw_ = (F.pad(t.reshape(b, s_len, h, n).float(),
                             (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
    if s0 is None:
        s0 = torch.zeros((b, h, n, n), dtype=torch.float32, device=x.device)
    out, s_final = dispatch.call(
        "wkv_chunk", wkv_chunk_ref, r_, k_, v_, lw_, p["u"], s0,
        min(chunk, r_.shape[1]))
    out = out[:, :s_len].reshape(b, s_len, d).to(x.dtype)
    out = layer_norm(out, p["ln_x_s"], p["ln_x_b"])
    out = out * F.silu(g)
    # output projection through the fusedmac epilogue (rnn_lm ladder v3+)
    return matmul_epilogue(out, p["wo"]), s_final


def channel_mix(p, x, cfg):
    xp = _shift(x)
    xk = _lerp(x, xp, p["mu_ck"])
    xr = _lerp(x, xp, p["mu_cr"])
    hid = torch.square(torch.relu(mac_matmul(xk, p["cm_k"])))
    # down-projection through the fusedmac epilogue (rnn_lm ladder v3+)
    return torch.sigmoid(mac_matmul(xr, p["cm_r"])) * matmul_epilogue(
        hid, p["cm_v"])


def rwkv_block(p, x, cfg, chunk=64):
    tm, _ = time_mix(p, layer_norm(x, p["ln1_s"], p["ln1_b"]), cfg,
                     chunk=chunk)
    x = x + tm
    return x + channel_mix(p, layer_norm(x, p["ln2_s"], p["ln2_b"]), cfg)


# ---------------------------------------------------------------------------
# decode (stateful single-token)
# ---------------------------------------------------------------------------


def rwkv_init_state(cfg, batch, dtype, device="cpu") -> dict:
    d, n = cfg.d_model, cfg.rwkv_head_dim
    h = d // n
    return {
        "s": torch.zeros((batch, h, n, n), dtype=torch.float32,
                         device=device),
        "tm_prev": torch.zeros((batch, d), dtype=dtype, device=device),
        "cm_prev": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def rwkv_block_decode(p, x, state, cfg):
    """x: (B, 1, d); state: one layer's ``{"s", "tm_prev", "cm_prev"}`` ->
    (out, new state), the new state in new tensors (the old one is left as
    it was, so a step may be repeated from it)."""
    b, _, d = x.shape
    n = cfg.rwkv_head_dim
    h = d // n
    xin = layer_norm(x[:, 0], p["ln1_s"], p["ln1_b"])
    xp = state["tm_prev"]
    r = mac_matmul(_lerp(xin, xp, p["mu_r"]), p["wr"]).reshape(b, h, n)
    k = mac_matmul(_lerp(xin, xp, p["mu_k"]), p["wk"]).reshape(b, h, n)
    v = mac_matmul(_lerp(xin, xp, p["mu_v"]), p["wv"]).reshape(b, h, n)
    g = mac_matmul(_lerp(xin, xp, p["mu_g"]), p["wg"])
    lw = _decay(p, _lerp(xin, xp, p["mu_w"])[:, None])[:, 0].reshape(b, h, n)
    r32, k32, v32 = (t.float() for t in (r, k, v))
    s = state["s"]
    # o = r (S + u*k v^T); S' = diag(exp(lw)) S + k v^T
    kv = k32[..., :, None] * v32[..., None, :]
    with full_f32():
        o = torch.einsum("bhi,bhij->bhj", r32,
                         s + p["u"][None, :, :, None] * kv)
    s_new = torch.exp(lw)[..., None] * s + kv
    out = o.reshape(b, d).to(x.dtype)
    out = layer_norm(out, p["ln_x_s"], p["ln_x_b"]) * F.silu(g)
    x = x + mac_matmul(out, p["wo"])[:, None]
    # channel mix
    xin2 = layer_norm(x[:, 0], p["ln2_s"], p["ln2_b"])
    xp2 = state["cm_prev"]
    xk = _lerp(xin2, xp2, p["mu_ck"])
    xr = _lerp(xin2, xp2, p["mu_cr"])
    hid = torch.square(torch.relu(mac_matmul(xk, p["cm_k"])))
    cm = torch.sigmoid(mac_matmul(xr, p["cm_r"])) * mac_matmul(hid, p["cm_v"])
    x = x + cm[:, None]
    return x, {"s": s_new, "tm_prev": xin, "cm_prev": xin2}
