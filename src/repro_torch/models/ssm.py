"""Selective SSM (Mamba-style) head for hymba's parallel attn+SSM layers,
and the pure-SSM stack of the ``ssm_lm`` class: the counterpart of the
reference's ``models/ssm.py``, function for function and leaf for leaf.

The full-sequence form is chunked: a loop over sequence chunks
(:func:`repro_torch.core.profiler.scan_chunks`, the reference's
``lax.scan``) carries the (d_inner, N) state, and within a chunk
:func:`associative_scan` runs the diagonal recurrence ``h_t = a_t h_{t-1} +
b_t`` with the reference's log-depth odd/even tree, so every sum is taken
in its order; the decays are never divided out of a cumulative product
(they underflow to 0 in f32 at full width).  The (B, chunk, d_inner, N)
decay and input tensors live one chunk at a time.  The whole form is the
``ssm_chunk`` dispatch site, which no backend implements (the reference
registers no kernel for it), so it always runs this plain version.

The arithmetic follows the reference's, rounding by rounding, in the
param dtype: the causal depthwise conv is a Python ``sum`` of K rounded
products (not a ``conv1d``, which sums in f32), ``silu`` is ``x *
sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))`` (XLA's), and
``softplus`` is ``jax.nn.softplus``'s ``logaddexp(x, 0)``.  ``A_log`` and
``D`` are f32 leaves whatever the param dtype.  Decode convolves its f32
buffer of the last K - 1 inputs with an ``einsum``, as the reference's
does, and returns its state in new tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import dispatch, profiler
from repro_torch.kernels.common import full_f32
from repro_torch.models.layers import (
    dense_init, embed_init, embed_logits, embed_lookup, mac_matmul,
    matmul_epilogue, mlp, mlp_init, residual_rmsnorm, rms_norm,
)


def ssm_init(gen: torch.Generator, cfg, dtype, device="cpu") -> dict:
    d, di, n = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    dt_rank = max(1, d // 16)
    kw = dict(dtype=dtype, device=device)
    dense = lambda shape, scale=None: dense_init(  # noqa: E731
        gen, shape, dtype, scale=scale, device=device)
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": dense((d, 2 * di)),
        "conv_w": dense((cfg.ssm_conv, di), scale=0.5),
        "conv_b": torch.zeros(di, **kw),
        "x_proj": dense((di, dt_rank + 2 * n)),
        "dt_proj": dense((dt_rank, di)),
        "dt_bias": torch.zeros(di, **kw),
        "A_log": torch.log(a).expand(di, n).contiguous(),
        "D": torch.ones(di, dtype=torch.float32, device=device),
        "out_proj": dense((di, d)),
    }


def _silu(x):
    """``jax.nn.silu`` as XLA evaluates it: each op rounded to x's dtype."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def _softplus(x):
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``, op for op in x's
    dtype."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    delta = x - zero
    return torch.where(torch.isnan(delta), x + zero,
                       torch.maximum(x, zero)
                       + torch.log1p(torch.exp(-torch.abs(delta))))


def _causal_conv(x, w, b):
    """x: (B, S, di); w: (K, di) depthwise causal conv, as a sum of K
    products each rounded to x's dtype."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return out + b


def _interleave(a, b, axis: int):
    """``jax.lax.associative_scan``'s interleave: ``a`` (n or n + 1 long on
    ``axis``) and ``b`` (n long) each padded with zeros between and around
    their elements, then added: a0 b0 a1 b1 ..."""
    na, nb = a.shape[axis], b.shape[axis]
    lead = [0, 0] * (a.ndim - axis - 1)

    def spread(t, first, tail):
        # t's elements at every other place from `first`, `tail` more
        # zeros at the end, as one pad of a new axis after `axis`
        pad = lead + ([1, 0] if first else [0, 1]) + [0, tail]
        out = F.pad(t.unsqueeze(axis + 1), pad).flatten(axis, axis + 1)
        return out.narrow(axis, 0, na + nb)

    return spread(a, False, 0) + spread(b, True, int(na > nb))


def associative_scan(fn, elems, axis: int):
    """``jax.lax.associative_scan(fn, elems, axis=axis)`` for a tuple of
    tensors: the same recursion (strided slices, ``fn`` on the pairs, the
    even elements combined from the odd ones, pad-interleaved by add), so
    ``fn`` meets the same operands in the same order."""
    def scan(elems):
        n = elems[0].shape[axis]
        if n < 2:
            return elems

        def sl(t, start, stop=None, step=1):
            idx = [slice(None)] * t.ndim
            idx[axis] = slice(start, stop, step)
            return t[tuple(idx)]

        reduced = fn([sl(e, 0, -1, 2) for e in elems],
                     [sl(e, 1, None, 2) for e in elems])
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn([sl(e, 0, -1) for e in odd],
                      [sl(e, 2, None, 2) for e in elems])
        else:
            even = fn(odd, [sl(e, 2, None, 2) for e in elems])
        even = [torch.cat([sl(e, 0, 1), r], dim=axis)
                for e, r in zip(elems, even)]
        return [_interleave(e, o, axis) for e, o in zip(even, odd)]

    return scan(list(elems))


def _combine(a, b):
    return (a[0] * b[0], b[0] * a[1] + b[1])


def _ssm_forward_ref(p, xz, cfg, h0=None, chunk=128):
    """xz: already in_proj'ed (B, S, 2 di) -> (out (B, S, di), h_final (B,
    di, N) f32).  S is zero-padded to a multiple of the chunk (a zero dt
    leaves the state as it is) and the padding dropped after."""
    b, s, _ = xz.shape
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    dt_rank = p["dt_proj"].shape[0]
    x, z = torch.split(xz, di, dim=-1)
    x = profiler.jitted(_silu, _causal_conv(x, p["conv_w"], p["conv_b"]))
    proj = mac_matmul(x, p["x_proj"])
    dt_in, b_t, c_t = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt = profiler.jitted(_softplus,
                         mac_matmul(dt_in, p["dt_proj"]) + p["dt_bias"])
    dt = dt.float()
    a = -torch.exp(p["A_log"])  # (di, N)
    if h0 is None:
        h0 = torch.zeros((b, di, n), dtype=torch.float32, device=xz.device)
    chunk = min(chunk, s)
    pad = (-s) % chunk
    xs = [dt, x.float(), b_t.float(), c_t.float()]
    if pad:
        xs = [F.pad(t, (0, 0, 0, pad)) for t in xs]
    last = torch.full((1,), chunk - 1, dtype=torch.int64, device=xz.device)

    def body(h, dt_c, x_c, b_c, c_c):
        dec_c = torch.exp(dt_c[..., None] * a)  # (B, chunk, di, N)
        bx_c = (dt_c * x_c)[..., None] * b_c[:, :, None, :]
        dec_cum, bx_cum = associative_scan(_combine, (dec_c, bx_c), axis=1)
        h_all = dec_cum * h[:, None] + bx_cum
        with full_f32():
            y = torch.einsum("bsdn,bsn->bsd", h_all, c_c)
        # the reference's h_all[:, -1] is a dynamic_slice, with bytes
        return torch.index_select(h_all, 1, last)[:, 0], y

    h_final, y = profiler.scan_chunks(body, h0, xs, (s + pad) // chunk)
    y = y[:, :s]
    y = y + p["D"] * x.float()
    out = y.to(xz.dtype) * profiler.jitted(_silu, z)
    return out, h_final


def ssm_forward(p, x, cfg, chunk=128):
    """Full-sequence SSM head. x: (B, S, d) -> (B, S, d)."""
    xz = mac_matmul(x, p["in_proj"])
    out, _ = dispatch.call("ssm_chunk", _ssm_forward_ref, p, xz, cfg,
                           chunk=chunk)
    return matmul_epilogue(out, p["out_proj"])


def ssm_init_state(cfg, batch, device="cpu") -> dict:
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, di, n), **f32),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), **f32)}


def ssm_decode(p, x, state, cfg):
    """Single-token step. x: (B, 1, d); state: one layer's ``{"h", "conv"}``
    -> (out (B, 1, d), new state), the new state in new tensors (the old
    one is left as it was, so a step may be repeated from it)."""
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    dt_rank = p["dt_proj"].shape[0]
    xz = mac_matmul(x, p["in_proj"])[:, 0]  # (B, 2 di)
    xt, z = torch.split(xz, di, dim=-1)
    conv_buf = torch.cat([state["conv"], xt[:, None].float()], dim=1)
    with full_f32():
        conv = torch.einsum("bkd,kd->bd", conv_buf.to(xt.dtype), p["conv_w"])
    xt = _silu(conv + p["conv_b"])
    proj = mac_matmul(xt, p["x_proj"])
    dt_in, b_t, c_t = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt = _softplus(mac_matmul(dt_in, p["dt_proj"]) + p["dt_bias"]).float()
    a = -torch.exp(p["A_log"])
    decay = torch.exp(dt[..., None] * a)  # (B, di, N)
    h = decay * state["h"] + (dt * xt.float())[..., None] * b_t.float()[
        :, None, :]
    with full_f32():
        y = torch.einsum("bdn,bn->bd", h, c_t.float())
    y = y + p["D"] * xt.float()
    out = y.to(x.dtype) * _silu(z)
    out = matmul_epilogue(out[:, None], p["out_proj"])
    return out, {"h": h, "conv": conv_buf[:, 1:]}


# ---------------------------------------------------------------------------
# pure-SSM stack (the ssm_lm class exemplar)
# ---------------------------------------------------------------------------


def ssm_stack_init(gen: torch.Generator, cfg, dtype=None, device=None):
    """Params for a small pure-SSM LM (Mamba-style): embed -> n_layers x
    (SSM sublayer + gated MLP with residual_rmsnorm between) -> tied
    logits; ``layers`` is a list, not stacked, as the reference's is.
    No registered arch is attention-free selective-scan, so this stack is
    the ``ssm_lm`` exemplar."""
    device = gen.device if device is None else torch.device(device)
    dtype = dtype or getattr(torch, cfg.param_dtype)
    ones = lambda: torch.ones(cfg.d_model, dtype=dtype,  # noqa: E731
                              device=device)
    embed = embed_init(gen, cfg.vocab_padded, cfg.d_model, dtype,
                       device=device)
    layers = [{"ln1": ones(), "ssm": ssm_init(gen, cfg, dtype, device),
               "ln2": ones(), "mlp": mlp_init(gen, cfg, dtype, device)}
              for _ in range(cfg.n_layers)]
    return {"embed": embed, "layers": layers, "ln_f": ones()}


def ssm_stack_forward(params, tokens, cfg, run):
    """Tokens (B, S) -> (logits, aux).  The profile shows ssm_chunk sites
    and no attention, so the class is ``ssm_lm``.  The layers run in a
    Python loop, as the reference's do (no layer scan)."""
    x = embed_lookup(params["embed"], tokens)
    for p in params["layers"]:
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        s = ssm_forward(p["ssm"], h, cfg, chunk=run.ssm_chunk)
        x, h2 = residual_rmsnorm(x, s, p["ln2"], cfg.norm_eps)
        x = mlp(p["mlp"], h2, cfg, residual=x)  # acc_mac skip-add
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return embed_logits(params["embed"], x), torch.zeros(
        (), dtype=torch.float32, device=x.device)
