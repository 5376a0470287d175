"""LM assembly for the dense family (granite, qwen3, starcoder2), the rwkv
family (rwkv6), the hybrid family (hymba), the enc_dec family (whisper) and
the vlm family (internvl2), the counterpart of the reference's
``models/transformer.py``.

Params are a dict: ``{"embed": {"table": (V, d)}, "ln_f": (d,), "layers":
[one dict per layer]}``; a dense layer holds ``ln1``, ``attn``, ``ln2`` and
``mlp``, a hybrid layer adds ``ssm`` (:func:`repro_torch.models.ssm.
ssm_init`) and the ``attn_out_norm``/``ssm_out_norm`` scales of its two
heads, an rwkv layer is the flat dict of :func:`repro_torch.models.rwkv.
rwkv_layer_init`, and rwkv adds the top-level ``ln0_s``/``ln0_b`` LayerNorm
after the embedding.  enc_dec adds ``enc_layers`` (dense layers, run
non-causal over the frames) and ``ln_enc``; its decoder layers hold ``ln1``,
``attn``, ``lnx``, ``xattn`` (the cross-attention's projections), ``ln2``
and ``mlp``, and its forward takes ``frames`` (B, F, d), the stubbed audio
frontend's precomputed frame embeddings.  vlm is the dense stack with a
top-level ``frontend_proj`` (d, d); its forward takes ``patches`` (B, P, d),
the stubbed vision frontend's precomputed patch embeddings, projects them
through the ``mac_matmul`` site and runs the causal stack over the P patches
followed by the text, and the logits cover the text alone.  Its decode step
is the dense one, from tokens alone, as the reference's.  The reference
stacks the layers on a leading axis and scans them; here a list runs in a
Python loop
(:func:`repro_torch.core.profiler.scan`, which the profiler sees once per
program site, as the reference's traced scan body).  :func:`params_from_jax`
converts the reference's tree.

The decode state is ``{"index": (B,) int32, "cache": {...}}``.  Dense and
enc_dec: the cache is ``{"k", "v": (L, B, Smax, K, dh)}``, with int8
``k``/``v`` and f32 ``k_scale``/``v_scale`` (L, B, Smax, K) planes when
``kv_quant="int8"``; :func:`decode_step` writes each lane's new K/V into it
in place.  enc_dec adds ``cross_kv``: ``{"k", "v": (L, B, Se, K, dh)}``, the
encoder's K/V per layer, built once by :func:`init_decode_state` from the
frames and never written.  Hybrid:
the same K/V pools, rolling over ``Smax = min(max_len, window)`` rows,
plus the SSM's ``h`` (L, B, d_inner, N) and ``conv`` (L, B, K - 1,
d_inner) f32 state, which :func:`decode_step` returns in new tensors (a
step repeated from the old state, as a retry is, applies the recurrence
once).  rwkv: the recurrent state ``{"s": (L, B, H, N, N) f32, "tm_prev",
"cm_prev": (L, B, d)}``, with no position axis, in new tensors.  Either way
the step returns a new ``index``.

The other families (moe, mla) come with later slices.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core import profiler
from repro_torch.models import layers as L
from repro_torch.models import rwkv as RWKV
from repro_torch.models import ssm as SSM

FAMILIES = ("dense", "rwkv", "hybrid", "enc_dec", "vlm")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the port serves the {FAMILIES} families; {cfg.name} is "
            f"{cfg.family!r}")


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _dense_layer_init(gen, cfg, dtype, device):
    ones = dict(dtype=dtype, device=device)
    return {
        "ln1": torch.ones(cfg.d_model, **ones),
        "attn": L.attn_init(gen, cfg, dtype, device=device),
        "ln2": torch.ones(cfg.d_model, **ones),
        "mlp": L.mlp_init(gen, cfg, dtype, device=device),
    }


def _hybrid_layer_init(gen, cfg, dtype, device):
    ones = dict(dtype=dtype, device=device)
    return {
        "ln1": torch.ones(cfg.d_model, **ones),
        "attn": L.attn_init(gen, cfg, dtype, device=device),
        "ssm": SSM.ssm_init(gen, cfg, dtype, device=device),
        "attn_out_norm": torch.ones(cfg.d_model, **ones),
        "ssm_out_norm": torch.ones(cfg.d_model, **ones),
        "ln2": torch.ones(cfg.d_model, **ones),
        "mlp": L.mlp_init(gen, cfg, dtype, device=device),
    }


def _encdec_dec_layer_init(gen, cfg, dtype, device):
    ones = dict(dtype=dtype, device=device)
    return {
        "ln1": torch.ones(cfg.d_model, **ones),
        "attn": L.attn_init(gen, cfg, dtype, device=device),
        "lnx": torch.ones(cfg.d_model, **ones),
        "xattn": L.attn_init(gen, cfg, dtype, device=device),
        "ln2": torch.ones(cfg.d_model, **ones),
        "mlp": L.mlp_init(gen, cfg, dtype, device=device),
    }


def init_params(gen: torch.Generator, cfg: ArchConfig, device=None) -> dict:
    """Random params in ``cfg.param_dtype`` with the reference's
    distributions (``dense_init``: N(0, 1)/sqrt(fan_in); the embedding at
    scale 1), drawn from ``gen`` on its own device and kept on ``device``
    (default: the generator's).  With a CUDA generator every weight is drawn
    on the card, one at a time, so a full-width model never exists on the
    CPU."""
    _check_family(cfg)
    device = gen.device if device is None else torch.device(device)
    dtype = torch_dtype(cfg.param_dtype)
    params = {
        "embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model, dtype,
                              device=device),
        "ln_f": torch.ones(cfg.d_model, dtype=dtype, device=device),
    }
    if cfg.family == "rwkv":
        params["ln0_s"] = torch.ones(cfg.d_model, dtype=dtype, device=device)
        params["ln0_b"] = torch.zeros(cfg.d_model, dtype=dtype, device=device)
        layer_init = RWKV.rwkv_layer_init
    elif cfg.family == "hybrid":
        layer_init = _hybrid_layer_init
    elif cfg.family == "enc_dec":
        params["enc_layers"] = [_dense_layer_init(gen, cfg, dtype, device)
                                for _ in range(cfg.n_enc_layers)]
        params["ln_enc"] = torch.ones(cfg.d_model, dtype=dtype,
                                      device=device)
        layer_init = _encdec_dec_layer_init
    else:
        layer_init = _dense_layer_init
    params["layers"] = [layer_init(gen, cfg, dtype, device)
                        for _ in range(cfg.n_layers)]
    if cfg.family == "vlm":
        params["frontend_proj"] = L.dense_init(
            gen, (cfg.d_model, cfg.d_model), dtype, device=device)
    return params


def _to_torch(a, device) -> torch.Tensor:
    """A numpy array as a tensor of its own (a copy) on ``device``."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":  # ml_dtypes: torch cannot read it as is
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(tree, device) -> list:
    """A tree whose leaves are stacked on a leading layer axis -> one tree
    per layer."""
    first = tree
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [_map(tree, lambda a, i=i: _to_torch(np.asarray(a)[i], device))
            for i in range(np.asarray(first).shape[0])]


STACKS = ("layers", "enc_layers")  # the reference's scanned layer stacks


def params_from_jax(tree, cfg: ArchConfig, device="cpu") -> dict:
    """The reference's param tree (numpy leaves, bf16 as ``ml_dtypes``,
    layers stacked on a leading L axis, or a list of layers as the
    reference's ``ssm_stack_init`` makes) -> the port's, on ``device``, bit
    for bit, every leaf in its own dtype (rwkv's ``w0`` and ``u``, the
    SSM's ``A_log`` and ``D`` f32).  enc_dec's ``enc_layers`` stack becomes
    a list as ``layers`` does."""
    _check_family(cfg)
    to = lambda a: _to_torch(a, device)  # noqa: E731
    out = {}
    for name, sub in tree.items():
        if name not in STACKS:
            out[name] = _map(sub, to)
        elif isinstance(sub, (list, tuple)):
            out[name] = [_map(p, to) for p in sub]
        else:
            out[name] = _unstack(sub, device)
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _block_dense(p, x, cfg, run, positions, causal=True):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    a = L.attention(p["attn"], h, cfg, positions=positions, causal=causal,
                    window=cfg.sliding_window or None,
                    attn_impl=run.attn_impl, chunk=run.attn_chunk)
    x, h2 = L.residual_rmsnorm(x, a, p["ln2"], cfg.norm_eps)
    return L.mlp(p["mlp"], h2, cfg, residual=x)  # acc_mac skip-add


def _mix(p, a, s, cfg):
    """The hybrid layer's two heads, each normalised, averaged."""
    return 0.5 * (L.rms_norm(a, p["attn_out_norm"], cfg.norm_eps)
                  + L.rms_norm(s, p["ssm_out_norm"], cfg.norm_eps))


def _block_hybrid(p, x, cfg, run, positions):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    a = L.attention(p["attn"], h, cfg, positions=positions, causal=True,
                    window=cfg.sliding_window or None,
                    attn_impl=run.attn_impl, chunk=run.attn_chunk)
    s = SSM.ssm_forward(p["ssm"], h, cfg, chunk=run.ssm_chunk)
    x, h2 = L.residual_rmsnorm(x, _mix(p, a, s, cfg), p["ln2"], cfg.norm_eps)
    return L.mlp(p["mlp"], h2, cfg, residual=x)  # acc_mac skip-add


def _block_encdec_dec(p, x, enc_out, cfg, run, positions):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    a = L.attention(p["attn"], h, cfg, positions=positions, causal=True,
                    attn_impl=run.attn_impl, chunk=run.attn_chunk)
    x = x + a
    h = L.rms_norm(x, p["lnx"], cfg.norm_eps)
    enc_kv = L.encoder_kv(p["xattn"], enc_out, cfg)
    c = L.cross_attention(p["xattn"], h, enc_kv, cfg,
                          attn_impl=run.attn_impl, chunk=run.attn_chunk)
    x, h2 = L.residual_rmsnorm(x, c, p["ln2"], cfg.norm_eps)
    return L.mlp(p["mlp"], h2, cfg, residual=x)  # acc_mac skip-add


def _encode(params, frames, cfg, run):
    """The Whisper-style encoder over precomputed frame embeddings (the
    stubbed frontend): sinusoidal positions, non-causal dense layers, then
    ``ln_enc``."""
    if frames is None:
        raise ValueError(f"{cfg.name} ({cfg.family}) needs frames=: the "
                         "(B, n_frames, d_model) frame embeddings")
    x = frames + L.sinusoidal_positions(frames.shape[1], cfg.d_model,
                                        frames.dtype, device=frames.device)
    x = profiler.scan(lambda p, x: _block_dense(  # noqa: E731
        p, x, cfg, run, positions=None, causal=False), x,
        params["enc_layers"])
    return L.rms_norm(x, params["ln_enc"], cfg.norm_eps)


def _patch_prefix(params, patches, x, cfg):
    """The vlm prefix: the patch embeddings (B, P, d) projected through
    ``frontend_proj`` at the ``mac_matmul`` site, cast to the embeddings'
    type and put in front of the token embeddings ``x``."""
    if patches is None:
        raise ValueError(f"{cfg.name} ({cfg.family}) needs patches=: the "
                         "(B, n_patches, d_model) patch embeddings")
    pe = L.mac_matmul(patches, params["frontend_proj"])
    return torch.cat([pe.to(x.dtype), x], dim=1)


def forward_hidden(params, tokens, cfg: ArchConfig, run: RunConfig,
                   frames=None, patches=None):
    """tokens: (B, S) -> (hidden (B, prefix + S, d), aux, prefix_len);
    enc_dec takes ``frames`` (B, F, d), vlm ``patches`` (B, P, d), whose P
    rows lead the hidden states (``prefix_len`` = P)."""
    _check_family(cfg)
    # the reference encodes the frames before it embeds the tokens
    enc_out = (_encode(params, frames, cfg, run) if cfg.family == "enc_dec"
               else None)
    x = L.embed_lookup(params["embed"], tokens)
    prefix = 0
    if cfg.family == "vlm":
        x = _patch_prefix(params, patches, x, cfg)
        prefix = patches.shape[1]
    if cfg.family == "rwkv":
        x = L.layer_norm(x, params["ln0_s"], params["ln0_b"])
        body = lambda p, x: RWKV.rwkv_block(  # noqa: E731
            p, x, cfg, chunk=run.wkv_chunk)
    elif cfg.family == "enc_dec":
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model, x.dtype,
                                       device=x.device)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        body = lambda p, x: _block_encdec_dec(  # noqa: E731
            p, x, enc_out, cfg, run, positions)
    else:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        block = _block_hybrid if cfg.family == "hybrid" else _block_dense
        body = lambda p, x: block(  # noqa: E731
            p, x, cfg, run, positions)
    x = profiler.scan(body, x, params["layers"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps), aux, prefix


def forward_lm(params, tokens, cfg: ArchConfig, run: RunConfig, frames=None,
               patches=None):
    """tokens: (B, S) -> (logits (B, S, V_padded), aux); enc_dec takes
    ``frames`` (B, F, d), vlm ``patches`` (B, P, d) (the logits of the text
    positions alone)."""
    hidden, aux, prefix = forward_hidden(params, tokens, cfg, run,
                                         frames=frames, patches=patches)
    if prefix:
        # contiguous, so the logits fold into one GEMM over the table (a
        # strided 3-D operand takes a batched product over B copies of it)
        hidden = hidden[:, prefix:].contiguous()
    return L.embed_logits(params["embed"], hidden), aux


# ---------------------------------------------------------------------------
# decode: stateful single-token generation
# ---------------------------------------------------------------------------


def init_decode_state(params, cfg: ArchConfig, run: RunConfig, batch: int,
                      max_len: int, frames=None, kv_quant=None) -> dict:
    """The per-layer cache (leading L axis) and the per-lane position
    index, on the params' device.  ``kv_quant="int8"`` stores the KV pools
    as int8 codes with per-(position, head) f32 scale planes (4x smaller),
    and passes hybrid's SSM state through as it is; rwkv's recurrent state
    has no KV layout and refuses it, as the reference does.  enc_dec runs
    the encoder over ``frames`` (batch, F, d) once and keeps each layer's
    cross-attention K/V in ``cross_kv``."""
    _check_family(cfg)
    table = params["embed"]["table"]
    dev, dtype = table.device, table.dtype
    n_layers = len(params["layers"])
    index = torch.zeros(batch, dtype=torch.int32, device=dev)
    if kv_quant not in (None, "int8"):
        raise ValueError(f"unknown kv_quant {kv_quant!r} (want 'int8')")
    if cfg.family == "rwkv":
        cache = {name: t.new_zeros((n_layers, *t.shape)) for name, t in
                 RWKV.rwkv_init_state(cfg, batch, dtype, dev).items()}
        if kv_quant is not None:
            raise ValueError(
                "kv_quant='int8' needs a {'k','v'} cache layout; this family "
                f"caches {sorted(cache)} (MLA/paired-MoE/RWKV are "
                "unsupported)")
        return {"index": index, "cache": cache}
    kv, dh = cfg.n_kv_heads, cfg.d_head
    smax = (min(max_len, cfg.sliding_window) if cfg.sliding_window
            else max_len)
    shape = (n_layers, batch, smax, kv, dh)
    if kv_quant is None:
        cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
    else:
        int8 = dict(dtype=torch.int8, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        cache = {"k": torch.zeros(shape, **int8),
                 "v": torch.zeros(shape, **int8),
                 "k_scale": torch.zeros(shape[:-1], **f32),
                 "v_scale": torch.zeros(shape[:-1], **f32)}
    if cfg.family == "hybrid":
        cache.update({name: t.new_zeros((n_layers, *t.shape)) for name, t in
                      SSM.ssm_init_state(cfg, batch, dev).items()})
    state = {"index": index, "cache": cache}
    if cfg.family == "enc_dec":
        enc_out = _encode(params, frames, cfg, run)
        kvs = [L.encoder_kv(p["xattn"], enc_out, cfg)
               for p in params["layers"]]
        state["cross_kv"] = {"k": torch.stack([k for k, _ in kvs]),
                             "v": torch.stack([v for _, v in kvs])}
    return state


def decode_step(params, state, tokens, cfg: ArchConfig, run: RunConfig):
    """tokens: (B, 1) -> (logits (B, 1, V_padded), new state).  Dense,
    enc_dec and hybrid: the new state holds the same K/V pools (their rows
    at each lane's index written in place) and ``index + 1``; the old
    state's index is untouched, so a step may be repeated from it (retry,
    warmup).  Hybrid's SSM state and rwkv's recurrent cache are new tensors
    in the new state, and the old state's are untouched.  enc_dec adds each
    lane's sinusoidal position row, its index clamped to the table's last
    row as the reference's gather clamps it (a lane the wave loop leaves
    idle keeps stepping, and its index runs past the cache), and attends to
    the state's ``cross_kv`` in the plain form, as the reference does."""
    del run
    _check_family(cfg)
    idx = state["index"]
    cache = state["cache"]
    x = L.embed_lookup(params["embed"], tokens)
    if cfg.family == "enc_dec":
        pos_table = L.sinusoidal_positions(cache["k"].shape[2], cfg.d_model,
                                           x.dtype, device=x.device)
        row = idx.long().clamp(0, pos_table.shape[0] - 1)
        x = x + pos_table[row][:, None, :]
    if cfg.family == "rwkv":
        x = L.layer_norm(x, params["ln0_s"], params["ln0_b"])
        steps = []
        for i, p in enumerate(params["layers"]):
            x, c2 = RWKV.rwkv_block_decode(
                p, x, {name: t[i] for name, t in cache.items()}, cfg)
            steps.append(c2)
        cache = {name: torch.stack([c[name] for c in steps])
                 for name in cache}
    else:
        window = cfg.sliding_window or None
        cross = state.get("cross_kv")
        ssm_steps = []
        for i, p in enumerate(params["layers"]):
            c = {name: t[i] for name, t in cache.items()}
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            attn_c = {name: c[name] for name in ("k", "v", "k_scale",
                                                 "v_scale") if name in c}
            a, _ = L.attention_decode(p["attn"], h, attn_c, idx, cfg,
                                      window=window)
            if cfg.family == "hybrid":
                s, sc2 = SSM.ssm_decode(p["ssm"], h, {"h": c["h"],
                                                      "conv": c["conv"]}, cfg)
                ssm_steps.append(sc2)
                a = _mix(p, a, s, cfg)
            elif cfg.family == "enc_dec":
                x = x + a
                h = L.rms_norm(x, p["lnx"], cfg.norm_eps)
                a = L.cross_attention(p["xattn"], h, (cross["k"][i],
                                                      cross["v"][i]), cfg,
                                      attn_impl="naive")
            x, h2 = L.residual_rmsnorm(x, a, p["ln2"], cfg.norm_eps)
            x = L.mlp(p["mlp"], h2, cfg, residual=x)  # acc_mac skip-add
        if ssm_steps:
            cache = dict(cache, **{name: torch.stack([c[name] for c in
                                                      ssm_steps])
                                   for name in ("h", "conv")})
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = L.embed_logits(params["embed"], x)
    return logits, dict(state, cache=cache, index=idx + 1)
