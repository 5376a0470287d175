"""The port's enc_dec path (whisper-tiny) against the reference, on the CPU.

The smoke variant (2 encoder and 2 decoder layers, d_model 128, 4 heads of
32 over 2 KV heads, d_ff 256, vocab 512, 16 frames), its params the
reference's own init carried over by ``params_from_jax``, the frames and
tokens drawn with numpy from a seed:

* ``sinusoidal_positions`` at whisper-tiny's (1500, 384) and the smoke
  shapes against the reference's table as its compiled program holds it;
* ``_encode`` and the ``forward_lm`` logits at v0..v4, port against
  reference at the same level (the reference's kernels in interpret mode,
  as its own tests run them; the port's wrappers on their plain versions),
  in f32, and in bf16 at v0 and v4.  At 16 frames the encoder and the
  cross-attention take the flash kernel's non-causal path with Sq != Skv
  (32 decoder queries over 16 frames) in both packages;
* the v4 report: class ``dense_lm`` (the reference's ``classify`` never
  returns ``enc_dec_lm``), site counts and bytes, the cost model's
  site-derived inputs and the two scans' loop trips equal, hbm and weight
  bytes within 2%, the rv32 ladder within 0.1%, the rewrite stats equal;
* ``init_decode_state``'s ``cross_kv``, the decode against the
  teacher-forced forward and against the reference's decode, a lane past
  the cache clamped as the reference clamps it, the int8 KV cache's drift,
  and the legacy wave loop: a refilled lane decodes as a
  fresh engine's, and the port's ``ServeEngine(frames=)`` streams equal the
  reference's ``ServeEngine`` on the same weights and frames; the launcher
  serves the smoke variant and refuses ``--lm``.

Tolerances.  The sinusoidal table: within one f32 ulp (6e-8: every entry
is in [-1, 1]) of the reference's, equal after a bf16 cast (the port
rounds each op's f64 value once; XLA folds the table at compile time and
is correctly rounded on all but a few entries).  f32 logits: 1e-3 absolute
and 1e-5 relative, as the hybrid test states it (the smoke logits reach
|92|; the two frameworks sum the f32 products in other orders).  bf16
logits: relative L2 within two bf16 epsilons (2**-6), as the dense test
states it.  ``cross_kv`` and the encoder output in f32: 1e-5 absolute and
relative.  Decode against the forward: the reference's own ``atol`` 2e-3
and ``rtol`` 1e-3 (``tests/test_recurrent_decode.py``).  int8 KV: the
decode logits within relative L2 2e-2 of the f32 cache's (the per-(position,
head) amax quantizer's error, as the hybrid test bounds it), and the port's
drift within 1e-3 of the reference's.  The reference's programs run once
per level per module.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import marvel as jmarvel  # noqa: E402
from repro.configs.base import RunConfig as JRun  # noqa: E402
from repro.configs.registry import get_arch as jget_arch  # noqa: E402
from repro.configs.registry import smoke_variant as jsmoke  # noqa: E402
from repro.core import rewrite as jrewrite  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import server as jserver  # noqa: E402
from repro_torch import marvel as tmarvel  # noqa: E402
from repro_torch.configs import RunConfig, get_arch, smoke_variant  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime import server as tserver  # noqa: E402

ARCH = "whisper-tiny"
B, S = 2, 32
RUN = dict(seq_len=S, global_batch=B, attn_chunk=16)
TOL = dict(atol=1e-3, rtol=1e-5)
KV_TOL = dict(atol=1e-5, rtol=1e-5)
DECODE_TOL = dict(atol=2e-3, rtol=1e-3)
BF16_LOGITS_REL = 2.0**-6
LEVELS = ("v0", "v1", "v2", "v3", "v4")
SITE_INPUTS = ("matmul_flops", "loop_iters", "residual_norm_bytes",
               "epilogue_bytes", "conv_epilogue_bytes", "dw_flops",
               "dw_epilogue_bytes", "sep_intermediate_bytes",
               "acc_bytes_saved", "acc_flops", "pool_flops",
               "pool_saved_bytes", "attn_score_bytes", "attn_flops",
               "wkv_flops", "rmsnorm_epilogue_bytes")


def n(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        jnp.asarray(x, jnp.float32))


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class Smoke:
    """The smoke model in ``dtype`` with the reference's params (``of``: a
    model whose params are cast, one init for both dtypes), both packages'
    run configs, (B, S) tokens and (B, F, d) frames."""

    def __init__(self, dtype, of=None):
        self.jcfg = jsmoke(jget_arch(ARCH)).replace(param_dtype=dtype)
        self.cfg = smoke_variant(get_arch(ARCH)).replace(param_dtype=dtype)
        self.jrun, self.run = JRun(**RUN), RunConfig(**RUN)
        self.jparams = (
            JT.init_params(jax.random.PRNGKey(0), self.jcfg) if of is None
            else jax.tree_util.tree_map(
                lambda a: a.astype(jnp.dtype(dtype)), of.jparams))
        self.params = T.params_from_jax(
            jax.tree_util.tree_map(np.asarray, self.jparams), self.cfg)
        rng = np.random.default_rng(0)
        self.tokens = rng.integers(0, self.cfg.vocab, (B, S)).astype(np.int32)
        self.jframes = jnp.asarray(rng.standard_normal(
            (B, self.cfg.n_frames, self.cfg.d_model)), jnp.dtype(dtype))
        self.frames = T._to_torch(np.asarray(self.jframes), "cpu")
        self._progs, self._logits, self._decoded = {}, {}, {}
        self._jstates = {}

    def progs(self, level):
        """(reference, port) programs of ``forward_lm`` at the level, the
        tokens and frames as example args."""
        if level not in self._progs:
            jcfg, jrun, cfg, run = self.jcfg, self.jrun, self.cfg, self.run
            jp = jmarvel.compile(
                lambda p, x, f: JT.forward_lm(p, x, jcfg, jrun, frames=f)[0],
                self.tokens, self.jframes, params=self.jparams, level=level,
                backend="pallas", do_rewrite=False, precompile=False)
            tp = tmarvel.compile(
                lambda p, x, f: T.forward_lm(p, x, cfg, run, frames=f)[0],
                self.tokens, self.frames, params=self.params, level=level,
                backend="cuda", device="cpu")
            self._progs[level] = jp, tp
        return self._progs[level]

    def logits(self, level):
        """(port, reference) forward logits at the level."""
        if level not in self._logits:
            jp, tp = self.progs(level)
            with torch.inference_mode():
                got = n(tp(self.tokens, self.frames))
            self._logits[level] = got, n(jp(self.tokens, self.jframes))
        return self._logits[level]

    def jstate(self, kv_quant=None):
        """The reference's decode state for B lanes of S positions with the
        frames (its arrays are immutable, so one build serves every
        test)."""
        if kv_quant not in self._jstates:
            self._jstates[kv_quant] = JT.init_decode_state(
                self.jparams, self.jcfg, self.jrun, batch=B, max_len=S,
                frames=self.jframes, kv_quant=kv_quant)
        return self._jstates[kv_quant]

    def step_fn(self, level="v4"):
        tp = self.progs(level)[1]
        return tp.table.bind(
            lambda s, x: T.decode_step(self.params, s, x, self.cfg, self.run))

    def decode(self, kv_quant=None):
        """(the port's, the reference's) token-by-token decode logits (B,
        S, V) under the v4 tables, from states built with the frames."""
        if kv_quant not in self._decoded:
            self._decoded[kv_quant] = self._decode(kv_quant)
        return self._decoded[kv_quant]

    def _decode(self, kv_quant):
        step = self.step_fn()
        state = T.init_decode_state(self.params, self.cfg, self.run, batch=B,
                                    max_len=S, frames=self.frames,
                                    kv_quant=kv_quant)
        jcfg, jrun = self.jcfg, self.jrun
        jtable = self.progs("v4")[0].table
        jstep = jax.jit(jtable.bind(
            lambda p, s, x: JT.decode_step(p, s, x, jcfg, jrun)))
        jstate = self.jstate(kv_quant)
        outs, jouts = [], []
        with torch.inference_mode():
            for i in range(S):
                lg, state = step(state, torch.from_numpy(
                    self.tokens[:, i:i + 1]))
                outs.append(n(lg))
                jlg, jstate = jstep(self.jparams, jstate,
                                    self.tokens[:, i:i + 1])
                jouts.append(n(jlg))
        return np.concatenate(outs, 1), np.concatenate(jouts, 1)


@pytest.fixture(scope="module")
def f32():
    return Smoke("float32")


@pytest.fixture(scope="module")
def bf16(f32):
    return Smoke("bfloat16", of=f32)


def test_smoke_variant_is_the_references(f32):
    for f in ("family", "n_layers", "n_enc_layers", "d_model", "n_heads",
              "n_kv_heads", "head_dim", "d_ff", "vocab", "n_frames", "act",
              "mlp_gated", "attn_bias", "rope"):
        assert getattr(f32.cfg, f) == getattr(f32.jcfg, f), f
    assert (f32.cfg.n_enc_layers, f32.cfg.n_frames) == (2, 16)
    full = get_arch(ARCH)
    for f in full.__dataclass_fields__:
        assert getattr(full, f) == getattr(jget_arch(ARCH), f), f
    assert (full.n_layers, full.n_enc_layers, full.d_model,
            full.n_frames) == (4, 4, 384, 1500)


def test_params_from_jax_carries_every_leaf_bit_for_bit(bf16):
    jp = jax.tree_util.tree_map(np.asarray, bf16.jparams)
    assert set(bf16.params) == set(jp) == {"embed", "ln_f", "enc_layers",
                                           "ln_enc", "layers"}
    for name in ("ln_f", "ln_enc"):
        np.testing.assert_array_equal(bf16.params[name].view(
            torch.int16).numpy(), jp[name].view(np.int16))
    np.testing.assert_array_equal(
        bf16.params["embed"]["table"].view(torch.int16).numpy(),
        jp["embed"]["table"].view(np.int16))
    for stack, n_leaves in (("enc_layers", 14), ("layers", 23)):
        leaves = jax.tree_util.tree_leaves_with_path(jp[stack])
        assert len(leaves) == n_leaves, stack
        assert len(bf16.params[stack]) == 2
        for i, layer in enumerate(bf16.params[stack]):
            assert set(layer) == set(jp[stack])
            for path, leaf in leaves:
                got = layer
                for k in path:
                    got = got[k.key]
                assert got.dtype == torch.bfloat16
                np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                              leaf[i].view(np.int16))
    assert set(bf16.params["layers"][0]) == {"ln1", "attn", "lnx", "xattn",
                                             "ln2", "mlp"}


@pytest.mark.parametrize("seq,d", [(1500, 384), (32, 128), (16, 128)])
def test_sinusoidal_positions_match_reference(seq, d):
    """Against the table the reference's compiled program adds (XLA folds
    it at compile time; its eager ops would move the angles by up to
    1.2e-4)."""
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = n(jax.jit(lambda x: x + JL.sinusoidal_positions(seq, d, jdt))(
            jnp.zeros((seq, d), jdt)))
        got = TL.sinusoidal_positions(seq, d, tdt)
        assert got.dtype == tdt and got.shape == (seq, d)
        if tdt == torch.float32:
            np.testing.assert_allclose(n(got), want, rtol=0, atol=2.0**-24)
        else:
            np.testing.assert_array_equal(n(got), want)


def test_encoder_output_matches_reference(f32):
    want = jax.jit(lambda p, f: JT._encode(p, f, f32.jcfg, f32.jrun))(
        f32.jparams, f32.jframes)
    with torch.inference_mode():
        got = T._encode(f32.params, f32.frames, f32.cfg, f32.run)
    assert got.shape == (B, f32.cfg.n_frames, f32.cfg.d_model)
    np.testing.assert_allclose(n(got), n(want), **KV_TOL)
    with pytest.raises(ValueError, match="needs frames="):
        T.forward_lm(f32.params, torch.from_numpy(f32.tokens), f32.cfg,
                     f32.run)


@pytest.mark.parametrize("level", LEVELS)
def test_encdec_logits_match_reference_at_the_same_level(f32, level):
    got, want = f32.logits(level)
    assert got.shape == want.shape == (B, S, f32.cfg.vocab_padded)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("level", ["v0", "v4"])
def test_encdec_bf16_logits_match_reference(bf16, level):
    got, want = bf16.logits(level)
    assert np.isfinite(got).all()
    assert rel_l2(got, want) <= BF16_LOGITS_REL


def test_encdec_report_matches_reference(bf16):
    """Two scans (the encoder's, then the decoder's, whose body holds
    ``encoder_kv``'s GEMMs over the frames), each counted as the reference
    traces its body once."""
    jp, tp = bf16.progs("v4")
    assert tp.model_class == jp.model_class == "dense_lm"
    assert tp.extensions == jp.report.recommended_extensions
    counts = dict(tp.profile.site_counts)
    assert counts == dict(jp.report.profile.site_counts)
    assert dict(tp.profile.site_bytes) == dict(jp.report.profile.site_bytes)
    # a site per program site: the encoder's 6 GEMMs, the decoder's 10
    # (self q/k/v/o, cross q/o, encoder_kv's k/v, the MLP's 2); self,
    # cross and encoder attention; the two blocks' fused norms
    for pat, k in (("matmul_epilogue", 16), ("flash_attention", 3),
                   ("residual_rmsnorm", 2), ("rms_norm", 5)):
        assert counts[pat] == k, pat
    got, want = tp.report, jp.report
    gi = got.profile.as_costmodel_inputs()
    wi = want.profile.as_costmodel_inputs()
    for key in SITE_INPUTS:
        assert gi[key] == wi[key], key
    # 2 + 2 layers; the decoder's self-attention 2 chunks of 16 a layer,
    # the encoder's and the cross-attention's 1 over the 16 frames
    assert gi["loop_iters"] == 4 + 2 * (2 + 1) + 2 * 1
    for key in ("hbm_bytes", "weight_bytes"):
        assert gi[key] == pytest.approx(wi[key], rel=2e-2), key
    for level in LEVELS:
        assert got.rv32_cycles[level] == pytest.approx(
            want.rv32_cycles[level], rel=1e-3), level
    assert got.rv32_speedup_v4 == pytest.approx(want.rv32_speedup_v4,
                                                rel=1e-3)
    _, stats = jrewrite.rewrite(jp.fn, jnp.asarray(bf16.tokens),
                                bf16.jframes)
    assert got.rewrite_ok and got.rewrite_stats == stats


def test_cross_kv_matches_reference(f32):
    state = T.init_decode_state(f32.params, f32.cfg, f32.run, batch=B,
                                max_len=S, frames=f32.frames)
    jstate = f32.jstate()
    assert set(state) == set(jstate) == {"index", "cache", "cross_kv"}
    for k in ("k", "v"):
        got, want = state["cross_kv"][k], jstate["cross_kv"][k]
        assert tuple(got.shape) == want.shape == (2, B, 16, 2, 32)
        np.testing.assert_allclose(n(got), n(want), **KV_TOL)
        assert tuple(state["cache"][k].shape) == jstate["cache"][k].shape


def test_decode_matches_forward_and_reference(f32):
    """The port's token-by-token decode against its own teacher-forced
    forward, and against the reference's decode step by step."""
    got, want = f32.decode()
    fwd, _ = f32.logits("v4")
    np.testing.assert_allclose(got, fwd, **DECODE_TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_past_the_cache_clamps_as_the_reference(f32):
    """A lane whose index has run past the cache (an idle lane of the wave
    loop keeps stepping) takes the table's last position row and the
    cache's last row, as the reference's gather and
    ``dynamic_update_slice`` clamp them; the other lane is unaffected."""
    index = np.array([S + 5, 3], np.int32)
    state = T.init_decode_state(f32.params, f32.cfg, f32.run, batch=B,
                                max_len=S, frames=f32.frames)
    jstate = dict(f32.jstate(), index=jnp.asarray(index))
    state["index"] = torch.from_numpy(index)
    tok = f32.tokens[:, :1]
    with torch.inference_mode():
        got, new = T.decode_step(f32.params, state, torch.from_numpy(tok),
                                 f32.cfg, f32.run)
    want, jnew = jax.jit(lambda p, s, x: JT.decode_step(
        p, s, x, f32.jcfg, f32.jrun))(f32.jparams, jstate, tok)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    np.testing.assert_array_equal(new["index"].numpy(), index + 1)
    np.testing.assert_allclose(n(new["cache"]["k"]), n(jnew["cache"]["k"]),
                               **KV_TOL)


def test_int8_kv_drift_is_bounded(f32):
    got8, want8 = f32.decode(kv_quant="int8")
    got, want = f32.decode()
    drift, jdrift = rel_l2(got8, got), rel_l2(want8, want)
    assert 0 < drift <= 2e-2, drift
    assert drift == pytest.approx(jdrift, abs=1e-3)
    np.testing.assert_allclose(got8, want8, rtol=1e-3, atol=1e-2)


def _requests(module, vocab, k, budget):
    rng = np.random.default_rng(7)
    return [module.Request(uid=i, prompt=rng.integers(1, vocab, int(
        rng.integers(3, 7))).tolist(), max_new_tokens=budget)
        for i in range(k)]


def test_wave_loop_streams_equal_reference_engine(f32):
    """5 requests through 2 lanes (so lanes are refilled) of the legacy
    wave loop, the same weights and frames in both packages: the greedy
    streams are equal token for token."""
    kw = dict(batch_slots=B, max_len=S)
    teng = tserver.ServeEngine(f32.params, f32.cfg, f32.run,
                               frames=f32.frames, **kw)
    jeng = jserver.ServeEngine(f32.jparams, f32.jcfg, f32.jrun,
                               frames=f32.jframes, **kw)
    treqs = _requests(tserver, f32.cfg.vocab, 5, 6)
    jreqs = _requests(jserver, f32.cfg.vocab, 5, 6)
    for eng, reqs in ((teng, treqs), (jeng, jreqs)):
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
    for tr, jr in zip(treqs, jreqs):
        assert tr.done and len(tr.generated) == 6
        assert tr.generated == jr.generated, tr.uid
    assert teng.metrics()["completed"] == 5


def test_refilled_lane_decodes_as_a_fresh_engine(f32):
    """slots=1: the second request refills the lane the first one left;
    the lane keeps its cross-attention K/V, and its stream equals a fresh
    engine's serving that request alone."""
    frames = f32.frames[:1]
    reqs = _requests(tserver, f32.cfg.vocab, 2, 5)
    engine = tserver.ServeEngine(f32.params, f32.cfg, f32.run,
                                 batch_slots=1, max_len=S, frames=frames)
    cross = {k: v.clone() for k, v in engine.state["cross_kv"].items()}
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    for k, v in engine.state["cross_kv"].items():
        assert torch.equal(v, cross[k]), k
    fresh = tserver.ServeEngine(f32.params, f32.cfg, f32.run, batch_slots=1,
                                max_len=S, frames=frames)
    alone = _requests(tserver, f32.cfg.vocab, 2, 5)[1]
    fresh.submit(alone)
    fresh.run_until_drained()
    assert reqs[1].done and reqs[1].generated == alone.generated


def test_launcher_serves_whisper_smoke_and_refuses_lm(capsys):
    m = tserve.main(["--arch", "whisper-tiny", "--smoke", "--requests", "3",
                     "--max-new", "2", "--slots", "2", "--device", "cpu"])
    assert m["completed"] == 3 and m["submitted"] == 3
    assert "served 3 requests" in capsys.readouterr().out
    for extra in ([], ["--supervised"]):
        with pytest.raises(ValueError, match="legacy wave loop"):
            tserve.main(["--arch", "whisper-tiny", "--smoke", "--lm",
                         *extra, "--device", "cpu"])
