"""The port's vlm path (internvl2-26b) and granite-34b's one-KV-head config
against the reference, on the CPU.

internvl2-26b's smoke variant (2 layers, d_model 128, 4 heads of 32 over 2
KV heads, d_ff 256, vocab 512, 8 patches) and granite-34b's (the same
widths over one KV head), their params the reference's own init carried
over by ``params_from_jax``, the tokens and the patch embeddings drawn with
numpy from a seed (the patches in the params' dtype, as the reference's
smoke test draws them in its bf16):

* the smoke variants and the full configs equal the reference's;
* ``params_from_jax`` carries every leaf bit for bit, ``frontend_proj``
  included;
* the ``forward_lm`` logits with patches at v0..v4, port against reference
  at the same level (the reference's kernels in interpret mode, as its own
  tests run them; the port's wrappers on their plain versions), in f32, and
  in bf16 at v0 and v4; a forward without patches raises;
* the v4 report with ``(tokens, patches)`` as example args: class
  ``dense_lm``, the site counts and bytes (the patch projection and the
  logits at the ``mac_matmul`` site), the cost model's site-derived inputs
  and the loop trips equal, hbm and weight bytes within 0.07% (the prefix's
  concatenate moves its bytes, the slice before the logits none), the rv32
  ladder within 0.1%, the rewrite stats equal;
* the decode steps (dense, from tokens alone) against the reference's
  ``decode_step``; the legacy wave loop's streams against the reference's
  ``ServeEngine``; the launcher serves the smoke variant and refuses
  ``--lm`` and ``--supervised``;
* granite-34b: the logits at v0 and v4 and its report, the int8 KV cache's
  drift (scale planes over its one head), and the continuous-batching
  tier's streams against a static decode, through the launcher's own
  factory.

Tolerances, as ``tests/test_torch_encdec.py`` states them.  f32 logits:
1e-3 absolute and 1e-5 relative (the two frameworks sum the f32 products in
other orders).  bf16 logits: relative L2 within two bf16 epsilons (2**-6).
Decode against the reference's decode: the same as the f32 logits; against
the port's own forward, the reference's ``atol`` 2e-3 and ``rtol`` 1e-3
(``tests/test_recurrent_decode.py``).  int8 KV: the decode logits within
relative L2 2e-2 of the f32 cache's, and the port's drift within 1e-3 of
the reference's.  Each reference program runs once per level per module.
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
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import server as jserver  # noqa: E402
from repro_torch import marvel as tmarvel  # noqa: E402
from repro_torch.configs import RunConfig, get_arch, smoke_variant  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime import server as tserver  # noqa: E402
from repro_torch.runtime.lm_server import static_decode  # noqa: E402

VLM, MQA = "internvl2-26b", "granite-34b"
B, S = 2, 32
RUN = dict(seq_len=S, global_batch=B, attn_chunk=16)
TOL = dict(atol=1e-3, rtol=1e-5)
DECODE_TOL = dict(atol=2e-3, rtol=1e-3)
BF16_LOGITS_REL = 2.0**-6
BYTES_REL = 7e-4
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
    """An arch's smoke model in ``dtype`` with the reference's params
    (``of``: a model whose params are cast, one init for both dtypes), both
    packages' run configs, (B, S) tokens and, for vlm, (B, P, d) patches in
    the params' dtype."""

    def __init__(self, arch, dtype, of=None):
        self.jcfg = jsmoke(jget_arch(arch)).replace(param_dtype=dtype)
        self.cfg = smoke_variant(get_arch(arch)).replace(param_dtype=dtype)
        self.jrun, self.run = JRun(**RUN), RunConfig(**RUN)
        self.jparams = (
            JT.init_params(jax.random.PRNGKey(0), self.jcfg) if of is None
            else jax.tree_util.tree_map(
                lambda a: a.astype(jnp.dtype(dtype)), of.jparams))
        self.params = T.params_from_jax(
            jax.tree_util.tree_map(np.asarray, self.jparams), self.cfg)
        rng = np.random.default_rng(0)
        self.tokens = rng.integers(0, self.cfg.vocab, (B, S)).astype(np.int32)
        self.args, self.jargs = (self.tokens,), (self.tokens,)
        if self.cfg.family == "vlm":
            jpatches = jnp.asarray(rng.standard_normal(
                (B, self.cfg.n_patches, self.cfg.d_model)), jnp.dtype(dtype))
            self.jargs += (jpatches,)
            self.args += (T._to_torch(np.asarray(jpatches), "cpu"),)
        self._progs, self._logits, self._decoded = {}, {}, {}

    def progs(self, level):
        """(reference, port) programs of ``forward_lm`` at the level, the
        tokens (and patches) as example args."""
        if level not in self._progs:
            jcfg, jrun, cfg, run = self.jcfg, self.jrun, self.cfg, self.run
            jp = jmarvel.compile(
                lambda p, x, *f: JT.forward_lm(p, x, jcfg, jrun,
                                               patches=f[0] if f else None)[0],
                *self.jargs, params=self.jparams, level=level,
                backend="pallas", do_rewrite=False, precompile=False)
            tp = tmarvel.compile(
                lambda p, x, *f: T.forward_lm(p, x, cfg, run,
                                              patches=f[0] if f else None)[0],
                *self.args, params=self.params, level=level, backend="cuda",
                device="cpu")
            self._progs[level] = jp, tp
        return self._progs[level]

    def logits(self, level):
        """(port, reference) forward logits at the level."""
        if level not in self._logits:
            jp, tp = self.progs(level)
            with torch.inference_mode():
                got = n(tp(*self.args))
            self._logits[level] = got, n(jp(*self.jargs))
        return self._logits[level]

    def step_fn(self):
        return self.progs("v4")[1].table.bind(
            lambda s, x: T.decode_step(self.params, s, x, self.cfg, self.run))

    def decode(self, kv_quant=None):
        """(the port's, the reference's) token-by-token decode logits (B,
        S, V) under the v4 tables, from tokens alone."""
        if kv_quant not in self._decoded:
            self._decoded[kv_quant] = self._decode(kv_quant)
        return self._decoded[kv_quant]

    def _decode(self, kv_quant):
        step = self.step_fn()
        state = T.init_decode_state(self.params, self.cfg, self.run, batch=B,
                                    max_len=S, kv_quant=kv_quant)
        jcfg, jrun = self.jcfg, self.jrun
        jstep = jax.jit(self.progs("v4")[0].table.bind(
            lambda p, s, x: JT.decode_step(p, s, x, jcfg, jrun)))
        jstate = JT.init_decode_state(self.jparams, jcfg, jrun, batch=B,
                                      max_len=S, kv_quant=kv_quant)
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
    return Smoke(VLM, "float32")


@pytest.fixture(scope="module")
def bf16(f32):
    return Smoke(VLM, "bfloat16", of=f32)


@pytest.fixture(scope="module")
def mqa():
    return Smoke(MQA, "float32")


def assert_report_matches(smoke):
    """The v4 report of the port against the reference's, class
    ``dense_lm``."""
    jp, tp = smoke.progs("v4")
    assert tp.model_class == jp.model_class == "dense_lm"
    assert tp.extensions == jp.report.recommended_extensions
    counts = dict(tp.profile.site_counts)
    assert counts == dict(jp.report.profile.site_counts)
    assert dict(tp.profile.site_bytes) == dict(jp.report.profile.site_bytes)
    got, want = tp.report, jp.report
    gi = got.profile.as_costmodel_inputs()
    wi = want.profile.as_costmodel_inputs()
    for key in SITE_INPUTS:
        assert gi[key] == wi[key], key
    for key in ("hbm_bytes", "weight_bytes"):
        assert gi[key] == pytest.approx(wi[key], rel=BYTES_REL), key
    for level in LEVELS:
        assert got.rv32_cycles[level] == pytest.approx(
            want.rv32_cycles[level], rel=1e-3), level
    assert got.rv32_speedup_v4 == pytest.approx(want.rv32_speedup_v4,
                                                rel=1e-3)
    _, stats = jrewrite.rewrite(jp.fn, *(jnp.asarray(a) for a in
                                         smoke.jargs))
    assert got.rewrite_ok and got.rewrite_stats == stats
    return counts


@pytest.mark.parametrize("arch", [VLM, MQA])
def test_smoke_variant_is_the_references(arch):
    cfg, jcfg = smoke_variant(get_arch(arch)), jsmoke(jget_arch(arch))
    for f in cfg.__dataclass_fields__:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    full = get_arch(arch)
    for f in full.__dataclass_fields__:
        assert getattr(full, f) == getattr(jget_arch(arch), f), f
    if arch == VLM:
        assert (cfg.family, cfg.n_patches, full.n_patches) == ("vlm", 8, 256)
        assert (full.n_layers, full.d_model, full.n_kv_heads,
                full.vocab_padded) == (48, 6144, 8, 92672)
    else:
        assert (cfg.family, cfg.n_kv_heads, full.n_kv_heads) == ("dense", 1,
                                                                 1)
        assert (full.n_layers, full.d_model, full.d_ff) == (88, 6144, 24576)


def test_params_from_jax_carries_every_leaf_bit_for_bit(bf16):
    jp = jax.tree_util.tree_map(np.asarray, bf16.jparams)
    assert set(bf16.params) == set(jp) == {"embed", "ln_f", "layers",
                                           "frontend_proj"}
    for got, want in ((bf16.params["ln_f"], jp["ln_f"]),
                      (bf16.params["frontend_proj"], jp["frontend_proj"]),
                      (bf16.params["embed"]["table"], jp["embed"]["table"])):
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    assert tuple(bf16.params["frontend_proj"].shape) == (128, 128)
    leaves = jax.tree_util.tree_leaves_with_path(jp["layers"])
    assert len(bf16.params["layers"]) == 2
    for i, layer in enumerate(bf16.params["layers"]):
        assert set(layer) == {"ln1", "attn", "ln2", "mlp"}
        for path, leaf in leaves:
            got = layer
            for k in path:
                got = got[k.key]
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          leaf[i].view(np.int16))


def test_init_params_draws_the_frontend_projection():
    cfg = smoke_variant(get_arch(VLM))
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    w = params["frontend_proj"]
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (128, 128)
    # dense_init: N(0, 1) / sqrt(fan_in)
    assert float(w.float().std()) == pytest.approx(128**-0.5, rel=0.05)
    assert "frontend_proj" not in T.init_params(
        torch.Generator().manual_seed(0), smoke_variant(get_arch(MQA)))


@pytest.mark.parametrize("level", LEVELS)
def test_vlm_logits_match_reference_at_the_same_level(f32, level):
    got, want = f32.logits(level)
    assert got.shape == want.shape == (B, S, f32.cfg.vocab_padded)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("level", ["v0", "v4"])
def test_vlm_bf16_logits_match_reference(bf16, level):
    got, want = bf16.logits(level)
    assert np.isfinite(got).all()
    assert rel_l2(got, want) <= BF16_LOGITS_REL


def test_vlm_forward_needs_patches_and_attends_to_them(f32):
    """Without patches the forward raises and names ``patches=``; the
    patches reach the text's logits through the causal prefix (other
    patches move every text position's logits)."""
    tokens = torch.from_numpy(f32.tokens)
    with pytest.raises(ValueError, match="needs patches="):
        T.forward_lm(f32.params, tokens, f32.cfg, f32.run)
    with torch.inference_mode():
        a = n(T.forward_lm(f32.params, tokens, f32.cfg, f32.run,
                           patches=f32.args[1])[0])
        b = n(T.forward_lm(f32.params, tokens, f32.cfg, f32.run,
                           patches=-f32.args[1])[0])
    assert a.shape == (B, S, f32.cfg.vocab_padded)
    assert (np.abs(a - b).max(axis=-1) > 1e-3).all()


def test_vlm_report_matches_reference(bf16):
    """The prefix's ops map onto the reference's eqns: the patch
    projection's ``mac_matmul`` site, the concatenate (its bytes), the
    slice before the logits (none)."""
    counts = assert_report_matches(bf16)
    # per program site: the patch projection and the MLP's up projection at
    # mac_matmul, 6 GEMMs, one flash attention, one fused norm
    for pat, k in (("mac_matmul", 2), ("matmul_epilogue", 6),
                   ("flash_attention", 1), ("residual_rmsnorm", 1)):
        assert counts[pat] == k, pat
    jp, tp = bf16.progs("v4")
    assert dict(tp.table) == {p: "cuda" for p in tp.table}
    assert "mac_matmul" not in tp.table  # no kernel in either package
    assert tp.profile.counts["other:cat"] == jp.report.profile.counts[
        "other:concatenate"]


def test_vlm_decode_matches_reference(f32):
    """The vlm decode step is the dense one, from tokens alone, in both
    packages."""
    got, want = f32.decode()
    assert got.shape == (B, S, f32.cfg.vocab_padded)
    np.testing.assert_allclose(got, want, **TOL)


def _requests(module, vocab, k, budget):
    rng = np.random.default_rng(7)
    return [module.Request(uid=i, prompt=rng.integers(1, vocab, int(
        rng.integers(3, 7))).tolist(), max_new_tokens=budget)
        for i in range(k)]


def test_wave_loop_streams_equal_reference_engine(f32):
    """5 requests through 2 lanes (so lanes are refilled) of the legacy
    wave loop, from tokens alone in both packages (the reference's loop
    passes no patches): the greedy streams are equal token for token."""
    kw = dict(batch_slots=B, max_len=S)
    teng = tserver.ServeEngine(f32.params, f32.cfg, f32.run, **kw)
    jeng = jserver.ServeEngine(f32.jparams, f32.jcfg, f32.jrun, **kw)
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


def test_launcher_serves_internvl2_smoke_and_refuses_lm(capsys):
    m = tserve.main(["--arch", VLM, "--smoke", "--requests", "3",
                     "--max-new", "2", "--slots", "2", "--device", "cpu"])
    assert m["completed"] == 3 and m["submitted"] == 3
    assert "served 3 requests" in capsys.readouterr().out
    for extra in ([], ["--supervised"]):
        with pytest.raises(ValueError, match="vlm family.*legacy wave loop"):
            tserve.main(["--arch", VLM, "--smoke", "--lm", *extra,
                         "--device", "cpu"])
    from repro_torch.runtime.actor import lm_program_factory

    with pytest.raises(ValueError, match="needs patches="):
        lm_program_factory(VLM, smoke=True, device="cpu")


@pytest.mark.parametrize("level", ["v0", "v4"])
def test_granite_34b_logits_match_reference(mqa, level):
    assert mqa.cfg.n_kv_heads == 1 and mqa.cfg.n_heads == 4
    got, want = mqa.logits(level)
    np.testing.assert_allclose(got, want, **TOL)


def test_granite_34b_report_matches_reference(mqa):
    counts = assert_report_matches(mqa)
    assert counts["mac_matmul"] == 1 and counts["matmul_epilogue"] == 6


def test_granite_34b_decode_and_int8_kv_drift(mqa):
    """The decode against the port's forward and the reference's decode;
    the int8 cache's scale planes hold one head, and its drift is bounded
    and the reference's."""
    got, want = mqa.decode()
    fwd, _ = mqa.logits("v4")
    np.testing.assert_allclose(got, fwd, **DECODE_TOL)
    np.testing.assert_allclose(got, want, **TOL)
    state = T.init_decode_state(mqa.params, mqa.cfg, mqa.run, batch=B,
                                max_len=S, kv_quant="int8")
    assert tuple(state["cache"]["k_scale"].shape) == (2, B, S, 1)
    got8, want8 = mqa.decode(kv_quant="int8")
    drift, jdrift = rel_l2(got8, got), rel_l2(want8, want)
    assert 0 < drift <= 2e-2, drift
    assert drift == pytest.approx(jdrift, abs=1e-3)


def test_granite_34b_continuous_tier_streams_equal_static_decode(capsys):
    """The launcher's factory at v4 on the CPU: staggered arrivals through
    2 slots with int8 KV equal a static decode of each prompt in its own
    lane; the launcher serves ``--lm`` with 0 new buckets after warmup."""
    from repro_torch.runtime.actor import lm_program_factory

    prog, ctx = lm_program_factory(MQA, smoke=True, device="cpu")
    cfg, run = ctx["cfg"], ctx["run"]
    engine = prog.serve(mode="lm_sync", cfg=cfg, run=run, slots=2,
                        bucket_lens=(32,), kv_quant="int8")
    engine.warmup()
    prompts = [r.prompt for r in _requests(tserver, cfg.vocab, 4, 0)]
    reqs = []
    for i, p in enumerate(prompts):
        reqs.append(engine.submit(p, uid=i, max_new_tokens=4))
        engine.step()
    engine.run_until_drained()
    decode = prog.table.bind(
        lambda s, x: T.decode_step(prog.bound_params, s, x, cfg, run))
    state = T.init_decode_state(prog.bound_params, cfg, run, batch=4,
                                max_len=32, kv_quant="int8")
    static = static_decode(decode, state, prompts, 4, cfg.vocab)
    for r, want in zip(reqs, static):
        assert r.done and r.error is None and r.generated == want, r.uid
    m = tserve.main(["--arch", MQA, "--smoke", "--lm", "--requests", "3",
                     "--max-new", "2", "--slots", "2", "--kv-quant", "int8",
                     "--device", "cpu"])
    assert m["completed"] == 3 and m["errors"] == 0
    assert "0 new buckets after warmup" in capsys.readouterr().out
