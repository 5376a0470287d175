"""The port's hybrid_lm path (hymba-1.5b) and the ssm_lm stack against the
reference, on the CPU.

The smoke variant (2 layers, d_model 128, 4 heads of 32 over 2 KV heads,
d_ff 256, vocab 512, SSM d_inner 256 with 8 states, a 32-token sliding
window), its params the reference's own init carried over by
``params_from_jax``:

* ``forward_lm`` logits at v0..v4, port against reference at the same
  level (the reference's kernels in interpret mode, as its own tests run
  them; the port's wrappers on their plain versions), in f32, and in bf16
  at v0 and v4;
* the ``ssm_chunk`` site alone, ``_ssm_forward_ref`` of both packages on
  the same in-projected input and initial state, at a ragged S (padded to
  the chunk) and at a chunk of odd length, and one ``ssm_decode`` step;
* the v4 report of the bf16 model at S = 64, ``attn_chunk`` = ``ssm_chunk``
  = 32 (two SWA blocks and two SSM chunks per layer): class ``hybrid_lm``,
  site counts and bytes, the cost model's site-derived inputs and loop
  trips equal, hbm and weight bytes within 2%, the rv32 ladder within 0.1%
  (v0 -> v4 2.047), the rewrite stats equal; the pure-SSM stack classifies
  ``ssm_lm`` with the reference's site counts and logits;
* the port's decode against its forward across the rolling window (48
  tokens: two windows, six SSM chunks of 8), the int8 KV cache's drift,
  a repeated decode step, and a request admitted to a reused slot.

Tolerances.  f32 logits: 1e-3 absolute and 1e-5 relative (the smoke logits
reach |103|; the two frameworks sum the f32 products in other orders and
evaluate exp and the sigmoid to within an ulp).  bf16 logits: relative L2
within two bf16 epsilons (2**-6), as the dense test states it (the MLP's
``silu`` act is one PyTorch op, rounded once, where XLA rounds after each
op).  The SSM site follows the reference's bf16 roundings op for op, so
in bf16 its output equals the reference's on all but a few elements in
10**4, each within one bf16 rounding, when the reference runs op by op
(compiled, XLA keeps f32 inside its CPU fusions and moves the state by up
to 8e-3); in f32 it is within 1e-5 relative.
Decode against the forward: the reference's own ``atol`` 2e-3 and ``rtol``
1e-3 (``tests/test_recurrent_decode.py``).  The reference's programs run
once per level per module, the v4 compile once.
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
from repro.core.extensions import resolve_table as jresolve  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import marvel as tmarvel  # noqa: E402
from repro_torch.configs import RunConfig, get_arch, smoke_variant  # noqa: E402
from repro_torch.core.extensions import resolve_table as tresolve  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime.kvcache import POSITION_LEAVES  # noqa: E402
from repro_torch.runtime.lm_server import static_decode  # noqa: E402

ARCH = "hymba-1.5b"
RUN = dict(seq_len=64, global_batch=2, attn_chunk=32, ssm_chunk=32)
RUN_DECODE = dict(seq_len=48, global_batch=2, attn_chunk=8, ssm_chunk=8)
TOL = dict(atol=1e-3, rtol=1e-5)
DECODE_TOL = dict(atol=2e-3, rtol=1e-3)
BF16_LOGITS_REL = 2.0**-6
B, S = 2, 64
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


def t(a):
    return T._to_torch(np.asarray(a), "cpu")


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class Smoke:
    """The smoke model in ``dtype`` with the reference's params, both
    packages' run configs and a (B, S) batch of tokens."""

    def __init__(self, dtype, run=RUN):
        self.jcfg = jsmoke(jget_arch(ARCH)).replace(param_dtype=dtype)
        self.cfg = smoke_variant(get_arch(ARCH)).replace(param_dtype=dtype)
        self.jrun, self.run = JRun(**run), RunConfig(**run)
        self.jparams = JT.init_params(jax.random.PRNGKey(0), self.jcfg)
        self.params = T.params_from_jax(
            jax.tree_util.tree_map(np.asarray, self.jparams), self.cfg)
        self.tokens = np.random.default_rng(0).integers(
            0, self.cfg.vocab, (B, run["seq_len"])).astype(np.int32)
        self._logits = {}

    def table(self, level):
        """(reference, port) tables of the level on the hybrid_lm ladder."""
        return (jresolve(level, "pallas", model_class="hybrid_lm"),
                tresolve(level, "cuda", model_class="hybrid_lm"))

    def logits(self, level):
        """(port, reference) forward logits under the level's tables."""
        if level not in self._logits:
            jtab, ttab = self.table(level)
            jcfg, jrun, cfg, run = self.jcfg, self.jrun, self.cfg, self.run
            jfwd = jax.jit(jtab.bind(
                lambda p, x: JT.forward_lm(p, x, jcfg, jrun)[0]))
            tfwd = ttab.bind(lambda p, x: T.forward_lm(p, x, cfg, run)[0])
            with torch.inference_mode():
                got = n(tfwd(self.params, torch.from_numpy(self.tokens)))
            self._logits[level] = got, n(jfwd(self.jparams, self.tokens))
        return self._logits[level]

    def decode(self, tokens, level="v4", kv_quant=None):
        """The port's token-by-token decode logits (B, S, V) under the
        level's table."""
        step = self.table(level)[1].bind(
            lambda s, x: T.decode_step(self.params, s, x, self.cfg, self.run))
        state = T.init_decode_state(self.params, self.cfg, self.run,
                                    batch=tokens.shape[0],
                                    max_len=tokens.shape[1],
                                    kv_quant=kv_quant)
        outs = []
        with torch.inference_mode():
            for i in range(tokens.shape[1]):
                lg, state = step(state, torch.from_numpy(tokens[:, i:i + 1]))
                outs.append(n(lg))
        return np.concatenate(outs, 1), state


@pytest.fixture(scope="module")
def f32():
    return Smoke("float32")


@pytest.fixture(scope="module")
def bf16():
    """The bf16 model with the reference's v4 program, compiled once."""
    s = Smoke("bfloat16")
    jcfg, jrun, cfg, run = s.jcfg, s.jrun, s.cfg, s.run
    s.jprog = jmarvel.compile(
        lambda p, x: JT.forward_lm(p, x, jcfg, jrun)[0], s.tokens,
        params=s.jparams, level="v4", backend="pallas", do_rewrite=False,
        precompile=False)
    s.tprog = tmarvel.compile(
        lambda p, x: T.forward_lm(p, x, cfg, run)[0], s.tokens,
        params=s.params, level="v4", backend="cuda", device="cpu")
    return s


@pytest.fixture(scope="module")
def dec():
    return Smoke("float32", RUN_DECODE)


def test_smoke_variant_is_the_references(f32):
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab", "ssm_d_inner", "ssm_state",
              "ssm_conv", "sliding_window"):
        assert getattr(f32.cfg, f) == getattr(f32.jcfg, f), f
    assert (f32.cfg.ssm_d_inner, f32.cfg.ssm_state,
            f32.cfg.sliding_window) == (256, 8, 32)
    full = get_arch(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "ssm_state", "ssm_d_inner",
              "sliding_window"):
        assert getattr(full, f) == getattr(jget_arch(ARCH), f), f


def test_params_from_jax_carries_every_leaf_bit_for_bit(bf16):
    jp = jax.tree_util.tree_map(np.asarray, bf16.jparams)
    np.testing.assert_array_equal(n(bf16.params["ln_f"]),
                                  jp["ln_f"].astype(np.float32))
    np.testing.assert_array_equal(
        bf16.params["embed"]["table"].view(torch.int16).numpy(),
        jp["embed"]["table"].view(np.int16))
    assert len(bf16.params["layers"]) == 2
    leaves = jax.tree_util.tree_leaves_with_path(jp["layers"])
    assert len(leaves) == 20
    for i, layer in enumerate(bf16.params["layers"]):
        assert set(layer) == set(jp["layers"])
        for path, leaf in leaves:
            got = layer
            for k in path:
                got = got[k.key]
            assert str(got.dtype).removeprefix("torch.") == leaf.dtype.name
            want = leaf[i]
            if want.dtype.name == "bfloat16":
                got, want = got.view(torch.int16), want.view(np.int16)
            np.testing.assert_array_equal(got.numpy(), want)
    ssm = bf16.params["layers"][0]["ssm"]
    assert ssm["A_log"].dtype == ssm["D"].dtype == torch.float32
    assert ssm["in_proj"].dtype == torch.bfloat16


@pytest.mark.parametrize("level", LEVELS)
def test_hybrid_logits_match_reference_at_the_same_level(f32, level):
    got, want = f32.logits(level)
    assert got.shape == want.shape == (B, S, f32.cfg.vocab_padded)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("level", ["v0", "v4"])
def test_hybrid_bf16_logits_match_reference(bf16, level):
    got, want = bf16.logits(level)
    assert np.isfinite(got).all()
    assert rel_l2(got, want) <= BF16_LOGITS_REL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_chunk_site_matches_reference(dtype):
    """``_ssm_forward_ref`` on the same in-projected (B, 45, 2 di) input and
    a given ``h0``: chunks of 16 (45 padded to 48) and 45 (one chunk of odd
    length); then one decode step from a given state.  In bf16 the reference
    runs op by op: compiled, XLA keeps f32 inside its fusions on the CPU
    and the final state moves by up to 8e-3 (its program rounds each op to
    bf16, as the port does); the whole model's bf16 logits are held against
    the compiled reference above."""
    jcfg, cfg = jsmoke(jget_arch(ARCH)), smoke_variant(get_arch(ARCH))
    jp = JS.ssm_init(jax.random.PRNGKey(3), jcfg, jnp.dtype(dtype))
    tp = {k: t(v) for k, v in jp.items()}
    assert tp["A_log"].dtype == torch.float32
    rng = np.random.default_rng(1)
    jxz = jnp.asarray(rng.standard_normal((2, 45, 512)), jnp.dtype(dtype))
    h0 = (rng.standard_normal((2, 256, 8)) * 0.5).astype(np.float32)
    # in bf16 the reference evaluated op by op, as its program states the
    # roundings (compiled, XLA keeps f32 inside its fusions on the CPU)
    ref, dec = JS._ssm_forward_ref, JS.ssm_decode
    if dtype == "float32":
        ref = jax.jit(ref, static_argnames=("cfg", "chunk"))
        dec = jax.jit(dec, static_argnames=("cfg",))
    for chunk in (16, 64):
        want, want_h = ref(jp, jxz, cfg=jcfg, h0=jnp.asarray(h0),
                           chunk=chunk)
        got, got_h = TS._ssm_forward_ref(tp, t(jxz), cfg,
                                         h0=torch.from_numpy(h0), chunk=chunk)
        assert got.dtype == t(jxz).dtype and got_h.dtype == torch.float32
        np.testing.assert_allclose(n(got_h), n(want_h), rtol=1e-5,
                                   atol=1e-5)
        if dtype == "float32":
            np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)
        else:
            assert np.mean(n(got) != n(want)) < 1e-3
            np.testing.assert_allclose(n(got), n(want), rtol=2.0**-7,
                                       atol=2.0**-14)
    state = {"h": h0, "conv": rng.standard_normal((2, 3, 256)).astype(
        np.float32)}
    jx = jnp.asarray(rng.standard_normal((2, 1, 128)), jnp.dtype(dtype))
    want, want_s = dec(jp, jx, {k: jnp.asarray(v) for k, v in state.items()},
                       cfg=jcfg)
    got, got_s = TS.ssm_decode(tp, t(jx), {k: torch.from_numpy(v)
                                           for k, v in state.items()}, cfg)
    np.testing.assert_allclose(n(got), n(want), rtol=2.0**-7, atol=1e-5)
    for k in ("h", "conv"):
        assert got_s[k].dtype == torch.float32
        np.testing.assert_allclose(n(got_s[k]), n(want_s[k]), rtol=1e-5,
                                   atol=1e-5)


def test_hybrid_report_matches_reference(bf16):
    tp, jp = bf16.tprog, bf16.jprog
    assert tp.model_class == jp.model_class == "hybrid_lm"
    assert tp.extensions == jp.report.recommended_extensions
    counts = dict(tp.profile.site_counts)
    assert counts == dict(jp.report.profile.site_counts)
    assert dict(tp.profile.site_bytes) == dict(jp.report.profile.site_bytes)
    for pat, k in (("matmul_epilogue", 7), ("mac_matmul", 4),
                   ("ssm_chunk", 1), ("flash_attention", 1),
                   ("residual_rmsnorm", 1), ("rms_norm", 4)):
        assert counts[pat] == k, pat
    assert dict(tp.table) == {p: "cuda" for p in (
        "residual_rmsnorm", "matmul_epilogue", "sep_block", "flash_attention",
        "wkv_chunk", "mac_matmul_int8")}
    assert "ssm_chunk" not in tp.table  # no kernel in either package
    got, want = tp.report, jp.report
    gi = got.profile.as_costmodel_inputs()
    wi = want.profile.as_costmodel_inputs()
    for key in SITE_INPUTS:
        assert gi[key] == wi[key], key
    assert gi["loop_iters"] == 10  # 2 layers, 2 SWA blocks and 2 chunks each
    assert gi["attn_score_bytes"] > 0 and gi["attn_flops"] > 0
    for key in ("hbm_bytes", "weight_bytes"):
        assert gi[key] == pytest.approx(wi[key], rel=2e-2), key
    for level in LEVELS:
        assert got.rv32_cycles[level] == pytest.approx(
            want.rv32_cycles[level], rel=1e-3), level
    assert got.rv32_speedup_v4 == pytest.approx(want.rv32_speedup_v4,
                                                rel=1e-3)
    assert got.rv32_speedup_v4 == pytest.approx(2.047, abs=1e-3)
    _, stats = jrewrite.rewrite(jp.fn, jnp.asarray(bf16.tokens))
    assert got.rewrite_ok and got.rewrite_stats == stats


def test_ssm_stack_classifies_as_ssm_lm():
    """The pure-SSM stack (the reference's layers, a list run in a Python
    loop) compiles to class ``ssm_lm`` with the reference's site counts,
    and its f32 logits match the reference's at v4."""
    jcfg = jsmoke(jget_arch(ARCH)).replace(param_dtype="float32")
    cfg = smoke_variant(get_arch(ARCH)).replace(param_dtype="float32")
    jrun, run = JRun(**RUN), RunConfig(**RUN)
    jparams = JS.ssm_stack_init(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg)
    assert isinstance(params["layers"], list) and len(params["layers"]) == 2
    tokens = np.random.default_rng(2).integers(0, cfg.vocab,
                                               (1, 48)).astype(np.int32)
    jp = jmarvel.compile(
        lambda p, x: JS.ssm_stack_forward(p, x, jcfg, jrun)[0], tokens,
        params=jparams, level="v4", backend="pallas", do_rewrite=False,
        precompile=False)
    tp = tmarvel.compile(
        lambda p, x: TS.ssm_stack_forward(p, x, cfg, run)[0], tokens,
        params=params, level="v4", backend="cuda", device="cpu")
    assert tp.model_class == jp.model_class == "ssm_lm"
    assert dict(tp.profile.site_counts) == dict(jp.report.profile.site_counts)
    assert tp.profile.site_counts["ssm_chunk"] == 2
    assert tp.profile.loop_iters == jp.report.profile.loop_iters == 4
    np.testing.assert_allclose(n(tp(tokens)), n(jp(tokens)), **TOL)
    init = TS.ssm_stack_init(torch.Generator().manual_seed(0), cfg)
    assert len(init["layers"]) == 2 and init["layers"][0]["ssm"][
        "D"].dtype == torch.float32


def test_decode_matches_forward_across_the_window(dec):
    """48 tokens through the 32-token rolling window and six SSM chunks of
    8: the port's token-by-token decode against its own blocked-SWA,
    chunked-scan forward, and that forward against the reference's."""
    got, state = dec.decode(dec.tokens)
    fwd, want = dec.logits("v4")
    np.testing.assert_allclose(got, fwd, **DECODE_TOL)
    np.testing.assert_allclose(fwd, want, **TOL)
    assert state["cache"]["k"].shape[2] == 32  # min(max_len, window)
    assert int(state["index"][0]) == 48


def test_int8_kv_drift_is_bounded(dec):
    """int8 K/V with f32 scales, the SSM state passed through untouched:
    the decode logits stay within relative L2 2e-2 of the f32 cache's
    (the per-(position, head) amax quantizer's error, 1/254 of each row's
    largest element), and the state's h/conv leaves are f32 as before."""
    state = T.init_decode_state(dec.params, dec.cfg, dec.run, batch=2,
                                max_len=48, kv_quant="int8")
    cache = state["cache"]
    assert cache["k"].dtype == cache["v"].dtype == torch.int8
    assert cache["k_scale"].shape == (2, 2, 32, 2)
    assert cache["h"].dtype == cache["conv"].dtype == torch.float32
    assert cache["h"].shape == (2, 2, 256, 8)
    assert cache["conv"].shape == (2, 2, 3, 256)
    got, _ = dec.decode(dec.tokens, kv_quant="int8")
    want, _ = dec.decode(dec.tokens)
    drift = rel_l2(got, want)
    assert 0 < drift <= 2e-2, drift


def test_repeated_step_leaves_state_as_one_step(dec):
    """A step retried from the same state (the LM engine's retry path)
    gives the same logits and state as one step: the SSM's h/conv come back
    in new tensors, the K/V rows are rewritten with the same values."""
    step = dec.table("v4")[1].bind(
        lambda s, x: T.decode_step(dec.params, s, x, dec.cfg, dec.run))
    state = T.init_decode_state(dec.params, dec.cfg, dec.run, batch=2,
                                max_len=48)
    with torch.inference_mode():
        for i in range(40):  # past the window: the rows roll over
            _, state = step(state, torch.from_numpy(dec.tokens[:, i:i + 1]))
        before = {k: v.clone() for k, v in state["cache"].items()}
        tok = torch.from_numpy(dec.tokens[:, 40:41])
        lg1, s1 = step(state, tok)
        once = {k: v.clone() for k, v in s1["cache"].items()}
        for k in ("h", "conv"):  # the old state is untouched
            assert torch.equal(state["cache"][k], before[k]), k
        lg2, s2 = step(state, tok)
    torch.testing.assert_close(lg2, lg1, rtol=0, atol=0)
    for k, v in s2["cache"].items():
        torch.testing.assert_close(v, once[k], rtol=0, atol=0)
    assert not torch.equal(once["h"], before["h"])
    assert torch.equal(s2["index"], state["index"] + 1)


def test_reused_slot_starts_from_zero_ssm_state(dec):
    """slots=1: the second request lands on the slot the first one left,
    whose h/conv rows the first sequence filled; at admission they are
    zero (the reference's manager leaves them), and its first logits and
    its stream equal a fresh decode of its prompt."""
    cfg, run = dec.cfg, dec.run
    prog = tmarvel.compile(lambda p, x: T.forward_lm(p, x, cfg, run)[0],
                           dec.tokens[:1, :8], params=dec.params, level="v4",
                           backend="cuda", device="cpu")
    assert prog.model_class == "hybrid_lm"
    engine = prog.serve(mode="lm_sync", cfg=cfg, run=run, slots=1,
                        bucket_lens=(48,))
    engine.warmup()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab, 6).tolist() for _ in range(2)]
    first = engine.submit(prompts[0], uid=0, max_new_tokens=4)
    engine.run_until_drained()
    assert first.done
    pool = engine.manager.pools[48]
    assert pool.state["cache"]["h"].abs().max() > 0  # the left-over state
    admitted = {}
    alloc = engine.manager.alloc

    def recording(uid, total_len):
        got = alloc(uid, total_len)
        admitted[uid] = {k: v.clone() for k, v in pool.state["cache"].items()}
        return got

    engine.manager.alloc = recording
    second = engine.submit(prompts[1], uid=1, max_new_tokens=4)
    engine.run_until_drained()
    assert second.done and engine.manager.slot_reuses() == 1
    cache = admitted[1]
    for name in ("h", "conv"):
        assert name not in POSITION_LEAVES
        assert torch.count_nonzero(cache[name][:, 0]) == 0, name
    step = prog.table.bind(
        lambda s, x: T.decode_step(dec.params, s, x, cfg, run))
    fresh = T.init_decode_state(dec.params, cfg, run, batch=1, max_len=48)
    tok = torch.tensor([[prompts[1][0]]], dtype=torch.int32)
    with torch.inference_mode():
        want, _ = step(fresh, tok)
        got, _ = step(dict(fresh, cache=cache), tok)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert second.generated == static_decode(step, fresh, [prompts[1]], 4,
                                             cfg.vocab)[0]
