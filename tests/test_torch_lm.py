"""The port's dense-LM path against the reference, on the CPU.

The ``residual_rmsnorm`` and ``flash_attention`` wrappers (their plain
versions on CPU tensors) are held against the reference's Pallas kernels in
interpret mode on the shared conformance grid's cases
(``kernel_cases.GRID``: 130 rows of 257, grouped-query, ragged ``sq=200``
and int8-KV attention), in f32 and bf16; the attention cases the reference
wrapper routes to its plain path (``Sq == 1``, ``kv_len``, a window) must
not reach the kernel.  RoPE and the int8 KV quantizer are held on their own
(the codes exactly).  Then the qwen3-8b smoke variant (2 layers, d 128),
with the reference's own init carried over by ``params_from_jax``:
``forward_lm`` logits at v0, v2 and v4 against the reference at the same
level, its classification, tables, site counts and report (the cost
model's site-derived inputs and loop trips equal, the rv32 ladder within
0.1%, the rewrite stats equal), and the continuous-
batching engine's greedy streams against the reference engine's (f32
params, so bf16 ties cannot decide an argmax), with and without int8 KV.
One starcoder2-3b smoke forward covers the non-gated GELU MLP with biases.
The GEMM and attention sites of six LMs at full width (recorded over
fake tensors) take the tensor-core forms of their kernels.
``chip_smoke.flash_launch_reading`` (the card's launch-level reading of
flash attention) is held at a small shape: the honest kernel's rounding
schedule in another f32 order reads below its limit, the schedule with a
bf16 PV accumulator above it.

Tolerances: ``tol_from_acc`` of the compared dtype and reduction length, as
the reference's conformance runner states them (flash attention with its
slack of 4); f32 logits ``tol_from_acc(float32, d_ff)``; bf16 logits within
two bf16 epsilons (2**-6) relative L2, since the two frameworks round bf16
at other places (the reference's XLA rounds ``x*sigmoid(x)`` after each
op, PyTorch's ``silu`` once).  Each reference forward and engine runs once
per module.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import kernel_cases as kc  # noqa: E402
from repro import marvel as jmarvel  # noqa: E402
from repro.configs.base import RunConfig as JRun  # noqa: E402
from repro.core import rewrite as jrewrite  # noqa: E402
from repro.configs.registry import get_arch as jget_arch  # noqa: E402
from repro.configs.registry import smoke_variant as jsmoke  # noqa: E402
from repro.core.extensions import resolve_table as jresolve  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import marvel as tmarvel  # noqa: E402
from repro_torch.configs import RunConfig, get_arch, smoke_variant  # noqa: E402
from repro_torch.core.extensions import resolve_table as tresolve  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import residual_rmsnorm as trr  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime.batching import RetryPolicy  # noqa: E402
from repro_torch.runtime.faults import (  # noqa: E402
    FaultInjector, InjectedFault,
)
from repro_torch.runtime.kvcache import SequenceTooLong  # noqa: E402

BF16_LOGITS_REL = 2.0**-6
RUN = dict(seq_len=32, global_batch=4, mode="decode", attn_chunk=16)



@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-3-2b", "starcoder2-3b",
                                  "rwkv6-1.6b", "granite-34b",
                                  "internvl2-26b"])
def test_lm_kernels_take_the_tensor_core_forms(arch):
    """Every GEMM and attention site of the LMs at full width (recorded
    over fake tensors; internvl2-26b with bf16 patches) is bf16 in shapes
    the tensor-core forms take: the GEMM's decode form at the decode step's
    1..16 slots, its wgmma form at the serve's prefill buckets and the B =
    4, S = 512 prefill (granite-34b's K/V projections N = 128 wide among
    them); flash attention's wgmma form (heads of 64 or 128)."""
    from repro_torch.core import profiler
    from repro_torch.kernels import matmul_epilogue as tme

    cfg = get_arch(arch)
    run = RunConfig(seq_len=8, global_batch=1, mode="prefill")
    gen = torch.Generator().manual_seed(0)
    patches = (torch.zeros((1, 4, cfg.d_model), dtype=torch.bfloat16)
               if cfg.family == "vlm" else None)
    sites = profiler.site_shapes(
        lambda: T.forward_lm(T.init_params(gen, cfg),
                             torch.zeros((1, 8), dtype=torch.int32), cfg, run,
                             patches=patches),
        "matmul_epilogue", "flash_attention")
    gemms = [(w, dt) for p, (_, dt), (w, _) in sites if p == "matmul_epilogue"]
    heads = [(q, k, dt) for p, (q, dt), (k, _) in sites
             if p == "flash_attention"]
    assert gemms and len(heads) == (0 if cfg.family == "rwkv" else 1)
    for (k, n), dt in gemms:
        assert dt == torch.bfloat16
        for m in (1, 8, 16):
            assert tme.gemm_form(m, k, n, dt) == "decode", (m, k, n)
        for m in (32, 64, 2048):
            assert tme.gemm_form(m, k, n, dt) == "wgmma", (m, k, n)
    for q, k, dt in heads:
        assert dt == torch.bfloat16 and q[-1] == cfg.d_head
        assert tfa.flash_form(q[-1], 512, dt) == "wgmma"

def t(a, dtype=None):
    """A JAX/numpy array as a CPU tensor (bf16 carried bit for bit)."""
    out = T._to_torch(np.asarray(a), "cpu")
    return out if dtype is None else out.to(dtype)


def n(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)

# the profile's site-derived cost-model inputs (equal exactly) and the
# rv32 ladder (within 0.1%) against the reference's report
SITE_INPUTS = ("matmul_flops", "loop_iters", "residual_norm_bytes",
               "epilogue_bytes", "conv_epilogue_bytes", "dw_flops",
               "dw_epilogue_bytes", "sep_intermediate_bytes",
               "acc_bytes_saved", "acc_flops", "pool_flops",
               "pool_saved_bytes", "attn_score_bytes", "attn_flops",
               "wkv_flops", "rmsnorm_epilogue_bytes")


# the profile's byte totals against the reference's (the CNN test's limit)
HBM_REL = 2e-2


def assert_bytes_match(got, want):
    """hbm_bytes and weight_bytes of two profiles within ``HBM_REL``."""
    for key in ("hbm_bytes", "weight_bytes"):
        assert getattr(got, key) == pytest.approx(getattr(want, key),
                                                  rel=HBM_REL), key


def assert_report_matches(tp, jp, tokens):
    got, want = tp.report, jp.report
    gi = got.profile.as_costmodel_inputs()
    wi = want.profile.as_costmodel_inputs()
    for key in SITE_INPUTS:
        assert gi[key] == wi[key], key
    assert_bytes_match(got.profile, want.profile)
    assert gi["loop_iters"] > 0
    for level in ("v0", "v1", "v2", "v3", "v4"):
        assert got.rv32_cycles[level] == pytest.approx(
            want.rv32_cycles[level], rel=1e-3), level
    assert got.rv32_speedup_v4 == pytest.approx(want.rv32_speedup_v4,
                                                rel=1e-3)
    _, stats = jrewrite.rewrite(jp.fn, jnp.asarray(tokens))
    assert got.rewrite_ok and got.rewrite_stats == stats



def grid(impl):
    return [pytest.param(case, id=kc.case_id(impl, case))
            for name, case in kc.GRID if name == impl]


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


DTYPES = [pytest.param((jnp.float32, torch.float32), id="f32"),
          pytest.param((jnp.bfloat16, torch.bfloat16), id="bf16")]


# ---------------------------------------------------------------------------
# kernels: plain versions vs the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtypes", DTYPES)
@pytest.mark.parametrize("case", grid("residual_rmsnorm"))
def test_residual_rmsnorm_matches_reference_kernel(case, dtypes):
    jdt, tdt = dtypes
    c = dict(seed=0, rows=33, d=96) | case
    res, x, scale = (a.astype(jdt) for a in kc.rmsnorm_case(
        c["seed"], c["rows"], c["d"]))
    want_res, want = jops._pallas_residual_rmsnorm(res, x, scale)
    before = trr.residual_rmsnorm.launches
    got_res, got = tops._cuda_residual_rmsnorm(t(res), t(x), t(scale))
    assert trr.residual_rmsnorm.launches == before  # CPU: the plain version
    assert got.dtype == got_res.dtype == tdt
    np.testing.assert_array_equal(n(got_res), n(want_res))  # one f32 add
    np.testing.assert_allclose(n(got), n(want),
                               **kc.tol_from_acc(jdt, c["d"]))
    if tdt == torch.bfloat16:
        # the parity hazard: the baseline rounds res + x to bf16 before it
        # normalises, the kernel does not; each side matches its own
        base_res, base = TL._residual_rmsnorm_ref(t(res), t(x), t(scale),
                                                  1e-6)
        jbase_res, jbase = JL._residual_rmsnorm_ref(res, x, scale, 1e-6)
        np.testing.assert_array_equal(n(base_res), n(jbase_res))
        np.testing.assert_allclose(n(base), n(jbase),
                                   **kc.tol_from_acc(jdt, c["d"]))
        assert not np.array_equal(n(base), n(got))


@pytest.mark.parametrize("dtypes", DTYPES)
@pytest.mark.parametrize("case", grid("flash_attention"))
def test_flash_attention_matches_reference_kernel(case, dtypes):
    jdt, tdt = dtypes
    c = dict(seed=0, b=1, sq=64, kheads=2, g=2, dh=16, int8_kv=False) | case
    q, k, v, ks, vs = kc.attn_case(c["seed"], c["b"], c["sq"], c["kheads"],
                                   c["g"], c["dh"], int8_kv=c["int8_kv"])
    q = q.astype(jdt)
    if not c["int8_kv"]:
        k, v = k.astype(jdt), v.astype(jdt)
    want = jops._pallas_flash_attention(q, k, v, causal=True, k_scale=ks,
                                        v_scale=vs)
    kw = {} if ks is None else dict(k_scale=t(ks), v_scale=t(vs))
    got = tops._cuda_flash_attention(t(q), t(k), t(v), causal=True, **kw)
    assert got.dtype == tdt and got.shape == tuple(want.shape)
    np.testing.assert_allclose(n(got), n(want),
                               **kc.tol_from_acc(jdt, c["sq"], slack=4.0))


@pytest.mark.parametrize("route", [
    dict(sq=1, skv=20, kv_len=True), dict(sq=1, skv=20),
    dict(sq=24, skv=24, window=8), dict(sq=8, skv=130, causal=False)])
def test_flash_routing_keeps_the_reference_guards(route, monkeypatch):
    """Decode (Sq == 1), ragged decode (kv_len), windows and non-causal
    attention over a ragged KV tile run the plain reference, never the
    kernel, and match the reference's plain path."""
    r = dict(kv_len=False, window=None, causal=True) | route
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, r["sq"], 2, 2, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, r["skv"], 2, 16)).astype(np.float32)
            for _ in range(2))
    kv_len = np.array([5, 20], np.int32) if r["kv_len"] else None
    kw = dict(causal=r["causal"], window=r["window"],
              impl="naive" if r["sq"] == 1 else "chunked", chunk=16)

    def refuse(*a, **k):
        raise AssertionError("routed to the kernel")

    monkeypatch.setattr(tfa, "flash_attention", refuse)
    got = tops._cuda_flash_attention(
        t(q), t(k), t(v), kv_len=None if kv_len is None else t(kv_len), **kw)
    want = JL._flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), kv_len=kv_len, **kw)
    np.testing.assert_allclose(n(got), n(want),
                               **kc.tol_from_acc(jnp.float32, r["skv"]))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_launch_reading_flags_a_bf16_pv_accumulator(causal):
    """``chip_smoke.flash_launch_reading`` at a small grouped shape (2 key
    tiles): the honest kernel's rounding schedule evaluated in another f32
    order (float64 products rounded to f32) reads below its limit of 1;
    the same schedule with its PV partial sums rounded to bf16 per key tile
    (the planted fault) reads above it.  Both are torch code."""
    import chip_smoke

    r = np.random.default_rng(0)
    bf = torch.bfloat16
    q = torch.from_numpy(r.standard_normal((1, 128, 2, 2, 64),
                                           np.float32)).to(bf)
    k, v = (torch.from_numpy(r.standard_normal((1, 128, 2, 64),
                                               np.float32)).to(bf)
            for _ in range(2))
    other_order = chip_smoke.flash_tile_model(
        q, k, v, causal, dot=lambda a, b: (a.double() @ b.double()).float())
    honest = chip_smoke.flash_launch_reading(q, k, v, causal, other_order)
    wrong = chip_smoke.flash_launch_reading(
        q, k, v, causal, chip_smoke.flash_rounded_pv(q, k, v, causal))
    assert honest <= 1.0 < wrong, (honest, wrong)


def test_rope_and_int8_kv_quantizer_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 4, 32)).astype(np.float32) * 3
    pos = np.arange(40)[None].repeat(2, 0) + np.array([[0], [17]])
    for theta in (1e4, 1e6):
        got = TL.apply_rope(t(x), t(pos), theta)
        want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)
    x[0, 0, 0, :] = 0.0  # an all-zero row: the 1e-8 scale floor
    x[0, 1, 0, 0] = 127.0 * 0.5 / 127.0  # exact halves occur in the codes
    codes, scale = TL.quantize_kv_int8(t(x))
    jcodes, jscale = JL.quantize_kv_int8(jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert codes.dtype == torch.int8 and int(codes.abs().max()) == 127


def test_greedy_argmax_and_plain_products_follow_the_reference():
    """Two parity hazards: ``jnp.argmax`` takes the first of tied maxima
    (random bf16 logits tie often), and the plain products must sum bf16
    in f32 whatever cuBLAS's reduced-precision switch says."""
    from repro_torch.kernels.common import full_f32

    tied = torch.tensor([[1.0, 3.0, 3.0, -2.0], [5.0, 5.0, 5.0, 5.0]],
                        dtype=torch.bfloat16)
    assert tied.argmax(dim=-1).tolist() == np.asarray(jnp.argmax(
        jnp.asarray(n(tied), jnp.bfloat16), axis=-1)).tolist() == [1, 0]
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    try:
        matmul.allow_bf16_reduced_precision_reduction = True
        with full_f32():
            assert not matmul.allow_bf16_reduced_precision_reduction
        assert matmul.allow_bf16_reduced_precision_reduction
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved


# ---------------------------------------------------------------------------
# the qwen3-8b smoke model
# ---------------------------------------------------------------------------


class Smoke:
    def __init__(self, arch, dtype):
        self.jcfg = jsmoke(jget_arch(arch)).replace(param_dtype=dtype)
        self.cfg = smoke_variant(get_arch(arch)).replace(param_dtype=dtype)
        self.jrun, self.run = JRun(**RUN), RunConfig(**RUN)
        self.jparams = JT.init_params(jax.random.PRNGKey(0), self.jcfg)
        self.params = T.params_from_jax(
            jax.tree_util.tree_map(np.asarray, self.jparams), self.cfg)
        self.tokens = np.random.default_rng(0).integers(
            1, self.cfg.vocab, (2, 40)).astype(np.int32)
        self._jprogs, self._tprogs, self._logits = {}, {}, {}

    def jprog(self, level):
        if level not in self._jprogs:
            jcfg, jrun = self.jcfg, self.jrun
            self._jprogs[level] = jmarvel.compile(
                lambda p, x: JT.forward_lm(p, x, jcfg, jrun)[0], self.tokens,
                params=self.jparams, level=level, backend="pallas",
                do_rewrite=False, precompile=False)
        return self._jprogs[level]

    def tprog(self, level):
        if level not in self._tprogs:
            cfg, run = self.cfg, self.run
            self._tprogs[level] = tmarvel.compile(
                lambda p, x: T.forward_lm(p, x, cfg, run)[0], self.tokens,
                params=self.params, level=level, backend="cuda",
                device="cpu")
        return self._tprogs[level]

    def logits(self, level):
        if level not in self._logits:
            self._logits[level] = (n(self.tprog(level)(self.tokens)),
                                   n(self.jprog(level)(self.tokens)))
        return self._logits[level]


@pytest.fixture(scope="module")
def qwen():
    return Smoke("qwen3-8b", "float32")


@pytest.fixture(scope="module")
def qwen_bf16():
    return Smoke("qwen3-8b", "bfloat16")


def test_params_from_jax_carries_every_leaf_bit_for_bit(qwen, qwen_bf16):
    for s in (qwen, qwen_bf16):
        jl = jax.tree_util.tree_map(np.asarray, s.jparams["layers"])
        assert len(s.params["layers"]) == s.cfg.n_layers == 2
        for i, layer in enumerate(s.params["layers"]):
            for path, leaf in jax.tree_util.tree_leaves_with_path(jl):
                keys = [p.key for p in path]
                got = layer
                for key in keys:
                    got = got[key]
                assert got.dtype == T.torch_dtype(s.cfg.param_dtype)
                np.testing.assert_array_equal(n(got), leaf[i].astype(
                    np.float32))
        np.testing.assert_array_equal(
            n(s.params["embed"]["table"]),
            np.asarray(s.jparams["embed"]["table"], np.float32))


@pytest.mark.parametrize("level", ["v0", "v2", "v4"])
def test_qwen3_logits_match_reference_at_the_same_level(qwen, level):
    got, want = qwen.logits(level)
    assert got.shape == want.shape == (2, 40, qwen.cfg.vocab_padded)
    np.testing.assert_allclose(
        got, want, **kc.tol_from_acc(jnp.float32, qwen.cfg.d_ff))


def test_qwen3_bf16_logits_match_reference_at_v2(qwen_bf16):
    got, want = qwen_bf16.logits("v2")
    assert qwen_bf16.tprog("v2").resolved_extensions == {
        "mac_matmul_int8": "cuda", "residual_rmsnorm": "cuda"}
    assert np.isfinite(got).all()
    assert rel_l2(got, want) <= BF16_LOGITS_REL


def test_qwen3_classifies_and_resolves_as_the_reference(qwen):
    tp, jp = qwen.tprog("v4"), qwen.jprog("v4")
    assert tp.model_class == jp.model_class == "dense_lm"
    assert tp.extensions == jp.report.recommended_extensions
    assert dict(tp.profile.site_counts) == dict(jp.report.profile.site_counts)
    assert dict(tp.profile.site_bytes) == dict(jp.report.profile.site_bytes)
    ported = ("matmul_epilogue", "residual_rmsnorm", "flash_attention",
              "sep_block", "mac_matmul_int8", "wkv_chunk")
    for level in ("v0", "v1", "v2", "v3", "v4"):
        want = {p: "cuda" for p, impl in jresolve(
            level, "pallas", extensions=jp.report.recommended_extensions,
            model_class="dense_lm").items() if p in ported}
        got = tresolve(level, "cuda", extensions=tp.extensions,
                       model_class=tp.model_class)
        assert dict(got) == want, level
    assert dict(tp.table) == {"residual_rmsnorm": "cuda",
                              "matmul_epilogue": "cuda", "sep_block": "cuda",
                              "flash_attention": "cuda", "wkv_chunk": "cuda",
                              "mac_matmul_int8": "cuda"}
    # the reports: the scan's trip count multiplies what its body records
    assert_report_matches(tp, jp, qwen.tokens)


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-3-2b", "starcoder2-3b",
                                  "rwkv6-1.6b"])
def test_lm_profile_byte_totals_match_reference(arch):
    """The four LMs' smoke variants at batch 1 (bf16, the reference's own
    weights): the profile's ``hbm_bytes`` and ``weight_bytes`` within
    ``HBM_REL`` of the reference's, so the modelled GPU rows of the report
    are the reference's.  The reference counts a dtype conversion's bytes
    and a contraction's second operand as its weight."""
    from repro.core import profiler as jprof
    from repro_torch.core import profiler as tprof

    jcfg, cfg = jsmoke(jget_arch(arch)), smoke_variant(get_arch(arch))
    jrun, run = JRun(**RUN), RunConfig(**RUN)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg)
    tokens = np.ones((1, 8), np.int32)
    want = jprof.profile_fn(
        lambda p, x: JT.forward_lm(p, x, jcfg, jrun)[0], jparams, tokens)
    got = tprof.profile_fn(lambda p, x: T.forward_lm(p, x, cfg, run)[0],
                           params, torch.from_numpy(tokens))
    assert_bytes_match(got, want)
    assert got.matmul_flops == want.matmul_flops


def test_starcoder2_smoke_forward_matches_reference_at_v4():
    s = Smoke("starcoder2-3b", "float32")
    assert not s.cfg.mlp_gated and s.cfg.attn_bias and s.cfg.n_kv_heads == 2
    got, want = s.logits("v4")
    np.testing.assert_allclose(
        got, want, **kc.tol_from_acc(jnp.float32, s.cfg.d_ff))


# ---------------------------------------------------------------------------
# continuous batching: streams, warm buckets, eviction replay
# ---------------------------------------------------------------------------


def _prompts(vocab, k, seed, lo=3, hi=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(lo, hi + 1))
                         ).tolist() for _ in range(k)]


def _staggered(engine, prompts, budgets):
    engine.warmup()
    reqs = []
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        reqs.append(engine.submit(p, uid=i, max_new_tokens=b))
        engine.step()  # one decode step between arrivals
    engine.run_until_drained()
    return reqs


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["f32_kv",
                                                           "int8_kv"])
def test_engine_streams_match_reference_engine(qwen, kv_quant):
    """Staggered arrivals, mid-flight evictions and slot reuse (6 sequences
    through 4 slots) at v4: the port's greedy streams are the reference
    engine's, token for token, and the port's match its own static
    padded-batch decode."""
    from repro_torch.runtime.lm_server import static_decode

    prompts = _prompts(qwen.cfg.vocab, 6, seed=2)
    budgets = [3, 7, 4, 6, 2, 5]
    kw = dict(slots=4, bucket_lens=(64,), kv_quant=kv_quant)
    jeng = qwen.jprog("v4").serve(mode="lm_sync", cfg=qwen.jcfg,
                                  run=qwen.jrun, **kw)
    teng = qwen.tprog("v4").serve(mode="lm_sync", cfg=qwen.cfg,
                                  run=qwen.run, **kw)
    jreqs = _staggered(jeng, prompts, budgets)
    treqs = _staggered(teng, prompts, budgets)
    for i, (jr, tr) in enumerate(zip(jreqs, treqs)):
        assert tr.done and tr.error is None
        assert tr.generated == jr.generated, f"uid {i} diverged"
        assert len(tr.generated) == budgets[i]
    assert teng.manager.slot_reuses() > 0
    decode = qwen.tprog("v4").table.bind(
        lambda s, x: T.decode_step(qwen.params, s, x, qwen.cfg, qwen.run))
    state = T.init_decode_state(qwen.params, qwen.cfg, qwen.run, batch=6,
                                max_len=64, kv_quant=kv_quant)
    static = static_decode(decode, state, prompts, max(budgets),
                           qwen.cfg.vocab)
    for i, tr in enumerate(treqs):
        assert tr.generated == static[i][:budgets[i]]


def test_engine_warm_buckets_admission_and_eviction_replay(qwen):
    """No new bucket after warmup (a sibling engine warms from the shared
    exec cache), too-long prompts refused at admission, and a poison lane
    isolated by eviction bisection while the innocents replay their full
    prompts to the same streams."""
    prog = qwen.tprog("v4")
    kw = dict(cfg=qwen.cfg, run=qwen.run, slots=4, max_len=64)
    engine = prog.serve(mode="lm_sync", **kw)
    engine.warmup()
    n_buckets = len(engine.manager.bucket_lens)
    assert engine.manager.bucket_lens == (32, 64)
    assert engine.compile_misses + engine.compile_hits == n_buckets
    warm = engine.compile_misses
    with pytest.raises(SequenceTooLong):
        engine.submit(list(range(1, 70)), uid=99, max_new_tokens=8)
    prompts = _prompts(qwen.cfg.vocab, 3, seed=5)
    clean = [engine.submit(p, uid=i, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    engine.run_until_drained()
    assert engine.compile_misses == warm and engine.compile_hits > 0
    sibling = prog.serve(mode="lm_sync", **kw)
    sibling.warmup()
    assert sibling.compile_misses == 0
    assert sibling.compile_hits == n_buckets

    inj = FaultInjector(poison_uids=(1,))
    poisoned = prog.serve(mode="lm_sync", faults=inj,
                          retry=RetryPolicy(max_retries=1,
                                            backoff_base_ms=0.1, jitter=0.0),
                          **kw)
    poisoned.warmup()
    reqs = [poisoned.submit(p, uid=i, max_new_tokens=5)
            for i, p in enumerate(prompts)]
    poisoned.run_until_drained()
    assert isinstance(reqs[1].error, InjectedFault)
    for i in (0, 2):
        assert reqs[i].done and reqs[i].error is None
        assert reqs[i].generated == clean[i].generated
    assert poisoned.replays_total > 0 and inj.injected["poison"] > 0
