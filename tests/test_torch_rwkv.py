"""The port's rnn_lm path (rwkv6-1.6b) against the reference, on the CPU.

The smoke variant (2 layers, d_model 128, 4 heads of 32, d_ff 256, vocab
512) in f32, with the reference's own init carried over by
``params_from_jax``, and 16-token sequences at ``wkv_chunk = 8`` (two
chunks), as the reference's ``tests/test_recurrent_decode.py`` runs it:

* ``forward_lm`` logits and token-by-token ``decode_step`` logits, port
  against reference, at v0, v1, v3 and v4 (the reference with
  ``backend="pallas"``, its kernels in interpret mode as its own tests run
  them; the port with ``backend="cuda"`` on the CPU, every wrapper on its
  plain version);
* the port's chunked forward against its own decode (the invariant of
  ``test_recurrent_decode.py``);
* ``params_from_jax`` bit for bit, ``ln0_*`` and the f32 ``w0`` and ``u``
  included; the site counts and bytes, the class (``rnn_lm``), the
  resolved tables and the report (site-derived cost-model inputs and loop
  trips equal, the rv32 ladder within 0.1%, the rewrite stats) equal to
  the reference's ``marvel.compile``;
* the slot-reuse repair: a request admitted to a reclaimed slot starts from
  a zero recurrent state, and its first logits and its stream equal a
  fresh single-request decode of the same prompt.

Tolerance, for every logits comparison: 1e-3 absolute and 1e-5 relative,
tighter than the reference's own for this model (2e-3 and 1e-3,
``test_recurrent_decode.py``); the smoke logits reach |129|, and the two
frameworks sum each f32 product in another order.  Each reference program
is built once per module.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import marvel as jmarvel  # noqa: E402
from repro.configs.base import RunConfig as JRun  # noqa: E402
from repro.core import rewrite as jrewrite  # noqa: E402
from repro.configs.registry import get_arch as jget_arch  # noqa: E402
from repro.configs.registry import smoke_variant as jsmoke  # noqa: E402
from repro.core.extensions import resolve_table as jresolve  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import marvel as tmarvel  # noqa: E402
from repro_torch.configs import RunConfig, get_arch, smoke_variant  # noqa: E402
from repro_torch.core.extensions import resolve_table as tresolve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime.kvcache import POSITION_LEAVES  # noqa: E402
from repro_torch.runtime.lm_server import static_decode  # noqa: E402

RUN = dict(seq_len=32, global_batch=2, attn_impl="chunked", attn_chunk=8,
           ssm_chunk=8, wkv_chunk=8)
TOL = dict(atol=1e-3, rtol=1e-5)
B, S = 2, 16
LEVELS = ["v0", "v1", "v3", "v4"]


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


def assert_report_matches(tp, jp, tokens):
    got, want = tp.report, jp.report
    gi = got.profile.as_costmodel_inputs()
    wi = want.profile.as_costmodel_inputs()
    for key in SITE_INPUTS:
        assert gi[key] == wi[key], key
    for key in ("hbm_bytes", "weight_bytes"):  # the CNN test's HBM_REL
        assert gi[key] == pytest.approx(wi[key], rel=2e-2), key
    assert gi["loop_iters"] > 0
    for level in ("v0", "v1", "v2", "v3", "v4"):
        assert got.rv32_cycles[level] == pytest.approx(
            want.rv32_cycles[level], rel=1e-3), level
    assert got.rv32_speedup_v4 == pytest.approx(want.rv32_speedup_v4,
                                                rel=1e-3)
    _, stats = jrewrite.rewrite(jp.fn, jnp.asarray(tokens))
    assert got.rewrite_ok and got.rewrite_stats == stats



class Smoke:
    def __init__(self):
        arch = "rwkv6-1.6b"
        self.jcfg = jsmoke(jget_arch(arch)).replace(param_dtype="float32")
        self.cfg = smoke_variant(get_arch(arch)).replace(
            param_dtype="float32")
        self.jrun, self.run = JRun(**RUN), RunConfig(**RUN)
        self.jparams = JT.init_params(jax.random.PRNGKey(0), self.jcfg)
        self.params = T.params_from_jax(
            jax.tree_util.tree_map(np.asarray, self.jparams), self.cfg)
        self.tokens = np.random.default_rng(0).integers(
            0, self.cfg.vocab, (B, S)).astype(np.int32)
        self._jprogs, self._tprogs = {}, {}

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

    def tdecode(self, level):
        """The port's decode step under the level's table."""
        return self.tprog(level).table.bind(
            lambda s, x: T.decode_step(self.params, s, x, self.cfg,
                                       self.run))

    def decode_logits(self, level):
        """(port, reference) logits of a token-by-token decode of the
        tokens, (B, S, V) each."""
        tstep = self.tdecode(level)
        jstep = self.jprog(level).table.bind(
            lambda s, x: JT.decode_step(self.jparams, s, x, self.jcfg,
                                        self.jrun))
        tstate = T.init_decode_state(self.params, self.cfg, self.run,
                                     batch=B, max_len=S)
        jstate = JT.init_decode_state(self.jparams, self.jcfg, self.jrun,
                                      batch=B, max_len=S)
        touts, jouts = [], []
        with torch.inference_mode():
            for i in range(S):
                tok = self.tokens[:, i:i + 1]
                lg, tstate = tstep(tstate, torch.from_numpy(tok))
                touts.append(n(lg))
                jlg, jstate = jstep(jstate, tok)
                jouts.append(n(jlg))
        return np.concatenate(touts, 1), np.concatenate(jouts, 1)


@pytest.fixture(scope="module")
def rwkv():
    return Smoke()


def test_smoke_variant_is_the_references(rwkv):
    assert rwkv.cfg.rwkv_head_dim == 32 and rwkv.cfg.d_model == 128
    assert rwkv.cfg.d_model // rwkv.cfg.rwkv_head_dim == 4
    for f in ("n_layers", "d_model", "d_ff", "vocab", "rwkv_head_dim",
              "family"):
        assert getattr(rwkv.cfg, f) == getattr(rwkv.jcfg, f), f


def test_params_from_jax_carries_every_leaf_bit_for_bit(rwkv):
    jp = jax.tree_util.tree_map(np.asarray, rwkv.jparams)
    for name in ("ln0_s", "ln0_b", "ln_f"):
        np.testing.assert_array_equal(rwkv.params[name].numpy(), jp[name])
    np.testing.assert_array_equal(rwkv.params["embed"]["table"].numpy(),
                                  jp["embed"]["table"])
    assert len(rwkv.params["layers"]) == 2
    for i, layer in enumerate(rwkv.params["layers"]):
        assert set(layer) == set(jp["layers"])
        for key, leaf in jp["layers"].items():
            assert layer[key].dtype == torch.float32
            np.testing.assert_array_equal(layer[key].numpy(), leaf[i])
    bf = T.params_from_jax(jax.tree_util.tree_map(np.asarray, JT.init_params(
        jax.random.PRNGKey(1), rwkv.jcfg.replace(param_dtype="bfloat16"))),
        rwkv.cfg.replace(param_dtype="bfloat16"))
    layer = bf["layers"][0]
    assert layer["w0"].dtype == layer["u"].dtype == torch.float32
    assert layer["wr"].dtype == bf["ln0_s"].dtype == torch.bfloat16


@pytest.mark.parametrize("level", LEVELS)
def test_rwkv_logits_match_reference_at_the_same_level(rwkv, level):
    got = n(rwkv.tprog(level)(rwkv.tokens))
    want = n(rwkv.jprog(level)(rwkv.tokens))
    assert got.shape == want.shape == (B, S, rwkv.cfg.vocab_padded)
    np.testing.assert_allclose(got, want, **TOL)
    tdec, jdec = rwkv.decode_logits(level)
    np.testing.assert_allclose(tdec, jdec, **TOL)
    # the port's chunked forward against its own token-by-token decode
    np.testing.assert_allclose(got, tdec, **TOL)


def test_rwkv_classifies_and_resolves_as_the_reference(rwkv):
    tp, jp = rwkv.tprog("v4"), rwkv.jprog("v4")
    assert tp.model_class == jp.model_class == "rnn_lm"
    assert tp.extensions == jp.report.recommended_extensions
    assert dict(tp.profile.site_counts) == dict(jp.report.profile.site_counts)
    assert dict(tp.profile.site_bytes) == dict(jp.report.profile.site_bytes)
    assert tp.profile.site_counts["wkv_chunk"] == 1
    assert tp.profile.site_counts["mac_matmul"] == 8
    assert tp.profile.site_counts["matmul_epilogue"] == 2
    for level in ("v0", "v1", "v2", "v3", "v4"):
        want = {p: "cuda" for p, impl in jresolve(
            level, "pallas", extensions=jp.report.recommended_extensions,
            model_class="rnn_lm").items() if impl == "pallas"}
        got = tresolve(level, "cuda", extensions=tp.extensions,
                       model_class=tp.model_class)
        assert dict(got) == want, level
    for pat in ("mac_matmul_int8", "matmul_epilogue", "wkv_chunk"):
        assert tp.table[pat] == "cuda", pat
    assert "residual_rmsnorm" not in tp.table  # no add2i on this ladder
    # the reports: the scan's trip count multiplies what its body records
    assert_report_matches(tp, jp, rwkv.tokens)


def test_rwkv_refuses_int8_kv_with_the_references_message(rwkv):
    msg = "needs a {'k','v'} cache layout"
    for init, p, cfg, run in ((T.init_decode_state, rwkv.params, rwkv.cfg,
                               rwkv.run),
                              (JT.init_decode_state, rwkv.jparams, rwkv.jcfg,
                               rwkv.jrun)):
        with pytest.raises(ValueError, match=msg):
            init(p, cfg, run, batch=1, max_len=16, kv_quant="int8")


def test_reused_slot_starts_from_zero_state(rwkv):
    """slots=1: the second request lands on the slot the first one left,
    whose recurrent state the first sequence filled; at admission its rows
    are zero again, and its first logits and stream equal a fresh decode of
    its prompt (logits: the smoke model's greedy streams are constant)."""
    engine = rwkv.tprog("v4").serve(mode="lm_sync", cfg=rwkv.cfg,
                                    run=rwkv.run, slots=1, bucket_lens=(32,))
    engine.warmup()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, rwkv.cfg.vocab, 6).tolist() for _ in range(2)]
    first = engine.submit(prompts[0], uid=0, max_new_tokens=4)
    engine.run_until_drained()
    assert first.done
    pool = engine.manager.pools[32]
    assert pool.state["cache"]["s"].abs().max() > 0  # the left-over state
    admitted = {}
    alloc = engine.manager.alloc

    def recording(uid, total_len):
        got = alloc(uid, total_len)
        admitted[uid] = {k: t.clone() for k, t in pool.state["cache"].items()}
        return got

    engine.manager.alloc = recording
    second = engine.submit(prompts[1], uid=1, max_new_tokens=4)
    engine.run_until_drained()
    assert second.done and engine.manager.slot_reuses() == 1
    cache = admitted[1]
    for name in ("s", "tm_prev", "cm_prev"):
        assert name not in POSITION_LEAVES
        assert torch.count_nonzero(cache[name][:, 0]) == 0, name
    step = rwkv.tdecode("v4")
    tok = torch.tensor([[prompts[1][0]]], dtype=torch.int32)
    fresh = T.init_decode_state(rwkv.params, rwkv.cfg, rwkv.run, batch=1,
                                max_len=32)
    reused = dict(fresh, cache=cache)
    with torch.inference_mode():
        want, _ = step(fresh, tok)
        got, _ = step(reused, tok)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    stream = static_decode(step, fresh, [prompts[1]], 4, rwkv.cfg.vocab)
    assert second.generated == stream[0]
