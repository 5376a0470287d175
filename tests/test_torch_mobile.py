"""The port's mobile CNNs and DenseNet121 against the reference, on the CPU.

The depthwise and separable-block kernels' plain versions (what their
wrappers run on CPU tensors) are held against the reference's Pallas
kernels in interpret mode, and the ``cuda`` dispatch wrappers against the
reference's ``pallas`` wrappers, on the shared conformance grid's cases
(``kernel_cases.GRID``) and on the guard cases of ``test_depthwise.py``.
Then MobileNetV1, MobileNetV2 and DenseNet121 at full width and their
native 64x64x3 input, batch 2, with the reference's own weights carried
across through numpy and inputs from a numpy seed, match the reference's
logits at the same level: v0 within 1e-4 relative L2 (f32 sums in another
order), v2 and v4 within 1e-3 (the kernels' plain versions against the
Pallas kernels in interpret mode).  One reference forward per (model,
level) is computed and shared.

Tolerances: depthwise rtol = atol = 1e-5 (the int32 sums are exact, only
the f32 epilogue rounds); separable block ``tol_from_acc(float32, C)``
against the kernel (an f32 contraction over C summed in another order) and
``tol_from_acc(int32, C, slack=2)`` between the wrappers, as the
reference's own conformance runner states it.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import kernel_cases as kc  # noqa: E402
from repro.core import dispatch as jdispatch  # noqa: E402
from repro.core.extensions import resolve_table as jresolve  # noqa: E402
from repro.kernels import depthwise_conv as jdw  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.core import dispatch as tdispatch  # noqa: E402
from repro_torch.core import profiler as tprofiler  # noqa: E402
from repro_torch.core.extensions import resolve_table as tresolve  # noqa: E402
from repro_torch.kernels import depthwise_conv as tdw  # noqa: E402
from repro_torch.kernels import fused_conv as tfc  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

DW_TOL = dict(rtol=1e-5, atol=1e-5)
LEVEL_TOL = {"v0": 1e-4, "v2": 1e-3, "v4": 1e-3}


def t(a):
    """A JAX array (or None) as a CPU tensor of the same dtype."""
    return None if a is None else torch.from_numpy(np.array(a))


def grid(impl):
    return [pytest.param(case, id=kc.case_id(impl, case))
            for name, case in kc.GRID if name == impl]


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def dw_inputs(seed=0, h=13, w_sp=11, c=5, stride=1, padding="SAME",
              act="relu"):
    x, w, b, s, sh = kc.dw_case(seed, h, w_sp, c)
    return x, w, b, s, sh, dict(stride=stride, padding=padding, act=act)


def sep_inputs(seed=0, h=13, w_sp=11, c=5, cout=9, stride=1, dw_act="relu",
               pw_act="none"):
    args = kc.sep_case(seed, h, w_sp, c, cout)
    return args, dict(stride=stride, dw_act=dw_act, pw_act=pw_act)


def sep_kwargs(args, kw):
    x, wd, wp, ds, dt, ps, pt = args
    return (x, wd, wp), dict(dw_scale=ds, dw_shift=dt, pw_scale=ps,
                             pw_shift=pt, **kw)


def as_torch(args, kwargs):
    return ([t(a) for a in args],
            {k: t(v) if hasattr(v, "dtype") else v for k, v in kwargs.items()})


# ---------------------------------------------------------------------------
# plain versions vs the reference's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", grid("depthwise_conv"))
def test_depthwise_plain_matches_pallas_kernel(case):
    x, w, b, s, sh, kw = dw_inputs(**case)
    x8, xs = jops._quant_int8(x)
    w8, ws = jops._quant_int8(w[:, :, 0, :], axes=(0, 1))
    es, eb = xs * ws * s, b * s + sh
    want = jdw.depthwise_conv_int8(x8, w8, es, eb, **kw)
    got = tdw.depthwise_conv_int8_plain(t(x8), t(w8), t(es), t(eb), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DW_TOL)


@pytest.mark.parametrize("case", grid("sep_block"))
def test_sep_block_plain_matches_pallas_kernel(case):
    (x, wd, wp, ds, dt, ps, pt), kw = sep_inputs(**case)
    c, cout = x.shape[-1], wp.shape[-1]
    x8, xs = jops._quant_int8(x)
    wd8, wds = jops._quant_int8(wd[:, :, 0, :], axes=(0, 1))
    wp8, wps = jops._quant_int8(wp.reshape(c, cout), axes=(0,))
    folded = (x8, wd8, xs * wds * ds, dt, wp8, wps * ps, pt)
    want = jdw.sep_block_int8(*folded, **kw)
    got = tdw.sep_block_int8_plain(*map(t, folded), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **kc.tol_from_acc(jnp.float32, c))


# ---------------------------------------------------------------------------
# the cuda dispatch wrappers vs the reference's pallas wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", grid("depthwise_conv"))
def test_depthwise_wrapper_matches_pallas_wrapper(case):
    x, w, b, s, sh, kw = dw_inputs(**case)
    want = jops._pallas_depthwise_conv(x, w, b, scale=s, shift=sh, **kw)
    got = tops._cuda_depthwise_conv(t(x), t(w), t(b), scale=t(s),
                                    shift=t(sh), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DW_TOL)


@pytest.mark.parametrize("case", grid("sep_block"))
def test_sep_block_wrapper_matches_pallas_wrapper(case):
    args, kwargs = sep_kwargs(*sep_inputs(**case))
    want = jops._pallas_sep_block(*args, **kwargs)
    targs, tkwargs = as_torch(args, kwargs)
    got = tops._cuda_sep_block(*targs, **tkwargs)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want),
        **kc.tol_from_acc(jnp.int32, args[0].shape[-1], slack=2.0))


@pytest.mark.parametrize("taps", ["hwio", "squeezed"])
@pytest.mark.parametrize("oracle", ["depthwise_conv_ref", "sep_block_ref"])
def test_plain_oracles_match_reference_oracles(oracle, taps):
    """``ref.depthwise_conv_ref`` and ``ref.sep_block_ref`` take the HWIO
    (KH, KW, 1, C) weights and the squeezed (KH, KW, C) tap stack alike."""
    def squeeze(w):
        return w[:, :, 0, :] if taps == "squeezed" else w

    if oracle == "depthwise_conv_ref":
        x, w, b, s, sh = kc.dw_case(4, 9, 7, 6)
        args = (x, squeeze(w), b)
        kwargs = dict(stride=2, padding="SAME", act="relu6", scale=s,
                      shift=sh)
    else:
        x, wd, wp, ds, dt, ps, pt = kc.sep_case(4, 9, 7, 6, 10)
        args = (x, squeeze(wd), wp)
        kwargs = dict(stride=1, padding="VALID", dw_scale=ds, dw_shift=dt,
                      dw_act="relu", pw_scale=ps, pw_shift=pt, pw_act="relu6")
    want = getattr(jref, oracle)(*args, **kwargs)
    got = getattr(tref, oracle)(*as_torch(args, kwargs)[0],
                                **as_torch(args, kwargs)[1])
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# guard paths of test_depthwise.py: both packages decide from shapes and
# arguments alone, and the decomposed sep block keeps its stage kernels
def _guard_grouped_not_depthwise():
    ks = jax.random.split(jax.random.PRNGKey(0), 2)
    x = jax.random.normal(ks[0], (1, 10, 10, 8), jnp.float32)
    w = jax.random.normal(ks[1], (3, 3, 2, 8), jnp.float32)
    return (jops._pallas_depthwise_conv(x, w, None, act="relu"),
            tops._cuda_depthwise_conv(t(x), t(w), None, act="relu"))


def _guard_exotic_padding():
    x, w, _, _, _ = kc.dw_case(3, 9, 9, 6)
    pad = ((2, 1), (0, 3))
    return (jops._pallas_depthwise_conv(x, w, None, padding=pad),
            tops._cuda_depthwise_conv(t(x), t(w), None, padding=pad))


def _guard_squeezed_taps():
    x, w, b, s, sh = kc.dw_case(2, 9, 9, 5)
    kw = dict(act="relu")
    want = jops._pallas_depthwise_conv(x, w, b, scale=s, shift=sh, **kw)
    got4 = tops._cuda_depthwise_conv(t(x), t(w), t(b), scale=t(s),
                                     shift=t(sh), **kw)
    got3 = tops._cuda_depthwise_conv(t(x), t(w[:, :, 0, :]), t(b),
                                     scale=t(s), shift=t(sh), **kw)
    np.testing.assert_array_equal(got3.numpy(), got4.numpy())
    return want, got3


def _guard_degenerate_valid():
    x, w = jnp.ones((1, 2, 2, 4)), jnp.ones((3, 3, 1, 4))
    want = jops._pallas_depthwise_conv(x, w, None, padding="VALID")
    got = tops._cuda_depthwise_conv(t(x), t(w), None, padding="VALID")
    assert tuple(got.shape) == (1, 0, 0, 4)
    return want, got


def _guard_sep_exotic_padding():
    x, wd, wp, ds, dt, ps, pt = kc.sep_case(5, 9, 9, 6, 10)
    kwargs = dict(padding=((1, 1), (1, 1)), dw_scale=ds, dw_shift=dt,
                  dw_act="relu", pw_scale=ps, pw_shift=pt, pw_act="none")
    targs, tkwargs = as_torch((x, wd, wp), kwargs)
    return (jops._pallas_sep_block(x, wd, wp, **kwargs),
            tops._cuda_sep_block(*targs, **tkwargs))


@pytest.mark.parametrize("guard", [
    _guard_grouped_not_depthwise, _guard_exotic_padding, _guard_squeezed_taps,
    _guard_degenerate_valid, _guard_sep_exotic_padding,
], ids=lambda f: f.__name__.lstrip("_"))
def test_guarded_sites_match_reference(guard):
    want, got = guard()
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("pw_k", [3, 1])
def test_declined_sep_block_keeps_its_stage_kernels(pw_k, monkeypatch):
    """A sep site the fused kernel declines decomposes into the stage
    wrappers: a 3x3 'pointwise' runs the depthwise kernel and the conv
    kernel; the eligible 1x1 runs the fused kernel alone."""
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.standard_normal((1, 9, 9, 6), np.float32))
    wd = torch.from_numpy(r.standard_normal((3, 3, 1, 6), np.float32) / 3)
    wp = torch.from_numpy(
        r.standard_normal((pw_k, pw_k, 6, 10), np.float32) / 7)
    calls = []
    for mod, name in ((tdw, "depthwise_conv_int8"), (tdw, "sep_block_int8"),
                      (tfc, "fused_conv_int8")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    tops._cuda_sep_block(x, wd, wp, dw_act="relu", pw_act="none")
    want = (["depthwise_conv_int8", "fused_conv_int8"] if pw_k == 3
            else ["sep_block_int8"])
    assert calls == want


# ---------------------------------------------------------------------------
# whole models at the same level as the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    """JAX params, inputs and logits, one forward per (model, level) — the
    reference's interpret-mode forwards dominate the file's time."""
    params_cache, logits_cache = {}, {}

    def get(name, level):
        if name not in params_cache:
            init, _, in_shape = jcnn.get_cnn(name)
            params = jax.tree_util.tree_map(np.asarray,
                                            init(jax.random.PRNGKey(0)))
            x = np.random.default_rng(1).standard_normal(
                (2, *in_shape)).astype(np.float32)
            params_cache[name] = (params, x)
        params, x = params_cache[name]
        if (name, level) not in logits_cache:
            apply = jcnn.get_cnn(name)[1]
            # v0 runs jitted (the same logits, several times faster); the
            # kernel levels run eagerly, as the reference's own tests run
            # them: under jit XLA rounds the int8 path's f32 scales
            # differently, which flips a few int8 codes
            fn = jax.jit(apply) if level == "v0" else apply
            with jdispatch.use_table(jresolve(level, "pallas",
                                              model_class="cnn")):
                logits_cache[name, level] = np.asarray(
                    fn(params, jnp.asarray(x)))
        return params, x, logits_cache[name, level]

    return get


@pytest.mark.parametrize("name,level", [
    ("mobilenetv1", "v0"), ("mobilenetv1", "v4"),
    ("mobilenetv2", "v0"), ("mobilenetv2", "v2"), ("mobilenetv2", "v4"),
    ("densenet121", "v0"), ("densenet121", "v4"),
])
def test_logits_match_reference_at_same_level(reference, name, level):
    params, x, want = reference(name, level)
    _, apply, _ = tcnn.get_cnn(name)
    p = tcnn.params_from_jax(name, params)
    with torch.inference_mode(), tdispatch.use_table(
            tresolve(level, "cuda", model_class="cnn")):
        got = apply(p, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel_l2(got, want) <= LEVEL_TOL[level], (name, level)


@pytest.mark.parametrize("name", ["mobilenetv1", "mobilenetv2"])
def test_v2_dispatch_runs_stage_kernels_with_no_grouped_fallback(
        name, monkeypatch):
    """At v2 (dw_mac, no sep_block yet) every separable block decomposes:
    each depthwise stage runs the depthwise kernel and each pointwise 1x1
    the conv kernel, as in the reference; no plain reference is taken."""
    init, apply, in_shape = tcnn.get_cnn(name)
    p = init(torch.Generator().manual_seed(0))
    x = torch.zeros((1, *in_shape))
    sites = tprofiler.profile_fn(lambda x: apply(p, x), x).site_counts
    calls = {"depthwise_conv_int8": 0, "fused_conv_int8": 0,
             "sep_block_int8": 0}
    fallbacks = []
    for mod, kname in ((tdw, "depthwise_conv_int8"), (tdw, "sep_block_int8"),
                       (tfc, "fused_conv_int8")):
        real = getattr(mod, kname)
        monkeypatch.setattr(mod, kname, lambda *a, _r=real, _n=kname, **k:
                            calls.__setitem__(_n, calls[_n] + 1) or _r(*a, **k))
    for rname in ("fused_conv_ref", "conv_nhwc"):
        real = getattr(tref, rname)
        monkeypatch.setattr(tref, rname, lambda *a, _r=real, _n=rname, **k:
                            fallbacks.append(_n) or _r(*a, **k))
    with torch.inference_mode(), tdispatch.use_table(
            tresolve("v2", "cuda", model_class="cnn")):
        apply(p, x)
    assert not fallbacks, fallbacks
    assert calls == {"depthwise_conv_int8": sites["sep_block"],
                     "fused_conv_int8": sites["fused_conv"],
                     "sep_block_int8": 0}
    assert sites["depthwise_conv"] == sites["sep_block"] == {
        "mobilenetv1": 13, "mobilenetv2": 17}[name]
