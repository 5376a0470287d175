"""The port's CNNs against the reference, on the CPU.

LeNet-5* (native 28x28x1) and ResNet50 at full width and its native
64x64x3 input, batch 2, with the reference's own weights carried across
through numpy: the port's logits match the reference's at v0 (relative L2
<= 1e-4: f32 sums in another order) and at v4 on the kernels (``cuda``
backend, whose wrappers run their plain versions on CPU tensors, against
the reference's ``pallas`` backend in interpret mode; relative L2 <= 1e-3).
For all six CNNs the profiler's site counts, its instruction counts and
conv strides, the class and the recommended extensions equal the
reference's, its FLOP and byte totals agree within 0.5% and 2%, and the
report's rv32 ladder within 0.1% (its v0 -> v4 speedup within 0.01 of the
reference's); and at v4 every conv, GEMM, pool,
depthwise and separable-block site reaches its kernel wrapper with no
plain fallback.  The mobile nets' and DenseNet121's logits are held in
``test_torch_mobile.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import classes as jclasses  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro.core import pipeline as jpipeline  # noqa: E402
from repro.core import dispatch as jdispatch  # noqa: E402
from repro.core import profiler as jprofiler  # noqa: E402
from repro.core.extensions import resolve_table as jresolve  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.core import classes as tclasses  # noqa: E402
from repro_torch.core import costmodel as tcost  # noqa: E402
from repro_torch.core import pipeline as tpipeline  # noqa: E402
from repro_torch.core import dispatch as tdispatch  # noqa: E402
from repro_torch.core import profiler as tprofiler  # noqa: E402
from repro_torch.core.extensions import resolve_table as tresolve  # noqa: E402
from repro_torch.kernels import depthwise_conv as tdw  # noqa: E402
from repro_torch.kernels import fused_conv as tfc  # noqa: E402
from repro_torch.kernels import matmul_epilogue as tme  # noqa: E402
from repro_torch.kernels import pooling as tpk  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

V0_TOL, V4_TOL = 1e-4, 1e-3
# the profile's totals against the reference's, and the rv32 ladder
FLOPS_REL, HBM_REL, RV32_REL = 5e-3, 2e-2, 1e-3
# the reference's rv32 v0 -> v4 speedup per CNN (its report at batch 1)
RV32_SPEEDUP = {"lenet5": 2.081, "mobilenetv1": 2.077, "resnet50": 2.082,
                "vgg16": 2.083, "mobilenetv2": 2.067, "densenet121": 2.079}
SIX = ["lenet5", "vgg16", "resnet50", "mobilenetv1", "mobilenetv2",
       "densenet121"]
# kernel launches per v4 forward: (fused_conv, matmul_epilogue, pool,
# sep_block), as the reference dispatches them
V4_CALLS = {"resnet50": (20, 34, 2, 0), "mobilenetv1": (1, 1, 1, 13),
            "mobilenetv2": (1, 18, 1, 17), "densenet121": (59, 62, 5, 0),
            "vgg16": (13, 2, 5, 0), "lenet5": (2, 1, 0, 0)}


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def reference():
    """JAX params, inputs and logits at v0 and v4 (pallas, interpret mode),
    computed once per model — the ResNet50 v4 forward dominates the file's
    time."""
    cache = {}

    def get(name):
        if name not in cache:
            init, apply, in_shape = jcnn.get_cnn(name)
            params = jax.tree_util.tree_map(np.asarray,
                                            init(jax.random.PRNGKey(0)))
            x = np.random.default_rng(1).standard_normal(
                (2, *in_shape)).astype(np.float32)
            # jitted: the same v0 logits as eager, several times faster
            v0 = np.asarray(jax.jit(apply)(params, jnp.asarray(x)))
            with jdispatch.use_table(jresolve("v4", "pallas",
                                              model_class="cnn")):
                v4 = np.asarray(apply(params, jnp.asarray(x)))
            cache[name] = (params, x, {"v0": v0, "v4": v4})
        return cache[name]

    return get


@pytest.mark.parametrize("level", ["v0", "v4"])
@pytest.mark.parametrize("name", ["lenet5", "resnet50"])
def test_logits_match_reference_at_same_level(reference, name, level):
    params, x, want = reference(name)
    _, apply, _ = tcnn.get_cnn(name)
    p = tcnn.params_from_jax(name, params)
    table = tresolve(level, "cuda", model_class="cnn")
    with torch.inference_mode(), tdispatch.use_table(table):
        got = apply(p, torch.from_numpy(x)).numpy()
    assert got.shape == want[level].shape and np.isfinite(got).all()
    tol = V0_TOL if level == "v0" else V4_TOL
    assert rel_l2(got, want[level]) <= tol, (name, level)


@pytest.mark.parametrize("name", SIX)
def test_profile_matches_reference(name):
    init, apply, in_shape = jcnn.get_cnn(name)
    params = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))
    want = jprofiler.profile_fn(lambda x: apply(params, x),
                                jnp.zeros((1, *in_shape)))
    p = tcnn.params_from_jax(name, params)
    _, tapply, _ = tcnn.get_cnn(name)
    got = tprofiler.profile_fn(lambda x: tapply(p, x),
                               torch.zeros((1, *in_shape)))
    assert dict(got.site_counts) == dict(want.site_counts)
    assert dict(got.site_bytes) == dict(want.site_bytes)
    for op in ("conv", "dot", "mul(mac)", "mul_add(mac)", "fusedmac"):
        assert got.counts[op] == want.counts[op], op
    assert dict(got.conv_strides) == dict(want.conv_strides)
    assert tclasses.recommend(got) == jclasses.recommend(want)
    # the cost model's inputs: every exact term equal, the totals within
    # FLOPS_REL / HBM_REL (the reference counts a 4-byte literal operand
    # the port's scalar arguments do not have)
    gi, wi = got.as_costmodel_inputs(), want.as_costmodel_inputs()
    assert set(gi) == set(wi)
    for key in wi:
        if key == "flops":
            assert gi[key] == pytest.approx(wi[key], rel=FLOPS_REL)
        elif key == "hbm_bytes":
            assert gi[key] == pytest.approx(wi[key], rel=HBM_REL)
        else:
            assert gi[key] == wi[key], key
    for level in tcost.LEVELS:
        ga, wa = tcost.apply_level(gi, level), jcost.apply_level(wi, level)
        assert ga["int8_fraction"] == pytest.approx(wa["int8_fraction"],
                                                    abs=1e-3)
        assert tcost.rv32_cycles(gi, level) == pytest.approx(
            jcost.rv32_cycles(wi, level), rel=RV32_REL)
    cls, exts = tclasses.recommend(got)
    report = tpipeline.build_report(got, cls, exts, {})
    ref = jpipeline.build_report(want, *jclasses.recommend(want), {})
    for level in tcost.LEVELS:
        assert report.rv32_cycles[level] == pytest.approx(
            ref.rv32_cycles[level], rel=RV32_REL)
        assert report.rv32_energy_j[level] == pytest.approx(
            ref.rv32_energy_j[level], rel=RV32_REL)
    assert report.rv32_speedup_v4 == pytest.approx(ref.rv32_speedup_v4,
                                                   abs=0.01)
    assert report.rv32_speedup_v4 == pytest.approx(RV32_SPEEDUP[name],
                                                   abs=0.01)
    assert 1.7 <= report.rv32_speedup_v4 <= 2.4  # the paper's band


@pytest.mark.parametrize("name", SIX)
def test_v4_dispatch_zero_baseline_conv_and_pool_sites(name, monkeypatch):
    """At v4 on the cuda backend every conv, GEMM, pool and separable-block
    site reaches its kernel wrapper; the plain references inside the
    dispatch wrappers are never taken.  The baseline profile records each
    separable block's two stage sites too, which at v4 run fused."""
    init, apply, in_shape = tcnn.get_cnn(name)
    p = init(torch.Generator().manual_seed(0))
    x = torch.zeros((1, *in_shape))
    sites = tprofiler.profile_fn(lambda x: apply(p, x), x).site_counts

    calls = {"conv": 0, "gemm": 0, "pool": 0, "dw": 0, "sep": 0}
    fallbacks = []

    def counting(bucket, real):
        def wrapped(*a, **k):
            calls[bucket] += 1
            return real(*a, **k)
        return wrapped

    monkeypatch.setattr(tfc, "fused_conv_int8",
                        counting("conv", tfc.fused_conv_int8))
    monkeypatch.setattr(tme, "matmul_epilogue",
                        counting("gemm", tme.matmul_epilogue))
    for kname in ("windowed_pool", "global_avgpool"):
        monkeypatch.setattr(tpk, kname, counting("pool", getattr(tpk, kname)))
    monkeypatch.setattr(tdw, "depthwise_conv_int8",
                        counting("dw", tdw.depthwise_conv_int8))
    monkeypatch.setattr(tdw, "sep_block_int8",
                        counting("sep", tdw.sep_block_int8))
    for rname in ("fused_conv_ref", "pool_ref", "matmul_epilogue_ref",
                  "conv_nhwc"):
        real = getattr(tref, rname)
        monkeypatch.setattr(
            tref, rname,
            lambda *a, _r=real, _n=rname, **k: fallbacks.append(_n) or _r(*a, **k))

    with torch.inference_mode(), tdispatch.use_table(
            tresolve("v4", "cuda", model_class="cnn")):
        apply(p, x)

    assert not fallbacks, fallbacks
    assert calls["conv"] == sites["fused_conv"] - sites["sep_block"]
    assert calls["gemm"] == sites["matmul_epilogue"]
    assert calls["pool"] == sites["pool"]
    assert calls["sep"] == sites["sep_block"]
    assert calls["dw"] == sites["depthwise_conv"] - sites["sep_block"] == 0
    assert (calls["conv"], calls["gemm"], calls["pool"],
            calls["sep"]) == V4_CALLS[name]
    if name == "resnet50":
        assert sites["acc_mac"] == 16


@pytest.mark.parametrize("name", SIX)
def test_port_init_matches_reference_shapes_and_scale(name):
    """``init(gen)`` draws the reference's tree and shapes (params_from_jax
    raises on any mismatch) and its distributions: every weight with the
    same standard deviation within sampling error, zeros and ones alike."""
    jinit, _, _ = jcnn.get_cnn(name)
    want = jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(0)))
    tcnn.params_from_jax(name, want)
    got = jax.tree_util.tree_map(
        lambda a: a.numpy(), tcnn.get_cnn(name)[0](torch.Generator().manual_seed(0)),
        is_leaf=lambda a: isinstance(a, torch.Tensor))
    pairs = list(zip(jax.tree_util.tree_leaves(want),
                     jax.tree_util.tree_leaves(got)))
    assert len(pairs) == len(jax.tree_util.tree_leaves(want))
    for a, b in pairs:
        assert a.shape == b.shape
        assert abs(a.std() - b.std()) <= 0.1 * a.std()
        if a.size < 100:  # biases and BN affines are constants
            np.testing.assert_array_equal(a, b)


def test_params_from_jax_rejects_wrong_shapes():
    jinit, _, _ = jcnn.get_cnn("lenet5")
    tree = jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(0)))
    tree["fc"]["w"] = tree["fc"]["w"][:, :5]
    with pytest.raises(ValueError, match="shape"):
        tcnn.params_from_jax("lenet5", tree)
