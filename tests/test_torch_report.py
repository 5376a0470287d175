"""The port's report, int8 PTQ and chess_rewrite pass against the
reference, on the CPU.

* the cost model: the reference's unit cases (cumulative levels, the rv32
  issue-slot model landing near the paper's ~2x) held number for number
  against the port, ``apply_level`` equal at every level, and no constant
  of the reference's accelerator in the port's model;
* PTQ: ``quantize_tree`` / ``fake_quantize_tree`` give the reference's
  stats, leaf shapes and dtypes and model size on the six CNNs' parameter
  trees (the reference's from their shapes, through ``jax.eval_shape``),
  and on LeNet-5*'s and MobileNetV1's
  parameters (the reference's own, carried across; MobileNetV1's
  depthwise weights quantize over a unit axis) its int8 codes and scales
  and fake-quantized weights bit for bit;
* the rewrite: the reference's synthetic case, and LeNet-5* and VGG16 at
  v0, give the reference's fusion stats; each bucket's rewritten graph
  computes exactly what the program computes (LeNet-5*, ResNet50,
  MobileNetV2 at v0 and at v4 on the ``cuda`` backend, whose wrappers run
  their plain versions here); a failed rewrite warns and clears
  ``rewrite_ok``, a bucket whose rewrite fails counts a
  ``rewrite_fallbacks``;
* ``compile(quantize=True, backend="ref")`` against the reference's on
  LeNet-5* and MobileNetV1: the same quant stats and logits within 1e-4
  relative L2 (f32 sums in another order); ``run_marvel_flow`` and
  ``cost()``.

Each model's parameters are drawn once per module: the reference's
(jitted init) where a test compares against the reference's numbers, the
port's own init where it compares the port with itself.
"""
import inspect
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import marvel as jmarvel  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro.core import rewrite as jrewrite  # noqa: E402
from repro.core.pipeline import run_marvel_flow as jflow  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.quant import ptq as jptq  # noqa: E402
from repro_torch import marvel as tmarvel  # noqa: E402
from repro_torch.core import costmodel as tcost  # noqa: E402
from repro_torch.core import rewrite as trewrite  # noqa: E402
from repro_torch.core.pipeline import run_marvel_flow as tflow  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.quant import ptq as tptq  # noqa: E402

SIX = ["lenet5", "vgg16", "resnet50", "mobilenetv1", "mobilenetv2",
       "densenet121"]
LOGITS_REL = 1e-4


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def cnn():
    """name -> (reference params as numpy, port params, port apply, input
    shape), drawn once (the init jitted: both packages get the same
    numbers whatever they are)."""
    cache = {}

    def get(name):
        if name not in cache:
            init, _, in_shape = jcnn.get_cnn(name)
            jp = jax.tree_util.tree_map(np.asarray,
                                        jax.jit(init)(jax.random.PRNGKey(0)))
            _, tapply, _ = tcnn.get_cnn(name)
            cache[name] = (jp, tcnn.params_from_jax(name, jp), tapply,
                           in_shape)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def own():
    """name -> (port params from the port's init, port apply, input
    shape), drawn once."""
    cache = {}

    def get(name):
        if name not in cache:
            init, tapply, in_shape = tcnn.get_cnn(name)
            cache[name] = (init(torch.Generator().manual_seed(0)), tapply,
                           in_shape)
        return cache[name]

    return get


def tleaves(tree):
    """A port tree's leaves in the order jax.tree_util flattens the same
    tree (dict keys sorted, None no leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tleaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tleaves(v)]
    return [] if tree is None else [tree]


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

RV32_CASE = {"flops": 2e9, "matmul_flops": 2e9, "hbm_bytes": 1e8,
             "weight_bytes": 1e6, "residual_norm_bytes": 0.0,
             "epilogue_bytes": 0.0, "attn_score_bytes": 0.0,
             "loop_iters": 10}


def test_rv32_cost_model_reproduces_paper_speedup_as_the_reference():
    assert tcost.LEVELS == jcost.LEVELS
    cycles = [tcost.rv32_cycles(RV32_CASE, lvl) for lvl in tcost.LEVELS]
    assert cycles == [jcost.rv32_cycles(RV32_CASE, lvl)
                      for lvl in jcost.LEVELS]
    assert 1.8 <= cycles[0] / cycles[-1] <= 2.4
    assert all(a >= b for a, b in zip(cycles, cycles[1:]))
    for lvl in tcost.LEVELS:
        assert tcost.rv32_energy_j(1e6, lvl) == jcost.rv32_energy_j(1e6, lvl)
        assert tcost.apply_level(RV32_CASE, lvl) == jcost.apply_level(
            RV32_CASE, lvl)


def test_costmodel_carries_no_constant_of_the_reference_accelerator():
    """The roofline constants are the H100's, labelled with the card's
    name and power limit; none of the reference's accelerator's numbers."""
    src = inspect.getsource(tcost)
    for text in ("197e12", "394e12", "819e9", "0.94e9", "170.0"):
        assert text not in src, text
    for value in (197e12, 394e12, 819e9, 0.94e9, 170.0, 50e9, 2000):
        assert value not in [v for k, v in vars(tcost).items()
                             if k.isupper() and isinstance(v, float)], value
    assert "H100 80GB HBM3" in src and "700.00 W" in src
    assert tcost.PEAK_FLOPS_INT8 == pytest.approx(2 * tcost.PEAK_FLOPS_BF16,
                                                  rel=1e-3)


# ---------------------------------------------------------------------------
# PTQ
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SIX)
def test_quant_stats_match_the_reference(own, name):
    """Stats, leaf shapes and dtypes in flatten order, and model size: the
    reference's from its parameter tree's shapes alone."""
    jinit, _, _ = jcnn.get_cnn(name)
    shapes = jax.eval_shape(jinit, jax.random.PRNGKey(0))
    tp = own(name)[0]
    for fn in ("quantize_tree", "fake_quantize_tree"):
        stats = {}
        want = jax.eval_shape(
            lambda p: stats.setdefault("s", getattr(jptq, fn)(p))[0], shapes)
        got, tstats = getattr(tptq, fn)(tp)
        assert tstats == stats["s"][1], fn
        assert [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for t in tleaves(got)] == [
            (tuple(w.shape), str(w.dtype))
            for w in jax.tree_util.tree_leaves(want)], fn
    qbytes = {}
    jax.eval_shape(lambda p: qbytes.setdefault("b", jptq.quantized_bytes(p))
                   and p, shapes)
    assert tptq.quantized_bytes(tp) == qbytes["b"]


@pytest.mark.parametrize("name", ["lenet5", "mobilenetv1"])
def test_quantize_trees_match_the_reference(cnn, name):
    jp, tp, _, _ = cnn(name)
    jq, jstats = jptq.quantize_tree(jp)
    tq, tstats = tptq.quantize_tree(tp)
    assert tstats == jstats
    for got, want in zip(tleaves(tq), jax.tree_util.tree_leaves(jq),
                         strict=True):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jf, jfstats = jptq.fake_quantize_tree(jp)
    tf, tfstats = tptq.fake_quantize_tree(tp)
    assert tfstats == jfstats == jstats
    for got, want in zip(tleaves(tf), jax.tree_util.tree_leaves(jf),
                         strict=True):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tptq.quantized_bytes(tp) == jptq.quantized_bytes(jp)


def test_quantize_tree_predicate_sees_the_references_names(cnn):
    jp, tp, _, _ = cnn("lenet5")
    seen_j, seen_t = [], []
    jptq.quantize_tree(jp, lambda n, leaf: seen_j.append(n) or "fc" not in n)
    _, stats = tptq.quantize_tree(tp, lambda n, leaf: seen_t.append(n)
                                  or "fc" not in n)
    assert seen_t == seen_j and stats == {"quantized": 2, "total": 6}


# ---------------------------------------------------------------------------
# the rewrite
# ---------------------------------------------------------------------------


def test_rewrite_synthetic_case_matches_the_reference():
    def jf(x, w, b):
        y = jnp.maximum(x @ w + b, 0.0)
        return y * 2.0 + y

    def tf(x, w, b):
        y = torch.clamp_min(x @ w + b, 0.0)
        return y * 2.0 + y

    rng = np.random.default_rng(0)
    x, w = (rng.standard_normal(s).astype(np.float32)
            for s in ((8, 16), (16, 4)))
    b = np.ones(4, np.float32)
    _, jstats = jrewrite.rewrite(jf, x, w, b)
    targs = [torch.from_numpy(a) for a in (x, w, b)]
    rw, tstats = trewrite.rewrite(tf, *targs)
    assert tstats == jstats == {"mac": 1, "fusedmac": 1}
    assert torch.equal(rw(*targs), tf(*targs))
    assert trewrite.count_custom_instructions(rw) == {
        "marvel_mac": 1, "marvel_fusedmac": 1, "marvel_fusedconv": 0}


@pytest.mark.parametrize("name", ["lenet5", "vgg16"])
def test_rewrite_stats_at_v0_match_the_reference(cnn, name):
    jp, tp, tapply, in_shape = cnn(name)
    _, japply, _ = jcnn.get_cnn(name)
    x = np.zeros((1, *in_shape), np.float32)
    _, want = jrewrite.rewrite(lambda x: japply(jp, x), x)
    prog = tmarvel.compile(tapply, x, params=tp, level="v0", device="cpu",
                           precompile=False)
    assert prog.report.rewrite_ok and prog.rewrite_baked
    assert prog.report.rewrite_stats == want
    assert want == {"lenet5": {"mac": 1, "fusedmac": 2},
                    "vgg16": {"mac": 1, "fusedmac": 14}}[name]


@pytest.mark.parametrize("level", ["v0", "v4"])
@pytest.mark.parametrize("name", ["lenet5", "resnet50", "mobilenetv2"])
def test_rewritten_program_equals_the_unrewritten_function(own, name, level):
    tp, tapply, in_shape = own(name)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, *in_shape)).astype(np.float32))
    prog = tmarvel.compile(tapply, x, params=tp, level=level, backend="cuda",
                           device="cpu")
    graph = prog.baked_graph(x)
    with torch.inference_mode():
        got = graph(x)
    want = prog(x)  # the bucket's executable: the bound function
    assert prog.rewrite_baked and prog.rewrite_fallbacks == 0
    assert got.shape == want.shape and torch.equal(got, want)
    custom = trewrite.count_custom_instructions(graph)
    stats = prog.report.rewrite_stats
    assert custom["marvel_mac"] + custom["marvel_fusedmac"] + custom[
        "marvel_fusedconv"] == stats["mac"] + stats["fusedmac"] > 0
    kernels = {str(n.target).split(".")[1] for n in graph.graph.nodes
               if str(n.target).startswith("marvel.")} - {"mac", "fusedmac",
                                                          "fusedconv"}
    assert bool(kernels) == (level == "v4"), kernels


def test_failed_rewrite_warns_and_clears_rewrite_ok(own, monkeypatch):
    tp, tapply, in_shape = own("lenet5")
    x = torch.zeros((2, *in_shape))

    def broken(fn, *args):
        raise RuntimeError("planted")

    real = trewrite.rewrite
    monkeypatch.setattr(trewrite, "rewrite", broken)
    with pytest.warns(RuntimeWarning, match="chess_rewrite failed"):
        prog = tmarvel.compile(tapply, x, params=tp, level="v4",
                               backend="cuda", device="cpu")
    assert not prog.report.rewrite_ok and not prog.rewrite_baked
    assert prog.report.rewrite_stats == {"error": "planted"}
    assert "FAILED: planted" in prog.summary()
    assert prog(x).shape == (2, 10) and prog.baked_graph(x) is None
    # a program whose pass succeeded, with a bucket whose trace fails
    monkeypatch.setattr(trewrite, "rewrite", real)
    prog = tmarvel.compile(tapply, x, params=tp, level="v4", backend="cuda",
                           device="cpu")
    monkeypatch.setattr(trewrite, "rewrite", broken)
    x3 = torch.zeros((3, *in_shape))
    with pytest.warns(RuntimeWarning, match="chess_rewrite failed"):
        assert prog.baked_graph(x3) is None
    assert prog(x3).shape == (3, 10) and prog.rewrite_fallbacks == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        # the example bucket's graph was traced at compile
        assert prog.baked_graph(x) is not None and prog(x).shape == (2, 10)


# ---------------------------------------------------------------------------
# compile(quantize=True) and the report-only front
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["lenet5", "mobilenetv1"])
def test_quantized_compile_matches_the_reference(cnn, name):
    jp, tp, tapply, in_shape = cnn(name)
    _, japply, _ = jcnn.get_cnn(name)
    x = np.random.default_rng(2).standard_normal(
        (2, *in_shape)).astype(np.float32)
    jprog = jmarvel.compile(japply, x, params=jp, level="v4", backend="ref",
                            quantize=True, tuned="off")
    tprog = tmarvel.compile(tapply, x, params=tp, level="v4", backend="ref",
                            quantize=True, device="cpu")
    assert tprog.quantized and tprog.quant_stats == jprog.quant_stats
    assert tprog.quant_stats["quantized"] > 0
    got, want = tprog(x).numpy(), np.asarray(jprog(x))
    assert got.shape == want.shape
    assert rel_l2(got, want) <= LOGITS_REL
    assert rel_l2(got, tmarvel.compile(tapply, x, params=tp, level="v4",
                                       backend="ref", device="cpu",
                                       do_rewrite=False)(x).numpy()) > 0


def test_quantize_without_params_raises():
    with pytest.raises(ValueError, match="quantize=True needs"):
        tmarvel.compile(lambda x: x * 2.0, torch.zeros(2), quantize=True,
                        device="cpu")


def test_run_marvel_flow_and_cost_match_the_reference(cnn):
    jp, tp, tapply, in_shape = cnn("lenet5")
    _, japply, _ = jcnn.get_cnn("lenet5")
    x = np.zeros((1, *in_shape), np.float32)
    want = jflow(lambda x: japply(jp, x), x)
    got = tflow(lambda x: tapply(tp, x), torch.from_numpy(x), device="cpu")
    assert got.model_class == want.model_class == "cnn"
    assert got.recommended_extensions == want.recommended_extensions
    assert got.rewrite_stats == want.rewrite_stats
    for lvl in tcost.LEVELS:
        assert got.rv32_cycles[lvl] == pytest.approx(want.rv32_cycles[lvl],
                                                     rel=1e-3)
    assert got.rv32_speedup_v4 == pytest.approx(want.rv32_speedup_v4,
                                                abs=0.01)
    prog = tmarvel.compile(tapply, x, params=tp, level="v2", device="cpu",
                           precompile=False)
    cost = prog.cost()
    assert set(cost) == {"rv32_cycles", "rv32_energy_j", "gpu_cycles",
                         "gpu_energy_j", "hbm_bytes"}
    assert cost["rv32_cycles"] == prog.report.rv32_cycles["v2"]
    assert prog.cost("v4")["gpu_cycles"] == prog.report.gpu_cycles["v4"]
    with pytest.raises(ValueError, match="unknown processor version"):
        prog.cost("v9")
    assert prog.report.summary() in prog.summary()
