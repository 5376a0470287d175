"""The port's CNN kernels and the rnn_lm kernels (``mac_matmul_int8``,
``wkv_chunk``) against the reference, on the CPU.

Each kernel's plain PyTorch version (what its wrapper runs on CPU tensors)
is held against the reference's Pallas kernel, run in interpret mode as the
reference's own tests run it, on that kernel's cases of the shared
conformance grid (``kernel_cases.GRID``).  Then each ``cuda`` dispatch
wrapper is held against the reference's ``pallas`` wrapper on the same
inputs, with the int8 codes of the on-the-fly quantization equal.

Tolerances: fused_conv rtol = atol = 1e-5 (the int32 sums are exact, only
the f32 epilogue rounds); matmul_epilogue ``tol_from_acc(dtype, K)`` (f32
sums in another order); max pools equal; avg pools rtol 1e-6; the global
average rtol 1e-6 with atol 1e-6, because a mean of signed values can sit
near 0, where the order of an f32 sum over H*W moves the result by a few
1e-8 absolute; mac_matmul_int8 equal (exact int32 sums, the same f32
scale products); wkv_chunk the reference conformance runner's
``tol_from_acc(float32, S, slack=8)``.

The GEMM kernel's form predicate and split-K plan are checked on every GEMM
site of the six CNNs and four LMs at full width (recorded over fake
tensors): the CNNs' f32 GEMMs on CUDA cores, every plan covering K, the
CUDA-core form's tile and its split-K counters; and the depthwise kernel's
block geometry at every depthwise site of the mobile nets.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import kernel_cases as kc  # noqa: E402
from repro.kernels import fused_conv as jfc  # noqa: E402
from repro.kernels import mac_matmul as jmm  # noqa: E402
from repro.kernels import matmul_epilogue as jme  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import pooling as jpk  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import wkv_chunk as jwk  # noqa: E402
from repro.quant import ptq as jptq  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels import depthwise_conv as tdw  # noqa: E402
from repro_torch.kernels import fused_conv as tfc  # noqa: E402
from repro_torch.kernels import mac_matmul as tmm  # noqa: E402
from repro_torch.kernels import matmul_epilogue as tme  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import pooling as tpk  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import wkv_chunk as twk  # noqa: E402
from repro_torch.quant import ptq as tptq  # noqa: E402

CONV_TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    """A JAX array (or None) as a CPU tensor of the same dtype."""
    if a is None:
        return None
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def n(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def grid(impl):
    return [pytest.param(case, id=kc.case_id(impl, case))
            for name, case in kc.GRID if name == impl]


# ---------------------------------------------------------------------------
# case builders shared by the plain-version and wrapper tests
# ---------------------------------------------------------------------------


def conv_inputs(seed=0, h=13, w_sp=11, cin=5, cout=9, k=3, stride=1,
                padding="SAME", act="relu", residual=False):
    x, w, b, s, sh = kc.conv_case(seed, h, w_sp, cin, cout, k)
    res = None
    if residual:
        shape = jax.eval_shape(
            lambda a, c: jref.fused_conv_ref(a, c, None, stride=stride,
                                             padding=padding), x, w).shape
        res = jax.random.normal(jax.random.PRNGKey(seed + 1), shape)
    return x, w, b, s, sh, res, dict(stride=stride, padding=padding, act=act)


def gemm_inputs(seed=0, m=37, k=64, n=48, act="relu", dtype=jnp.float32,
                residual=False, affine=True):
    x, w, b, r = kc.matmul_case(seed, m, k, n, dtype)
    s = 0.5 + jax.random.uniform(jax.random.PRNGKey(seed + 2), (n,))
    return (x, w, b, s if affine else None, r if residual else None,
            act, kc.tol_from_acc(dtype, k))


def pool_inputs(seed=0, h=13, w_sp=11, c=5, op="max", k=2, stride=2,
                dtype=jnp.float32):
    return kc.pool_case(seed, h, w_sp, c, dtype), op, k, stride


def assert_pool(got, want, op):
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    if op == "max":
        np.testing.assert_array_equal(n(got), np.asarray(want))
    elif op == "avg":
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6)
    else:
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# plain versions vs the reference's Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", grid("fused_conv"))
def test_fused_conv_plain_matches_pallas_kernel(case):
    x, w, b, s, sh, res, kw = conv_inputs(**case)
    x8, xs = jops._quant_int8(x)
    w8, ws = jops._quant_int8(w, axes=(0, 1, 2))
    es, eb = xs * ws * s, b * s + sh
    want = jfc.fused_conv_int8(x8, w8, es, eb, res, **kw)
    got = tfc.fused_conv_int8_plain(t(x8), t(w8), t(es), t(eb), t(res), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)


@pytest.mark.parametrize("case", grid("matmul_epilogue"))
def test_matmul_epilogue_plain_matches_pallas_kernel(case):
    x, w, b, s, r, act, tol = gemm_inputs(**case)
    want = jme.matmul_epilogue(x, w, b, act=act, scale=s, residual=r)
    got = tme.matmul_epilogue_plain(t(x), t(w), t(b), act=act, scale=t(s),
                                    residual=t(r))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("case", grid("pool"))
def test_pool_plain_matches_pallas_kernel(case):
    x, op, k, stride = pool_inputs(**case)
    if op == "global_avg":
        want = jpk.global_avgpool(x)
        got = tpk.global_avgpool_plain(t(x))
    else:
        kernel = jpk.maxpool2d if op == "max" else jpk.avgpool2d
        want = kernel(x, k=k, stride=stride)
        got = tpk.windowed_pool_plain(t(x), k=k, stride=stride, op=op)
    assert_pool(got, want, op)


# ---------------------------------------------------------------------------
# the cuda dispatch wrappers vs the reference's pallas wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", grid("fused_conv"))
def test_quant_int8_codes_equal_reference(case):
    x, w, *_ = conv_inputs(**case)
    for a, axes, t_axes in ((x, None, None), (w, (0, 1, 2), (0, 1, 2))):
        want_q, want_s = jops._quant_int8(a, axes=axes)
        got_q, got_s = tops._quant_int8(t(a), axes=t_axes)
        assert got_q.dtype == torch.int8
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("case", grid("fused_conv"))
def test_fused_conv_wrapper_matches_pallas_wrapper(case):
    x, w, b, s, sh, res, kw = conv_inputs(**case)
    want = jops._pallas_fused_conv(x, w, b, groups=1, scale=s, shift=sh,
                                   residual=res, **kw)
    got = tops._cuda_fused_conv(t(x), t(w), t(b), groups=1, scale=t(s),
                                shift=t(sh), residual=t(res), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)


@pytest.mark.parametrize("case", grid("matmul_epilogue"))
def test_matmul_epilogue_wrapper_matches_pallas_wrapper(case):
    x, w, b, s, r, act, tol = gemm_inputs(**case)
    want = jops._pallas_matmul_epilogue(x, w, b, act=act, scale=s,
                                        residual=r)
    got = tops._cuda_matmul_epilogue(t(x), t(w), t(b), act=act, scale=t(s),
                                     residual=t(r))
    assert got.dtype == t(want).dtype
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("case", grid("pool"))
def test_pool_wrapper_matches_pallas_wrapper(case):
    x, op, k, stride = pool_inputs(**case)
    want = jops._pallas_pool(x, op=op, k=k, stride=stride)
    got = tops._cuda_pool(t(x), op=op, k=k, stride=stride)
    assert_pool(got, want, op)


# guard paths: sites outside a kernel's contract take the plain reference
# in both packages, decided from shapes and arguments alone
def _guard_grouped():
    x, w, b, s, sh = kc.conv_case(0, 9, 9, 4, 4, 3)
    w = w[:, :, :2, :]
    return (jops._pallas_fused_conv(x, w, b, groups=2, act="relu"),
            tops._cuda_fused_conv(t(x), t(w), t(b), groups=2, act="relu"))


def _guard_exotic_padding():
    x, w, b, s, sh = kc.conv_case(0, 9, 9, 4, 6, 3)
    pad = ((1, 0), (2, 1))
    return (jops._pallas_fused_conv(x, w, b, padding=pad, act="relu"),
            tops._cuda_fused_conv(t(x), t(w), t(b), padding=pad, act="relu"))


def _guard_unsupported_act():
    x, w, b, s, sh = kc.conv_case(0, 9, 9, 4, 6, 3)
    return (jops._pallas_fused_conv(x, w, b, act="silu"),
            tops._cuda_fused_conv(t(x), t(w), t(b), act="silu"))


def _guard_gemm_broadcast_residual():
    x, w, b, r = kc.matmul_case(0, 5, 8, 6)
    res = r[:1]
    return (jops._pallas_matmul_epilogue(x, w, b, act="relu", residual=res),
            tops._cuda_matmul_epilogue(t(x), t(w), t(b), act="relu",
                                       residual=t(res)))


def _guard_empty_gemm():
    x, w = jnp.zeros((0, 8)), jnp.ones((8, 4))
    return (jops._pallas_matmul_epilogue(x, w, None, act="relu"),
            tops._cuda_matmul_epilogue(t(x), t(w), None, act="relu"))


def _guard_pool_window():
    x = kc.pool_case(0, 12, 12, 6)
    return (jops._pallas_pool(x, op="max", k=4, stride=4),
            tops._cuda_pool(t(x), op="max", k=4, stride=4))


@pytest.mark.parametrize("guard", [
    _guard_grouped, _guard_exotic_padding, _guard_unsupported_act,
    _guard_gemm_broadcast_residual, _guard_empty_gemm, _guard_pool_window,
], ids=lambda f: f.__name__.lstrip("_"))
def test_guarded_sites_match_reference(guard):
    want, got = guard()
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("tiles,k_iters", [
    (1, 128), (8, 144), (29, 4), (4, 16), (131, 300), (132, 300), (500, 2),
    (1, 1), (2, 3),
])
def test_split_k_covers_k_with_no_empty_slice(tiles, k_iters):
    """The split-K policy of the GEMM and conv kernels: one slice once the
    tiles fill the 132 SMs; otherwise slices of >= 4 K steps (unless K is
    shorter) that cover K with none empty."""
    s = common.split_k(tiles, k_iters, 132)
    per = -(-k_iters // s)
    assert s >= 1 and s * per >= k_iters and (s - 1) * per < k_iters
    if tiles >= 132:
        assert s == 1
    elif s > 1:
        assert per >= 4 and tiles * s <= 2 * 132 + tiles


CNNS = ("lenet5", "mobilenetv1", "vgg16", "resnet50", "mobilenetv2",
        "densenet121")
LMS = ("qwen3-8b", "granite-3-2b", "starcoder2-3b", "rwkv6-1.6b")
# the GEMM rows the serving tiers batch: CNN batches of 1..8 images (times
# the spatial rows of a 1x1 conv); LM decode steps at 1..16 slots, the serve's
# prefill buckets of 32 and 64 positions and the B = 4, S = 512 prefill
LM_ROWS = (1, 8, 16, 32, 64, 2048)


@functools.lru_cache(maxsize=None)
def _gemm_sites(model):
    """(rows per image or token, K, N, dtype) of every matmul_epilogue site
    of a full-width model, recorded over fake tensors."""
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.core import profiler
    from repro_torch.models import transformer as T
    from repro_torch.models.cnn import get_cnn

    gen = torch.Generator().manual_seed(0)
    if model in CNNS:
        init, apply, in_shape = get_cnn(model)
        fn = lambda: apply(init(gen), torch.zeros((1, *in_shape)))  # noqa: E731
    else:
        cfg = get_arch(model)
        run = RunConfig(seq_len=8, global_batch=1, mode="prefill")
        fn = lambda: T.forward_lm(T.init_params(gen, cfg),  # noqa: E731
                                  torch.zeros((1, 8), dtype=torch.int32),
                                  cfg, run)
    sites = profiler.site_shapes(fn, "matmul_epilogue")
    assert sites
    out = []
    for _, (xs, xdt), (ws, wdt) in sites:
        assert xdt == wdt
        rows = int(np.prod(xs[:-1])) // (1 if model in CNNS else 8)
        out.append((rows, ws[0], ws[1], xdt))
    return out


@pytest.mark.parametrize("model", CNNS)
def test_cnn_gemms_take_the_cuda_core_form(model):
    """Every GEMM of the six CNNs is f32 and takes the CUDA-core form at
    every batch the serving tier runs: on tensor cores f32 would become
    TF32, which the reference does not compute."""
    for rows, k, n, dt in _gemm_sites(model):
        assert dt == torch.float32
        for batch in range(1, 9):
            assert tme.gemm_form(rows * batch, k, n, dt) == "fma"


def _gemm_launches(model):
    """(form, M, K, N) of every GEMM launch of a model at every row count
    the serving tiers run it at."""
    for rows, k, n, dt in _gemm_sites(model):
        for m in ([rows * b for b in range(1, 9)] if model in CNNS
                  else LM_ROWS):
            yield tme.gemm_form(m, k, n, dt), m, k, n


@pytest.mark.parametrize("model", CNNS + LMS)
def test_gemm_split_plans_cover_k(model):
    """The split-K plan of every GEMM of the ten models, in the form the
    wrapper routes it to, at every row count it runs at: whole K steps of
    the form, slices that cover K with none empty, one slice once the
    tiles fill the 132 SMs."""
    for form, m, k, n in _gemm_launches(model):
        bk = tme.TILES[form][2]
        splits, per, (bm, bn) = tme.split_plan(form, m, n, k, 132)
        assert per % bk == 0 and splits * per >= k
        assert (splits - 1) * per < k, (model, form, m, k, n)
        tiles = -(-n // bn) * (1 if bm is None else -(-m // bm))
        assert splits == 1 or tiles < 132


@pytest.mark.parametrize("model", CNNS)
def test_fma_tile_and_split_plan(model):
    """The fma form's tile and split plan at every f32 GEMM of the CNNs:
    a tile of the kernel's table, taken from the same pure function the
    wrapper calls; at most FMA_MAX_SPLITS slices, which the last block of a
    tile sums in one launch; a split only where the tiles alone do not
    fill the 132 SMs, so every split launch has a tile counter; and no
    tile taller than M rounded up to the table's shortest tile."""
    shortest = min(bm for bm, *_ in tme.FMA_TILES)
    for form, m, k, n in _gemm_launches(model):
        assert form == "fma"
        t = tme.fma_tile(m, n, k, 132)
        bm, tm, *_ = tme.FMA_TILES[t]
        assert bm % tm == 0 and (bm // tm) * 16 <= 256
        splits, per, tile = tme.split_plan(form, m, n, k, 132)
        assert tile == (bm, tme.TILES["fma"][1])
        assert 1 <= splits <= tme.FMA_MAX_SPLITS
        tiles = -(-m // bm) * -(-n // tile[1])
        if splits > 1:
            assert tiles <= tme.counter_slots(132), (m, k, n)
        assert bm <= max(shortest, -(-m // shortest) * shortest)


def test_fma_counter_buffer_covers_every_split_grid():
    """One int32 counter a tile, allocated once per device: enough for the
    largest tile grid any split launch of the ten models can have, at any
    SM count the plan may be given."""
    for sms in (16, 66, 132, 144):
        slots = tme.counter_slots(sms)
        for model in CNNS + LMS:
            for form, m, k, n in _gemm_launches(model):
                if form != "fma":
                    continue
                splits, _, (bm, bn) = tme.split_plan(form, m, n, k, sms)
                if splits > 1:
                    assert -(-m // bm) * -(-n // bn) <= slots


@functools.lru_cache(maxsize=None)
def _dw_sites(model):
    """(x shape, taps) of every depthwise site of a full-width CNN at a
    batch of 8 images, recorded over fake tensors."""
    from repro_torch.core import profiler
    from repro_torch.models.cnn import get_cnn

    init, apply, in_shape = get_cnn(model)
    gen = torch.Generator().manual_seed(0)
    sites = profiler.site_shapes(
        lambda: apply(init(gen), torch.zeros((8, *in_shape))),
        "depthwise_conv")
    assert sites
    return [(xs, ws[:2]) for _, (xs, _), (ws, _) in sites]


@pytest.mark.parametrize("model", ("mobilenetv1", "mobilenetv2"))
def test_depthwise_tile_geometry(model):
    """The depthwise kernel's blocks at every depthwise site of the mobile
    nets, at both strides: the halo and taps fit the shared memory, the
    channel group is one the kernel takes, and at a batch of 8 the blocks
    fill the 132 SMs at least once."""
    for (n, h, w_in, c), (kh, kw) in _dw_sites(model):
        for stride in (1, 2):
            ho, wo = -(-h // stride), -(-w_in // stride)
            th, cg = tdw.dw_tile(n, ho, wo, c, kh, kw, stride, 132)
            assert cg in tdw.DW_GROUPS and 1 <= th <= ho
            assert tdw.dw_smem(th, cg, wo, kh, kw, stride) <= tdw.DW_SMEM_MAX
            assert n * -(-c // cg) * -(-ho // th) >= 132, (h, c, stride)


@functools.lru_cache(maxsize=None)
def _sep_launches(model):
    """(M, C, Cout, taps, stride) of every separable-block launch of a
    full-width mobile net's batch-8 forward at v4, recorded over fake
    tensors (the ``sep_block`` site's x, depthwise and pointwise weights)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import dispatch
    from repro_torch.models.cnn import get_cnn

    init, apply, in_shape = get_cnn(model)
    seen, inner = [], dispatch.call

    def record(pattern, baseline, *args, **kwargs):
        if pattern == "sep_block":
            x, wd, wp = (tuple(a.shape) for a in args[:3])
            stride = kwargs.get("stride", 1)
            ho = -(-x[1] // stride)
            wo = -(-x[2] // stride)
            seen.append((x[0] * ho * wo, x[3], wp[-1], wd[0] * wd[1],
                         stride))
        return inner(pattern, baseline, *args, **kwargs)

    dispatch.call = record
    try:
        with FakeTensorMode(allow_non_fake_inputs=True), \
                dispatch.use_table(dispatch.EMPTY_TABLE):
            apply(init(torch.Generator().manual_seed(0)),
                  torch.zeros((8, *in_shape)))
    finally:
        dispatch.call = inner
    return seen


@pytest.mark.parametrize("model,launches", (("mobilenetv2", 17),
                                            ("mobilenetv1", 13)))
def test_sep_block_plan(model, launches):
    """The separable block's plan at every launch of the mobile nets'
    batch-8 forwards, at the SM counts a plan may be given: a tile the
    kernel is built for, its grid covering M and Cout, all of Cout in one
    tile up to 128 channels (each depthwise element computed once) unless
    the sweep's table says otherwise; the slices of C covering its
    32-channel chunks with none empty, at most SEP_MAX_SPLITS of them
    (or the sweep's number), and
    a split only where the tiles do not fill the SMs, so the tile counters
    (one buffer a device, shared with the GEMM's fma form) cover every
    split grid; the shared memory within a block's."""
    sites = _sep_launches(model)
    assert len(sites) == launches
    for sms in (16, 66, 132, 144):
        for m, c, cout, taps, _ in sites:
            bm, bn, splits, per = tdw.sep_plan(m, c, cout, sms)
            assert (bm, bn) in tdw.SEP_TILES
            tiles_m, tiles_n = -(-m // bm), -(-cout // bn)
            assert tiles_m * bm >= m and tiles_n * bn >= cout
            if cout <= 128 and (m, c, cout) not in tdw.SEP_TUNED:
                assert tiles_n == 1 and bn < 2 * max(cout, 16)
            chunks = -(-c // tdw.SEP_C)
            tuned = tdw.SEP_TUNED.get((m, c, cout), (0, 0, 1))[2]
            assert 1 <= splits <= max(tdw.SEP_MAX_SPLITS, tuned)
            assert (splits - 1) * per < chunks <= splits * per
            if splits > 1:
                assert tiles_m * tiles_n < sms
                assert tiles_m * tiles_n <= tme.counter_slots(sms)
            assert tdw.sep_smem(bm, bn, taps) <= tdw.SEP_SMEM_MAX
    # a policy that never splits keeps every launch in one slice (how
    # chip_smoke.py times a launch without its split)
    policy = tdw.split_k
    tdw.split_k = lambda tiles, k_iters, sms: 1
    try:
        assert all(tdw.sep_plan(m, c, cout, 132)[2] == 1
                   for m, c, cout, _, _ in sites)
    finally:
        tdw.split_k = policy


# the int8 conv's launches on the CNN path (batch 8, 64x64x3) as (M, K, N):
# the stem of every CNN; ResNet50's 3x3 convs and stride-2 1x1 projections;
# DenseNet121's 3x3 growth convs (Cout = 32)
CONV_PATH_SHAPES = [
    (8192, 147, 64),
    (2048, 576, 64), (512, 1152, 128), (128, 2304, 256), (32, 4608, 512),
    (512, 256, 512), (128, 512, 1024), (32, 1024, 2048),
    (2048, 1152, 32), (512, 1152, 32), (128, 1152, 32), (32, 1152, 32),
]
# chip_smoke.MAC_CASES: the grid's three, rwkv6-1.6b's at 8 and 2048 rows
MAC_SHAPES = [(130, 257, 140), (64, 96, 32), (1, 256, 128),
              (8, 2048, 2048), (8, 2048, 7168), (8, 7168, 2048),
              (2048, 2048, 7168)]


def _check_imma_plan(tile, splits, m, k, n, sms):
    """One int8 tensor-core plan: a tile the kernel is built for (one with
    a byte-load patch tile where K, and so Cin, is not a multiple of 4),
    its grid covering M and N with no empty tile, 32-wide tiles for N <=
    32, the slices of K whole 64-deep steps covering K with none empty, a
    split exactly where split_k splits the tile grid, and tile counters
    for every tile of a split grid."""
    bm, bn, wm, wn, stages = tfc.IMMA_TILES[tile]
    if k % 4:
        assert tile in tfc.BYTE_TILES
    tiles_m, tiles_n = -(-m // bm), -(-n // bn)
    assert (tiles_m - 1) * bm < m <= tiles_m * bm
    assert (tiles_n - 1) * bn < n <= tiles_n * bn
    if n <= 32:
        assert bn == 32
    k_iters = -(-k // tfc.BK)
    per = -(-k_iters // splits) * tfc.BK
    assert 1 <= splits <= k_iters
    assert (splits - 1) * per < k <= splits * per
    grid_splits = common.split_k(tiles_m * tiles_n, k_iters, sms) > 1
    assert (splits > 1) == grid_splits
    if splits > 1:
        assert tiles_m * tiles_n <= tme.counter_slots(sms)


@pytest.mark.parametrize("m,k,n", CONV_PATH_SHAPES)
def test_conv_plan(m, k, n):
    """conv_plan at every launch shape of the CNN path, at the SM counts a
    plan may be given; a policy that never splits keeps the launch in one
    slice (how chip_smoke.py times a launch without its split)."""
    for sms in (16, 66, 132, 144):
        _check_imma_plan(*tfc.conv_plan(m, n, k, sms), m, k, n, sms)
    never = lambda tiles, k_iters, sms: 1  # noqa: E731
    assert tfc._conv_plan(m, n, k, 132, never, k)[1] == 1


@pytest.mark.parametrize("m,k,n", MAC_SHAPES)
def test_mac_plan(m, k, n):
    """mac_plan at every case chip_smoke.py holds and times: the same
    checks; decode rows (M <= 16) in a 16-row tile unless the sweep's
    table says otherwise."""
    for sms in (16, 66, 132, 144):
        tile, splits = tmm.mac_plan(m, n, k, sms)
        _check_imma_plan(tile, splits, m, k, n, sms)
        if m <= 16 and k % 4 == 0 and (m, k, n) not in tmm.MAC_TUNED:
            assert tfc.IMMA_TILES[tile][0] == 16


def test_imma_tiles_match_the_kernel():
    """IMMA_TILES lists the tiles csrc/fused_conv.cu's launcher builds, in
    the order of its tile codes, BYTE_TILES those it also builds with a
    byte-load patch tile; the mac cases are chip_smoke.MAC_CASES."""
    import re
    from pathlib import Path

    import chip_smoke

    src = (Path(tfc.__file__).parents[1] / "csrc" / "fused_conv.cu").read_text()
    built = re.findall(r"case (\d+): return launch_tile<Tile<([\d, ]+)>>",
                       src)
    assert [int(i) for i, _ in built] == list(range(len(tfc.IMMA_TILES)))
    assert [tuple(int(v) for v in t.split(",")) for _, t in built] == list(
        tfc.IMMA_TILES)
    bytes_built = re.findall(
        r"case (\d+): return launch_tile<Tile<([\d, ]+)>, true>", src)
    assert [int(i) for i, _ in bytes_built] == list(tfc.BYTE_TILES)
    assert [tuple(int(v) for v in t.split(",")) for _, t in bytes_built] == [
        tfc.IMMA_TILES[i] for i in tfc.BYTE_TILES]
    assert chip_smoke.MAC_CASES == MAC_SHAPES


def test_gemm_form_predicate():
    """bf16 with K and N multiples of 8 and aligned bases: decode up to 16
    rows, wgmma above; anything else the CUDA-core form."""
    bf, f32 = torch.bfloat16, torch.float32
    assert tme.gemm_form(16, 4096, 1024, bf) == "decode"
    assert tme.gemm_form(17, 4096, 1024, bf) == "wgmma"
    assert tme.gemm_form(2048, 4096, 1024, f32) == "fma"
    assert tme.gemm_form(2048, 4100, 1024, bf) == "fma"
    assert tme.gemm_form(2048, 4096, 1020, bf) == "fma"
    assert tme.gemm_form(8, 4096, 1024, bf, aligned=False) == "fma"


def test_kernel_wrappers_refuse_tensors_off_cpu_and_cuda():
    """A wrapper runs the plain version only for CPU tensors; any other
    device goes to the kernel or raises — it never falls back."""
    x = torch.zeros((1, 4, 4, 8), device="meta")
    with pytest.raises(RuntimeError, match="CPU"):
        tpk.global_avgpool(x)
    with pytest.raises(RuntimeError, match="CPU"):
        tme.matmul_epilogue(torch.zeros((2, 3), device="meta"),
                            torch.zeros((3, 4), device="meta"))
    i8 = dict(dtype=torch.int8, device="meta")
    with pytest.raises(RuntimeError, match="CPU"):
        tmm.mac_matmul_int8(torch.zeros((2, 3), **i8),
                            torch.zeros((3, 4), **i8),
                            torch.zeros(4, device="meta"))
    z = torch.zeros((1, 4, 2, 8), device="meta")
    with pytest.raises(RuntimeError, match="CPU"):
        twk.wkv_chunk(z, z, z, z, torch.zeros((2, 8), device="meta"),
                      torch.zeros((1, 2, 8, 8), device="meta"), chunk=4)
    assert common.runs_plain(torch.zeros(2), None)


# ---------------------------------------------------------------------------
# the rnn_lm kernels: mac_matmul_int8 and wkv_chunk
# ---------------------------------------------------------------------------


def mac_float_inputs(seed=0, m=64, k=96, n=32):
    """f32 activations and weights for the quantizing wrapper."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return jnp.asarray(x), jnp.asarray(w)


def wkv_inputs(seed=0, b=1, s=32, heads=2, n=8, chunk=16):
    """The grid's WKV case (the conformance runner's defaults) with a
    non-zero start state, so the from-state term is exercised too."""
    r, k, v, lw, u, s0 = kc.wkv_case(seed, b, s, heads, n)
    s0 = 0.3 * jax.random.normal(jax.random.PRNGKey(seed + 1), s0.shape)
    return (r, k, v, lw, u, s0), chunk, kc.tol_from_acc(jnp.float32, s,
                                                         slack=8.0)


@pytest.mark.parametrize("case", grid("mac_matmul_int8"))
def test_mac_matmul_plain_matches_pallas_kernel(case):
    x, w, s = kc.mac_case(0, **case)
    want = jmm.mac_matmul_int8(x, w, s)
    before = tmm.mac_matmul_int8.launches
    got = tmm.mac_matmul_int8(t(x), t(w), t(s))
    assert tmm.mac_matmul_int8.launches == before  # CPU: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", grid("mac_matmul_int8"))
def test_mac_matmul_wrapper_matches_pallas_wrapper(case):
    """Weights quantized per output channel, activations per row on the
    fly: the codes and scales equal the reference's, then the outputs."""
    x, w = mac_float_inputs(**case)
    jq, tq = jptq.quantize_weight(w), tptq.quantize_weight(t(w))
    np.testing.assert_array_equal(tq["w_int8"].numpy(), np.asarray(jq["w_int8"]))
    np.testing.assert_array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
    np.testing.assert_array_equal(tptq.dequantize(tq).numpy(),
                                  np.asarray(jptq.dequantize(jq)))
    # the reference wrapper's per-row activation codes (ops.py:39-50)
    absmax = jnp.max(jnp.abs(x), axis=1, keepdims=True)
    jxs = jnp.maximum(absmax, 1e-8) / 127.0
    jcodes = jnp.clip(jnp.round(x / jxs), -127, 127).astype(jnp.int8)
    codes, xs = tops._quant_rows(t(x))
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    want = jops._pallas_mac_matmul_int8(x, jq)
    got = tops._cuda_mac_matmul_int8(t(x), tq)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", grid("wkv_chunk"))
def test_wkv_chunk_plain_matches_pallas_kernel(case):
    args, chunk, tol = wkv_inputs(**case)
    want, want_s = jwk.wkv_chunk(*args, chunk=chunk)
    before = twk.wkv_chunk.launches
    got, got_s = twk.wkv_chunk(*(t(a) for a in args), chunk=chunk)
    assert twk.wkv_chunk.launches == before  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **tol)


@pytest.mark.parametrize("case", grid("wkv_chunk"))
def test_wkv_chunk_wrapper_matches_pallas_wrapper(case):
    args, chunk, tol = wkv_inputs(**case)
    want, want_s = jops._pallas_wkv_chunk(*args, chunk)
    got, got_s = tops._cuda_wkv_chunk(*(t(a) for a in args), chunk)
    assert got.dtype == got_s.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **tol)


@pytest.mark.parametrize("case", grid("wkv_chunk"))
def test_wkv_chunk_plain_matches_sequential_recurrence(case):
    """The chunked plain version against the token-by-token oracle, on the
    grid's S and on a ragged S zero-padded to whole chunks as ``time_mix``
    pads it (the wrapper itself refuses a ragged S, as the reference)."""
    args, chunk, tol = wkv_inputs(**case)
    targs = [t(a) for a in args]
    for s_len in (targs[0].shape[1], targs[0].shape[1] - 3):
        cut = [a[:, :s_len] for a in targs[:4]] + targs[4:]
        pad = (-s_len) % chunk
        padded = [torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                  for a in cut[:4]] + cut[4:]
        if pad:
            with pytest.raises(ValueError, match="multiple of chunk"):
                twk.wkv_chunk(*cut, chunk=chunk)
        got, got_s = twk.wkv_chunk(*padded, chunk=chunk)
        want, want_s = tref.wkv_ref_sequential(*cut)
        assert tuple(got.shape) == tuple(padded[0].shape)
        np.testing.assert_allclose(got[:, :s_len].numpy(), want.numpy(),
                                   **tol)
        np.testing.assert_allclose(got_s.numpy(), want_s.numpy(), **tol)
