"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is visible and run on the
card with ``PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (that machine
has no JAX, so this file imports nothing of it).  The cases are the shapes
of the shared conformance grid's (``kernel_cases.GRID``), plus the stem's
Cin = 3 and a Cin % 4 == 0 conv with a residual, Cin = 24 and 20 and Cout =
40 and 33, so every copy width of the int8 conv's patch and weight tiles
runs, and every launch shape of the CNN path at batch 8 (the stem,
ResNet50's 3x3 convs and projections, DenseNet121's Cout = 32 growth
convs); two launches of a split-K conv and a split-K mac give the same
bits and leave the tile counters 0; one int8 tensor-core tile per staged
width (``marvel_imma_selftest``) equals the exact product; the depthwise and separable-block cases cover C not a
multiple of 4 (byte loads) and of the 32-channel chunk, stride 2 with SAME
and VALID, each act, Cout not a multiple of the 64-channel tile, the
split over C of MobileNet's late blocks (MobileNetV2's last at batch 8,
whose two launches give the same bits) and its first block's shape at
batch 2.  Inputs are made with numpy from a
seed.  Tolerances as in ``test_torch_kernels.py`` (the depthwise sums are
exact, the separable block's f32 contraction over C gets
``tol_from_acc(float32, C)``); TF32 is off for the plain versions, and a v0
forward on the card matches the CPU with both TF32 flags on.

The CNN path's CUDA-core kernels at the forwards' own shapes: every f32
GEMM shape of a batch-8 ResNet50, MobileNetV2, DenseNet121 and MobileNetV1
forward through the fma form (the N = 2 heads and K = 24 among them), and
ragged (K % 4 != 0, N % 4 != 0) and bf16 operands, each within the
products' magnitude bound; two launches of each give the same bits and
every split launch leaves its tile counters 0; every depthwise shape of
MobileNetV1/V2 at stride 1 and 2, equal to the plain version.

The pool kernels in each form, read from the wrappers'
``launches_by_form``: the vector form at every pool launch shape of the
CNN path cut to batch 2 (VGG16's five max pools, the 3x3 stem pool,
DenseNet121's three avg pools, the four global-average pools), in f32 and
int8; a NaN planted in one max window per form, which must come out NaN
(as ``torch.maximum`` gives it); an input view one element past an aligned
address, which takes the scalar form; the global average at H*W = 1, 4
(vector form) and 143 (rows form).

The LM kernels: ``residual_rmsnorm`` on the grid's rows (33 x 96, 130 x
257), qwen3-8b's (8 and 2048 rows of 4096, the scale in bf16 or f32),
hymba-1.5b's (8 and 2048 rows of 1600), whisper-tiny's (8, 1792 and 6000
rows of 384), internvl2-26b's and granite-34b's 6144 (8, 128 and 2048
rows), 8200 (beyond the
rows form's registers) and rows one element past an aligned address, each
launch in the form ``norm_plan`` gives (read from ``launches_by_form``),
and one wrapper call traced with ``torch.profiler``: one device kernel,
no cast of the scale before it;
``flash_attention`` on the grid's grouped and ragged cases, qwen3-8b's heads
and non-causal cross-attention with Sq != Skv in both forms (7 and 40
queries over 16 keys in f32, 448 over 1536 at d = 64 in bf16), heads of
128 with 6 (internvl2-26b) and 48 (granite-34b, one KV head) query heads a
KV head, and the GEMM on bf16 operands, whisper-tiny's shapes with bias,
gelu and residual among them, and the 6144-wide LMs' (N = 128, K = 24576).  In f32 the tolerance is ``tol_from_acc(float32, K)`` (sum order
over the reduction K); in bf16 the outputs may differ by one bf16 rounding
(2**-7 relative), and flash attention's probabilities too (2**-7 of
``mean|v|`` absolute), where the two sum orders straddle a rounding edge.

The tensor-core forms: one wgmma tile per operand arrangement the kernels
use (``hopper_selftest.cu``: K-major and MN-major A and B, register A) on
random data against torch; the bf16 GEMM through its decode and wgmma
forms at M in {1, 8, 16, 33, 64, 2047}, K in {64, 4096, 12288}, N in {8,
1024, 2048, 4096}, every act and f32, bf16 or no residual, within the
products' magnitude bound plus one bf16 rounding, and at hymba-1.5b's
shapes (N = 1600 and 320 end in half a wgmma column tile; K = 1600, 3200
and 5504) with and without a residual; the shapes that must
take the CUDA-core form; bf16 flash attention at d in {64, 128}, G in {1,
4}, S in {1, 63, 128, 512}, causal and full, through the wgmma form.

The rnn_lm kernels: ``mac_matmul_int8`` on the grid's three cases, a
skinny ragged one, a tiled one with K % 32 != 0 and N % 8 != 0 and
rwkv6-1.6b's GEMM shapes, equal to its plain version
(exact int32 sums); ``wkv_chunk`` on the grid's three cases, the smoke
model's and rwkv6-1.6b's head sizes, a decay strong enough that
``exp(-cum)`` would overflow, and rwkv6-1.6b's prefill at B = 1 (S = 512,
32 heads, 8 chunks of 64), within ``tol_from_acc(float32, S)`` with the
conformance runner's slack of 8; two launches of that prefill give the
same bits and leave the chain's ticket and flags 0; the kernel's shared
memory equals ``smem_bytes``; a ragged S, a head size it is not built for
and a working set over the block's shared memory are refused, not run
plain.

The kernels as ``marvel::`` ops (``kernels/library.py``): each op's fake
implementation gives its real output's shape, dtype and strides at a main
path shape; a v4 CNN program's rewritten graph launches each kernel as
often as the program's eager executable and gives the same logits; a
launcher patched after a bucket was traced is what its graph runs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

# kernel_cases.GRID's shapes for the three ported kernels
CONV_CASES = [
    dict(stride=1, padding="SAME", act="none"),
    dict(stride=2, padding="VALID", act="relu"),
    dict(stride=2, padding="SAME", act="relu6"),
    dict(stride=1, padding="VALID", act="relu", residual=True),
    dict(stride=2, padding="SAME", act="relu", residual=True),
    dict(h=8, w_sp=9, cin=130, cout=140, stride=2, act="relu"),
    dict(h=32, w_sp=32, cin=3, cout=64, k=7, stride=2, act="relu"),
    dict(h=15, w_sp=15, cin=64, cout=70, k=3, stride=2, act="relu6",
         residual=True),
    # few output tiles against a long K: the split-K path
    dict(h=2, w_sp=2, cin=512, cout=512, k=3, act="relu", residual=True),
    # 8- and 4-byte patch copies (Cin = 24, 20), 4-byte weight copies and
    # ragged tiles (Cout = 40, M = 2 * 5 * 4), byte weight loads (Cout = 33)
    dict(h=9, w_sp=7, cin=24, cout=40, stride=2, act="relu6"),
    dict(h=5, w_sp=6, cin=20, cout=33, padding="VALID", act="none",
         residual=True),
] + [
    # every launch shape of the CNN path at batch 8, as (M, K, N): the stem
    # (8192, 147, 64); ResNet50's 3x3 convs (2048, 576, 64) .. (32, 4608,
    # 512) and stride-2 projections (512, 256, 512) .. (32, 1024, 2048);
    # DenseNet121's growth convs (2048 .. 32, 1152, 32)
    dict(batch=8, h=64, w_sp=64, cin=3, cout=64, k=7, stride=2, act="relu"),
    *(dict(batch=8, h=h, w_sp=h, cin=c, cout=c, act="relu", residual=True)
      for h, c in ((16, 64), (8, 128), (4, 256), (2, 512))),
    *(dict(batch=8, h=h, w_sp=h, cin=c, cout=2 * c, k=1, stride=2,
           act="none") for h, c in ((16, 256), (8, 512), (4, 1024))),
    *(dict(batch=8, h=h, w_sp=h, cin=128, cout=32, act="none")
      for h in (16, 8, 4, 2)),
]
GEMM_CASES = [
    dict(act="silu"),
    dict(act="gelu"),
    dict(m=130, k=257, n=140, act="relu", residual=True),
    dict(act="none", residual=True, affine=False),
    dict(m=8, k=2048, n=2, act="none"),  # one tile: the split-K path
    dict(m=32, k=2048, n=512, act="relu", residual=True),
]
POOL_CASES = [
    dict(op="max", k=2), dict(op="max", k=3), dict(op="avg", k=2),
    dict(op="avg", k=3), dict(op="max", k=3, dtype=np.int8),
    dict(op="avg", k=2, dtype=np.int8), dict(op="global_avg"),
    dict(op="global_avg", dtype=np.int8),
    dict(h=16, w_sp=16, c=130, op="max", k=2),
]


DW_CASES = [
    dict(c=5, act="none"),  # C % 4 != 0: byte loads
    dict(c=20, stride=2, padding="SAME", act="relu6"),  # C % 16 != 0
    dict(c=48, k=5, stride=2, padding="VALID", act="relu6"),
    # a row too wide for 32 channels of halo: fewer channels a block
    dict(c=32, h=6, w_sp=1200, act="none"),
    dict(c=6, stride=2, padding="SAME", act="relu"),
    dict(c=7, stride=2, padding="VALID", act="relu6"),
    dict(c=32, padding="VALID", act="relu"),  # char4 loads, float4 stores
    dict(c=96, h=32, w_sp=32, stride=2, padding="SAME", act="relu6"),
    dict(c=144, stride=2, padding="VALID", act="none"),
    dict(c=24, k=5, act="relu"),  # a tap stack the kernel does not unroll
]
SEP_CASES = [
    dict(c=5, cout=9, dw_act="relu", pw_act="relu"),
    dict(c=6, cout=70, stride=2, padding="VALID", dw_act="relu6",
         pw_act="none"),
    dict(c=130, cout=140, stride=2, dw_act="relu6", pw_act="none"),
    dict(c=96, cout=24, h=32, w_sp=32, stride=2, dw_act="relu6",
         pw_act="none"),
    dict(c=33, cout=64, stride=2, padding="SAME", dw_act="none",
         pw_act="relu6"),
    # few output tiles against a long C: the split over C
    dict(c=960, cout=320, h=2, w_sp=2, dw_act="relu6", pw_act="none"),
    dict(c=1024, cout=1024, h=4, w_sp=4, stride=2, dw_act="relu",
         pw_act="relu"),
    # MobileNetV2 v4's last block (M = 32 at batch 8, a split over C) and
    # its first (M = 8192 at batch 8; here M = 2048 at batch 2)
    dict(c=960, cout=320, h=2, w_sp=2, batch=8, dw_act="relu6",
         pw_act="none"),
    dict(c=32, cout=16, h=32, w_sp=32, dw_act="relu6", pw_act="none"),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_fused_conv_kernel_matches_plain(card, case):
    from repro_torch.kernels import fused_conv as fc

    args, kw = _conv_args(card, case)
    before = fc.fused_conv_int8.launches
    got = fc.fused_conv_int8(*args, **kw)
    torch.cuda.synchronize()
    assert fc.fused_conv_int8.launches == before + 1
    want = fc.fused_conv_int8_plain(*args, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _conv_args(card, case):
    from repro_torch.kernels import common

    c = dict(seed=0, batch=2, h=13, w_sp=11, cin=5, cout=9, k=3, stride=1,
             padding="SAME", act="relu", residual=False) | case
    r = _rng(c["seed"])
    n = c["batch"]
    x = r.integers(-127, 128, (n, c["h"], c["w_sp"], c["cin"]), np.int8)
    w = r.integers(-127, 128, (c["k"], c["k"], c["cin"], c["cout"]), np.int8)
    es = (r.random(c["cout"]) * 1e-3).astype(np.float32)
    eb = r.standard_normal(c["cout"]).astype(np.float32)
    ho = common.conv_out_size(c["h"], c["k"], c["stride"], c["padding"])
    wo = common.conv_out_size(c["w_sp"], c["k"], c["stride"], c["padding"])
    res = (r.standard_normal((n, ho, wo, c["cout"])).astype(np.float32)
           if c["residual"] else None)
    args = [None if a is None else torch.from_numpy(a).to(card)
            for a in (x, w, es, eb, res)]
    return args, dict(stride=c["stride"], padding=c["padding"], act=c["act"])


@pytest.mark.parametrize("which", ["conv", "mac"])
def test_int8_split_launches_give_the_same_bits(card, which):
    """Split K summed in one launch, the slices in order: two launches of
    ResNet50's last 3x3 conv at batch 8 (M = 32, K = 4608) and of
    rwkv6-1.6b's decode down projection (M = 8, K = 7168) give the same
    bits, equal to the plain version, and leave the tile counters 0."""
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_conv as fc
    from repro_torch.kernels import mac_matmul as mm
    from repro_torch.kernels import matmul_epilogue as me

    sms = build.sm_count(card)
    if which == "conv":
        args, kw = _conv_args(card, dict(batch=8, h=2, w_sp=2, cin=512,
                                         cout=512, residual=True))
        assert fc.conv_plan(32, 512, 4608, sms)[1] > 1
        run = lambda: fc.fused_conv_int8(*args, **kw)  # noqa: E731
        want = fc.fused_conv_int8_plain(*args, **kw)
    else:
        r = _rng(1)
        args = [torch.from_numpy(a).to(card) for a in (
            r.integers(-128, 128, (8, 7168), np.int8),
            r.integers(-128, 128, (7168, 2048), np.int8),
            (r.random(2048) * 0.02).astype(np.float32))]
        assert mm.mac_plan(8, 2048, 7168, sms)[1] > 1
        run = lambda: mm.mac_matmul_int8(*args)  # noqa: E731
        want = mm.mac_matmul_int8_ref(*args)
    first, again = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    if which == "mac":
        assert torch.equal(first, want)
    else:
        torch.testing.assert_close(first, want, rtol=1e-5, atol=1e-5)
    assert int(me._counters(card).abs().sum()) == 0


@pytest.mark.parametrize("bn", [32, 64, 128])
def test_imma_tile_fragment_maps(card, bn):
    """One 16 x BN x 64 int8 tile through csrc/imma.cuh's staged layouts
    (the patch tile's and the weight tile's swizzles), its ldmatrix A
    fragments, its register-built B column quads and the accumulators'
    column map, on mma.sync s8, against the exact product of random codes
    (-128 included).  A wrong map gives wrong numbers here and nowhere
    as plainly."""
    from repro_torch.kernels import build

    r = _rng(bn)
    a = torch.from_numpy(r.integers(-128, 128, (16, 64), np.int8))
    b = torch.from_numpy(r.integers(-128, 128, (64, bn), np.int8))
    ad, bd = a.to(card), b.to(card)
    out = torch.empty((16, bn), dtype=torch.int32, device=card)
    with torch.cuda.device(card):
        status = build.lib().marvel_imma_selftest(
            ad.data_ptr(), bd.data_ptr(), out.data_ptr(), bn,
            build.stream_ptr(card))
    build.check("imma_selftest", status)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), (a.long() @ b.long()).int())


@pytest.mark.parametrize("case", GEMM_CASES, ids=str)
def test_matmul_epilogue_kernel_matches_plain(card, case):
    from repro_torch.kernels import matmul_epilogue as me

    c = dict(seed=0, m=37, k=64, n=48, act="relu", residual=False,
             affine=True) | case
    r = _rng(c["seed"])
    m, k, n = c["m"], c["k"], c["n"]
    x = torch.from_numpy(r.standard_normal((m, k), np.float32) * 0.5)
    w = torch.from_numpy(r.standard_normal((k, n), np.float32) * 0.1)
    b = torch.from_numpy(r.standard_normal(n, np.float32) * 0.1)
    s = torch.from_numpy(0.5 + r.random(n, np.float32)) if c["affine"] else None
    res = (torch.from_numpy(r.standard_normal((m, n), np.float32))
           if c["residual"] else None)
    args = [None if a is None else a.to(card) for a in (x, w, b)]
    kw = dict(act=c["act"], scale=None if s is None else s.to(card),
              residual=None if res is None else res.to(card))
    got = me.matmul_epilogue(*args, **kw)
    want = me.matmul_epilogue_plain(*args, **kw)
    t = max(max(32, k) * float(np.finfo(np.float32).eps) * 8, 1e-5)
    torch.testing.assert_close(got, want, rtol=t, atol=t)  # tol_from_acc


@pytest.mark.parametrize("case", POOL_CASES, ids=str)
def test_pool_kernels_match_plain(card, case):
    from repro_torch.kernels import pooling as pk

    c = dict(seed=0, h=13, w_sp=11, c=5, op="max", k=2, stride=2,
             dtype=np.float32) | case
    r = _rng(c["seed"])
    shape = (2, c["h"], c["w_sp"], c["c"])
    if np.dtype(c["dtype"]) == np.int8:
        x = torch.from_numpy(r.integers(-127, 128, shape, np.int8))
    else:
        x = torch.from_numpy(r.standard_normal(shape, np.float32))
    x = x.to(card)
    if c["op"] == "global_avg":
        got, want = pk.global_avgpool(x), pk.global_avgpool_plain(x)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        return
    kw = dict(k=c["k"], stride=c["stride"], op=c["op"])
    got, want = pk.windowed_pool(x, **kw), pk.windowed_pool_plain(x, **kw)
    assert got.dtype == want.dtype
    if c["op"] == "max":
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


# every pool launch shape of the CNN path at batch 2: (shape, op, window)
VECTOR_POOL_CASES = [
    *(((2, h, h, c), "max", 2) for h, c in ((64, 64), (32, 128), (16, 256),
                                             (8, 512), (4, 512))),
    ((2, 32, 32, 64), "max", 3),
    *(((2, h, h, c), "avg", 2) for h, c in ((15, 128), (7, 256), (3, 512))),
]
GAP_VECTOR_SHAPES = [(2, 2, 2, 2048), (2, 2, 2, 1280), (2, 2, 2, 1024),
                     (2, 1, 1, 1024)]


def _pool_x(card, shape, dtype, seed=0):
    r = _rng(seed)
    if np.dtype(dtype) == np.int8:
        return torch.from_numpy(r.integers(-127, 128, shape, np.int8)).to(card)
    return torch.from_numpy(r.standard_normal(shape, np.float32)).to(card)


def _assert_pool(got, want, op):
    assert got.dtype == want.dtype and got.shape == want.shape
    if op == "max":
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    elif op == "avg":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    else:  # global average: another sum order than torch.sum's
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _pool_launch(x, op, k=2):
    """(kernel result, plain result, launches per form of the call): the
    wrapper's form counters set to 0 just before."""
    from repro_torch.kernels import pooling as pk

    if op == "global_avg":
        fn, plain, kw = pk.global_avgpool, pk.global_avgpool_plain, {}
        fn.launches_by_form = {"vector": 0, "rows": 0, "scalar": 0}
    else:
        fn, plain = pk.windowed_pool, pk.windowed_pool_plain
        kw = dict(k=k, stride=2, op=op)
        fn.launches_by_form = {"vector": 0, "scalar": 0}
    got = fn(x, **kw)
    return got, plain(x, **kw), fn.launches_by_form


def _one(form, forms):
    return {f: int(f == form) for f in forms}


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
@pytest.mark.parametrize("shape,op,k", VECTOR_POOL_CASES, ids=str)
def test_windowed_pool_vector_form_at_cnn_shapes(card, shape, op, k, dtype):
    got, want, forms = _pool_launch(_pool_x(card, shape, dtype), op, k)
    _assert_pool(got, want, op)
    assert forms == _one("vector", forms)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
@pytest.mark.parametrize("shape", GAP_VECTOR_SHAPES, ids=str)
def test_global_avgpool_vector_form_at_cnn_shapes(card, shape, dtype):
    got, want, forms = _pool_launch(_pool_x(card, shape, dtype), "global_avg")
    _assert_pool(got, want, "global_avg")
    assert forms == _one("vector", forms)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("c,form", [(64, "vector"), (5, "scalar")])
def test_max_pool_propagates_a_planted_nan(card, c, form, k):
    """A NaN in a max window gives NaN, as ``torch.maximum`` and the
    reference's ``lax.max`` do (the NaN is not the window's first tap)."""
    x = _pool_x(card, (2, 9, 7, c), np.float32)
    x[1, 3, 2, c - 1] = float("nan")
    got, want, forms = _pool_launch(x, "max", k)
    assert torch.isnan(want).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    _assert_pool(got, want, "max")
    assert forms == _one(form, forms)


@pytest.mark.parametrize("op", ["max", "avg", "global_avg"])
def test_pool_unaligned_input_takes_the_scalar_form(card, op):
    shape = (2, 8, 8, 64)
    buf = _pool_x(card, (int(np.prod(shape)) + 1,), np.float32)
    x = buf[1:].view(shape)  # one element past an aligned address
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got, want, forms = _pool_launch(x, op)
    _assert_pool(got, want, op)
    assert forms == _one("scalar", forms)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
@pytest.mark.parametrize("hw,form", [((1, 1), "vector"), ((2, 2), "vector"),
                                     ((13, 11), "rows")])
def test_global_avgpool_forms_by_pixels(card, hw, form, dtype):
    got, want, forms = _pool_launch(_pool_x(card, (2, *hw, 64), dtype),
                                    "global_avg")
    _assert_pool(got, want, "global_avg")
    assert forms == _one(form, forms)


@pytest.mark.parametrize("case", DW_CASES, ids=str)
def test_depthwise_kernel_matches_plain(card, case):
    from repro_torch.kernels import depthwise_conv as dw

    c = dict(seed=0, h=13, w_sp=11, c=5, k=3, stride=1, padding="SAME",
             act="relu") | case
    r = _rng(c["seed"])
    x = r.integers(-127, 128, (2, c["h"], c["w_sp"], c["c"]), np.int8)
    w = r.integers(-127, 128, (c["k"], c["k"], c["c"]), np.int8)
    es = (r.random(c["c"]) * 1e-3).astype(np.float32)
    eb = r.standard_normal(c["c"]).astype(np.float32)
    args = [torch.from_numpy(a).to(card) for a in (x, w, es, eb)]
    kw = dict(stride=c["stride"], padding=c["padding"], act=c["act"])
    before = dw.depthwise_conv_int8.launches
    got = dw.depthwise_conv_int8(*args, **kw)
    torch.cuda.synchronize()
    assert dw.depthwise_conv_int8.launches == before + 1
    want = dw.depthwise_conv_int8_plain(*args, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", SEP_CASES, ids=str)
def test_sep_block_kernel_matches_plain(card, case):
    from repro_torch.kernels import depthwise_conv as dw

    args, kw = _sep_args(case)
    before = dw.sep_block_int8.launches
    got = dw.sep_block_int8(*args, **kw)
    torch.cuda.synchronize()
    assert dw.sep_block_int8.launches == before + 1
    want = dw.sep_block_int8_plain(*args, **kw)
    t = max(max(32, args[0].shape[-1]) * float(np.finfo(np.float32).eps) * 8,
            1e-5)
    torch.testing.assert_close(got, want, rtol=t, atol=t)  # tol_from_acc


def test_sep_block_split_launches_give_the_same_bits(card):
    """Split-C summed in one launch, the slices in order: two launches of
    MobileNetV2's last block at batch 8 (8 slices of C) give the same
    bits."""
    from repro_torch.kernels import build
    from repro_torch.kernels import depthwise_conv as dw

    args, kw = _sep_args(SEP_CASES[-2])
    m, c, cout = 32, 960, 320
    assert dw.sep_plan(m, c, cout, build.sm_count(card))[2] > 1
    first = dw.sep_block_int8(*args, **kw)
    again = dw.sep_block_int8(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def _sep_args(case):
    c = dict(seed=0, h=13, w_sp=11, c=5, cout=9, stride=1, padding="SAME",
             dw_act="relu", pw_act="none", batch=2) | case
    r = _rng(c["seed"])
    x = r.integers(-127, 128, (c["batch"], c["h"], c["w_sp"], c["c"]),
                   np.int8)
    wd = r.integers(-127, 128, (3, 3, c["c"]), np.int8)
    ds = (r.random(c["c"]) * 1e-5).astype(np.float32)
    db = r.standard_normal(c["c"]).astype(np.float32)
    wp = r.integers(-127, 128, (c["c"], c["cout"]), np.int8)
    ps = (r.random(c["cout"]) * 1e-3).astype(np.float32)
    pb = r.standard_normal(c["cout"]).astype(np.float32)
    args = [torch.from_numpy(a).to("cuda")
            for a in (x, wd, ds, db, wp, ps, pb)]
    kw = dict(stride=c["stride"], padding=c["padding"], dw_act=c["dw_act"],
              pw_act=c["pw_act"])
    return args, kw


# ---------------------------------------------------------------------------
# the CNN path's CUDA-core kernels at the forwards' own shapes
# ---------------------------------------------------------------------------

CNN_GEMM_MODELS = ("resnet50", "mobilenetv2", "densenet121", "mobilenetv1")
# ragged and bf16 operands in the fma form: K % 4 != 0, N = 2 heads, K = 24,
# N % 4 != 0, bf16 with K % 8 != 0 and a bf16 residual
FMA_CASES = [dict(m=37, k=30, n=48), dict(m=8, k=24, n=2),
             dict(m=2050, k=31, n=6, residual=True),
             dict(m=8, k=2048, n=2, bf16=True),
             dict(m=100, k=257, n=70, bf16=True),
             dict(m=33, k=1000, n=130, bf16=True, residual=True)]


def _cnn_sites(model, pattern):
    """The distinct (x shape, w shape) of a pattern's sites in a batch-8
    forward of a full-width CNN, recorded over fake tensors."""
    from repro_torch.core import profiler
    from repro_torch.models.cnn import get_cnn

    init, apply, in_shape = get_cnn(model)
    gen = torch.Generator().manual_seed(0)
    sites = profiler.site_shapes(
        lambda: apply(init(gen), torch.zeros((8, *in_shape))), pattern)
    return sorted({(xs, ws) for _, (xs, _), (ws, _) in sites})


def _fma_case(card, seed, m, k, n, bf16=False, residual=False, act="relu"):
    """One fma-form launch against the plain version within
    ``_gemm_case_tol`` (f32 output); a second launch gives the same bits;
    a split launch leaves every tile counter at 0."""
    from repro_torch.kernels import build
    from repro_torch.kernels import matmul_epilogue as me

    r = _rng(seed)
    dt = torch.bfloat16 if bf16 else torch.float32
    x = torch.from_numpy(r.standard_normal((m, k), np.float32)).to(card, dt)
    w = torch.from_numpy(r.standard_normal((k, n), np.float32)
                         / np.sqrt(k)).to(card, dt)
    es = torch.from_numpy(0.5 + r.random(n, np.float32)).to(card)
    eb = torch.from_numpy(r.standard_normal(n, np.float32) * 0.1).to(card)
    res = (torch.from_numpy(r.standard_normal((m, n), np.float32)).to(card, dt)
           if residual else None)
    got = me._launch(x, w, es, eb, res, act, "fma")
    again = me._launch(x, w, es, eb, res, act, "fma")
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, again), (m, k, n)
    want = me._plain(x, w, es, eb, res, act)
    err = (got - want).abs()
    tol = _gemm_case_tol(x, w, want, es, eb, res, bf16_out=False)
    assert (err <= tol).all(), (m, k, n, (err / tol).max().item())
    splits = me.split_plan("fma", m, n, k, build.sm_count(card))[0]
    if splits > 1:
        assert int(me._counters(card).abs().sum()) == 0, (m, k, n)
    return splits


@pytest.mark.parametrize("model", CNN_GEMM_MODELS)
def test_fma_gemm_at_every_cnn_shape(card, model):
    """Every f32 GEMM shape of a batch-8 forward of the CNN through the fma
    form, the N = 2 head and MobileNetV2's K = 24 among them; every split-K
    shape launched twice gives the same bits and leaves its counters 0."""
    for i, (xs, ws) in enumerate(_cnn_sites(model, "matmul_epilogue")):
        _fma_case(card, i, int(np.prod(xs[:-1])), ws[0], ws[1],
                  residual=i % 2 == 1)


@pytest.mark.parametrize("case", FMA_CASES, ids=str)
def test_fma_gemm_ragged_and_bf16_operands(card, case):
    _fma_case(card, 0, **case)


@pytest.mark.parametrize("model", ("mobilenetv2", "mobilenetv1"))
def test_depthwise_at_every_mobile_shape(card, model):
    """Every depthwise shape of a batch-8 forward of the mobile net, at
    stride 1 and 2 with SAME padding, equal to the plain version (exact
    int32 sums)."""
    from repro_torch.kernels import depthwise_conv as dw

    for i, (xs, ws) in enumerate(_cnn_sites(model, "depthwise_conv")):
        r = _rng(i)
        c = xs[-1]
        x = torch.from_numpy(r.integers(-127, 128, xs, np.int8)).to(card)
        w = torch.from_numpy(r.integers(-127, 128, (ws[0], ws[1], c),
                                        np.int8)).to(card)
        es = torch.from_numpy((r.random(c) * 1e-3).astype(np.float32)).to(card)
        eb = torch.from_numpy(r.standard_normal(c).astype(np.float32)).to(card)
        for stride in (1, 2):
            kw = dict(stride=stride, padding="SAME", act="relu6")
            got = dw.depthwise_conv_int8(x, w, es, eb, **kw)
            want = dw.depthwise_conv_int8_plain(x, w, es, eb, **kw)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["lenet5", "resnet50"])
def test_v0_forward_on_card_is_full_f32_whatever_the_tf32_flags(card, name):
    """The plain baselines (v0) run in full f32 on the card even with both
    TF32 flags on (cuDNN's default is on), and leave the flags as they
    were: the card's v0 logits match the CPU's within 1e-4 relative L2
    (f32 sums in another order; TF32 convolutions give about 1e-3)."""
    from repro_torch import marvel
    from repro_torch.models.cnn import get_cnn

    init, apply, in_shape = get_cnn(name)
    params = init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_rng(1).standard_normal((8, *in_shape), np.float32))
    want = marvel.compile(apply, x, params=params, level="v0",
                          device="cpu")(x)
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        got = marvel.compile(apply, x, params=params, level="v0")(x).cpu()
        assert [f.allow_tf32 for f in flags] == [True, True]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
    assert got.shape == want.shape and torch.isfinite(got).all()
    rel = (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()
    assert rel <= 1e-4, rel


def _tol32(k):
    t = max(max(32, k) * float(np.finfo(np.float32).eps) * 8, 1e-5)
    return dict(rtol=t, atol=t)  # tol_from_acc(float32, K)


RMSNORM_CASES = [
    dict(rows=33, d=96), dict(rows=130, d=257),
    dict(rows=8, d=4096, dtype="bfloat16"),
    dict(rows=2048, d=4096, dtype="bfloat16"),
    dict(rows=130, d=257, dtype="bfloat16"), dict(rows=8, d=4096),
    # hymba-1.5b: a prefill's 2048 rows and a decode step's 8 of 1600
    dict(rows=2048, d=1600, dtype="bfloat16"),
    dict(rows=8, d=1600, dtype="bfloat16"),
    # whisper-tiny: the encoder's 4 x 1500 frames, the decoder's 4 x 448
    # tokens and a decode step's 8 rows of 384
    dict(rows=6000, d=384, dtype="bfloat16"),
    dict(rows=1792, d=384, dtype="bfloat16"),
    dict(rows=8, d=384, dtype="bfloat16"),
    # bf16 rows with an f32 scale; internvl2-26b's and granite-34b's width
    # 6144 (norm_plan: the rows form, 256 threads a row, 3 vectors each, one
    # row a block) at a decode step's 8 rows, the 2-layer cut's 128 and a
    # B = 4, S = 512 prefill's 2048; a width beyond the rows form's
    # registers and a view off 16-byte alignment (both the scalar form)
    dict(rows=2048, d=4096, dtype="bfloat16", scale="float32"),
    dict(rows=8, d=6144, dtype="bfloat16"),
    dict(rows=128, d=6144, dtype="bfloat16"),
    dict(rows=2048, d=6144, dtype="bfloat16"),
    dict(rows=8, d=8200, dtype="bfloat16"),
    dict(rows=130, d=4096, dtype="bfloat16", offset=1),
]


@pytest.mark.parametrize("case", RMSNORM_CASES, ids=str)
def test_residual_rmsnorm_kernel_matches_plain(card, case):
    from repro_torch.kernels import residual_rmsnorm as rr
    from repro_torch.kernels.ref import residual_rmsnorm_plain

    c = dict(seed=0, dtype="float32", offset=0) | case
    r = _rng(c["seed"])
    dt = getattr(torch, c["dtype"])
    sdt = getattr(torch, c.get("scale", c["dtype"]))
    n, off = c["rows"] * c["d"], c["offset"]
    res, x = (torch.from_numpy(r.standard_normal(n + off, np.float32)).to(
        card, dt)[off:].view(c["rows"], c["d"]) for _ in range(2))
    scale = torch.from_numpy(0.5 + r.random(c["d"], np.float32)).to(card, sdt)
    form = rr.norm_plan(c["rows"], c["d"], dt, sdt, aligned=off == 0).form
    assert form == ("scalar" if off or c["d"] in (257, 8200) else "rows")
    before = rr.residual_rmsnorm.launches
    forms = dict(rr.residual_rmsnorm.launches_by_form)
    got_res, got = rr.residual_rmsnorm(res, x, scale)
    torch.cuda.synchronize()
    assert rr.residual_rmsnorm.launches == before + 1
    forms[form] += 1
    assert rr.residual_rmsnorm.launches_by_form == forms
    want_res, want = residual_rmsnorm_plain(res, x, scale)
    assert got.dtype == got_res.dtype == dt
    torch.testing.assert_close(got_res, want_res, rtol=0, atol=0)
    tol = (_tol32(c["d"]) if dt == torch.float32
           else dict(rtol=2**-7, atol=1e-6))
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("scale_dtype", ["bfloat16", "float32"])
def test_residual_rmsnorm_call_is_one_device_kernel(card, scale_dtype):
    """One wrapper call on bf16 rows is one device kernel whatever the
    scale's type: no cast or copy of the scale runs before it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import residual_rmsnorm as rr

    g = torch.Generator(device="cpu").manual_seed(0)
    res, x = (torch.randn((2048, 4096), generator=g).to(card, torch.bfloat16)
              for _ in range(2))
    scale = torch.rand(4096, generator=g).to(card, getattr(torch,
                                                           scale_dtype))
    rr.residual_rmsnorm(res, x, scale)  # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rr.residual_rmsnorm(res, x, scale)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "residual_rmsnorm" in kernels[0], kernels


FLASH_CASES = [
    dict(),  # kernel_cases.GRID: b=1, sq=64, K=2, G=2, dh=16
    dict(sq=200, dh=32),
    dict(b=2, kheads=1, g=4, dh=8),
    dict(int8_kv=True),
    dict(sq=130, kheads=3, g=1, int8_kv=True),
    dict(sq=100, causal=False),
    dict(sq=512, kheads=8, g=4, dh=128, dtype="bfloat16"),
    dict(b=2, sq=77, kheads=2, g=2, dh=64, dtype="bfloat16"),
    # cross-attention, non-causal with Sq != Skv: whisper-tiny's smoke
    # variant (queries over 16 frames, the fma form) and 448 decoder queries
    # over 1536 keys at d = 64 (the wgmma form)
    dict(sq=7, skv=16, causal=False, form="fma"),
    dict(sq=40, skv=16, dh=32, causal=False, form="fma"),
    dict(b=2, sq=448, skv=1536, kheads=6, g=1, dh=64, causal=False,
         dtype="bfloat16", form="wgmma"),
    # heads of 128 in the wgmma form: internvl2-26b's 6 query heads a KV
    # head (8 KV heads) over 256 patches + 256 tokens, and granite-34b's
    # 48 query heads over its one KV head (MQA), at B = 4, S = 512 and at a
    # ragged 320
    dict(b=4, sq=512, kheads=8, g=6, dh=128, dtype="bfloat16",
         form="wgmma"),
    dict(b=4, sq=512, kheads=1, g=48, dh=128, dtype="bfloat16",
         form="wgmma"),
    dict(b=1, sq=320, kheads=1, g=48, dh=128, dtype="bfloat16",
         form="wgmma"),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_kernel_matches_plain(card, case):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.layers import quantize_kv_int8

    c = dict(seed=0, b=1, sq=64, kheads=2, g=2, dh=16, int8_kv=False,
             causal=True, dtype="float32") | case
    r = _rng(c["seed"])
    dt = getattr(torch, c["dtype"])
    q = torch.from_numpy(r.standard_normal(
        (c["b"], c["sq"], c["kheads"], c["g"], c["dh"]), np.float32))
    k, v = (torch.from_numpy(r.standard_normal(
        (c["b"], c.get("skv", c["sq"]), c["kheads"], c["dh"]), np.float32))
        for _ in range(2))
    q, k, v = (t.to(card, dt) for t in (q, k, v))
    kw = {}
    if c["int8_kv"]:  # through the dispatch wrapper's dequant boundary
        (k, ks), (v, vs) = quantize_kv_int8(k), quantize_kv_int8(v)
        kw = dict(k_scale=ks, v_scale=vs)
    before = fa.flash_attention.launches
    forms = dict(fa.flash_attention.launches_by_form)
    got = ops._cuda_flash_attention(q, k, v, causal=c["causal"], **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    if "form" in c:
        assert fa.flash_attention.launches_by_form[c["form"]] == forms[
            c["form"]] + 1
    if c["int8_kv"]:
        k = (k.float() * kw["k_scale"][..., None]).to(dt)
        v = (v.float() * kw["v_scale"][..., None]).to(dt)
    want = fa.flash_attention_plain(q, k, v, causal=c["causal"])
    assert got.shape == want.shape and got.dtype == dt
    if dt == torch.float32:
        tol = _tol32(c["sq"])
        tol = dict(rtol=4 * tol["rtol"], atol=4 * tol["atol"])  # slack 4
    else:
        tol = dict(rtol=2**-7, atol=2**-7 * v.float().abs().mean().item())
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("case", [dict(m=8, k=4096, n=1024),
                                  dict(m=130, k=257, n=140, act="silu",
                                       residual=True),
                                  dict(m=256, k=512, n=384, act="gelu")],
                         ids=str)
def test_matmul_epilogue_reads_bf16_operands_in_place(card, case):
    """bf16 operands: the CUDA-core form's f32 result is bit for bit that of
    the same values through its f32 path, within tol_from_acc of the plain
    version; the form the wrapper routes them to writes bf16 within one
    bf16 rounding of the plain version."""
    from repro_torch.kernels import matmul_epilogue as me

    c = dict(seed=0, act="none", residual=False) | case
    r = _rng(c["seed"])
    m, k, n = c["m"], c["k"], c["n"]
    bf = torch.bfloat16
    x = torch.from_numpy(r.standard_normal((m, k), np.float32)).to(card, bf)
    w = torch.from_numpy(r.standard_normal((k, n), np.float32)
                         / np.sqrt(k)).to(card, bf)
    res = (torch.from_numpy(r.standard_normal((m, n), np.float32)).to(card, bf)
           if c["residual"] else None)
    es = torch.ones(n, device=card)
    eb = torch.zeros(n, device=card)
    got = me._launch(x, w, es, eb, res, c["act"], "fma")
    f32_path = me._launch(x.float(), w.float(), es, eb,
                          None if res is None else res.float(), c["act"])
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.equal(got, f32_path)
    want = me._plain(x, w, es, eb, res, c["act"])
    torch.testing.assert_close(got, want, **_tol32(k))
    before = me.matmul_epilogue.launches
    out = me.matmul_epilogue(x, w, act=c["act"], residual=res)
    assert me.matmul_epilogue.launches == before + 1 and out.dtype == bf
    torch.testing.assert_close(
        out.float(), me.matmul_epilogue_plain(x, w, act=c["act"],
                                              residual=res).float(),
        rtol=2**-7, atol=1e-6)


# ---------------------------------------------------------------------------
# the tensor-core forms (csrc/hopper.cuh)
# ---------------------------------------------------------------------------

# mode: (N, A stored as, B stored as), as csrc/hopper_selftest.cu lists them
WGMMA_MODES = {0: (128, "mk", "kn"), 1: (128, "mk", "kn"),
               2: (64, "mk", "nk"), 3: (8, "km", "nk"), 4: (16, "km", "nk"),
               5: (64, "mk", "kn")}


@pytest.mark.parametrize("mode", sorted(WGMMA_MODES))
def test_wgmma_tile_descriptors(card, mode):
    """One 64 x N x 64 wgmma tile, loaded by TMA with 128-byte swizzle,
    on random non-symmetric data against torch on the same bf16 values:
    K-major and MN-major (transposed) A and B in shared memory, and A from
    registers (modes 1 and 5).  A wrong LBO / SBO, swizzle base, transpose
    immediate or fragment map gives wrong numbers here.  Products of bf16
    are exact in f32, so only the order of 64 f32 sums differs."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ref import full_f32

    n, a_as, b_as = WGMMA_MODES[mode]
    r = _rng(mode)
    bf = torch.bfloat16
    a = torch.from_numpy(r.standard_normal((64, 64), np.float32)).to(card, bf)
    b = torch.from_numpy(r.standard_normal(
        (64, n) if b_as == "kn" else (n, 64), np.float32)).to(card, bf)
    out = torch.empty((64, n), device=card)
    with torch.cuda.device(card):
        status = build.lib().marvel_wgmma_selftest(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), mode,
            build.stream_ptr(card))
    build.check("wgmma_selftest", status)
    torch.cuda.synchronize()
    av = a.float() if a_as == "mk" else a.float().T
    bv = b.float() if b_as == "kn" else b.float().T
    with full_f32():
        want = av @ bv
    torch.testing.assert_close(out, want, **_tol32(64))


def _gemm_case_tol(x, w, want, es, eb, res, bf16_out=True):
    """Two f32 evaluations of the epilogued GEMM in other sum orders (K eps
    times the products' magnitude, the epilogue's roundings, a few ulp of
    the act), plus the one rounding of the result to bf16 (``bf16_out``)."""
    from repro_torch.kernels.ref import full_f32

    eps = float(np.finfo(np.float32).eps)
    with full_f32():
        mag = x.float().abs() @ w.float().abs()
    extra = eb.abs() + (0 if res is None else res.float().abs())
    k = x.shape[1]
    return (1.2 * eps * ((k + 2) * mag * es.abs() + 2 * extra)
            + (4 * eps + (2.0**-8 if bf16_out else 0.0)) * want.abs())


_GEMM_ACTS = ("none", "relu", "relu6", "silu", "gelu")
TC_GEMM_CASES = [dict(m=m, k=k, n=n) for m in (1, 8, 16, 33, 64, 2047)
                 for k in (64, 4096, 12288) for n in (8, 1024, 2048, 4096)]


@pytest.mark.parametrize("i", range(len(TC_GEMM_CASES)))
def test_matmul_epilogue_tensor_core_forms(card, i):
    """bf16 GEMMs of every (M, K, N) of the grid through the wrapper: the
    form each launch takes (decode up to M = 16, wgmma above), the bf16
    output within :func:`_gemm_case_tol` of the plain f32 version; the acts
    and an f32, bf16 or no residual cycle over the cases."""
    from repro_torch.kernels import matmul_epilogue as me

    c = TC_GEMM_CASES[i]
    m, k, n = c["m"], c["k"], c["n"]
    act = _GEMM_ACTS[i % 5]
    res_kind = (None, "f32", "bf16")[i % 3]
    r = _rng(i)
    bf = torch.bfloat16
    x = torch.from_numpy(r.standard_normal((m, k), np.float32)).to(card, bf)
    w = torch.from_numpy(r.standard_normal((k, n), np.float32)
                         / np.sqrt(k)).to(card, bf)
    b = torch.from_numpy(r.standard_normal(n, np.float32) * 0.1).to(card)
    s = torch.from_numpy(0.5 + r.random(n, np.float32)).to(card)
    res = (None if res_kind is None else torch.from_numpy(
        r.standard_normal((m, n), np.float32)).to(
            card, bf if res_kind == "bf16" else torch.float32))
    form = "decode" if m <= me.DECODE_M_MAX else "wgmma"
    before = dict(me.matmul_epilogue.launches_by_form)
    got = me.matmul_epilogue(x, w, b, act=act, scale=s, residual=res)
    torch.cuda.synchronize()
    assert me.matmul_epilogue.launches_by_form[form] == before[form] + 1
    assert got.dtype == bf and got.shape == (m, n)
    x2, es, eb, r2 = me._prepare(x, w, b, s, None, res)
    want = me._plain(x2, w, es, eb, r2, act)
    err = (got.float() - want).abs()
    tol = _gemm_case_tol(x2, w, want, es, eb, r2)
    assert (err <= tol).all(), (err / tol).max().item()


# hymba-1.5b's GEMMs (M, K, N): its prefill's 2048 rows (q / o, k and v,
# the SSM's out_proj, the MLP's down projection) and a decode step's 8;
# N = 1600 and 320 end in a half column tile of the wgmma form
HYMBA_GEMM_CASES = [(2048, 1600, 1600), (2048, 1600, 320), (2048, 3200, 1600),
                    (2048, 5504, 1600), (8, 1600, 1600)]


def _hold_bf16_gemm(card, m, k, n, with_res):
    """One bf16 GEMM, with or without a bf16 residual, through the form M
    gives it (decode up to ``DECODE_M_MAX``, wgmma above): within
    :func:`_gemm_case_tol` of the plain f32 version, every column of a
    ragged last tile included."""
    from repro_torch.kernels import matmul_epilogue as me

    r = _rng(m + k + n)
    bf = torch.bfloat16
    x = torch.from_numpy(r.standard_normal((m, k), np.float32)).to(card, bf)
    w = torch.from_numpy(r.standard_normal((k, n), np.float32)
                         / np.sqrt(k)).to(card, bf)
    res = (torch.from_numpy(r.standard_normal((m, n), np.float32)).to(
        card, bf) if with_res else None)
    form = "decode" if m <= me.DECODE_M_MAX else "wgmma"
    before = dict(me.matmul_epilogue.launches_by_form)
    got = me.matmul_epilogue(x, w, residual=res)
    torch.cuda.synchronize()
    assert me.matmul_epilogue.launches_by_form[form] == before[form] + 1
    assert got.dtype == bf and got.shape == (m, n)
    x2, es, eb, r2 = me._prepare(x, w, None, None, None, res)
    want = me._plain(x2, w, es, eb, r2, "none")
    err = (got.float() - want).abs()
    tol = _gemm_case_tol(x2, w, want, es, eb, r2)
    assert (err <= tol).all(), (err / tol).max().item()
    assert (err[:, -(n % 128 or 128):] <= tol[:, -(n % 128 or 128):]).all()


@pytest.mark.parametrize("with_res", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("mkn", HYMBA_GEMM_CASES, ids=str)
def test_matmul_epilogue_hymba_shapes(card, mkn, with_res):
    """bf16 GEMMs at hymba-1.5b's shapes through the form each takes
    (decode at M = 8, wgmma at 2048), with and without a bf16 residual:
    within :func:`_gemm_case_tol` of the plain f32 version, every column of
    the ragged last tile included."""
    _hold_bf16_gemm(card, *mkn, with_res)


# granite-34b's and internvl2-26b's GEMMs (M, K, N, residual): a B = 4,
# S = 512 prefill's 2048 rows and a decode step's 8; granite-34b's K and V
# projections N = 128 wide (one wgmma column tile), its FFN's down
# projection K = 24576 deep, internvl2-26b's K and V 1024 wide and its down
# projection K = 16384; the down projections carry the residual
WIDE_GEMM_CASES = [(2048, 6144, 128, False), (8, 6144, 128, False),
                   (2048, 24576, 6144, True), (8, 24576, 6144, True),
                   (2048, 6144, 24576, False), (2048, 6144, 1024, False),
                   (8, 16384, 6144, True)]


@pytest.mark.parametrize("case", WIDE_GEMM_CASES, ids=str)
def test_matmul_epilogue_6144_wide_shapes(card, case):
    """bf16 GEMMs at the 6144-wide LMs' shapes through the form each takes
    (decode at M = 8, wgmma at 2048): within :func:`_gemm_case_tol` of the
    plain f32 version."""
    _hold_bf16_gemm(card, *case)


# whisper-tiny's GEMMs (M, K, N, act, residual): the encoder's 4 x 1500
# frames and the decoder's 4 x 448 tokens (the q/k/v/o and encoder_kv
# projections, the MLP's up projection with gelu, its down projection with
# the residual) and a decode step's 8 rows; every one has a bias
WHISPER_GEMM_CASES = [
    (6000, 384, 384, "none", False), (6000, 384, 1536, "gelu", False),
    (6000, 1536, 384, "none", True), (1792, 384, 384, "none", False),
    (1792, 384, 1536, "gelu", False), (1792, 1536, 384, "none", True),
    (8, 384, 384, "none", False), (8, 384, 1536, "gelu", False),
    (8, 1536, 384, "none", True)]


@pytest.mark.parametrize("case", WHISPER_GEMM_CASES, ids=str)
def test_matmul_epilogue_whisper_shapes(card, case):
    """bf16 GEMMs at whisper-tiny's shapes with its bias, gelu (tanh) and
    residual through the form each takes (decode at M = 8, wgmma above):
    within :func:`_gemm_case_tol` of the plain f32 version."""
    from repro_torch.kernels import matmul_epilogue as me

    m, k, n, act, with_res = case
    r = _rng(m + k + n)
    bf = torch.bfloat16
    x = torch.from_numpy(r.standard_normal((m, k), np.float32)).to(card, bf)
    w = torch.from_numpy(r.standard_normal((k, n), np.float32)
                         / np.sqrt(k)).to(card, bf)
    b = torch.from_numpy(r.standard_normal(n, np.float32) * 0.1).to(card, bf)
    res = (torch.from_numpy(r.standard_normal((m, n), np.float32)).to(
        card, bf) if with_res else None)
    form = "decode" if m <= me.DECODE_M_MAX else "wgmma"
    before = dict(me.matmul_epilogue.launches_by_form)
    got = me.matmul_epilogue(x, w, b, act=act, residual=res)
    torch.cuda.synchronize()
    assert me.matmul_epilogue.launches_by_form[form] == before[form] + 1
    assert got.dtype == bf and got.shape == (m, n)
    x2, es, eb, r2 = me._prepare(x, w, b, None, None, res)
    want = me._plain(x2, w, es, eb, r2, act)
    err = (got.float() - want).abs()
    tol = _gemm_case_tol(x2, w, want, es, eb, r2)
    assert (err <= tol).all(), (err / tol).max().item()


def test_matmul_epilogue_routes_what_tensor_cores_cannot_take(card):
    """K or N not a multiple of 8, a base not 16-byte aligned, and f32
    operands take the CUDA-core form, which the counters show."""
    from repro_torch.kernels import matmul_epilogue as me

    r = _rng(0)
    bf = torch.bfloat16

    def run(x, w):
        before = dict(me.matmul_epilogue.launches_by_form)
        got = me.matmul_epilogue(x, w, act="relu")
        torch.cuda.synchronize()
        after = me.matmul_epilogue.launches_by_form
        took = [f for f in me.FORMS if after[f] == before[f] + 1]
        torch.testing.assert_close(
            got.float(), me.matmul_epilogue_plain(x, w, act="relu").float(),
            rtol=2**-7, atol=1e-5)
        return took

    def mat(shape, dt=bf):
        return torch.from_numpy(r.standard_normal(shape, np.float32)).to(
            card, dt)

    assert run(mat((64, 257)), mat((257, 128))) == ["fma"]  # K % 8
    assert run(mat((8, 256)), mat((256, 130))) == ["fma"]  # N % 8
    buf = mat((64 * 256 + 1,))
    x = buf[1:].view(64, 256)  # contiguous, 2 bytes past an aligned base
    assert x.data_ptr() % 16 != 0
    assert run(x, mat((256, 128))) == ["fma"]
    f32 = torch.float32
    assert run(mat((64, 256), f32), mat((256, 128), f32)) == ["fma"]
    assert run(mat((64, 256)), mat((256, 128))) == ["wgmma"]
    assert run(mat((8, 256)), mat((256, 128))) == ["decode"]


TC_FLASH_CASES = [dict(s=s, g=g, d=d, causal=causal)
                  for s in (1, 63, 128, 512) for g in (1, 4) for d in (64, 128)
                  for causal in (True, False)]


@pytest.mark.parametrize("case", TC_FLASH_CASES, ids=str)
def test_flash_attention_wgmma_form(card, case):
    """bf16 heads of 64 and 128 take the wgmma form; within one bf16
    rounding of the output and of the probabilities (2**-7 of mean |v|)
    of the plain version, as the bf16 cases above."""
    from repro_torch.kernels import flash_attention as fa

    s, g, d = case["s"], case["g"], case["d"]
    r = _rng(s + g + d)
    bf = torch.bfloat16
    q = torch.from_numpy(r.standard_normal((2, s, 2, g, d), np.float32))
    k, v = (torch.from_numpy(r.standard_normal((2, s, 2, d), np.float32))
            for _ in range(2))
    q, k, v = (t.to(card, bf) for t in (q, k, v))
    before = fa.flash_attention.launches_by_form["wgmma"]
    got = fa.flash_attention(q, k, v, causal=case["causal"])
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_by_form["wgmma"] == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=case["causal"])
    assert got.shape == want.shape and got.dtype == bf
    torch.testing.assert_close(
        got.float(), want.float(), rtol=2**-7,
        atol=2**-7 * v.float().abs().mean().item())


MAC_CASES = [
    dict(m=130, k=257, n=140), dict(m=64, k=96, n=32),
    dict(m=1, k=256, n=128),  # kernel_cases.GRID
    dict(m=5, k=130, n=131),  # skinny with ragged K and N: byte loads
    dict(m=300, k=1001, n=77),  # K % 32 != 0, N % 8 != 0 in 128-row tiles
    # rwkv6-1.6b's GEMM shapes at 8 decode slots and at a 2048-row prefill
    dict(m=8, k=2048, n=2048), dict(m=8, k=2048, n=7168),
    dict(m=8, k=7168, n=2048), dict(m=2048, k=2048, n=7168),
]


@pytest.mark.parametrize("case", MAC_CASES, ids=str)
def test_mac_matmul_int8_kernel_matches_plain(card, case):
    """Exact int32 sums and the same f32 scale product: equal."""
    from repro_torch.kernels import mac_matmul as mm

    m, k, n = case["m"], case["k"], case["n"]
    r = _rng(0)
    x = torch.from_numpy(r.integers(-127, 128, (m, k), np.int8)).to(card)
    w = torch.from_numpy(r.integers(-127, 128, (k, n), np.int8)).to(card)
    s = torch.from_numpy((r.random(n) * 0.02).astype(np.float32)).to(card)
    before = mm.mac_matmul_int8.launches
    got = mm.mac_matmul_int8(x, w, s)
    torch.cuda.synchronize()
    assert mm.mac_matmul_int8.launches == before + 1
    assert torch.equal(got, mm.mac_matmul_int8_ref(x, w, s))


WKV_CASES = [
    dict(),  # kernel_cases.GRID: b=1, s=32, heads=2, n=8, chunk=16
    dict(s=64, chunk=16, heads=3, n=16),
    dict(b=2, s=48, chunk=48),
    dict(b=2, s=16, heads=4, n=32, chunk=8),  # the smoke model's heads
    dict(s=128, heads=4, n=64, chunk=64),  # rwkv6's heads
    # strong decay: exp(-cum) over a chunk would overflow f32
    dict(b=2, s=128, heads=8, n=64, chunk=64, decay=2.0),
    # rwkv6-1.6b's prefill at B = 1: 32 heads of 64, 8 chunks of 64
    dict(s=512, heads=32, n=64, chunk=64),
]


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_wkv_chunk_kernel_matches_plain(card, case):
    """f32 sums over N, the chunk and the chunks in another order, and
    exps of cumsums summed in another order: tol_from_acc(float32, S)
    with the conformance runner's slack of 8."""
    from repro_torch.kernels import wkv_chunk as wk
    from repro_torch.kernels.ref import wkv_chunk_ref

    args, c = _wkv_args(case)
    before = wk.wkv_chunk.launches
    got, got_s = wk.wkv_chunk(*args, chunk=c["chunk"])
    torch.cuda.synchronize()
    assert wk.wkv_chunk.launches == before + 1
    want, want_s = wkv_chunk_ref(*args, c["chunk"])
    assert torch.isfinite(got).all() and torch.isfinite(got_s).all()
    t = _tol32(c["s"])
    tol = dict(rtol=8 * t["rtol"], atol=8 * t["atol"])
    torch.testing.assert_close(got, want, **tol)
    torch.testing.assert_close(got_s, want_s, **tol)


def test_wkv_chunk_launches_give_the_same_bits(card):
    """The chunks chained through published states: two launches of the
    rwkv6-1.6b prefill head shape give the same bits, and the chain's
    ticket and flags are zero after each."""
    from repro_torch.kernels import wkv_chunk as wk

    args, c = _wkv_args(WKV_CASES[-1])
    first = wk.wkv_chunk(*args, chunk=c["chunk"])
    again = wk.wkv_chunk(*args, chunk=c["chunk"])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not wk._sync(card, 1).any()


def test_wkv_chunk_shared_memory_matches_the_kernel(card):
    """``smem_bytes`` mirrors the kernel's layout for every shape it
    takes, and the kernel reports 0 for the shapes it does not."""
    from repro_torch.kernels import build
    from repro_torch.kernels import wkv_chunk as wk

    lib = build.lib()
    for n in (4, 8, 16, 32, 64, 128):
        for chunk in (4, 8, 12, 16, 48, 64, 128, 256, 1024):
            want = wk.smem_bytes(n, chunk) if wk.kernel_takes(n, chunk) else 0
            assert lib.marvel_wkv_chunk_smem(n, chunk) == want, (n, chunk)


def _wkv_args(case):
    c = dict(b=1, s=32, heads=2, n=8, chunk=16, decay=0.0) | case
    r = _rng(0)
    shape = (c["b"], c["s"], c["heads"], c["n"])
    rr, kk, vv = (torch.from_numpy(0.3 * r.standard_normal(shape, np.float32))
                  for _ in range(3))
    lw = -torch.from_numpy(np.exp(0.3 * r.standard_normal(shape, np.float32)
                                  + c["decay"]))
    u = torch.from_numpy(0.3 * r.standard_normal(shape[2:], np.float32))
    s0 = torch.from_numpy(0.3 * r.standard_normal(
        (c["b"], c["heads"], c["n"], c["n"]), np.float32))
    return [a.to("cuda") for a in (rr, kk, vv, lw, u, s0)], c


def test_wkv_chunk_refuses_what_the_kernel_cannot_run(card):
    """A ragged S, a head size the kernel is not built for, and a chunk
    whose working set exceeds a block's shared memory raise on the card;
    none runs the plain version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import wkv_chunk as wk

    def args(s, n):
        z = torch.zeros((1, s, 2, n), device=card)
        return (z, z, z, -torch.ones_like(z), torch.zeros((2, n), device=card),
                torch.zeros((1, 2, n, n), device=card))

    before = wk.wkv_chunk.launches
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops._cuda_wkv_chunk(*args(100, 64), 64)
    with pytest.raises(ValueError, match="outside the kernel's shapes"):
        ops._cuda_wkv_chunk(*args(128, 128), 64)
    with pytest.raises(ValueError, match="shared memory"):
        ops._cuda_wkv_chunk(*args(256, 16), 256)
    assert wk.wkv_chunk.launches == before


# ---------------------------------------------------------------------------
# the kernels as marvel:: ops, the rewritten programs
# ---------------------------------------------------------------------------


def _library_cases(dev):
    """One call per ``marvel::`` kernel op at a shape the main path gives
    it: {name: (args, kwargs)}."""
    g = torch.Generator().manual_seed(5)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g,
                             dtype=torch.int8).to(dev)

    def f(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dev, dtype)

    bf = torch.bfloat16
    return {
        "fused_conv": ((i8(8, 16, 16, 64), i8(3, 3, 64, 64), f(64), f(64)),
                       dict(stride=2, act="relu")),
        "matmul_epilogue": ((f(8, 4, 4, 256), f(256, 128), f(128)),
                            dict(act="relu", residual=f(8, 4, 4, 128))),
        "windowed_pool": ((f(8, 32, 32, 64),), dict(k=3, stride=2)),
        "global_avgpool": ((f(8, 2, 2, 2048),), {}),
        "depthwise_conv": ((i8(8, 32, 32, 96), i8(3, 3, 96), f(96), f(96)),
                           dict(stride=2, act="relu6")),
        "sep_block": ((i8(8, 16, 16, 64), i8(3, 3, 64), f(64), f(64),
                       i8(64, 128), f(128), f(128)), dict(dw_act="relu")),
        "residual_rmsnorm": ((f(2, 8, 4096, dtype=bf), f(2, 8, 4096, dtype=bf),
                              f(4096)), {}),
        "flash_attention": ((f(1, 128, 8, 4, 128, dtype=bf),
                             f(1, 128, 8, 128, dtype=bf),
                             f(1, 128, 8, 128, dtype=bf)), {}),
        "wkv_chunk": ((f(1, 128, 4, 64), f(1, 128, 4, 64), f(1, 128, 4, 64),
                       -torch.rand((1, 128, 4, 64), generator=g).to(dev),
                       f(4, 64), f(1, 4, 64, 64)), dict(chunk=64)),
        "mac_matmul_int8": ((i8(64, 256), i8(256, 128), f(128).abs()), {}),
    }


def test_library_fakes_give_the_real_outputs(card):
    """Each marvel:: kernel op's fake implementation gives its real
    output's shape, dtype and strides (a graph traced from the fakes runs
    the real ops)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import library

    for name, (args, kwargs) in _library_cases(card).items():
        op = library.OPS[name]
        real = op(*args, **kwargs)
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake = op(*(mode.from_tensor(a) for a in args), **{
                k: mode.from_tensor(v) if isinstance(v, torch.Tensor) else v
                for k, v in kwargs.items()})
        reals = real if isinstance(real, tuple) else (real,)
        fakes = fake if isinstance(fake, tuple) else (fake,)
        assert len(reals) == len(fakes), name
        for r, fk in zip(reals, fakes):
            assert (r.shape, r.dtype, r.stride(), r.device) == (
                fk.shape, fk.dtype, fk.stride(), fk.device), name


def _entry_launches():
    """Every kernel entry point's launch counter."""
    from repro_torch.kernels import depthwise_conv as dw
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_conv as fc
    from repro_torch.kernels import mac_matmul as mm
    from repro_torch.kernels import matmul_epilogue as me
    from repro_torch.kernels import pooling as pk
    from repro_torch.kernels import residual_rmsnorm as rr
    from repro_torch.kernels import wkv_chunk as wk

    entries = (fc.fused_conv_int8, me.matmul_epilogue, pk.windowed_pool,
               pk.global_avgpool, dw.depthwise_conv_int8, dw.sep_block_int8,
               rr.residual_rmsnorm, fa.flash_attention, wk.wkv_chunk,
               mm.mac_matmul_int8)
    return {fn.__name__: fn.launches for fn in entries}


def _run_graph(graph, *args):
    """A bucket's rewritten graph run as the program runs its bucket, the
    plain versions' products in full f32."""
    from repro_torch.kernels.common import full_f32

    with torch.inference_mode(), full_f32():
        return graph(*args)


@pytest.mark.parametrize("name", ["resnet50", "mobilenetv2"])
def test_rewritten_cnn_launches_as_the_unrewritten(card, name):
    """A v4 program's rewritten graph launches each kernel as often as the
    program's eager executable (the unrewritten function), and computes
    the same logits (the same kernels on the same inputs)."""
    from repro_torch import marvel
    from repro_torch.models.cnn import get_cnn

    init, apply, in_shape = get_cnn(name)
    params = init(torch.Generator().manual_seed(0), device=card)
    x = torch.from_numpy(_rng(6).standard_normal((8, *in_shape),
                                                 np.float32)).to(card)
    prog = marvel.compile(apply, x, params=params, level="v4", quantize=True)
    graph = prog.baked_graph(x)
    assert prog.rewrite_baked and graph is not None
    launched = []
    for run in (lambda: _run_graph(graph, x), lambda: prog(x)):
        run()
        before = _entry_launches()
        out = run()
        torch.cuda.synchronize()
        launched.append(({k: v - before[k] for k, v in
                          _entry_launches().items()}, out.cpu()))
    (rw, got), (un, want) = launched
    assert rw == un and sum(rw.values()) > 0, (rw, un)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_a_patched_launch_is_what_the_baked_graph_runs(card):
    """The baked graph reaches the kernel through its module's attribute
    at call time: a launcher patched after the bucket was traced is the
    one that runs."""
    from repro_torch import marvel
    from repro_torch.kernels import fused_conv as fc
    from repro_torch.models.cnn import get_cnn

    init, apply, in_shape = get_cnn("lenet5")
    params = init(torch.Generator().manual_seed(0), device=card)
    x = torch.from_numpy(_rng(7).standard_normal((8, *in_shape),
                                                 np.float32)).to(card)
    prog = marvel.compile(apply, x, params=params, level="v4")
    graph = prog.baked_graph(x)
    assert graph is not None
    want = _run_graph(graph, x)
    real, seen = fc._launch, []

    def planted(*args):
        seen.append(args[0].shape)
        return real(*args) + 1.0

    fc._launch = planted
    try:
        got = _run_graph(graph, x)
    finally:
        fc._launch = real
    assert len(seen) == 2  # LeNet-5*'s two int8 convs
    assert not torch.equal(got, want)
    torch.testing.assert_close(_run_graph(graph, x), want, rtol=0, atol=0)
