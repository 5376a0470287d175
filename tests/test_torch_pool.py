"""The pool kernels' launch plan and plain versions, on the CPU.

``pooling.pool_plan`` is a pure function of the launch's shape, type,
window and the input's alignment: it must put every pool launch of the
paper CNNs' batch-8 v4 forwards (VGG16's five max pools, ResNet50's and
DenseNet121's 3x3 stem pools, DenseNet121's three avg pools, the four
global-average pools) in the vector form (16-byte channel groups), with a
geometry that covers every output once and spreads over the SMs; and the
scalar form where C is not a multiple of the group (4 f32, 16 int8) or the
input is not 16-byte aligned.  The plain versions (what the wrappers run on
CPU tensors) are held against the reference's Pallas kernels in interpret
mode at widths the vector form takes, and with a NaN in a max window
(``torch.maximum`` and ``jnp.maximum`` both propagate it).
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import kernel_cases as kc  # noqa: E402
from repro.kernels import pooling as jpk  # noqa: E402
from repro_torch.kernels import pooling as tpk  # noqa: E402

# every pool launch of the six CNNs' batch-8 v4 forwards (all f32):
# (forward, input shape, op, window)
MAIN_PATH_SITES = [
    ("vgg16", (8, 64, 64, 64), "max", 2),
    ("vgg16", (8, 32, 32, 128), "max", 2),
    ("vgg16", (8, 16, 16, 256), "max", 2),
    ("vgg16", (8, 8, 8, 512), "max", 2),
    ("vgg16", (8, 4, 4, 512), "max", 2),
    ("resnet50", (8, 32, 32, 64), "max", 3),
    ("resnet50", (8, 2, 2, 2048), "global_avg", 2),
    ("densenet121", (8, 32, 32, 64), "max", 3),
    ("densenet121", (8, 15, 15, 128), "avg", 2),
    ("densenet121", (8, 7, 7, 256), "avg", 2),
    ("densenet121", (8, 3, 3, 512), "avg", 2),
    ("densenet121", (8, 1, 1, 1024), "global_avg", 2),
    ("mobilenetv2", (8, 2, 2, 1280), "global_avg", 2),
    ("mobilenetv1", (8, 2, 2, 1024), "global_avg", 2),
]


def _site_id(site):
    forward, shape, op, k = site
    return f"{forward}-{op}{k}-{'x'.join(map(str, shape))}"


@pytest.mark.parametrize("site", MAIN_PATH_SITES, ids=_site_id)
def test_pool_plan_takes_the_vector_form_on_the_main_path(site):
    _, (n, h, w, c), op, k = site
    plan = tpk.pool_plan((n, h, w, c), torch.float32, op, k, 2)
    assert plan.form == "vector"
    bx, by = plan.block
    gx, gy, gz = plan.grid
    assert 32 <= bx * by <= 256 and (bx * by) % 32 == 0
    groups = c // tpk.group_width(torch.float32)
    if op == "global_avg":
        assert by == 1 and gz == 1 and gy == n and gx * bx >= groups
        threads = n * groups
    else:
        ho, wo = (h - k) // 2 + 1, (w - k) // 2 + 1
        # every (group, column, row) once; no block wholly outside
        assert gz == n * ho
        assert gx * bx >= groups > (gx - 1) * bx
        assert gy * by >= wo > (gy - 1) * by
        threads = n * ho * wo * groups
    blocks = math.prod(plan.grid)
    # one warp a block at least, and no fewer blocks than SMs where the
    # launch has a warp for each
    assert blocks >= min(tpk.H100_SMS, threads // 32)


@pytest.mark.parametrize("shape,dtype,op,k,aligned,form", [
    ((2, 13, 11, 5), torch.float32, "max", 2, True, "scalar"),
    ((2, 13, 11, 5), torch.float32, "avg", 3, True, "scalar"),
    ((2, 13, 11, 5), torch.float32, "global_avg", 2, True, "scalar"),
    ((2, 13, 11, 20), torch.int8, "max", 3, True, "scalar"),
    ((2, 8, 8, 24), torch.int8, "global_avg", 2, True, "scalar"),
    ((2, 8, 8, 32), torch.int8, "avg", 2, True, "vector"),
    ((8, 32, 32, 64), torch.float32, "max", 3, False, "scalar"),
    ((8, 2, 2, 2048), torch.float32, "global_avg", 2, False, "scalar"),
    ((2, 2, 2, 64), torch.float32, "global_avg", 2, True, "vector"),
    ((2, 3, 3, 64), torch.float32, "global_avg", 2, True, "rows"),
    ((2, 13, 11, 64), torch.float32, "global_avg", 2, True, "rows"),
], ids=str)
def test_pool_plan_forms_off_the_main_path(shape, dtype, op, k, aligned,
                                           form):
    """C not a multiple of the 16-byte group (c = 5, int8 C % 16 != 0) and
    an unaligned input take the scalar forms; a global average over more
    than GAP_VECTOR_MAX_HW = 4 pixels (3 x 3, the grid's 13 x 11) the rows
    form."""
    plan = tpk.pool_plan(shape, dtype, op, k, 2, ptr_aligned=aligned)
    assert plan.form == form
    bx, by = plan.block
    if form == "scalar" and op != "global_avg":
        n, h, w, c = shape
        total = n * ((h - k) // 2 + 1) * ((w - k) // 2 + 1) * c
        assert by == 1 and plan.grid[1:] == (1, 1)
        assert plan.grid[0] * bx >= total > (plan.grid[0] - 1) * bx
    elif op == "global_avg" and form != "vector":
        assert plan.block == (tpk.GAP_C, tpk.GAP_R)


@pytest.mark.parametrize("shape,op,k,dtype", [
    ((2, 9, 7, 64), "max", 3, jnp.float32),
    ((2, 8, 8, 32), "avg", 2, jnp.int8),
], ids=str)
def test_pool_plain_matches_pallas_kernel_at_vector_widths(shape, op, k,
                                                           dtype):
    n, h, w, c = shape
    x = kc.pool_case(0, h, w, c, dtype, batch=n)
    assert tpk.pool_plan(shape, torch.float32 if dtype == jnp.float32
                         else torch.int8, op, k, 2).form == "vector"
    kernel = jpk.maxpool2d if op == "max" else jpk.avgpool2d
    want = np.asarray(kernel(x, k=k, stride=2))
    got = tpk.windowed_pool_plain(torch.from_numpy(np.array(x)), k=k,
                                  stride=2, op=op).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if op == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("k", [2, 3])
def test_max_pool_plain_propagates_nan_as_the_reference(k):
    x = np.random.default_rng(0).standard_normal((2, 9, 7, 8), np.float32)
    x[1, 3, 2, 5] = np.nan  # one tap of window (1, 1, 0 or 1) in channel 5
    want = np.asarray(jpk.maxpool2d(jnp.asarray(x), k=k, stride=2))
    got = tpk.windowed_pool_plain(torch.from_numpy(x), k=k, stride=2,
                                  op="max").numpy()
    assert np.isnan(want).sum() >= 1
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got, want)
