"""The fused residual-add + RMSNorm kernel's launch plan
(``repro_torch.kernels.residual_rmsnorm.norm_plan``), on the CPU.

The plan is a pure function and the wrapper launches what it says, so the
geometry the CUDA kernel (``csrc/residual_rmsnorm.cu``) is given is held
here: every norm launch shape of the LM paths (qwen3-8b's d_model 4096,
hymba-1.5b's 1600, whisper-tiny's 384 and the next slices' 6144, at a
decode step's 8 rows and the prefills' 1792, 2048 and 6000, with the scale
in bf16 as the models pass it or in f32) takes the ``rows`` form, its
threads and vectors cover the row and no thread holds more than the
register budget; a width that is not a multiple of the 16-byte vector, one
beyond the rows form's registers, and an unaligned row take the two-pass
``scalar`` form, one block a row.  The kernel itself is held against its
plain version on the card (``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import residual_rmsnorm as rr

BF16, F32 = torch.bfloat16, torch.float32

CASES = [dict(rows=r, d=d, scale=s, form="rows")
         for d in (384, 1600, 4096, 6144) for r in (8, 1792, 2048, 6000)
         for s in (BF16, F32)]
CASES += [
    # the widest rows the register form holds, in either row type
    dict(rows=2048, d=8192, form="rows"),
    dict(rows=8, d=8192, dtype=F32, scale=F32, form="rows"),
    dict(rows=130, d=257, form="scalar"),
    dict(rows=130, d=257, dtype=F32, scale=F32, form="scalar"),
    dict(rows=8, d=8200, form="scalar"),
    dict(rows=2048, d=4096, aligned=False, form="scalar"),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={str(v).replace('torch.', '')}" for k, v in c.items()))
def test_norm_plan(case):
    c = dict(dtype=BF16, scale=BF16, aligned=True) | case
    p = rr.norm_plan(c["rows"], c["d"], c["dtype"], c["scale"], c["aligned"])
    assert p.form == c["form"] and p.cluster == 1
    if p.form == "scalar":
        assert (p.threads, p.rows_per_block, p.grid) == (
            rr.SCALAR_THREADS, 1, c["rows"])
        return
    row_bytes = c["d"] * c["dtype"].itemsize
    t, rpb = p.threads, p.rows_per_block
    assert t & (t - 1) == 0 and rr.ROWS_MIN_GROUP <= t <= rr.ROWS_MAX_THREADS
    assert 1 <= rpb and t * rpb <= rr.ROWS_MAX_THREADS
    # the group's vectors cover the row, the last round not wholly idle
    assert t * p.vecs * rr.VECTOR_BYTES >= row_bytes
    assert t * (p.vecs - 1) * rr.VECTOR_BYTES < row_bytes
    assert 1 <= p.vecs <= rr.VECS_MAX
    # the blocks cover the rows, none wholly idle
    assert p.grid * rpb >= c["rows"] > (p.grid - 1) * rpb


@pytest.mark.parametrize("rows", [8, 128, 2048])
def test_norm_plan_at_the_6144_wide_lms(rows):
    """internvl2-26b's and granite-34b's rows of 6144 (a decode step, the
    2-layer cut's prefill, a B = 4, S = 512 prefill): the rows form, a
    group of 256 threads a row, 3 vectors each, one row a block."""
    p = rr.norm_plan(rows, 6144, BF16, BF16, True)
    assert (p.form, p.threads, p.rows_per_block, p.vecs, p.grid,
            p.cluster) == ("rows", 256, 1, 3, rows, 1)


def test_norm_plan_constants_match_the_kernel():
    """The plan's limits and form codes are the CUDA source's."""
    src = (Path(rr.__file__).parents[1] / "csrc"
           / "residual_rmsnorm.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("ROWS_MAX_THREADS") == rr.ROWS_MAX_THREADS
    assert const("ROWS_MAX_NV") == rr.VECS_MAX
    assert const("SCALAR_THREADS") == rr.SCALAR_THREADS
    forms = re.search(r"enum Form \{ SCALAR = (\d+), ROWS = (\d+) \}", src)
    assert (int(forms[1]), int(forms[2])) == (rr.FORM_CODES["scalar"],
                                              rr.FORM_CODES["rows"])
