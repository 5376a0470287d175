"""The decomposition of the port's wkv kernel, on the CPU, before any card.

``csrc/wkv_chunk.cu`` splits the chunked WKV recurrence into (a) each
chunk's intra-chunk output, bonus, decay and state contribution, computed
from the chunk alone with the decay between two tokens of different
16-token sub-chunks factored through a boundary token, (b) the scan of the
chunk states, and (c) the from-state term.  ``chip_smoke.wkv_split_model``
mirrors that arithmetic in plain PyTorch; here it is held against the
reference's Pallas kernel ``repro.kernels.wkv_chunk.wkv_chunk`` (interpret
mode, as the reference's own tests run it) on the conformance grid's wkv
cases, the rwkv6 head at chunk 64 (both split levels), and a decay strong
enough that exp(-cum) over a chunk overflows f32.  Inputs are made with
numpy from a seed.

Tolerance: the reference conformance runner's ``tol_from_acc(float32, S,
slack=8)``, as for the plain version (``test_torch_kernels.py``): both
sides sum in f32 in other orders, and each factored decay carries two exp
roundings instead of one, a few ulp of a term.  The chunk plan of the
wrapper (the kernel's thread layout and shared memory) is checked here
too, on every model's head size and chunk.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
import kernel_cases as kc  # noqa: E402
from repro.kernels import wkv_chunk as jwk  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.kernels import wkv_chunk as twk  # noqa: E402

CASES = [dict(case, decay=0.0) for name, case in kc.GRID if name == "wkv_chunk"]
CASES += [
    dict(s=128, heads=2, n=16, chunk=64, decay=0.0),  # two split levels
    # strong decay: exp(-cum) over a chunk would overflow f32
    dict(b=2, s=128, heads=2, n=16, chunk=64, decay=2.0),
]


def inputs(seed=0, b=1, s=32, heads=2, n=8, chunk=16, decay=0.0):
    """r, k, v (0.3 N(0, 1)), lw = -exp(0.3 N(0, 1) + decay), u and a
    non-zero start state, f32, from numpy."""
    rng = np.random.default_rng(seed)
    shape = (b, s, heads, n)
    r, k, v = (0.3 * rng.standard_normal(shape, np.float32)
               for _ in range(3))
    lw = -np.exp(0.3 * rng.standard_normal(shape, np.float32)
                 + np.float32(decay))
    u = 0.3 * rng.standard_normal((heads, n), np.float32)
    s0 = 0.3 * rng.standard_normal((b, heads, n, n), np.float32)
    return (r, k, v, lw.astype(np.float32), u, s0), chunk


@pytest.mark.parametrize("case", CASES, ids=str)
def test_split_model_matches_pallas_kernel(case):
    args, chunk = inputs(**case)
    want, want_s = jwk.wkv_chunk(*(jnp.asarray(a) for a in args),
                                 chunk=chunk)
    got, got_s = chip_smoke.wkv_split_model(
        *(torch.from_numpy(a) for a in args), chunk)
    assert got.dtype == got_s.dtype == torch.float32
    assert torch.isfinite(got).all() and torch.isfinite(got_s).all()
    tol = kc.tol_from_acc(jnp.float32, args[0].shape[1], slack=8.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **tol)


@pytest.mark.parametrize("chunk", [8, 16, 48, 64, 128])
def test_split_covers_every_pair_once(chunk):
    """The direct pairs (inside a sub-chunk) and the split's blocks (upper
    rows x lower rows of a node) cover every s < t exactly once, and each
    block's boundary token lies between its columns and its rows."""
    sub, cover = twk.SUB, np.zeros((chunk, chunk), np.int64)
    for t in range(chunk):
        for s in range(t):
            cover[t, s] += t // sub == s // sub
    nsub = -(-chunk // sub)
    for d in range(1, (nsub - 1).bit_length() + 1):
        for base in range(0, nsub, 1 << d):
            mid = base + (1 << (d - 1))
            if mid >= nsub:
                break
            lo, hi = sub * mid, min(sub * (base + (1 << d)), chunk)
            assert sub * base <= lo - 1 < lo <= hi  # s <= e < t
            cover[lo:hi, sub * base:lo] += 1
    np.testing.assert_array_equal(cover, np.tril(np.ones_like(cover), -1))


def test_kernel_takes_every_model_head_within_two_blocks_an_sm():
    """Every rwkv config's head size and its smoke variant's, at the run
    config's chunk and at the CPU tests' chunk of 8, is a shape the kernel
    takes, in at most half an SM's shared memory (228 KB, 1 KB of it
    reserved a block), so an SM holds two blocks; the shapes it does not
    take are refused before a launch."""
    chunks = (RunConfig(seq_len=1, global_batch=1).wkv_chunk, 8)
    seen = set()
    for arch in registry.ARCH_IDS:
        cfg = registry.get_arch(arch)
        if cfg.family == "rwkv":
            for c in (cfg, registry.smoke_variant(cfg)):
                seen.update((c.rwkv_head_dim, ch) for ch in chunks)
    assert (64, 64) in seen and (32, 8) in seen
    for n, chunk in sorted(seen):
        assert twk.kernel_takes(n, chunk), (n, chunk)
        assert twk.smem_bytes(n, chunk) <= (228 << 10) // 2 - 1024, (n, chunk)
    assert twk.smem_bytes(64, 64) == 4 * (4 * 64 * 68 + 64 * 68 + 64 * 68
                                          + 4 * 64 + 64 + 64)
    assert not twk.kernel_takes(128, 64) and not twk.kernel_takes(64, 128)
    assert twk.kernel_takes(16, 256)
    assert twk.smem_bytes(16, 256) > twk.SMEM_MAX
