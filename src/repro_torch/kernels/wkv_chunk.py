"""zol (rnn_lm): the RWKV-6 chunked WKV recurrence in one kernel.

Replaces the TPU kernel ``src/repro/kernels/wkv_chunk.py::_kernel`` (its
``pl.pallas_call`` at ``wkv_chunk.py:86``); the CUDA kernel is
``csrc/wkv_chunk.cu``, whose header says what bounds it on the H100 and how
its design answers that.  One block per (batch, head) walks the chunks in
order with the (N, N) state in shared memory, reading r, k, v and lw in
their (B, S, H, N) layout in place, and emits the output and the final
state.  S must be a whole number of chunks, as in the reference; the model
(``models/rwkv.py::time_mix``) zero-pads it.

:func:`wkv_chunk` is the wrapper: CPU tensors run the plain version
(:func:`~repro_torch.kernels.ref.wkv_chunk_ref`), CUDA tensors launch the
kernel (``wkv_chunk.launches`` counts the launches).  A head size and chunk
whose working set exceeds a block's shared memory is refused on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, runs_plain
from repro_torch.kernels.ref import wkv_chunk_ref

SMEM_MAX = 232448  # the shared memory one block may use on the H100
_INT32_MAX = 2**31 - 1


def smem_bytes(n: int, chunk: int) -> int:
    """Shared memory of one block (``smem_floats`` in csrc/wkv_chunk.cu):
    the (N, N) state, six (chunk, N + 1) tiles, A (chunk, chunk + 1), the
    bonus row and u."""
    return 4 * (n * n + 6 * chunk * (n + 1) + chunk * (chunk + 1) + chunk
                + n)


def _launch(r, k, v, lw, u, s0, chunk):
    b, s_len, h, n = r.shape
    if smem_bytes(n, chunk) > SMEM_MAX:
        raise ValueError(f"head size {n} with chunk {chunk} needs "
                         f"{smem_bytes(n, chunk)} bytes of shared memory, "
                         f"over the block's {SMEM_MAX}")
    if r.numel() > _INT32_MAX or b * h > _INT32_MAX:
        raise ValueError("operands exceed the kernel's 32-bit indexing")
    r, k, v, lw, u, s0 = (t.float().contiguous()
                          for t in (r, k, v, lw, u, s0))
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw)):
        check_operand(t, name, torch.float32, (b, s_len, h, n))
    check_operand(u, "u", torch.float32, (h, n))
    check_operand(s0, "s0", torch.float32, (b, h, n, n))
    out = torch.empty_like(r)
    s_final = torch.empty_like(s0)
    with torch.cuda.device(r.device):
        status = build.lib().marvel_wkv_chunk(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), s0.data_ptr(), out.data_ptr(), s_final.data_ptr(),
            b, s_len, h, n, chunk, build.stream_ptr(r.device))
    build.check("wkv_chunk", status)
    return out, s_final


def wkv_chunk(r, k, v, lw, u, s0, chunk=64):
    """r, k, v, lw: (B, S, H, N) f32 (lw the log-decay, < 0); u: (H, N);
    s0: (B, H, N, N) -> (out (B, S, H, N) f32, s_final (B, H, N, N) f32)."""
    if not (r.shape == k.shape == v.shape == lw.shape):
        raise ValueError(f"r, k, v, lw must share one shape; got "
                         f"{[tuple(t.shape) for t in (r, k, v, lw)]}")
    if chunk < 1 or r.shape[1] % chunk:
        raise ValueError(f"S = {r.shape[1]} must be a positive multiple of "
                         f"chunk = {chunk}")
    if runs_plain(r, k, v, lw, u, s0):
        return wkv_chunk_ref(r, k, v, lw, u, s0, chunk)
    out = _launch(r, k, v, lw, u, s0, chunk)
    wkv_chunk.launches += 1
    return out


wkv_chunk.launches = 0
