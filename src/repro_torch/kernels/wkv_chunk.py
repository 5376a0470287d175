"""zol (rnn_lm): the RWKV-6 chunked WKV recurrence in one kernel launch.

Replaces the TPU kernel ``src/repro/kernels/wkv_chunk.py::_kernel`` (its
``pl.pallas_call`` at ``wkv_chunk.py:86``); the CUDA kernel is
``csrc/wkv_chunk.cu``, whose header says what bounds it on the H100 and how
its design answers that.  The TPU kernel walks the chunks of a (batch,
head) in order with the state in VMEM; the CUDA kernel runs one block per
(batch, head, chunk), each computing its chunk's intra-chunk output and
state contribution from the chunk alone, and chains only the state from
chunk to chunk, so a prefill at B = 4, S = 512, H = 32 runs 1024 blocks
instead of 128.  It reads r, k, v and lw in their (B, S, H, N) layout in
place and emits the output and the final state.  S must be a whole number
of chunks, as in the reference; the model (``models/rwkv.py::time_mix``)
zero-pads it.

:func:`wkv_chunk` is the wrapper: CPU tensors run the plain version
(:func:`~repro_torch.kernels.ref.wkv_chunk_ref`), CUDA tensors launch the
kernel (``wkv_chunk.launches`` counts the launches).  A head size and chunk
the kernel does not take (:func:`kernel_takes`) is refused on the card.
The launch allocates the published states' workspace with ``torch.empty``;
the chain's ticket and flags live in one int32 buffer a device, zero
between launches (each launch leaves it zero), so launches that share it
must be ordered on one stream, as every launch of the port is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, runs_plain
from repro_torch.kernels.ref import wkv_chunk_ref

SMEM_MAX = 232448  # the shared memory one block may use on the H100
SUB = 16  # tokens of a sub-chunk (csrc/wkv_chunk.cu)
_INT32_MAX = 2**31 - 1


def kernel_takes(n: int, chunk: int) -> bool:
    """The shapes the kernel is built for: N one of 8, 16, 32, 64 (a
    template argument, so its loops unroll), the chunk a multiple of 4 and
    chunk * N <= 4096 (one 4 x 4 output tile a thread of 256 covers the
    chunk's output and the (N, N) state)."""
    return n in (8, 16, 32, 64) and chunk > 0 and chunk % 4 == 0 and \
        chunk * n <= 4096


def smem_bytes(n: int, chunk: int) -> int:
    """Shared memory of one block (``layout`` in csrc/wkv_chunk.cu): five
    (chunk, N + 4) tiles (r, v, k, cum and one split level) plus one for
    each further level of the binary split into 16-token sub-chunks, A
    (chunk, chunk + 4) — or the previous state's (N, N + 4) from cum on,
    if larger — then the sub-chunk boundaries' cums, the bonus and u."""
    ld, nsub = n + 4, -(-chunk // SUB)
    lev = (nsub - 1).bit_length()
    tile = chunk * ld
    end = 4 * tile + max(lev - 1, 0) * tile + chunk * (chunk + 4)
    end = max(end, 3 * tile + n * ld)
    return 4 * (end + nsub * n + chunk + n)


_SYNC: dict = {}


def _sync(device, slots: int):
    """The chain's ticket and per-chunk flags on ``device``: int32 zeros,
    at least ``slots`` long, allocated once (grown when a launch needs
    more); every launch leaves them zero."""
    key = device.index if device.index is not None else \
        torch.cuda.current_device()
    buf = _SYNC.get(key)
    if buf is None or buf.numel() < slots:
        buf = torch.zeros(max(slots, 1 << 12), dtype=torch.int32,
                          device=device)
        _SYNC[key] = buf
    return buf


def _launch(r, k, v, lw, u, s0, chunk):
    b, s_len, h, n = r.shape
    if not kernel_takes(n, chunk):
        raise ValueError(f"head size {n} with chunk {chunk} is outside the "
                         f"kernel's shapes (N one of 8, 16, 32, 64, chunk a "
                         f"multiple of 4, chunk * N <= 4096)")
    if smem_bytes(n, chunk) > SMEM_MAX:
        raise ValueError(f"head size {n} with chunk {chunk} needs "
                         f"{smem_bytes(n, chunk)} bytes of shared memory, "
                         f"over the block's {SMEM_MAX}")
    nc = s_len // chunk
    if r.numel() > _INT32_MAX or b * h * nc > _INT32_MAX:
        raise ValueError("operands exceed the kernel's 32-bit indexing")
    # contiguous, and 16-byte aligned for the kernel's cp.async copies
    r, k, v, lw, u, s0 = (
        t if t.data_ptr() % 16 == 0 else t.clone()
        for t in (x.float().contiguous() for x in (r, k, v, lw, u, s0)))
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw)):
        check_operand(t, name, torch.float32, (b, s_len, h, n))
    check_operand(u, "u", torch.float32, (h, n))
    check_operand(s0, "s0", torch.float32, (b, h, n, n))
    out = torch.empty_like(r)
    s_final = torch.empty_like(s0)
    ws = torch.empty((b * h * (nc - 1), n, n), dtype=torch.float32,
                     device=r.device)
    sync = _sync(r.device, 1 + b * h * nc)
    with torch.cuda.device(r.device):
        status = build.lib().marvel_wkv_chunk(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), s0.data_ptr(), out.data_ptr(), s_final.data_ptr(),
            ws.data_ptr() if ws.numel() else None, sync.data_ptr(), b,
            s_len, h, n, chunk, build.stream_ptr(r.device))
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
