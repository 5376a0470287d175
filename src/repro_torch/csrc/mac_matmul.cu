// mac: int8 x int8 -> int32 GEMM with the per-column dequant scale.
//
// Replaces the TPU kernel src/repro/kernels/mac_matmul.py::_kernel
// (pl.pallas_call at mac_matmul.py:58).
//
//   out[m, n] = f32(acc[m, n]) * scale[n],
//   acc[m, n] = sum_k x[m, k] * w[k, n]            (int32, exact)
//
// x is (M, K) and w (K, N), both int8 row-major; out is (M, N) f32.  The
// sums are exact in any order, so the result is bit for bit the plain
// version's.
//
// Bound on the H100: at the decode shapes (M <= 8) the weight bytes, K * N
// int8 read once (4.4 us for rwkv6-1.6b's 2048 x 7168); at the prefill
// shapes the int8 operations at 1,979 TOP/s on the tensor cores.  The
// GEMM is the 1x1 conv of a 1 x M image of K channels, so it runs the
// conv's kernel (fused_conv.cu, imma.cuh): int8 tensor-core tiles
// (mma.sync m16n8k32), a cp.async ring of 64-deep K steps with x as the
// k-contiguous A and w's column quads built in registers from its staged
// (K, N) rows, split K summed in the same launch on the tile counters, and
// the epilogue f32(acc) * scale.  Decode rows take the 16-row tile with its
// rows past M empty (the weights are read once either way); the tile and
// the split of K come from kernels/mac_matmul.py::mac_plan.  A ragged K or
// N is zero fill at the copies (4-byte copies or byte loads where a row is
// not a multiple of 16 bytes), never a padded copy.
#include <cuda_runtime.h>

#include <cstdint>

#include "imma.cuh"

// x: (M, K) int8, w: (K, N) int8, scale: (N,) f32, out: (M, N) f32.
// tile: an index of kernels/fused_conv.py::IMMA_TILES; splits > 1 needs ws,
// (tiles * splits * BM * BN) int32, and counters, one zeroed int32 a tile;
// k_per_split is a multiple of 64 with splits * k_per_split >= K.  K *
// 127^2 must fit int32 (K <= 133,000).
extern "C" int marvel_mac_matmul_int8(const int8_t* x, const int8_t* w,
                                      const float* scale, float* out,
                                      int* ws, int* counters, int M, int K,
                                      int N, int tile, int splits,
                                      int k_per_split, void* stream) {
  // one image of 1 x M pixels, K channels; no bias, residual or act
  const imma::Conv p{x, w, scale, /*eb=*/nullptr, /*res=*/nullptr, out, ws,
                     counters,
                     /*N, H, W, Cin=*/1, 1, M, K,
                     /*KH, KW, Cout, Ho, Wo=*/1, 1, N, 1, M,
                     /*stride, top, left=*/1, 0, 0,
                     tile, splits, k_per_split, /*act=*/0};
  return imma::launch(p, (cudaStream_t)stream);
}
