// fusedmac: GEMM with the folded bias/BN/residual/act epilogue fused, on
// f32 or bf16 operands with f32 sums.
//
// Replaces the TPU kernel src/repro/kernels/matmul_epilogue.py::_kernel
// (pl.pallas_call at matmul_epilogue.py:105).
//
//   out[m, n] = act(sum_k x[m, k] * w[k, n] * es[n] + eb[n] [+ res[m, n]])
//
// Bound on the H100: at ResNet50's shapes (K <= 2048, M = 4B..225B rows) a
// full-f32 GEMM is at 2*M*N*K / 67 TFLOP/s against the bytes of x, w, the
// residual and the output at 3.35 TB/s; the small-M late stages and the
// N = 2 head are bound by reading w.  A bf16 LM's decode step (M = a few
// slots) is bound by reading w; its prefill (M = B*S) by the operations.
// Design: a classic shared-memory tiled GEMM in full f32 FMA (no TF32, so
// the sums stay at f32 precision): each 256-thread block owns a 64x64
// output tile, stages 64x16 tiles of x and 16x64 tiles of w in shared
// memory, and each thread keeps a 4x4 register tile of accumulators.  The
// operands are read in their own type: a bf16 operand is converted to f32
// while it is staged (exactly), so the sums, the epilogue and the result are
// bit for bit those of the same values through the f32 path, and a bf16
// weight is never copied to f32 in device memory.  The residual may be f32
// or bf16 too.  Ragged M, N and K are masked with zero fill, so the wrapper
// needs no padded copies.  The epilogue runs on the register tile and the
// f32 output is written once.
//
// Split-K: the late stages and the head have too few 64x64 tiles to fill
// 132 SMs (the head is one tile walking K = 2048 alone).  The wrapper then
// asks for `splits` slices of K: each block sums its slice into a f32
// workspace, and a second kernel adds the slices in a fixed order (so the
// result does not vary from run to run) and applies the epilogue.  Tensor
// cores (wgmma on TF32/bf16) and TMA pipelining are later work.
#include <cuda_bf16.h>

#include <cstdint>

#include "epilogue.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T, typename R>
__global__ void __launch_bounds__(THREADS)
matmul_epilogue_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ es,
                       const float* __restrict__ eb,
                       const R* __restrict__ res, float* __restrict__ out,
                       float* __restrict__ ws, int M, int N, int K,
                       int k_per_split, int act) {
  __shared__ float As[BK][BM];  // x tile, transposed: As[k][m]
  __shared__ float Bs[BK][BN];  // w tile: Bs[k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      int e = tid + l * THREADS;
      int r = e / BK, c = e % BK;
      int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < k_end) ? ld(x + (size_t)gm * K + gk) : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < (BK * BN) / THREADS; ++l) {
      int e = tid + l * THREADS;
      int r = e / BN, c = e % BN;
      int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < k_end && gn < N) ? ld(w + (size_t)gk * N + gn) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      size_t idx = (size_t)gm * N + gn;
      if (ws != nullptr)  // split-K: this slice's partial sum
        ws[(size_t)blockIdx.z * M * N + idx] = acc[i][j];
      else
        out[idx] = marvel::epilogue(acc[i][j], es[gn], eb[gn], res, idx, act);
    }
  }
}

// split-K second pass: the slices summed in order 0..splits-1, then the
// epilogue
template <typename R>
__global__ void splitk_epilogue_kernel(const float* __restrict__ ws,
                                       int splits,
                                       const float* __restrict__ es,
                                       const float* __restrict__ eb,
                                       const R* __restrict__ res,
                                       float* __restrict__ out, int M, int N,
                                       int act) {
  size_t total = (size_t)M * N;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float acc = ws[i];
  for (int s = 1; s < splits; ++s) acc = __fadd_rn(acc, ws[(size_t)s * total + i]);
  int n = (int)(i % N);
  out[i] = marvel::epilogue(acc, es[n], eb[n], res, i, act);
}

template <typename T, typename R>
int launch(const void* xv, const void* wv, const float* es, const float* eb,
           const void* resv, float* out, float* ws, int M, int N, int K,
           int splits, int k_per_split, int act, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  const R* res = static_cast<const R*>(resv);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  if (splits <= 1) {
    matmul_epilogue_kernel<T, R><<<grid, THREADS, 0, s>>>(
        x, w, es, eb, res, out, nullptr, M, N, K, K, act);
    return (int)cudaGetLastError();
  }
  matmul_epilogue_kernel<T, R><<<grid, THREADS, 0, s>>>(
      x, w, es, eb, res, out, ws, M, N, K, k_per_split, act);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  size_t total = (size_t)M * N;
  unsigned blocks = (unsigned)((total + 255) / 256);
  splitk_epilogue_kernel<R><<<blocks, 256, 0, s>>>(ws, splits, es, eb, res,
                                                   out, M, N, act);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, K), w: (K, N), both f32 or both bf16 (x_bf16); res: (M, N) f32 or
// bf16 (res_bf16) or null; es, eb: (N,) f32; out: (M, N) f32.  splits > 1
// needs ws: a (splits, M, N) f32 workspace; k_per_split is a multiple of BK
// with splits * k_per_split >= K.
extern "C" int marvel_matmul_epilogue(const void* x, const void* w,
                                      const float* es, const float* eb,
                                      const void* res, float* out, float* ws,
                                      int M, int N, int K, int splits,
                                      int k_per_split, int act, int x_bf16,
                                      int res_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (x_bf16) {
    if (res_bf16)
      return launch<bf16, bf16>(x, w, es, eb, res, out, ws, M, N, K, splits,
                                k_per_split, act, s);
    return launch<bf16, float>(x, w, es, eb, res, out, ws, M, N, K, splits,
                               k_per_split, act, s);
  }
  if (res_bf16)
    return launch<float, bf16>(x, w, es, eb, res, out, ws, M, N, K, splits,
                               k_per_split, act, s);
  return launch<float, float>(x, w, es, eb, res, out, ws, M, N, K, splits,
                              k_per_split, act, s);
}
