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
// result does not vary from run to run) and applies the epilogue.
//
// That CUDA-core form ("fma") runs every f32 GEMM (the CNNs: on tensor
// cores f32 would become TF32, which the reference does not compute) and
// the bf16 shapes the tensor-core forms cannot take (K or N not a multiple
// of 8, a base not 16-byte aligned).  bf16 operands otherwise take one of
// two tensor-core forms (hopper.cuh), chosen by the wrapper's shape
// predicate (kernels/matmul_epilogue.py::gemm_form):
//
//   "wgmma" (the prefill, M > 16): a 128 x BN output tile per block (BN =
//   256 where K is long and those tiles still fill the SMs, else 128; the
//   wrapper's wgmma_tile_n), K in steps of 64 (one 128-byte swizzle row of
//   bf16) through a ring of shared-memory stages.  One producer thread
//   issues the TMA loads: x as a K-major 128x64 box, w read in place from
//   its (K, N) layout as BN / 64 MN-major 64x64 boxes (w is never
//   transposed or copied).  Two consumer warpgroups each run
//   wgmma.m64n{BN}k16 on their 64 rows into f32 registers, one stage's
//   products in flight while the next stage's are issued.  TMA zero-fills
//   ragged M, N and K.  Bound: the operations (2 M N K at 989 TFLOP/s
//   bf16).
//
//   "decode" (M <= 16): bound by reading w once.  A and B swap: each block
//   computes a 64-column strip of out^T = w^T x^T with wgmma.m64n8k16 (n16
//   for M > 8), w^T an MN-major A straight from w's layout, x^T a K-major B
//   (x is row-major), through an 8-stage ring of 9-10 KB stages; split-K
//   spreads the strips over about two waves of the SMs.
//
// Both write the output in bf16 (round to nearest even, in pairs) from the
// f32 epilogue in registers, as the reference writes x.dtype; the split-K
// second pass likewise.  Their sums run in another order than the fma
// form's (wgmma's own order within a k16 step), all in f32.
#include <cuda_bf16.h>

#include <cstdint>

#include "epilogue.cuh"
#include "hopper.cuh"

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

__device__ __forceinline__ void store(float* out, size_t i, float y) {
  out[i] = y;
}
__device__ __forceinline__ void store(__nv_bfloat16* out, size_t i, float y) {
  out[i] = __float2bfloat16_rn(y);
}

// split-K second pass: the slices summed in order 0..splits-1, then the
// epilogue; O is the output type (f32 for the fma form, bf16 for the
// tensor-core forms)
template <typename R, typename O>
__global__ void splitk_epilogue_kernel(const float* __restrict__ ws,
                                       int splits,
                                       const float* __restrict__ es,
                                       const float* __restrict__ eb,
                                       const R* __restrict__ res,
                                       O* __restrict__ out, int M, int N,
                                       int act) {
  size_t total = (size_t)M * N;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float acc = ws[i];
  for (int s = 1; s < splits; ++s) acc = __fadd_rn(acc, ws[(size_t)s * total + i]);
  int n = (int)(i % N);
  store(out, i, marvel::epilogue(acc, es[n], eb[n], res, i, act));
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
  splitk_epilogue_kernel<R, float><<<blocks, 256, 0, s>>>(
      ws, splits, es, eb, res, out, M, N, act);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the tensor-core forms: bf16 operands, f32 sums, bf16 output
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int TC_BK = 64;  // K per stage: one 128-byte swizzle row of bf16

namespace wg {  // the prefill form: two consumer warpgroups, a producer warp
constexpr int BM = 128, THREADS = 288;
constexpr int A_BYTES = BM * TC_BK * 2;  // x: 128 rows of 64 k
constexpr int BOX_B = TC_BK * 64 * 2;    // one w box: 64 k rows of 64 n
// per tile width BN (128 or 256): stages of the ring, blocks an SM
__host__ __device__ constexpr int stages(int bn) { return bn == 128 ? 3 : 4; }
__host__ __device__ constexpr int min_blocks(int bn) {
  return bn == 128 ? 2 : 1;
}
__host__ __device__ constexpr int stage(int bn) {
  return A_BYTES + (bn / 64) * BOX_B;
}
__host__ __device__ constexpr int smem(int bn) {
  return 1024 + stages(bn) * stage(bn) + 2 * stages(bn) * 8;
}
}  // namespace wg

namespace dec {  // the decode form
constexpr int BN = 64, STAGES = 8, THREADS = 256;
constexpr int W_BYTES = TC_BK * BN * 2;  // w: 64 k rows of 64 n
template <int MP>
__host__ __device__ constexpr int stage() {
  return W_BYTES + MP * 128;  // + x: MP rows of 64 k
}
template <int MP>
__host__ __device__ constexpr int smem() {
  return 1024 + STAGES * stage<MP>() + 2 * STAGES * 8;
}
}  // namespace dec

// out[idx], out[idx + 1] (columns n, n + 1) from their f32 sums: the
// epilogue and one bf16 rounding each, or the raw sums into this split's
// workspace slice
template <typename R>
__device__ __forceinline__ void write_pair(bf16* out, float* ws,
                                           const float* es, const float* eb,
                                           const R* res, size_t idx, int n,
                                           float v0, float v1, int act) {
  if (ws != nullptr) {
    *reinterpret_cast<float2*>(ws + idx) = make_float2(v0, v1);
    return;
  }
  const float y0 = marvel::epilogue(v0, es[n], eb[n], res, idx, act);
  const float y1 = marvel::epilogue(v1, es[n + 1], eb[n + 1], res, idx + 1,
                                    act);
  *reinterpret_cast<__nv_bfloat162*>(out + idx) =
      __floats2bfloat162_rn(y0, y1);
}

template <int BN>
__device__ __forceinline__ void mma_wide(float (&acc)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 128)
    hopper::wgmma_m64n128k16_ss<0, 1>(acc, da, db);
  else
    hopper::wgmma_m64n256k16_ss<0, 1>(acc, da, db);
}

// the prefill form: block (blockIdx.x, blockIdx.y) owns the 128 x BN tile
// at (m0, n0) (M tiles fastest, so the blocks of one wave share w's
// column tiles), blockIdx.z its slice of `ips` K stages.  BN = 128: three
// 32 KB stages, two blocks an SM (one's epilogue overlaps the other's
// products); BN = 256: four 48 KB stages, one block an SM, half the
// shared-memory reads of x per product.
template <int BN, typename R>
__global__ void __launch_bounds__(wg::THREADS, wg::min_blocks(BN))
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const float* __restrict__ es, const float* __restrict__ eb,
                  const R* __restrict__ res, bf16* __restrict__ out,
                  float* __restrict__ ws, int M, int N, int K, int ips,
                  int act) {
  using namespace hopper;
  constexpr int STAGES = wg::stages(BN), STAGE = wg::stage(BN);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int m0 = blockIdx.x * wg::BM, n0 = blockIdx.y * BN;
  const int it0 = blockIdx.z * ips;
  const int n_it = min((K + TC_BK - 1) / TC_BK - it0, ips);
  const int role = threadIdx.x / 128;  // 0, 1: consumers, 2: producer

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp releases
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (role == 2) {
    if (threadIdx.x == 256) {
      for (int i = 0; i < n_it; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        uint8_t* a = smem + s * STAGE;
        uint8_t* b = a + wg::A_BYTES;
        const int k0 = (it0 + i) * TC_BK;
        mbar_expect_tx(&full[s], STAGE);
        tma_load(a, &xmap, &full[s], k0, m0);
#pragma unroll
        for (int h = 0; h < BN / 64; ++h)
          tma_load(b + h * wg::BOX_B, &wmap, &full[s], n0 + 64 * h, k0);
      }
    }
    return;
  }

  const int c = role, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  fence_regs(acc);
  // one group of products in flight: stage i's are issued before stage
  // i - 1's are waited for and its buffers released
  for (int i = 0; i < n_it; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* a = smem + s * STAGE + c * 64 * 128;
    const uint8_t* b = smem + s * STAGE + wg::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_wide<BN>(acc, kmajor_desc(a + kk * 32),
                   mnmajor_desc(b + kk * 2048, wg::BOX_B));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  float* wsz = ws == nullptr ? nullptr : ws + (size_t)blockIdx.z * M * N;
  const int r0 = m0 + 64 * c + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (lane % 4);
    if (n >= N) continue;  // N % 8 == 0, so n + 1 < N too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + 8 * h;
      if (m < M)
        write_pair(out, wsz, es, eb, res, (size_t)m * N + n, n,
                   acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], act);
    }
  }
}

// the decode form: block blockIdx.x owns output columns n0..n0+63 of all
// M <= MP rows, blockIdx.z its slice of `ips` K stages; the product runs
// transposed (D = w^T x^T, 64 x MP)
template <int MP, typename R>
__global__ void __launch_bounds__(dec::THREADS)
gemm_decode_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ es, const float* __restrict__ eb,
                   const R* __restrict__ res, bf16* __restrict__ out,
                   float* __restrict__ ws, int M, int N, int K, int ips,
                   int act) {
  using namespace hopper;
  constexpr int STAGE = dec::stage<MP>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + dec::STAGES * STAGE);
  uint64_t* empty = full + dec::STAGES;
  const int n0 = blockIdx.x * dec::BN;
  const int it0 = blockIdx.z * ips;
  const int n_it = min((K + TC_BK - 1) / TC_BK - it0, ips);
  const int role = threadIdx.x / 128;  // 0: producer, 1: consumer

  if (threadIdx.x == 0) {
    for (int s = 0; s < dec::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each consumer warp releases
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (role == 0) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < n_it; ++i) {
        const int s = i % dec::STAGES;
        if (i >= dec::STAGES)
          mbar_wait(&empty[s], ((i / dec::STAGES) - 1) & 1);
        uint8_t* wt = smem + s * STAGE;
        const int k0 = (it0 + i) * TC_BK;
        mbar_expect_tx(&full[s], STAGE);
        tma_load(wt, &wmap, &full[s], n0, k0);
        tma_load(wt + dec::W_BYTES, &xmap, &full[s], k0, 0);
      }
    }
    return;
  }

  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  float acc[MP / 2];
#pragma unroll
  for (int i = 0; i < MP / 2; ++i) acc[i] = 0.0f;
  fence_regs(acc);
  for (int i = 0; i < n_it; ++i) {
    const int s = i % dec::STAGES;
    mbar_wait(&full[s], (i / dec::STAGES) & 1);
    const uint8_t* wt = smem + s * STAGE;
    const uint8_t* xt = wt + dec::W_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = mnmajor_desc(wt + kk * 2048, dec::W_BYTES);
      const uint64_t db = kmajor_desc(xt + kk * 32);
      if constexpr (MP == 8)
        wgmma_m64n8k16_ss<1, 0>(acc, da, db);
      else
        wgmma_m64n16k16_ss<1, 0>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // D's row is the output column n, its column the output row m
  float* wsz = ws == nullptr ? nullptr : ws + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + 16 * warp + lane / 4 + 8 * h;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < MP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * j + 2 * (lane % 4) + e;
        if (m >= M) continue;
        const size_t idx = (size_t)m * N + n;
        const float v = acc[4 * j + 2 * h + e];
        if (wsz != nullptr)
          wsz[idx] = v;
        else
          out[idx] = __float2bfloat16_rn(
              marvel::epilogue(v, es[n], eb[n], res, idx, act));
      }
  }
}

template <typename K>
int set_smem(K kern, int bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// form 1 (wgmma, 128x128 tiles), 3 (wgmma, 128x256 tiles) or 2 (decode);
// x: (M, K), w: (K, N) bf16, K % 8 == 0,
// N % 8 == 0, 16-byte aligned bases; k_per_split a multiple of TC_BK
template <typename R>
int launch_tc(int form, const void* x, const void* w, const float* es,
              const float* eb, const void* resv, bf16* out, float* ws, int M,
              int N, int K, int splits, int k_per_split, int act,
              cudaStream_t s) {
  using hopper::bf16_map;
  const R* res = static_cast<const R*>(resv);
  float* wsp = splits > 1 ? ws : nullptr;
  const int ips = k_per_split / TC_BK;
  CUtensorMap xmap, wmap;
  const cuuint64_t wdims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t wstr[1] = {(cuuint64_t)N * 2};
  const cuuint32_t wbox[2] = {64, TC_BK};
  int err = bf16_map(&wmap, w, 2, wdims, wstr, wbox);
  if (err) return err;
  const cuuint64_t xdims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t xstr[1] = {(cuuint64_t)K * 2};
  if (form == 1 || form == 3) {
    const cuuint32_t xbox[2] = {TC_BK, wg::BM};
    err = bf16_map(&xmap, x, 2, xdims, xstr, xbox);
    if (err) return err;
    const int bn = form == 1 ? 128 : 256;
    auto kern = form == 1 ? gemm_wgmma_kernel<128, R>
                          : gemm_wgmma_kernel<256, R>;
    err = set_smem(kern, wg::smem(bn));
    if (err) return err;
    dim3 grid((M + wg::BM - 1) / wg::BM, (N + bn - 1) / bn, splits);
    kern<<<grid, wg::THREADS, wg::smem(bn), s>>>(xmap, wmap, es, eb, res,
                                                 out, wsp, M, N, K, ips, act);
  } else {
    const int mp = M <= 8 ? 8 : 16;
    const cuuint32_t xbox[2] = {TC_BK, (cuuint32_t)mp};
    err = bf16_map(&xmap, x, 2, xdims, xstr, xbox);
    if (err) return err;
    dim3 grid((N + dec::BN - 1) / dec::BN, 1, splits);
    if (mp == 8) {
      auto kern = gemm_decode_kernel<8, R>;
      err = set_smem(kern, dec::smem<8>());
      if (err) return err;
      kern<<<grid, dec::THREADS, dec::smem<8>(), s>>>(
          xmap, wmap, es, eb, res, out, wsp, M, N, K, ips, act);
    } else {
      auto kern = gemm_decode_kernel<16, R>;
      err = set_smem(kern, dec::smem<16>());
      if (err) return err;
      kern<<<grid, dec::THREADS, dec::smem<16>(), s>>>(
          xmap, wmap, es, eb, res, out, wsp, M, N, K, ips, act);
    }
  }
  err = (int)cudaGetLastError();
  if (err != 0 || splits <= 1) return err;
  size_t total = (size_t)M * N;
  unsigned blocks = (unsigned)((total + 255) / 256);
  splitk_epilogue_kernel<R, bf16><<<blocks, 256, 0, s>>>(ws, splits, es, eb,
                                                         res, out, M, N, act);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, K), w: (K, N), both f32 or both bf16 (x_bf16); res: (M, N) f32 or
// bf16 (res_bf16) or null; es, eb: (N,) f32.  form 0 (fma): out is (M, N)
// f32, k_per_split a multiple of BK; form 1 or 3 (wgmma, 128x128 or 128x256
// tiles) or 2 (decode, M <= 16): bf16 operands only, K % 8 == 0, N % 8 ==
// 0, 16-byte aligned x and w, out (M, N) bf16, k_per_split a multiple of
// 64.  splits > 1 needs ws: a (splits, M, N) f32 workspace, with splits *
// k_per_split >= K.
extern "C" int marvel_matmul_epilogue(const void* x, const void* w,
                                      const float* es, const float* eb,
                                      const void* res, void* out, float* ws,
                                      int M, int N, int K, int splits,
                                      int k_per_split, int act, int x_bf16,
                                      int res_bf16, int form, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (form != 0) {
    if (!x_bf16 || form > 3 || (form == 2 && M > 16) || K % 8 || N % 8)
      return (int)cudaErrorInvalidValue;
    bf16* o = static_cast<bf16*>(out);
    if (res_bf16)
      return launch_tc<bf16>(form, x, w, es, eb, res, o, ws, M, N, K, splits,
                             k_per_split, act, s);
    return launch_tc<float>(form, x, w, es, eb, res, o, ws, M, N, K, splits,
                            k_per_split, act, s);
  }
  float* o = static_cast<float*>(out);
  if (x_bf16) {
    if (res_bf16)
      return launch<bf16, bf16>(x, w, es, eb, res, o, ws, M, N, K, splits,
                                k_per_split, act, s);
    return launch<bf16, float>(x, w, es, eb, res, o, ws, M, N, K, splits,
                               k_per_split, act, s);
  }
  if (res_bf16)
    return launch<float, bf16>(x, w, es, eb, res, o, ws, M, N, K, splits,
                               k_per_split, act, s);
  return launch<float, float>(x, w, es, eb, res, o, ws, M, N, K, splits,
                              k_per_split, act, s);
}
