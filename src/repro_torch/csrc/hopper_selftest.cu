// Standalone proof of hopper.cuh: one warpgroup multiplies a 64x64 bf16 A
// by a 64xN bf16 B, loaded by TMA with 128-byte swizzle, in four k16
// wgmma steps into f32 registers, and writes the 64xN product.  Each mode
// is one operand arrangement the tensor-core kernels use, so a wrong
// descriptor field (LBO, SBO, the swizzle, the transpose immediates) or a
// wrong fragment map shows here as wrong numbers on random data:
//
//   mode 0: A K-major in shared memory, B MN-major, n128 (the GEMM's wgmma
//           form: x K-major, w read from its (K, N) layout);
//   mode 1: A from registers, B MN-major, n128 (flash attention's P V at
//           d = 128);
//   mode 2: A K-major, B K-major, n64 (flash attention's q k^T);
//   mode 3: A MN-major, B K-major, n8 (the GEMM's decode form at M <= 8:
//           w^T as A, x as B);
//   mode 4: the same at n16 (M <= 16);
//   mode 5: A from registers, B MN-major, n64 (P V at d = 64).
//
// a: (64, 64) row-major, read as A[m][k] (mode 3, 4: as A[k][m], so A is
// MN-major); b: (64, N) row-major read as B[k][n] (modes 0, 1, 5: MN-major)
// or (N, 64) read as B[n][k] (modes 2, 3, 4: K-major); out: (64, N) f32.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

template <int N, int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db) {
  if constexpr (N == 8) wgmma_m64n8k16_ss<TA, TB>(d, da, db);
  if constexpr (N == 16) wgmma_m64n16k16_ss<TA, TB>(d, da, db);
  if constexpr (N == 64) wgmma_m64n64k16_ss<TA, TB>(d, da, db);
  if constexpr (N == 128) wgmma_m64n128k16_ss<TA, TB>(d, da, db);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_m64n64k16_rs<1>(d, a, db);
  if constexpr (N == 128) wgmma_m64n128k16_rs<1>(d, a, db);
}

constexpr int A_BYTES = 64 * 64 * 2;

template <int N, int MODE>
__global__ void __launch_bounds__(128)
selftest_kernel(const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap bmap,
                const bf16* __restrict__ a, float* __restrict__ out) {
  constexpr bool RS = MODE == 1 || MODE == 5;
  constexpr bool A_MN = MODE == 3 || MODE == 4;
  constexpr bool B_MN = MODE == 0 || MODE == 1 || MODE == 5;
  constexpr int B_BYTES = N * 64 * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* As = align1024(smem_raw);
  uint8_t* Bs = As + A_BYTES;
  __shared__ uint64_t bar;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;

  if (tid == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar, (RS ? 0 : A_BYTES) + B_BYTES);
    if (!RS) tma_load(As, &amap, &bar, 0, 0);
    if (B_MN) {
      for (int h = 0; h < N / 64; ++h)
        tma_load(Bs + h * 8192, &bmap, &bar, 64 * h, 0);
    } else {
      tma_load(Bs, &bmap, &bar, 0, 0);
    }
  }

  // register A: the m64k16 fragment of each k16 step, straight from a
  uint32_t af[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int r0 = 16 * warp + g, k0 = 16 * kk + 2 * c;
    auto at = [&](int r, int k) { return __bfloat162float(a[r * 64 + k]); };
    af[kk][0] = pack_bf16(at(r0, k0), at(r0, k0 + 1));
    af[kk][1] = pack_bf16(at(r0 + 8, k0), at(r0 + 8, k0 + 1));
    af[kk][2] = pack_bf16(at(r0, k0 + 8), at(r0, k0 + 9));
    af[kk][3] = pack_bf16(at(r0 + 8, k0 + 8), at(r0 + 8, k0 + 9));
  }
  mbar_wait(&bar, 0);

  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.0f;
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = B_MN ? mnmajor_desc(Bs + kk * 2048, 8192)
                             : kmajor_desc(Bs + kk * 32);
    if constexpr (RS) {
      mma_rs<N>(d, af[kk], db);
    } else {
      const uint64_t da = A_MN ? mnmajor_desc(As + kk * 2048, 8192)
                               : kmajor_desc(As + kk * 32);
      mma_ss<N, A_MN ? 1 : 0, B_MN ? 1 : 0>(d, da, db);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);

#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        out[(16 * warp + g + 8 * h) * N + 8 * j + 2 * c + e] =
            d[4 * j + 2 * h + e];
}

template <int N, int MODE>
int run(const void* a, const void* b, float* out, cudaStream_t s) {
  constexpr bool B_MN = MODE == 0 || MODE == 1 || MODE == 5;
  CUtensorMap amap, bmap;
  const cuuint64_t adims[2] = {64, 64}, astr[1] = {128};
  const cuuint32_t abox[2] = {64, 64};
  int err = bf16_map(&amap, a, 2, adims, astr, abox);
  if (err) return err;
  if (B_MN) {  // (64 k, N) row-major: boxes of 64 n x 64 k
    const cuuint64_t dims[2] = {N, 64}, str[1] = {N * 2};
    const cuuint32_t box[2] = {64, 64};
    err = bf16_map(&bmap, b, 2, dims, str, box);
  } else {  // (N, 64 k) row-major: one box of N rows
    const cuuint64_t dims[2] = {64, N}, str[1] = {128};
    const cuuint32_t box[2] = {64, N};
    err = bf16_map(&bmap, b, 2, dims, str, box);
  }
  if (err) return err;
  const size_t smem = 1024 + A_BYTES + N * 64 * 2;
  selftest_kernel<N, MODE><<<1, 128, smem, s>>>(
      amap, bmap, static_cast<const bf16*>(a), out);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0..5 as in the header; out holds 64 x N f32, N = 128, 128, 64, 8,
// 16, 64 for modes 0..5
extern "C" int marvel_wgmma_selftest(const void* a, const void* b,
                                     float* out, int mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: return run<128, 0>(a, b, out, s);
    case 1: return run<128, 1>(a, b, out, s);
    case 2: return run<64, 2>(a, b, out, s);
    case 3: return run<8, 3>(a, b, out, s);
    case 4: return run<16, 4>(a, b, out, s);
    case 5: return run<64, 5>(a, b, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
