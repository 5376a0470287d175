// fusedmac: GEMM with the folded bias/BN/residual/act epilogue fused, on
// f32 or bf16 operands with f32 sums.
//
// Replaces the TPU kernel src/repro/kernels/matmul_epilogue.py::_kernel
// (pl.pallas_call at matmul_epilogue.py:105).
//
//   out[m, n] = act(sum_k x[m, k] * w[k, n] * es[n] + eb[n] [+ res[m, n]])
//
// Bound on the H100: at the CNNs' shapes (batch 8: M = 8..8192, K =
// 16..2048, N = 2..2048) the least time is 0.01-2 us, from the f32
// operations (2*M*N*K at 67 TFLOP/s outside the tensor cores) or the bytes
// (x, w, the residual and the output at 3.35 TB/s); every launch is far
// above that, so what bounds the CUDA-core form ("fma") is latency: the
// launch itself, each global load's round trip, and, where the tiles are
// too few for the SMs, the split of K and the sum of its slices.  A bf16
// LM's decode step (M = a few slots) is bound by reading w; its prefill
// (M = B*S) by the operations.
//
// The fma form's design against that latency:
//   - one table of seven tiles, picked with the split of K by the wrapper
//     from the shape (kernels/matmul_epilogue.py::fma_plan, a cost model
//     fitted to every tile and split timed on the card): BM x 64 output
//     tiles, BM = 128, 64, 32 or 16, each thread an 8x4, 4x4, 2x4 or 1x4
//     register tile, so the small-M late stages and the heads do not pad a
//     64-row tile, and fewer rows a thread where the tiles are few;
//   - a cp.async ring of 3 to 8 stages of 32- or 16-deep K steps: the
//     copies of the next steps are in flight while a step's FMAs run, one
//     barrier a step, and a step's zero-filled tail past K is skipped;
//     16-byte copies where K (for x) or N (for w) is a multiple of 16
//     bytes of elements and the base aligned, else element by element
//     (the N = 2 heads); a K step's part past K reads as 0, and rows past
//     M and columns past N are not copied at all (they feed only outputs
//     that are never written), so the wrapper makes no padded copy;
//   - the operands stay in their own type in shared memory: x row-major
//     (each thread reads 4 consecutive k of one of its rows as one 16-byte
//     vector, the 8 threads of a quarter warp the same address), w 64
//     columns a row (each thread 4 consecutive n, a quarter warp 128
//     contiguous bytes), so no store is transposed and no read conflicts
//     on banks; a bf16 operand is widened to f32 exactly on that read, so
//     its sums and result are bit for bit the f32 path's on the same
//     values, and a bf16 weight is never copied;
//   - split-K in the same launch: each slice writes its f32 partial tile
//     to a workspace and, after the block's barrier, one thread counts it
//     in on an int32 counter of its tile with an acq_rel atomic (releasing
//     the block's writes); the block that counts last sums the slices in
//     order 0..S-1 with __fadd_rn (the bits do not depend on which block
//     that is; the partials are loaded several slices at a time, so the
//     sum costs a few round trips, not one a slice), runs the epilogue and
//     puts the counter back to 0.  The counters are allocated once per
//     device by the wrapper, zero, so no launch clears them and their
//     address stays fixed.
// Sums in full f32 FMA on the CUDA cores: no TF32, whose 10-bit operands
// the reference does not compute (and the latency, not the FFMA rate,
// bounds these shapes).  The epilogue runs on the register tile and the
// f32 output is written once, a float4 a row where N % 4 == 0.
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

#include "cp_async.cuh"
#include "epilogue.cuh"
#include "hopper.cuh"

namespace {

template <typename K>
int set_smem(K kern, int bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ---------------------------------------------------------------------------
// the CUDA-core form ("fma"): f32 sums of f32 or bf16 operands, f32 output
// ---------------------------------------------------------------------------

namespace fma {

constexpr int BN = 64, TN = 4;

// threads of a BM x 64 tile whose threads each own TM rows x 4 columns
__host__ __device__ constexpr int threads(int bm, int tm) {
  return (bm / tm) * (BN / TN);
}
template <typename T>
__host__ __device__ constexpr int smem(int bm, int stages, int bk) {
  return stages * (bm * bk + bk * BN) * (int)sizeof(T);
}

// four consecutive elements of a shared-memory row as f32 (a bf16 is
// widened exactly: its bits are the high half of the f32's)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// one element: f32 through cp.async (zero-filled when !ok), bf16 (2
// bytes, below cp.async's smallest copy) by a plain load and store
__device__ __forceinline__ void copy1(float* dst, const float* src, bool ok) {
  cpa::copy4(dst, src, ok ? 4 : 0);
}
__device__ __forceinline__ void copy1(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, bool ok) {
  *dst = ok ? *src : __float2bfloat16_rn(0.0f);
}

// stage one BK-deep step: x[m0 .. m0+BM, k0 .. k0+BK) into xs (row-major,
// BK a row) and w[k0 .. k0+BK, n0 .. n0+BN) into ws (BN a row).  k past
// k_end reads as 0; rows past M and columns past N are not copied at all:
// they feed only accumulators of outputs that are never written.  xv / wv:
// 16-byte copies (K, resp. N, a multiple of 16 bytes of elements and the
// base aligned), else one element a copy.
template <typename T, int BM, int THREADS, int BK>
__device__ __forceinline__ void stage(T* xs, T* ws, const T* x, const T* w,
                                      int M, int N, int K, int m0, int n0,
                                      int k0, int k_end, bool xv, bool wv,
                                      int tid) {
  constexpr int CH = 16 / (int)sizeof(T);
  if (xv) {
    constexpr int PER = BK / CH, TOTAL = BM * PER;
#pragma unroll
    for (int e = tid; e < TOTAL; e += THREADS) {
      const int r = e / PER, c = (e % PER) * CH;
      const int gm = m0 + r, gk = k0 + c;
      const bool ok = gk < k_end;
      if (gm < M)
        cpa::copy16(xs + r * BK + c, ok ? x + (size_t)gm * K + gk : x,
                    ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      const bool ok = gk < k_end;
      if (gm < M) copy1(xs + e, ok ? x + (size_t)gm * K + gk : x, ok);
    }
  }
  if (wv) {
    constexpr int PER = BN / CH, TOTAL = BK * PER;
#pragma unroll
    for (int e = tid; e < TOTAL; e += THREADS) {
      const int r = e / PER, c = (e % PER) * CH;
      const int gk = k0 + r, gn = n0 + c;
      const bool ok = gk < k_end;
      if (gn < N)
        cpa::copy16(ws + r * BN + c, ok ? w + (size_t)gk * N + gn : w,
                    ok ? 16 : 0);
    }
  } else {
    // columns n0 .. n0+nw of each row (the N = 2 heads copy 2, not 64)
    const int nw = min(BN, N - n0);
    for (int e = tid; e < BK * nw; e += THREADS) {
      const int r = e / nw, c = e % nw;
      const int gk = k0 + r, gn = n0 + c;
      const bool ok = gk < k_end;
      copy1(ws + r * BN + c, ok ? w + (size_t)gk * N + gn : w, ok);
    }
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float residual(const void* res, int res_bf16,
                                          size_t i) {
  return res_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(res)[i])
             : static_cast<const float*>(res)[i];
}

// block (blockIdx.x, blockIdx.y) owns the BM x 64 output tile at (m0, n0),
// blockIdx.z its slice [z * k_per_split, ...) of K.  Thread (ty, tx) owns
// rows ty*TM .. +TM and columns tx*4 .. +4 of the tile.
template <typename T, int BM, int TM, int STAGES, int BK>
__global__ void __launch_bounds__(threads(BM, TM))
gemm_fma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const float* __restrict__ es, const float* __restrict__ eb,
                const void* __restrict__ res, int res_bf16,
                float* __restrict__ out, float* __restrict__ ws,
                int* __restrict__ counters, int M, int N, int K, int splits,
                int k_per_split, int act, int xv, int wv) {
  constexpr int THREADS = threads(BM, TM), STAGE = BM * BK + BK * BN;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  __shared__ int last;
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, z = blockIdx.z;
  const int k_begin = z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_kt = (k_end - k_begin + BK - 1) / BK;

  // the ring: steps 0 .. STAGES-2 in flight before the first product; one
  // commit group a step (empty past the slice's end, so the counts match)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_kt)
      stage<T, BM, THREADS, BK>(sm + s * STAGE, sm + s * STAGE + BM * BK, x, w,
                            M, N, K, m0, n0, k_begin + s * BK, k_end, xv, wv,
                            tid);
    cpa::commit();
  }

  // the epilogue's operands, loaded while the ring fills: es / eb, and
  // without a split the residual
  const int gn0 = n0 + tx * 4;
  float s4[4], b4[4], r4[TM][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s4[j] = gn0 + j < N ? cpa::load_now(es + gn0 + j) : 0.0f;
    b4[j] = gn0 + j < N ? cpa::load_now(eb + gn0 + j) : 0.0f;
  }
  const bool pre_res = res != nullptr && splits == 1;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r4[i][j] = 0.0f;
      if (pre_res && gm < M && gn0 + j < N) {
        const size_t idx = (size_t)gm * N + gn0 + j;
        r4[i][j] = res_bf16
                       ? cpa::load_now_bf16(
                             static_cast<const __nv_bfloat16*>(res) + idx)
                       : cpa::load_now(static_cast<const float*>(res) + idx);
      }
    }
  }

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int kt = 0; kt < n_kt; ++kt) {
    cpa::wait<STAGES - 2>();
    __syncthreads();  // step kt landed; step kt-1's slot is free
    const int pf = kt + STAGES - 1;
    if (pf < n_kt) {
      T* slot = sm + (pf % STAGES) * STAGE;
      stage<T, BM, THREADS, BK>(slot, slot + BM * BK, x, w, M, N, K, m0, n0,
                            k_begin + pf * BK, k_end, xv, wv, tid);
    }
    cpa::commit();
    const T* xs = sm + (kt % STAGES) * STAGE;
    const T* wsm = xs + BM * BK;
    // the zero-filled tail past k_end (K = 16 or 24 in a 32-deep step)
    // adds nothing: stop at its end
    const int kt_len = k_end - (k_begin + kt * BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      if (kk >= kt_len) break;
      float4 a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = load4(xs + (ty * TM + i) * BK + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = load4(wsm + (kk + q) * BN + tx * 4);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = q == 0 ? a[i].x : q == 1 ? a[i].y
                           : q == 2 ? a[i].z : a[i].w;
          acc[i][0] = fmaf(av, b[q].x, acc[i][0]);
          acc[i][1] = fmaf(av, b[q].y, acc[i][1]);
          acc[i][2] = fmaf(av, b[q].z, acc[i][2]);
          acc[i][3] = fmaf(av, b[q].w, acc[i][3]);
        }
    }
  }
  cpa::wait<0>();

  if (splits > 1) {
    // split-K in this launch: every slice writes its partial tile; after
    // the block's barrier one thread counts the slice in with an acq_rel
    // atomic (releasing the block's writes, acquiring the other slices');
    // the block that counts last sums the slices in order 0..splits-1 (so
    // the bits do not depend on which block that is) and runs the epilogue
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* part = ws + (size_t)tile * splits * (BM * BN);
    const int off = (ty * TM) * BN + tx * 4;
#pragma unroll
    for (int i = 0; i < TM; ++i)
      __stcg(reinterpret_cast<float4*>(part + (size_t)z * (BM * BN) + off +
                                       i * BN),
             make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    __syncthreads();
    if (tid == 0) {
      int prev;
      asm volatile("atom.acq_rel.gpu.add.s32 %0, [%1], 1;\n"
                   : "=r"(prev)
                   : "l"(counters + tile)
                   : "memory");
      last = prev == splits - 1;
    }
    __syncthreads();
    if (!last) return;
    // the other slices' partials loaded B slices at a time (one round
    // trip per B slices, not per slice; B * TM float4 in flight a thread),
    // then added in slice order
    constexpr int B = TM >= 8 ? 1 : 8 / TM;
    float4 own[TM], sum[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      own[i] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    for (int s0 = 0; s0 < splits; s0 += B) {
      float4 v[B][TM];
#pragma unroll
      for (int u = 0; u < B; ++u)
#pragma unroll
        for (int i = 0; i < TM; ++i)
          if (s0 + u < splits && s0 + u != z)
            v[u][i] = __ldcg(reinterpret_cast<const float4*>(
                part + (size_t)(s0 + u) * (BM * BN) + off + i * BN));
#pragma unroll
      for (int u = 0; u < B; ++u) {
        const int sl = s0 + u;
        if (sl >= splits) break;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 val = sl == z ? own[i] : v[u][i];
          sum[i] = sl == 0 ? val : add4(sum[i], val);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      acc[i][0] = sum[i].x;
      acc[i][1] = sum[i].y;
      acc[i][2] = sum[i].z;
      acc[i][3] = sum[i].w;
    }
    if (tid == 0) counters[tile] = 0;  // ready for the next launch
  }

  // the epilogue, act(acc * es + eb [+ res]) rounded as marvel::epilogue
  const bool vec_out = (N & 3) == 0 && gn0 < N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) break;
    const size_t row = (size_t)gm * N;
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = __fadd_rn(__fmul_rn(acc[i][j], s4[j]), b4[j]);
      if (res != nullptr && gn0 + j < N)
        v = __fadd_rn(v, pre_res ? r4[i][j]
                                 : residual(res, res_bf16, row + gn0 + j));
      y[j] = marvel::apply_act(v, act);
    }
    if (vec_out) {
      *reinterpret_cast<float4*>(out + row + gn0) =
          make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn0 + j < N) out[row + gn0 + j] = y[j];
    }
  }
}

template <typename T, int BM, int TM, int STAGES, int BK>
int launch_tile(const void* xp, const void* wp, const float* es,
                const float* eb, const void* res, int res_bf16, float* out,
                float* ws, int* counters, int M, int N, int K, int splits,
                int k_per_split, int act, cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(wp);
  constexpr int CH = 16 / (int)sizeof(T), SMEM = smem<T>(BM, STAGES, BK);
  const int xv = K % CH == 0 && ((uintptr_t)x & 15) == 0;
  const int wv = N % CH == 0 && ((uintptr_t)w & 15) == 0;
  auto kern = gemm_fma_kernel<T, BM, TM, STAGES, BK>;
  // the ring is dynamic shared memory; with the kernel's own static word
  // it may pass the 48 KB a launch gets without asking
  if (SMEM + 16 > 48 * 1024) {
    const int err = set_smem(kern, SMEM);
    if (err) return err;
  }
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  kern<<<grid, threads(BM, TM), SMEM, s>>>(
      x, w, es, eb, res, res_bf16, out, splits > 1 ? ws : nullptr, counters,
      M, N, K, splits, splits > 1 ? k_per_split : K, act, xv, wv);
  return (int)cudaGetLastError();
}

// tile index -> (BM, TM, stages of the ring, K step), as
// kernels/matmul_epilogue.py::FMA_TILES
template <typename T>
int launch(int tile, const void* x, const void* w, const float* es,
           const float* eb, const void* res, int res_bf16, float* out,
           float* ws, int* counters, int M, int N, int K, int splits,
           int k_per_split, int act, cudaStream_t s) {
#define MARVEL_FMA_TILE(i, bm, tm, st, bk)                                  \
  case i:                                                                   \
    return launch_tile<T, bm, tm, st, bk>(x, w, es, eb, res, res_bf16, out, \
                                          ws, counters, M, N, K, splits,    \
                                          k_per_split, act, s);
  switch (tile) {
    MARVEL_FMA_TILE(0, 128, 8, 3, 32)
    MARVEL_FMA_TILE(1, 64, 4, 4, 32)
    MARVEL_FMA_TILE(2, 32, 4, 4, 32)
    MARVEL_FMA_TILE(3, 16, 1, 6, 32)
    MARVEL_FMA_TILE(4, 64, 4, 6, 16)
    MARVEL_FMA_TILE(5, 32, 2, 8, 16)
    MARVEL_FMA_TILE(6, 16, 1, 8, 16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MARVEL_FMA_TILE
}

}  // namespace fma

__device__ __forceinline__ void store(float* out, size_t i, float y) {
  out[i] = y;
}
__device__ __forceinline__ void store(__nv_bfloat16* out, size_t i, float y) {
  out[i] = __float2bfloat16_rn(y);
}

// split-K second pass of the tensor-core forms: the slices summed in order
// 0..splits-1, then the epilogue, written in O (bf16)
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
// f32, `tile` indexes the fma tiles (FMA_TILES of the wrapper), k_per_split
// is a multiple of 32, and splits > 1 needs ws, (M tiles * N tiles *
// splits) partial tiles of BM x 64 f32, and counters, one int32 a tile, all
// 0 (the launch leaves them 0).  form 1 or 3 (wgmma, 128x128 or 128x256
// tiles) or 2 (decode, M <= 16): bf16 operands only, K % 8 == 0, N % 8 ==
// 0, 16-byte aligned x and w, out (M, N) bf16, k_per_split a multiple of
// 64, and splits > 1 needs ws: a (splits, M, N) f32 workspace.  Either way
// splits * k_per_split >= K.
extern "C" int marvel_matmul_epilogue(const void* x, const void* w,
                                      const float* es, const float* eb,
                                      const void* res, void* out, float* ws,
                                      int* counters, int M, int N, int K,
                                      int splits, int k_per_split, int act,
                                      int x_bf16, int res_bf16, int form,
                                      int tile, void* stream) {
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
  if (splits > 1 && (ws == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  if (x_bf16)
    return fma::launch<bf16>(tile, x, w, es, eb, res, res_bf16, o, ws,
                             counters, M, N, K, splits, k_per_split, act, s);
  return fma::launch<float>(tile, x, w, es, eb, res, res_bf16, o, ws,
                            counters, M, N, K, splits, k_per_split, act, s);
}
