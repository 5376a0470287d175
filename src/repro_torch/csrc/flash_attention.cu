// zol: causal flash attention with an online softmax, on grouped-query
// layouts.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (pl.pallas_call at flash_attention.py:87).
//
// For every (batch b, KV head kh, group g) and query position i:
//   s_j   = (q_i . k_j) * scale                        (f32, scale = 1/sqrt(d))
//   s_j   = -1e30 where j > i (causal) or j >= Skv
//   out_i = sum_j T(p_j) v_j / max(sum_j p_j, 1e-30),  p_j = exp(s_j - m)
// with the running max m and sum l carried in f32 across KV tiles, the
// probabilities rounded to v's type T before the PV product (the sum l is
// taken from the unrounded ones), and the output written in T.
//
// Layouts, read in place: q and out are (B, Sq, K, G, d), k and v are
// (B, Skv, K, d), all contiguous.  The (b, kh, g) row of q reads KV head kh:
// the GQA repeat of the reference wrapper is an index, not a copy.
//
// Bound on the H100: at qwen3-8b's prefill (d = 128, S = 512) the two
// products do 4 * S^2/2 * d FLOPs per (b, head) against reading q, k, v and
// writing out once, above the card's operations-per-byte line: operations.
// Design (simple and right first; wgmma, TMA and bf16 tensor cores later):
// one 256-thread block per (64-query tile, b*K*G row).  The block stages its
// Q tile and then each needed 64-key tile of K (transposed) and V in shared
// memory as f32 (the conversion from bf16 is exact), computes the 64x64
// score tile with CUDA-core FMAs (each thread a 4x4 register tile), masks by
// position (so ragged S needs no padded copy), updates the running max and
// sum with warp shuffles across the 16 threads that share a row, rounds P
// to T into shared memory and accumulates P V into a 4 x (DMAX/16) register
// tile.  Key tiles wholly above the diagonal are never loaded.  Rows of
// shared memory are padded by one float so the column reads are free of
// bank conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// p rounded to T and back (exact for f32)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

struct Geom {
  int B, Sq, Skv, K, G, d;
};

template <int DMAX>
constexpr size_t smem_bytes() {
  // Q[BQ][DMAX+1], V[BK][DMAX+1], K^T[DMAX][BK+1], P[BQ][BK+1] in f32
  return sizeof(float) * ((size_t)2 * BQ * (DMAX + 1) +
                          (size_t)DMAX * (BK + 1) + (size_t)BQ * (BK + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, Geom g,
             float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int DP = DMAX + 1, KP = BK + 1, DJ = DMAX / 16;
  float* Qs = smem;               // [BQ][DP]
  float* Vs = Qs + BQ * DP;       // [BK][DP]
  float* Kt = Vs + BK * DP;       // [DMAX][KP]
  float* Ps = Kt + DMAX * KP;     // [BQ][KP]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int d = g.d;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;  // (b, kh, g) flattened, g fastest
  const int gi = bh % g.G, kh = (bh / g.G) % g.K, b = bh / (g.G * g.K);
  const size_t q_row = (size_t)g.K * g.G * d;  // stride between positions
  const size_t k_row = (size_t)g.K * d;
  const T* qb = q + (size_t)b * g.Sq * q_row + ((size_t)kh * g.G + gi) * d;
  T* ob = out + (size_t)b * g.Sq * q_row + ((size_t)kh * g.G + gi) * d;
  const T* kb = k + (size_t)b * g.Skv * k_row + (size_t)kh * d;
  const T* vb = v + (size_t)b * g.Skv * k_row + (size_t)kh * d;

  for (int e = tid; e < BQ * d; e += THREADS) {
    int r = e / d, c = e % d;
    int s = q0 + r;
    Qs[r * DP + c] = s < g.Sq ? to_f32(qb[(size_t)s * q_row + c]) : 0.0f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  int n_kt = (g.Skv + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);  // skip above diag
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < BK * d; e += THREADS) {
      int r = e / d, c = e % d;
      int s = k0 + r;
      bool ok = s < g.Skv;
      Kt[c * KP + r] = ok ? to_f32(kb[(size_t)s * k_row + c]) : 0.0f;
      Vs[r * DP + c] = ok ? to_f32(vb[(size_t)s * k_row + c]) : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int kk = 0; kk < d; ++kk) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * DP + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Kt[kk * KP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bb[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < g.Skv && (!causal || qpos >= kpos);
        sc[i][j] = ok ? __fmul_rn(sc[i][j], scale) : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = expf(sc[i][j] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * KP + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = fmaf(l[i], corr, rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * KP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= g.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) ob[(size_t)s * q_row + c] = from_f32<T>(__fdiv_rn(acc[i][j], den));
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* out, Geom g,
           float scale, int causal, cudaStream_t s) {
  auto kern = flash_kernel<T, DMAX>;
  constexpr size_t bytes = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g.Sq + BQ - 1) / BQ, g.B * g.K * g.G);
  kern<<<grid, THREADS, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), g, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, Geom g,
               float scale, int causal, cudaStream_t s) {
  if (g.d <= 32) return launch<T, 32>(q, k, v, out, g, scale, causal, s);
  if (g.d <= 64) return launch<T, 64>(q, k, v, out, g, scale, causal, s);
  return launch<T, 128>(q, k, v, out, g, scale, causal, s);
}

}  // namespace

// q, out: (B, Sq, K, G, d); k, v: (B, Skv, K, d); one type for all four
// (bf16 when is_bf16, else f32); 1 <= d <= 128; B*K*G <= 65535 rows.
extern "C" int marvel_flash_attention(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Skv, int K, int G, int d,
                                      float scale, int causal, int is_bf16,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || Sq == 0) return 0;
  Geom g{B, Sq, Skv, K, G, d};
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, g, scale, causal, s);
  return dispatch_d<float>(q, k, v, out, g, scale, causal, s);
}
