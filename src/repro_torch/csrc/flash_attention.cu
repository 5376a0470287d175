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
// CUDA-core design (the "fma" form, the first port of this kernel):
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
//
// That CUDA-core form ("fma") runs f32 attention (on tensor cores f32 would
// become TF32, which the reference does not compute) and bf16 heads outside
// {64, 128}.  bf16 at d = 64 or 128 takes the tensor-core form ("wgmma",
// hopper.cuh), chosen by the wrapper's predicate
// (kernels/flash_attention.py::flash_form): one 384-thread block per (128
// queries, (b, kh, g) row), issued heaviest first (the last query tiles of
// the causal triangle).  A producer thread loads the Q tile once by TMA
// through a 4-D tensor map over q's (B, Sq, K*G, d) layout, and 64-key
// tiles of K and V through a 2-stage ring from (B, Skv, K, d) in place
// (d = 128 is two 64-wide boxes; tiles wholly above the diagonal are never
// loaded; TMA zero-fills past Sq and Skv).  Two consumer warpgroups of 64
// queries each compute S = Q K^T with wgmma.m64n64k16 (both operands
// K-major) into f32 registers, mask by position with -1e30, run the online
// softmax in registers (the running max and sum reduced across the 4 lanes
// that share a row; the sum l from the unrounded p), round P to bf16 in
// registers and feed it as the register A of wgmma.m64n{d}k16 against V as
// an MN-major B, O accumulating in f32 registers.  The output is written in
// bf16, o / max(l, 1e-30).  The rounding is the reference's: P in v's type
// for the PV product, scores, sums and the rescale in f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// the wgmma form: bf16, d in {64, 128}
// ---------------------------------------------------------------------------

namespace tc {
constexpr int BQ = 128, BKV = 64, STAGES = 2, THREADS = 384;
template <int D>
__host__ __device__ constexpr int q_bytes() {
  return BQ * D * 2;  // d / 64 boxes of 128 rows x 64
}
template <int D>
__host__ __device__ constexpr int kv_bytes() {
  return BKV * D * 2;  // d / 64 boxes of 64 keys x 64
}
template <int D>
__host__ __device__ constexpr int smem() {
  return 1024 + q_bytes<D>() + 2 * STAGES * kv_bytes<D>() +
         (1 + 2 * STAGES) * 8;
}
}  // namespace tc

template <int D>
__global__ void __launch_bounds__(tc::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ out, Geom g, float scale,
                   int causal) {
  using namespace hopper;
  constexpr int QBOX = tc::BQ * 128, KVBOX = tc::BKV * 128;
  constexpr int KV = tc::kv_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Ks = Qs + tc::q_bytes<D>();  // [stage][d / 64 boxes]
  uint8_t* Vs = Ks + tc::STAGES * KV;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Vs + tc::STAGES * KV);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + tc::STAGES;

  const int n_qt = (g.Sq + tc::BQ - 1) / tc::BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * tc::BQ;  // heaviest first
  const int row = blockIdx.x;  // (b, kh, g) flattened, g fastest
  const int gi = row % g.G, kh = (row / g.G) % g.K, b = row / (g.G * g.K);
  int n_kt = (g.Skv + tc::BKV - 1) / tc::BKV;
  if (causal) n_kt = min(n_kt, (q0 + tc::BQ - 1) / tc::BKV + 1);
  const int role = threadIdx.x / 128;  // 0: producer, 1, 2: consumers

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < tc::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp releases
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (role == 0) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, tc::q_bytes<D>());
      for (int h = 0; h < D / 64; ++h)
        tma_load(Qs + h * QBOX, &qmap, qbar, 64 * h, kh * g.G + gi, q0, b);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % tc::STAGES;
        if (t >= tc::STAGES) mbar_wait(&empty[s], ((t / tc::STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * KV);
        for (int h = 0; h < D / 64; ++h) {
          tma_load(Ks + s * KV + h * KVBOX, &kmap, &full[s], 64 * h, kh,
                   t * tc::BKV, b);
          tma_load(Vs + s * KV + h * KVBOX, &vmap, &full[s], 64 * h, kh,
                   t * tc::BKV, b);
        }
      }
    }
    return;
  }

  const int c = role - 1, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, quad = lane % 4;
  const int r_base = q0 + 64 * c + 16 * warp + lane / 4;
  float o[D / 2], m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  fence_regs(o);
  mbar_wait(qbar, 0);

  for (int t = 0; t < n_kt; ++t) {
    const int s = t % tc::STAGES;
    mbar_wait(&full[s], (t / tc::STAGES) & 1);
    const uint8_t* kt = Ks + s * KV;
    const uint8_t* vt = Vs + s * KV;

    // S = Q K^T: 64 queries x 64 keys, f32
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int h = kk / 4, off = (kk % 4) * 32;
      wgmma_m64n64k16_ss<0, 0>(
          sc, kmajor_desc(Qs + h * QBOX + c * 64 * 128 + off),
          kmajor_desc(kt + h * KVBOX + off));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // mask, online softmax; thread rows r_base and r_base + 8
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qpos = r_base + 8 * hh;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          const int kpos = t * tc::BKV + 8 * j + 2 * quad + e;
          const bool ok = kpos < g.Skv && (!causal || qpos >= kpos);
          sc[i] = ok ? __fmul_rn(sc[i], scale) : NEG_INF;
          mx = fmaxf(mx, sc[i]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hh], mx);
      const float corr = expf(m_run[hh] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          sc[i] = expf(sc[i] - m_new);
          rs += sc[i];
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_run[hh] = fmaf(l_run[hh], corr, rs);
      m_run[hh] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * hh] *= corr;
        o[4 * j + 2 * hh + 1] *= corr;
      }
    }

    // P rounded to bf16 as the register A of P V (keys 16kk..16kk+15)
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = mnmajor_desc(vt + kk * 2048, KVBOX);
      if constexpr (D == 128)
        wgmma_m64n128k16_rs<1>(o, pa[kk], dv);
      else
        wgmma_m64n64k16_rs<1>(o, pa[kk], dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int sp = r_base + 8 * hh;
    if (sp >= g.Sq) continue;
    const float den = fmaxf(l_run[hh], 1e-30f);
    __nv_bfloat16* orow =
        out + (((size_t)b * g.Sq + sp) * g.K * g.G + (size_t)kh * g.G + gi) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * quad;
      *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
          __fdiv_rn(o[4 * j + 2 * hh], den),
          __fdiv_rn(o[4 * j + 2 * hh + 1], den));
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, Geom g,
              float scale, int causal, cudaStream_t s) {
  using hopper::bf16_map;
  CUtensorMap qm, km, vm;
  const cuuint64_t kg = (cuuint64_t)g.K * g.G, e = 2;
  const cuuint64_t qdims[4] = {D, kg, (cuuint64_t)g.Sq, (cuuint64_t)g.B};
  const cuuint64_t qstr[3] = {D * e, kg * D * e, (cuuint64_t)g.Sq * kg * D * e};
  const cuuint32_t qbox[4] = {64, 1, tc::BQ, 1};
  int err = bf16_map(&qm, q, 4, qdims, qstr, qbox);
  if (err) return err;
  const cuuint64_t kdims[4] = {D, (cuuint64_t)g.K, (cuuint64_t)g.Skv,
                               (cuuint64_t)g.B};
  const cuuint64_t kstr[3] = {D * e, (cuuint64_t)g.K * D * e,
                              (cuuint64_t)g.Skv * g.K * D * e};
  const cuuint32_t kbox[4] = {64, 1, tc::BKV, 1};
  err = bf16_map(&km, k, 4, kdims, kstr, kbox);
  if (err) return err;
  err = bf16_map(&vm, v, 4, kdims, kstr, kbox);
  if (err) return err;
  auto kern = flash_wgmma_kernel<D>;
  err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::smem<D>());
  if (err) return err;
  dim3 grid(g.B * g.K * g.G, (g.Sq + tc::BQ - 1) / tc::BQ);
  kern<<<grid, tc::THREADS, tc::smem<D>(), s>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), g, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B, Sq, K, G, d); k, v: (B, Skv, K, d); one type for all four
// (bf16 when is_bf16, else f32).  form 0 (fma): 1 <= d <= 128, B*K*G <=
// 65535 rows; form 1 (wgmma): bf16, d = 64 or 128, Skv >= 1, 16-byte
// aligned bases, Sq / 128 <= 65535 query tiles.
extern "C" int marvel_flash_attention(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Skv, int K, int G, int d,
                                      float scale, int causal, int is_bf16,
                                      int form, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || Sq == 0) return 0;
  Geom g{B, Sq, Skv, K, G, d};
  if (form == 1) {
    if (!is_bf16 || Skv < 1) return (int)cudaErrorInvalidValue;
    if (d == 64) return launch_tc<64>(q, k, v, out, g, scale, causal, s);
    if (d == 128) return launch_tc<128>(q, k, v, out, g, scale, causal, s);
    return (int)cudaErrorInvalidValue;
  }
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, g, scale, causal, s);
  return dispatch_d<float>(q, k, v, out, g, scale, causal, s);
}
