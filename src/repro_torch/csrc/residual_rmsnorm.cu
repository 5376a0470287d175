// add2i: fused residual-add + RMSNorm, both outputs in one kernel.
//
// Replaces the TPU kernel src/repro/kernels/residual_rmsnorm.py::_kernel
// (pl.pallas_call at residual_rmsnorm.py:43).
//
//   r         = f32(res[row]) + f32(x[row])
//   newres    = T(r)
//   normed    = T((r * (1 / sqrt(mean(r * r) + eps))) * f32(scale))
//
// The mean is taken over the unrounded f32 r, and the reciprocal square root
// is correctly rounded (1.0f / sqrtf), as the reference computes them.  The
// scale is read in its own type (f32 or bf16, whatever the rows' type) and
// widened to f32 in registers, exactly, as the reference's astype does: no
// copy of it runs before the kernel.
//
// Bound on the H100: bytes.  Per element it reads two inputs and writes two
// outputs (8 bytes in bf16) against about six operations, far below the
// card's operations-per-byte line; at a decode step's 8 rows the launch
// itself (about 1.9 us back to back) is the floor.  Two forms, planned in
// Python (residual_rmsnorm.py::norm_plan) and launched as planned:
//
// rows    A group of t threads (a power of two, 8..256) takes one row; a
//         block holds rows_per_block groups, so narrow rows share a block.
//         Each thread loads its NV 16-byte vectors of res and x at once
//         (vector i + k*t in round k, the last round predicated), adds in
//         f32, stores newres and keeps r in f32 registers; its scale packs
//         are loaded before the reduction, so their latency overlaps it.
//         The sum of r * r is reduced by warp shuffles (over the group's
//         lanes only, when t < 32), and through shared memory only when
//         t > 32.  normed is written from the registers: each row is read
//         once.  Needs D a multiple of the vector, D <= t * NV * vector and
//         16-byte aligned pointers.
// scalar  One 256-thread block a row, two passes with scalar loads: pass 1
//         writes newres and sums r * r, pass 2 reads the row again (from L2)
//         and writes normed.  Any D and alignment (D = 257, D beyond the
//         rows form's registers, a view off 16-byte alignment).
//
// Timed on the H100 and not kept (tools/time_rmsnorm_kernels.py; PERF.md):
// a row split over a thread-block cluster at few rows
// (tools/rmsnorm_cluster.cu), blocks looping over rows with the next row's
// loads in flight, the scale loaded after the reduction, split sums of
// squares and paired bf16 conversions.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int SCALAR_THREADS = 256;
constexpr int ROWS_MAX_THREADS = 256;  // a rows-form block, any group size
constexpr int ROWS_MAX_NV = 8;         // vectors a thread holds

enum Form { SCALAR = 0, ROWS = 1 };  // kernels/residual_rmsnorm.py FORM_CODES

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

// one 16-byte vector of T
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// The N scale values beside one vector of rows, as 32-bit words: N f32 (N
// words) or N bf16 (N / 2 words, element j in the low half of word j / 2
// when j is even).  Loaded where it stands, non-coherent and volatile, so
// the compiler does not sink it past the reduction to its first use.
template <typename S, int N>
struct ScalePack {
  static constexpr int WORDS = N * sizeof(S) / 4;  // 2, 4 or 8
  uint32_t w[WORDS];

  __device__ __forceinline__ void load(const S* p) {
    const char* b = reinterpret_cast<const char*>(p);
    if constexpr (WORDS == 2) {
      asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n"
                   : "=r"(w[0]), "=r"(w[1])
                   : "l"(b));
    } else {
#pragma unroll
      for (int q = 0; q < WORDS / 4; ++q)
        asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(w[4 * q]), "=r"(w[4 * q + 1]), "=r"(w[4 * q + 2]),
                       "=r"(w[4 * q + 3])
                     : "l"(b + 16 * q));
    }
  }
  __device__ __forceinline__ float get(int j) const {
    if constexpr (sizeof(S) == 4) {
      return __uint_as_float(w[j]);
    } else {  // bf16 -> f32 is exact: the bits shifted to the top half
      return __uint_as_float((j & 1) ? (w[j >> 1] & 0xffff0000u)
                                     : (w[j >> 1] << 16));
    }
  }
};

// the rows form: see the header.  blockDim.x = t * rows_per_block.
template <typename T, typename S, int NV>
__global__ void __launch_bounds__(ROWS_MAX_THREADS)
residual_rmsnorm_rows(const T* __restrict__ res, const T* __restrict__ x,
                      const S* __restrict__ scale, T* __restrict__ newres,
                      T* __restrict__ normed, int R, int D, int t, float eps) {
  using V = Vec<T>;
  constexpr int VN = V::N;
  __shared__ float red[ROWS_MAX_THREADS / 32];
  const int lane = threadIdx.x & (t - 1);
  const int row = blockIdx.x * (blockDim.x / t) + threadIdx.x / t;
  const bool live = row < R;
  const int nv = D / VN;
  const size_t base = (size_t)row * D;
  const V* rv = reinterpret_cast<const V*>(res + base);
  const V* xv = reinterpret_cast<const V*>(x + base);

  V a[NV], b[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + k * t;
    if (live && i < nv) {
      a[k] = rv[i];
      b[k] = xv[i];
    }
  }
  ScalePack<S, VN> sc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + k * t;
    if (live && i < nv) sc[k].load(scale + (size_t)i * VN);
  }

  float r[NV][VN];
  float ss = 0.0f;
  V* ov = reinterpret_cast<V*>(newres + base);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + k * t;
    if (live && i < nv) {
      V o;
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        r[k][j] = __fadd_rn(to_f32(a[k].v[j]), to_f32(b[k].v[j]));
        o.v[j] = from_f32<T>(r[k][j]);
        ss = fmaf(r[k][j], r[k][j], ss);
      }
      ov[i] = o;
    }
  }

  // the row's sum: a butterfly over the group's lanes gives every lane the
  // same sum (each level adds the same two values); above a warp, the
  // warps' sums through shared memory, added in one order by every thread
  const int wlanes = t < 32 ? t : 32;
  const unsigned mask =
      t < 32 ? ((1u << t) - 1u) << ((threadIdx.x & 31) & ~(t - 1))
             : 0xffffffffu;
  for (int off = wlanes / 2; off > 0; off >>= 1)
    ss += __shfl_xor_sync(mask, ss, off);
  if (t > 32) {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = ss;
    __syncthreads();
    const float* w = red + (threadIdx.x / t) * (t / 32);
    ss = w[0];
    for (int q = 1; q < t / 32; ++q) ss += w[q];
  }
  const float var = __fdiv_rn(ss, (float)D);
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));

  V* nv_out = reinterpret_cast<V*>(normed + base);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + k * t;
    if (live && i < nv) {
      V o;
#pragma unroll
      for (int j = 0; j < VN; ++j)
        o.v[j] = from_f32<T>(__fmul_rn(__fmul_rn(r[k][j], inv),
                                       sc[k].get(j)));
      nv_out[i] = o;
    }
  }
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (warp == 0) {
    total = lane < SCALAR_THREADS / 32 ? red[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      total += __shfl_xor_sync(0xffffffffu, total, off);
    if (lane == 0) red[0] = total;
  }
  __syncthreads();
  return red[0];
}

// the scalar form: see the header.  One block a row.
template <typename T, typename S>
__global__ void __launch_bounds__(SCALAR_THREADS)
residual_rmsnorm_scalar(const T* __restrict__ res, const T* __restrict__ x,
                        const S* __restrict__ scale,
                        T* __restrict__ newres, T* __restrict__ normed, int D,
                        float eps) {
  __shared__ float red[SCALAR_THREADS / 32];
  const size_t base = (size_t)blockIdx.x * D;
  const T* rr = res + base;
  const T* xr = x + base;
  float ss = 0.0f;
  for (int i = threadIdx.x; i < D; i += SCALAR_THREADS) {
    float r = __fadd_rn(to_f32(rr[i]), to_f32(xr[i]));
    newres[base + i] = from_f32<T>(r);
    ss = fmaf(r, r, ss);
  }
  const float var = __fdiv_rn(block_sum(ss, red), (float)D);
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  for (int i = threadIdx.x; i < D; i += SCALAR_THREADS) {
    float r = __fadd_rn(to_f32(rr[i]), to_f32(xr[i]));
    normed[base + i] = from_f32<T>(
        __fmul_rn(__fmul_rn(r, inv), to_f32(scale[i])));
  }
}

template <typename T, typename S, int NV>
void launch_rows(const T* r, const T* x, const S* sc, T* nr, T* nm, int R,
                 int D, int t, int rpb, int grid, float eps, cudaStream_t s) {
  residual_rmsnorm_rows<T, S, NV><<<grid, t * rpb, 0, s>>>(r, x, sc, nr, nm,
                                                           R, D, t, eps);
}

template <typename T, typename S>
int launch(const void* res, const void* x, const void* scale, void* newres,
           void* normed, int R, int D, float eps, int form, int t, int rpb,
           int nv, int grid, cudaStream_t s) {
  const T* r = static_cast<const T*>(res);
  const T* xx = static_cast<const T*>(x);
  const S* sc = static_cast<const S*>(scale);
  T* nr = static_cast<T*>(newres);
  T* nm = static_cast<T*>(normed);
  if (form == SCALAR) {
    if (grid != R) return (int)cudaErrorInvalidValue;
    residual_rmsnorm_scalar<T, S><<<R, SCALAR_THREADS, 0, s>>>(r, xx, sc, nr,
                                                              nm, D, eps);
    return (int)cudaGetLastError();
  }
  constexpr int VN = 16 / sizeof(T);
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) % 16) == 0;
  };
  // the plan's geometry must cover the rows: refuse any other
  if (form != ROWS || t < 8 || t > ROWS_MAX_THREADS || (t & (t - 1)) ||
      rpb < 1 || t * rpb > ROWS_MAX_THREADS || nv < 1 || nv > ROWS_MAX_NV ||
      D % VN || D / VN > t * nv || (long long)grid * rpb < R ||
      !aligned(res) || !aligned(x) || !aligned(scale) || !aligned(newres) ||
      !aligned(normed))
    return (int)cudaErrorInvalidValue;
  switch (nv) {
    case 1: launch_rows<T, S, 1>(r, xx, sc, nr, nm, R, D, t, rpb, grid, eps, s); break;
    case 2: launch_rows<T, S, 2>(r, xx, sc, nr, nm, R, D, t, rpb, grid, eps, s); break;
    case 3: launch_rows<T, S, 3>(r, xx, sc, nr, nm, R, D, t, rpb, grid, eps, s); break;
    case 4: launch_rows<T, S, 4>(r, xx, sc, nr, nm, R, D, t, rpb, grid, eps, s); break;
    case 5: launch_rows<T, S, 5>(r, xx, sc, nr, nm, R, D, t, rpb, grid, eps, s); break;
    case 6: launch_rows<T, S, 6>(r, xx, sc, nr, nm, R, D, t, rpb, grid, eps, s); break;
    case 7: launch_rows<T, S, 7>(r, xx, sc, nr, nm, R, D, t, rpb, grid, eps, s); break;
    default: launch_rows<T, S, 8>(r, xx, sc, nr, nm, R, D, t, rpb, grid, eps, s); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// res, x, newres, normed: (R, D) of one type (bf16 when is_bf16, else f32);
// scale: (D,) bf16 when scale_is_bf16, else f32.  The form and its geometry
// come from residual_rmsnorm.py::norm_plan: threads per row t, rows per
// block, vectors per thread nv and the grid (blocks); cluster must be 1.
extern "C" int marvel_residual_rmsnorm(const void* res, const void* x,
                                       const void* scale, void* newres,
                                       void* normed, int R, int D, float eps,
                                       int is_bf16, int scale_is_bf16,
                                       int form, int t, int rpb, int nv,
                                       int grid, int cluster, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R == 0) return 0;
  if (cluster != 1) return (int)cudaErrorInvalidValue;
  if (is_bf16 && scale_is_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        res, x, scale, newres, normed, R, D, eps, form, t, rpb, nv, grid, s);
  if (is_bf16)
    return launch<__nv_bfloat16, float>(res, x, scale, newres, normed, R, D,
                                        eps, form, t, rpb, nv, grid, s);
  if (scale_is_bf16)
    return launch<float, __nv_bfloat16>(res, x, scale, newres, normed, R, D,
                                        eps, form, t, rpb, nv, grid, s);
  return launch<float, float>(res, x, scale, newres, normed, R, D, eps, form,
                              t, rpb, nv, grid, s);
}
