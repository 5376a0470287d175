// add2i: fused residual-add + RMSNorm, both outputs in one kernel.
//
// Replaces the TPU kernel src/repro/kernels/residual_rmsnorm.py::_kernel
// (pl.pallas_call at residual_rmsnorm.py:43).
//
//   r         = f32(res[row]) + f32(x[row])
//   newres    = T(r)
//   normed    = T(r * (1 / sqrt(mean(r * r) + eps)) * scale)
//
// The mean is taken over the unrounded f32 r, and the reciprocal square root
// is correctly rounded (1.0f / sqrtf), as the reference computes them.
//
// Bound on the H100: bytes.  Per element it reads two inputs and writes two
// outputs (8 bytes in bf16) against about six operations, far below the
// card's operations-per-byte line.  Design: one 256-thread block per row.
// Pass 1 reads res and x with 16-byte vector loads (8 bf16 or 4 f32) where
// the row allows it, writes newres and sums r * r in f32; a warp-shuffle and
// shared-memory reduction gives the row's sum.  Pass 2 reads the row again
// (it is resident in L1/L2 after pass 1, so device memory sees it once),
// recomputes r with the same f32 add and writes normed.  A row whose length
// is not a multiple of the vector, or whose base is not 16-byte aligned,
// runs the scalar loop (the D = 257 case).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

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

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (warp == 0) {
    total = lane < THREADS / 32 ? red[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      total += __shfl_xor_sync(0xffffffffu, total, off);
    if (lane == 0) red[0] = total;
  }
  __syncthreads();
  return red[0];
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
residual_rmsnorm_kernel(const T* __restrict__ res, const T* __restrict__ x,
                        const float* __restrict__ scale,
                        T* __restrict__ newres, T* __restrict__ normed, int D,
                        float eps) {
  __shared__ float red[THREADS / 32];
  const size_t base = (size_t)blockIdx.x * D;
  const T* rr = res + base;
  const T* xr = x + base;
  float ss = 0.0f;
  if (VEC) {
    using V = Vec<T>;
    const int nv = D / V::N;
    const V* rv = reinterpret_cast<const V*>(rr);
    const V* xv = reinterpret_cast<const V*>(xr);
    V* ov = reinterpret_cast<V*>(newres + base);
    for (int i = threadIdx.x; i < nv; i += THREADS) {
      V a = rv[i], b = xv[i], o;
#pragma unroll
      for (int j = 0; j < V::N; ++j) {
        float r = __fadd_rn(to_f32(a.v[j]), to_f32(b.v[j]));
        o.v[j] = from_f32<T>(r);
        ss = fmaf(r, r, ss);
      }
      ov[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < D; i += THREADS) {
      float r = __fadd_rn(to_f32(rr[i]), to_f32(xr[i]));
      newres[base + i] = from_f32<T>(r);
      ss = fmaf(r, r, ss);
    }
  }
  const float var = __fdiv_rn(block_sum(ss, red), (float)D);
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  if (VEC) {
    using V = Vec<T>;
    const int nv = D / V::N;
    const V* rv = reinterpret_cast<const V*>(rr);
    const V* xv = reinterpret_cast<const V*>(xr);
    V* ov = reinterpret_cast<V*>(normed + base);
    for (int i = threadIdx.x; i < nv; i += THREADS) {
      V a = rv[i], b = xv[i], o;
#pragma unroll
      for (int j = 0; j < V::N; ++j) {
        float r = __fadd_rn(to_f32(a.v[j]), to_f32(b.v[j]));
        o.v[j] = from_f32<T>(
            __fmul_rn(__fmul_rn(r, inv), scale[i * V::N + j]));
      }
      ov[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < D; i += THREADS) {
      float r = __fadd_rn(to_f32(rr[i]), to_f32(xr[i]));
      normed[base + i] = from_f32<T>(__fmul_rn(__fmul_rn(r, inv), scale[i]));
    }
  }
}

template <typename T>
int launch(const void* res, const void* x, const float* scale, void* newres,
           void* normed, int R, int D, float eps, cudaStream_t s) {
  const T* r = static_cast<const T*>(res);
  const T* xx = static_cast<const T*>(x);
  T* nr = static_cast<T*>(newres);
  T* nm = static_cast<T*>(normed);
  constexpr int VN = 16 / sizeof(T);
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) % 16) == 0;
  };
  bool vec = D % VN == 0 && aligned(res) && aligned(x) && aligned(newres) &&
             aligned(normed);
  if (vec)
    residual_rmsnorm_kernel<T, true><<<R, THREADS, 0, s>>>(r, xx, scale, nr,
                                                           nm, D, eps);
  else
    residual_rmsnorm_kernel<T, false><<<R, THREADS, 0, s>>>(r, xx, scale, nr,
                                                            nm, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// res, x, newres, normed: (R, D) of one type (bf16 when is_bf16, else f32);
// scale: (D,) f32.  R <= 2^31 - 1 rows, one block each.
extern "C" int marvel_residual_rmsnorm(const void* res, const void* x,
                                       const float* scale, void* newres,
                                       void* normed, int R, int D, float eps,
                                       int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R == 0) return 0;
  if (is_bf16)
    return launch<__nv_bfloat16>(res, x, scale, newres, normed, R, D, eps, s);
  return launch<float>(res, x, scale, newres, normed, R, D, eps, s);
}
