// pool: windowed max/avg pooling and the global-average reduce.
//
// Replaces the TPU kernels src/repro/kernels/pooling.py::_pool_kernel
// (pl.pallas_call at pooling.py:123, via maxpool2d / avgpool2d) and
// pooling.py::_gap_kernel (pl.pallas_call at pooling.py:160).
//
// Both are memory-bound reductions on the H100: the bound is the input read
// once plus the output written once at 3.35 TB/s.  At the CNN path's sizes
// (0.04-8.4 MB a launch) a launch sits near the card's launch floor, so the
// design keeps each thread's work short and its loads wide, and spreads
// even the smallest launch over the SMs.  Every form launches the geometry
// that kernels/pooling.py::pool_plan gives (one plan, a pure function the
// CPU tests reach):
//  * windowed, vector form: one thread per (output pixel, 16-byte channel
//    group: 4 f32 or 16 int8 channels); each of the k*k taps is one 16-byte
//    read-only load, the result one 16-byte store (int8 avg: four of f32).
//    The block is (channel groups) x (output columns), the grid's z axis the
//    output row n*Ho + oh, so the index math is 32-bit with one divide
//    (row / Ho).  The k = 3 overlap of neighbouring windows is left to
//    L1/L2.
//  * windowed, scalar form: one thread per output element, 32-bit index
//    math; it takes C not a multiple of the group, an input not 16-byte
//    aligned, and grids the vector form's z axis cannot hold.
//  Both walk the taps in row-major order: avg adds them in f32 (__fadd_rn)
//  and multiplies by 1/(k*k) (__fmul_rn), as the plain version does; max
//  propagates NaN (a NaN tap makes the window NaN), as torch.maximum and
//  the reference's lax.max do.  Max keeps the input type; avg of int8
//  writes f32.
//  * global average, vector form (small H*W): one thread per (n, 16-byte
//    channel group) sums the H*W pixels in order with 16-byte loads and
//    multiplies by 1/(H*W): no shared memory, no barrier.
//  * global average, rows form (large H*W): one block per (n, 32 channel
//    groups); 8 thread rows take pixels p = r, r+8, ... in order, then the 8
//    partial sums are added in a fixed order in shared memory (no atomics,
//    so the result does not vary from run to run).  16-byte groups where C
//    and the pointer allow; the scalar form is the same kernel one channel
//    a thread.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

enum Form { kScalar = 0, kVector = 1, kRows = 2 };

// V channels of type T at p as f32 lanes: a 16-byte read-only load for the
// vector widths (4 f32, 16 int8), a scalar one for V = 1.
template <typename T, int V>
struct Lanes;

template <>
struct Lanes<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
};

template <>
struct Lanes<int8_t, 1> {
  static __device__ __forceinline__ void load(const int8_t* p, float* v) {
    v[0] = (float)__ldg(reinterpret_cast<const signed char*>(p));
  }
};

template <>
struct Lanes<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

template <>
struct Lanes<int8_t, 16> {
  static __device__ __forceinline__ void load(const int8_t* p, float* v) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    const int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        v[4 * i + b] = (float)(int8_t)(w[i] >> (8 * b));
  }
};

// V f32 lanes stored as V values of type O (16-byte stores for V >= 4)
template <typename O, int V>
__device__ __forceinline__ void store(O* p, const float* v);

template <>
__device__ __forceinline__ void store<float, 1>(float* p, const float* v) {
  p[0] = v[0];
}

template <>
__device__ __forceinline__ void store<int8_t, 1>(int8_t* p, const float* v) {
  p[0] = (int8_t)v[0];
}

template <>
__device__ __forceinline__ void store<float, 4>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <>
__device__ __forceinline__ void store<float, 16>(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<float4*>(p)[i] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

template <>
__device__ __forceinline__ void store<int8_t, 16>(int8_t* p, const float* v) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      w[i] |= ((unsigned)(int)v[4 * i + b] & 0xffu) << (8 * b);
  }
  *reinterpret_cast<int4*>(p) =
      make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

// one tap into the window's running value: the f32 sum, or the max with a
// sticky NaN (once acc is NaN, v > acc is false for every v)
template <bool AVG>
__device__ __forceinline__ float take(float acc, float v) {
  if (AVG) return __fadd_rn(acc, v);
  return (v != v || v > acc) ? v : acc;
}

template <typename T, typename O, int V, int K, bool AVG>
__global__ void windowed_vec_kernel(const T* __restrict__ x,
                                    O* __restrict__ out, int H, int W, int C,
                                    int Ho, int Wo, int G, int stride) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int ow = blockIdx.y * blockDim.y + threadIdx.y;
  const int row = blockIdx.z;  // n * Ho + oh
  if (g >= G || ow >= Wo) return;
  const int n = row / Ho, oh = row - n * Ho;
  // every offset is below the input's element count, < 2**31 (the wrapper)
  const T* base = x + ((n * H + oh * stride) * W + ow * stride) * C + g * V;
  float acc[V], v[V];
  Lanes<T, V>::load(base, acc);
#pragma unroll
  for (int t = 1; t < K * K; ++t) {
    Lanes<T, V>::load(base + ((t / K) * W + t % K) * C, v);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = take<AVG>(acc[j], v[j]);
  }
  if (AVG) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = __fmul_rn(acc[j], 1.0f / (float)(K * K));
  }
  store<O, V>(out + (row * Wo + ow) * C + g * V, acc);
}

template <typename T, typename O, bool AVG>
__global__ void windowed_scalar_kernel(const T* __restrict__ x,
                                       O* __restrict__ out, int total, int H,
                                       int W, int C, int Ho, int Wo, int k,
                                       int stride) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const unsigned c = (unsigned)i % C;
  unsigned t = (unsigned)i / C;
  const unsigned ow = t % Wo;
  t /= Wo;
  const unsigned oh = t % Ho, n = t / Ho;
  const T* base = x + ((n * H + oh * stride) * W + ow * stride) * C + c;
  float acc;
  Lanes<T, 1>::load(base, &acc);
  for (int kh = 0; kh < k; ++kh) {
    for (int kw = 0; kw < k; ++kw) {
      if (kh == 0 && kw == 0) continue;
      float v;
      Lanes<T, 1>::load(base + (kh * W + kw) * C, &v);
      acc = take<AVG>(acc, v);
    }
  }
  if (AVG) acc = __fmul_rn(acc, 1.0f / (float)(k * k));
  store<O, 1>(out + i, &acc);
}

template <typename T, int V>
__global__ void gap_vec_kernel(const T* __restrict__ x,
                               float* __restrict__ out, int HW, int C, int G) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = blockIdx.y;
  if (g >= G) return;
  const T* p = x + n * HW * C + g * V;
  float s[V], v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = 0.0f;
#pragma unroll 4
  for (int q = 0; q < HW; ++q) {
    Lanes<T, V>::load(p + q * C, v);
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = __fadd_rn(s[j], v[j]);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = __fmul_rn(s[j], 1.0f / (float)HW);
  store<float, V>(out + n * C + g * V, s);
}

constexpr int GAP_C = 32, GAP_R = 8;

template <typename T, int V>
__global__ void gap_rows_kernel(const T* __restrict__ x,
                                float* __restrict__ out, int HW, int C,
                                int G) {
  __shared__ float part[GAP_R][V][GAP_C];
  const int tc = threadIdx.x, tr = threadIdx.y;
  const int n = blockIdx.y, g = blockIdx.x * GAP_C + tc;
  float s[V], v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = 0.0f;
  if (g < G) {
    const T* img = x + n * HW * C + g * V;
    for (int p = tr; p < HW; p += GAP_R) {
      Lanes<T, V>::load(img + p * C, v);
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] = __fadd_rn(s[j], v[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) part[tr][j][tc] = s[j];
  __syncthreads();
  if (tr == 0 && g < G) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float acc = part[0][j][tc];
#pragma unroll
      for (int r = 1; r < GAP_R; ++r) acc = __fadd_rn(acc, part[r][j][tc]);
      s[j] = __fmul_rn(acc, 1.0f / (float)HW);
    }
    store<float, V>(out + n * C + g * V, s);
  }
}

template <typename T, typename O, bool AVG>
int windowed_launch(const void* x, void* out, int N, int H, int W, int C,
                    int Ho, int Wo, int k, int stride, int form, dim3 grid,
                    dim3 block, cudaStream_t s) {
  const T* xi = static_cast<const T*>(x);
  O* o = static_cast<O*>(out);
  constexpr int V = 16 / sizeof(T);
  if (form == kScalar) {
    windowed_scalar_kernel<T, O, AVG><<<grid, block, 0, s>>>(
        xi, o, N * Ho * Wo * C, H, W, C, Ho, Wo, k, stride);
  } else if (form == kVector && C % V == 0 && k == 2) {
    windowed_vec_kernel<T, O, V, 2, AVG><<<grid, block, 0, s>>>(
        xi, o, H, W, C, Ho, Wo, C / V, stride);
  } else if (form == kVector && C % V == 0 && k == 3) {
    windowed_vec_kernel<T, O, V, 3, AVG><<<grid, block, 0, s>>>(
        xi, o, H, W, C, Ho, Wo, C / V, stride);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int gap_launch(const void* x, float* out, int HW, int C, int form, dim3 grid,
               dim3 block, cudaStream_t s) {
  const T* xi = static_cast<const T*>(x);
  constexpr int V = 16 / sizeof(T);
  if (form == kScalar)
    gap_rows_kernel<T, 1><<<grid, block, 0, s>>>(xi, out, HW, C, C);
  else if (form == kRows && C % V == 0)
    gap_rows_kernel<T, V><<<grid, block, 0, s>>>(xi, out, HW, C, C / V);
  else if (form == kVector && C % V == 0)
    gap_vec_kernel<T, V><<<grid, block, 0, s>>>(xi, out, HW, C, C / V);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// in_int8: x is int8 (else f32).  Max pools write x's type; avg pools f32.
// form and (bx, by) x (gx, gy, gz): pooling.py::pool_plan.
extern "C" int marvel_windowed_pool(const void* x, void* out, int in_int8,
                                    int N, int H, int W, int C, int Ho, int Wo,
                                    int k, int stride, int avg, int form,
                                    int bx, int by, int gx, int gy, int gz,
                                    void* stream) {
  const dim3 grid(gx, gy, gz), block(bx, by);
  cudaStream_t s = (cudaStream_t)stream;
  if (in_int8 && !avg)
    return windowed_launch<int8_t, int8_t, false>(x, out, N, H, W, C, Ho, Wo,
                                                  k, stride, form, grid, block,
                                                  s);
  if (in_int8)
    return windowed_launch<int8_t, float, true>(x, out, N, H, W, C, Ho, Wo, k,
                                                stride, form, grid, block, s);
  if (!avg)
    return windowed_launch<float, float, false>(x, out, N, H, W, C, Ho, Wo, k,
                                                stride, form, grid, block, s);
  return windowed_launch<float, float, true>(x, out, N, H, W, C, Ho, Wo, k,
                                             stride, form, grid, block, s);
}

extern "C" int marvel_global_avgpool(const void* x, float* out, int in_int8,
                                     int HW, int C, int form, int bx, int by,
                                     int gx, int gy, void* stream) {
  const dim3 grid(gx, gy), block(bx, by);
  cudaStream_t s = (cudaStream_t)stream;
  if (in_int8) return gap_launch<int8_t>(x, out, HW, C, form, grid, block, s);
  return gap_launch<float>(x, out, HW, C, form, grid, block, s);
}
