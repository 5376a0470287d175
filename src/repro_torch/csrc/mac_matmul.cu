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
// int8 read once; at prefill shapes the int8 operations (1,979 TOP/s on
// tensor cores).  This first kernel runs the products on the CUDA cores
// with __dp4a (four int8 products summed into an int32 per instruction),
// in two forms:
//
// * skinny (M <= 8): a 256-thread block owns 128 output columns; each of
//   its 8 warps walks every 8th quad of k rows, each lane reads 4 adjacent
//   columns of 4 rows (four 32-bit loads: a warp reads 128 contiguous bytes
//   of each row), transposes them into 4 column quads with __byte_perm and
//   keeps all M rows' sums in registers.  The warps' sums meet in shared
//   memory.  Spending 64 tile rows on 8 would read the weights 8 times over.
// * tiled (M > 8): 64 x 64 output tiles, K in chunks of 32 staged in shared
//   memory as k-contiguous int8 quads, a 4 x 4 int32 register tile per
//   thread (the loop of fused_conv.cu).
//
// Both split K across blocks (grid.z / grid.y) when the output tiles alone
// leave the card's SMs idle; the slices then add their int32 sums into a
// zeroed workspace with atomicAdd (integer sums: exact in any order) and a
// second kernel applies the scale.  A ragged K or N is a bounds check with
// zero fill (byte loads where a row is not 4-byte aligned), never a padded
// copy.  Tensor cores (wgmma s8) and TMA are later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
// tiled form
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int KQ = BK / 4;   // int8 quads per k chunk
constexpr int ROW = KQ + 1;  // padded row length in 32-bit words
// skinny form
constexpr int SK_ROWS = 8;    // the most rows it takes
constexpr int SK_COLS = 128;  // columns per block: 32 lanes x 4
constexpr int SK_WARPS = THREADS / 32;

__device__ __forceinline__ int load_quad(const int8_t* p, int avail,
                                         bool vec) {
  // 4 consecutive int8 as one word (low byte first); bytes past `avail`
  // read as 0
  if (vec && avail >= 4) return *reinterpret_cast<const int*>(p);
  int word = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (b < avail) word |= (int)((uint32_t)(uint8_t)p[b] << (8 * b));
  return word;
}

__device__ __forceinline__ void store(float* out, int* ws, size_t idx,
                                      int acc, float scale) {
  if (ws != nullptr)
    atomicAdd(ws + idx, acc);
  else
    out[idx] = __fmul_rn((float)acc, scale);
}

__global__ void __launch_bounds__(THREADS)
mac_tiled_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int* __restrict__ ws, int M, int K, int N, int k_per_split,
                 int xvec) {
  __shared__ int As[BM * ROW];  // As[m][kq]
  __shared__ int Bs[BN * ROW];  // Bs[n][kq], 4 k-consecutive bytes a word
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const int q = tid + l * THREADS;
      const int row = q / KQ, kq = q % KQ;
      const int gm = m0 + row, k = k0 + kq * 4;
      As[row * ROW + kq] =
          (gm < M && k < k_end)
              ? load_quad(x + (size_t)gm * K + k, k_end - k, xvec)
              : 0;
    }
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const int q = tid + l * THREADS;
      const int col = q % BN, kq = q / BN;
      const int gn = n0 + col;
      int word = 0;
      if (gn < N) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int k = k0 + kq * 4 + b;
          if (k < k_end)
            word |= (int)((uint32_t)(uint8_t)w[(size_t)k * N + gn] << (8 * b));
        }
      }
      Bs[col * ROW + kq] = word;
    }
    __syncthreads();
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * ROW + kq];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * ROW + kq];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) store(out, ws, (size_t)gm * N + gn, acc[i][j], scale[gn]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
mac_skinny_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ out,
                  int* __restrict__ ws, int M, int K, int N, int k_per_split,
                  int xvec, int wvec) {
  __shared__ int red[SK_WARPS][SK_ROWS][SK_COLS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * SK_COLS + lane * 4;  // this lane's 4 columns
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  int acc[SK_ROWS][4];
#pragma unroll
  for (int m = 0; m < SK_ROWS; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0;

  for (int k = k_begin + 4 * warp; k < k_end; k += 4 * SK_WARPS) {
    // rows k..k+3 of this lane's 4 columns, one word per row
    int rw[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      rw[b] = 0;
      if (k + b < k_end && n0 < N)
        rw[b] = load_quad(w + (size_t)(k + b) * N + n0, N - n0, wvec);
    }
    // transpose: col[c] holds rows k..k+3 of column n0 + c
    const int lo01 = __byte_perm(rw[0], rw[1], 0x5140);
    const int hi01 = __byte_perm(rw[0], rw[1], 0x7362);
    const int lo23 = __byte_perm(rw[2], rw[3], 0x5140);
    const int hi23 = __byte_perm(rw[2], rw[3], 0x7362);
    const int col[4] = {__byte_perm(lo01, lo23, 0x5410),
                        __byte_perm(lo01, lo23, 0x7632),
                        __byte_perm(hi01, hi23, 0x5410),
                        __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int m = 0; m < SK_ROWS; ++m) {
      if (m < M) {
        const int xq = load_quad(x + (size_t)m * K + k, k_end - k, xvec);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = __dp4a(xq, col[c], acc[m][c]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < SK_ROWS; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][m][lane * 4 + c] = acc[m][c];
  __syncthreads();
  for (int e = threadIdx.x; e < M * SK_COLS; e += THREADS) {
    const int m = e / SK_COLS, col = e % SK_COLS;
    const int gn = blockIdx.x * SK_COLS + col;
    if (gn >= N) continue;
    int sum = 0;
#pragma unroll
    for (int q = 0; q < SK_WARPS; ++q) sum += red[q][m][col];
    store(out, ws, (size_t)m * N + gn, sum, scale[gn]);
  }
}

// split-K second pass: the summed int32 workspace times the scale
__global__ void scale_kernel(const int* __restrict__ ws,
                             const float* __restrict__ scale,
                             float* __restrict__ out, int M, int N) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) out[i] = __fmul_rn((float)ws[i], scale[i % N]);
}

}  // namespace

// x: (M, K) int8, w: (K, N) int8, scale: (N,) f32, out: (M, N) f32.
// splits > 1 needs ws, an (M, N) int32 workspace this call zeroes;
// k_per_split is a multiple of 32 with splits * k_per_split >= K.  M <= 8
// takes the skinny form.  K * 127^2 must fit int32 (K <= 133,000).
extern "C" int marvel_mac_matmul_int8(const int8_t* x, const int8_t* w,
                                      const float* scale, float* out,
                                      int* ws, int M, int K, int N,
                                      int splits, int k_per_split,
                                      void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int* acc_ws = splits > 1 ? ws : nullptr;
  if (acc_ws != nullptr) {
    cudaError_t err =
        cudaMemsetAsync(acc_ws, 0, (size_t)M * N * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  const int xvec = (K % 4 == 0) && (((uintptr_t)x & 3) == 0);
  if (M <= SK_ROWS) {
    const int wvec = (N % 4 == 0) && (((uintptr_t)w & 3) == 0);
    dim3 grid((N + SK_COLS - 1) / SK_COLS, splits > 1 ? splits : 1);
    mac_skinny_kernel<<<grid, THREADS, 0, s>>>(x, w, scale, out, acc_ws, M,
                                               K, N, k_per_split, xvec, wvec);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits > 1 ? splits : 1);
    mac_tiled_kernel<<<grid, THREADS, 0, s>>>(x, w, scale, out, acc_ws, M, K,
                                              N, k_per_split, xvec);
  }
  int err = (int)cudaGetLastError();
  if (err != 0 || acc_ws == nullptr) return err;
  const size_t total = (size_t)M * N;
  scale_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(acc_ws, scale,
                                                                out, M, N);
  return (int)cudaGetLastError();
}
