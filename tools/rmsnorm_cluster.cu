// The few-row alternative to the rows form of csrc/residual_rmsnorm.cu,
// built and timed only by tools/time_rmsnorm_kernels.py (--variants
// cluster): each row is split over a thread-block cluster of C blocks
// (2..8), each block holds its slice of the row in registers as the rows
// form does, and the blocks add their partial sums of r * r through
// distributed shared memory (every block reads the C partials in rank
// order, so all get the same sum).  The same function and rounding as the
// rows form; only the order of the sum of squares differs.
//
// Entry point: marvel_residual_rmsnorm_cluster, with the signature of
// marvel_residual_rmsnorm: t threads a block, nv vectors a thread, grid =
// R * cluster blocks, rows_per_block 1.
#include <cooperative_groups.h>

#include "residual_rmsnorm.cu"

namespace cg = cooperative_groups;

namespace {

template <typename T, typename S, int NV>
__global__ void __launch_bounds__(ROWS_MAX_THREADS)
residual_rmsnorm_cluster(const T* __restrict__ res, const T* __restrict__ x,
                         const S* __restrict__ scale, T* __restrict__ newres,
                         T* __restrict__ normed, int D, float eps) {
  using V = Vec<T>;
  constexpr int VN = V::N;
  __shared__ float red[ROWS_MAX_THREADS / 32];
  __shared__ float part;
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int t = blockDim.x;
  const int row = blockIdx.x / nc;
  const int nv = D / VN;
  const int per = (nv + nc - 1) / nc;
  const int lo = rank * per;
  const int hi = min(nv, lo + per);
  const size_t base = (size_t)row * D;
  const V* rv = reinterpret_cast<const V*>(res + base);
  const V* xv = reinterpret_cast<const V*>(x + base);

  V a[NV], b[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lo + threadIdx.x + k * t;
    if (i < hi) {
      a[k] = rv[i];
      b[k] = xv[i];
    }
  }
  ScalePack<S, VN> sc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lo + threadIdx.x + k * t;
    if (i < hi) sc[k].load(scale + (size_t)i * VN);
  }
  float r[NV][VN];
  float ss = 0.0f;
  V* ov = reinterpret_cast<V*>(newres + base);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lo + threadIdx.x + k * t;
    if (i < hi) {
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
  const int wlanes = t < 32 ? t : 32;
  const unsigned mask = t < 32 ? (1u << t) - 1u : 0xffffffffu;
  for (int off = wlanes / 2; off > 0; off >>= 1)
    ss += __shfl_xor_sync(mask, ss, off);
  if (t > 32) {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = red[0];
    for (int q = 1; q < t / 32; ++q) ss += red[q];
  }
  if (threadIdx.x == 0) part = ss;
  cluster.sync();
  float total = 0.0f;
  for (int q = 0; q < nc; ++q) total += *cluster.map_shared_rank(&part, q);
  const float var = __fdiv_rn(total, (float)D);
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  V* nv_out = reinterpret_cast<V*>(normed + base);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lo + threadIdx.x + k * t;
    if (i < hi) {
      V o;
#pragma unroll
      for (int j = 0; j < VN; ++j)
        o.v[j] = from_f32<T>(__fmul_rn(__fmul_rn(r[k][j], inv),
                                       sc[k].get(j)));
      nv_out[i] = o;
    }
  }
  cluster.sync();  // the partials stay readable until every block read them
}

template <typename T, typename S, int NV>
int launch_cluster(const void* res, const void* x, const void* scale,
                   void* newres, void* normed, int D, float eps, int t,
                   int grid, int nc, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(t);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, residual_rmsnorm_cluster<T, S, NV>, static_cast<const T*>(res),
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(newres), static_cast<T*>(normed), D, eps);
}

template <typename T, typename S>
int launch_c(const void* res, const void* x, const void* scale, void* newres,
             void* normed, int R, int D, float eps, int t, int nv, int grid,
             int nc, cudaStream_t s) {
  constexpr int VN = 16 / sizeof(T);
  if (nc < 2 || nc > 8 || grid != R * nc || t < 8 || t > ROWS_MAX_THREADS ||
      (t & (t - 1)) || nv < 1 || nv > 4 || D % VN ||
      (D / VN + nc - 1) / nc > t * nv)
    return (int)cudaErrorInvalidValue;
  switch (nv) {
    case 1: return launch_cluster<T, S, 1>(res, x, scale, newres, normed, D, eps, t, grid, nc, s);
    case 2: return launch_cluster<T, S, 2>(res, x, scale, newres, normed, D, eps, t, grid, nc, s);
    case 3: return launch_cluster<T, S, 3>(res, x, scale, newres, normed, D, eps, t, grid, nc, s);
    default: return launch_cluster<T, S, 4>(res, x, scale, newres, normed, D, eps, t, grid, nc, s);
  }
}

}  // namespace

extern "C" int marvel_residual_rmsnorm_cluster(
    const void* res, const void* x, const void* scale, void* newres,
    void* normed, int R, int D, float eps, int is_bf16, int scale_is_bf16,
    int form, int t, int rpb, int nv, int grid, int cluster, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R == 0) return 0;
  if (form != ROWS || rpb != 1) return (int)cudaErrorInvalidValue;
  if (is_bf16 && scale_is_bf16)
    return launch_c<__nv_bfloat16, __nv_bfloat16>(
        res, x, scale, newres, normed, R, D, eps, t, nv, grid, cluster, s);
  if (is_bf16)
    return launch_c<__nv_bfloat16, float>(res, x, scale, newres, normed, R,
                                          D, eps, t, nv, grid, cluster, s);
  if (scale_is_bf16)
    return launch_c<float, __nv_bfloat16>(res, x, scale, newres, normed, R,
                                          D, eps, t, nv, grid, cluster, s);
  return launch_c<float, float>(res, x, scale, newres, normed, R, D, eps, t,
                                nv, grid, cluster, s);
}
