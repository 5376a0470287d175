// zol (rnn_lm): the RWKV-6 chunked WKV recurrence, one block per (b, h).
//
// Replaces the TPU kernel src/repro/kernels/wkv_chunk.py::_kernel
// (pl.pallas_call at wkv_chunk.py:86).
//
// For each chunk of C tokens, with cum the inclusive cumsum of the
// log-decay lw over the chunk and cx = cum - lw (exclusive):
//
//   out[t, j] = sum_i r[t,i] exp(cx[t,i]) S[i,j]                (from-state)
//             + sum_{s<t} A[t,s] v[s,j]                          (intra-chunk)
//             + (sum_i r[t,i] u[i] k[t,i]) v[t,j]                (bonus)
//   A[t, s]   = sum_i r[t,i] k[s,i] exp(cx[t,i] - cum[s,i])      (s < t)
//   S'[i, j]  = exp(cum[C-1,i]) S[i,j]
//             + sum_t k[t,i] exp(cum[C-1,i] - cum[t,i]) v[t,j]
//
// Every exponent is <= 0 (lw < 0), so nothing overflows: the decay between
// two tokens is taken as one exp of a difference of cumsums, never as a
// product exp(cx[t]) * exp(-cum[s]), whose second factor overflows when a
// chunk's decay is strong.  The state S starts at s0 and the final state
// is written out.  S is a whole number of chunks, as in the reference (the
// model zero-pads it).
//
// Layouts: r, k, v, lw and out are (B, S, H, N) f32 read in place (the
// reference wrapper's transpose to (B, H, nc, C, N) is an index here); u
// is (H, N); s0 and sout are (B, H, N, N).
//
// Bound on the H100: bytes at the full-width prefill (4 B S H N f32 in,
// B S H N out, 4 B S H N^2 operations: about 4 operations a byte).  This
// first kernel is bound instead by its own serial work: one block per
// (b, h) walks the chunks in order (the recurrence), keeps the N x N state
// in shared memory for the whole sequence, stages each chunk's r, k, v and
// lw tiles (rows padded to N + 1 floats, so a warp reading 32 rows of one
// column hits 32 banks), and runs the four contractions on CUDA-core FMAs
// with accurate expf.  B H blocks (128 at B = 4, H = 32) fill about one
// wave.  Tensor cores and splitting a sequence across blocks are later
// work.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;

// kernels/wkv_chunk.py::smem_bytes mirrors this
inline size_t smem_floats(int N, int C) {
  const int ld = N + 1;
  return (size_t)N * N + 6 * (size_t)C * ld + (size_t)C * (C + 1) + C + N;
}

__global__ void __launch_bounds__(THREADS)
wkv_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ lw,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ out, float* __restrict__ sout, int S,
                 int H, int N, int C) {
  extern __shared__ float sm[];
  const int ld = N + 1;
  float* st = sm;               // state, st[i * N + j]
  float* rs = st + N * N;       // r tile, rs[t * ld + i]
  float* ks = rs + C * ld;      // k tile
  float* vs = ks + C * ld;      // v tile
  float* cum = vs + C * ld;     // inclusive cumsum of lw
  float* cx = cum + C * ld;     // lw, then cum - lw
  float* wq = cx + C * ld;      // r exp(cx), then k exp(cum[C-1] - cum)
  float* as = wq + C * ld;      // A, as[t * (C + 1) + s]
  float* bonus = as + C * (C + 1);
  float* us = bonus + C;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const size_t sbase = (size_t)bh * N * N;
  for (int e = tid; e < N * N; e += THREADS) st[e] = s0[sbase + e];
  for (int e = tid; e < N; e += THREADS) us[e] = u[h * N + e];

  const int nc = S / C;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * C;
    __syncthreads();  // the previous chunk is done with every tile
    for (int e = tid; e < C * N; e += THREADS) {
      const int t = e / N, i = e % N;
      const size_t g = (((size_t)b * S + t0 + t) * H + h) * N + i;
      rs[t * ld + i] = r[g];
      ks[t * ld + i] = k[g];
      vs[t * ld + i] = v[g];
      cx[t * ld + i] = lw[g];
    }
    __syncthreads();
    // cumsums over t, one column per thread
    for (int i = tid; i < N; i += THREADS) {
      float run = 0.0f;
      for (int t = 0; t < C; ++t) {
        const float l = cx[t * ld + i];
        run = __fadd_rn(run, l);
        cum[t * ld + i] = run;
        cx[t * ld + i] = __fsub_rn(run, l);
      }
    }
    __syncthreads();
    for (int e = tid; e < C * N; e += THREADS) {
      const int t = e / N, i = e % N;
      wq[t * ld + i] = __fmul_rn(rs[t * ld + i], expf(cx[t * ld + i]));
    }
    for (int t = tid; t < C; t += THREADS) {
      float acc = 0.0f;
      for (int i = 0; i < N; ++i)
        acc = fmaf(rs[t * ld + i], __fmul_rn(us[i], ks[t * ld + i]), acc);
      bonus[t] = acc;
    }
    // A: a warp holds one t and 32 consecutive s
    for (int e = tid; e < C * C; e += THREADS) {
      const int t = e / C, s = e % C;
      float acc = 0.0f;
      if (s < t) {
        const float* rt = rs + t * ld;
        const float* ct = cx + t * ld;
        const float* kk = ks + s * ld;
        const float* cs = cum + s * ld;
        for (int i = 0; i < N; ++i)
          acc = fmaf(__fmul_rn(rt[i], kk[i]), expf(ct[i] - cs[i]), acc);
      }
      as[t * (C + 1) + s] = acc;
    }
    __syncthreads();
    // out: a warp holds one t and consecutive j
    for (int e = tid; e < C * N; e += THREADS) {
      const int t = e / N, j = e % N;
      float o_state = 0.0f, o_intra = 0.0f;
      for (int i = 0; i < N; ++i)
        o_state = fmaf(wq[t * ld + i], st[i * N + j], o_state);
      for (int s = 0; s < t; ++s)
        o_intra = fmaf(as[t * (C + 1) + s], vs[s * ld + j], o_intra);
      out[(((size_t)b * S + t0 + t) * H + h) * N + j] =
          __fadd_rn(__fadd_rn(o_state, o_intra),
                    __fmul_rn(bonus[t], vs[t * ld + j]));
    }
    __syncthreads();
    const float* last = cum + (C - 1) * ld;
    for (int e = tid; e < C * N; e += THREADS) {
      const int t = e / N, i = e % N;
      wq[t * ld + i] = __fmul_rn(ks[t * ld + i], expf(last[i] - cum[t * ld + i]));
    }
    __syncthreads();
    // state update: each thread owns its (i, j) elements
    for (int e = tid; e < N * N; e += THREADS) {
      const int i = e / N, j = e % N;
      float acc = 0.0f;
      for (int t = 0; t < C; ++t) acc = fmaf(wq[t * ld + i], vs[t * ld + j], acc);
      st[e] = __fadd_rn(__fmul_rn(expf(last[i]), st[e]), acc);
    }
  }
  __syncthreads();
  for (int e = tid; e < N * N; e += THREADS) sout[sbase + e] = st[e];
}

}  // namespace

// r, k, v, lw, out: (B, S, H, N) f32; u: (H, N); s0, sout: (B, H, N, N).
// One block per (b, h), B * H <= 2^31 - 1, S % C == 0.  Shared memory
// beyond the card's limit fails at cudaFuncSetAttribute and is returned as
// its error.
extern "C" int marvel_wkv_chunk(const float* r, const float* k,
                                const float* v, const float* lw,
                                const float* u, const float* s0, float* out,
                                float* sout, int B, int S, int H, int N,
                                int C, void* stream) {
  if (C <= 0 || S % C != 0) return (int)cudaErrorInvalidValue;
  if (B * H == 0 || N == 0 || S == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = smem_floats(N, C) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv_chunk_kernel<<<B * H, THREADS, smem, s>>>(r, k, v, lw, u, s0, out,
                                                 sout, S, H, N, C);
  return (int)cudaGetLastError();
}
