// zol (rnn_lm): the RWKV-6 chunked WKV recurrence, one block per (b, h,
// chunk), the chunks of a head chained through their states.
//
// Replaces the TPU kernel src/repro/kernels/wkv_chunk.py::_kernel
// (pl.pallas_call at wkv_chunk.py:86).
//
// For each chunk of C tokens, with cum the inclusive cumsum of the
// log-decay lw over the chunk and cx[t] = cum[t-1] (exclusive, 0 at t = 0):
//
//   out[t, j] = sum_i r[t,i] exp(cx[t,i]) S[i,j]                (from-state)
//             + sum_{s<t} A[t,s] v[s,j]                          (intra-chunk)
//             + (sum_i r[t,i] u[i] k[t,i]) v[t,j]                (bonus)
//   A[t, s]   = sum_i r[t,i] k[s,i] exp(cx[t,i] - cum[s,i])      (s < t)
//   S'[i, j]  = exp(cum[C-1,i]) S[i,j] + U[i,j]
//   U[i, j]   = sum_t k[t,i] exp(cum[C-1,i] - cum[t,i]) v[t,j]
//
// S starts at s0 and the final state is written out; S is a whole number
// of chunks, as in the reference (the model zero-pads it).  Layouts: r, k,
// v, lw and out are (B, S, H, N) f32 read in place; u is (H, N); s0 and
// sout are (B, H, N, N).
//
// Bound on the H100: bytes (4 B S H N f32 in, B S H N out: 0.631 ms for
// the 24 launches of an rwkv6-1.6b prefill at B = 4, S = 512, against
// 0.58 ms for its 4 N^2 + 2 C N operations a token and head at the f32
// CUDA-core peak).  The first kernel (one block per (b, h) walking the 8
// chunks in order, an accurate expf in the innermost loop of A) took 524
// us a launch at that shape (H100 80GB HBM3, 700 W): 128 blocks on 132
// SMs, one block an SM for its shared memory, and 131k exps a chunk.  This
// design answers each of those:
//
//   - Chunks in parallel.  Only the state is sequential, and it needs
//     nothing of the chunk but U and the decay exp(cum[C-1]).  Each block
//     (B H nc of them, 1024 at that shape) computes its chunk's A, its
//     intra-chunk output and U from the chunk alone, then waits for the
//     previous chunk's state S_{c-1} (s0 for the first), adds its own
//     (S_c = exp(cum[C-1]) S_{c-1} + U, rounded exactly as the first kernel
//     rounded it, so the final state's bits do not change), publishes S_c
//     with a release flag, and only then runs the from-state product.  The
//     chain of a head is one short step a chunk.  A block draws its chunk
//     from an atomic ticket, chunk-major, so the block it waits on has
//     always started before it: no order of scheduling deadlocks.  The
//     consumer puts the flag back to 0, and the block that draws the last
//     ticket resets the ticket, so the buffer is zero after every launch.
//   - Few exps.  The decay between s and t is factored through a boundary
//     token e with s <= e < t: exp(cx[t] - cum[e]) exp(cum[e] - cum[s]),
//     both exponents <= 0 (never exp(cx[t]) exp(-cum[s]), whose second
//     factor overflows when a chunk decays strongly).  The boundaries are
//     those of a binary split of the chunk into sub-chunks of 16 tokens:
//     at level d each row is either the upper half of its node (r times
//     the first factor) or the lower half (k times the second), one tile a
//     level, so every pair s < t in different sub-chunks is one f32 dot
//     product of two staged rows.  Only the pairs inside a sub-chunk take
//     their exp directly (C * 16 * N / 2 a chunk, from C^2 N / 2).
//   - Loads that overlap.  lw, then r, k and u, then v arrive in three
//     cp.async groups, so the cumsum starts while the rest land; each
//     product reads float4 rows (rows padded by 4 floats, so the rows of a
//     phase fall on different banks) into a register tile summed in
//     ascending order; the head size N is a template argument, so every
//     loop over it unrolls.  About 106 KB of shared memory at N = C = 64,
//     so an SM holds two blocks.
//   - Balanced work.  A thread's intra-chunk output rows are a pair near
//     the top of the chunk and its mirror near the bottom, so every thread
//     sums about the same share of the causal A v; a row run of the
//     elementwise pass lies in one sub-chunk, so its split sides and
//     boundaries are read once.
//
// Measured on an H100 80GB HBM3 at 700 W (tools/time_wkv_kernels.py):
// 0.111 ms a launch at the rwkv6-1.6b prefill's shape, from 0.527.  What
// bounds it now is latency in the short phases between a block's
// barriers, with two blocks an SM to hide it: variants without the
// direct in-sub-chunk exps ran 0.091 ms, without the wait for the previous
// state no faster, with fast exps 2% faster, with 2 x 2 blocks of pairs
// (fewer loads, fewer threads) 8% slower.  The kernel library builds in
// 72.4 s (chip_smoke.py), against 73.6 s before this design.
//
// The sums stay f32 FMAs on the CUDA cores (TF32 or bf16 contractions are
// flagged by chip_smoke.py::wkv_tol).  Two launches on the same inputs give
// the same bits: every sum has a fixed order and the chain carries exact
// values.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SUB = 16;  // tokens of a sub-chunk, whose pairs take direct exps
// levels of the split at most: C N <= 4096 and N >= 8 give C <= 512, 32
// sub-chunks
constexpr int MAX_LEV = 5;

__host__ __device__ inline int split_levels(int nsub) {
  int l = 0;
  while ((1 << l) < nsub) ++l;
  return l;
}

// the block's shared memory, in floats; kernels/wkv_chunk.py::smem_bytes
// mirrors it.  Tiles of C rows of N + 4 floats: r (then r exp(cx)), v, k
// (then k exp(cum[C-1] - cum)), cum (then the level-1 split rows), the
// split rows of levels 2..lev, then A (C rows of C + 4).  The previous
// state (N rows of N + 4) overlays cum onwards once A is read.  Then the
// sub-chunk boundaries' cums (nsub rows of N), the bonus (C) and u (N).
struct Layout {
  int ld, ldc, nsub, lev;
  size_t r, v, k, cum, lvl, a, bnd, bonus, u, total;
};

__host__ __device__ inline Layout layout(int N, int C) {
  Layout L;
  L.ld = N + 4;
  L.ldc = C + 4;
  L.nsub = (C + SUB - 1) / SUB;
  L.lev = split_levels(L.nsub);
  const size_t tile = (size_t)C * L.ld;
  L.r = 0;
  L.v = tile;
  L.k = 2 * tile;
  L.cum = 3 * tile;
  L.lvl = 4 * tile;
  L.a = L.lvl + (size_t)(L.lev > 1 ? L.lev - 1 : 0) * tile;
  size_t end = L.a + (size_t)C * L.ldc;
  const size_t state_end = L.cum + (size_t)N * L.ld;
  if (state_end > end) end = state_end;
  L.bnd = end;
  L.bonus = L.bnd + (size_t)L.nsub * N;
  L.u = L.bonus + C;
  L.total = L.u + N;
  return L;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// one block of the split: level d's upper rows [rlo, rlo + hh) against its
// lower rows [clo, clo + w), and the index e of a microtile inside it
struct SplitTile {
  int d, rlo, hh, clo, w, e;
};

// the block that microtile e of the whole split falls in; false past the
// last block
__device__ bool split_tile(int e, int nsub, int lev, int C, SplitTile& st) {
  for (int d = 1; d <= lev; ++d) {
    for (int base = 0;; base += 1 << d) {
      const int mid = base + (1 << (d - 1));
      if (mid >= nsub) break;
      const int rlo = SUB * mid, clo = SUB * base;
      const int hh = min(SUB * (base + (1 << d)), C) - rlo, w = rlo - clo;
      const int tiles = (hh / 2) * (w / 4);
      if (e < tiles) {
        st = SplitTile{d, rlo, hh, clo, w, e};
        return true;
      }
      e -= tiles;
    }
  }
  return false;
}

__device__ __forceinline__ void wait_flag(const int* f) {
  unsigned tries = 0;
  for (;;) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(f)
                 : "memory");
    if (v != 0) return;
    if (++tries == (1u << 26)) __trap();  // a lost producer: fail, not hang
    __nanosleep(64);
  }
}

// N, the head size, is a template argument, so every loop over it unrolls
template <int N>
__global__ void __launch_bounds__(THREADS, 2)
wkv_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ lw,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ out, float* __restrict__ sout,
                 float* __restrict__ ws, int* __restrict__ sync, int B, int S,
                 int H, int C) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int ticket_s;
  const Layout L = layout(N, C);
  const int ld = L.ld, ldc = L.ldc, nsub = L.nsub, lev = L.lev;
  const int tid = threadIdx.x;
  const int BH = B * H, nc = S / C;
  int* flags = sync + 1;  // flags[bh * nc + c]: S_c published

  if (tid == 0) {
    const int t = atomicAdd(sync, 1);
    if (t == BH * nc - 1) atomicExch(sync, 0);  // every ticket drawn
    ticket_s = t;
  }
  __syncthreads();
  const int c = ticket_s / BH, bh = ticket_s - (ticket_s / BH) * BH;
  const int b = bh / H, h = bh - b * H;

  float* R = sm + L.r;
  float* V = sm + L.v;
  float* K = sm + L.k;
  float* CUM = sm + L.cum;
  float* A = sm + L.a;
  float* BND = sm + L.bnd;
  float* BON = sm + L.bonus;
  float* US = sm + L.u;
  constexpr int nq = N / 4;
  // token t of this chunk starts at float (row0 + t H) N
  const size_t row0 = ((size_t)b * S + (size_t)c * C) * H + h;

  // 0) the chunk's lw, then r, k and u, then v: three cp.async groups, so
  // the cumsum starts while r, k and v land, and A while v does
  const auto stage = [&](float* dst, const float* src) {
    for (int e = tid; e < C * nq; e += THREADS) {
      const int t = e / nq, j = e - t * nq;
      cpa::copy16(dst + t * ld + 4 * j,
                  src + (row0 + (size_t)t * H) * N + 4 * j, 16);
    }
  };
  stage(CUM, lw);
  cpa::commit();
  stage(R, r);
  stage(K, k);
  for (int j = tid; j < nq; j += THREADS)
    cpa::copy16(US + 4 * j, u + (size_t)h * N + 4 * j, 16);
  cpa::commit();
  stage(V, v);
  cpa::commit();
  cpa::wait<2>();
  __syncthreads();

  // 1) the cumsum over t, one column a thread, in order (the state's
  // decays are the first kernel's bit for bit), a sub-chunk's lw loaded
  // at a time, each sub-chunk's last cum kept
  if (tid < N) {
    float run = 0.0f;
    for (int t0 = 0; t0 < C; t0 += SUB) {
      float l[SUB];
#pragma unroll
      for (int j = 0; j < SUB; ++j)
        l[j] = t0 + j < C ? CUM[(t0 + j) * ld + tid] : 0.0f;
#pragma unroll
      for (int j = 0; j < SUB; ++j)
        if (t0 + j < C) {
          run = __fadd_rn(run, l[j]);
          CUM[(t0 + j) * ld + tid] = run;
        }
      BND[(t0 / SUB) * N + tid] = run;
    }
  }
  cpa::wait<1>();
  __syncthreads();

  // 2a) the bonus, on the last C threads (the ones with fewer pairs below)
  for (int t = THREADS - 1 - tid; t >= 0 && t < C; t -= THREADS) {
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 rr = ld4(R + t * ld + i), kk = ld4(K + t * ld + i);
      const float4 uu = ld4(US + i);
      acc = fmaf(rr.x, __fmul_rn(uu.x, kk.x), acc);
      acc = fmaf(rr.y, __fmul_rn(uu.y, kk.y), acc);
      acc = fmaf(rr.z, __fmul_rn(uu.z, kk.z), acc);
      acc = fmaf(rr.w, __fmul_rn(uu.w, kk.w), acc);
    }
    BON[t] = acc;
  }
  // A inside each sub-chunk, direct: pairs t > s enumerated row by row, so
  // a phase's lanes share t and read consecutive rows s; two sums of
  // alternate column quads, added at the end
  {
    int total = 0;
    for (int p = 0; p < nsub; ++p) {
      const int tp = min(SUB, C - SUB * p);
      total += tp * (tp - 1) / 2;
    }
    for (int e = tid; e < total; e += THREADS) {
      int idx = e, p = 0;
      for (;; ++p) {
        const int tp = min(SUB, C - SUB * p), np = tp * (tp - 1) / 2;
        if (idx < np) break;
        idx -= np;
      }
      int tt = 1;
      while (idx >= tt) {
        idx -= tt;
        ++tt;
      }
      const int t = SUB * p + tt, s = SUB * p + idx;
      const float* rt = R + t * ld;
      const float* cxt = CUM + (t - 1) * ld;
      const float* ks = K + s * ld;
      const float* cs = CUM + s * ld;
      float acc[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 a = ld4(rt + i), x = ld4(cxt + i);
        const float4 kk = ld4(ks + i), m = ld4(cs + i);
        float& ac = acc[(i / 4) & 1];
        ac = fmaf(__fmul_rn(a.x, kk.x), expf(x.x - m.x), ac);
        ac = fmaf(__fmul_rn(a.y, kk.y), expf(x.y - m.y), ac);
        ac = fmaf(__fmul_rn(a.z, kk.z), expf(x.z - m.z), ac);
        ac = fmaf(__fmul_rn(a.w, kk.w), expf(x.w - m.w), ac);
      }
      A[t * ldc + s] = __fadd_rn(acc[0], acc[1]);
    }
    // the entries s >= t that the intra-chunk product reads (its 4-row
    // groups run s up to the group's end)
    for (int t = tid; t < C; t += THREADS)
      for (int s = t; s <= (t | 3); ++s) A[t * ldc + s] = 0.0f;
  }

  // 2b) elementwise, a thread a column and a run of rows inside one
  // sub-chunk (runs of a power of two <= 16 rows): r exp(cx) over r, k
  // exp(cum[C-1] - cum) over k, and each level's split rows (level 1 over
  // cum: a thread overwrites only its own elements, and reads its run's
  // first cx before the barrier).  A row's side of each level's split and
  // its boundary depend only on its sub-chunk, so they are read once.
  {
    const int runs = min(C, THREADS / N);
    int len = 1;
    while (len * runs < C) len *= 2;
    const int i = tid % N, run = tid / N;
    const int ta = run * len, tb = run < runs ? min(C, ta + len) : ta;
    float prev = (ta > 0 && ta < tb) ? CUM[(ta - 1) * ld + i] : 0.0f;
    const int q = ta / SUB;
    float bound[MAX_LEV];
    bool used[MAX_LEV], upper[MAX_LEV];
#pragma unroll
    for (int d = 1; d <= MAX_LEV; ++d) {
      const int mid = ((q >> d) << d) + (1 << (d - 1));
      used[d - 1] = d <= lev && mid < nsub;
      upper[d - 1] = q >= mid;
      // cum at the boundary token 16 mid - 1
      bound[d - 1] = used[d - 1] ? BND[(mid - 1) * N + i] : 0.0f;
    }
    const float last = BND[(nsub - 1) * N + i];
    __syncthreads();
#pragma unroll 4
    for (int t = ta; t < tb; ++t) {
      const int x = t * ld + i;
      const float rr = R[x], kk = K[x], cum = CUM[x], cx = prev;
      R[x] = __fmul_rn(rr, expf(cx));
      K[x] = __fmul_rn(kk, expf(last - cum));
#pragma unroll
      for (int d = 1; d <= MAX_LEV; ++d) {
        if (d > lev) break;
        const float e = bound[d - 1];
        const float val =
            __fmul_rn(upper[d - 1] ? rr : kk,
                      expf(upper[d - 1] ? cx - e : e - cum));
        float* Ld = d == 1 ? CUM : sm + L.lvl + (size_t)(d - 2) * C * ld;
        Ld[x] = used[d - 1] ? val : 0.0f;
      }
      prev = cum;
    }
  }
  __syncthreads();

  // 3) A across sub-chunks: each split block (upper rows x lower rows of a
  // node) is a product of two row sets of its level's tile; microtile
  // (ti, si) takes rows ti + hh/2 a and columns si + w/4 b
  for (int e0 = tid;; e0 += THREADS) {
    SplitTile st;
    if (!split_tile(e0, nsub, lev, C, st)) break;
    const int rlo = st.rlo, clo = st.clo, hs = st.hh / 2, wsd = st.w / 4;
    const int ti = st.e / wsd, si = st.e - ti * wsd;
    const float* Ld =
        st.d == 1 ? CUM : sm + L.lvl + (size_t)(st.d - 2) * C * ld;
    float acc[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) acc[a][bb] = 0.0f;
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      float4 x[2], y[4];
#pragma unroll
      for (int a = 0; a < 2; ++a) x[a] = ld4(Ld + (rlo + ti + hs * a) * ld + i);
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        y[bb] = ld4(Ld + (clo + si + wsd * bb) * ld + i);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          acc[a][bb] = fmaf(x[a].x, y[bb].x, acc[a][bb]);
          acc[a][bb] = fmaf(x[a].y, y[bb].y, acc[a][bb]);
          acc[a][bb] = fmaf(x[a].z, y[bb].z, acc[a][bb]);
          acc[a][bb] = fmaf(x[a].w, y[bb].w, acc[a][bb]);
        }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        A[(rlo + ti + hs * a) * ldc + clo + si + wsd * bb] = acc[a][bb];
  }
  cpa::wait<0>();  // v
  __syncthreads();

  // 4) from the chunk alone: the intra-chunk output and U.  A thread's
  // output rows are two pairs, 2 tg, 2 tg + 1 and C - 2 - 2 tg, C - 1 -
  // 2 tg (columns 4 jg..), so that every thread's causal share of A v is
  // the same; a pair reads A up to its 4-row group's end.  U's rows are
  // 4 tg.. (i), its columns 4 jg.. (j).
  const int tg = tid / nq, jg = tid - (tid / nq) * nq;
  const bool has_o = tid < (C / 4) * nq, has_u = tid < nq * nq;
  const int rows[4] = {2 * tg, 2 * tg + 1, C - 2 - 2 * tg, C - 1 - 2 * tg};
  float o[4][4], uacc[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) o[x][y] = uacc[x][y] = 0.0f;
  if (has_o) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r0 = rows[2 * half], s_end = (r0 + 2 + 3) & ~3;
      for (int s = 0; s < s_end; s += 4) {
        float4 a[2], vv[4];
#pragma unroll
        for (int x = 0; x < 2; ++x) a[x] = ld4(A + (r0 + x) * ldc + s);
#pragma unroll
        for (int y = 0; y < 4; ++y) vv[y] = ld4(V + (s + y) * ld + 4 * jg);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const float av = at(a[x], q);
            float* ox = o[2 * half + x];
            ox[0] = fmaf(av, vv[q].x, ox[0]);
            ox[1] = fmaf(av, vv[q].y, ox[1]);
            ox[2] = fmaf(av, vv[q].z, ox[2]);
            ox[3] = fmaf(av, vv[q].w, ox[3]);
          }
      }
    }
  }
  if (has_u) {
#pragma unroll 4
    for (int t = 0; t < C; ++t) {
      const float4 kd = ld4(K + t * ld + 4 * tg), vv = ld4(V + t * ld + 4 * jg);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float kv = at(kd, x);
        uacc[x][0] = fmaf(kv, vv.x, uacc[x][0]);
        uacc[x][1] = fmaf(kv, vv.y, uacc[x][1]);
        uacc[x][2] = fmaf(kv, vv.z, uacc[x][2]);
        uacc[x][3] = fmaf(kv, vv.w, uacc[x][3]);
      }
    }
  }
  __syncthreads();  // A and the split tiles are read: the state may land

  // 5) the previous chunk's state (s0 for the first), over cum onwards
  float* SP = CUM;
  const float* src = s0 + (size_t)bh * N * N;
  if (c > 0) {
    int* f = flags + (size_t)bh * nc + c - 1;
    if (tid == 0) {
      wait_flag(f);
      *f = 0;  // its one reader: zero again for the next launch
    }
    __syncthreads();
    src = ws + ((size_t)bh * (nc - 1) + c - 1) * N * N;
  }
  for (int e = tid; e < N * nq; e += THREADS) {
    const int row = e / nq, j = e - row * nq;
    cpa::copy16(SP + row * ld + 4 * j, src + (size_t)row * N + 4 * j, 16);
  }
  cpa::commit();
  cpa::wait<0>();
  __syncthreads();

  // 6) S_c = exp(cum[C-1]) S_{c-1} + U, published for the next chunk (the
  // last chunk's is the final state)
  if (has_u) {
    float* dst = c < nc - 1 ? ws + ((size_t)bh * (nc - 1) + c) * N * N
                            : sout + (size_t)bh * N * N;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = 4 * tg + x;
      const float dec = expf(BND[(nsub - 1) * N + i]);
      const float4 sp = ld4(SP + i * ld + 4 * jg);
      const float4 sn = make_float4(
          __fadd_rn(__fmul_rn(dec, sp.x), uacc[x][0]),
          __fadd_rn(__fmul_rn(dec, sp.y), uacc[x][1]),
          __fadd_rn(__fmul_rn(dec, sp.z), uacc[x][2]),
          __fadd_rn(__fmul_rn(dec, sp.w), uacc[x][3]));
      __stcg(reinterpret_cast<float4*>(dst + (size_t)i * N + 4 * jg), sn);
    }
  }
  if (c < nc - 1) {
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(
                       flags + (size_t)bh * nc + c),
                   "r"(1)
                   : "memory");
    }
  }

  // 7) the from-state term, then out = (from-state + intra) + bonus v
  if (has_o) {
    float os[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) os[x][y] = 0.0f;
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      float4 a[4], sv[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) a[x] = ld4(R + rows[x] * ld + i);
#pragma unroll
      for (int y = 0; y < 4; ++y) sv[y] = ld4(SP + (i + y) * ld + 4 * jg);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float av = at(a[x], q);
          os[x][0] = fmaf(av, sv[q].x, os[x][0]);
          os[x][1] = fmaf(av, sv[q].y, os[x][1]);
          os[x][2] = fmaf(av, sv[q].z, os[x][2]);
          os[x][3] = fmaf(av, sv[q].w, os[x][3]);
        }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int t = rows[x];
      const float4 vv = ld4(V + t * ld + 4 * jg);
      const float bon = BON[t];
      const float4 y = make_float4(
          __fadd_rn(__fadd_rn(os[x][0], o[x][0]), __fmul_rn(bon, vv.x)),
          __fadd_rn(__fadd_rn(os[x][1], o[x][1]), __fmul_rn(bon, vv.y)),
          __fadd_rn(__fadd_rn(os[x][2], o[x][2]), __fmul_rn(bon, vv.z)),
          __fadd_rn(__fadd_rn(os[x][3], o[x][3]), __fmul_rn(bon, vv.w)));
      *reinterpret_cast<float4*>(out + (row0 + (size_t)t * H) * N + 4 * jg) =
          y;
    }
  }
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, const float* s0, float* out, float* sout,
           float* ws, int* sync, int B, int S, int H, int C, int smem,
           cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      wkv_chunk_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  wkv_chunk_kernel<N><<<B * H * (S / C), THREADS, smem, s>>>(
      r, k, v, lw, u, s0, out, sout, ws, sync, B, S, H, C);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of one block, bytes (0 where the kernel does not take the
// shape: N one of 8, 16, 32, 64, C a multiple of 4 and C N <= 4096, so
// that one 4 x 4 output tile a thread covers the chunk's output and the
// state).
extern "C" int marvel_wkv_chunk_smem(int N, int C) {
  if ((N != 8 && N != 16 && N != 32 && N != 64) || C <= 0 || C % 4 ||
      C * N > 4096)
    return 0;
  return (int)(layout(N, C).total * sizeof(float));
}

// r, k, v, lw, out: (B, S, H, N) f32; u: (H, N); s0, sout: (B, H, N, N);
// every pointer 16-byte aligned.  ws: (B H (S/C - 1), N, N) f32 scratch for
// the published states; sync: 1 + B H (S/C) int32, zero before the launch
// and zero after it.  B H S/C blocks, S % C == 0.  Launches that share
// sync must be ordered on one stream.
extern "C" int marvel_wkv_chunk(const float* r, const float* k,
                                const float* v, const float* lw,
                                const float* u, const float* s0, float* out,
                                float* sout, float* ws, int* sync, int B,
                                int S, int H, int N, int C, void* stream) {
  const int smem = marvel_wkv_chunk_smem(N, C);
  if (smem == 0 || S % C != 0) return (int)cudaErrorInvalidValue;
  if (B * H == 0 || S == 0) return 0;
  const void* ptrs[] = {r, k, v, lw, u, s0, out, sout};
  for (const void* p : ptrs)
    if (((uintptr_t)p & 15) != 0) return (int)cudaErrorInvalidValue;
  if (S / C > 1 && (ws == nullptr || ((uintptr_t)ws & 15) != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (N) {
    case 64: return launch<64>(r, k, v, lw, u, s0, out, sout, ws, sync, B, S, H, C, smem, s);
    case 32: return launch<32>(r, k, v, lw, u, s0, out, sout, ws, sync, B, S, H, C, smem, s);
    case 16: return launch<16>(r, k, v, lw, u, s0, out, sout, ws, sync, B, S, H, C, smem, s);
    case 8: return launch<8>(r, k, v, lw, u, s0, out, sout, ws, sync, B, S, H, C, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
