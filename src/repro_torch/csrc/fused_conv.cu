// conv_mac / acc_mac: int8 NHWC implicit-GEMM conv with the f32 epilogue,
// on int8 tensor cores; the same kernel runs the int8 GEMM (mac_matmul.cu).
//
// Replaces the TPU kernel src/repro/kernels/fused_conv.py::_kernel
// (pl.pallas_call at fused_conv.py:134).
//
//   out[n, oh, ow, co] = act(acc * es[co] + eb[co] [+ res[n, oh, ow, co]])
//   acc = sum_{kh, kw, ci} x[n, oh*s - top + kh, ow*s - left + kw, ci]
//                          * w[kh, kw, ci, co]                  (int32, exact)
//
// GEMM view: M = N*Ho*Wo output pixels, Ncol = Cout, K = KH*KW*Cin in the
// (kh, kw, ci) order of the HWIO weights, so w is already a row-major
// (K, Cout) matrix.  Bound on the H100: at the CNN forwards' sizes the
// int8 products take a few microseconds or less at the 1,979 TOP/s
// tensor-core rate and the bytes less still, so a launch is bound by its
// latency: the chain of loads, products and (split K) the partials' round
// trip, above the ~2 us any launch takes.  Design (the tiles, fragment
// maps and staged layouts are in imma.cuh):
//   - the products run on the tensor cores, mma.sync m16n8k32 s8 x s8 ->
//     s32 (exact), one warp a 16*MI x 32*NG piece of the block's tile;
//   - a ring of STAGES K steps of 64 in shared memory, filled by cp.async,
//     so the next steps' loads are in flight during this step's products:
//     the patch tile (A) is gathered from the image by 16-byte copies where
//     Cin % 16 == 0, 8- or 4-byte copies where Cin is a multiple of those,
//     each copy's source outside the image or past the slice's K given
//     src_bytes = 0, so SAME and VALID padding and ragged edges need no
//     branch and no padded copy; the weight tile (B) by 16-byte copies along
//     N (4-byte copies or byte loads where Cout is not a multiple of 16);
//   - where Cin is not a multiple of 4 (the stem's Cin = 3) the patch tile
//     takes byte loads into registers, issued when a step is fetched and
//     stored after the current step's products; that form is built for the
//     two tiles of BYTE_TILES only, so no other launch holds its registers;
//   - B's column quads are built in registers with __byte_perm from the
//     staged (K, N) rows (no transposed copy of the weights is made);
//   - one tile per shape from kernels/fused_conv.py::imma_plan: BM from 16
//     to 128 output pixels, BN of 32, 64 or 128 columns (DenseNet121's Cout
//     = 32 runs in 32-wide tiles), and a split of K where the tiles alone
//     leave the card's SMs idle;
//   - split K in the same launch: each slice writes its int32 partial tile
//     in its threads' register order, counts in on an int32 counter of its
//     tile with an acq_rel atomic after the block's barrier, and the block
//     that counts last adds the slices in order 0..S-1 (loading several
//     slices at a time), runs the epilogue and puts the counter back to 0.
//     The counters are the f32 GEMM's (kernels/matmul_epilogue.py::
//     _counters), allocated once per device, zero between launches;
//   - the patch origin of each row and the (kh, kw, ci) of each K step come
//     from divisions by Wo, Ho, Cin and KW done as a multiply-high and a
//     shift (FastDiv), and the epilogue clamps for the conv's three acts
//     instead of calling marvel::apply_act: on the H100 the integer divides
//     and apply_act's inlined silu and gelu each cost a launch up to
//     microseconds (tools/bisect_imma_kernel.py times builds with each
//     put back; PERF.md).
// The epilogue runs on the register tile and writes f32 once, a float4 at a
// time where Cout % 4 == 0; with eb null (the GEMM) it is f32(acc) * es.
#include <cstdint>

#include "epilogue.cuh"
#include "imma.cuh"

namespace {

using imma::BK;

template <int BM_, int BN_, int WM, int WN, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
  static constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int MI = WM / 16, NG = WN / 32, NT = 4 * NG;
  static constexpr int WM_ = WM, WN_ = WN;
  static constexpr int A_BYTES = BM * BK, STAGE = A_BYTES + BK * BN;
  static constexpr int SMEM = STAGES * STAGE;
  // 16-byte units a thread stages a step: A rows (4 units a row, the
  // thread's unit column fixed at tid % 4), B units
  static constexpr int RA = (4 * BM + THREADS - 1) / THREADS;
  static constexpr int RB = 4 * BN / THREADS;
  static_assert(WM % 16 == 0 && WN % 32 == 0 && BM % WM == 0 &&
                BN % WN == 0 && (4 * BN) % THREADS == 0, "tile");
};

// n / d for 0 <= n < 2^31 as a multiply-high and a shift (the divisor's
// multiplier computed once on the host), for the divisions by Cin, KW, Wo
// and Ho
struct FastDiv {
  uint32_t d, mul, shr;
  static FastDiv make(int d) {
    if (d <= 1) return {1u, 0u, 0u};
    int l = 0;
    while ((1u << l) < (uint32_t)d) ++l;  // ceil(log2 d)
    const uint64_t p = 31 + l;
    return {(uint32_t)d, (uint32_t)(((1ull << p) + d - 1) / d),
            (uint32_t)(p - 32)};
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)(__umulhi((uint32_t)n, mul) >> shr);
  }
};

struct Params {
  imma::Conv p;
  int M, K;
  int xv;  // bytes a copy of the patch tile: 16, 8, 4 or 1 (byte loads)
  int wv;  // bytes a copy of the weight tile: 16, 4 or 1
  FastDiv cin, kw, wo, ho;
};

struct Row {  // one output pixel's patch origin
  int img, ih0, iw0;
  bool ok;
};

// k = (kh * KW + kw) * Cin + ci
__device__ __forceinline__ void k_coords(int k, const Params& q, int& kh,
                                        int& kw, int& ci) {
  const int t = q.cin.div(k);
  ci = k - t * q.p.Cin;
  kh = q.kw.div(t);
  kw = t - kh * q.p.KW;
}

// the patch tile of K step [k0, k0 + 64) by cp.async (Cin a multiple of
// 4): this thread's unit column u = tid % 4 of rows tid / 4 + r * THREADS / 4
template <class T>
__device__ __forceinline__ void stage_a(uint8_t* As, const Params& q,
                                        const Row (&rows)[T::RA], int k0,
                                        int k_end, int tid) {
  const imma::Conv& p = q.p;
  const int u = tid & 3, kq = k0 + 16 * u;
  for (int j = 0; j < 16; j += q.xv) {
    const int k = kq + j;
    int kh, kw, ci;
    k_coords(k, q, kh, kw, ci);
    const bool kin = k < k_end;
#pragma unroll
    for (int r = 0; r < T::RA; ++r) {
      const int row = (tid >> 2) + r * (T::THREADS / 4);
      if (T::RA * T::THREADS > 4 * T::BM && row >= T::BM) break;
      const int ih = rows[r].ih0 + kh, iw = rows[r].iw0 + kw;
      const bool ok = kin && rows[r].ok && ih >= 0 && ih < p.H && iw >= 0 &&
                      iw < p.W;
      const int8_t* src =
          ok ? p.x + rows[r].img + (ih * p.W + iw) * p.Cin + ci : p.x;
      uint8_t* dst = As + imma::a_off(row, u) + j;
      if (q.xv == 16)
        cpa::copy16(dst, src, ok ? 16 : 0);
      else if (q.xv == 8)
        cpa::copy8(dst, src, ok ? 8 : 0);
      else
        cpa::copy4(dst, src, ok ? 4 : 0);
    }
  }
}

// a byte of read-only global memory, loaded where it stands (kept in order
// with the copies and products, as cpa::load_now)
__device__ __forceinline__ uint32_t load_u8(const int8_t* p) {
  unsigned short v;
  asm volatile("ld.global.nc.u8 %0, [%1];\n" : "=h"(v) : "l"(p));
  return v;
}

// the patch bytes of one K step where Cin is not a multiple of 4 (the
// stem's Cin = 3): loaded into registers when the step is fetched and
// stored into its slot after this step's products (put_a), so their
// latency overlaps the products; the unit's 16 k are stepped through
// (kh, kw, ci) once, shared by the thread's rows
template <class T>
struct PatchBytes {
  uint32_t v[T::RA][16];
};

template <class T>
__device__ __forceinline__ void fetch_a(PatchBytes<T>& h, const Params& q,
                                        const Row (&rows)[T::RA], int k0,
                                        int k_end, int tid) {
  const imma::Conv& p = q.p;
  const int kq = k0 + 16 * (tid & 3);
  int kh, kw, ci;
  k_coords(kq, q, kh, kw, ci);
#pragma unroll
  for (int b = 0; b < 16; ++b) {
#pragma unroll
    for (int r = 0; r < T::RA; ++r) {
      const int ih = rows[r].ih0 + kh, iw = rows[r].iw0 + kw;
      h.v[r][b] = 0;
      if (kq + b < k_end && rows[r].ok && ih >= 0 && ih < p.H && iw >= 0 &&
          iw < p.W)
        h.v[r][b] = load_u8(p.x + rows[r].img + (ih * p.W + iw) * p.Cin + ci);
    }
    if (++ci == p.Cin) {
      ci = 0;
      if (++kw == p.KW) {
        kw = 0;
        ++kh;
      }
    }
  }
}

template <class T>
__device__ __forceinline__ void put_a(uint8_t* As, const PatchBytes<T>& h,
                                      int tid) {
#pragma unroll
  for (int r = 0; r < T::RA; ++r) {
    const int row = (tid >> 2) + r * (T::THREADS / 4);
    if (T::RA * T::THREADS > 4 * T::BM && row >= T::BM) break;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = h.v[r][4 * i] | h.v[r][4 * i + 1] << 8 |
             h.v[r][4 * i + 2] << 16 | h.v[r][4 * i + 3] << 24;
    *reinterpret_cast<uint4*>(As + imma::a_off(row, tid & 3)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// the weight tile of K step [k0, k0 + 64), columns [n0, n0 + BN)
template <class T>
__device__ __forceinline__ void stage_b(uint8_t* Bs, const Params& q, int k0,
                                        int k_end, int n0, int tid) {
  const imma::Conv& p = q.p;
  constexpr int U = T::BN / 16;
#pragma unroll
  for (int i = 0; i < T::RB; ++i) {
    const int L = tid + i * T::THREADS;
    const int k = L / U, u = L % U;
    const int gk = k0 + k, gn = n0 + 16 * u;
    uint8_t* dst = Bs + imma::b_off<T::BN>(k, u);
    const bool kin = gk < k_end;
    if (q.wv == 16) {
      const bool ok = kin && gn < p.Cout;
      cpa::copy16(dst, ok ? p.w + gk * p.Cout + gn : p.w, ok ? 16 : 0);
    } else if (q.wv == 4) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const bool ok = kin && gn + 4 * s < p.Cout;
        cpa::copy4(dst + 4 * s, ok ? p.w + gk * p.Cout + gn + 4 * s : p.w,
                   ok ? 4 : 0);
      }
    } else {
      uint32_t wd[4] = {0, 0, 0, 0};
      if (kin) {
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (gn + b < p.Cout)
            wd[b >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                              p.w[gk * p.Cout + gn + b]))
                          << (8 * (b & 3));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  }
}

// block (blockIdx.x, blockIdx.y) owns the BM x BN output tile at
// (m0, n0), blockIdx.z its slice [z * k_per_split, ...) of K.  BYTES: the
// patch tile by byte loads (Cin not a multiple of 4), built only for the
// tiles of BYTE_TILES, so no other launch holds their registers
template <class T, bool BYTES>
__global__ void __launch_bounds__(T::THREADS) imma_conv_kernel(Params q) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int last;
  const imma::Conv& p = q.p;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp % T::WARPS_M) * T::WM_;
  const int wn0 = (warp / T::WARPS_M) * T::WN_;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  const int z = blockIdx.z;
  const int k_begin = z * p.k_per_split;
  const int k_end = min(q.K, k_begin + p.k_per_split);
  const int n_kt = max(0, (k_end - k_begin + BK - 1) / BK);

  Row rows[T::RA];
#pragma unroll
  for (int r = 0; r < T::RA; ++r) {
    const int row = (tid >> 2) + r * (T::THREADS / 4);
    const int gm = m0 + row;
    const bool ok = row < T::BM && gm < q.M;
    const int mm = ok ? gm : 0;
    const int t = q.wo.div(mm), ow = mm - t * p.Wo;
    const int n = q.ho.div(t), oh = t - n * p.Ho;
    rows[r] = {n * p.H * p.W * p.Cin, oh * p.stride - p.top,
               ow * p.stride - p.left, ok};
  }

  // the ring: steps 0 .. STAGES-2 in flight before the first product; one
  // commit group a step (empty past the slice's end, so the counts match)
  PatchBytes<T> held;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < n_kt) {
      uint8_t* st = smem + s * T::STAGE;
      if constexpr (BYTES) {
        fetch_a<T>(held, q, rows, k_begin + s * BK, k_end, tid);
        put_a<T>(st, held, tid);
      } else {
        stage_a<T>(st, q, rows, k_begin + s * BK, k_end, tid);
      }
      stage_b<T>(st + T::A_BYTES, q, k_begin + s * BK, k_end, n0, tid);
    }
    cpa::commit();
  }

  // the epilogue's per-column operands, loaded while the ring fills: this
  // lane's columns 8t..8t+7 of each of its 32-column groups
  float es8[T::NG][8], eb8[T::NG][8];
#pragma unroll
  for (int G = 0; G < T::NG; ++G)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int gn = n0 + wn0 + 32 * G + 8 * (lane & 3) + c;
      es8[G][c] = gn < p.Cout ? cpa::load_now(p.es + gn) : 0.0f;
      eb8[G][c] =
          p.eb != nullptr && gn < p.Cout ? cpa::load_now(p.eb + gn) : 0.0f;
    }

  int acc[T::MI][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  for (int kt = 0; kt < n_kt; ++kt) {
    cpa::wait<T::STAGES - 2>();
    __syncthreads();  // step kt landed; step kt-1's slot is free
    const int pf = kt + T::STAGES - 1;
    uint8_t* pf_slot = smem + (pf % T::STAGES) * T::STAGE;
    if (pf < n_kt) {
      if constexpr (BYTES)
        fetch_a<T>(held, q, rows, k_begin + pf * BK, k_end, tid);
      else
        stage_a<T>(pf_slot, q, rows, k_begin + pf * BK, k_end, tid);
      stage_b<T>(pf_slot + T::A_BYTES, q, k_begin + pf * BK, k_end, n0, tid);
    }
    cpa::commit();
    const uint8_t* As = smem + (kt % T::STAGES) * T::STAGE;
    const uint8_t* Bs = As + T::A_BYTES;
    // a step's zero-filled tail past k_end adds nothing: stop at its end
    const int kt_len = k_end - (k_begin + kt * BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      if (kk >= kt_len) break;
      uint32_t a[T::MI][4];
#pragma unroll
      for (int i = 0; i < T::MI; ++i)
        imma::load_a(a[i], As, wm0 + 16 * i, kk, lane);
#pragma unroll
      for (int G = 0; G < T::NG; ++G) {
        uint32_t b[4][2];
        imma::load_b<T::BN>(b, Bs, wn0 + 32 * G, kk, lane);
#pragma unroll
        for (int i = 0; i < T::MI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            imma::mma(acc[i][4 * G + j], a[i], b[j][0], b[j][1]);
      }
    }
    if constexpr (BYTES)
      if (pf < n_kt) put_a<T>(pf_slot, held, tid);
  }
  cpa::wait<0>();

  if (p.splits > 1) {
    // every slice writes its partial tile in its threads' register order;
    // after the block's barrier one thread counts the slice in with an
    // acq_rel atomic (releasing the block's writes, acquiring the other
    // slices'); the block that counts last adds the slices in order
    constexpr int V = T::MI * T::NT;  // int4 a thread
    constexpr int PART = T::BM * T::BN / 4;  // int4 a slice's tile
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    int4* part = reinterpret_cast<int4*>(p.ws) + (size_t)tile * p.splits * PART;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int(&v)[4] = acc[e / T::NT][e % T::NT];
      __stcg(part + (size_t)z * PART + e * T::THREADS + tid,
             make_int4(v[0], v[1], v[2], v[3]));
    }
    __syncthreads();
    if (tid == 0) {
      int prev;
      asm volatile("atom.acq_rel.gpu.add.s32 %0, [%1], 1;\n"
                   : "=r"(prev)
                   : "l"(p.counters + tile)
                   : "memory");
      last = prev == p.splits - 1;
    }
    __syncthreads();
    if (!last) return;
    // the other slices' partials loaded SB slices at a time (one round
    // trip per SB slices), then added in slice order
    constexpr int SB = V >= 16 ? 1 : 16 / V;
    int sum[V][4];
#pragma unroll
    for (int e = 0; e < V; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[e][c] = 0;
    for (int s0 = 0; s0 < p.splits; s0 += SB) {
      int4 v[SB][V];
#pragma unroll
      for (int u = 0; u < SB; ++u)
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (s0 + u < p.splits && s0 + u != z)
            v[u][e] = __ldcg(part + (size_t)(s0 + u) * PART +
                             e * T::THREADS + tid);
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        const int sl = s0 + u;
        if (sl >= p.splits) break;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int(&own)[4] = acc[e / T::NT][e % T::NT];
          const int4 val = sl == z ? make_int4(own[0], own[1], own[2], own[3])
                                   : v[u][e];
          sum[e][0] += val.x;
          sum[e][1] += val.y;
          sum[e][2] += val.z;
          sum[e][3] += val.w;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[e / T::NT][e % T::NT][c] = sum[e][c];
    if (tid == 0) p.counters[tile] = 0;  // ready for the next launch
  }

  // the epilogue on the register tile: rows g and g+8 of each m16 tile,
  // 8 contiguous columns of each 32-column group
  const bool vec_out = (p.Cout & 3) == 0;
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm0 + 16 * i + (lane >> 2) + 8 * h;
      if (gm >= q.M) continue;
      const size_t row = (size_t)gm * p.Cout;
#pragma unroll
      for (int G = 0; G < T::NG; ++G) {
        const int c0 = n0 + wn0 + 32 * G + 8 * (lane & 3);
        float y[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float a = (float)acc[i][4 * G + (c & 3)][2 * h + (c >> 2)];
          if (p.eb == nullptr) {
            y[c] = __fmul_rn(a, es8[G][c]);
          } else {
            float v = __fadd_rn(__fmul_rn(a, es8[G][c]), eb8[G][c]);
            if (p.res != nullptr && c0 + c < p.Cout)
              v = __fadd_rn(v, p.res[row + c0 + c]);
            // the conv's acts (none, relu, relu6) as marvel::apply_act
            // computes them, without its switch over silu and gelu, whose
            // inlined code slows every launch (see the header)
            if (p.act != marvel::kNone) {
              v = fmaxf(v, 0.0f);
              if (p.act == marvel::kRelu6) v = fminf(v, 6.0f);
            }
            y[c] = v;
          }
        }
#pragma unroll
        for (int hv = 0; hv < 2; ++hv) {
          const int col = c0 + 4 * hv;
          if (vec_out) {
            if (col < p.Cout)
              *reinterpret_cast<float4*>(p.out + row + col) = make_float4(
                  y[4 * hv], y[4 * hv + 1], y[4 * hv + 2], y[4 * hv + 3]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (col + c < p.Cout) p.out[row + col + c] = y[4 * hv + c];
          }
        }
      }
    }
}

template <class T, bool BYTES = false>
int launch_tile(const Params& q, cudaStream_t s) {
  auto kern = imma_conv_kernel<T, BYTES>;
  // the ring is dynamic shared memory; with the kernel's own static word
  // it may pass the 48 KB a launch gets without asking
  if (T::SMEM + 16 > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((q.M + T::BM - 1) / T::BM, (q.p.Cout + T::BN - 1) / T::BN,
            q.p.splits);
  kern<<<grid, T::THREADS, T::SMEM, s>>>(q);
  return (int)cudaGetLastError();
}

int vec_bytes(const void* base, int row, int widest) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  for (int v = widest; v >= 4; v /= 2)
    if (row % v == 0 && a % v == 0) return v;
  return 1;
}

// ---------------------------------------------------------------------------
// one tile of products through the same fragment maps and staged layouts
// ---------------------------------------------------------------------------

// a: (16, 64) and b: (64, BN) int8 row-major, out: (16, BN) int32 = a @ b
template <int BN>
__global__ void imma_selftest_kernel(const int8_t* a, const int8_t* b,
                                     int* out) {
  __shared__ __align__(128) uint8_t As[16 * BK], Bs[BK * BN];
  const int lane = threadIdx.x;
  for (int e = lane; e < 16 * 4; e += 32)
    *reinterpret_cast<uint4*>(As + imma::a_off(e / 4, e % 4)) =
        *reinterpret_cast<const uint4*>(a + e * 16);
  for (int e = lane; e < BK * BN / 16; e += 32)
    *reinterpret_cast<uint4*>(
        Bs + imma::b_off<BN>(e / (BN / 16), e % (BN / 16))) =
        *reinterpret_cast<const uint4*>(b + e * 16);
  __syncwarp();
  int acc[BN / 8][4] = {};
  for (int kk = 0; kk < BK; kk += 32) {
    uint32_t af[4];
    imma::load_a(af, As, 0, kk, lane);
#pragma unroll
    for (int G = 0; G < BN / 32; ++G) {
      uint32_t bf[4][2];
      imma::load_b<BN>(bf, Bs, 32 * G, kk, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        imma::mma(acc[4 * G + j], af, bf[j][0], bf[j][1]);
    }
  }
#pragma unroll
  for (int G = 0; G < BN / 32; ++G)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[((lane >> 2) + 8 * (c >> 1)) * BN + 32 * G +
            imma::d_col(lane, j, c)] = acc[4 * G + j][c];
}

}  // namespace

namespace imma {

// the tiles, by the index kernels/fused_conv.py::IMMA_TILES gives them:
// (BM, BN, warp rows, warp columns, stages of the ring); a patch tile of
// byte loads only in the tiles of BYTE_TILES
int launch(const Conv& p, cudaStream_t s) {
  const int M = p.N * p.Ho * p.Wo, K = p.KH * p.KW * p.Cin;
  if (M <= 0 || p.Cout <= 0) return 0;
  if (p.splits < 1 || p.k_per_split % BK != 0 ||
      (p.splits > 1 && (p.ws == nullptr || p.counters == nullptr)) ||
      (p.eb != nullptr && (p.act < marvel::kNone || p.act > marvel::kRelu6)))
    return (int)cudaErrorInvalidValue;
  // the weight tile takes 16- or 4-byte copies
  const int wv = vec_bytes(p.w, p.Cout, 16);
  const Params q{p,
                 M,
                 K,
                 vec_bytes(p.x, p.Cin, 16),
                 wv == 8 ? 4 : wv,
                 FastDiv::make(p.Cin),
                 FastDiv::make(p.KW),
                 FastDiv::make(p.Wo),
                 FastDiv::make(p.Ho)};
  if (q.xv == 1) {  // the byte gather: BYTE_TILES only
    switch (p.tile) {
      case 3: return launch_tile<Tile<32, 64, 16, 32, 4>, true>(q, s);
      case 5: return launch_tile<Tile<32, 32, 16, 32, 4>, true>(q, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (p.tile) {
    case 0: return launch_tile<Tile<128, 128, 64, 32, 5>>(q, s);
    case 1: return launch_tile<Tile<64, 128, 32, 32, 4>>(q, s);
    case 2: return launch_tile<Tile<16, 128, 16, 32, 4>>(q, s);
    case 3: return launch_tile<Tile<32, 64, 16, 32, 4>>(q, s);
    case 4: return launch_tile<Tile<16, 64, 16, 32, 4>>(q, s);
    case 5: return launch_tile<Tile<32, 32, 16, 32, 4>>(q, s);
    case 6: return launch_tile<Tile<16, 32, 16, 32, 4>>(q, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace imma

// x: (N, H, W, Cin) int8, w: (KH, KW, Cin, Cout) int8, es / eb: (Cout,)
// f32, res: null or (N, Ho, Wo, Cout) f32, out: (N, Ho, Wo, Cout) f32.
// tile: an index of kernels/fused_conv.py::IMMA_TILES; splits > 1 needs ws,
// (tiles * splits * BM * BN) int32, and counters, one zeroed int32 a tile;
// k_per_split is a multiple of 64 with splits * k_per_split >= KH*KW*Cin.
extern "C" int marvel_fused_conv(const int8_t* x, const int8_t* w,
                                 const float* es, const float* eb,
                                 const float* res, float* out, int* ws,
                                 int* counters, int N, int H, int W, int Cin,
                                 int KH, int KW, int Cout, int Ho, int Wo,
                                 int stride, int top, int left, int tile,
                                 int splits, int k_per_split, int act,
                                 void* stream) {
  const imma::Conv p{x,  w,  es,   eb, res, out,    ws,   counters,
                     N,  H,  W,    Cin, KH, KW,     Cout, Ho,
                     Wo, stride, top, left, tile, splits, k_per_split, act};
  return imma::launch(p, (cudaStream_t)stream);
}

// one warp, one 16 x BN x 64 tile (BN = 32, 64 or 128) through
// imma.cuh's staged layouts and fragment maps
extern "C" int marvel_imma_selftest(const int8_t* a, const int8_t* b,
                                    int* out, int bn, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (bn) {
    case 32: imma_selftest_kernel<32><<<1, 32, 0, s>>>(a, b, out); break;
    case 64: imma_selftest_kernel<64><<<1, 32, 0, s>>>(a, b, out); break;
    case 128: imma_selftest_kernel<128><<<1, 32, 0, s>>>(a, b, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
