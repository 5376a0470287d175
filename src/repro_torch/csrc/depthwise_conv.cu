// dw_mac: int8 depthwise conv, and the fused depthwise -> 1x1 pointwise
// separable block.
//
// Replaces the TPU kernels src/repro/kernels/depthwise_conv.py::_dw_kernel
// (pl.pallas_call at depthwise_conv.py:107, depthwise_conv_int8) and
// depthwise_conv.py::_sep_kernel (pl.pallas_call at depthwise_conv.py:197,
// sep_block_int8).
//
// depthwise_conv_int8:
//   out[n, oh, ow, c] = act(acc * es[c] + eb[c])
//   acc = sum_{kh, kw} x[n, oh*s - top + kh, ow*s - left + kw, c]
//                      * w[kh, kw, c]                          (int32, exact)
// Bound on the H100: bytes at the roofline (9 MACs per int8 input byte, 4
// bytes of f32 out per output), but at MobileNet's batch-8 shapes those
// bytes take 0.05-0.5 us, so what bounds a launch is latency: the launch,
// and the round trip of the loads before the first MAC.  The design
// answers that with one block per tile of (image, band of TH output rows,
// group of CG = 32 or 64 channels; the wrapper's kernels/depthwise_conv.py
// ::dw_tile picks them so MobileNet's late shapes still give a wave of
// blocks on 132 SMs):
//   - the block stages its int8 halo, (TH-1)*s + KH rows of (Wo rounded up
//     to 4 - 1)*s + KW columns of CG channels, all its copies (16-byte
//     cp.async where C and CG are multiples of 16, else bytes) issued
//     before one wait, with the taps and the epilogue's es / eb loaded
//     meanwhile; rows and columns outside the image (SAME puts the smaller
//     half of the padding low, kernels/common.py::same_pads) and channels
//     past C read as 0, so the MAC loop has no bounds check;
//   - each thread keeps one quad of 4 channels and its KH*KW taps in
//     registers (3x3 at stride 1 or 2 unrolled; other stacks read the taps
//     from shared memory) and computes 4 adjacent output columns, reading
//     each input pixel of a tap row once for the 4 (char4 from shared
//     memory), index math in 32 bits from the block and thread indices;
//   - the int32 sums are exact, the f32 epilogue and act run on them as
//     before, and each output pixel's 4 channels are written as one float4
//     (bytewise where C % 4 != 0).
//
// sep_block_int8:
//   d[m, c]      = dw_act(dwconv(x)[m, c] * ds[c] + db[c])        (f32)
//   out[m, co]   = pw_act((sum_c d[m, c] * float(wp[c, co])) * ps[co] + pb[co])
// Bound on the H100: at MobileNet's batch-8 shapes the bytes (the int8
// image and weights in, the f32 output) and the f32 pointwise FLOPs take
// 0.03-0.3 us a launch, so what bounds it is latency: the launch, the
// round trips of the loads, and the chain of channel chunks a block walks.
// The first kernel (one 64 x 64 tile for every shape, the depthwise tile
// recomputed for every N tile, taps and pixels read from global memory
// with a bounds test a tap, weights converted synchronously, split-C
// through a second kernel) took 31.5 us a launch on average over
// MobileNetV2 v4's 17 (H100 80GB HBM3, 700 W).  This design:
//   - a tile planned per shape in the wrapper (kernels/depthwise_conv.py
//     ::sep_plan): BM of 32, 64 or 128 pixels by BN of 16..128 output
//     channels.  Its rule takes all of Cout up to 128 in one block, so
//     each depthwise element is computed once, with tiles that fill the
//     SMs where M allows; a sweep of every tile and split on the card
//     (tools/sweep_cnn_kernels.py) found more, narrower tiles faster at M
//     <= 128, where blocks, not repeated depthwise work, are short, and
//     those shapes take the sweep's plan (SEP_TUNED);
//   - each chunk of 32 channels staged with cp.async in one group: for
//     every (pixel, tap) of the tile its 32 channels (tiles of consecutive
//     pixels span images at the late 2x2 and 4x4 shapes, so the staging is
//     per tap, not a halo: at most KH KW times the input's bytes, from L2),
//     the taps, the pointwise weights' rows and the depthwise scale and
//     bias; pixels outside the image and channels past C arrive as 0, so
//     the MAC loop has no bounds test; the next chunk's copies go out
//     under this chunk's work (two stages);
//   - the depthwise tile in exact int32 (a channel quad of a pixel a
//     thread), its f32 epilogue and act into shared memory, so the
//     intermediate never reaches device memory, then the pointwise
//     contraction in f32 FMAs in channel order on a register tile (no
//     TF32: the reference contracts in f32);
//   - split-C in the same launch: where the tiles do not fill the SMs the
//     wrapper splits C into slices of whole chunks; each slice writes its
//     partial tile, counts in on a tile counter (acq_rel), and the last
//     block sums the slices in order 0..splits-1 (the bits do not depend
//     on which block that is) and runs the pointwise epilogue once.
// Measured (tools/time_cnn_kernels.py, H100 80GB HBM3, 700 W): 6.4-14 us a
// launch, 0.54 -> 0.15 ms for MobileNetV2 v4's 17; the launch and the
// chain of a block's load, barriers and count-in bound it, not bytes or
// FLOPs.
#include <cstdint>

#include "cp_async.cuh"
#include "epilogue.cuh"

namespace {

struct DwGeom {
  int N, H, W, C, KH, KW, Ho, Wo, stride, top, left;
};

// output columns one thread of the depthwise kernel computes, side by side
constexpr int DW_COLS = 2;

// the depthwise block's shared memory: the int8 halo of its band, (TH-1)*s
// + KH rows of (Wo rounded up to DW_COLS - 1)*s + KW columns of CG
// channels (16-byte aligned), then its KH*KW*CG taps
__host__ __device__ inline int dw_halo_h(int th, int s, int kh) {
  return (th - 1) * s + kh;
}
__host__ __device__ inline int dw_halo_w(int wo, int s, int kw) {
  return ((wo + DW_COLS - 1) / DW_COLS * DW_COLS - 1) * s + kw;
}
__host__ __device__ inline int dw_halo_bytes(const DwGeom& g, int th,
                                             int cg) {
  return (dw_halo_h(th, g.stride, g.KH) * dw_halo_w(g.Wo, g.stride, g.KW) *
              cg + 15) & ~15;
}

// block (blockIdx.x, blockIdx.y, blockIdx.z) owns channels c0 .. c0+CG of
// output rows oh0 .. oh0+TH of image n.  KS > 0, S > 0: a KS x KS tap
// stack at stride S, unrolled, its taps in registers; KS == S == 0: g.KH x
// g.KW at g.stride, the taps read from shared memory.  VEC: C and CG
// multiples of 16 and x 16-byte aligned, so the halo is staged in 16-byte
// copies; else byte by byte.  Thread t works channel quad t % (CG/4) of
// every (row, column group) it visits.
template <int KS, int S, bool VEC>
__global__ void __launch_bounds__(256)
depthwise_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ es, const float* __restrict__ eb,
                 float* __restrict__ out, DwGeom g, int TH, int CG, int act) {
  extern __shared__ __align__(16) int8_t dsm[];
  const int KH = KS > 0 ? KS : g.KH, KW = KS > 0 ? KS : g.KW;
  const int st = S > 0 ? S : g.stride;
  const int HH = dw_halo_h(TH, st, KH);
  const int groups = (g.Wo + DW_COLS - 1) / DW_COLS;
  const int HW = (groups * DW_COLS - 1) * st + KW;
  int8_t* halo = dsm;
  int8_t* taps = dsm + dw_halo_bytes(g, TH, CG);
  const int c0 = blockIdx.x * CG, oh0 = blockIdx.y * TH, n = blockIdx.z;
  const int ih0 = oh0 * st - g.top, iw0 = -g.left;
  const int8_t* img = x + (size_t)n * g.H * g.W * g.C;
  const int tid = threadIdx.x, nt = blockDim.x;

  // 1) every copy of the halo issued, then the taps and the epilogue's
  // constants, then one wait; outside the image (SAME padding, the rounded
  // columns, rows past the last band) and past C reads as 0
  if constexpr (VEC) {
    // thread t copies 16-byte chunk t % per of columns t / per, t / per +
    // nt / per, ... of every halo row: no division in the loop
    const int per = CG / 16, j = tid % per, step = nt / per;
    const int c = c0 + 16 * j;
    for (int row = 0; row < HH; ++row) {
      const int ih = ih0 + row;
      const bool row_ok = ih >= 0 && ih < g.H && c < g.C;
      const int8_t* src = img + ((size_t)ih * g.W + iw0) * g.C + c;
      int8_t* dst = halo + (row * HW) * CG + 16 * j;
      for (int col = tid / per; col < HW; col += step) {
        const int iw = iw0 + col;
        const bool ok = row_ok && iw >= 0 && iw < g.W;
        cpa::copy16(dst + col * CG, ok ? src + (size_t)col * g.C : x,
                    ok ? 16 : 0);
      }
    }
    cpa::commit();
  } else {
    const int total = HH * HW * CG;
    for (int e = tid; e < total; e += nt) {
      const int cc = e % CG, p = e / CG, col = p % HW, row = p / HW;
      const int ih = ih0 + row, iw = iw0 + col, c = c0 + cc;
      const bool ok = ih >= 0 && ih < g.H && iw >= 0 && iw < g.W && c < g.C;
      halo[e] = ok ? img[((size_t)ih * g.W + iw) * g.C + c] : 0;
    }
  }
  const int qg = CG / 4, q = tid % qg, c = c0 + 4 * q;
  // the taps: with the halo's 16-byte copies where it has them, else
  // byte by byte; a thread takes its own 4 channels' into registers after
  // the wait
  if constexpr (VEC) {
    const int per = CG / 16;
    for (int e = tid; e < KH * KW * per; e += nt) {
      const int t = e / per, cc = c0 + 16 * (e - t * per);
      const bool ok = cc < g.C;
      cpa::copy16(taps + t * CG + (cc - c0), ok ? w + t * g.C + cc : w,
                  ok ? 16 : 0);
    }
    cpa::commit();
  } else {
    for (int e = tid; e < KH * KW * CG; e += nt) {
      const int t = e / CG, cc = c0 + (e - t * CG);
      taps[e] = cc < g.C ? w[t * g.C + cc] : 0;
    }
  }
  float s4[4], b4[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s4[j] = c + j < g.C ? cpa::load_now(es + c + j) : 0.0f;
    b4[j] = c + j < g.C ? cpa::load_now(eb + c + j) : 0.0f;
  }
  if constexpr (VEC) cpa::wait<0>();
  __syncthreads();
  if (c >= g.C) return;
  int tp[KS > 0 ? KS * KS : 1][4];
  if constexpr (KS > 0) {
#pragma unroll
    for (int t = 0; t < KS * KS; ++t) {
      const char4 v = *reinterpret_cast<const char4*>(taps + t * CG + 4 * q);
      tp[t][0] = v.x;
      tp[t][1] = v.y;
      tp[t][2] = v.z;
      tp[t][3] = v.w;
    }
  }

  // 2) DW_COLS adjacent output columns x 4 channels a visit, int32 exact
  const int th = min(TH, g.Ho - oh0), items = th * groups;
  const bool vec_out = (g.C & 3) == 0;
  for (int it = tid / qg; it < items; it += nt / qg) {
    const int r = it / groups, cgi = it - r * groups;
    const int8_t* base =
        halo + ((r * st) * HW + cgi * DW_COLS * st) * CG + 4 * q;
    int acc[DW_COLS][4];
#pragma unroll
    for (int j = 0; j < DW_COLS; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] = 0;
    if constexpr (KS > 0) {
      constexpr int NIN = (DW_COLS - 1) * S + KS;
#pragma unroll
      for (int kh = 0; kh < KS; ++kh) {
        char4 v[NIN];
#pragma unroll
        for (int i = 0; i < NIN; ++i)
          v[i] = *reinterpret_cast<const char4*>(base + (kh * HW + i) * CG);
#pragma unroll
        for (int j = 0; j < DW_COLS; ++j)
#pragma unroll
          for (int kw = 0; kw < KS; ++kw) {
            const char4 a = v[j * S + kw];
            const int* t = tp[kh * KS + kw];
            acc[j][0] += (int)a.x * t[0];
            acc[j][1] += (int)a.y * t[1];
            acc[j][2] += (int)a.z * t[2];
            acc[j][3] += (int)a.w * t[3];
          }
      }
    } else {
      for (int kh = 0; kh < KH; ++kh)
        for (int kw = 0; kw < KW; ++kw) {
          const char4 t =
              *reinterpret_cast<const char4*>(taps + (kh * KW + kw) * CG +
                                              4 * q);
#pragma unroll
          for (int j = 0; j < DW_COLS; ++j) {
            const char4 a = *reinterpret_cast<const char4*>(
                base + (kh * HW + j * st + kw) * CG);
            acc[j][0] += (int)a.x * (int)t.x;
            acc[j][1] += (int)a.y * (int)t.y;
            acc[j][2] += (int)a.z * (int)t.z;
            acc[j][3] += (int)a.w * (int)t.w;
          }
        }
    }
    // 3) the f32 epilogue and act on the exact sums, one float4 a column
    float* o = out + (((size_t)n * g.Ho + oh0 + r) * g.Wo) * g.C + c;
#pragma unroll
    for (int j = 0; j < DW_COLS; ++j) {
      const int ow = cgi * DW_COLS + j;
      if (ow >= g.Wo) break;
      float y[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        y[k] = marvel::epilogue((float)acc[j][k], s4[k], b4[k], nullptr, 0,
                                act);
      float* p = o + (size_t)ow * g.C;
      if (vec_out) {
        *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (c + k < g.C) p[k] = y[k];
      }
    }
  }
}

template <int KS, int S>
int launch_depthwise(bool vec, const int8_t* x, const int8_t* w,
                     const float* es, const float* eb, float* out, DwGeom g,
                     int th, int cg, int act, cudaStream_t s) {
  auto kern = vec ? depthwise_kernel<KS, S, true>
                  : depthwise_kernel<KS, S, false>;
  const int smem = dw_halo_bytes(g, th, cg) + g.KH * g.KW * cg;
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  // one thread a channel quad of each (row, column group) of the band, in
  // whole warps, at most 256
  const int items = th * ((g.Wo + DW_COLS - 1) / DW_COLS) * (cg / 4);
  const int threads = items >= 256 ? 256 : (items + 31) / 32 * 32;
  dim3 grid((g.C + cg - 1) / cg, (g.Ho + th - 1) / th, g.N);
  kern<<<grid, threads, smem, s>>>(x, w, es, eb, out, g, th, cg, act);
  return (int)cudaGetLastError();
}

constexpr int SB_C = 32;  // channels of a chunk
constexpr int SB_THREADS = 256;

// bytes of one stage of a chunk's copies: the (pixel, tap) vectors, the
// taps, the pointwise weights' rows, then the depthwise scale and bias
__host__ __device__ inline int sb_stage_bytes(int bm, int bn, int taps) {
  return bm * taps * SB_C + taps * SB_C + SB_C * bn + 2 * SB_C * 4;
}

// the block's shared memory (kernels/depthwise_conv.py::sep_smem mirrors
// it): two stages, the f32 depthwise tile (SB_C rows of bm + 1), the f32
// weights (SB_C rows of bn) and the (pixel, tap) image offsets
__host__ __device__ inline int sb_smem(int bm, int bn, int taps) {
  return 2 * sb_stage_bytes(bm, bn, taps) + SB_C * (bm + 1) * 4 +
         SB_C * bn * 4 + bm * taps * 4;
}

// block (blockIdx.x, blockIdx.y, blockIdx.z) owns output channels n0 ..
// n0+BN of pixels m0 .. m0+BM and chunks [z cps, (z+1) cps) of C.  Thread
// (ty, tx) keeps rows ty + GY i and columns tx + GX j of the tile.  VEC:
// C % 16 == 0, x, wd, ds and db 16-byte aligned, Cout % 4 == 0 and wp
// 4-byte aligned (its rows copied in wq = 16, 8 or 4 bytes), so every
// stage is cp.async; else bytes loaded in place.
template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(SB_THREADS)
sep_block_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wd,
                 const float* __restrict__ ds, const float* __restrict__ db,
                 const int8_t* __restrict__ wp, const float* __restrict__ ps,
                 const float* __restrict__ pb, float* __restrict__ out,
                 float* __restrict__ ws, int* __restrict__ counters, DwGeom g,
                 int Cout, int wq, int cps, int dw_act, int pw_act) {
  constexpr int TN = BN >= 64 ? 4 : BN / 16;
  constexpr int GX = BN / TN, GY = SB_THREADS / GX, TM = BM / GY;
  static_assert(GX * TN == BN && GY * TM == BM && TM >= 1, "sep tile");
  extern __shared__ __align__(16) int8_t sb[];
  __shared__ int last;
  const int T = g.KH * g.KW;
  const int stage = sb_stage_bytes(BM, BN, T);
  float* Ds = reinterpret_cast<float*>(sb + 2 * stage);  // Ds[c][m], BM + 1
  float* Wf = Ds + SB_C * (BM + 1);                      // Wf[c][n]
  int* off = reinterpret_cast<int*>(Wf + SB_C * BN);     // off[p * T + t]
  const int tid = threadIdx.x, tx = tid % GX, ty = tid / GX;
  const int M = g.N * g.Ho * g.Wo;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int z = blockIdx.z, splits = gridDim.z;
  const int k_begin = z * cps;
  const int k_end = min((g.C + SB_C - 1) / SB_C, k_begin + cps);

  // where each (pixel, tap) of the tile reads the image; -1 outside it
  // (SAME padding) and past M
  for (int e = tid; e < BM * T; e += SB_THREADS) {
    const int p = e / T, t = e - p * T, m = m0 + p;
    int o = -1;
    if (m < M) {
      const int ow = m % g.Wo, r = m / g.Wo, oh = r % g.Ho, n = r / g.Ho;
      const int ih = oh * g.stride - g.top + t / g.KW;
      const int iw = ow * g.stride - g.left + t % g.KW;
      if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
        o = ((n * g.H + ih) * g.W + iw) * g.C;
    }
    off[e] = o;
  }
  float pss[TN], pbs[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tx + GX * j;
    pss[j] = n < Cout ? cpa::load_now(ps + n) : 0.0f;
    pbs[j] = n < Cout ? cpa::load_now(pb + n) : 0.0f;
  }
  __syncthreads();

  // one chunk's pixels, taps, weights, scale and bias into stage `buf`;
  // channels past C, pixels outside the image and columns past Cout are 0
  auto stage_chunk = [&](int buf, int kc) {
    int8_t* Xs = sb + buf * stage;
    int8_t* Ts = Xs + BM * T * SB_C;
    int8_t* W8 = Ts + T * SB_C;
    float* DSs = reinterpret_cast<float*>(W8 + SB_C * BN);
    float* DBs = DSs + SB_C;
    const int c0 = kc * SB_C;
    if constexpr (VEC) {
      for (int e = tid; e < BM * T * 2; e += SB_THREADS) {
        const int o = off[e >> 1], c = c0 + 16 * (e & 1);
        const bool ok = o >= 0 && c < g.C;
        cpa::copy16(Xs + 16 * e, ok ? x + o + c : x, ok ? 16 : 0);
      }
      for (int e = tid; e < T * 2; e += SB_THREADS) {
        const int t = e >> 1, c = c0 + 16 * (e & 1);
        const bool ok = c < g.C;
        cpa::copy16(Ts + 16 * e, ok ? wd + t * g.C + c : wd, ok ? 16 : 0);
      }
      const int per = BN / wq;
      for (int e = tid; e < SB_C * per; e += SB_THREADS) {
        const int cc = e / per, j = e - cc * per;
        const int c = c0 + cc, n = n0 + j * wq;
        const bool ok = c < g.C && n < Cout;
        const int8_t* src = ok ? wp + (size_t)c * Cout + n : wp;
        int8_t* dst = W8 + cc * BN + j * wq;
        if (wq == 16)
          cpa::copy16(dst, src, ok ? 16 : 0);
        else if (wq == 8)
          cpa::copy8(dst, src, ok ? 8 : 0);
        else
          cpa::copy4(dst, src, ok ? 4 : 0);
      }
      for (int e = tid; e < SB_C / 2; e += SB_THREADS) {
        const int j = e % (SB_C / 4), c = c0 + 4 * j;
        const float* src = e < SB_C / 4 ? ds : db;
        float* dst = (e < SB_C / 4 ? DSs : DBs) + 4 * j;
        const bool ok = c < g.C;
        cpa::copy16(dst, ok ? src + c : src, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BM * T * SB_C; e += SB_THREADS) {
        const int o = off[e / SB_C], c = c0 + e % SB_C;
        Xs[e] = o >= 0 && c < g.C ? x[o + c] : 0;
      }
      for (int e = tid; e < T * SB_C; e += SB_THREADS) {
        const int t = e / SB_C, c = c0 + e % SB_C;
        Ts[e] = c < g.C ? wd[t * g.C + c] : 0;
      }
      for (int e = tid; e < SB_C * BN; e += SB_THREADS) {
        const int c = c0 + e / BN, n = n0 + e % BN;
        W8[e] = c < g.C && n < Cout ? wp[(size_t)c * Cout + n] : 0;
      }
      for (int e = tid; e < SB_C; e += SB_THREADS) {
        DSs[e] = c0 + e < g.C ? ds[c0 + e] : 0.0f;
        DBs[e] = c0 + e < g.C ? db[c0 + e] : 0.0f;
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  if (k_begin < k_end) {
    stage_chunk(0, k_begin);
    cpa::commit();
  }
  for (int kc = k_begin; kc < k_end; ++kc) {
    const int buf = (kc - k_begin) & 1;
    // the next chunk's copies go out under this chunk's work
    if (kc + 1 < k_end) {
      stage_chunk(buf ^ 1, kc + 1);
      cpa::commit();
      cpa::wait<1>();
    } else {
      cpa::wait<0>();
    }
    __syncthreads();
    {
      const int8_t* Xs = sb + buf * stage;
      const int8_t* Ts = Xs + BM * T * SB_C;
      const int8_t* W8 = Ts + T * SB_C;
      const float* DSs = reinterpret_cast<const float*>(W8 + SB_C * BN);
      const float* DBs = DSs + SB_C;
      // the depthwise tile, int32 and exact: channel quad q of pixels p,
      // every tap from shared memory with no bounds test, then its f32
      // epilogue and act into Ds
      const int q = tid % (SB_C / 4);
      for (int p = tid / (SB_C / 4); p < BM; p += SB_THREADS / (SB_C / 4)) {
        int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
        const int8_t* xp = Xs + p * T * SB_C + 4 * q;
#pragma unroll 9
        for (int t = 0; t < T; ++t) {
          const char4 xv = *reinterpret_cast<const char4*>(xp + t * SB_C);
          const char4 wv =
              *reinterpret_cast<const char4*>(Ts + t * SB_C + 4 * q);
          a0 += (int)xv.x * (int)wv.x;
          a1 += (int)xv.y * (int)wv.y;
          a2 += (int)xv.z * (int)wv.z;
          a3 += (int)xv.w * (int)wv.w;
        }
        const int a[4] = {a0, a1, a2, a3};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cc = 4 * q + j;
          Ds[cc * (BM + 1) + p] =
              kc * SB_C + cc < g.C
                  ? marvel::epilogue((float)a[j], DSs[cc], DBs[cc], nullptr,
                                     0, dw_act)
                  : 0.0f;
        }
      }
      for (int e = tid; e < SB_C * BN; e += SB_THREADS) Wf[e] = (float)W8[e];
    }
    __syncthreads();
    // the pointwise contraction, f32 FMAs in channel order
#pragma unroll 8
    for (int cc = 0; cc < SB_C; ++cc) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Ds[cc * (BM + 1) + ty + GY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Wf[cc * BN + tx + GX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  if (splits > 1) {
    // split-C in this launch: every slice writes its partial tile; after
    // the block's barrier one thread counts it in with an acq_rel atomic;
    // the block that counts last sums the slices in order 0..splits-1,
    // its own from registers, NB slices' loads in flight at a time, and
    // puts the counter back to 0
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* part = ws + (size_t)tile * splits * (BM * BN);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        __stcg(part + (size_t)z * (BM * BN) + (ty + GY * i) * BN + tx +
                   GX * j,
               acc[i][j]);
    __syncthreads();
    if (tid == 0) {
      int prev;
      asm volatile("atom.acq_rel.gpu.add.s32 %0, [%1], 1;\n"
                   : "=r"(prev)
                   : "l"(counters + tile)
                   : "memory");
      last = prev == splits - 1;
    }
    __syncthreads();
    if (!last) return;
    constexpr int NB = TM * TN >= 32 ? 1 : 32 / (TM * TN);
    float sum[TM][TN];
    for (int s0 = 0; s0 < splits; s0 += NB) {
      float v[NB][TM][TN];
#pragma unroll
      for (int u = 0; u < NB; ++u)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            if (s0 + u < splits && s0 + u != z)
              v[u][i][j] = __ldcg(part + (size_t)(s0 + u) * (BM * BN) +
                                  (ty + GY * i) * BN + tx + GX * j);
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const int sl = s0 + u;
        if (sl >= splits) break;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const float val = sl == z ? acc[i][j] : v[u][i][j];
            sum[i][j] = sl == 0 ? val : __fadd_rn(sum[i][j], val);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = sum[i][j];
    if (tid == 0) counters[tile] = 0;  // ready for the next launch
  }

  // the pointwise epilogue, once, and the one write of the output
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + GY * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + GX * j;
      if (n < Cout)
        out[(size_t)m * Cout + n] =
            marvel::epilogue(acc[i][j], pss[j], pbs[j], nullptr, 0, pw_act);
    }
  }
}

template <int BM, int BN, bool VEC>
int launch_sep(const int8_t* x, const int8_t* wd, const float* ds,
               const float* db, const int8_t* wp, const float* ps,
               const float* pb, float* out, float* ws, int* counters,
               DwGeom g, int Cout, int wq, int splits, int cps, int dw_act,
               int pw_act, cudaStream_t s) {
  auto kern = sep_block_kernel<BM, BN, VEC>;
  const int smem = sb_smem(BM, BN, g.KH * g.KW);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  const int M = g.N * g.Ho * g.Wo;
  dim3 grid((Cout + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kern<<<grid, SB_THREADS, smem, s>>>(x, wd, ds, db, wp, ps, pb, out, ws,
                                      counters, g, Cout, wq, cps, dw_act,
                                      pw_act);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, W, C) int8, w (KH, KW, C) int8, es/eb (C,) f32 -> out
// (N, Ho, Wo, C) f32, in blocks of th output rows x cg channels (cg one of
// 4, 8, 16, 32, 64).
extern "C" int marvel_depthwise_conv(const int8_t* x, const int8_t* w,
                                     const float* es, const float* eb,
                                     float* out, int N, int H, int W, int C,
                                     int KH, int KW, int Ho, int Wo,
                                     int stride, int top, int left, int th,
                                     int cg, int act, void* stream) {
  DwGeom g{N, H, W, C, KH, KW, Ho, Wo, stride, top, left};
  cudaStream_t s = (cudaStream_t)stream;
  if (th < 1 || cg < 4 || cg > 64 || (cg & (cg - 1)) != 0 ||
      ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const bool vec = C % 16 == 0 && cg % 16 == 0 && ((uintptr_t)x & 15) == 0 &&
                   ((uintptr_t)w & 15) == 0;
  if (KH == 3 && KW == 3 && stride == 1)
    return launch_depthwise<3, 1>(vec, x, w, es, eb, out, g, th, cg, act, s);
  if (KH == 3 && KW == 3 && stride == 2)
    return launch_depthwise<3, 2>(vec, x, w, es, eb, out, g, th, cg, act, s);
  return launch_depthwise<0, 0>(vec, x, w, es, eb, out, g, th, cg, act, s);
}

// x (N, H, W, C) int8, wd (KH, KW, C) int8, ds/db (C,) f32, wp (C, Cout)
// int8, ps/pb (Cout,) f32 -> out (N, Ho, Wo, Cout) f32, in tiles of bm
// pixels x bn output channels (kernels/depthwise_conv.py::SEP_TILES; 64 x
// 64 where vec is 0) and `splits` slices of cps chunks of 32 channels,
// none empty.  vec: C % 16 == 0, Cout % 4 == 0, x, wd, ds and db 16-byte
// and wp 4-byte aligned.  splits > 1 needs ws, (tiles, splits, bm, bn)
// f32, and counters, one int32 a tile, zero before and after the launch;
// launches that share them must be ordered on one stream.
extern "C" int marvel_sep_block(const int8_t* x, const int8_t* wd,
                                const float* ds, const float* db,
                                const int8_t* wp, const float* ps,
                                const float* pb, float* out, float* ws,
                                int* counters, int N, int H, int W, int C,
                                int KH, int KW, int Ho, int Wo, int stride,
                                int top, int left, int Cout, int bm, int bn,
                                int vec, int splits, int cps, int dw_act,
                                int pw_act, void* stream) {
  DwGeom g{N, H, W, C, KH, KW, Ho, Wo, stride, top, left};
  cudaStream_t s = (cudaStream_t)stream;
  const int chunks = (C + SB_C - 1) / SB_C;
  if (splits < 1 || cps < 1 || (splits - 1) * cps >= chunks ||
      splits * cps < chunks || (splits > 1 && (!ws || !counters)))
    return (int)cudaErrorInvalidValue;
  if ((long long)N * Ho * Wo == 0 || Cout == 0) return 0;
  auto aligned = [](const void* p, int a) {
    return ((uintptr_t)p & (a - 1)) == 0;
  };
  if (!vec) {
    if (bm != 64 || bn != 64) return (int)cudaErrorInvalidValue;
    return launch_sep<64, 64, false>(x, wd, ds, db, wp, ps, pb, out, ws,
                                     counters, g, Cout, 1, splits, cps,
                                     dw_act, pw_act, s);
  }
  if (C % 16 || Cout % 4 || !aligned(x, 16) || !aligned(wd, 16) ||
      !aligned(ds, 16) || !aligned(db, 16) || !aligned(wp, 4))
    return (int)cudaErrorInvalidValue;
  const int wq = Cout % 16 == 0 && aligned(wp, 16) ? 16
                 : Cout % 8 == 0 && aligned(wp, 8) ? 8 : 4;
#define SEP_TILE(BM_, BN_)                                                  \
  if (bm == BM_ && bn == BN_)                                               \
    return launch_sep<BM_, BN_, true>(x, wd, ds, db, wp, ps, pb, out, ws,   \
                                      counters, g, Cout, wq, splits, cps,   \
                                      dw_act, pw_act, s);
  SEP_TILE(32, 16)
  SEP_TILE(32, 32)
  SEP_TILE(32, 64)
  SEP_TILE(32, 128)
  SEP_TILE(64, 16)
  SEP_TILE(64, 32)
  SEP_TILE(64, 64)
  SEP_TILE(128, 16)
  SEP_TILE(128, 32)
#undef SEP_TILE
  return (int)cudaErrorInvalidValue;
}
