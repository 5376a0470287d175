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
// Bound on the H100: at MobileNet's shapes, bytes (the int8 image and
// weights in, the f32 output), with the f32 pointwise contraction on the
// CUDA cores next.  Design: each 256-thread block owns a tile of 64 output
// pixels x 64 output channels and walks C in chunks of 32.  For each chunk
// it (1) recomputes the depthwise tile in int32 from the int8 image, two
// pixels x four channels per thread, taps as char4 where C % 4 == 0;
// (2) applies the depthwise epilogue and act in f32 into shared memory, so
// the (N, Ho, Wo, C) intermediate never reaches device memory; (3) converts
// the chunk of int8 pointwise weights to f32 in shared memory and
// contracts, each thread keeping a 4x4 f32 register tile summed with CUDA-
// core FMAs in channel order.  No TF32: the reference contracts in f32.  The
// pointwise epilogue runs once at the end and the output is written once.
//
// Split-C: MobileNet's late blocks have few output tiles (32 pixels at
// batch 8 against C = 960..1024), so the wrapper may ask for `splits`
// slices of C.  Each block then writes its slice's f32 partial sums to a
// workspace, and a second kernel adds the slices in a fixed order (the
// result does not vary from run to run) and applies the pointwise epilogue.
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

constexpr int SB_M = 64, SB_N = 64, SB_C = 32, SB_THREADS = 256;
constexpr int SB_QUADS = SB_C / 4;                 // channel quads per chunk
constexpr int SB_ROWS = SB_THREADS / SB_QUADS;     // pixel rows per pass
constexpr int SB_PIX = SB_M / SB_ROWS;             // pixels per thread

template <int KS>
__global__ void __launch_bounds__(SB_THREADS)
sep_block_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wd,
                 const float* __restrict__ ds, const float* __restrict__ db,
                 const int8_t* __restrict__ wp, const float* __restrict__ ps,
                 const float* __restrict__ pb, float* __restrict__ out,
                 float* __restrict__ ws, DwGeom g, int Cout, int c_per_split,
                 int dw_act, int pw_act, int vec4) {
  __shared__ float Ds[SB_C][SB_M + 1];  // dw tile after its act: Ds[c][m]
  __shared__ float Ws[SB_C][SB_N];      // pw weights as f32: Ws[c][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int M = g.N * g.Ho * g.Wo;
  const int m0 = blockIdx.y * SB_M, n0 = blockIdx.x * SB_N;
  const int c_begin = blockIdx.z * c_per_split;
  const int c_end = min(g.C, c_begin + c_per_split);
  const int KH = KS > 0 ? KS : g.KH, KW = KS > 0 ? KS : g.KW;

  // the depthwise work of this thread: channel quad `cq` of each chunk, at
  // pixel rows rbase + SB_ROWS * l of the tile
  const int cq = tid % SB_QUADS, rbase = tid / SB_QUADS;
  int ih0[SB_PIX], iw0[SB_PIX];
  size_t img[SB_PIX];
  bool mvalid[SB_PIX];
#pragma unroll
  for (int l = 0; l < SB_PIX; ++l) {
    const int m = m0 + rbase + SB_ROWS * l;
    mvalid[l] = m < M;
    const int mm = mvalid[l] ? m : 0;
    const int ow = mm % g.Wo;
    const int t = mm / g.Wo;
    const int oh = t % g.Ho;
    const int n = t / g.Ho;
    ih0[l] = oh * g.stride - g.top;
    iw0[l] = ow * g.stride - g.left;
    img[l] = (size_t)n * g.H * g.W * g.C;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int c0 = c_begin; c0 < c_end; c0 += SB_C) {
    // 1) the depthwise tile of this chunk, int32 and exact
    const int cb = c0 + cq * 4;
    const bool quad = vec4 && cb < c_end;  // C % 4 == 0: whole quads
    int dacc[SB_PIX][4];
#pragma unroll
    for (int l = 0; l < SB_PIX; ++l)
#pragma unroll
      for (int j = 0; j < 4; ++j) dacc[l][j] = 0;
    if (cb < c_end) {
#pragma unroll
      for (int kh = 0; kh < KH; ++kh) {
#pragma unroll
        for (int kw = 0; kw < KW; ++kw) {
          const int8_t* tp = wd + (size_t)(kh * KW + kw) * g.C + cb;
          int tap[4];
          if (quad) {
            const char4 b = __ldg(reinterpret_cast<const char4*>(tp));
            tap[0] = b.x; tap[1] = b.y; tap[2] = b.z; tap[3] = b.w;
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              tap[j] = cb + j < c_end ? (int)__ldg(tp + j) : 0;
          }
#pragma unroll
          for (int l = 0; l < SB_PIX; ++l) {
            const int ih = ih0[l] + kh, iw = iw0[l] + kw;
            if (!mvalid[l] || ih < 0 || ih >= g.H || iw < 0 || iw >= g.W)
              continue;
            const int8_t* px = x + img[l] + ((size_t)ih * g.W + iw) * g.C + cb;
            if (quad) {
              const char4 a = *reinterpret_cast<const char4*>(px);
              dacc[l][0] += (int)a.x * tap[0];
              dacc[l][1] += (int)a.y * tap[1];
              dacc[l][2] += (int)a.z * tap[2];
              dacc[l][3] += (int)a.w * tap[3];
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (cb + j < c_end) dacc[l][j] += (int)px[j] * tap[j];
            }
          }
        }
      }
    }
    // 2) its epilogue and act in f32, into shared memory; channels past the
    // chunk and pixels past M contribute 0
#pragma unroll
    for (int l = 0; l < SB_PIX; ++l)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cb + j;
        float v = 0.0f;
        if (mvalid[l] && c < c_end)
          v = marvel::epilogue((float)dacc[l][j], ds[c], db[c], nullptr, 0,
                               dw_act);
        Ds[cq * 4 + j][rbase + SB_ROWS * l] = v;
      }
    // 3) the chunk of pointwise weights, int8 -> f32
#pragma unroll
    for (int l = 0; l < (SB_C * SB_N) / SB_THREADS; ++l) {
      const int e = tid + l * SB_THREADS;
      const int r = e / SB_N, col = e % SB_N;
      const int c = c0 + r, gn = n0 + col;
      Ws[r][col] = (c < c_end && gn < Cout)
                       ? (float)wp[(size_t)c * Cout + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SB_C; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ds[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
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
      if (gn >= Cout) continue;
      const size_t idx = (size_t)gm * Cout + gn;
      if (ws != nullptr)  // split-C: this slice's partial sum
        ws[(size_t)blockIdx.z * M * Cout + idx] = acc[i][j];
      else
        out[idx] = marvel::epilogue(acc[i][j], ps[gn], pb[gn], nullptr, 0,
                                    pw_act);
    }
  }
}

// split-C second pass: the slices summed in order 0..splits-1, then the
// pointwise epilogue
__global__ void sep_splitc_kernel(const float* __restrict__ ws, int splits,
                                  const float* __restrict__ ps,
                                  const float* __restrict__ pb,
                                  float* __restrict__ out, int M, int Cout,
                                  int act) {
  const size_t total = (size_t)M * Cout;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float acc = ws[i];
  for (int s = 1; s < splits; ++s)
    acc = __fadd_rn(acc, ws[(size_t)s * total + i]);
  const int co = (int)(i % Cout);
  out[i] = marvel::epilogue(acc, ps[co], pb[co], nullptr, 0, act);
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
// int8, ps/pb (Cout,) f32 -> out (N, Ho, Wo, Cout) f32.  splits > 1 needs
// ws: a (splits, N*Ho*Wo, Cout) f32 workspace; c_per_split is a multiple of
// 32 with splits * c_per_split >= C.
extern "C" int marvel_sep_block(const int8_t* x, const int8_t* wd,
                                const float* ds, const float* db,
                                const int8_t* wp, const float* ps,
                                const float* pb, float* out, float* ws, int N,
                                int H, int W, int C, int KH, int KW, int Ho,
                                int Wo, int stride, int top, int left,
                                int Cout, int splits, int c_per_split,
                                int dw_act, int pw_act, void* stream) {
  DwGeom g{N, H, W, C, KH, KW, Ho, Wo, stride, top, left};
  cudaStream_t s = (cudaStream_t)stream;
  const int M = N * Ho * Wo;
  const int vec4 = C % 4 == 0 && ((uintptr_t)x & 3) == 0 &&
                   ((uintptr_t)wd & 3) == 0;
  if (splits < 1) splits = 1;
  float* part = splits > 1 ? ws : nullptr;
  const int per = splits > 1 ? c_per_split : C;
  dim3 grid((Cout + SB_N - 1) / SB_N, (M + SB_M - 1) / SB_M, splits);
  if (KH == 3 && KW == 3)
    sep_block_kernel<3><<<grid, SB_THREADS, 0, s>>>(
        x, wd, ds, db, wp, ps, pb, out, part, g, Cout, per, dw_act, pw_act,
        vec4);
  else
    sep_block_kernel<0><<<grid, SB_THREADS, 0, s>>>(
        x, wd, ds, db, wp, ps, pb, out, part, g, Cout, per, dw_act, pw_act,
        vec4);
  int err = (int)cudaGetLastError();
  if (err != 0 || splits <= 1) return err;
  const size_t total = (size_t)M * Cout;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  sep_splitc_kernel<<<blocks, 256, 0, s>>>(ws, splits, ps, pb, out, M, Cout,
                                           pw_act);
  return (int)cudaGetLastError();
}
