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
// Bound on the H100: bytes.  A 3x3 tap stack does 9 MACs per int8 input
// byte and writes 4 bytes of f32 per output, far below the card's
// operations-per-byte line.  Design: one thread per (output pixel, 4-channel
// group) with the channels innermost, so neighbouring threads read
// neighbouring bytes of each tap and write neighbouring floats.  Where
// C % 4 == 0 the taps load as one char4 and the output stores as one float4;
// otherwise byte by byte.  The int32 sums are exact; the epilogue and act run
// in f32 on them.  SAME/VALID padding is a bounds check with zero fill (low
// side = total // 2), with no padded copy of the image.
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

#include "epilogue.cuh"

namespace {

struct DwGeom {
  int N, H, W, C, KH, KW, Ho, Wo, stride, top, left;
};

// KS > 0: a KS x KS tap stack, unrolled; KS == 0: g.KH x g.KW at run time.
template <bool VEC4, int KS>
__global__ void __launch_bounds__(256)
depthwise_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ es, const float* __restrict__ eb,
                 float* __restrict__ out, DwGeom g, int act) {
  const int quads = (g.C + 3) / 4;
  const size_t total = (size_t)g.N * g.Ho * g.Wo * quads;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c0 = (int)(i % quads) * 4;
  const size_t p = i / quads;  // output pixel, (n, oh, ow) row-major
  const int ow = (int)(p % g.Wo);
  const size_t t = p / g.Wo;
  const int oh = (int)(t % g.Ho);
  const int n = (int)(t / g.Ho);
  const int KH = KS > 0 ? KS : g.KH, KW = KS > 0 ? KS : g.KW;
  const int ih0 = oh * g.stride - g.top, iw0 = ow * g.stride - g.left;
  const int8_t* img = x + (size_t)n * g.H * g.W * g.C;

  int acc[4] = {0, 0, 0, 0};
#pragma unroll
  for (int kh = 0; kh < KH; ++kh) {
    const int ih = ih0 + kh;
    if (ih < 0 || ih >= g.H) continue;
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      const int iw = iw0 + kw;
      if (iw < 0 || iw >= g.W) continue;
      const int8_t* px = img + ((size_t)ih * g.W + iw) * g.C + c0;
      const int8_t* pw = w + (size_t)(kh * KW + kw) * g.C + c0;
      if (VEC4) {
        const char4 a = *reinterpret_cast<const char4*>(px);
        const char4 b = __ldg(reinterpret_cast<const char4*>(pw));
        acc[0] += (int)a.x * (int)b.x;
        acc[1] += (int)a.y * (int)b.y;
        acc[2] += (int)a.z * (int)b.z;
        acc[3] += (int)a.w * (int)b.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < g.C) acc[j] += (int)px[j] * (int)__ldg(pw + j);
      }
    }
  }

  float* o = out + p * g.C + c0;
  if (VEC4) {
    float4 v;
    v.x = marvel::epilogue((float)acc[0], es[c0], eb[c0], nullptr, 0, act);
    v.y = marvel::epilogue((float)acc[1], es[c0 + 1], eb[c0 + 1], nullptr, 0, act);
    v.z = marvel::epilogue((float)acc[2], es[c0 + 2], eb[c0 + 2], nullptr, 0, act);
    v.w = marvel::epilogue((float)acc[3], es[c0 + 3], eb[c0 + 3], nullptr, 0, act);
    *reinterpret_cast<float4*>(o) = v;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < g.C)
        o[j] = marvel::epilogue((float)acc[j], es[c0 + j], eb[c0 + j],
                                nullptr, 0, act);
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

template <bool VEC4>
void launch_depthwise(const int8_t* x, const int8_t* w, const float* es,
                      const float* eb, float* out, DwGeom g, int act,
                      unsigned blocks, cudaStream_t s) {
  if (g.KH == 3 && g.KW == 3)
    depthwise_kernel<VEC4, 3><<<blocks, 256, 0, s>>>(x, w, es, eb, out, g, act);
  else
    depthwise_kernel<VEC4, 0><<<blocks, 256, 0, s>>>(x, w, es, eb, out, g, act);
}

}  // namespace

// x (N, H, W, C) int8, w (KH, KW, C) int8, es/eb (C,) f32 -> out
// (N, Ho, Wo, C) f32.
extern "C" int marvel_depthwise_conv(const int8_t* x, const int8_t* w,
                                     const float* es, const float* eb,
                                     float* out, int N, int H, int W, int C,
                                     int KH, int KW, int Ho, int Wo,
                                     int stride, int top, int left, int act,
                                     void* stream) {
  DwGeom g{N, H, W, C, KH, KW, Ho, Wo, stride, top, left};
  cudaStream_t s = (cudaStream_t)stream;
  const size_t threads = (size_t)N * Ho * Wo * ((C + 3) / 4);
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  const bool vec4 = C % 4 == 0 && ((uintptr_t)x & 3) == 0 &&
                    ((uintptr_t)w & 3) == 0 && ((uintptr_t)out & 15) == 0;
  if (vec4)
    launch_depthwise<true>(x, w, es, eb, out, g, act, blocks, s);
  else
    launch_depthwise<false>(x, w, es, eb, out, g, act, blocks, s);
  return (int)cudaGetLastError();
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
