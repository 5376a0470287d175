// Int8 tensor-core tiles for the port's two int8 x int8 -> int32
// contractions, the implicit-GEMM conv (fused_conv.cu) and the int8 GEMM
// (mac_matmul.cu): mma.sync.m16n8k32 s8 x s8 -> s32, its fragment maps,
// the layout of the tiles staged in shared memory, and the arguments of the
// one kernel both run (defined in fused_conv.cu).
//
// mma.sync and not wgmma: the conv's M falls to 32 output pixels (ResNet50's
// stage 4, DenseNet121's block 4) and the GEMM's decode rows to M = 8,
// against wgmma's 64-row tiles; and wgmma takes 8-bit operands K-major only
// (the shared-memory transpose flags exist for .f16/.bf16 alone), while the
// weights here are (K, N) row-major, which is MN-major.
//
// Fragment maps of m16n8k32 (PTX ISA, "Matrix fragments for
// mma.m16n8k32"), lane = 4 g + t, 4 int8 a 32-bit register, the lowest k in
// the lowest byte:
//   A (16 x 32, row): a[0] = A[g][4t..4t+3], a[1] = A[g+8][4t..4t+3],
//                     a[2] = A[g][16+4t..],  a[3] = A[g+8][16+4t..]
//   B (32 x 8, col):  b[0] = B[4t..4t+3][g], b[1] = B[16+4t..16+4t+3][g]
//   D (16 x 8, s32):  d[0], d[1] = D[g][2t], D[g][2t+1];
//                     d[2], d[3] = D[g+8][2t], D[g+8][2t+1]
//
// One stage of the staging ring holds a K step of BK = 64:
//   A: BM rows x 64 bytes (k-contiguous), four 16-byte units a row; unit u
//      of row m sits at unit 4 m + (u ^ ((m >> 1) & 3)), so the 8 rows x 16
//      bytes that one ldmatrix matrix reads fall in 8 distinct bank groups.
//      ldmatrix.x4 then gives a[0..3] as the map above wants.
//   B: 64 rows (k) x BN bytes (n), as 16-byte copies along N take them from
//      the (K, N) row-major weights: unit u of row k sits at unit
//      (k * BN/16 + u) ^ (((k >> 2) & 3) << 1).
// B's fragment wants k-contiguous column quads, the transpose of that
// layout.  No transposed copy of the weights is made in device memory (the
// conv's weights are quantized inside every forward): each lane builds its
// quads in registers.  Within a 32-column group the lane reads the 32-bit
// word g (columns 4g..4g+3) of rows 4t..4t+3 and turns the 4 x 4 bytes
// with __byte_perm into four column quads, the b register of four n8
// tiles: n8 tile j's column g is the group's column 4 g + j.  The swizzle
// puts the 4 rows x 2 units a warp reads in one load in 8 distinct bank
// groups, for BN = 32, 64 and 128 alike.  A lane's accumulators then hold
// the 8 contiguous output columns 8t..8t+7 of rows g and g+8 of each
// 32-column group: D tile j's d[c] is column 8t + 4 (c & 1) + j.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

namespace imma {

constexpr int BK = 64;  // K step of a stage, in int8

// d += a * b: one m16n8k32 product, s8 operands, s32 sums (exact)
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 16-byte matrices; lane l gives the address of row l % 8 of
// matrix l / 8, and receives word l % 4 of row l / 4 of each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(cpa::smem_u32(p)));
}

// r[i] holds 4 columns of row i; col[c] gets rows 0..3 of column c
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&col)[4]) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
  col[0] = __byte_perm(lo01, lo23, 0x5410);
  col[1] = __byte_perm(lo01, lo23, 0x7632);
  col[2] = __byte_perm(hi01, hi23, 0x5410);
  col[3] = __byte_perm(hi01, hi23, 0x7632);
}

// byte offset of unit u (16 bytes) of row m in a stage's A tile
__device__ __forceinline__ int a_off(int m, int u) {
  return (4 * m + (u ^ ((m >> 1) & 3))) * 16;
}

// byte offset of unit u of row k in a stage's B tile of BN columns
template <int BN>
__device__ __forceinline__ int b_off(int k, int u) {
  return ((k * (BN / 16) + u) ^ (((k >> 2) & 3) << 1)) * 16;
}

// the A fragment of the 16 rows from m0, the 32 k from kk (0 or 32)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint8_t* As,
                                       int m0, int kk, int lane) {
  const int m = m0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldsm_x4(a, As + a_off(m, kk / 16 + (lane >> 4)));
}

// the B fragments of four n8 tiles, the 32 columns from c0 (a multiple of
// 32), the 32 k from kk: b[j][0..1] for n8 tile j
template <int BN>
__device__ __forceinline__ void load_b(uint32_t (&b)[4][2],
                                       const uint8_t* Bs, int c0, int kk,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int word = c0 / 4 + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t r[4], col[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = *reinterpret_cast<const uint32_t*>(
          Bs + b_off<BN>(kk + 16 * h + 4 * t + i, word >> 2) +
          (word & 3) * 4);
    transpose4(r, col);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j][h] = col[j];
  }
}

// the output column of n8 tile j's accumulator c within its 32-column group
__device__ __forceinline__ int d_col(int lane, int j, int c) {
  return 8 * (lane & 3) + 4 * (c & 1) + j;
}

// ---------------------------------------------------------------------------
// the kernel both contractions run (fused_conv.cu)
// ---------------------------------------------------------------------------

// out[m, n] = act(f32(acc) * es[n] + eb[n] [+ res[m, n]]), or with eb null
// f32(acc) * es[n] alone (the GEMM's dequant scale); acc summed over the
// implicit im2col of an NHWC int8 image against (K, N) int8 weights.  The
// GEMM is the 1x1 conv of a 1 x M image of K channels.
struct Conv {
  const int8_t* x;
  const int8_t* w;
  const float* es;
  const float* eb;   // null: scale only, no act
  const float* res;  // null: no residual
  float* out;
  int* ws;        // split K: tiles * splits * BM * BN int32 partials
  int* counters;  // split K: one zeroed int32 a tile, left zero
  int N, H, W, Cin, KH, KW, Cout, Ho, Wo, stride, top, left;
  int tile, splits, k_per_split, act;
};

// launch one of the tiles (csrc/fused_conv.cu, kernels/fused_conv.py::
// IMMA_TILES); returns a CUDA error code
int launch(const Conv& p, cudaStream_t s);

}  // namespace imma
