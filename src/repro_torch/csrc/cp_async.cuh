// Asynchronous global -> shared copies (cp.async, sm_80 and later) for the
// CUDA-core kernels: the f32 GEMM's staging ring, the depthwise halo, the
// separable block's staged taps and weights, and the wkv chunk tiles.
// A copy whose source is outside the tensor passes src_bytes = 0: nothing
// is read and the destination is filled with zeros, so ragged edges and
// SAME padding need no branch around the copy.
#pragma once

#include <cstdint>

namespace cpa {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, both addresses 16-byte aligned; src_bytes is 16 or 0
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 8 bytes, both addresses 8-byte aligned; src_bytes is 8 or 0
__device__ __forceinline__ void copy8(void* dst, const void* src,
                                      int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes, both addresses 4-byte aligned; src_bytes is 4 or 0
__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a read-only global load issued where it stands: the compiler may sink a
// plain load of __restrict__ const data to its first use, past the waits
// and barriers of a main loop, where its latency would no longer overlap
// anything; a volatile load is kept in order with the copies above
__device__ __forceinline__ float load_now(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}
// a bf16, widened to f32 exactly
__device__ __forceinline__ float load_now_bf16(const void* p) {
  unsigned short u;
  asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=h"(u) : "l"(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

}  // namespace cpa
