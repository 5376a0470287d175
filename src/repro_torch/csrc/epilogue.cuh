// Shared f32 epilogue of the GEMM and conv kernels:
//   act(acc * es + eb [+ residual])
// The multiply and the add are rounded separately (no FMA contraction), as
// the plain PyTorch versions and the reference compute them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace marvel {

// codes match repro_torch/kernels/common.py::ACT_CODES
enum Act : int { kNone = 0, kRelu = 1, kRelu6 = 2, kSilu = 3, kGelu = 4 };

__device__ __forceinline__ float apply_act(float y, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(y, 0.0f);
    case kRelu6:
      return fminf(fmaxf(y, 0.0f), 6.0f);
    case kSilu:
      return y / (1.0f + expf(-y));
    case kGelu: {
      // tanh form, as jax.nn.gelu's default and F.gelu(approximate="tanh")
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      float inner = c * (y + 0.044715f * y * y * y);
      return 0.5f * y * (1.0f + tanhf(inner));
    }
    default:
      return y;
  }
}

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// res: null, or an f32 or bf16 tensor read at idx
template <typename R>
__device__ __forceinline__ float epilogue(float acc, float es, float eb,
                                          const R* res, size_t idx, int act) {
  float y = __fadd_rn(__fmul_rn(acc, es), eb);
  if (res != nullptr) y = __fadd_rn(y, as_f32(res[idx]));
  return apply_act(y, act);
}

// no residual
__device__ __forceinline__ float epilogue(float acc, float es, float eb,
                                          std::nullptr_t, size_t, int act) {
  return apply_act(__fadd_rn(__fmul_rn(acc, es), eb), act);
}

}  // namespace marvel
