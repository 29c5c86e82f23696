// Device helpers shared by the attention kernels (flash_attention.cu,
// splash_attention.cu): the mask value, bf16 packing, exp2, and the
// reductions over the four lanes that share an accumulator row.
//
// Each .cu that includes this header is compiled into a library of its own
// (ops/kernels/_build.py), and the build hashes every csrc/*.cuh with the
// source, so a change here rebuilds every kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

typedef __nv_bfloat16 bf16;

// The library kernels' DEFAULT_MASK_VALUE (-0.7 * FLT_MAX).
constexpr float kMaskValue = static_cast<float>(-0.7 * 3.4028234663852886e38);

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// exp2 in one instruction (ex2.approx, flush to zero); softmax logits are
// kept in log2 units (times kLog2e) so the exponential is this.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace attn
