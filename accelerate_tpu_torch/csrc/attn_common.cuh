// Device helpers shared by the attention kernels (flash_attention.cu,
// splash_attention.cu): bf16 packing, mma.sync.m16n8k16, ldmatrix operand
// loads in the mma fragment layouts, cp.async tile staging with padded rows,
// and the reductions over the four lanes that share an accumulator row.
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// c += a . b for one m16n8k16 tile (bf16 inputs, f32 accumulators).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and register i receives matrix i in the
// fragment layout (lane t: row t / 4, columns 2(t % 4) and 2(t % 4) + 1, or
// the transpose with .trans).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A operand (16 x 16, row-major) of rows r0.., columns k0..: matrices
// (rows +0, cols +0), (+8, +0), (+0, +8), (+8, +8) are a0..a3 (PTX ISA,
// mma.m16n8k16 fragment layout).
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int r0, int k0,
                                       int lane) {
  ldsm_x4(a, s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + k0 + (lane >> 4) * 8);
}

// B operands of two n8 tiles, n0 and n0 + 8, at depth k0.., where
// B[k][n] = T[n][k]: T's rows are B's columns (K in Q.K^T). Registers:
// b0, b1 of tile n0, then b0, b1 of tile n0 + 8.
template <int LD>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const bf16* s, int n0, int k0,
                                            int lane) {
  ldsm_x4(b, s + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 + ((lane >> 3) & 1) * 8);
}

// The same with B[k][n] = T[k][n]: T row-major along k (V in P.V), read
// transposed.
template <int LD>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const bf16* s, int n0, int k0,
                                            int lane) {
  ldsm_x4_trans(b, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 + (lane >> 4) * 8);
}

// rows x D tile from global (row stride `stride` elements) into shared
// memory (row stride D + 8), 16 bytes per cp.async by NT threads; the
// caller commits.
template <int D, int NT>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long stride, int rows) {
  constexpr int kVecs = D / 8;
  for (int i = threadIdx.x; i < rows * kVecs; i += NT) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(s + r * (D + 8) + c)),
                 "l"(g + r * stride + c));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
