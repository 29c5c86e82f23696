// Paged KV gather for Hopper (sm_90a).
//
// Replaces the TPU kernel gather_block_view_kernel
// (accelerate_tpu/ops/pallas/paged_decode.py:204, pallas_call at :294, kernel
// names paged_gather_kernel and, with scales, paged_gather_dequant_kernel).
//
// What it computes: for every (layer l, slot b, chain block j) it copies pool
// block tables[b, j] of layer l -- bs * Hkv * D elements -- into the contiguous
// view out[l, b, j*bs : (j+1)*bs]. A slot with active[b] == 0 reads nothing and
// gets zeros. The dequant variant reads an int8 pool plus one f32 scale per
// token row and writes float(q) * scale, cast once to the output type: the
// expression of gather_block_view / ops/int8.dequantize_kv, so the kernel and
// the plain version are bitwise equal on active slots.
//
// Bound: memory. There is no arithmetic worth counting (one multiply per
// element in the dequant variant). The least traffic is each referenced pool
// block read once (plus its bs f32 scales when quantized) and the whole view
// written once: at the Llama-3-8B engine shape (L=32, B=8, M=20, bs=16,
// Hkv=8, D=128, bf16) the write alone is 168 MB, about 0.05 ms at 3.35 TB/s.
//
// Design: one CTA per (l, b, j), grid (M, B, L). Each CTA reads its own table
// entry (Hopper has no scalar prefetch; the entry is one 4-byte load) and
// streams its block with 16-byte vector loads and stores, neighbouring
// threads on neighbouring addresses. A bf16 block at the 8B shape is 32 KB, so
// each of the 256 threads moves 8 vectors, and the grid has thousands of CTAs
// to keep all 132 SMs streaming. A straight copy gains nothing from staging
// through shared memory or TMA, so it uses neither.
//
// Interface: plain C functions bound with ctypes
// (accelerate_tpu_torch/ops/kernels/paged_gather.py). Each launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int chain_block(const int32_t* __restrict__ tables, int b, int M,
                                           int j, int N) {
  const int idx = tables[static_cast<long long>(b) * M + j];
  if (idx < 0 || idx >= N) __trap();  // a table entry outside the pool is a caller bug
  return idx;
}

// Byte copy of whole blocks: the element type does not matter.
__global__ void __launch_bounds__(kThreads)
    gather_copy(const uint4* __restrict__ pool, const int32_t* __restrict__ tables,
                const uint8_t* __restrict__ active, uint4* __restrict__ out, int N, int B,
                int M, long long vecs_per_block) {
  const int j = blockIdx.x, b = blockIdx.y, l = blockIdx.z;
  uint4* dst = out + ((static_cast<long long>(l) * B + b) * M + j) * vecs_per_block;
  if (!active[b]) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (long long i = threadIdx.x; i < vecs_per_block; i += kThreads) dst[i] = zero;
    return;
  }
  const int idx = chain_block(tables, b, M, j, N);
  const uint4* src = pool + (static_cast<long long>(l) * N + idx) * vecs_per_block;
  for (long long i = threadIdx.x; i < vecs_per_block; i += kThreads) dst[i] = src[i];
}

template <typename OutT>
__device__ __forceinline__ OutT from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// Dequantizing copy: 16 int8 values per 16-byte load become 16 OutT values,
// written as 2 (bf16/f16) or 4 (f32) 16-byte stores. A load never straddles
// two token rows because the wrapper requires Hkv * D % 16 == 0.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    gather_dequant(const int4* __restrict__ pool, const float* __restrict__ scales,
                   const int32_t* __restrict__ tables, const uint8_t* __restrict__ active,
                   OutT* __restrict__ out, int N, int B, int M, int bs, int row_elems) {
  constexpr int kVec = 16;
  constexpr int kOutVecs = kVec * static_cast<int>(sizeof(OutT)) / 16;
  const int j = blockIdx.x, b = blockIdx.y, l = blockIdx.z;
  const long long block_elems = static_cast<long long>(bs) * row_elems;
  const long long vecs = block_elems / kVec;
  uint4* dst = reinterpret_cast<uint4*>(
      out + ((static_cast<long long>(l) * B + b) * M + j) * block_elems);
  if (!active[b]) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (long long i = threadIdx.x; i < vecs * kOutVecs; i += kThreads) dst[i] = zero;
    return;
  }
  const int idx = chain_block(tables, b, M, j, N);
  const long long blk = static_cast<long long>(l) * N + idx;
  const int4* src = pool + blk * vecs;
  const float* row_scale = scales + blk * bs;
  for (long long i = threadIdx.x; i < vecs; i += kThreads) {
    const int4 raw = src[i];
    const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
    const float s = row_scale[(i * kVec) / row_elems];
    alignas(16) OutT e[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) e[k] = from_float<OutT>(static_cast<float>(q[k]) * s);
#pragma unroll
    for (int m = 0; m < kOutVecs; ++m) dst[i * kOutVecs + m] = reinterpret_cast<const uint4*>(e)[m];
  }
}

}  // namespace

extern "C" {

int paged_gather_launch(const void* pool, const void* tables, const void* active, void* out,
                        int L, int N, int B, int M, long long block_bytes, void* stream) {
  const dim3 grid(M, B, L);
  gather_copy<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(pool), static_cast<const int32_t*>(tables),
      static_cast<const uint8_t*>(active), static_cast<uint4*>(out), N, B, M, block_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}

// out_kind: 0 = float32, 1 = bfloat16, 2 = float16.
int paged_gather_dequant_launch(const void* pool, const void* scales, const void* tables,
                                const void* active, void* out, int out_kind, int L, int N,
                                int B, int M, int bs, int row_elems, void* stream) {
  const dim3 grid(M, B, L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* p = static_cast<const int4*>(pool);
  const float* sc = static_cast<const float*>(scales);
  const int32_t* t = static_cast<const int32_t*>(tables);
  const uint8_t* a = static_cast<const uint8_t*>(active);
  switch (out_kind) {
    case 0:
      gather_dequant<float><<<grid, kThreads, 0, s>>>(p, sc, t, a, static_cast<float*>(out), N,
                                                      B, M, bs, row_elems);
      break;
    case 1:
      gather_dequant<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          p, sc, t, a, static_cast<__nv_bfloat16*>(out), N, B, M, bs, row_elems);
      break;
    case 2:
      gather_dequant<__half><<<grid, kThreads, 0, s>>>(p, sc, t, a, static_cast<__half*>(out),
                                                       N, B, M, bs, row_elems);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* paged_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
