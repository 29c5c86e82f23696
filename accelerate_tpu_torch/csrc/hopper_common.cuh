// Hopper (sm_90a) building blocks for the attention kernels and the int8 matmul: mbarriers and
// named barriers, TMA tile loads into 128-byte-swizzled shared memory, wgmma shared-memory
// descriptors and the asynchronous warpgroup products (SS: both operands in
// shared memory; RS: A in registers), setmaxnreg, and the tile helpers the
// attention kernels share (descriptors of a k step, TMA loads of a whole
// tile, accumulators to A fragments). Raw PTX, no CUTLASS, so a source that
// includes this builds in seconds.
//
// Shared-memory tiles. A (B, S, H, D) bf16 tensor is read by TMA through a
// 4-D tensor map (encode_bshd_map) as boxes of `rows` sequence positions by
// 64 head-dim elements (128 bytes, the widest box the 128-byte swizzle
// takes), so a rows x D tile lands as D / 64 panels of rows x 128 bytes,
// each panel 1024-byte aligned and swizzled in 8-row (1024-byte) atoms.
// Positions at or past S come in as zeros. Such a panel is the canonical
// wgmma SW128 layout both ways:
//   - K-major (the row's elements are the contraction): desc_kmajor, stride
//     1024 bytes between 8-row groups; a 16-element k step adds 32 bytes to
//     the start address inside the panel, and the next 64 elements are the
//     next panel.
//   - MN-major (the rows are the contraction, as V in P.V): desc_mnmajor,
//     1024 bytes between 8-row groups of the contraction and one panel
//     between 64-element blocks of N; a 16-row k step adds 2048 bytes.
//
// The host part, encode_bshd_map, reaches the driver's
// cuTensorMapEncodeTiled through cudaGetDriverEntryPoint (ByVersion from
// CUDA 12.5), so the libraries link against the runtime alone and need no
// -lcuda. encode_2d_map does the same for a row-major matrix.
//
// Thread block clusters (the int8 matmul): cluster_rank, the cluster-wide
// barrier (cluster_sync), and loads from a peer CTA's shared memory
// (cluster_ld_u32 at the address cluster_map gives).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the inits visible to the async proxy (TMA); a __syncthreads follows.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spins until the barrier's phase differs from `parity` (a barrier starts in
// phase 0 and flips each time its arrivals and bytes are complete). A wait
// that never ends (a load that was never issued) fails the launch after
// kSpinLimit polls, seconds past any real wait, instead of holding the card:
// mbar_wait by a trap; mbar_wait_fault by a store to address 0, an illegal
// address. ptxas keeps every value that is live across a trap within the
// launch bound's registers (168 at 384 threads), so code that holds more
// after setmaxnreg_inc, as splash's D = 256 consumers do, spills around
// every wait that can trap; a store does not bind it.
constexpr uint32_t kSpinLimit = 1u << 28;

template <bool kFault>
__device__ __forceinline__ void mbar_spin(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (n == kSpinLimit) {
      if (kFault)
        asm volatile("st.global.u32 [%0], %1;\n" ::"l"(0ull), "r"(0u) : "memory");
      else
        __trap();
    }
  }
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  mbar_spin<false>(bar, parity);
}

__device__ __forceinline__ void mbar_wait_fault(uint64_t* bar, uint32_t parity) {
  mbar_spin<true>(bar, parity);
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `count` threads: sync
// waits for the count, arrive counts without waiting. Both order the
// shared-memory accesses before them for the threads that sync after.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ----------------------------------------------------------------------- TMA
// One box of a 4-D tensor map, coordinates innermost first, into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// One box of a 2-D tensor map (c0 the inner coordinate) into shared memory.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Orders this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (TMA writes, wgmma reads) behind a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------ clusters
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives and waits: shared-memory
// writes before it (local or remote) are visible to all of them after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of this CTA's shared address `addr` in the
// CTA of rank `rank`.
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ uint32_t cluster_ld_u32(uint32_t cluster_addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(cluster_addr) : "memory");
  return v;
}

// A contiguous run of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The value of x, opaque to the compiler, so a descriptor built from it is
// computed where it is used rather than hoisted out of the mainloop and
// held (two registers each) beside the accumulators.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// K-major operand: `addr` is the panel's row 0 plus 32 bytes per k step.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

// MN-major operand: `addr` is the contraction row of the k step in the
// first panel; `panel_bytes` separates 64-element blocks of N.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, uint32_t panel_bytes) {
  return desc_sw128(addr, panel_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers an asynchronous product reads or writes in place, so the
// compiler moves no access to them across a wgmma fence, commit or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x N f32, the warpgroup's accumulator layout: thread t of warp w
// holds rows 16w + t/4 and +8, columns 8j + 2(t%4) and +1 at d[4j..4j+3])
// += A . B over one k16 step, 16-bit operands of type T (bf16, or fp16 for
// the flash kernels' fp16 path). scale_d = 0 overwrites d.
//   ss:    A (64 x 16) and B (N x 16) K-major in shared memory.
//   rs_mn: A in registers (the mma.m16n8k16 A fragment of the warp's 16
//          rows: a[0] row t/4 cols 2(t%4)+{0,1}, a[1] row +8, a[2] cols +8,
//          a[3] both), B (16 x N) MN-major in shared memory.
template <int N, typename T = attn::bf16>
struct Wgmma {
  static __device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                            int scale_d);
  static __device__ __forceinline__ void rs_mn(float (&d)[N / 2], const uint32_t* a, uint64_t b,
                                               int scale_d);
};

// The N = 64 and N = 128 products for element type T, whose PTX name is TY.
#define HOPPER_WGMMA_64_128(T, TY)                                                              \
  template <>                                                                                   \
  __device__ __forceinline__ void Wgmma<64, T>::ss(float (&d)[32], uint64_t a, uint64_t b,      \
                                                   int scale_d) {                               \
    asm volatile(                                                                               \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                            \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                            \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"        \
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                                      \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),\
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),\
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),\
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                                  \
        : "l"(a), "l"(b), "r"(scale_d));                                                        \
  }                                                                                             \
  template <>                                                                                   \
  __device__ __forceinline__ void Wgmma<64, T>::rs_mn(float (&d)[32], const uint32_t* a,        \
                                                      uint64_t b, int scale_d) {                \
    asm volatile(                                                                               \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                            \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                            \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"        \
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                         \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),\
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),\
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),\
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                                  \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));                    \
  }                                                                                             \
  template <>                                                                                   \
  __device__ __forceinline__ void Wgmma<128, T>::ss(float (&d)[64], uint64_t a, uint64_t b,     \
                                                    int scale_d) {                              \
    asm volatile(                                                                               \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                            \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                           \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "      \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "      \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"        \
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                                      \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),\
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),\
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),\
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),\
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),\
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),\
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),\
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),\
          "+f"(d[63])                                                                         \
        : "l"(a), "l"(b), "r"(scale_d));                                                        \
  }                                                                                             \
  template <>                                                                                   \
  __device__ __forceinline__ void Wgmma<128, T>::rs_mn(float (&d)[64], const uint32_t* a,       \
                                                       uint64_t b, int scale_d) {               \
    asm volatile(                                                                               \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                            \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                           \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "      \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "      \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"        \
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                         \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),\
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),\
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),\
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),\
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),\
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),\
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),\
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),\
          "+f"(d[63])                                                                         \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));                    \
  }

HOPPER_WGMMA_64_128(attn::bf16, "bf16")
HOPPER_WGMMA_64_128(attn::f16, "f16")
#undef HOPPER_WGMMA_64_128

// N = 256 (a D = 256 accumulator: O += P.V, dV, dK and dQ at Gemma-2's head
// width), RS only; B spans four 64-column panels, `panel_bytes` apart.
template <>
__device__ __forceinline__ void Wgmma<256>::rs_mn(float (&d)[128], const uint32_t* a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// ------------------------------------------------------------------ registers
// Moves the warpgroup's register budget (a multiple of 8 in [24, 256]); all
// four warps execute it. Producers give registers up, consumers take them.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// -------------------------------------------------------------- tile helpers
// Bytes of a rows x D bf16 tile, and of one of its 64-column panels.
template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * D * 2;
}

__host__ __device__ constexpr int panel_bytes(int rows) { return rows * 128; }

// Descriptor of the k-th 16-element step of a K-major operand whose rows
// start at `base` in a tile of `rows`-row panels (D / 16 steps cross D / 64
// panels).
__device__ __forceinline__ uint64_t kstep(uint32_t base, int rows, int kk) {
  return desc_kmajor(opaque(base) + (kk >> 2) * panel_bytes(rows) + (kk & 3) * 32);
}

// Descriptor of the k-th 16-row step of an MN-major operand (a tile of
// `rows`-row panels read with its rows as the contraction).
__device__ __forceinline__ uint64_t mnstep(uint32_t base, int rows, int kk) {
  return desc_mnmajor(opaque(base) + kk * 16 * 128, panel_bytes(rows));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// One load of a rows x D tile: D / 64 TMA boxes at sequence position s0.
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map, uint64_t* bar,
                                         int rows, int h, int s0, int b) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
    tma_load_4d(dst + p * panel_bytes(rows), map, bar, p * 64, h, s0, b);
}

// The A fragments (type T: bf16 or fp16) of an f32 accumulator of N columns
// (the layout of Wgmma's d): 16-column step kc is a[4kc..4kc+3].
template <int N, typename T = attn::bf16>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[N / 4], const float (&d)[N / 2]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
    a[4 * kc + 0] = attn::pack2<T>(d[8 * kc + 0], d[8 * kc + 1]);
    a[4 * kc + 1] = attn::pack2<T>(d[8 * kc + 2], d[8 * kc + 3]);
    a[4 * kc + 2] = attn::pack2<T>(d[8 * kc + 4], d[8 * kc + 5]);
    a[4 * kc + 3] = attn::pack2<T>(d[8 * kc + 6], d[8 * kc + 7]);
  }
}

// Two adjacent output elements: bf16 and fp16 outputs are stored, f32
// outputs (gradient accumulators, as a ring block's) are added to.
__device__ __forceinline__ void emit2(attn::bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = attn::pack_bf16(a, b);
}

__device__ __forceinline__ void emit2(attn::f16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = attn::pack_f16(a, b);
}

__device__ __forceinline__ void emit2(float* p, float a, float b) {
  float2 acc = *reinterpret_cast<float2*>(p);
  acc.x += a;
  acc.y += b;
  *reinterpret_cast<float2*>(p) = acc;
}

// A row of an accumulator (its 8-column steps at d[4j + half*2 ..]) to
// global memory at `dst`, column 2(t%4) of each step.
template <int D, typename OutT>
__device__ __forceinline__ void emit_row(OutT* dst, const float (&d)[D / 2], int half, float mul) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    emit2(dst + j * 8, d[4 * j + 2 * half] * mul, d[4 * j + 2 * half + 1] * mul);
}

// ----------------------------------------------------------------- host side
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a contiguous (B, S, H, D) tensor of 16-bit elements (bf16
// unless `type` says fp16) read in boxes of `rows` positions x 64 head-dim
// elements of one (batch, head), 128-byte swizzled; coordinates (d0, h, s0,
// b). Returns a cudaError_t code.
inline int encode_bshd_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
                           int rows,
                           CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(H) * D * 2,
                                 static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Tensor map of a row-major (rows, cols) matrix of `type` with rows
// `row_bytes` apart (a multiple of 16), read in boxes of box_cols x box_rows;
// coordinates (col, row). Boxes past the edges read zeros.
inline int encode_2d_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                         long long rows, long long cols, long long row_bytes, int box_cols,
                         int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hopper
