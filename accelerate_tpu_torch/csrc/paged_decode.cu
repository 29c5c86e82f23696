// Fused paged decode attention for Hopper (sm_90a): attention of a query
// chunk against each slot's block chain, read straight from the KV pool.
//
// Replaces the TPU kernel paged_attention_kernel
// (accelerate_tpu/ops/pallas/paged_decode.py:64, pallas_call at :195, kernel
// name paged_decode_kernel), which the JAX package reaches through the op
// face accelerate_tpu/ops/paged_attention.py:238 (paged_attention).
//
// What it computes, for slot b, query s and query head hq (the G = H / Hkv
// query heads hq = h*G .. h*G+G-1 share KV head h): the math of cached_attention
// (accelerate_tpu_torch/ops/attention.py) on the chain of T = M * bs keys
// that the slot's table row names, key j being row j % bs of pool block
// table[b, j / bs]:
//   s_j = (q . k_j) * scale; for bf16 q and a bf16 pool the dot is rounded
//         to bf16 first (einsum of two bf16 operands returns bf16); an int8
//         pool dequantizes each row with its f32 scale, and the dot stays f32;
//   softcap: s_j = cap * tanh(s_j / cap);
//   bias: -1e30 where q_pos - j < 0 or the key is outside the window, plus
//         -1e30 where the pool mask is 0, ADDED as the plain version adds
//         them, so a row with no visible key gives the plain version's
//         answer (uniform over the keys with one exclusion); windows count
//         valid slots when a mask is given (ranks are the inclusive prefix
//         sum of the chain's mask over the WHOLE chain, q_rank = rank[q_pos]);
//   p = softmax(s) in f32; out = sum_j p_j v_j, cast to the output type
//   (bf16 for bf16 q on a bf16 pool, f32 otherwise). A slot with
//   active[b] == 0 walks nothing and gets zeros. A table entry outside the
//   pool traps.
// The sums run in another order than the plain version's GEMMs, so the two
// agree to a tolerance, not bitwise; two runs of the kernel agree bitwise
// (no atomics, every reduction in a fixed order).
//
// Bound: memory. A decode step (S = 1) does about 4 operations per byte of
// K and V against the card's 295 a byte, so the design reads every pool
// block the active chains name once, keeps bytes in flight on every SM,
// and fills the card whatever the number of slots:
//
// 1. Grid (KV head, chain split, slot x row tile). One CTA takes the G * S
//    query rows of one KV head (padded to 16; more rows take more row
//    tiles), so each K and V byte crosses from device memory once per slot,
//    not once per query head.
// 2. Flash-decoding. Each chain is cut into splits of `split_blocks` whole
//    pool blocks (plan() in ops/kernels/paged_decode.py picks the length:
//    at least two CTAs an SM). A split keeps an online softmax (running max
//    m, sum l, unnormalised f32 accumulator o) and writes (m, l, o) of its
//    rows to an f32 scratch; a second kernel, paged_decode_merge, combines
//    the splits of each row in split order (an online merge) and
//    normalises. A split whose
//    keys are all masked has a finite max (-1e30 or -2e30), so it merges to
//    nothing beside a split with a visible key, and to the plain version's
//    uniform answer when no split has one; no exp(-inf - -inf) arises.
//    Every key of the table is walked, trash-block tails included, as the
//    JAX kernel walks them.
// 3. Warp specialisation and asynchronous copies. Warp 0 is the producer:
//    it reads the split's table entries and, for each block, issues TMA
//    loads of the block's K and V rows of this head through a 3-D tensor
//    map over the pool layer's (N * bs, Hkv, D) rows, boxes of (128 bytes of
//    D, 1 head, bs rows) in the 128-byte swizzle (a bf16 block of Llama's
//    shape is two boxes of K and two of V, 2 KB each; a row of the block is
//    Hkv * D elements from the next), and bulk copies of the block's mask
//    row and, for an int8 pool, its two scale rows, all counted in bytes on
//    the stage's mbarrier. The stages form a ring (2 per consumer warp when
//    the CTA's shared memory stays under ~72 KB, three CTAs an SM, else 1):
//    48 KB of K and V in flight a CTA at Llama's shapes. Warps 1..3
//    consume: block i of the split goes to consumer warp i % 3, which keeps
//    its own (m, l, o) and releases the stage on its `empty` mbarrier; at
//    the end the three states are combined in warp order in shared memory.
//    Every wait is mbar_wait_fault: a lost copy fails the launch. (Copies of
//    one 256-byte row each, 33 a block, held the first version of this
//    kernel to a third of the rate: the copy engine's requests, not bytes,
//    bound it.)
// 4. Products. bf16 q (the serving path): q.K^T on the tensor cores
//    (mma.sync m16n8k16, f32 accumulation, two 8-key tiles and two k-step
//    parities as four independent chains; an int8 K row is exact in bf16,
//    converted in registers, and its scale multiplies the f32 dot
//    afterwards) into the warp's score tile in shared memory; the online
//    softmax runs there, 8 lanes a row over the real rows only; then P.V:
//    on a bf16 pool mma.sync with p rounded to bf16 (ldmatrix from the
//    probability tile); on an int8 pool w = p * vs_j is split into two bf16
//    terms (hi + lo, a relative error of about 2^-16) and both go through
//    mma.sync against the exact bf16 V (ldmatrix.trans on byte pairs), so
//    vs_j stays inside the sum and w is not rounded to one bf16. f32 q or
//    an f32 pool: f32 FMAs on the CUDA cores (no TF32); these combinations
//    are off the serving path. (A version that kept the softmax on the mma
//    fragments in registers, as flash attention does, measured no faster
//    here and spilled: the step is bound by the pool's bytes, not by it.)
// 5. Grid order: the KV head is the fastest grid index, so the Hkv CTAs
//    that read the same pool blocks (each its own 128-byte slice of every
//    row) run side by side; on the H100 this measured the same as the
//    split first.
//
// Layout of the query rows of a CTA: row r of row tile rt is global row
// gr = 16 * rt + r = s * G + g (query s, query head h * G + g).
//
// Interface: a plain C function bound with ctypes
// (accelerate_tpu_torch/ops/kernels/paged_decode.py). It launches the two
// kernels on the caller's stream, allocates nothing (the wrapper passes the
// scratch), refuses a shared-memory size that differs from its own count,
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kConsumers = 3;                  // consumer warps
constexpr int kThreads = 32 * (1 + kConsumers);
constexpr int kRows = 16;                      // query rows a CTA (G * S, padded)
constexpr float kNeg = -1e30f;

template <typename T>
struct Kind {
  static constexpr int value = 0;  // float
};
template <>
struct Kind<bf16> {
  static constexpr int value = 1;
};
template <>
struct Kind<int8_t> {
  static constexpr int value = 2;
};

// The output type: bf16 only when q and the pool are both bf16 (the
// promotion of einsum's operands), f32 otherwise.
template <typename QT, typename KVT>
struct OutOf {
  typedef float type;
};
template <>
struct OutOf<bf16, bf16> {
  typedef bf16 type;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// Four adjacent elements as f32 from shared memory (16, 8 or 4 bytes).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}
// An int8 value exactly as f32: 2^23 + (x + 128) has x + 128 in its low
// mantissa bits, so one integer op and one add replace the quarter-rate I2F.
__device__ __forceinline__ float s8_to_float(uint32_t byte) {
  return __uint_as_float(0x4B000000u | ((byte ^ 0x80u) & 0xFFu)) - 8388736.0f;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&v)[4]) {
  const uint32_t t = *reinterpret_cast<const uint32_t*>(p);
  v[0] = s8_to_float(t);
  v[1] = s8_to_float(t >> 8);
  v[2] = s8_to_float(t >> 16);
  v[3] = s8_to_float(t >> 24);
}

// Two adjacent elements as f32 from shared memory (8, 4 or 2 bytes).
__device__ __forceinline__ void load2(const float* p, float (&v)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x;
  v[1] = t.y;
}
__device__ __forceinline__ void load2(const bf16* p, float (&v)[2]) {
  const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(p);
  v[0] = __low2float(t);
  v[1] = __high2float(t);
}
__device__ __forceinline__ void load2(const int8_t* p, float (&v)[2]) {
  const uint32_t t = *reinterpret_cast<const uint16_t*>(p);
  v[0] = s8_to_float(t);
  v[1] = s8_to_float(t >> 8);
}

// Bytes I and J of four int8 values given as x ^ 0x80808080 (biased to
// unsigned), as one bf16x2 register (byte I in the low half), exactly: one
// byte permute builds 2^23 + (x + 128) and one add takes 2^23 + 128 away.
template <int I, int J>
__device__ __forceinline__ uint32_t s8pair_to_bf16x2(uint32_t biased) {
  const float lo = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | I)) - 8388736.0f;
  const float hi = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | J)) - 8388736.0f;
  return attn::pack_bf16(lo, hi);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// ldmatrix: four 8x8 b16 matrices, lanes 8i..8i+7 giving matrix i's rows.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }

// Byte offset of (row, byte column) in a tile that TMA wrote with the
// 128-byte swizzle: 128-byte panels of `bs` rows, each 1024-byte aligned,
// the 16-byte chunks of a row XOR-ed with the row's index mod 8. Eight rows
// read at one chunk column hit eight different bank groups.
__device__ __forceinline__ int swz(int row, int col, int bs) {
  return (col >> 7) * (bs * 128) + row * 128 + ((((col >> 4) & 7) ^ (row & 7)) << 4) + (col & 15);
}

// Byte offsets of a CTA's dynamic shared memory (the wrapper's plan()
// mirrors this count and the launch refuses a size that differs).
struct Layout {
  int scores;  // kConsumers x kRows x bs f32: raw dots, then biased scores
  int probs;   // kConsumers x kRows rows of (bs * 4 + 16) bytes: p (f32, or bf16)
  int stats;   // kConsumers x 3 x kRows f32: m, l, alpha
  int rank;    // kConsumers x bs int32: the valid-slot rank of each key
  int qinfo;   // kRows q positions, kRows q ranks (int32)
  int cum;     // M int32: inclusive prefix sum of the chain's mask per block
  int tbl;     // split_blocks int32: the split's table entries
  int side;    // stages x (mask row, k scales, v scales) of bs 4-byte values each
  int qtile;   // kRows rows of D * q_elt + 16 bytes
  int ring;    // stages x (K tile, V tile), from the next 1024-byte boundary;
               // the warps' final states reuse it
  int side_stage, st_ks, st_vs, tile, stage, tx;
  int total;
};

__host__ __device__ inline Layout make_layout(int D, int bs, int M, int split_blocks, int stages,
                                              int q_elt, int kv_elt, int has_mask, int quant,
                                              int use_rank) {
  Layout L;
  int off = up16(2 * stages * 8);
  L.scores = off;
  off += up16(kConsumers * kRows * bs * 4);
  L.probs = off;
  off += up16(kConsumers * kRows * (bs * 4 + 16));
  L.stats = off;
  off += up16(kConsumers * 3 * kRows * 4);
  L.rank = off;
  off += up16(kConsumers * bs * 4);
  L.qinfo = off;
  off += up16(2 * kRows * 4);
  L.cum = off;
  off += up16(use_rank ? M * 4 : 0);
  L.tbl = off;
  off += up16(split_blocks * 4);
  L.st_ks = has_mask ? bs * 4 : 0;
  L.st_vs = L.st_ks + (quant ? bs * 4 : 0);
  L.side_stage = L.st_vs + (quant ? bs * 4 : 0);
  L.side = off;
  off += up16(stages * L.side_stage);
  L.qtile = off;
  off += up16(kRows * (D * q_elt + 16));
  L.ring = off;
  L.tile = bs * D * kv_elt;
  L.stage = 2 * L.tile;
  L.tx = L.stage + L.side_stage;
  const int ring = stages * L.stage, comb = kConsumers * kRows * D * 4;
  L.total = L.ring + 1024 + (ring > comb ? ring : comb);
  return L;
}

struct Params {
  const void* q;
  const float *k_scale, *v_scale;  // (N, bs) for an int8 pool, else null
  const int32_t* tables;           // (B, M)
  const void* pos;                 // (S,) or (B, S), int32 or int64
  const int32_t* mask;             // (N, bs) or null
  const void* active;              // (B,) of 1, 4 or 8 bytes, or null (all active)
  float* scratch;                  // splits x rows_total x (D + 2) f32
  void* out;                       // (B, S, H, D)
  long long pos_bstride;
  int pos_elt, active_elt;
  int B, S, H, Hkv, D, N, bs, M, G, rows, row_tiles, split_blocks, splits, stages;
  int rows_total;  // B * S * H
  int has_window, window, use_rank;
  float softcap;  // 0 = off
  float scale;
  Layout L;
};

__device__ __forceinline__ bool slot_active(const Params& p, int b) {
  if (p.active == nullptr) return true;
  if (p.active_elt == 1) return static_cast<const uint8_t*>(p.active)[b] != 0;
  if (p.active_elt == 4) return static_cast<const int32_t*>(p.active)[b] != 0;
  return static_cast<const long long*>(p.active)[b] != 0;
}

__device__ __forceinline__ int q_position(const Params& p, int b, int s) {
  const long long i = static_cast<long long>(b) * p.pos_bstride + s;
  if (p.pos_elt == 4) return static_cast<const int32_t*>(p.pos)[i];
  return static_cast<int>(static_cast<const long long*>(p.pos)[i]);
}

// One (box_d, 1, bs) box of a 3-D tensor map over a pool layer's
// (N * bs, Hkv, D) rows; coordinates innermost first.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(hopper::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(hopper::smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ------------------------------------------------------------- the engines
// Each consumer warp keeps the unnormalised accumulator o of its 16 rows in
// registers (mma: the C-fragment layout; fma: 16 rows x D/32 columns a
// lane) and writes it to the combine area at the end. K and V tiles are
// TMA's swizzled panels (swz).

// Tensor-core engine: bf16 q on a bf16 or int8 pool.
template <typename KVT, int D>
struct MmaEngine {
  float o[D / 8][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }

  // Raw dots of the 16 rows with the block's bs keys, into sc[r * bs + k].
  __device__ __forceinline__ void scores(const unsigned char* qtile, const unsigned char* kt,
                                         int bs, float* sc, int lane) {
    const uint32_t qbase = hopper::smem_u32(qtile) + (lane % 16) * (D * 2 + 16) + (lane / 16) * 16;
    const uint32_t kbase = hopper::smem_u32(kt);
    const int g = lane / 4, c = lane % 4;
    for (int nt = 0; nt < bs / 8; nt += 2) {  // two 8-key tiles, four accumulation chains
      float acc[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        if constexpr (Kind<KVT>::value == 1) {
          uint32_t a0[4], a1[4], b[4], b2[4];
          ldsm_x4(qbase + kk * 32, a0);
          ldsm_x4(qbase + kk * 32 + 32, a1);
          const int col = (kk * 16 + (lane / 8) * 8) * 2;
          ldsm_x4(kbase + swz(nt * 8 + lane % 8, col, bs), b);
          ldsm_x4(kbase + swz(nt * 8 + 8 + lane % 8, col, bs), b2);
          mma_bf16(acc[0], a0, b[0], b[1]);
          mma_bf16(acc[1], a1, b[2], b[3]);
          mma_bf16(acc[2], a0, b2[0], b2[1]);
          mma_bf16(acc[3], a1, b2[2], b2[3]);
        } else {
          // int8 K: the contraction slots of the two k steps are permuted
          // alike in q and K, so that a lane's slots {2c, 2c+1, 2c+8, 2c+9}
          // of both steps are the 8 consecutive elements 8c..8c+7 of the
          // 32: one 8-byte load of its key's row, one 16-byte load of q.
          const unsigned char* q0 = qtile + g * (D * 2 + 16) + (kk * 16 + 8 * c) * 2;
          const uint4 x0 = *reinterpret_cast<const uint4*>(q0);
          const uint4 x1 = *reinterpret_cast<const uint4*>(q0 + 8 * (D * 2 + 16));
          const uint32_t a0[4] = {x0.x, x1.x, x0.y, x1.y}, a1[4] = {x0.z, x1.z, x0.w, x1.w};
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const uint2 k8 =
                *reinterpret_cast<const uint2*>(kt + swz(nt * 8 + 8 * u + g, kk * 16 + 8 * c, bs));
            const uint32_t lo = k8.x ^ 0x80808080u, hi = k8.y ^ 0x80808080u;
            mma_bf16(acc[2 * u], a0, s8pair_to_bf16x2<0, 1>(lo), s8pair_to_bf16x2<2, 3>(lo));
            mma_bf16(acc[2 * u + 1], a1, s8pair_to_bf16x2<0, 1>(hi), s8pair_to_bf16x2<2, 3>(hi));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float* r0 = sc + g * bs + (nt + u) * 8 + 2 * c;
        const float* e = acc[2 * u];
        const float* d = acc[2 * u + 1];
        *reinterpret_cast<float2*>(r0) = make_float2(e[0] + d[0], e[1] + d[1]);
        *reinterpret_cast<float2*>(r0 + 8 * bs) = make_float2(e[2] + d[2], e[3] + d[3]);
      }
    }
  }

  // o = o * alpha + P . V over the block.
  __device__ __forceinline__ void pv(const unsigned char* probs, int ppitch, const float* alpha,
                                     const unsigned char* vt, const float* vs, int bs, int lane) {
    const int g = lane / 4, c = lane % 4;
    const float a_lo = alpha[g], a_hi = alpha[g + 8];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= a_lo;
      o[n][1] *= a_lo;
      o[n][2] *= a_hi;
      o[n][3] *= a_hi;
    }
    const uint32_t vbase = hopper::smem_u32(vt);
    for (int kt = 0; kt < bs / 16; ++kt) {
      if (Kind<KVT>::value == 1) {
        uint32_t a[4];
        ldsm_x4(hopper::smem_u32(probs) + (lane % 16) * ppitch + (kt * 16 + (lane / 16) * 8) * 2,
                a);
        const int vrow = kt * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t b[4];
          ldsm_x4_trans(vbase + swz(vrow, (np * 16 + (lane / 16) * 8) * 2, bs), b);
          mma_bf16(o[2 * np], a, b[0], b[1]);
          mma_bf16(o[2 * np + 1], a, b[2], b[3]);
        }
      } else {
        // w = p * vs_j as hi + lo bf16 terms, in the A-fragment layout.
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = g + (e & 1) * 8, key = kt * 16 + 2 * c + (e >> 1) * 8;
          const float* pr = reinterpret_cast<const float*>(probs + row * ppitch);
          const float w0 = pr[key] * vs[key], w1 = pr[key + 1] * vs[key + 1];
          const float h0 = round_bf16(w0), h1 = round_bf16(w1);
          ahi[e] = attn::pack_bf16(h0, h1);
          alo[e] = attn::pack_bf16(w0 - h0, w1 - h1);
        }
        // int8 V by ldmatrix.trans on byte pairs: a lane gets keys 2c, 2c+1
        // of columns 2g, 2g+1; the even columns feed accumulator 2j and the
        // odd ones 2j+1 of each 16-column group j (write() puts them back).
        const int vrow = kt * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
        for (int np = 0; np < D / 32; ++np) {
          uint32_t r[4];
          ldsm_x4_trans(vbase + swz(vrow, np * 32 + (lane / 16) * 16, bs), r);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const uint32_t lo = r[2 * h2] ^ 0x80808080u, hi = r[2 * h2 + 1] ^ 0x80808080u;
            const int j = 4 * np + 2 * h2;
            const uint32_t e0 = s8pair_to_bf16x2<0, 2>(lo), e1 = s8pair_to_bf16x2<0, 2>(hi);
            const uint32_t d0 = s8pair_to_bf16x2<1, 3>(lo), d1 = s8pair_to_bf16x2<1, 3>(hi);
            mma_bf16(o[j], ahi, e0, e1);
            mma_bf16(o[j], alo, e0, e1);
            mma_bf16(o[j + 1], ahi, d0, d1);
            mma_bf16(o[j + 1], alo, d0, d1);
          }
        }
      }
    }
  }

  __device__ __forceinline__ void write(float* comb, int lane) const {
    const int g = lane / 4, c = lane % 4;
    if constexpr (Kind<KVT>::value == 1) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<float2*>(comb + g * D + n * 8 + 2 * c) = make_float2(o[n][0], o[n][1]);
        *reinterpret_cast<float2*>(comb + (g + 8) * D + n * 8 + 2 * c) =
            make_float2(o[n][2], o[n][3]);
      }
    } else {  // accumulators 2j, 2j+1 hold columns 16j + 4c + {0, 2} and {1, 3}
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const float* e = o[2 * j];
        const float* d = o[2 * j + 1];
        *reinterpret_cast<float4*>(comb + g * D + 16 * j + 4 * c) =
            make_float4(e[0], d[0], e[1], d[1]);
        *reinterpret_cast<float4*>(comb + (g + 8) * D + 16 * j + 4 * c) =
            make_float4(e[2], d[2], e[3], d[3]);
      }
    }
  }
};

// CUDA-core engine: f32 q or an f32 pool, full f32 products.
template <typename KVT, int D>
struct FmaEngine {
  static constexpr int kCols = D / 32;  // adjacent columns a lane owns
  float o[kRows][kCols];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int e = 0; e < kCols; ++e) o[r][e] = 0.f;
  }

  __device__ __forceinline__ void scores(const unsigned char* qtile, const unsigned char* kt,
                                         int bs, float* sc, int lane, int rows) {
    for (int i = lane; i < kRows * bs; i += 32) {
      const int r = i / bs, k = i % bs;
      float acc = 0.f;
      if (r < rows) {
        const float* qr = reinterpret_cast<const float*>(qtile + r * (D * 4 + 16));
#pragma unroll 8
        for (int d = 0; d < D; d += 4) {
          float kv[4];
          load4(reinterpret_cast<const KVT*>(kt + swz(k, d * sizeof(KVT), bs)), kv);
          const float4 qv = *reinterpret_cast<const float4*>(qr + d);
          acc = fmaf(qv.x, kv[0], acc);
          acc = fmaf(qv.y, kv[1], acc);
          acc = fmaf(qv.z, kv[2], acc);
          acc = fmaf(qv.w, kv[3], acc);
        }
      }
      sc[i] = acc;
    }
  }

  __device__ __forceinline__ void pv(const unsigned char* probs, int ppitch, const float* alpha,
                                     const unsigned char* vt, const float* vs, int bs, int lane,
                                     int rows) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float a = alpha[r];
#pragma unroll
      for (int e = 0; e < kCols; ++e) o[r][e] *= a;
    }
    for (int k = 0; k < bs; ++k) {
      float vv[kCols];
      if constexpr (kCols == 2) {
        load2(reinterpret_cast<const KVT*>(vt + swz(k, lane * kCols * sizeof(KVT), bs)), vv);
      } else {
#pragma unroll
        for (int e = 0; e < kCols; e += 4) {
          float t[4];
          load4(reinterpret_cast<const KVT*>(vt + swz(k, (lane * kCols + e) * sizeof(KVT), bs)), t);
#pragma unroll
          for (int u = 0; u < 4; ++u) vv[e + u] = t[u];
        }
      }
      const float vsk = vs != nullptr ? vs[k] : 1.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const float w = reinterpret_cast<const float*>(probs + r * ppitch)[k] * vsk;
#pragma unroll
          for (int e = 0; e < kCols; ++e) o[r][e] = fmaf(w, vv[e], o[r][e]);
        }
      }
    }
  }

  __device__ __forceinline__ void write(float* comb, int lane) const {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int e = 0; e < kCols; ++e) comb[r * D + lane * kCols + e] = o[r][e];
  }
};

// ------------------------------------------------------------- split kernel
template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_split(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const Params p) {
  constexpr bool kMma = Kind<QT>::value == 1 && Kind<KVT>::value != 0;
  constexpr bool kRoundScores = Kind<QT>::value == 1 && Kind<KVT>::value == 1;
  constexpr bool kQuant = Kind<KVT>::value == 2;
  constexpr int kBox = 128 / sizeof(KVT);  // elements of D a TMA box holds (128 bytes)
  typedef typename std::conditional<kMma, MmaEngine<KVT, D>, FmaEngine<KVT, D>>::type Engine;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout& L = p.L;
  const int h = blockIdx.x, split = blockIdx.y;
  const int b = blockIdx.z / p.row_tiles, rt = blockIdx.z % p.row_tiles;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, bs = p.bs;
  const int rows = min(kRows, p.rows - rt * kRows);  // real rows of this tile
  // The (B, S, H) row of row r of this tile: query s = gr / G, head h * G + gr % G.
  auto out_row = [&](int r) {
    const int gr = rt * kRows + r;
    return (static_cast<long long>(b) * p.S + gr / p.G) * p.H + h * p.G + gr % p.G;
  };
  if (!slot_active(p, b)) return;  // the merge writes its zeros
  const int j0 = split * p.split_blocks, nblk = min(p.split_blocks, p.M - j0);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + p.stages;
  int* qpos = reinterpret_cast<int*>(smem + L.qinfo);
  int* qrank = qpos + kRows;
  int* cum = reinterpret_cast<int*>(smem + L.cum);
  int* tbl = reinterpret_cast<int*>(smem + L.tbl);  // the split's table entries, read up front
  unsigned char* ring = hopper::align1024(smem + L.ring);
  const int32_t* table = p.tables + static_cast<long long>(b) * p.M;

  if (tid == 0) {
    for (int st = 0; st < p.stages; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], 1);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 0) {
    // Producer: read the split's table entries, then keep the ring full, a
    // block a stage: D * elt / 128 TMA boxes of bs rows for K and as many
    // for V, plus the mask row and the scale rows by bulk copies. It starts
    // while the consumers load the query tile.
    for (int i = lane; i < nblk; i += 32) {
      const int blk = table[j0 + i];
      if (blk < 0 || blk >= p.N) __trap();  // a table entry outside the pool is a caller bug
      tbl[i] = blk;
    }
    __syncwarp();
    if (lane == 0) {
      for (int i = 0; i < nblk; ++i) {
        const int st = i % p.stages;
        if (i >= p.stages) hopper::mbar_wait_fault(&empty[st], ((i / p.stages) - 1) & 1);
        const int row0 = tbl[i] * bs;
        unsigned char* kt = ring + st * L.stage;
        unsigned char* side = smem + L.side + st * L.side_stage;
        hopper::mbar_arrive_expect_tx(&full[st], L.tx);
#pragma unroll
        for (int pnl = 0; pnl < D / kBox; ++pnl) {
          tma_load_3d(kt + pnl * bs * 128, &kmap, &full[st], pnl * kBox, h, row0);
          tma_load_3d(kt + L.tile + pnl * bs * 128, &vmap, &full[st], pnl * kBox, h, row0);
        }
        if (p.mask != nullptr) hopper::bulk_load(side, p.mask + row0, bs * 4, &full[st]);
        if (kQuant) {
          hopper::bulk_load(side + L.st_ks, p.k_scale + row0, bs * 4, &full[st]);
          hopper::bulk_load(side + L.st_vs, p.v_scale + row0, bs * 4, &full[st]);
        }
      }
    }
    return;
  }

  // Consumers' setup (96 threads): the query tile, 16 bytes a thread at a
  // time (bf16 for the tensor cores, else f32; zero rows pad), the rows'
  // positions and, where a window meets a mask, their valid-slot ranks.
  const int ctid = tid - 32, cw = warp - 1;
  constexpr int kCThreads = 32 * kConsumers;
  constexpr int kQElt = kMma ? 2 : 4;
  constexpr int kVec = 16 / sizeof(QT);  // elements of q a 16-byte load holds
  for (int i = ctid; i < kRows * D / kVec; i += kCThreads) {
    const int r = i / (D / kVec), d = (i % (D / kVec)) * kVec;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows)  // q and out share the (B, S, H, D) layout
      raw = *reinterpret_cast<const uint4*>(static_cast<const QT*>(p.q) + out_row(r) * D + d);
    unsigned char* dst = smem + L.qtile + r * (D * kQElt + 16) + d * kQElt;
    if (sizeof(QT) == kQElt) {
      *reinterpret_cast<uint4*>(dst) = raw;
    } else {  // bf16 q for the CUDA cores: widen to f32
      const bf16* x = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) reinterpret_cast<float*>(dst)[e] = __bfloat162float(x[e]);
    }
  }
  if (ctid < kRows) qpos[ctid] = ctid < rows ? q_position(p, b, (rt * kRows + ctid) / p.G) : 0;
  if (p.use_rank) {  // counts of valid slots per block, then their inclusive prefix sum
    for (int m = ctid; m < p.M; m += kCThreads) {
      const int blk = table[m];
      if (blk < 0 || blk >= p.N) __trap();  // a table entry outside the pool is a caller bug
      int n = 0;
      for (int k = 0; k < bs; ++k) n += p.mask[static_cast<long long>(blk) * bs + k];
      cum[m] = n;
    }
    hopper::named_bar_sync(1, kCThreads);
    if (cw == 0) {
      int carry = 0;
      for (int base = 0; base < p.M; base += 32) {
        int x = base + lane < p.M ? cum[base + lane] : 0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, off);
          if (lane >= off) x += y;
        }
        if (base + lane < p.M) cum[base + lane] = carry + x;
        carry += __shfl_sync(0xffffffffu, x, 31);
      }
    }
    hopper::named_bar_sync(1, kCThreads);
    if (ctid < rows) {
      const int qp = qpos[ctid];
      if (qp < 0 || qp >= p.M * bs) __trap();  // the plain version's gather refuses it too
      const int pm = qp / bs, blk = table[pm];
      int n = pm > 0 ? cum[pm - 1] : 0;
      for (int k = 0; k <= qp % bs; ++k) n += p.mask[static_cast<long long>(blk) * bs + k];
      qrank[ctid] = n;
    } else if (ctid < kRows) {
      qrank[ctid] = 0;
    }
  }
  hopper::named_bar_sync(1, kCThreads);

  // Consumers: warp cw takes blocks cw, cw + 3, ... of the split.
  float* sc = reinterpret_cast<float*>(smem + L.scores) + cw * kRows * bs;
  const int ppitch = bs * 4 + 16;
  unsigned char* probs = smem + L.probs + cw * kRows * ppitch;
  float* m_w = reinterpret_cast<float*>(smem + L.stats) + cw * 3 * kRows;
  float* l_w = m_w + kRows;
  float* alpha_w = l_w + kRows;
  int* rk = reinterpret_cast<int*>(smem + L.rank) + cw * bs;
  if (lane < kRows) {
    m_w[lane] = -INFINITY;
    l_w[lane] = 0.f;
    alpha_w[lane] = 0.f;
  }
  Engine eng;
  eng.zero();
  __syncwarp();
  const int quad = lane >> 3, l8 = lane & 7;  // the softmax step: 8 lanes a row
  for (int i = cw; i < nblk; i += kConsumers) {
    const int st = i % p.stages;
    hopper::mbar_wait_fault(&full[st], (i / p.stages) & 1);
    const unsigned char* kt = ring + st * L.stage;
    const unsigned char* side = smem + L.side + st * L.side_stage;
    const int32_t* mrow = reinterpret_cast<const int32_t*>(side);
    const float* ks = reinterpret_cast<const float*>(side + L.st_ks);
    const float* vs = reinterpret_cast<const float*>(side + L.st_vs);
    const int jb = (j0 + i) * bs;  // chain index of the block's first key
    if (p.use_rank) {  // ranks over the whole chain: the count before the block, plus its prefix
      int carry = j0 + i > 0 ? cum[j0 + i - 1] : 0;
      for (int base = 0; base < bs; base += 32) {
        int x = base + lane < bs ? mrow[base + lane] : 0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, off);
          if (lane >= off) x += y;
        }
        if (base + lane < bs) rk[base + lane] = carry + x;
        carry += __shfl_sync(0xffffffffu, x, 31);
      }
    }
    if constexpr (kMma)
      eng.scores(smem + L.qtile, kt, bs, sc, lane);
    else
      eng.scores(smem + L.qtile, kt, bs, sc, lane, rows);
    __syncwarp();
    // Online softmax step over the real rows, 8 lanes a row, 4 rows a pass:
    // bias, running max, p = exp(s - m), l, alpha.
    for (int t = 0; t < (rows + 3) / 4; ++t) {
      const int r = 4 * t + quad;
      const bool live = r < rows;
      const int rr = live ? r : 0;
      const int qp = qpos[rr], qr = qrank[rr];
      float mx = -INFINITY;
      for (int k = l8; k < bs; k += 8) {
        float v = sc[rr * bs + k];
        if (kRoundScores) v = round_bf16(v);
        if (kQuant) v = __fmul_rn(v, ks[k]);
        v = __fmul_rn(v, p.scale);
        if (p.softcap > 0.f) v = __fmul_rn(tanhf(__fdiv_rn(v, p.softcap)), p.softcap);
        const int delta = qp - (jb + k);
        bool keep = delta >= 0;
        if (p.has_window) keep = keep && (p.use_rank ? qr - rk[k] : delta) < p.window;
        float bias = keep ? 0.f : kNeg;
        if (p.mask != nullptr) bias = __fadd_rn(bias, mrow[k] != 0 ? 0.f : kNeg);
        v = __fadd_rn(v, bias);
        if (live) sc[r * bs + k] = v;
        mx = fmaxf(mx, v);
      }
#pragma unroll
      for (int off = 4; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_w[rr];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      if (live) {
        for (int k = l8; k < bs; k += 8) {
          const float e = __expf(sc[r * bs + k] - m_new);
          sum += e;
          if (kMma && Kind<KVT>::value == 1)
            reinterpret_cast<bf16*>(probs + r * ppitch)[k] = __float2bfloat16_rn(e);
          else
            reinterpret_cast<float*>(probs + r * ppitch)[k] = e;
        }
      }
#pragma unroll
      for (int off = 4; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (live && l8 == 0) {
        const float alpha = __expf(m_old - m_new);  // 0 on the first block (m_old = -inf)
        m_w[r] = m_new;
        l_w[r] = l_w[r] * alpha + sum;
        alpha_w[r] = alpha;
      }
    }
    __syncwarp();
    if constexpr (kMma)
      eng.pv(probs, ppitch, alpha_w, kt + L.tile, vs, bs, lane);
    else
      eng.pv(probs, ppitch, alpha_w, kt + L.tile, kQuant ? vs : nullptr, bs, lane, rows);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  // Combine the three warps' states in warp order; write the split's
  // (m, l, o) of each real row to the scratch.
  hopper::named_bar_sync(1, kCThreads);  // every stage read: the ring is free
  float* comb = reinterpret_cast<float*>(ring);
  eng.write(comb + cw * kRows * D, lane);
  hopper::named_bar_sync(1, kCThreads);
  const float* stats = reinterpret_cast<const float*>(smem + L.stats);
  for (int i = ctid; i < rows * D; i += kCThreads) {
    const int row = i / D, d = i % D;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) m = fmaxf(m, stats[w * 3 * kRows + row]);
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      const float e = __expf(stats[w * 3 * kRows + row] - m);  // 0 for a warp without blocks
      o = fmaf(comb[(w * kRows + row) * D + d], e, o);
      l = fmaf(stats[w * 3 * kRows + kRows + row], e, l);
    }
    float* dst =
        p.scratch + (static_cast<long long>(split) * p.rows_total + out_row(row)) * (D + 2);
    dst[2 + d] = o;
    if (d == 0) {
      dst[0] = m;
      dst[1] = l;
    }
  }
}

// ------------------------------------------------------------- merge kernel
// A CTA of D threads a (slot, query, head) row, a column a thread: an
// online merge of the splits' (m, l, o) in split order (the running max
// rescales the sums, as in the split's own softmax), the next eight splits'
// loads in flight while eight are merged, then the division and the cast;
// zeros for an inactive slot.
template <typename OutT, int D>
__global__ void __launch_bounds__(D) paged_decode_merge(const Params p) {
  const int row = blockIdx.x, tid = threadIdx.x;
  OutT* out = static_cast<OutT*>(p.out) + static_cast<long long>(row) * D;
  if (!slot_active(p, row / (p.S * p.H))) {
    store(out + tid, 0.f);
    return;
  }
  const long long stride = static_cast<long long>(p.rows_total) * (D + 2);
  const float* src = p.scratch + static_cast<long long>(row) * (D + 2);
  float m = -INFINITY, l = 0.f, acc = 0.f;
  float2 ml[8], ml_next[8];
  float x[8], x_next[8];
  auto fetch = [&](int i0, float2(&mls)[8], float(&xs)[8]) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (i0 + u < p.splits) {
        mls[u] = *reinterpret_cast<const float2*>(src + (i0 + u) * stride);
        xs[u] = src[(i0 + u) * stride + 2 + tid];
      }
    }
  };
  fetch(0, ml, x);
  for (int i0 = 0; i0 < p.splits; i0 += 8) {
    if (i0 + 8 < p.splits) fetch(i0 + 8, ml_next, x_next);  // the next eight in flight
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (i0 + u < p.splits) {
        const float m_new = fmaxf(m, ml[u].x);
        const float keep = __expf(m - m_new), e = __expf(ml[u].x - m_new);  // keep = 0 at first
        acc = fmaf(x[u], e, acc * keep);
        l = fmaf(ml[u].y, e, l * keep);
        m = m_new;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      ml[u] = ml_next[u];
      x[u] = x_next[u];
    }
  }
  store(out + tid, __fdiv_rn(acc, l));
}

// A 3-D tensor map over one pool layer: dims (D, Hkv, N * bs), boxes of
// (128 bytes of D, 1 head, bs rows), 128-byte swizzle.
int encode_pool_map(CUtensorMap* map, const void* pool, CUtensorMapDataType type, int elt, int D,
                    int Hkv, long long rows, int bs) {
  const hopper::EncodeTiledFn fn = hopper::encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * elt,
                                 static_cast<cuuint64_t>(Hkv) * D * elt};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / elt), 1, static_cast<cuuint32_t>(bs)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, type, 3, const_cast<void*>(pool), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename QT, typename KVT, int D>
int launch(const CUtensorMap& kmap, const CUtensorMap& vmap, const Params& p, cudaStream_t stream) {
  auto kernel = paged_decode_split<QT, KVT, D>;
  if (p.L.total > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.L.total);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(p.Hkv, p.splits, p.B * p.row_tiles);
  kernel<<<grid, kThreads, p.L.total, stream>>>(kmap, vmap, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  typedef typename OutOf<QT, KVT>::type OutT;
  paged_decode_merge<OutT, D><<<p.rows_total, D, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KVT>
int launch_d(const CUtensorMap& kmap, const CUtensorMap& vmap, const Params& p,
             cudaStream_t stream) {
  switch (p.D) {
    case 64:
      return launch<QT, KVT, 64>(kmap, vmap, p, stream);
    case 128:
      return launch<QT, KVT, 128>(kmap, vmap, p, stream);
    case 256:
      return launch<QT, KVT, 256>(kmap, vmap, p, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q_kind: 0 = float32, 1 = bfloat16. kv_kind: 0 = float32, 1 = bfloat16,
// 2 = int8 with k_scale/v_scale. pos holds int32 (pos_elt 4) or int64 (8)
// positions, pos_bstride apart between slots (0 for one row shared by all
// slots). active: null (every slot active) or B flags of active_elt bytes.
// mask may be null. scratch: splits x B*S*H x (D + 2) f32. The wrapper
// checks D (a multiple of 128 bytes of the pool's type, up to 256
// elements), bs a multiple of 16, the 16-byte alignment of the pools and
// the scale and mask rows, Hkv dividing H, and the grid's limits; `smem`
// must equal this function's own count.
int paged_decode_launch(int q_kind, int kv_kind, const void* q, const void* k, const void* v,
                        const void* k_scale, const void* v_scale, const void* tables,
                        const void* pos, int pos_elt, long long pos_bstride, const void* mask,
                        const void* active, int active_elt, void* out, void* scratch, int B, int S,
                        int H, int Hkv, int D, int N, int bs, int M, int split_blocks, int stages,
                        int has_window, int window, float softcap, float scale, long long smem,
                        void* stream) {
  Params p;
  p.q = q;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int32_t*>(tables);
  p.pos = pos;
  p.pos_elt = pos_elt;
  p.pos_bstride = pos_bstride;
  p.mask = static_cast<const int32_t*>(mask);
  p.active = active;
  p.active_elt = active_elt;
  p.scratch = static_cast<float*>(scratch);
  p.out = out;
  p.B = B;
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.D = D;
  p.N = N;
  p.bs = bs;
  p.M = M;
  p.G = H / Hkv;
  p.rows = p.G * S;
  p.row_tiles = (p.rows + kRows - 1) / kRows;
  p.split_blocks = split_blocks;
  p.splits = (M + split_blocks - 1) / split_blocks;
  p.stages = stages;
  p.rows_total = B * S * H;
  p.has_window = has_window;
  p.window = window;
  p.use_rank = has_window && mask != nullptr;
  p.softcap = softcap;
  p.scale = scale;
  const bool mma = q_kind == 1 && kv_kind != 0;
  const int elt = kv_kind == 0 ? 4 : (kv_kind == 1 ? 2 : 1);
  p.L = make_layout(D, bs, M, split_blocks, stages, mma ? 2 : 4, elt, mask != nullptr,
                    kv_kind == 2, p.use_rank);
  if (static_cast<long long>(p.L.total) != smem || stages % kConsumers != 0 || bs % 16 != 0 ||
      (D * elt) % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType type = kv_kind == 0   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : kv_kind == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                  : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap kmap, vmap;
  const long long rows = static_cast<long long>(N) * bs;
  int rc = encode_pool_map(&kmap, k, type, elt, D, Hkv, rows, bs);
  if (rc == 0) rc = encode_pool_map(&vmap, v, type, elt, D, Hkv, rows, bs);
  if (rc != 0) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_kind * 3 + kv_kind) {
    case 0:
      return launch_d<float, float>(kmap, vmap, p, s);
    case 1:
      return launch_d<float, bf16>(kmap, vmap, p, s);
    case 2:
      return launch_d<float, int8_t>(kmap, vmap, p, s);
    case 3:
      return launch_d<bf16, float>(kmap, vmap, p, s);
    case 4:
      return launch_d<bf16, bf16>(kmap, vmap, p, s);
    case 5:
      return launch_d<bf16, int8_t>(kmap, vmap, p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
