// Causal flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the library flash kernel that the JAX package calls from
// accelerate_tpu/ops/attention.py:144 (jax/experimental/pallas/ops/tpu/
// flash_attention.py: forward pallas_call at :758, dkv at :1121, dq at :1456).
//
// What it computes, in the layout (B, S, H, D) with bf16 q, k, v and equal
// head counts (GQA heads are repeated by the caller, as the JAX model does):
//   s = (q . k^T) * scale in f32; where a key is masked (key > query when
//   causal, or a segment id that differs from the query's) s += MASK, the
//   library's DEFAULT_MASK_VALUE (-0.7 * FLT_MAX); p = softmax(s) with an
//   online running max and sum; P is rounded to bf16 before P.V, which
//   accumulates in f32 (the library does p.astype(v.dtype) at :471/:556).
//   The forward writes o (bf16) and the per-row log-sum-exp (f32, (B, H, S)).
//   The backward recomputes P = exp(s - lse) and follows the library's split:
//   delta = rowsum(dO * O); a dK/dV kernel over KV tiles; a dQ kernel over
//   query tiles. No atomics: every output element has one writer, so the
//   result is deterministic.
//
// Bound: operations. At the Llama-3-8B training shape (B=2, S=2048, H=32,
// D=128, causal) the forward needs 68.7 GFLOP, 0.069 ms at 989 TFLOP/s,
// against 67 MB of bytes (0.02 ms at 3.35 TB/s); the backward needs about
// 2.5 times the forward's products.
//
// Design: tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulate),
// four warps per CTA, each warp owning 16 rows of the 64-row tile it works
// on. The accumulator of S = Q.K^T has the register layout of the A operand
// of P.V, so P never leaves registers; row max and row sum are reduced over
// the four lanes that share a row with two shuffles. Operand fragments come
// from shared memory through ldmatrix (.trans for the operands stored
// k-major, V in P.V and Q/dO in the backward's products), four 8x8 matrices
// per instruction. Tiles are staged with rows padded by 8 elements, so each
// ldmatrix phase hits 32 distinct banks, and the tiles a loop walks are
// double-buffered with cp.async: the next tile's copy is in flight while
// the tensor cores work on the current one. Causal tiles above the diagonal
// are skipped, and the forward and dQ walk query tiles heaviest first.
// wgmma and TMA wait for a later change.
//
// Interface: plain C functions bound with ctypes
// (accelerate_tpu_torch/ops/kernels/flash_attention.py). Each launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;      // rows of a query tile (forward, dQ) and of a KV tile
constexpr int kBwdQTile = 32;  // query rows per step of the dK/dV kernel
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
// memory (row stride D + 8), 16 bytes per cp.async; the caller commits.
template <int D>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long stride, int rows) {
  constexpr int kVecs = D / 8;
  for (int i = threadIdx.x; i < rows * kVecs; i += kThreads) {
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

// Scaled, masked logit: the library's s * sm_scale + where(keep, 0, MASK).
__device__ __forceinline__ float masked_logit(float dot, float scale, int query, int key,
                                              int causal, const int* seg_row, int seg_q) {
  float s = dot * scale;
  const bool keep = (!causal || key <= query) && (seg_row == nullptr || seg_row[key] == seg_q);
  return keep ? s : s + kMaskValue;
}

template <int D>
__host__ __device__ constexpr int tile_elems() {
  return kTile * (D + 8);
}

// ------------------------------------------------------------------ forward
// Shared memory: K and V tiles, two stages each.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const int* __restrict__ seg, bf16* __restrict__ o, float* __restrict__ lse, int S,
              int H, int causal, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);  // [2][kTile * LD]
  bf16* sV = sK + 2 * tile_elems<D>();       // [2][kTile * LD]
  const int n_tiles = S / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long stride = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * S * stride + static_cast<long long>(h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const int* seg_row = seg == nullptr ? nullptr : seg + static_cast<long long>(b) * S;

  // Stage the Q tile through sK; each warp keeps its 16 rows as A fragments.
  load_tile<D>(sK, q + base + q0 * stride, stride, kTile);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a<LD>(qa[kk], sK, warp * 16, kk * 16, lane);
  __syncthreads();

  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const int seg_a = seg_row == nullptr ? 0 : seg_row[row_a];
  const int seg_b = seg_row == nullptr ? 0 : seg_row[row_b];
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int n_kv = causal ? qt + 1 : n_tiles;
  load_tile<D>(sK, k + base, stride, kTile);
  load_tile<D>(sV, v + base, stride, kTile);
  cp_async_commit();
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kTile;
    const bf16* cK = sK + (kt & 1) * tile_elems<D>();
    const bf16* cV = sV + (kt & 1) * tile_elems<D>();
    if (kt + 1 < n_kv) {  // prefetch the next tile into the other stage
      const long long next = static_cast<long long>(k0 + kTile) * stride;
      load_tile<D>(sK + ((kt + 1) & 1) * tile_elems<D>(), k + base + next, stride, kTile);
      load_tile<D>(sV + ((kt + 1) & 1) * tile_elems<D>(), v + base + next, stride, kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kTile / 8; n += 2) {
        uint32_t bb[4];
        load_b_rows<LD>(bb, cK, n * 8, kk * 16, lane);
        mma(s[n], qa[kk], bb[0], bb[1]);
        mma(s[n + 1], qa[kk], bb[2], bb[3]);
      }
    }
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + n * 8 + t * 2 + j;
        s[n][j] = masked_logit(s[n][j], scale, row_a, key, causal, seg_row, seg_a);
        s[n][2 + j] = masked_logit(s[n][2 + j], scale, row_b, key, causal, seg_row, seg_b);
        mx_a = fmaxf(mx_a, s[n][j]);
        mx_b = fmaxf(mx_b, s[n][2 + j]);
      }
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    const float alpha_a = __expf(m_a - mx_a), alpha_b = __expf(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      s[n][0] = __expf(s[n][0] - m_a);
      s[n][1] = __expf(s[n][1] - m_a);
      s[n][2] = __expf(s[n][2] - m_b);
      s[n][3] = __expf(s[n][3] - m_b);
      rs_a += s[n][0] + s[n][1];
      rs_b += s[n][2] + s[n][3];
    }
    l_a = l_a * alpha_a + rs_a;  // per-lane partial sums; reduced over the quad at the end
    l_b = l_b * alpha_b + rs_b;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= alpha_a;
      acc[i][1] *= alpha_a;
      acc[i][2] *= alpha_b;
      acc[i][3] *= alpha_b;
    }
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int i = 0; i < D / 8; i += 2) {
        uint32_t bb[4];
        load_b_cols<LD>(bb, cV, i * 8, kc * 16, lane);
        mma(acc[i], pa, bb[0], bb[1]);
        mma(acc[i + 1], pa, bb[2], bb[3]);
      }
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
  bf16* oa = o + base + row_a * stride + t * 2;
  bf16* ob = o + base + row_b * stride + t * 2;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    *reinterpret_cast<uint32_t*>(oa + i * 8) = pack_bf16(acc[i][0] * inv_a, acc[i][1] * inv_a);
    *reinterpret_cast<uint32_t*>(ob + i * 8) = pack_bf16(acc[i][2] * inv_b, acc[i][3] * inv_b);
  }
  if (t == 0) {
    float* lrow = lse + static_cast<long long>(bh) * S;
    lrow[row_a] = m_a + logf(l_a);
    lrow[row_b] = m_b + logf(l_b);
  }
}

// ------------------------------------------------------------ backward: delta
// delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d] in f32; one warp per row.
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                    float* __restrict__ delta, int S, int H, long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const bf16* po = o + r * D;
  const bf16* pd = dout + r * D;
  float acc = 0.f;
#pragma unroll
  for (int i = lane; i < D; i += 32) acc += __bfloat162float(po[i]) * __bfloat162float(pd[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long b = r / (static_cast<long long>(S) * H);
    const int s = static_cast<int>((r / H) % S), h = static_cast<int>(r % H);
    delta[(b * H + h) * S + s] = acc;
  }
}

// ------------------------------------------------------------ backward: dK, dV
// Grid (KV tiles, B*H). Each warp owns 16 keys of the CTA's 64-key tile and
// walks the query tiles that can see them, 32 queries at a time:
//   P^T = exp(S^T - lse), dV += P^T dO, dP^T = V dO^T,
//   dS^T = P^T (dP^T - delta) * scale, dK += dS^T Q.
// Shared memory: the K and V tiles, and two stages of the Q and dO tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ seg,
                   const bf16* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                   int S, int H, int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int kQElems = kBwdQTile * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + tile_elems<D>();
  bf16* sQ = sV + tile_elems<D>();  // [2][kQElems]
  bf16* sdO = sQ + 2 * kQElems;     // [2][kQElems]

  const int kt = blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long stride = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * S * stride + static_cast<long long>(h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kTile;
  const int* seg_row = seg == nullptr ? nullptr : seg + static_cast<long long>(b) * S;
  const float* lse_row = lse + static_cast<long long>(bh) * S;
  const float* delta_row = delta + static_cast<long long>(bh) * S;

  const int q_first = causal ? k0 : 0;
  load_tile<D>(sK, k + base + k0 * stride, stride, kTile);
  load_tile<D>(sV, v + base + k0 * stride, stride, kTile);
  load_tile<D>(sQ, q + base + q_first * stride, stride, kBwdQTile);
  load_tile<D>(sdO, dout + base + q_first * stride, stride, kBwdQTile);
  cp_async_commit();

  const int key_a = k0 + warp * 16 + g, key_b = key_a + 8;
  const int seg_ka = seg_row == nullptr ? 0 : seg_row[key_a];
  const int seg_kb = seg_row == nullptr ? 0 : seg_row[key_b];
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  for (int q0 = q_first, step = 0; q0 < S; q0 += kBwdQTile, ++step) {
    const bf16* cQ = sQ + (step & 1) * kQElems;
    const bf16* cdO = sdO + (step & 1) * kQElems;
    if (q0 + kBwdQTile < S) {  // prefetch the next query step into the other stage
      const long long next = static_cast<long long>(q0 + kBwdQTile) * stride;
      load_tile<D>(sQ + ((step + 1) & 1) * kQElems, q + base + next, stride, kBwdQTile);
      load_tile<D>(sdO + ((step + 1) & 1) * kQElems, dout + base + next, stride, kBwdQTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S^T = K_w Q^T: 16 keys x 32 queries.
    float st[kBwdQTile / 8][4];
#pragma unroll
    for (int n = 0; n < kBwdQTile / 8; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4];
      load_a<LD>(ka, sK, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < kBwdQTile / 8; n += 2) {
        uint32_t bb[4];
        load_b_rows<LD>(bb, cQ, n * 8, kk * 16, lane);
        mma(st[n], ka, bb[0], bb[1]);
        mma(st[n + 1], ka, bb[2], bb[3]);
      }
    }
    // P^T = exp(masked logit - lse[query]).
#pragma unroll
    for (int n = 0; n < kBwdQTile / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int query = q0 + n * 8 + t * 2 + j;
        const int seg_q = seg_row == nullptr ? 0 : seg_row[query];
        const float ls = lse_row[query];
        const bool keep_a = (!causal || key_a <= query) && (seg_row == nullptr || seg_ka == seg_q);
        const bool keep_b = (!causal || key_b <= query) && (seg_row == nullptr || seg_kb == seg_q);
        const float sa = st[n][j] * scale, sb = st[n][2 + j] * scale;
        st[n][j] = __expf((keep_a ? sa : sa + kMaskValue) - ls);
        st[n][2 + j] = __expf((keep_b ? sb : sb + kMaskValue) - ls);
      }
    }
    // dV += P^T dO: 16 keys x D over 32 queries.
#pragma unroll
    for (int kc = 0; kc < kBwdQTile / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kc][0], st[2 * kc][1]),
                              pack_bf16(st[2 * kc][2], st[2 * kc][3]),
                              pack_bf16(st[2 * kc + 1][0], st[2 * kc + 1][1]),
                              pack_bf16(st[2 * kc + 1][2], st[2 * kc + 1][3])};
#pragma unroll
      for (int i = 0; i < D / 8; i += 2) {
        uint32_t bb[4];
        load_b_cols<LD>(bb, cdO, i * 8, kc * 16, lane);
        mma(dv_acc[i], pa, bb[0], bb[1]);
        mma(dv_acc[i + 1], pa, bb[2], bb[3]);
      }
    }
    // dP^T = V_w dO^T: 16 keys x 32 queries.
    float dpt[kBwdQTile / 8][4];
#pragma unroll
    for (int n = 0; n < kBwdQTile / 8; ++n) dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t va[4];
      load_a<LD>(va, sV, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < kBwdQTile / 8; n += 2) {
        uint32_t bb[4];
        load_b_rows<LD>(bb, cdO, n * 8, kk * 16, lane);
        mma(dpt[n], va, bb[0], bb[1]);
        mma(dpt[n + 1], va, bb[2], bb[3]);
      }
    }
    // dS^T = P^T (dP^T - delta[query]) * scale, then dK += dS^T Q.
#pragma unroll
    for (int n = 0; n < kBwdQTile / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float dl = delta_row[q0 + n * 8 + t * 2 + j];
        st[n][j] = st[n][j] * (dpt[n][j] - dl) * scale;
        st[n][2 + j] = st[n][2 + j] * (dpt[n][2 + j] - dl) * scale;
      }
    }
#pragma unroll
    for (int kc = 0; kc < kBwdQTile / 16; ++kc) {
      const uint32_t da[4] = {pack_bf16(st[2 * kc][0], st[2 * kc][1]),
                              pack_bf16(st[2 * kc][2], st[2 * kc][3]),
                              pack_bf16(st[2 * kc + 1][0], st[2 * kc + 1][1]),
                              pack_bf16(st[2 * kc + 1][2], st[2 * kc + 1][3])};
#pragma unroll
      for (int i = 0; i < D / 8; i += 2) {
        uint32_t bb[4];
        load_b_cols<LD>(bb, cQ, i * 8, kc * 16, lane);
        mma(dk_acc[i], da, bb[0], bb[1]);
        mma(dk_acc[i + 1], da, bb[2], bb[3]);
      }
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }

  bf16* dka = dk + base + key_a * stride + t * 2;
  bf16* dkb = dk + base + key_b * stride + t * 2;
  bf16* dva = dv + base + key_a * stride + t * 2;
  bf16* dvb = dv + base + key_b * stride + t * 2;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    *reinterpret_cast<uint32_t*>(dka + i * 8) = pack_bf16(dk_acc[i][0], dk_acc[i][1]);
    *reinterpret_cast<uint32_t*>(dkb + i * 8) = pack_bf16(dk_acc[i][2], dk_acc[i][3]);
    *reinterpret_cast<uint32_t*>(dva + i * 8) = pack_bf16(dv_acc[i][0], dv_acc[i][1]);
    *reinterpret_cast<uint32_t*>(dvb + i * 8) = pack_bf16(dv_acc[i][2], dv_acc[i][3]);
  }
}

// ------------------------------------------------------------ backward: dQ
// Grid (query tiles, B*H). Each warp owns 16 queries and walks the KV tiles
// they can see: P = exp(S - lse), dP = dO V^T, dS = P (dP - delta) * scale,
// dQ += dS K. Shared memory: the Q and dO tiles, and two stages of the K and
// V tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg,
                 const bf16* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq, int S, int H, int causal,
                 float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + tile_elems<D>();
  bf16* sK = sdO + tile_elems<D>();      // [2][kTile * LD]
  bf16* sV = sK + 2 * tile_elems<D>();  // [2][kTile * LD]

  const int n_tiles = S / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long stride = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * S * stride + static_cast<long long>(h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const int* seg_row = seg == nullptr ? nullptr : seg + static_cast<long long>(b) * S;

  load_tile<D>(sQ, q + base + q0 * stride, stride, kTile);
  load_tile<D>(sdO, dout + base + q0 * stride, stride, kTile);
  load_tile<D>(sK, k + base, stride, kTile);
  load_tile<D>(sV, v + base, stride, kTile);
  cp_async_commit();
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const int seg_a = seg_row == nullptr ? 0 : seg_row[row_a];
  const int seg_b = seg_row == nullptr ? 0 : seg_row[row_b];
  const float lse_a = lse[static_cast<long long>(bh) * S + row_a];
  const float lse_b = lse[static_cast<long long>(bh) * S + row_b];
  const float dl_a = delta[static_cast<long long>(bh) * S + row_a];
  const float dl_b = delta[static_cast<long long>(bh) * S + row_b];
  float dq_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq_acc[i][0] = dq_acc[i][1] = dq_acc[i][2] = dq_acc[i][3] = 0.f;

  const int n_kv = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kTile;
    const bf16* cK = sK + (kt & 1) * tile_elems<D>();
    const bf16* cV = sV + (kt & 1) * tile_elems<D>();
    if (kt + 1 < n_kv) {  // prefetch the next tile into the other stage
      const long long next = static_cast<long long>(k0 + kTile) * stride;
      load_tile<D>(sK + ((kt + 1) & 1) * tile_elems<D>(), k + base + next, stride, kTile);
      load_tile<D>(sV + ((kt + 1) & 1) * tile_elems<D>(), v + base + next, stride, kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a<LD>(qa, sQ, warp * 16, kk * 16, lane);
      load_a<LD>(da, sdO, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < kTile / 8; n += 2) {
        uint32_t bb[4];
        load_b_rows<LD>(bb, cK, n * 8, kk * 16, lane);
        mma(s[n], qa, bb[0], bb[1]);
        mma(s[n + 1], qa, bb[2], bb[3]);
        load_b_rows<LD>(bb, cV, n * 8, kk * 16, lane);
        mma(dp[n], da, bb[0], bb[1]);
        mma(dp[n + 1], da, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + n * 8 + t * 2 + j;
        const float pa = __expf(masked_logit(s[n][j], scale, row_a, key, causal, seg_row, seg_a) - lse_a);
        const float pb = __expf(masked_logit(s[n][2 + j], scale, row_b, key, causal, seg_row, seg_b) - lse_b);
        s[n][j] = pa * (dp[n][j] - dl_a) * scale;
        s[n][2 + j] = pb * (dp[n][2 + j] - dl_b) * scale;
      }
    }
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      const uint32_t dsa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                               pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                               pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                               pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int i = 0; i < D / 8; i += 2) {
        uint32_t bb[4];
        load_b_cols<LD>(bb, cK, i * 8, kc * 16, lane);
        mma(dq_acc[i], dsa, bb[0], bb[1]);
        mma(dq_acc[i + 1], dsa, bb[2], bb[3]);
      }
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }

  bf16* da_ = dq + base + row_a * stride + t * 2;
  bf16* db_ = dq + base + row_b * stride + t * 2;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    *reinterpret_cast<uint32_t*>(da_ + i * 8) = pack_bf16(dq_acc[i][0], dq_acc[i][1]);
    *reinterpret_cast<uint32_t*>(db_ + i * 8) = pack_bf16(dq_acc[i][2], dq_acc[i][3]);
  }
}

template <int D>
constexpr int fwd_smem_bytes() {
  return 4 * tile_elems<D>() * 2;
}

template <int D>
constexpr int dkdv_smem_bytes() {
  return (2 * kTile + 4 * kBwdQTile) * (D + 8) * 2;
}

template <int D>
constexpr int dq_smem_bytes() {
  return 6 * tile_elems<D>() * 2;
}

template <int D>
int fwd_launch(const bf16* q, const bf16* k, const bf16* v, const int* seg, bf16* o, float* lse,
               int B, int S, int H, int causal, float scale, cudaStream_t stream) {
  constexpr int kSmem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd<D><<<dim3(S / kTile, B * H), kThreads, kSmem, stream>>>(q, k, v, seg, o, lse, S, H,
                                                                    causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_launch(const bf16* q, const bf16* k, const bf16* v, const int* seg, const bf16* o,
               const bf16* dout, const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv,
               int B, int S, int H, int causal, float scale, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * S * H;
  flash_bwd_delta<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      o, dout, delta, S, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int kDkdvSmem = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDkdvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv<D><<<dim3(S / kTile, B * H), kThreads, kDkdvSmem, stream>>>(
      q, k, v, seg, dout, lse, delta, dk, dv, S, H, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int kDqSmem = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq<D><<<dim3(S / kTile, B * H), kThreads, kDqSmem, stream>>>(
      q, k, v, seg, dout, lse, delta, dq, S, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, o: (B, S, H, D) bf16, contiguous; seg: (B, S) int32 or null;
// lse: (B, H, S) f32. D is 64 or 128 and S a multiple of 64 (the wrapper checks).
int flash_attention_fwd_launch(const void* q, const void* k, const void* v, const void* seg,
                               void* o, void* lse, int B, int S, int H, int D, int causal,
                               float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const int* sp = static_cast<const int*>(seg);
  if (D == 128)
    return fwd_launch<128>(qp, kp, vp, sp, static_cast<bf16*>(o), static_cast<float*>(lse), B, S,
                           H, causal, scale, s);
  if (D == 64)
    return fwd_launch<64>(qp, kp, vp, sp, static_cast<bf16*>(o), static_cast<float*>(lse), B, S,
                          H, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// delta: (B, H, S) f32 scratch; dq, dk, dv: (B, S, H, D) bf16 outputs.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* seg,
                               const void* o, const void* dout, const void* lse, void* delta,
                               void* dq, void* dk, void* dv, int B, int S, int H, int D,
                               int causal, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const int* sp = static_cast<const int*>(seg);
  const bf16* op = static_cast<const bf16*>(o);
  const bf16* dp = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (D == 128)
    return bwd_launch<128>(qp, kp, vp, sp, op, dp, lp, dl, static_cast<bf16*>(dq),
                           static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, S, H, causal, scale,
                           s);
  if (D == 64)
    return bwd_launch<64>(qp, kp, vp, sp, op, dp, lp, dl, static_cast<bf16*>(dq),
                          static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, S, H, causal, scale,
                          s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
