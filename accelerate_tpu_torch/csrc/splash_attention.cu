// Causal splash attention (local window, tanh logit softcap, segment ids),
// forward and backward, for Hopper (sm_90a).
//
// Replaces the library splash kernel that the JAX package calls from
// accelerate_tpu/ops/attention.py:180 (make_splash_mha in jax/experimental/
// pallas/ops/tpu/splash_attention/splash_attention_kernel.py: forward
// flash_attention_kernel, dq _flash_attention_dq_kernel, dkv
// _flash_attention_dkv_kernel).
//
// What it computes, in the layout (B, S, H, D) with bf16 q, k, v, equal head
// counts (GQA heads are repeated by the caller) and q already scaled (the
// caller folds 1/sqrt(D) or Gemma-2's query_pre_attn_scalar into q, as the
// JAX wrapper does):
//   l = q . k^T in f32, no scale; c = tanh(l / cap) * cap with a softcap,
//   else c = l; where a key is masked, c is REPLACED by MASK, the library's
//   DEFAULT_MASK_VALUE (-0.7 * FLT_MAX). A query q sees key k iff
//   0 <= q - k (< window with a window) and, with segment ids, seg[q] ==
//   seg[k]. p = softmax(c) with an online running max and sum, and o = P.V.
//   The forward writes o (bf16) and the per-row log-sum-exp (f32, (B, H, S)).
//   The backward follows the library's split: delta = rowsum(dO * O); a
//   dK/dV kernel over KV tiles; a dQ kernel over query tiles. It recomputes
//   the uncapped logits, p = exp(c - lse) and dS = p (dP - delta) times the
//   softcap's factor 1 - tanh^2(l / cap), with the same tanhf the forward
//   used. No atomics: every output element has one writer, so the result is
//   deterministic.
//   One difference from the TPU kernel: P (and dS) are rounded to bf16 to
//   feed the tensor cores, where the TPU kernel keeps P in f32 for P.V; the
//   f32 plain version (ops/attention.splash_attention_reference) holds the
//   kernel to pinned tolerances on the card.
//
// Block sparsity, the point of splash: a query tile [q0, q1] visits only the
// KV tiles from max(0, q0 - window + 1) to its diagonal; in dK/dV a KV tile
// [k0, k1] visits only the query steps from its diagonal to
// min(S - 1, k1 + window - 1). The mask is evaluated only on tiles that the
// diagonal, the window's edge or segment ids cut. A row whose first visited
// tile is wholly masked for it (a row past the window's edge, inside a query
// tile whose earlier rows need that tile) starts its running max at MASK;
// the first visible key rescales everything before it by exp(MASK - m) = 0,
// so the row ends as the plain version's. Every row sees at least itself.
//
// Bound: operations. Forward 4 * D * H * (visible pairs); at Gemma-2-9B's
// global layer (B1, S8192, H16, D256) 549.8 GFLOP, 0.556 ms at 989 TFLOP/s,
// and its local layer (window 4096) 412.4 GFLOP, 0.417 ms. The backward does
// five products of the same size (S, dP, dV, dK, dQ), about 2.5 times the
// forward's operations; the dK/dV kernel recomputes S once more (below).
//
// Design: tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulate),
// operands from shared memory through ldmatrix (.trans for the operands
// stored k-major), rows padded by 8 elements so each ldmatrix phase hits 32
// distinct banks, and the tiles a loop walks double-buffered with cp.async.
// The S accumulator has the register layout of the A operand of P.V, so P
// never leaves registers. Head widths 64, 128 and 256 are template
// instances. D = 256 is what shapes the kernels: a warp's 16 x 256 f32
// accumulator is 128 registers a lane, so
//   - Q (and dO) fragments are read from shared memory at every k-step
//     instead of being held in registers;
//   - the forward and dQ kernels walk 32-key KV tiles at D = 256 (64 below),
//     which keeps the S and dP accumulators at 16 registers and the forward's
//     shared memory at 99 KB, two CTAs an SM;
//   - the dK/dV kernel runs 8 warps: warps 0-3 accumulate dV and warps 4-7
//     dK for the same 64 keys, 16 keys a warp, each group recomputing S; one
//     warp holding both accumulators would need 256 registers a lane.
// Dynamic shared memory above 48 KB is opted into with
// cudaFuncSetAttribute. wgmma and TMA wait for a later change. The mma,
// ldmatrix and cp.async helpers are those of attn_common.cuh, shared with
// flash_attention.cu.
//
// Interface: plain C functions bound with ctypes
// (accelerate_tpu_torch/ops/kernels/splash_attention.py). Each launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError().
// window 0 means no window, softcap 0 no softcap.

#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace {

using namespace attn;

constexpr int kThreads = 128;       // forward and dQ: 4 warps, 16 query rows each
constexpr int kDkdvThreads = 256;   // dK/dV: 8 warps, two groups of 4
constexpr int kQTile = 64;          // query rows of a forward or dQ CTA
constexpr int kKvTileBwd = 64;      // keys of a dK/dV CTA
constexpr int kBwdQStep = 32;       // query rows per step of the dK/dV kernel

// Keys of a KV tile in the forward and dQ kernels.
template <int D>
__host__ __device__ constexpr int kv_tile() {
  return D == 256 ? 32 : 64;
}

// Does a query see a key? d = query - key.
__device__ __forceinline__ bool visible(int d, int window, bool same_segment) {
  return d >= 0 && (window == 0 || d < window) && same_segment;
}

// Must the mask be evaluated on the block of queries [q0, q0 + q_rows) and
// keys [k0, k0 + k_rows)? Not where every key is at or below the diagonal and
// inside the window for every query, and there are no segment ids.
__device__ __forceinline__ bool block_needs_mask(int q0, int q_rows, int k0, int k_rows,
                                                 int window, bool segments) {
  const bool below_diagonal = k0 + k_rows - 1 <= q0;
  const bool inside_window = window == 0 || (q0 + q_rows - 1) - k0 < window;
  return segments || !(below_diagonal && inside_window);
}

// The softcap of an uncapped logit l; `th` receives tanh(l / cap) (0 without
// a softcap), which the backward's factor 1 - th^2 reuses.
__device__ __forceinline__ float soft_cap(float l, float softcap, float& th) {
  if (softcap > 0.f) {
    th = tanhf(l / softcap);
    return th * softcap;
  }
  th = 0.f;
  return l;
}

// First and last KV tile (of `tile` keys) that queries [q0, q0 + q_rows) can see.
__device__ __forceinline__ int first_kv_tile(int q0, int window, int tile) {
  return window > 0 ? max(0, q0 - window + 1) / tile : 0;
}

// ------------------------------------------------------------------ forward
// Grid (query tiles, B*H). Shared memory: the Q tile, and two stages of the
// K and V tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
    splash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const int* __restrict__ seg, bf16* __restrict__ o, float* __restrict__ lse, int S,
               int H, int window, float softcap) {
  constexpr int LD = D + 8;
  constexpr int BK = kv_tile<D>();
  constexpr int kKvElems = BK * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [kQTile * LD]
  bf16* sK = sQ + kQTile * LD;               // [2][kKvElems]
  bf16* sV = sK + 2 * kKvElems;              // [2][kKvElems]
  const int qt = S / kQTile - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long stride = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * S * stride + static_cast<long long>(h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kQTile;
  const int* seg_row = seg == nullptr ? nullptr : seg + static_cast<long long>(b) * S;

  const int kt_lo = first_kv_tile(q0, window, BK), kt_hi = (q0 + kQTile - 1) / BK;
  load_tile<D, kThreads>(sQ, q + base + q0 * stride, stride, kQTile);
  load_tile<D, kThreads>(sK, k + base + kt_lo * BK * stride, stride, BK);
  load_tile<D, kThreads>(sV, v + base + kt_lo * BK * stride, stride, BK);
  cp_async_commit();

  const int wq0 = q0 + warp * 16;  // this warp's first query row
  const int row_a = wq0 + g, row_b = row_a + 8;
  const int seg_a = seg_row == nullptr ? 0 : seg_row[row_a];
  const int seg_b = seg_row == nullptr ? 0 : seg_row[row_b];
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK, stage = (kt - kt_lo) & 1;
    const bf16* cK = sK + stage * kKvElems;
    const bf16* cV = sV + stage * kKvElems;
    if (kt < kt_hi) {  // prefetch the next tile into the other stage
      const long long next = static_cast<long long>(k0 + BK) * stride;
      load_tile<D, kThreads>(sK + (stage ^ 1) * kKvElems, k + base + next, stride, BK);
      load_tile<D, kThreads>(sV + (stage ^ 1) * kKvElems, v + base + next, stride, BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      load_a<LD>(qa, sQ, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < BK / 8; n += 2) {
        uint32_t bb[4];
        load_b_rows<LD>(bb, cK, n * 8, kk * 16, lane);
        mma(s[n], qa, bb[0], bb[1]);
        mma(s[n + 1], qa, bb[2], bb[3]);
      }
    }
    const bool masked = block_needs_mask(wq0, 16, k0, BK, window, seg_row != nullptr);
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + n * 8 + t * 2 + j;
        float th;
        float ca = soft_cap(s[n][j], softcap, th);
        float cb = soft_cap(s[n][2 + j], softcap, th);
        if (masked) {
          const int seg_k = seg_row == nullptr ? 0 : seg_row[key];
          if (!visible(row_a - key, window, seg_k == seg_a)) ca = kMaskValue;
          if (!visible(row_b - key, window, seg_k == seg_b)) cb = kMaskValue;
        }
        s[n][j] = ca;
        s[n][2 + j] = cb;
        mx_a = fmaxf(mx_a, ca);
        mx_b = fmaxf(mx_b, cb);
      }
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    // exp(MASK - m) is 0 once a row has seen a visible key, and 1 while its
    // running max is still MASK: the first visible key rescales the rest away.
    const float alpha_a = __expf(m_a - mx_a), alpha_b = __expf(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
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
    for (int kc = 0; kc < BK / 16; ++kc) {
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
    splash_bwd_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout,
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
// Grid (KV tiles of 64 keys, B*H), 8 warps. Warp w owns keys 16 (w % 4).. of
// the tile; warps 0-3 accumulate dV, warps 4-7 dK. Both walk the query steps
// that can see the tile, 32 queries at a time:
//   P^T = exp(cap(K Q^T) - lse), dV += P^T dO           (warps 0-3)
//   dP^T = V dO^T, dS^T = P^T (dP^T - delta) (1 - tanh^2), dK += dS^T Q
//                                                        (warps 4-7)
// Shared memory: the K and V tiles, and two stages of the Q and dO steps.
template <int D>
__global__ void __launch_bounds__(kDkdvThreads)
    splash_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ seg,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int S, int H, int window, float softcap) {
  constexpr int LD = D + 8;
  constexpr int kQElems = kBwdQStep * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);  // [kKvTileBwd * LD]
  bf16* sV = sK + kKvTileBwd * LD;           // [kKvTileBwd * LD]
  bf16* sQ = sV + kKvTileBwd * LD;           // [2][kQElems]
  bf16* sdO = sQ + 2 * kQElems;              // [2][kQElems]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long stride = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * S * stride + static_cast<long long>(h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool dk_group = warp >= 4;
  const int wk = (warp & 3) * 16;  // this warp's first key within the tile
  const int k0 = blockIdx.x * kKvTileBwd;
  const int* seg_row = seg == nullptr ? nullptr : seg + static_cast<long long>(b) * S;
  const float* lse_row = lse + static_cast<long long>(bh) * S;
  const float* delta_row = delta + static_cast<long long>(bh) * S;

  // Queries that can see the tile: from its diagonal to the last one whose
  // window still reaches its last key.
  const int q_first = k0;
  const int q_end = window > 0 ? min(S, k0 + kKvTileBwd - 1 + window) : S;
  load_tile<D, kDkdvThreads>(sK, k + base + k0 * stride, stride, kKvTileBwd);
  load_tile<D, kDkdvThreads>(sV, v + base + k0 * stride, stride, kKvTileBwd);
  load_tile<D, kDkdvThreads>(sQ, q + base + q_first * stride, stride, kBwdQStep);
  load_tile<D, kDkdvThreads>(sdO, dout + base + q_first * stride, stride, kBwdQStep);
  cp_async_commit();

  const int key_a = k0 + wk + g, key_b = key_a + 8;
  const int seg_ka = seg_row == nullptr ? 0 : seg_row[key_a];
  const int seg_kb = seg_row == nullptr ? 0 : seg_row[key_b];
  float acc[D / 8][4];  // dK or dV of this warp's 16 keys
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int q0 = q_first, step = 0; q0 < q_end; q0 += kBwdQStep, ++step) {
    const bf16* cQ = sQ + (step & 1) * kQElems;
    const bf16* cdO = sdO + (step & 1) * kQElems;
    if (q0 + kBwdQStep < q_end) {  // prefetch the next query step into the other stage
      const long long next = static_cast<long long>(q0 + kBwdQStep) * stride;
      load_tile<D, kDkdvThreads>(sQ + ((step + 1) & 1) * kQElems, q + base + next, stride,
                                 kBwdQStep);
      load_tile<D, kDkdvThreads>(sdO + ((step + 1) & 1) * kQElems, dout + base + next, stride,
                                 kBwdQStep);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S^T = K_w Q^T: 16 keys x 32 queries, uncapped.
    float st[kBwdQStep / 8][4], dpt[kBwdQStep / 8][4];
#pragma unroll
    for (int n = 0; n < kBwdQStep / 8; ++n) {
      st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
      dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4];
      load_a<LD>(ka, sK, wk, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < kBwdQStep / 8; n += 2) {
        uint32_t bb[4];
        load_b_rows<LD>(bb, cQ, n * 8, kk * 16, lane);
        mma(st[n], ka, bb[0], bb[1]);
        mma(st[n + 1], ka, bb[2], bb[3]);
      }
    }
    if (dk_group) {  // dP^T = V_w dO^T: 16 keys x 32 queries.
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t va[4];
        load_a<LD>(va, sV, wk, kk * 16, lane);
#pragma unroll
        for (int n = 0; n < kBwdQStep / 8; n += 2) {
          uint32_t bb[4];
          load_b_rows<LD>(bb, cdO, n * 8, kk * 16, lane);
          mma(dpt[n], va, bb[0], bb[1]);
          mma(dpt[n + 1], va, bb[2], bb[3]);
        }
      }
    }
    // P^T, or dS^T = P^T (dP^T - delta[query]) (1 - tanh^2).
    const bool masked = block_needs_mask(q0, kBwdQStep, k0 + wk, 16, window, seg_row != nullptr);
#pragma unroll
    for (int n = 0; n < kBwdQStep / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int query = q0 + n * 8 + t * 2 + j;
        const float ls = lse_row[query];
        float th_a, th_b;
        const float ca = soft_cap(st[n][j], softcap, th_a);
        const float cb = soft_cap(st[n][2 + j], softcap, th_b);
        bool keep_a = true, keep_b = true;
        if (masked) {
          const int seg_q = seg_row == nullptr ? 0 : seg_row[query];
          keep_a = visible(query - key_a, window, seg_ka == seg_q);
          keep_b = visible(query - key_b, window, seg_kb == seg_q);
        }
        float pa = keep_a ? __expf(ca - ls) : 0.f;
        float pb = keep_b ? __expf(cb - ls) : 0.f;
        if (dk_group) {
          const float dl = delta_row[query];
          pa *= dpt[n][j] - dl;
          pb *= dpt[n][2 + j] - dl;
          if (softcap > 0.f) {
            pa *= 1.f - th_a * th_a;
            pb *= 1.f - th_b * th_b;
          }
        }
        st[n][j] = pa;
        st[n][2 + j] = pb;
      }
    }
    // dV += P^T dO, or dK += dS^T Q: 16 keys x D over 32 queries.
    const bf16* rhs = dk_group ? cQ : cdO;
#pragma unroll
    for (int kc = 0; kc < kBwdQStep / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kc][0], st[2 * kc][1]),
                              pack_bf16(st[2 * kc][2], st[2 * kc][3]),
                              pack_bf16(st[2 * kc + 1][0], st[2 * kc + 1][1]),
                              pack_bf16(st[2 * kc + 1][2], st[2 * kc + 1][3])};
#pragma unroll
      for (int i = 0; i < D / 8; i += 2) {
        uint32_t bb[4];
        load_b_cols<LD>(bb, rhs, i * 8, kc * 16, lane);
        mma(acc[i], pa, bb[0], bb[1]);
        mma(acc[i + 1], pa, bb[2], bb[3]);
      }
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }

  bf16* out = dk_group ? dk : dv;
  bf16* pa_ = out + base + key_a * stride + t * 2;
  bf16* pb_ = out + base + key_b * stride + t * 2;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    *reinterpret_cast<uint32_t*>(pa_ + i * 8) = pack_bf16(acc[i][0], acc[i][1]);
    *reinterpret_cast<uint32_t*>(pb_ + i * 8) = pack_bf16(acc[i][2], acc[i][3]);
  }
}

// ------------------------------------------------------------ backward: dQ
// Grid (query tiles, B*H). Each warp owns 16 queries and walks the KV tiles
// they can see: P = exp(cap(Q K^T) - lse), dP = dO V^T,
// dS = P (dP - delta) (1 - tanh^2), dQ += dS K. Shared memory: the Q and dO
// tiles, and two stages of the K and V tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
    splash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ seg,
                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq, int S, int H,
                  int window, float softcap) {
  constexpr int LD = D + 8;
  constexpr int BK = kv_tile<D>();
  constexpr int kKvElems = BK * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [kQTile * LD]
  bf16* sdO = sQ + kQTile * LD;              // [kQTile * LD]
  bf16* sK = sdO + kQTile * LD;              // [2][kKvElems]
  bf16* sV = sK + 2 * kKvElems;              // [2][kKvElems]

  const int qt = S / kQTile - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long stride = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * S * stride + static_cast<long long>(h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kQTile;
  const int* seg_row = seg == nullptr ? nullptr : seg + static_cast<long long>(b) * S;

  const int kt_lo = first_kv_tile(q0, window, BK), kt_hi = (q0 + kQTile - 1) / BK;
  load_tile<D, kThreads>(sQ, q + base + q0 * stride, stride, kQTile);
  load_tile<D, kThreads>(sdO, dout + base + q0 * stride, stride, kQTile);
  load_tile<D, kThreads>(sK, k + base + kt_lo * BK * stride, stride, BK);
  load_tile<D, kThreads>(sV, v + base + kt_lo * BK * stride, stride, BK);
  cp_async_commit();
  const int wq0 = q0 + warp * 16;
  const int row_a = wq0 + g, row_b = row_a + 8;
  const int seg_a = seg_row == nullptr ? 0 : seg_row[row_a];
  const int seg_b = seg_row == nullptr ? 0 : seg_row[row_b];
  const float lse_a = lse[static_cast<long long>(bh) * S + row_a];
  const float lse_b = lse[static_cast<long long>(bh) * S + row_b];
  const float dl_a = delta[static_cast<long long>(bh) * S + row_a];
  const float dl_b = delta[static_cast<long long>(bh) * S + row_b];
  float dq_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq_acc[i][0] = dq_acc[i][1] = dq_acc[i][2] = dq_acc[i][3] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK, stage = (kt - kt_lo) & 1;
    const bf16* cK = sK + stage * kKvElems;
    const bf16* cV = sV + stage * kKvElems;
    if (kt < kt_hi) {  // prefetch the next tile into the other stage
      const long long next = static_cast<long long>(k0 + BK) * stride;
      load_tile<D, kThreads>(sK + (stage ^ 1) * kKvElems, k + base + next, stride, BK);
      load_tile<D, kThreads>(sV + (stage ^ 1) * kKvElems, v + base + next, stride, BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a<LD>(qa, sQ, warp * 16, kk * 16, lane);
      load_a<LD>(da, sdO, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < BK / 8; n += 2) {
        uint32_t bb[4];
        load_b_rows<LD>(bb, cK, n * 8, kk * 16, lane);
        mma(s[n], qa, bb[0], bb[1]);
        mma(s[n + 1], qa, bb[2], bb[3]);
        load_b_rows<LD>(bb, cV, n * 8, kk * 16, lane);
        mma(dp[n], da, bb[0], bb[1]);
        mma(dp[n + 1], da, bb[2], bb[3]);
      }
    }
    const bool masked = block_needs_mask(wq0, 16, k0, BK, window, seg_row != nullptr);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + n * 8 + t * 2 + j;
        float th_a, th_b;
        const float ca = soft_cap(s[n][j], softcap, th_a);
        const float cb = soft_cap(s[n][2 + j], softcap, th_b);
        bool keep_a = true, keep_b = true;
        if (masked) {
          const int seg_k = seg_row == nullptr ? 0 : seg_row[key];
          keep_a = visible(row_a - key, window, seg_k == seg_a);
          keep_b = visible(row_b - key, window, seg_k == seg_b);
        }
        float da = keep_a ? __expf(ca - lse_a) * (dp[n][j] - dl_a) : 0.f;
        float db = keep_b ? __expf(cb - lse_b) * (dp[n][2 + j] - dl_b) : 0.f;
        if (softcap > 0.f) {
          da *= 1.f - th_a * th_a;
          db *= 1.f - th_b * th_b;
        }
        s[n][j] = da;
        s[n][2 + j] = db;
      }
    }
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
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
  return (kQTile + 4 * kv_tile<D>()) * (D + 8) * 2;
}

template <int D>
constexpr int dkdv_smem_bytes() {
  return (2 * kKvTileBwd + 4 * kBwdQStep) * (D + 8) * 2;
}

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * kQTile + 4 * kv_tile<D>()) * (D + 8) * 2;
}

template <int D>
int fwd_launch(const bf16* q, const bf16* k, const bf16* v, const int* seg, bf16* o, float* lse,
               int B, int S, int H, int window, float softcap, cudaStream_t stream) {
  constexpr int kSmem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(splash_fwd<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  splash_fwd<D><<<dim3(S / kQTile, B * H), kThreads, kSmem, stream>>>(q, k, v, seg, o, lse, S, H,
                                                                      window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_launch(const bf16* q, const bf16* k, const bf16* v, const int* seg, const bf16* o,
               const bf16* dout, const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv,
               int B, int S, int H, int window, float softcap, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * S * H;
  splash_bwd_delta<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      o, dout, delta, S, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int kDkdvSmem = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(splash_bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDkdvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  splash_bwd_dkdv<D><<<dim3(S / kKvTileBwd, B * H), kDkdvThreads, kDkdvSmem, stream>>>(
      q, k, v, seg, dout, lse, delta, dk, dv, S, H, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int kDqSmem = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(splash_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  splash_bwd_dq<D><<<dim3(S / kQTile, B * H), kThreads, kDqSmem, stream>>>(
      q, k, v, seg, dout, lse, delta, dq, S, H, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (pre-scaled), k, v, o: (B, S, H, D) bf16, contiguous; seg: (B, S) int32 or
// null; lse: (B, H, S) f32. D is 64, 128 or 256 and S a multiple of 64 (the
// wrapper checks); window 0 = none, softcap 0 = none.
int splash_attention_fwd_launch(const void* q, const void* k, const void* v, const void* seg,
                                void* o, void* lse, int B, int S, int H, int D, int window,
                                float softcap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const int* sp = static_cast<const int*>(seg);
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(lse);
  if (D == 256) return fwd_launch<256>(qp, kp, vp, sp, op, lp, B, S, H, window, softcap, s);
  if (D == 128) return fwd_launch<128>(qp, kp, vp, sp, op, lp, B, S, H, window, softcap, s);
  if (D == 64) return fwd_launch<64>(qp, kp, vp, sp, op, lp, B, S, H, window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// delta: (B, H, S) f32 scratch; dq, dk, dv: (B, S, H, D) bf16 outputs.
int splash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* seg,
                                const void* o, const void* dout, const void* lse, void* delta,
                                void* dq, void* dk, void* dv, int B, int S, int H, int D,
                                int window, float softcap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const int* sp = static_cast<const int*>(seg);
  const bf16* op = static_cast<const bf16*>(o);
  const bf16* dp = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  bf16* dqp = static_cast<bf16*>(dq);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  if (D == 256)
    return bwd_launch<256>(qp, kp, vp, sp, op, dp, lp, dl, dqp, dkp, dvp, B, S, H, window,
                           softcap, s);
  if (D == 128)
    return bwd_launch<128>(qp, kp, vp, sp, op, dp, lp, dl, dqp, dkp, dvp, B, S, H, window,
                           softcap, s);
  if (D == 64)
    return bwd_launch<64>(qp, kp, vp, sp, op, dp, lp, dl, dqp, dkp, dvp, B, S, H, window,
                          softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* splash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
