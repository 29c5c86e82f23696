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
// wgmma and TMA wait for a later change. The mma, ldmatrix and cp.async
// helpers are those of attn_common.cuh, shared with splash_attention.cu.
//
// Ring-attention blocks (ring_block_fwd_launch / ring_block_bwd_launch).
// They replace the library flash calls of the JAX package's ring,
// accelerate_tpu/parallel/ring.py: _flash_block_fwd (:93, library
// _flash_attention with save_residuals at :112) and _flash_block_bwd (:209,
// _flash_attention_bwd_dq / _bwd_dkv at :228 / :234). One visiting KV block
// of a rank's sequence shard runs the same mainloops as above, with:
//   - separate q and kv segment ids: the ring passes q all "real" (2) and
//     the travelling KV block's padding as kv segments (1 = pad), so pads
//     are masked for every query;
//   - causal = 1 for the diagonal block (mode 0 of the ring) and 0 for a
//     fully visible one (mode 1); a skipped block (mode 2) launches nothing;
//   - the forward writes the block-normalised o (bf16) and the row stats
//     l and m (f32) instead of the log-sum-exp. A row that sees no key of
//     the block ends with its running max at MASK level; it writes o = 0,
//     l = 0 and m = -1e30, never NaN;
//   - the backward reads the GLOBAL log-sum-exp of the rank's rows (+inf
//     mapped to 1e30 by the caller, so P = 0 there) and a delta computed
//     once per rank by the caller, launches no delta kernel, and ADDS dq,
//     dk and dv into the ring's f32 accumulators in its epilogue (one
//     writer per element, so no atomics).
// Bound: operations; a full 8192-key block at 32 heads of 128 is 1.10 TFLOP
// forward, 1.112 ms at 989 TFLOP/s, and about 2.5 times that backward.
//
// Interface: plain C functions bound with ctypes
// (accelerate_tpu_torch/ops/kernels/flash_attention.py and ring_block.py).
// Each launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;      // rows of a query tile (forward, dQ) and of a KV tile
constexpr int kBwdQTile = 32;  // query rows per step of the dK/dV kernel
constexpr float kNoKeyMax = -1e30f;  // the ring's running max of a row with no visible key

// Scaled, masked logit: the library's s * sm_scale + where(keep, 0, MASK).
// seg_kv_row: the kv segment ids of the batch row (null: no segments);
// seg_q: the query's segment id.
__device__ __forceinline__ float masked_logit(float dot, float scale, int query, int key,
                                              int causal, const int* seg_kv_row, int seg_q) {
  float s = dot * scale;
  const bool keep =
      (!causal || key <= query) && (seg_kv_row == nullptr || seg_kv_row[key] == seg_q);
  return keep ? s : s + kMaskValue;
}

// Two adjacent output elements: bf16 outputs are stored, f32 outputs (the
// ring's gradient accumulators) are added to.
__device__ __forceinline__ void emit2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ void emit2(float* p, float a, float b) {
  float2 acc = *reinterpret_cast<float2*>(p);
  acc.x += a;
  acc.y += b;
  *reinterpret_cast<float2*>(p) = acc;
}

template <int D>
__host__ __device__ constexpr int tile_elems() {
  return kTile * (D + 8);
}

// ------------------------------------------------------------------ forward
// Shared memory: K and V tiles, two stages each. Writes the log-sum-exp to
// `lse` (flash), or, with lse null, the row stats to `l_out` and `m_out` (a
// ring block; see the header).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
              bf16* __restrict__ o, float* __restrict__ lse, float* __restrict__ l_out,
              float* __restrict__ m_out, int S, int H, int causal, float scale) {
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
  const int* seg_row = seg_kv == nullptr ? nullptr : seg_kv + static_cast<long long>(b) * S;
  const int* seg_q_row = seg_q == nullptr ? nullptr : seg_q + static_cast<long long>(b) * S;

  // Stage the Q tile through sK; each warp keeps its 16 rows as A fragments.
  load_tile<D, kThreads>(sK, q + base + q0 * stride, stride, kTile);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a<LD>(qa[kk], sK, warp * 16, kk * 16, lane);
  __syncthreads();

  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const int seg_a = seg_q_row == nullptr ? 0 : seg_q_row[row_a];
  const int seg_b = seg_q_row == nullptr ? 0 : seg_q_row[row_b];
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int n_kv = causal ? qt + 1 : n_tiles;
  load_tile<D, kThreads>(sK, k + base, stride, kTile);
  load_tile<D, kThreads>(sV, v + base, stride, kTile);
  cp_async_commit();
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kTile;
    const bf16* cK = sK + (kt & 1) * tile_elems<D>();
    const bf16* cV = sV + (kt & 1) * tile_elems<D>();
    if (kt + 1 < n_kv) {  // prefetch the next tile into the other stage
      const long long next = static_cast<long long>(k0 + kTile) * stride;
      load_tile<D, kThreads>(sK + ((kt + 1) & 1) * tile_elems<D>(), k + base + next, stride, kTile);
      load_tile<D, kThreads>(sV + ((kt + 1) & 1) * tile_elems<D>(), v + base + next, stride, kTile);
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
  // A ring block's row that saw no key: every logit carried MASK, so its
  // running max sits near MASK, far below any unmasked logit.
  const bool ring = lse == nullptr;
  const bool none_a = ring && m_a < 0.5f * kMaskValue;
  const bool none_b = ring && m_b < 0.5f * kMaskValue;
  const float inv_a = none_a ? 0.f : 1.f / l_a, inv_b = none_b ? 0.f : 1.f / l_b;
  bf16* oa = o + base + row_a * stride + t * 2;
  bf16* ob = o + base + row_b * stride + t * 2;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    emit2(oa + i * 8, acc[i][0] * inv_a, acc[i][1] * inv_a);
    emit2(ob + i * 8, acc[i][2] * inv_b, acc[i][3] * inv_b);
  }
  if (t == 0) {
    const long long row0 = static_cast<long long>(bh) * S;
    if (!ring) {
      lse[row0 + row_a] = m_a + logf(l_a);
      lse[row0 + row_b] = m_b + logf(l_b);
    } else {
      l_out[row0 + row_a] = none_a ? 0.f : l_a;
      l_out[row0 + row_b] = none_b ? 0.f : l_b;
      m_out[row0 + row_a] = none_a ? kNoKeyMax : m_a;
      m_out[row0 + row_b] = none_b ? kNoKeyMax : m_b;
    }
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
// OutT: bf16 (flash: dk, dv stored) or float (a ring block: added to the
// ring's accumulators).
template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ seg_q,
                   const int* __restrict__ seg_kv, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   OutT* __restrict__ dk, OutT* __restrict__ dv, int S, int H, int causal,
                   float scale) {
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
  const int* seg_row = seg_kv == nullptr ? nullptr : seg_kv + static_cast<long long>(b) * S;
  const int* seg_q_row = seg_q == nullptr ? nullptr : seg_q + static_cast<long long>(b) * S;
  const float* lse_row = lse + static_cast<long long>(bh) * S;
  const float* delta_row = delta + static_cast<long long>(bh) * S;

  const int q_first = causal ? k0 : 0;
  load_tile<D, kThreads>(sK, k + base + k0 * stride, stride, kTile);
  load_tile<D, kThreads>(sV, v + base + k0 * stride, stride, kTile);
  load_tile<D, kThreads>(sQ, q + base + q_first * stride, stride, kBwdQTile);
  load_tile<D, kThreads>(sdO, dout + base + q_first * stride, stride, kBwdQTile);
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
      load_tile<D, kThreads>(sQ + ((step + 1) & 1) * kQElems, q + base + next, stride, kBwdQTile);
      load_tile<D, kThreads>(sdO + ((step + 1) & 1) * kQElems, dout + base + next, stride, kBwdQTile);
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
        const int seg_qv = seg_q_row == nullptr ? 0 : seg_q_row[query];
        const float ls = lse_row[query];
        const bool keep_a = (!causal || key_a <= query) && (seg_row == nullptr || seg_ka == seg_qv);
        const bool keep_b = (!causal || key_b <= query) && (seg_row == nullptr || seg_kb == seg_qv);
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

  OutT* dka = dk + base + key_a * stride + t * 2;
  OutT* dkb = dk + base + key_b * stride + t * 2;
  OutT* dva = dv + base + key_a * stride + t * 2;
  OutT* dvb = dv + base + key_b * stride + t * 2;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    emit2(dka + i * 8, dk_acc[i][0], dk_acc[i][1]);
    emit2(dkb + i * 8, dk_acc[i][2], dk_acc[i][3]);
    emit2(dva + i * 8, dv_acc[i][0], dv_acc[i][1]);
    emit2(dvb + i * 8, dv_acc[i][2], dv_acc[i][3]);
  }
}

// ------------------------------------------------------------ backward: dQ
// Grid (query tiles, B*H). Each warp owns 16 queries and walks the KV tiles
// they can see: P = exp(S - lse), dP = dO V^T, dS = P (dP - delta) * scale,
// dQ += dS K. Shared memory: the Q and dO tiles, and two stages of the K and
// V tiles. OutT as in flash_bwd_dkdv.
template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_kv, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 OutT* __restrict__ dq, int S, int H, int causal, float scale) {
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
  const int* seg_row = seg_kv == nullptr ? nullptr : seg_kv + static_cast<long long>(b) * S;
  const int* seg_q_row = seg_q == nullptr ? nullptr : seg_q + static_cast<long long>(b) * S;

  load_tile<D, kThreads>(sQ, q + base + q0 * stride, stride, kTile);
  load_tile<D, kThreads>(sdO, dout + base + q0 * stride, stride, kTile);
  load_tile<D, kThreads>(sK, k + base, stride, kTile);
  load_tile<D, kThreads>(sV, v + base, stride, kTile);
  cp_async_commit();
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const int seg_a = seg_q_row == nullptr ? 0 : seg_q_row[row_a];
  const int seg_b = seg_q_row == nullptr ? 0 : seg_q_row[row_b];
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
      load_tile<D, kThreads>(sK + ((kt + 1) & 1) * tile_elems<D>(), k + base + next, stride, kTile);
      load_tile<D, kThreads>(sV + ((kt + 1) & 1) * tile_elems<D>(), v + base + next, stride, kTile);
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

  OutT* da_ = dq + base + row_a * stride + t * 2;
  OutT* db_ = dq + base + row_b * stride + t * 2;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    emit2(da_ + i * 8, dq_acc[i][0], dq_acc[i][1]);
    emit2(db_ + i * 8, dq_acc[i][2], dq_acc[i][3]);
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
int fwd_launch(const bf16* q, const bf16* k, const bf16* v, const int* seg_q, const int* seg_kv,
               bf16* o, float* lse, float* l_out, float* m_out, int B, int S, int H, int causal,
               float scale, cudaStream_t stream) {
  constexpr int kSmem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd<D><<<dim3(S / kTile, B * H), kThreads, kSmem, stream>>>(
      q, k, v, seg_q, seg_kv, o, lse, l_out, m_out, S, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The dK/dV and dQ kernels; delta must be ready on the stream.
template <int D, typename OutT>
int bwd_main_launch(const bf16* q, const bf16* k, const bf16* v, const int* seg_q,
                    const int* seg_kv, const bf16* dout, const float* lse, const float* delta,
                    OutT* dq, OutT* dk, OutT* dv, int B, int S, int H, int causal, float scale,
                    cudaStream_t stream) {
  constexpr int kDkdvSmem = dkdv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<D, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv<D, OutT><<<dim3(S / kTile, B * H), kThreads, kDkdvSmem, stream>>>(
      q, k, v, seg_q, seg_kv, dout, lse, delta, dk, dv, S, H, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int kDqSmem = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dq<D, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq<D, OutT><<<dim3(S / kTile, B * H), kThreads, kDqSmem, stream>>>(
      q, k, v, seg_q, seg_kv, dout, lse, delta, dq, S, H, causal, scale);
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
  return bwd_main_launch<D, bf16>(q, k, v, seg, seg, dout, lse, delta, dq, dk, dv, B, S, H,
                                  causal, scale, stream);
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
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(lse);
  if (D == 128)
    return fwd_launch<128>(qp, kp, vp, sp, sp, op, lp, nullptr, nullptr, B, S, H, causal, scale,
                           s);
  if (D == 64)
    return fwd_launch<64>(qp, kp, vp, sp, sp, op, lp, nullptr, nullptr, B, S, H, causal, scale,
                          s);
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

// One ring block, forward. q, k, v, o: (B, S, H, D) bf16, contiguous, S the
// rank's shard; seg_q, seg_kv: (B, S) int32, both or neither; l, m: (B, H, S)
// f32 outputs. causal: 1 for the diagonal block, 0 for a fully visible one.
int ring_block_fwd_launch(const void* q, const void* k, const void* v, const void* seg_q,
                          const void* seg_kv, void* o, void* l, void* m, int B, int S, int H,
                          int D, int causal, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const int* sq = static_cast<const int*>(seg_q);
  const int* skv = static_cast<const int*>(seg_kv);
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(l);
  float* mp = static_cast<float*>(m);
  if (D == 128)
    return fwd_launch<128>(qp, kp, vp, sq, skv, op, nullptr, lp, mp, B, S, H, causal, scale, s);
  if (D == 64)
    return fwd_launch<64>(qp, kp, vp, sq, skv, op, nullptr, lp, mp, B, S, H, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// One ring block, backward. lse: (B, H, S) f32, the rank's GLOBAL
// log-sum-exp with +inf mapped to 1e30; delta: (B, H, S) f32, rowsum(dO * O)
// of the rank's rows; dq, dk, dv: (B, S, H, D) f32 accumulators, added to.
int ring_block_bwd_launch(const void* q, const void* k, const void* v, const void* seg_q,
                          const void* seg_kv, const void* dout, const void* lse,
                          const void* delta, void* dq, void* dk, void* dv, int B, int S, int H,
                          int D, int causal, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const int* sq = static_cast<const int*>(seg_q);
  const int* skv = static_cast<const int*>(seg_kv);
  const bf16* dp = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* dqp = static_cast<float*>(dq);
  float* dkp = static_cast<float*>(dk);
  float* dvp = static_cast<float*>(dv);
  if (D == 128)
    return bwd_main_launch<128, float>(qp, kp, vp, sq, skv, dp, lp, dl, dqp, dkp, dvp, B, S, H,
                                       causal, scale, s);
  if (D == 64)
    return bwd_main_launch<64, float>(qp, kp, vp, sq, skv, dp, lp, dl, dqp, dkp, dvp, B, S, H,
                                      causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
