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
// Design (the Hopper helpers are those of hopper_common.cuh). Each CTA has
// three warpgroups: warpgroup 0 is the producer, whose first thread issues
// every load by TMA into 128-byte-swizzled shared memory and signals it on
// mbarriers, then gives its registers up (setmaxnreg 24); warpgroups 1 and 2
// are consumers (setmaxnreg 240). All products are wgmma m64nNk16 with f32
// accumulators: scores and dP from shared memory on both sides (SS), with no
// ldmatrix; the products whose A is a probability or a dS take it from
// registers (RS), where the score accumulator already has the A fragment's
// layout, and read their B operand (V, dO, Q or K) MN-major from the same
// swizzled tile through the descriptor. Streamed tiles go through a ring of
// stages with full and empty mbarriers, so the next tile's copy runs under
// the current tile's math, and the two consumer warpgroups overlap each
// other's softmax with their products. Causal tiles above the diagonal are
// skipped, only tiles on the diagonal, at the ragged end or under segment
// ids evaluate the mask, and the forward and dQ walk query tiles heaviest
// first.
//   - forward: 128 query rows a CTA (Q loaded once), 64 a consumer, K/V
//     tiles of 128 keys in three stages. S = Q.K^T (SS), online softmax in
//     registers (exp2 of logits in log2 units), O += P.V (RS, V MN-major).
//     Issuing the next tile's S before this tile's softmax (two score
//     buffers) spilled: the consumers' code stays within 168 registers.
//   - dK/dV: 64 keys a CTA (K, V loaded once), Q/dO tiles of 64 rows in
//     three stages with their log-sum-exp and delta rows (and query segment
//     ids) brought in by bulk copies beside them. The consumers split the
//     work by output: one computes S^T = K.Q^T (SS), P^T, and dV += P^T.dO
//     (RS, dO MN-major); the other computes dP^T = V.dO^T (SS), reads P^T
//     (f32) from the first through shared memory under named barriers, and
//     accumulates dK += dS^T.Q (RS, Q MN-major). Each holds one 64 x D
//     accumulator: with both accumulators in one warpgroup, D = 128 spills.
//   - dQ: 128 query rows a CTA (Q, dO loaded once), 64 a consumer, K/V
//     tiles of 64 keys in two stages. S = Q.K^T and dP = dO.V^T (SS),
//     dQ += dS.K (RS, K MN-major).
// S only needs to be a multiple of 64: the 128-row tiles' second half past
// S reads zeros from TMA, keys past S get -inf logits, and no row past S is
// written. The ping-pong schedule of the two consumers (named barriers
// ordering one's softmax against the other's products) is not in.
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
// Each builds its TMA tensor maps on the host, launches on the caller's
// stream, allocates nothing, and returns a cudaError_t code.

#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace attn;
using namespace hopper;

constexpr int kThreads = 384;        // producer warpgroup + two consumer warpgroups
constexpr int kConsumers = 256;      // arrivals that release a stage
constexpr int kRows = 128;           // query rows of a forward or dQ CTA
constexpr int kStream = 64;          // keys of a dK/dV CTA; rows of a streamed backward tile
constexpr int kStages = 2;           // depth of the dQ kernel's ring of K/V tiles
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kNoKeyMax = -1e30f;  // the ring's running max of a row with no visible key

// ------------------------------------------------------------------ forward
constexpr int kFwdStages = 3;  // depth of the forward's ring of K/V tiles

// S = Q_w . K^T (64 rows x 128 keys), issued and committed.
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[kRows / 2], uint32_t q_base,
                                             uint32_t k_base) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<kRows>::ss(s, kstep(q_base, kRows, kk), kstep(k_base, kRows, kk), kk > 0);
  wgmma_commit();
}

template <int D>
struct FwdSmem {
  static constexpr int kTile = tile_bytes<D>(kRows);
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;                  // [kFwdStages]
  static constexpr int kV = kK + kFwdStages * kTile;      // [kFwdStages]
  static constexpr int kSeg = kV + kFwdStages * kTile;    // int [kFwdStages][kRows]
  static constexpr int kBar = kSeg + kFwdStages * kRows * 4;
  static constexpr int kBars = 1 + 3 * kFwdStages;        // q, full_k, full_v, empty
  static constexpr int kBytes = kBar + 8 * kBars + 1024;  // + alignment slack
};

// Grid (ceil(S / 128), B*H). Writes the log-sum-exp to `lse` (flash), or,
// with lse null, the row stats to `l_out` and `m_out` (a ring block).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ seg_q,
              const int* __restrict__ seg_kv, bf16* __restrict__ o, float* __restrict__ lse,
              float* __restrict__ l_out, float* __restrict__ m_out, int S, int H, int causal,
              float scale) {
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + kFwdStages;
  uint64_t* empty = full_v + kFwdStages;
  const int* sseg = reinterpret_cast<const int*>(smem + L::kSeg);

  const int n_qt = (S + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kRows;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kv_end = causal ? min(S, q0 + kRows) : S;
  const int n_kv = (kv_end + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The warpgroup index, read from lane 0 so the compiler knows it is
  // uniform: the role branch is then uniform, and the consumers' code gets
  // the registers setmaxnreg gives them.
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 0) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar_q, L::kTile);
      tma_tile<D>(smem + L::kQ, &tm_q, bar_q, kRows, h, q0, b);
      for (int kt = 0; kt < n_kv; ++kt) {
        const int st = kt % kFwdStages, k0 = kt * kRows;
        if (kt >= kFwdStages) mbar_wait(&empty[st], ((kt / kFwdStages) - 1) & 1);
        const int seg_bytes = seg_kv == nullptr ? 0 : min(kRows, S - k0) * 4;
        mbar_arrive_expect_tx(&full_k[st], L::kTile + seg_bytes);
        tma_tile<D>(smem + L::kK + st * L::kTile, &tm_k, &full_k[st], kRows, h, k0, b);
        if (seg_bytes)
          bulk_load(smem + L::kSeg + st * kRows * 4, seg_kv + static_cast<long long>(b) * S + k0,
                    seg_bytes, &full_k[st]);
        mbar_arrive_expect_tx(&full_v[st], L::kTile);
        tma_tile<D>(smem + L::kV + st * L::kTile, &tm_v, &full_v[st], kRows, h, k0, b);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int ct = threadIdx.x - 128, wg = role - 1;
  const int warp = (ct >> 5) & 3, lane = ct & 31, g = lane >> 2, t = lane & 3;
  const int row_a = q0 + wg * 64 + warp * 16 + g, row_b = row_a + 8;
  const int* seg_q_row = seg_q == nullptr ? nullptr : seg_q + static_cast<long long>(b) * S;
  const int seg_a = (seg_q_row != nullptr && row_a < S) ? seg_q_row[row_a] : 0;
  const int seg_b = (seg_q_row != nullptr && row_b < S) ? seg_q_row[row_b] : 0;
  const uint32_t q_base = smem_u32(smem + L::kQ) + wg * 64 * 128;

  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  const float scale2 = scale * kLog2e;  // logits in log2 units: exp2 is one instruction
  for (int kt = 0; kt < n_kv; ++kt) {
    const int st = kt % kFwdStages, k0 = kt * kRows;
    const uint32_t ph = (kt / kFwdStages) & 1;

    // S = Q . K^T: 64 rows x 128 keys.
    float s[kRows / 2];
    mbar_wait(&full_k[st], ph);
    issue_scores<D>(s, q_base, smem_u32(smem + L::kK + st * L::kTile));
    wgmma_wait<0>();
    fence_regs(s);

    const bool masked = (causal && k0 + kRows > q0) || k0 + kRows > S || seg_kv != nullptr;
    if (masked) {
      const int* seg_k = seg_kv == nullptr ? nullptr : sseg + st * kRows;
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kidx = j * 8 + t * 2 + c, key = k0 + kidx;
          float sa = s[4 * j + c] * scale2, sb = s[4 * j + 2 + c] * scale2;
          if (key >= S) {
            sa = sb = -INFINITY;
          } else {
            const int sk = seg_k == nullptr ? 0 : seg_k[kidx];
            if ((causal && key > row_a) || sk != seg_a) sa += kMaskValue;
            if ((causal && key > row_b) || sk != seg_b) sb += kMaskValue;
          }
          s[4 * j + c] = sa;
          s[4 * j + 2 + c] = sb;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) s[i] *= scale2;
    }

    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    const float alpha_a = fast_exp2(m_a - mx_a), alpha_b = fast_exp2(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      s[4 * j + 0] = fast_exp2(s[4 * j + 0] - m_a);
      s[4 * j + 1] = fast_exp2(s[4 * j + 1] - m_a);
      s[4 * j + 2] = fast_exp2(s[4 * j + 2] - m_b);
      s[4 * j + 3] = fast_exp2(s[4 * j + 3] - m_b);
      rs_a += s[4 * j] + s[4 * j + 1];
      rs_b += s[4 * j + 2] + s[4 * j + 3];
    }
    l_a = l_a * alpha_a + rs_a;  // per-lane partial sums; reduced over the quad at the end
    l_b = l_b * alpha_b + rs_b;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j + 0] *= alpha_a;
      acc[4 * j + 1] *= alpha_a;
      acc[4 * j + 2] *= alpha_b;
      acc[4 * j + 3] *= alpha_b;
    }
    uint32_t p[kRows / 4];
    to_a_frags<kRows>(p, s);

    // O += P . V: V read MN-major (its rows are the contraction).
    const uint32_t v_base = smem_u32(smem + L::kV + st * L::kTile);
    mbar_wait(&full_v[st], ph);
    fence_regs(acc);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kRows / 16; ++kc)
      Wgmma<D>::rs_mn(acc, &p[4 * kc], mnstep(v_base, kRows, kc), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[st]);
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  // A ring block's row that saw no key: every logit carried MASK, so its
  // running max sits near MASK, far below any unmasked logit.
  const bool ring = lse == nullptr;
  const bool none_a = ring && m_a < 0.5f * kMaskValue;
  const bool none_b = ring && m_b < 0.5f * kMaskValue;
  m_a *= kLn2;  // back to natural-log units
  m_b *= kLn2;
  const long long stride = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * S * stride + static_cast<long long>(h) * D;
  const long long row0 = static_cast<long long>(bh) * S;
  if (row_a < S) {
    emit_row<D>(o + base + row_a * stride + t * 2, acc, 0, none_a ? 0.f : 1.f / l_a);
    if (t == 0) {
      if (!ring) {
        lse[row0 + row_a] = m_a + logf(l_a);
      } else {
        l_out[row0 + row_a] = none_a ? 0.f : l_a;
        m_out[row0 + row_a] = none_a ? kNoKeyMax : m_a;
      }
    }
  }
  if (row_b < S) {
    emit_row<D>(o + base + row_b * stride + t * 2, acc, 1, none_b ? 0.f : 1.f / l_b);
    if (t == 0) {
      if (!ring) {
        lse[row0 + row_b] = m_b + logf(l_b);
      } else {
        l_out[row0 + row_b] = none_b ? 0.f : l_b;
        m_out[row0 + row_b] = none_b ? kNoKeyMax : m_b;
      }
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
// The two consumer warpgroups split the work by output, not by keys: both
// hold the CTA's 64 keys, the dV warpgroup computes P^T and accumulates dV,
// the dK warpgroup computes dP^T, takes P^T from the dV warpgroup through
// shared memory (f32, two buffers, named barriers), and accumulates dK.
// Each holds one 64 x D accumulator, so neither spills, and each runs two
// products a step.
constexpr int kDkdvStages = 3;
constexpr int kBarPReady = 1;     // named barriers kBarPReady + buffer: P^T written
constexpr int kBarPConsumed = 3;  // kBarPConsumed + buffer: P^T read

template <int D>
struct DkdvSmem {
  static constexpr int kOwn = tile_bytes<D>(kStream);    // K, V: 64 keys
  static constexpr int kTile = tile_bytes<D>(kStream);   // Q, dO: 64 queries
  static constexpr int kP = kStream * kStream * 4;       // P^T, f32, one buffer
  static constexpr int kK = 0;
  static constexpr int kV = kK + kOwn;
  static constexpr int kQ = kV + kOwn;                   // [kDkdvStages]
  static constexpr int kDo = kQ + kDkdvStages * kTile;   // [kDkdvStages]
  static constexpr int kPt = kDo + kDkdvStages * kTile;  // [2]
  static constexpr int kLse = kPt + 2 * kP;              // float [kDkdvStages][64]
  static constexpr int kDelta = kLse + kDkdvStages * kStream * 4;
  static constexpr int kSeg = kDelta + kDkdvStages * kStream * 4;  // int [kDkdvStages][64]
  static constexpr int kBar = kSeg + kDkdvStages * kStream * 4;
  static constexpr int kBars = 1 + 2 * kDkdvStages;      // kv, full, empty
  static constexpr int kBytes = kBar + 8 * kBars + 1024;
};

// Grid (S / 64, B*H). The CTA owns 64 keys and walks the 64-row query tiles
// that can see them:
//   dV warpgroup: P^T = exp(S^T - lse) with S^T = K Q^T, dV += P^T dO;
//   dK warpgroup: dP^T = V dO^T, dS^T = P^T (dP^T - delta) * scale,
//                 dK += dS^T Q.
// OutT: bf16 (flash: dk, dv stored) or float (a ring block: added to the
// ring's accumulators).
template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do, const int* __restrict__ seg_q,
                   const int* __restrict__ seg_kv, const float* __restrict__ lse,
                   const float* __restrict__ delta, OutT* __restrict__ dk,
                   OutT* __restrict__ dv, int S, int H, int causal, float scale) {
  using L = DkdvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kDkdvStages;

  const int k0 = blockIdx.x * kStream;  // the longest causal walks first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q_first = causal ? k0 : 0;
  const int n_q = (S - q_first) / kStream;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kDkdvStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The warpgroup index, read from lane 0 so the compiler knows it is
  // uniform and the role branches are uniform.
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 0) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * L::kOwn);
      tma_tile<D>(smem + L::kK, &tm_k, bar_kv, kStream, h, k0, b);
      tma_tile<D>(smem + L::kV, &tm_v, bar_kv, kStream, h, k0, b);
      const long long row0 = static_cast<long long>(bh) * S;
      for (int i = 0; i < n_q; ++i) {
        const int st = i % kDkdvStages, q0 = q_first + i * kStream;
        if (i >= kDkdvStages) mbar_wait(&empty[st], ((i / kDkdvStages) - 1) & 1);
        const int vec = kStream * 4;
        mbar_arrive_expect_tx(&full[st], 2 * L::kTile + 2 * vec + (seg_q == nullptr ? 0 : vec));
        tma_tile<D>(smem + L::kQ + st * L::kTile, &tm_q, &full[st], kStream, h, q0, b);
        tma_tile<D>(smem + L::kDo + st * L::kTile, &tm_do, &full[st], kStream, h, q0, b);
        bulk_load(smem + L::kLse + st * vec, lse + row0 + q0, vec, &full[st]);
        bulk_load(smem + L::kDelta + st * vec, delta + row0 + q0, vec, &full[st]);
        if (seg_q != nullptr)
          bulk_load(smem + L::kSeg + st * vec, seg_q + static_cast<long long>(b) * S + q0, vec,
                    &full[st]);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int ct = (threadIdx.x - 128) & 127;
  const int warp = ct >> 5, lane = ct & 31, g = lane >> 2, t = lane & 3;
  const int key_a = k0 + warp * 16 + g, key_b = key_a + 8;
  const bool dv_group = role == 1;
  float acc[D / 2];  // dV (dV warpgroup) or dK (dK warpgroup)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // P^T in fragment order: buffer [i & 1], value j of thread ct at j * 128 + ct.
  float* p_buf = reinterpret_cast<float*>(smem + L::kPt);

  mbar_wait(bar_kv, 0);
  if (dv_group) {
    const int* seg_kv_row = seg_kv == nullptr ? nullptr : seg_kv + static_cast<long long>(b) * S;
    const int seg_ka = seg_kv_row == nullptr ? 0 : seg_kv_row[key_a];
    const int seg_kb = seg_kv_row == nullptr ? 0 : seg_kv_row[key_b];
    const uint32_t k_base = smem_u32(smem + L::kK);
    for (int i = 0; i < n_q; ++i) {
      const int st = i % kDkdvStages, q0 = q_first + i * kStream;
      const uint32_t q_base = smem_u32(smem + L::kQ + st * L::kTile);
      const uint32_t do_base = smem_u32(smem + L::kDo + st * L::kTile);
      const float* s_lse = reinterpret_cast<const float*>(smem + L::kLse) + st * kStream;
      const int* s_seg = seg_q == nullptr
                             ? nullptr
                             : reinterpret_cast<const int*>(smem + L::kSeg) + st * kStream;
      mbar_wait(&full[st], (i / kDkdvStages) & 1);

      // S^T = K . Q^T: 64 keys x 64 queries.
      float sp[kStream / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<kStream>::ss(sp, kstep(k_base, kStream, kk), kstep(q_base, kStream, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sp);

      // P^T = exp(masked logit - lse[query]).
      const bool masked = (causal && q0 < k0 + kStream) || s_seg != nullptr;
#pragma unroll
      for (int j = 0; j < kStream / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = j * 8 + t * 2 + c, query = q0 + qi;
          float sa = sp[4 * j + c] * scale, sb = sp[4 * j + 2 + c] * scale;
          if (masked) {
            const int sq = s_seg == nullptr ? 0 : s_seg[qi];
            if ((causal && key_a > query) || sq != seg_ka) sa += kMaskValue;
            if ((causal && key_b > query) || sq != seg_kb) sb += kMaskValue;
          }
          const float ls = s_lse[qi];
          sp[4 * j + c] = __expf(sa - ls);
          sp[4 * j + 2 + c] = __expf(sb - ls);
        }
      }
      // Hand P^T to the dK warpgroup once it has read this buffer's last use.
      float* pb = p_buf + (i & 1) * (kStream * kStream);
      if (i >= 2) named_bar_sync(kBarPConsumed + (i & 1), kConsumers);
#pragma unroll
      for (int j = 0; j < kStream / 2; ++j) pb[j * 128 + ct] = sp[j];
      named_bar_arrive(kBarPReady + (i & 1), kConsumers);

      // dV += P^T . dO (dO read MN-major).
      uint32_t pa[kStream / 4];
      to_a_frags<kStream>(pa, sp);
      fence_regs(pa);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kStream / 16; ++kc)
        Wgmma<D>::rs_mn(acc, &pa[4 * kc], mnstep(do_base, kStream, kc), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[st]);
    }
    // Balance the dK warpgroup's last two arrivals on the consumed barriers.
    for (int i = max(n_q, 2); i < n_q + 2; ++i)
      named_bar_sync(kBarPConsumed + (i & 1), kConsumers);
  } else {
    const uint32_t v_base = smem_u32(smem + L::kV);
    for (int i = 0; i < n_q; ++i) {
      const int st = i % kDkdvStages;
      const uint32_t q_base = smem_u32(smem + L::kQ + st * L::kTile);
      const uint32_t do_base = smem_u32(smem + L::kDo + st * L::kTile);
      const float* s_delta = reinterpret_cast<const float*>(smem + L::kDelta) + st * kStream;
      mbar_wait(&full[st], (i / kDkdvStages) & 1);

      // dP^T = V . dO^T: 64 keys x 64 queries.
      float dpt[kStream / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<kStream>::ss(dpt, kstep(v_base, kStream, kk), kstep(do_base, kStream, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dpt);

      // dS^T = P^T (dP^T - delta[query]) * scale.
      const float* pb = p_buf + (i & 1) * (kStream * kStream);
      named_bar_sync(kBarPReady + (i & 1), kConsumers);
#pragma unroll
      for (int j = 0; j < kStream / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float dl = s_delta[j * 8 + t * 2 + c];
          dpt[4 * j + c] = pb[(4 * j + c) * 128 + ct] * (dpt[4 * j + c] - dl) * scale;
          dpt[4 * j + 2 + c] =
              pb[(4 * j + 2 + c) * 128 + ct] * (dpt[4 * j + 2 + c] - dl) * scale;
        }
      }
      named_bar_arrive(kBarPConsumed + (i & 1), kConsumers);

      // dK += dS^T . Q (Q read MN-major).
      uint32_t da[kStream / 4];
      to_a_frags<kStream>(da, dpt);
      fence_regs(da);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kStream / 16; ++kc)
        Wgmma<D>::rs_mn(acc, &da[4 * kc], mnstep(q_base, kStream, kc), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[st]);
    }
  }

  OutT* out = dv_group ? dv : dk;
  const long long stride = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * S * stride + static_cast<long long>(h) * D;
  emit_row<D>(out + base + key_a * stride + t * 2, acc, 0, 1.f);
  emit_row<D>(out + base + key_b * stride + t * 2, acc, 1, 1.f);
}

// ------------------------------------------------------------ backward: dQ
template <int D>
struct DqSmem {
  static constexpr int kOwn = tile_bytes<D>(kRows);      // Q, dO: 128 queries
  static constexpr int kTile = tile_bytes<D>(kStream);   // K, V: 64 keys
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kOwn;
  static constexpr int kK = kDo + kOwn;                  // [kStages]
  static constexpr int kV = kK + kStages * kTile;        // [kStages]
  static constexpr int kSeg = kV + kStages * kTile;      // int [kStages][64]
  static constexpr int kBar = kSeg + kStages * kStream * 4;
  static constexpr int kBars = 1 + 2 * kStages;          // q, full, empty
  static constexpr int kBytes = kBar + 8 * kBars + 1024;
};

// Grid (ceil(S / 128), B*H). Each consumer warpgroup owns 64 of the CTA's
// 128 queries and walks the 64-key tiles they can see: P = exp(S - lse),
// dP = dO V^T, dS = P (dP - delta) * scale, dQ += dS K. OutT as in
// flash_bwd_dkdv.
template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_kv, const float* __restrict__ lse,
                 const float* __restrict__ delta, OutT* __restrict__ dq, int S, int H,
                 int causal, float scale) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;

  const int n_qt = (S + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kRows;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n_kv = (causal ? min(S, q0 + kRows) : S) / kStream;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The warpgroup index, read from lane 0 so the compiler knows it is
  // uniform: the role branch is then uniform, and the consumers' code gets
  // the registers setmaxnreg gives them.
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 0) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar_q, 2 * L::kOwn);
      tma_tile<D>(smem + L::kQ, &tm_q, bar_q, kRows, h, q0, b);
      tma_tile<D>(smem + L::kDo, &tm_do, bar_q, kRows, h, q0, b);
      for (int kt = 0; kt < n_kv; ++kt) {
        const int st = kt % kStages, k0 = kt * kStream;
        if (kt >= kStages) mbar_wait(&empty[st], ((kt / kStages) - 1) & 1);
        const int vec = kStream * 4;
        mbar_arrive_expect_tx(&full[st], 2 * L::kTile + (seg_kv == nullptr ? 0 : vec));
        tma_tile<D>(smem + L::kK + st * L::kTile, &tm_k, &full[st], kStream, h, k0, b);
        tma_tile<D>(smem + L::kV + st * L::kTile, &tm_v, &full[st], kStream, h, k0, b);
        if (seg_kv != nullptr)
          bulk_load(smem + L::kSeg + st * vec, seg_kv + static_cast<long long>(b) * S + k0, vec,
                    &full[st]);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int ct = threadIdx.x - 128, wg = role - 1;
  const int warp = (ct >> 5) & 3, lane = ct & 31, g = lane >> 2, t = lane & 3;
  const int row_a = q0 + wg * 64 + warp * 16 + g, row_b = row_a + 8;
  const long long row0 = static_cast<long long>(bh) * S;
  const int* seg_q_row = seg_q == nullptr ? nullptr : seg_q + static_cast<long long>(b) * S;
  const bool in_a = row_a < S, in_b = row_b < S;
  const int seg_a = (seg_q_row != nullptr && in_a) ? seg_q_row[row_a] : 0;
  const int seg_b = (seg_q_row != nullptr && in_b) ? seg_q_row[row_b] : 0;
  const float lse_a = in_a ? lse[row0 + row_a] : 0.f, lse_b = in_b ? lse[row0 + row_b] : 0.f;
  const float dl_a = in_a ? delta[row0 + row_a] : 0.f, dl_b = in_b ? delta[row0 + row_b] : 0.f;
  const uint32_t q_base = smem_u32(smem + L::kQ) + wg * 64 * 128;
  const uint32_t do_base = smem_u32(smem + L::kDo) + wg * 64 * 128;

  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int st = kt % kStages, k0 = kt * kStream;
    const uint32_t k_base = smem_u32(smem + L::kK + st * L::kTile);
    const uint32_t v_base = smem_u32(smem + L::kV + st * L::kTile);
    const int* s_seg =
        seg_kv == nullptr ? nullptr : reinterpret_cast<const int*>(smem + L::kSeg) + st * kStream;
    mbar_wait(&full[st], (kt / kStages) & 1);

    // S = Q_w . K^T and dP = dO_w . V^T: 64 rows x 64 keys each, one group.
    float s[kStream / 2], dp[kStream / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<kStream>::ss(s, kstep(q_base, kRows, kk), kstep(k_base, kStream, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<kStream>::ss(dp, kstep(do_base, kRows, kk), kstep(v_base, kStream, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const bool masked = (causal && k0 + kStream > q0) || s_seg != nullptr;
#pragma unroll
    for (int j = 0; j < kStream / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kidx = j * 8 + t * 2 + c, key = k0 + kidx;
        float sa = s[4 * j + c] * scale, sb = s[4 * j + 2 + c] * scale;
        if (masked) {
          const int sk = s_seg == nullptr ? 0 : s_seg[kidx];
          if ((causal && key > row_a) || sk != seg_a) sa += kMaskValue;
          if ((causal && key > row_b) || sk != seg_b) sb += kMaskValue;
        }
        s[4 * j + c] = __expf(sa - lse_a) * (dp[4 * j + c] - dl_a) * scale;
        s[4 * j + 2 + c] = __expf(sb - lse_b) * (dp[4 * j + 2 + c] - dl_b) * scale;
      }
    }
    uint32_t da[kStream / 4];
    to_a_frags<kStream>(da, s);

    // dQ += dS . K (K read MN-major).
    fence_regs(da);
    fence_regs(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kStream / 16; ++kc)
      Wgmma<D>::rs_mn(dq_acc, &da[4 * kc], mnstep(k_base, kStream, kc), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    mbar_arrive(&empty[st]);
  }

  const long long stride = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * S * stride + static_cast<long long>(h) * D;
  if (in_a) emit_row<D>(dq + base + row_a * stride + t * 2, dq_acc, 0, 1.f);
  if (in_b) emit_row<D>(dq + base + row_b * stride + t * 2, dq_acc, 1, 1.f);
}

// Tensor maps of q, k, v (and dO) with the box rows each kernel streams.
struct Maps {
  CUtensorMap q, k, v, dout;
};

template <int D>
int make_maps(Maps* m, const bf16* q, const bf16* k, const bf16* v, const bf16* dout, int B,
              int S, int H, int q_rows, int kv_rows) {
  int err = encode_bshd_map(&m->q, q, B, S, H, D, q_rows);
  if (err == 0) err = encode_bshd_map(&m->k, k, B, S, H, D, kv_rows);
  if (err == 0) err = encode_bshd_map(&m->v, v, B, S, H, D, kv_rows);
  if (err == 0 && dout != nullptr) err = encode_bshd_map(&m->dout, dout, B, S, H, D, q_rows);
  return err;
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int D>
int fwd_launch(const bf16* q, const bf16* k, const bf16* v, const int* seg_q, const int* seg_kv,
               bf16* o, float* lse, float* l_out, float* m_out, int B, int S, int H, int causal,
               float scale, cudaStream_t stream) {
  Maps m;
  int err = make_maps<D>(&m, q, k, v, nullptr, B, S, H, kRows, kRows);
  if (err == 0) err = set_smem(flash_fwd<D>, FwdSmem<D>::kBytes);
  if (err != 0) return err;
  flash_fwd<D><<<dim3((S + kRows - 1) / kRows, B * H), kThreads, FwdSmem<D>::kBytes, stream>>>(
      m.q, m.k, m.v, seg_q, seg_kv, o, lse, l_out, m_out, S, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The dK/dV and dQ kernels; delta must be ready on the stream.
template <int D, typename OutT>
int bwd_main_launch(const bf16* q, const bf16* k, const bf16* v, const int* seg_q,
                    const int* seg_kv, const bf16* dout, const float* lse, const float* delta,
                    OutT* dq, OutT* dk, OutT* dv, int B, int S, int H, int causal, float scale,
                    cudaStream_t stream) {
  Maps m;
  int err = make_maps<D>(&m, q, k, v, dout, B, S, H, kStream, kStream);
  if (err == 0) err = set_smem(flash_bwd_dkdv<D, OutT>, DkdvSmem<D>::kBytes);
  if (err != 0) return err;
  flash_bwd_dkdv<D, OutT><<<dim3(S / kStream, B * H), kThreads, DkdvSmem<D>::kBytes, stream>>>(
      m.q, m.k, m.v, m.dout, seg_q, seg_kv, lse, delta, dk, dv, S, H, causal, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err == 0) err = make_maps<D>(&m, q, k, v, dout, B, S, H, kRows, kStream);
  if (err == 0) err = set_smem(flash_bwd_dq<D, OutT>, DqSmem<D>::kBytes);
  if (err != 0) return err;
  flash_bwd_dq<D, OutT><<<dim3((S + kRows - 1) / kRows, B * H), kThreads, DqSmem<D>::kBytes,
                          stream>>>(
      m.q, m.k, m.v, m.dout, seg_q, seg_kv, lse, delta, dq, S, H, causal, scale);
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
