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
// min(S - 1, k1 + window - 1). Each consumer warpgroup of a 128-row query
// tile skips the tiles its own 64 rows cannot see (the first rows' last
// tile is past their diagonal, the last rows' first tile may be past their
// window). The mask is evaluated only on tiles that the diagonal, the
// window's edge or segment ids cut. A row whose first visited tile is
// wholly masked for it starts its running max at MASK; the first visible
// key rescales everything before it by exp(MASK - m) = 0, so the row ends
// as the plain version's. Every row sees at least itself.
//
// Bound: operations. Forward 4 * D * H * (visible pairs); at Gemma-2-9B's
// global layer (B1, S8192, H16, D256) 549.8 GFLOP, 0.556 ms at 989 TFLOP/s,
// and its local layer (window 4096) 412.4 GFLOP, 0.417 ms. The backward does
// five products of the same size (S, dP, dV, dK, dQ), about 2.5 times the
// forward's operations; the dQ kernel recomputes S and dP (seven products in
// all, the price of no atomics).
//
// Design, as flash_attention.cu's (the Hopper helpers are those of
// hopper_common.cuh): each CTA has three warpgroups; warpgroup 0 is the
// producer, whose first thread issues every load by TMA into 128-byte-
// swizzled shared memory and signals it on mbarriers, then gives its
// registers up (setmaxnreg 24); warpgroups 1 and 2 are consumers
// (setmaxnreg 240). Every product is a wgmma m64nNk16 with f32 accumulators:
// scores and dP from shared memory on both sides (SS, N = 64 keys or
// queries, D / 16 k steps crossing D / 64 panels); the products whose A is
// a probability or a dS take it from registers (RS), where the score
// accumulator already has the A fragment's layout, with B (V, dO, Q or K)
// read MN-major from the same swizzled tile, N = D (m64n256k16 at D = 256).
// Head widths 64, 128 and 256 are instances of the same templates. D = 256
// is what sizes them: a 64 x 256 f32 accumulator is 128 registers a
// consumer thread, and a 64-row tile 32 KB of shared memory. Every
// mbarrier wait is mbar_wait_fault: with a trap in its timeout, ptxas holds
// the consumers to 168 registers and the D = 256 accumulators spill.
//   - forward: 128 query rows a CTA (Q loaded once, 64 KB at D = 256), 64 a
//     consumer; K/V tiles of 64 keys in two stages (three below D = 256):
//     192 KB. S = Q.K^T (SS), the softcap and the mask on S in registers,
//     online softmax (exp2 of logits in log2 units), O += P.V (RS).
//   - dK/dV: 64 keys a CTA (K, V loaded once), Q/dO steps of 64 rows in two
//     stages (three below D = 256) with their log-sum-exp, delta and
//     segment rows brought in by bulk copies beside them. The consumers
//     split the work by output, since two 64 x 256 accumulators do not fit
//     one warpgroup: one computes S^T = K.Q^T (SS), P^T, and dV += P^T.dO
//     (RS); the other computes dP^T = V.dO^T (SS), reads P^T times the
//     softcap's factor (f32) from the first through shared memory (two
//     buffers under named barriers), and accumulates dK += dS^T.Q (RS).
//     At D = 256: 64 + 128 + 32 KB and the row vectors, 226.5 KB of 227.
//   - dQ: 128 query rows a CTA (Q, dO loaded once, 128 KB at D = 256), 64 a
//     consumer; K tiles of 64 keys in two stages and V tiles in one (two
//     below D = 256), on separate barriers: V is released once dP is read,
//     K after dQ += dS.K. S = Q.K^T (SS) becomes P (1 - tanh^2) in its own
//     registers before dP = dO.V^T (SS) is issued, so the softcap's
//     temporaries and dP are never live together beside the 64 x 256 dQ
//     accumulator; then dQ += dS.K (RS, K MN-major). 224 KB at D = 256.
// S only needs to be a multiple of 64: KV tiles and query steps of 64 never
// pass S, the second half of a 128-row tile past S reads zeros from TMA and
// its consumer skips every tile, and no row past S is written.
//
// Interface: plain C functions bound with ctypes
// (accelerate_tpu_torch/ops/kernels/splash_attention.py). Each builds its
// TMA tensor maps on the host, launches on the caller's stream, allocates
// nothing, and returns a cudaError_t code. window 0 means no window,
// softcap 0 no softcap.

#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace attn;
using namespace hopper;

constexpr int kThreads = 384;    // producer warpgroup + two consumer warpgroups
constexpr int kConsumers = 256;  // arrivals that release a stage
constexpr int kRows = 128;       // query rows of a forward or dQ CTA, 64 a consumer
constexpr int kTile = 64;        // keys of a KV tile or a dK/dV CTA; rows of a query step
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Depth of a streamed ring: shared memory holds two stages at D = 256.
template <int D>
__host__ __device__ constexpr int stages() {
  return D == 256 ? 2 : 3;
}

// Does a query see a key? d = query - key.
__device__ __forceinline__ bool visible(int d, int window, bool same_segment) {
  return d >= 0 && (window == 0 || d < window) && same_segment;
}

// Must the mask be evaluated on the 64 x 64 block of queries from q0 and keys
// from k0? Not where every key is at or below the diagonal and inside the
// window for every query, and there are no segment ids.
__device__ __forceinline__ bool block_needs_mask(int q0, int k0, int window, bool segments) {
  const bool below_diagonal = k0 + kTile - 1 <= q0;
  const bool inside_window = window == 0 || (q0 + kTile - 1) - k0 < window;
  return segments || !(below_diagonal && inside_window);
}

// First KV tile that queries from q0 on can see.
__device__ __forceinline__ int first_kv_tile(int q0, int window) {
  return window > 0 ? max(0, q0 - window + 1) / kTile : 0;
}

// The softcap of an uncapped logit l (inv_cap = 1 / cap); `th` receives
// tanh(l / cap) (0 without a softcap), which the backward's factor
// 1 - th^2 reuses.
__device__ __forceinline__ float soft_cap(float l, float softcap, float inv_cap, float& th) {
  if (softcap > 0.f) {
    th = tanhf(l * inv_cap);
    return th * softcap;
  }
  th = 0.f;
  return l;
}

// The warpgroup index, read from lane 0 so the compiler knows it is uniform:
// the role branches are then uniform, and the consumers' code gets the
// registers setmaxnreg gives them.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

// ------------------------------------------------------------------ forward
template <int D>
struct FwdSmem {
  static constexpr int kStages = stages<D>();
  static constexpr int kQTile = tile_bytes<D>(kRows);
  static constexpr int kKvTile = tile_bytes<D>(kTile);
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQTile;                // [kStages]
  static constexpr int kV = kK + kStages * kKvTile;     // [kStages]
  static constexpr int kSeg = kV + kStages * kKvTile;   // int [kStages][kTile]
  static constexpr int kBar = kSeg + kStages * kTile * 4;
  static constexpr int kBars = 1 + 3 * kStages;         // q, full_k, full_v, empty
  static constexpr int kBytes = kBar + 8 * kBars + 1024;  // + alignment slack
};

// Grid (ceil(S / 128), B*H).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    splash_fwd(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ seg,
               bf16* __restrict__ o, float* __restrict__ lse, int S, int H, int window,
               float softcap) {
  using L = FwdSmem<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;
  const int* sseg = reinterpret_cast<const int*>(smem + L::kSeg);

  const int n_qt = (S + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kRows;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  // KV tiles some row of the CTA sees: from the first row's window edge to
  // the last real row's diagonal.
  const int kt_lo = first_kv_tile(q0, window);
  const int n_kv = (min(q0 + kRows, S) - 1) / kTile - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int role = warpgroup();
  if (role == 0) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar_q, L::kQTile);
      tma_tile<D>(smem + L::kQ, &tm_q, bar_q, kRows, h, q0, b);
      const int seg_bytes = seg == nullptr ? 0 : kTile * 4;
      for (int i = 0; i < n_kv; ++i) {
        const int st = i % kStages, k0 = (kt_lo + i) * kTile;
        if (i >= kStages) mbar_wait_fault(&empty[st], ((i / kStages) - 1) & 1);
        mbar_arrive_expect_tx(&full_k[st], L::kKvTile + seg_bytes);
        tma_tile<D>(smem + L::kK + st * L::kKvTile, &tm_k, &full_k[st], kTile, h, k0, b);
        if (seg_bytes)
          bulk_load(smem + L::kSeg + st * kTile * 4, seg + static_cast<long long>(b) * S + k0,
                    seg_bytes, &full_k[st]);
        mbar_arrive_expect_tx(&full_v[st], L::kKvTile);
        tma_tile<D>(smem + L::kV + st * L::kKvTile, &tm_v, &full_v[st], kTile, h, k0, b);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int ct = threadIdx.x - 128, wg = role - 1;
  const int warp = (ct >> 5) & 3, lane = ct & 31, g = lane >> 2, t = lane & 3;
  const int qw0 = q0 + wg * 64;  // the consumer's first row
  const int row_a = qw0 + warp * 16 + g, row_b = row_a + 8;
  // The consumer's own KV tiles; none for rows past S.
  const int kt_first = first_kv_tile(qw0, window), kt_last = qw0 < S ? qw0 / kTile : -1;
  const int* seg_row = seg == nullptr ? nullptr : seg + static_cast<long long>(b) * S;
  const int seg_a = (seg_row != nullptr && qw0 < S) ? seg_row[row_a] : 0;
  const int seg_b = (seg_row != nullptr && qw0 < S) ? seg_row[row_b] : 0;
  const uint32_t q_base = smem_u32(smem + L::kQ) + wg * 64 * 128;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait_fault(bar_q, 0);
  for (int i = 0; i < n_kv; ++i) {
    const int st = i % kStages, kt = kt_lo + i, k0 = kt * kTile;
    const uint32_t ph = (i / kStages) & 1;
    mbar_wait_fault(&full_k[st], ph);
    if (kt < kt_first || kt > kt_last) {  // a tile only the other consumer's rows see
      mbar_wait_fault(&full_v[st], ph);
      mbar_arrive(&empty[st]);
      continue;
    }

    // S = Q_w . K^T: 64 rows x 64 keys, uncapped.
    float s[kTile / 2];
    const uint32_t k_base = smem_u32(smem + L::kK + st * L::kKvTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<kTile>::ss(s, kstep(q_base, kRows, kk), kstep(k_base, kTile, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Cap, then replace masked logits by MASK; logits in log2 units (MASK
    // stays as it is: it only has to sit far below every real logit).
    const bool masked = block_needs_mask(qw0, k0, window, seg != nullptr);
    const int* seg_k = seg == nullptr ? nullptr : sseg + st * kTile;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kidx = j * 8 + t * 2 + c, key = k0 + kidx;
        float th;
        float sa = soft_cap(s[4 * j + c], softcap, inv_cap, th) * kLog2e;
        float sb = soft_cap(s[4 * j + 2 + c], softcap, inv_cap, th) * kLog2e;
        if (masked) {
          const int sk = seg_k == nullptr ? 0 : seg_k[kidx];
          if (!visible(row_a - key, window, sk == seg_a)) sa = kMaskValue;
          if (!visible(row_b - key, window, sk == seg_b)) sb = kMaskValue;
        }
        s[4 * j + c] = sa;
        s[4 * j + 2 + c] = sb;
      }
    }

    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    // exp(MASK - m) is 0 once a row has seen a visible key, and 1 while its
    // running max is still MASK: the first visible key rescales the rest away.
    const float alpha_a = fast_exp2(m_a - mx_a), alpha_b = fast_exp2(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
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
    uint32_t p[kTile / 4];
    to_a_frags<kTile>(p, s);

    // O += P . V: V read MN-major (its rows are the contraction).
    const uint32_t v_base = smem_u32(smem + L::kV + st * L::kKvTile);
    mbar_wait_fault(&full_v[st], ph);
    fence_regs(acc);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc)
      Wgmma<D>::rs_mn(acc, &p[4 * kc], mnstep(v_base, kTile, kc), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[st]);
  }

  if (qw0 >= S) return;
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const long long stride = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * S * stride + static_cast<long long>(h) * D;
  emit_row<D>(o + base + row_a * stride + t * 2, acc, 0, 1.f / l_a);
  emit_row<D>(o + base + row_b * stride + t * 2, acc, 1, 1.f / l_b);
  if (t == 0) {
    float* lrow = lse + static_cast<long long>(bh) * S;
    lrow[row_a] = m_a * kLn2 + logf(l_a);  // m back to natural-log units
    lrow[row_b] = m_b * kLn2 + logf(l_b);
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
constexpr int kBarPReady = 1;     // named barriers kBarPReady + buffer: P^T written
constexpr int kBarPConsumed = 3;  // kBarPConsumed + buffer: P^T read

template <int D>
struct DkdvSmem {
  static constexpr int kStages = stages<D>();
  static constexpr int kTileB = tile_bytes<D>(kTile);   // K, V; a Q or dO step
  static constexpr int kP = kTile * kTile * 4;          // P^T (times the cap's factor), f32
  static constexpr int kVec = kTile * 4;                // a step's f32 or int32 row vector
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTileB;
  static constexpr int kQ = kV + kTileB;                // [kStages]
  static constexpr int kDo = kQ + kStages * kTileB;     // [kStages]
  static constexpr int kPt = kDo + kStages * kTileB;    // [2]
  static constexpr int kLse = kPt + 2 * kP;             // [kStages]
  static constexpr int kDelta = kLse + kStages * kVec;  // [kStages]
  static constexpr int kSeg = kDelta + kStages * kVec;  // [kStages]
  static constexpr int kBar = kSeg + kStages * kVec;
  static constexpr int kBars = 1 + 2 * kStages;         // kv, full, empty
  static constexpr int kBytes = kBar + 8 * kBars + 1024;
};

// Grid (S / 64, B*H). The CTA owns 64 keys and walks the 64-row query steps
// that can see them, from its diagonal to the window's end:
//   dV warpgroup: P^T = exp(cap(K Q^T) - lse) (masked: 0), dV += P^T dO;
//   dK warpgroup: dP^T = V dO^T, dS^T = P^T (1 - tanh^2) (dP^T - delta),
//                 dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    splash_bwd_dkdv(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const int* __restrict__ seg,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int window,
                    float softcap) {
  using L = DkdvSmem<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kStages;

  const int k0 = blockIdx.x * kTile;  // the longest causal walks first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q_end = window > 0 ? min(S, k0 + kTile - 1 + window) : S;
  const int n_q = (q_end - k0 + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int role = warpgroup();
  if (role == 0) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * L::kTileB);
      tma_tile<D>(smem + L::kK, &tm_k, bar_kv, kTile, h, k0, b);
      tma_tile<D>(smem + L::kV, &tm_v, bar_kv, kTile, h, k0, b);
      const long long row0 = static_cast<long long>(bh) * S;
      for (int i = 0; i < n_q; ++i) {
        const int st = i % kStages, q0 = k0 + i * kTile;
        if (i >= kStages) mbar_wait_fault(&empty[st], ((i / kStages) - 1) & 1);
        mbar_arrive_expect_tx(&full[st],
                              2 * L::kTileB + 2 * L::kVec + (seg == nullptr ? 0 : L::kVec));
        tma_tile<D>(smem + L::kQ + st * L::kTileB, &tm_q, &full[st], kTile, h, q0, b);
        tma_tile<D>(smem + L::kDo + st * L::kTileB, &tm_do, &full[st], kTile, h, q0, b);
        bulk_load(smem + L::kLse + st * L::kVec, lse + row0 + q0, L::kVec, &full[st]);
        bulk_load(smem + L::kDelta + st * L::kVec, delta + row0 + q0, L::kVec, &full[st]);
        if (seg != nullptr)
          bulk_load(smem + L::kSeg + st * L::kVec, seg + static_cast<long long>(b) * S + q0,
                    L::kVec, &full[st]);
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

  mbar_wait_fault(bar_kv, 0);
  if (dv_group) {
    const int* seg_row = seg == nullptr ? nullptr : seg + static_cast<long long>(b) * S;
    const int seg_ka = seg_row == nullptr ? 0 : seg_row[key_a];
    const int seg_kb = seg_row == nullptr ? 0 : seg_row[key_b];
    const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
    const uint32_t k_base = smem_u32(smem + L::kK);
    for (int i = 0; i < n_q; ++i) {
      const int st = i % kStages, q0 = k0 + i * kTile;
      const uint32_t q_base = smem_u32(smem + L::kQ + st * L::kTileB);
      const uint32_t do_base = smem_u32(smem + L::kDo + st * L::kTileB);
      const float* s_lse = reinterpret_cast<const float*>(smem + L::kLse) + st * kTile;
      const int* s_seg =
          seg == nullptr ? nullptr : reinterpret_cast<const int*>(smem + L::kSeg) + st * kTile;
      mbar_wait_fault(&full[st], (i / kStages) & 1);

      // S^T = K . Q^T: 64 keys x 64 queries, uncapped.
      float sp[kTile / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<kTile>::ss(sp, kstep(k_base, kTile, kk), kstep(q_base, kTile, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sp);

      // P^T = exp(cap(S^T) - lse[query]), 0 where masked; the dK warpgroup
      // gets P^T (1 - tanh^2) once it has read this buffer's last use.
      float* pt = p_buf + (i & 1) * (kTile * kTile);
      if (i >= 2) named_bar_sync(kBarPConsumed + (i & 1), kConsumers);
      const bool masked = block_needs_mask(q0, k0, window, s_seg != nullptr);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = j * 8 + t * 2 + c, query = q0 + qi;
          float th_a, th_b;
          const float ca = soft_cap(sp[4 * j + c], softcap, inv_cap, th_a);
          const float cb = soft_cap(sp[4 * j + 2 + c], softcap, inv_cap, th_b);
          bool keep_a = true, keep_b = true;
          if (masked) {
            const int sq = s_seg == nullptr ? 0 : s_seg[qi];
            keep_a = visible(query - key_a, window, sq == seg_ka);
            keep_b = visible(query - key_b, window, sq == seg_kb);
          }
          const float ls = s_lse[qi];
          const float p_a = keep_a ? __expf(ca - ls) : 0.f;
          const float p_b = keep_b ? __expf(cb - ls) : 0.f;
          pt[(4 * j + c) * 128 + ct] = p_a * (1.f - th_a * th_a);
          pt[(4 * j + 2 + c) * 128 + ct] = p_b * (1.f - th_b * th_b);
          sp[4 * j + c] = p_a;
          sp[4 * j + 2 + c] = p_b;
        }
      }
      named_bar_arrive(kBarPReady + (i & 1), kConsumers);

      // dV += P^T . dO (dO read MN-major).
      uint32_t pf[kTile / 4];
      to_a_frags<kTile>(pf, sp);
      fence_regs(pf);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kTile / 16; ++kc)
        Wgmma<D>::rs_mn(acc, &pf[4 * kc], mnstep(do_base, kTile, kc), 1);
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
      const int st = i % kStages;
      const uint32_t q_base = smem_u32(smem + L::kQ + st * L::kTileB);
      const uint32_t do_base = smem_u32(smem + L::kDo + st * L::kTileB);
      const float* s_delta = reinterpret_cast<const float*>(smem + L::kDelta) + st * kTile;
      mbar_wait_fault(&full[st], (i / kStages) & 1);

      // dP^T = V . dO^T: 64 keys x 64 queries.
      float dpt[kTile / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<kTile>::ss(dpt, kstep(v_base, kTile, kk), kstep(do_base, kTile, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dpt);

      // dS^T = P^T (1 - tanh^2) (dP^T - delta[query]).
      const float* pt = p_buf + (i & 1) * (kTile * kTile);
      named_bar_sync(kBarPReady + (i & 1), kConsumers);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float dl = s_delta[j * 8 + t * 2 + c];
          dpt[4 * j + c] = pt[(4 * j + c) * 128 + ct] * (dpt[4 * j + c] - dl);
          dpt[4 * j + 2 + c] = pt[(4 * j + 2 + c) * 128 + ct] * (dpt[4 * j + 2 + c] - dl);
        }
      }
      named_bar_arrive(kBarPConsumed + (i & 1), kConsumers);

      // dK += dS^T . Q (Q read MN-major).
      uint32_t da[kTile / 4];
      to_a_frags<kTile>(da, dpt);
      fence_regs(da);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kTile / 16; ++kc)
        Wgmma<D>::rs_mn(acc, &da[4 * kc], mnstep(q_base, kTile, kc), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[st]);
    }
  }

  bf16* out = dv_group ? dv : dk;
  const long long stride = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * S * stride + static_cast<long long>(h) * D;
  emit_row<D>(out + base + key_a * stride + t * 2, acc, 0, 1.f);
  emit_row<D>(out + base + key_b * stride + t * 2, acc, 1, 1.f);
}

// ------------------------------------------------------------ backward: dQ
template <int D>
struct DqSmem {
  static constexpr int kKStages = 2;
  static constexpr int kVStages = D == 256 ? 1 : 2;     // shared memory holds one at D = 256
  static constexpr int kOwn = tile_bytes<D>(kRows);     // Q, dO: 128 queries
  static constexpr int kTileB = tile_bytes<D>(kTile);   // K, V: 64 keys
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kOwn;
  static constexpr int kK = kDo + kOwn;                 // [kKStages]
  static constexpr int kV = kK + kKStages * kTileB;     // [kVStages]
  static constexpr int kSeg = kV + kVStages * kTileB;   // int [kKStages][kTile]
  static constexpr int kBar = kSeg + kKStages * kTile * 4;
  static constexpr int kBars = 1 + 2 * kKStages + 2 * kVStages;  // q, full/empty K, V
  static constexpr int kBytes = kBar + 8 * kBars + 1024;
};

// Grid (ceil(S / 128), B*H). Each consumer warpgroup owns 64 of the CTA's
// 128 queries and walks the 64-key tiles they can see: P = exp(cap(Q K^T) -
// lse), dP = dO V^T, dS = P (dP - delta) (1 - tanh^2), dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    splash_bwd_dq(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do, const int* __restrict__ seg,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dq, int S, int H, int window, float softcap) {
  using L = DqSmem<D>;
  constexpr int kKStages = L::kKStages, kVStages = L::kVStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full_k = bar_q + 1;
  uint64_t* empty_k = full_k + kKStages;
  uint64_t* full_v = empty_k + kKStages;
  uint64_t* empty_v = full_v + kVStages;

  const int n_qt = (S + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kRows;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kt_lo = first_kv_tile(q0, window);
  const int n_kv = (min(q0 + kRows, S) - 1) / kTile - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&empty_k[s], kConsumers);
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_v[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int role = warpgroup();
  if (role == 0) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar_q, 2 * L::kOwn);
      tma_tile<D>(smem + L::kQ, &tm_q, bar_q, kRows, h, q0, b);
      tma_tile<D>(smem + L::kDo, &tm_do, bar_q, kRows, h, q0, b);
      const int seg_bytes = seg == nullptr ? 0 : kTile * 4;
      for (int i = 0; i < n_kv; ++i) {
        const int sk = i % kKStages, sv = i % kVStages, k0 = (kt_lo + i) * kTile;
        if (i >= kKStages) mbar_wait_fault(&empty_k[sk], ((i / kKStages) - 1) & 1);
        mbar_arrive_expect_tx(&full_k[sk], L::kTileB + seg_bytes);
        tma_tile<D>(smem + L::kK + sk * L::kTileB, &tm_k, &full_k[sk], kTile, h, k0, b);
        if (seg_bytes)
          bulk_load(smem + L::kSeg + sk * kTile * 4, seg + static_cast<long long>(b) * S + k0,
                    seg_bytes, &full_k[sk]);
        if (i >= kVStages) mbar_wait_fault(&empty_v[sv], ((i / kVStages) - 1) & 1);
        mbar_arrive_expect_tx(&full_v[sv], L::kTileB);
        tma_tile<D>(smem + L::kV + sv * L::kTileB, &tm_v, &full_v[sv], kTile, h, k0, b);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int ct = threadIdx.x - 128, wg = role - 1;
  const int warp = (ct >> 5) & 3, lane = ct & 31, g = lane >> 2, t = lane & 3;
  const int qw0 = q0 + wg * 64;
  const int row_a = qw0 + warp * 16 + g, row_b = row_a + 8;
  const int kt_first = first_kv_tile(qw0, window), kt_last = qw0 < S ? qw0 / kTile : -1;
  const bool real = qw0 < S;
  const long long row0 = static_cast<long long>(bh) * S;
  const int* seg_row = seg == nullptr ? nullptr : seg + static_cast<long long>(b) * S;
  const int seg_a = (seg_row != nullptr && real) ? seg_row[row_a] : 0;
  const int seg_b = (seg_row != nullptr && real) ? seg_row[row_b] : 0;
  const float lse_a = real ? lse[row0 + row_a] : 0.f, lse_b = real ? lse[row0 + row_b] : 0.f;
  const float dl_a = real ? delta[row0 + row_a] : 0.f, dl_b = real ? delta[row0 + row_b] : 0.f;
  const uint32_t q_base = smem_u32(smem + L::kQ) + wg * 64 * 128;
  const uint32_t do_base = smem_u32(smem + L::kDo) + wg * 64 * 128;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

  mbar_wait_fault(bar_q, 0);
  for (int i = 0; i < n_kv; ++i) {
    const int sk = i % kKStages, sv = i % kVStages, kt = kt_lo + i, k0 = kt * kTile;
    const uint32_t phk = (i / kKStages) & 1, phv = (i / kVStages) & 1;
    mbar_wait_fault(&full_k[sk], phk);
    if (kt < kt_first || kt > kt_last) {  // a tile only the other consumer's rows see
      mbar_wait_fault(&full_v[sv], phv);
      mbar_arrive(&empty_v[sv]);
      mbar_arrive(&empty_k[sk]);
      continue;
    }
    const uint32_t k_base = smem_u32(smem + L::kK + sk * L::kTileB);
    const uint32_t v_base = smem_u32(smem + L::kV + sv * L::kTileB);

    // S = Q_w . K^T: 64 rows x 64 keys; P (1 - tanh^2) in its registers.
    float s[kTile / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<kTile>::ss(s, kstep(q_base, kRows, kk), kstep(k_base, kTile, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const bool masked = block_needs_mask(qw0, k0, window, seg != nullptr);
    const int* s_seg =
        seg == nullptr ? nullptr : reinterpret_cast<const int*>(smem + L::kSeg) + sk * kTile;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kidx = j * 8 + t * 2 + c, key = k0 + kidx;
        float th_a, th_b;
        const float ca = soft_cap(s[4 * j + c], softcap, inv_cap, th_a);
        const float cb = soft_cap(s[4 * j + 2 + c], softcap, inv_cap, th_b);
        bool keep_a = true, keep_b = true;
        if (masked) {
          const int skey = s_seg == nullptr ? 0 : s_seg[kidx];
          keep_a = visible(row_a - key, window, skey == seg_a);
          keep_b = visible(row_b - key, window, skey == seg_b);
        }
        s[4 * j + c] = keep_a ? __expf(ca - lse_a) * (1.f - th_a * th_a) : 0.f;
        s[4 * j + 2 + c] = keep_b ? __expf(cb - lse_b) * (1.f - th_b * th_b) : 0.f;
      }
    }

    // dP = dO_w . V^T, then dS = P (1 - tanh^2) (dP - delta).
    float dp[kTile / 2];
    mbar_wait_fault(&full_v[sv], phv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<kTile>::ss(dp, kstep(do_base, kRows, kk), kstep(v_base, kTile, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dp);
    mbar_arrive(&empty_v[sv]);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      s[4 * j + 0] *= dp[4 * j + 0] - dl_a;
      s[4 * j + 1] *= dp[4 * j + 1] - dl_a;
      s[4 * j + 2] *= dp[4 * j + 2] - dl_b;
      s[4 * j + 3] *= dp[4 * j + 3] - dl_b;
    }
    uint32_t da[kTile / 4];
    to_a_frags<kTile>(da, s);

    // dQ += dS . K (K read MN-major).
    fence_regs(da);
    fence_regs(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc)
      Wgmma<D>::rs_mn(dq_acc, &da[4 * kc], mnstep(k_base, kTile, kc), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    mbar_arrive(&empty_k[sk]);
  }

  if (!real) return;
  const long long stride = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * S * stride + static_cast<long long>(h) * D;
  emit_row<D>(dq + base + row_a * stride + t * 2, dq_acc, 0, 1.f);
  emit_row<D>(dq + base + row_b * stride + t * 2, dq_acc, 1, 1.f);
}

// Tensor maps of q and dO (boxes of `q_rows` positions) and of k and v
// (boxes of 64 keys).
struct Maps {
  CUtensorMap q, k, v, dout;
};

template <int D>
int make_maps(Maps* m, const bf16* q, const bf16* k, const bf16* v, const bf16* dout, int B,
              int S, int H, int q_rows) {
  int err = encode_bshd_map(&m->q, q, B, S, H, D, q_rows);
  if (err == 0) err = encode_bshd_map(&m->k, k, B, S, H, D, kTile);
  if (err == 0) err = encode_bshd_map(&m->v, v, B, S, H, D, kTile);
  if (err == 0 && dout != nullptr) err = encode_bshd_map(&m->dout, dout, B, S, H, D, q_rows);
  return err;
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int D>
int fwd_launch(const bf16* q, const bf16* k, const bf16* v, const int* seg, bf16* o, float* lse,
               int B, int S, int H, int window, float softcap, cudaStream_t stream) {
  Maps m;
  int err = make_maps<D>(&m, q, k, v, nullptr, B, S, H, kRows);
  if (err == 0) err = set_smem(splash_fwd<D>, FwdSmem<D>::kBytes);
  if (err != 0) return err;
  splash_fwd<D><<<dim3((S + kRows - 1) / kRows, B * H), kThreads, FwdSmem<D>::kBytes, stream>>>(
      m.q, m.k, m.v, seg, o, lse, S, H, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_launch(const bf16* q, const bf16* k, const bf16* v, const int* seg, const bf16* o,
               const bf16* dout, const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv,
               int B, int S, int H, int window, float softcap, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * S * H;
  splash_bwd_delta<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      o, dout, delta, S, H, rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  Maps m;
  err = make_maps<D>(&m, q, k, v, dout, B, S, H, kTile);
  if (err == 0) err = set_smem(splash_bwd_dkdv<D>, DkdvSmem<D>::kBytes);
  if (err != 0) return err;
  splash_bwd_dkdv<D><<<dim3(S / kTile, B * H), kThreads, DkdvSmem<D>::kBytes, stream>>>(
      m.q, m.k, m.v, m.dout, seg, lse, delta, dk, dv, S, H, window, softcap);
  err = static_cast<int>(cudaGetLastError());
  if (err == 0) err = make_maps<D>(&m, q, k, v, dout, B, S, H, kRows);
  if (err == 0) err = set_smem(splash_bwd_dq<D>, DqSmem<D>::kBytes);
  if (err != 0) return err;
  splash_bwd_dq<D><<<dim3((S + kRows - 1) / kRows, B * H), kThreads, DqSmem<D>::kBytes,
                     stream>>>(m.q, m.k, m.v, m.dout, seg, lse, delta, dq, S, H, window, softcap);
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
