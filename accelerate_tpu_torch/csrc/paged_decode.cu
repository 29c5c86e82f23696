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
//         pool dequantizes each row as float(q8) * row_scale, the expression
//         of dequantize_kv, and the dot stays f32;
//   softcap: s_j = cap * tanh(s_j / cap);
//   bias: -1e30 where q_pos - j < 0 or the key is outside the window, plus
//         -1e30 where the pool mask is 0, ADDED as the plain version adds
//         them, so a fully masked row gives the plain version's uniform
//         answer; windows count valid slots when a mask is given (ranks are
//         the inclusive prefix sum of the chain's mask, q_rank = rank[q_pos]);
//   p = softmax(s) exactly (max, exp, sum, divide) in f32, rounded to q's
//   type; out = sum_j p_j v_j in f32, cast to the output type (bf16 for bf16
//   q on a bf16 pool, f32 otherwise). A slot with active[b] == 0 walks
//   nothing and gets zeros.
// The sums run in another order than the plain version's GEMMs, so the two
// agree to a tolerance, not bitwise.
//
// Bound: memory. A decode step (S = 1) does 4 * G * D operations per key
// and head against 2 * D bytes of K and V (bf16): about 2 operations a
// byte, far below the card's 295. The least traffic is every pool block the
// active slots' chains name, read once (plus its scales when quantized).
//
// Design: one CTA of 256 threads per (slot, query head, query), grid
// (B, H, S): a decode step has few slots, and a CTA for each query head
// gives the card H times as many CTAs as slots, while the G CTAs of one KV
// head read the same K and V rows, mostly from L2. The CTA first resolves
// each key's pool row through the table (one division a key) into shared
// memory, with the valid-slot ranks when a window meets a mask. Scores:
// each thread takes its own keys (tid, tid + 256, ...) and runs the dot
// product over D, four elements a load (16, 8 or 4 bytes), the query row
// broadcast from shared memory: no shuffles, 256 keys in flight. The T
// scores live in shared memory (the wrapper refuses a chain that does not
// fit; it never truncates). Softmax: block reductions. P.V: a thread owns
// four adjacent columns of D and one of 1024 / D interleaved parts of the
// chain, so a warp reads whole V rows; the parts are summed through shared
// memory. Both walks are unrolled so that a thread keeps 8-16 loads in
// flight: a walk that waits for each load in turn is bound by the memory
// latency, not its bandwidth. Splitting a long chain over several CTAs
// (flash-decoding) and staging blocks with cp.async are later work.
//
// Interface: a plain C function bound with ctypes
// (accelerate_tpu_torch/ops/kernels/paged_decode.py). It launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
struct IsBf16 {
  static constexpr bool value = false;
};
template <>
struct IsBf16<bf16> {
  static constexpr bool value = true;
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

// Four adjacent elements as f32, in one load of 16, 8 or 4 bytes (the
// wrapper checks the alignment).
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
__device__ __forceinline__ void load4(const int8_t* p, float (&v)[4]) {
  const char4 t = *reinterpret_cast<const char4*>(p);
  v[0] = static_cast<float>(t.x);
  v[1] = static_cast<float>(t.y);
  v[2] = static_cast<float>(t.z);
  v[3] = static_cast<float>(t.w);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = fmaxf(v, red[w]);
  __syncthreads();
  return v;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v += red[w];
  __syncthreads();
  return v;
}

struct Params {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;  // (N, bs) for an int8 pool, else null
  const int32_t* tables;           // (B, M)
  const int32_t* pos;              // (B, S)
  const int32_t* mask;             // (N, bs) or null
  const uint8_t* active;           // (B,)
  void* out;                       // (B, S, H, D)
  int B, S, H, Hkv, D, N, bs, M;
  int has_window, window;
  float softcap;  // 0 = off
  float scale;
};

// Shared memory: the query row (D f32), the chain's scores (T f32), the
// P.V parts (1024 f32), each key's pool row (T int32), then the ranks
// (T int32) when a window meets a mask.
template <typename QT, typename KVT>
__global__ void __launch_bounds__(kThreads) paged_decode(const Params p) {
  typedef typename OutOf<QT, KVT>::type OutT;
  constexpr bool kRoundScores = IsBf16<QT>::value && IsBf16<KVT>::value;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kWarps];
  const int b = blockIdx.x, hq = blockIdx.y, s = blockIdx.z;
  const int h = hq / (p.H / p.Hkv), D = p.D, T = p.M * p.bs, tid = threadIdx.x;
  const long long head = ((static_cast<long long>(b) * p.S + s) * p.H + hq) * D;
  OutT* out = static_cast<OutT*>(p.out) + head;
  if (!p.active[b]) {
    for (int i = tid; i < D; i += kThreads) store(out + i, 0.f);
    return;
  }
  float* qs = smem;
  float* sc = qs + D;
  float* part = sc + T;
  int* rows = reinterpret_cast<int*>(part + 4 * kThreads);
  int* rank = rows + T;
  const QT* q = static_cast<const QT*>(p.q) + head;
  for (int i = tid; i < D; i += kThreads) qs[i] = to_float(q[i]);
  const int32_t* table = p.tables + static_cast<long long>(b) * p.M;
  for (int j = tid; j < T; j += kThreads) {
    const int blk = table[j / p.bs];
    if (blk < 0 || blk >= p.N) __trap();  // a table entry outside the pool is a caller bug
    rows[j] = blk * p.bs + j % p.bs;
  }
  __syncthreads();
  const int q_pos = p.pos[static_cast<long long>(b) * p.S + s];
  const bool use_rank = p.has_window && p.mask != nullptr;
  if (use_rank) {  // inclusive prefix sum of the chain's mask, in 256 chunks
    int* scan = reinterpret_cast<int*>(part);
    const int per = (T + kThreads - 1) / kThreads;
    const int j0 = min(T, tid * per), j1 = min(T, j0 + per);
    int sum = 0;
    for (int j = j0; j < j1; ++j) sum += p.mask[rows[j]];
    scan[tid] = sum;
    __syncthreads();
    if (tid == 0) {
      int run = 0;
      for (int i = 0; i < kThreads; ++i) {
        const int v = scan[i];
        scan[i] = run;
        run += v;
      }
    }
    __syncthreads();
    int run = scan[tid];
    for (int j = j0; j < j1; ++j) {
      run += p.mask[rows[j]];
      rank[j] = run;
    }
    __syncthreads();
  }
  int q_rank = 0;
  if (use_rank) {
    if (q_pos < 0 || q_pos >= T) __trap();  // the plain version's gather refuses it too
    q_rank = rank[q_pos];
  }
  const KVT* kp = static_cast<const KVT*>(p.k);
  const KVT* vp = static_cast<const KVT*>(p.v);

  // Scores, one key a thread at a time.
  for (int j = tid; j < T; j += kThreads) {
    const long long row = rows[j];
    const KVT* krow = kp + (row * p.Hkv + h) * D;
    const float ks = p.k_scale != nullptr ? p.k_scale[row] : 1.f;
    float acc = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; d += 4) {
      float kv[4];
      load4(krow + d, kv);
      if (p.k_scale != nullptr) {
#pragma unroll
        for (int e = 0; e < 4; ++e) kv[e] = __fmul_rn(kv[e], ks);
      }
      const float4 qv = *reinterpret_cast<const float4*>(qs + d);
      acc = fmaf(qv.x, kv[0], acc);
      acc = fmaf(qv.y, kv[1], acc);
      acc = fmaf(qv.z, kv[2], acc);
      acc = fmaf(qv.w, kv[3], acc);
    }
    const int delta = q_pos - j;
    bool keep = delta >= 0;
    if (p.has_window) keep = keep && (use_rank ? q_rank - rank[j] : delta) < p.window;
    float bias = keep ? 0.f : kNeg;
    if (p.mask != nullptr) bias = __fadd_rn(bias, p.mask[row] != 0 ? 0.f : kNeg);
    float v = kRoundScores ? round_bf16(acc) : acc;
    v = __fmul_rn(v, p.scale);
    if (p.softcap > 0.f) v = __fmul_rn(tanhf(__fdiv_rn(v, p.softcap)), p.softcap);
    sc[j] = __fadd_rn(v, bias);
  }
  __syncthreads();

  // Exact softmax; probabilities rounded to q's type.
  float mx = -INFINITY;
  for (int j = tid; j < T; j += kThreads) mx = fmaxf(mx, sc[j]);
  mx = block_max(mx, red);
  float sum = 0.f;
  for (int j = tid; j < T; j += kThreads) {
    const float e = expf(__fsub_rn(sc[j], mx));
    sc[j] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  for (int j = tid; j < T; j += kThreads) {
    const float pj = __fdiv_rn(sc[j], sum);
    sc[j] = IsBf16<QT>::value ? round_bf16(pj) : pj;
  }
  __syncthreads();

  // P.V: thread (part, c) owns columns 4c..4c+3 and keys part, part + parts, ...
  const int chunks = D / 4, parts = kThreads / chunks, c = tid % chunks, part_id = tid / chunks;
  float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int j = part_id; j < T; j += parts) {
    const long long row = rows[j];
    float vv[4];
    load4(vp + (row * p.Hkv + h) * D + 4 * c, vv);
    if (p.v_scale != nullptr) {
      const float vs = p.v_scale[row];
#pragma unroll
      for (int e = 0; e < 4; ++e) vv[e] = __fmul_rn(vv[e], vs);
    }
    const float pj = sc[j];
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = fmaf(pj, vv[e], o[e]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) part[part_id * D + 4 * c + e] = o[e];
  __syncthreads();
  for (int i = tid; i < D; i += kThreads) {
    float total = 0.f;
    for (int sp = 0; sp < parts; ++sp) total += part[sp * D + i];
    store(out + i, total);
  }
}

template <typename QT, typename KVT>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kernel = paged_decode<QT, KVT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(p.B, p.H, p.S);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q_kind: 0 = float32, 1 = bfloat16. kv_kind: 0 = float32, 1 = bfloat16,
// 2 = int8 with k_scale/v_scale. mask may be null. The wrapper checks that
// D is a multiple of 4 with D / 4 dividing 256, that the pools are aligned
// for 4-element loads, that Hkv divides H and that `smem` bytes fit.
int paged_decode_launch(int q_kind, int kv_kind, const void* q, const void* k, const void* v,
                        const void* k_scale, const void* v_scale, const void* tables,
                        const void* pos, const void* mask, const void* active, void* out, int B,
                        int S, int H, int Hkv, int D, int N, int bs, int M, int has_window,
                        int window, float softcap, float scale, long long smem, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int32_t*>(tables);
  p.pos = static_cast<const int32_t*>(pos);
  p.mask = static_cast<const int32_t*>(mask);
  p.active = static_cast<const uint8_t*>(active);
  p.out = out;
  p.B = B;
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.D = D;
  p.N = N;
  p.bs = bs;
  p.M = M;
  p.has_window = has_window;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
  const int key = q_kind * 3 + kv_kind;
  switch (key) {
    case 0:
      return launch<float, float>(p, bytes, s);
    case 1:
      return launch<float, bf16>(p, bytes, s);
    case 2:
      return launch<float, int8_t>(p, bytes, s);
    case 3:
      return launch<bf16, float>(p, bytes, s);
    case 4:
      return launch<bf16, bf16>(p, bytes, s);
    case 5:
      return launch<bf16, int8_t>(p, bytes, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
