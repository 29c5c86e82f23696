// Fused optimizer update for Hopper (sm_90a): clip scale + moments + update
// rule + weight decay + learning-rate scale + apply, and the accumulation
// buffer's reset, in one pass over a parameter leaf.
//
// Replaces the TPU kernel _fused_leaf_call (accelerate_tpu/ops/pallas/
// fused_update.py:200, pallas_call at :254; kernel names
// fused_{sgd,sgd_momentum,adam,adamw}_update_kernel), one launch per leaf as
// the JAX code does.
//
// What it computes, per element, in the op order of the JAX package's
// _leaf_math (fused_update.py:164-190), which is optax's:
//   adam(w):  g *= factor; mu = (1-b1)*g + b1*mu; nu = (1-b2)*(g*g) + b2*nu;
//             u = (mu/bc1) / (sqrt(nu/bc2 + eps_root) + eps); [u += wd*p];
//             u = step_size*u; p = p + u
//   sgd:      g *= factor; p = p + step_size*g
//   momentum: g *= factor; trace = g + momentum*trace; p = p + step_size*trace
// and the accumulation buffer g is zeroed. p and the moments are updated in
// place (the JAX kernel's outputs are donated buffers). Every step is one
// correctly rounded f32 operation (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn), so nvcc cannot contract a multiply and an add into an FMA and
// the kernel is bitwise equal to the plain PyTorch version, which runs each
// operation as its own rounded kernel. The clip factor and the bias
// corrections bc1, bc2 are device scalars read through pointers: the host
// never waits for the global norm.
//
// Bound: memory. adam(w) reads p, mu, nu, g and writes p, mu, nu and the
// zeroed g: 8 f32 streams, 32 bytes per element (sgd 16, momentum 24). At
// the largest Llama-3-8B leaf (the embedding or LM head, 128256 x 4096 =
// 525M elements) that is 16.8 GB, 5.02 ms at 3.35 TB/s (H100 SXM data
// sheet); about 30 f32 operations per element are far below the card's
// 67 TFLOP/s.
//
// Design: a grid-stride loop over float4 vectors (16-byte loads and stores,
// neighbouring threads on neighbouring addresses), with a scalar tail for a
// length that is not a multiple of 4. The wrapper checks 16-byte alignment.
//
// Interface: plain C functions bound with ctypes
// (accelerate_tpu_torch/ops/kernels/fused_update.py). Each launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

enum Kind { kSgd = 0, kSgdMomentum = 1, kAdam = 2 };

struct Hyper {
  float one_minus_b1, b1, one_minus_b2, b2, eps, eps_root, wd, step_size, momentum;
  int has_wd;
};

template <int KIND>
__device__ __forceinline__ void update(float& p, float& s1, float& s2, float& g, float factor,
                                       float bc1, float bc2, const Hyper& hp) {
  const float gs = __fmul_rn(g, factor);
  float u;
  if (KIND == kAdam) {
    const float mu = __fadd_rn(__fmul_rn(hp.one_minus_b1, gs), __fmul_rn(hp.b1, s1));
    const float nu = __fadd_rn(__fmul_rn(hp.one_minus_b2, __fmul_rn(gs, gs)), __fmul_rn(hp.b2, s2));
    const float mu_hat = __fdiv_rn(mu, bc1);
    const float nu_hat = __fdiv_rn(nu, bc2);
    u = __fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(__fadd_rn(nu_hat, hp.eps_root)), hp.eps));
    if (hp.has_wd) u = __fadd_rn(u, __fmul_rn(hp.wd, p));
    s1 = mu;
    s2 = nu;
  } else if (KIND == kSgdMomentum) {
    u = __fadd_rn(gs, __fmul_rn(hp.momentum, s1));
    s1 = u;
  } else {
    u = gs;
  }
  p = __fadd_rn(p, __fmul_rn(hp.step_size, u));
  g = 0.f;
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
    fused_update(float* __restrict__ p, float* __restrict__ s1, float* __restrict__ s2,
                 float* __restrict__ g, long long n, const float* __restrict__ factor_ptr,
                 const float* __restrict__ bc1_ptr, const float* __restrict__ bc2_ptr, Hyper hp) {
  const float factor = *factor_ptr;
  const float bc1 = KIND == kAdam ? *bc1_ptr : 1.f;
  const float bc2 = KIND == kAdam ? *bc2_ptr : 1.f;
  const long long n4 = n / 4;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float4 dummy = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = first; i < n4; i += step) {
    float4 pv = reinterpret_cast<const float4*>(p)[i];
    float4 gv = reinterpret_cast<const float4*>(g)[i];
    float4 av = KIND == kSgd ? dummy : reinterpret_cast<const float4*>(s1)[i];
    float4 bv = KIND == kAdam ? reinterpret_cast<const float4*>(s2)[i] : dummy;
    update<KIND>(pv.x, av.x, bv.x, gv.x, factor, bc1, bc2, hp);
    update<KIND>(pv.y, av.y, bv.y, gv.y, factor, bc1, bc2, hp);
    update<KIND>(pv.z, av.z, bv.z, gv.z, factor, bc1, bc2, hp);
    update<KIND>(pv.w, av.w, bv.w, gv.w, factor, bc1, bc2, hp);
    reinterpret_cast<float4*>(p)[i] = pv;
    reinterpret_cast<float4*>(g)[i] = gv;
    if (KIND != kSgd) reinterpret_cast<float4*>(s1)[i] = av;
    if (KIND == kAdam) reinterpret_cast<float4*>(s2)[i] = bv;
  }
  for (long long i = n4 * 4 + first; i < n; i += step) {
    float a = KIND == kSgd ? 0.f : s1[i];
    float b = KIND == kAdam ? s2[i] : 0.f;
    update<KIND>(p[i], a, b, g[i], factor, bc1, bc2, hp);
    if (KIND != kSgd) s1[i] = a;
    if (KIND == kAdam) s2[i] = b;
  }
}

}  // namespace

extern "C" {

// kind: 0 = sgd, 1 = sgd with momentum (s1 = trace), 2 = adam (s1 = mu,
// s2 = nu; weight decay when has_wd). p, s1, s2, g: n f32 each, 16-byte
// aligned; factor, bc1, bc2: f32 device scalars (bc1, bc2 read for adam only).
int fused_update_launch(int kind, void* p, void* s1, void* s2, void* g, long long n,
                        const void* factor, const void* bc1, const void* bc2, float one_minus_b1,
                        float b1, float one_minus_b2, float b2, float eps, float eps_root,
                        int has_wd, float wd, float step_size, float momentum, void* stream) {
  if (n <= 0) return 0;
  const Hyper hp{one_minus_b1, b1, one_minus_b2, b2, eps, eps_root, wd, step_size, momentum,
                 has_wd};
  const long long vecs = (n + 3) / 4;
  const long long want = (vecs + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(p);
  float* a = static_cast<float*>(s1);
  float* b = static_cast<float*>(s2);
  float* gg = static_cast<float*>(g);
  const float* f = static_cast<const float*>(factor);
  const float* c1 = static_cast<const float*>(bc1);
  const float* c2 = static_cast<const float*>(bc2);
  switch (kind) {
    case kSgd:
      fused_update<kSgd><<<blocks, kThreads, 0, s>>>(pp, a, b, gg, n, f, c1, c2, hp);
      break;
    case kSgdMomentum:
      fused_update<kSgdMomentum><<<blocks, kThreads, 0, s>>>(pp, a, b, gg, n, f, c1, c2, hp);
      break;
    case kAdam:
      fused_update<kAdam><<<blocks, kThreads, 0, s>>>(pp, a, b, gg, n, f, c1, c2, hp);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fused_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
