// Fused AdamW update for Hopper (sm_90a): one pass over a parameter that
// reads p, g, m and v once and writes p, m and v in place, with bf16
// moments stored by stochastic rounding when a seed is given.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_optimizer.py:
// _adamw_kernel (:71; launched by _adamw_call_2d :150 on the parameter's
// own 2-D layout and by _adamw_call :181 on a flat [rows, 512] view).
//
// Arithmetic, as _adamw_math (:44-58), every operation one fp32 IEEE op
// rounded to nearest (the __f*_rn intrinsics: nvcc would otherwise
// contract a*b+c into an FMA, and the plain PyTorch version, one kernel
// per operation, never does):
//   p' = p * (1 - lr*wd)                   decoupled decay, first
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + ((1-b2)*g)*g
//   p'' = p' - (lr * (m'/bc1)) / (sqrt(v'/bc2) + eps)
// where bc1 = 1 - exp(t*log(b1)) and bc2 = 1 - exp(t*log(b2)) (0 for a
// beta of 0), the reference's exp/log form of beta**t.  The caller
// computes lr, bc1 and bc2 once per call in PyTorch on the device and
// passes them as three fp32 values in device memory; b1, 1-b1, b2, 1-b2,
// eps and wd arrive as fp32 scalars, rounded from the Python doubles as
// PyTorch rounds a Python scalar.  p'' is stored in p's dtype by round to
// nearest even.  A bf16 m' or v' is stored by stochastic rounding when
// `sr` is set (the reference's _store :61 with pltpu.stochastic_round):
//   bits = (f32 bits of x + (noise & 0xFFFF)) & 0xFFFF0000, then bf16,
// and by round to nearest even otherwise.
//
// Noise.  The TPU draws fresh hardware random bits per element and block
// (prng_random_bits, :63-65); those bits cannot be reproduced here.  This
// kernel draws them from a counter hash of (seed, counter) built from
// 32-bit multiply, xor and shift only (two rounds of the "lowbias32"
// finalizer): noise = mix(mix(c ^ k) + k) with k = mix(seed), and
// counter c = 2*i for m and 2*i + 1 for v at flat element index i.  The
// plain version computes the same hash with PyTorch integer ops, so the
// two draw identical noise and agree bit for bit.
//
// Bound: bytes.  Each element reads p, g, m, v and writes p, m, v: with
// bf16 p and g, 12 B read and 10 B written with fp32 moments, 8 and 6
// with bf16 moments; the ~20 fp32 operations per element are far below
// the card's rate.  Design: one thread per element, one CTA of 256
// threads per 256 elements, plain loads and stores: a simple kernel that
// is right first; wider vector accesses are the next step.  The TPU kernel's
// block shapes, its flat/2-D split and its tiling gate are TPU layout
// choices and have no counterpart: this kernel takes any shape.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/fused_optimizer.py):
//   int ptt_fused_adamw(p, g, m, v, scalars, n, b1, omb1, b2, omb2, eps,
//                       wd, sr, seed, p_dtype, m_dtype, stream)
//   scalars: 3 fp32 in device memory (lr, bc1, bc2); n < 2**31 elements;
//   g in p's dtype, v in m's dtype; dtype 0 = float32, 1 = bfloat16.
//   Returns cudaGetLastError().

#include "dtype.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using ptt::from_f32;
using ptt::to_f32;

constexpr int kThreads = 256;

// "lowbias32": a bijection of 32-bit integers with good avalanche.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t noise32(uint32_t k, uint32_t c) {
  return mix32(mix32(c ^ k) + k);
}

template <typename M>
__device__ __forceinline__ M store_moment(float x, int sr, uint32_t k,
                                          uint32_t c);

template <>
__device__ __forceinline__ float store_moment<float>(float x, int, uint32_t,
                                                     uint32_t) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 store_moment<__nv_bfloat16>(
    float x, int sr, uint32_t k, uint32_t c) {
  if (!sr) return __float2bfloat16(x);
  const uint32_t bits =
      (__float_as_uint(x) + (noise32(k, c) & 0xFFFFu)) & 0xFFFF0000u;
  return __float2bfloat16(__uint_as_float(bits));   // exact: low bits zero
}

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;
};

template <typename P, typename M>
__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(P* __restrict__ p, const P* __restrict__ g,
                   M* __restrict__ m, M* __restrict__ v,
                   const float* __restrict__ scalars, int n, Hyper h,
                   int sr, uint32_t seed) {
  const float lr = scalars[0];
  const float bc1 = scalars[1];
  const float bc2 = scalars[2];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float decay = __fsub_rn(1.f, __fmul_rn(lr, h.wd));
  const float pf = __fmul_rn(to_f32(p[i]), decay);
  const float gf = to_f32(g[i]);
  const float mn = __fadd_rn(__fmul_rn(h.b1, to_f32(m[i])),
                             __fmul_rn(h.omb1, gf));
  const float vn = __fadd_rn(__fmul_rn(h.b2, to_f32(v[i])),
                             __fmul_rn(__fmul_rn(h.omb2, gf), gf));
  const float mh = __fdiv_rn(mn, bc1);
  const float vh = __fdiv_rn(vn, bc2);
  const float den = __fadd_rn(__fsqrt_rn(vh), h.eps);
  p[i] = from_f32<P>(__fsub_rn(pf, __fdiv_rn(__fmul_rn(lr, mh), den)));
  const uint32_t k = mix32(seed);
  m[i] = store_moment<M>(mn, sr, k, 2u * (uint32_t)i);
  v[i] = store_moment<M>(vn, sr, k, 2u * (uint32_t)i + 1u);
}

template <typename P, typename M>
int launch(void* p, const void* g, void* m, void* v, const float* scalars,
           int n, Hyper h, int sr, uint32_t seed, cudaStream_t stream) {
  const int blocks = (int)(((long long)n + kThreads - 1) / kThreads);
  fused_adamw_kernel<P, M><<<blocks, kThreads, 0, stream>>>(
      static_cast<P*>(p), static_cast<const P*>(g), static_cast<M*>(m),
      static_cast<M*>(v), scalars, n, h, sr, seed);
  return (int)cudaGetLastError();
}

template <typename P>
int launch_m(void* p, const void* g, void* m, void* v, const float* scalars,
             int n, Hyper h, int sr, uint32_t seed, int m_dtype,
             cudaStream_t stream) {
  if (m_dtype == 0)
    return launch<P, float>(p, g, m, v, scalars, n, h, sr, seed, stream);
  if (m_dtype == 1)
    return launch<P, __nv_bfloat16>(p, g, m, v, scalars, n, h, sr, seed,
                                    stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ptt_fused_adamw(void* p, const void* g, void* m, void* v,
                               const void* scalars, int n, float b1,
                               float omb1, float b2, float omb2, float eps,
                               float wd, int sr, unsigned int seed,
                               int p_dtype, int m_dtype, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  const float* sc = static_cast<const float*>(scalars);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p_dtype == 0)
    return launch_m<float>(p, g, m, v, sc, n, h, sr, seed, m_dtype, st);
  if (p_dtype == 1)
    return launch_m<__nv_bfloat16>(p, g, m, v, sc, n, h, sr, seed, m_dtype,
                                   st);
  return (int)cudaErrorInvalidValue;
}
