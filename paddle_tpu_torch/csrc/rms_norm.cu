// RMSNorm forward for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * w,
// row by row over x [N, d], arithmetic in fp32, stored in x's dtype.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/rms_norm.py:_fwd_kernel
// (:63, launched by _rms_fwd_impl :70).  The Pallas kernel normalises a
// block of up to 256 rows per grid step, sequentially on one core; here
// rows are spread over the SMs.
//
// Bound: memory.  The function reads x and w once and writes y once,
// (2*N*d + d) * sizeof(T) bytes, at 3.35 TB/s on an H100 SXM; its ~4*N*d
// fp32 operations are far below the card's compute rate.  At decode sizes
// (N = number of serving slots, d = 4096) the bytes are a few hundred KB
// and the launch and one memory round trip are the time.
//
// Design against that bound: one pass, the row in registers, one memory
// round trip.
//   - A row is one CTA of `wr` warps (the wrapper's rms_norm_plan, a
//     function of d and the dtype alone).  Lane l of warp q holds the
//     16-byte vectors (k*wr + q)*32 + l, k < K, of the row (8 bf16 or 4
//     fp32 each; K <= 8, wr <= 16): for each k the warps read wr*512
//     consecutive bytes.
//   - Each thread issues its K loads of x and its K loads of w together
//     (w stays in L1 for the rows that follow), reduces, then scales the
//     x still in registers and stores: x is read once.  The plan takes
//     K = 2 (d = 4096 bf16: 8 warps), which gave the shortest decode
//     launch; the grid is N CTAs, one row each, so the hardware balances
//     the rows over the SMs at large N.
//   - The sum of squares is fixed by d: each lane keeps one fp32 fma
//     chain per element position j over its vectors k, adds the chains in
//     a pairwise tree over j, a butterfly of xor shuffles (16, 8, 4, 2, 1)
//     sums the warp's lanes, and with wr > 1 every thread adds the wr warp
//     sums in the order 0 .. wr-1 through shared memory (one
//     __syncthreads; none when wr == 1).  So a row's bits depend on d and
//     the dtype, never on N.
//   - Short chains (K fmas, then log2 of the vector width adds) keep the
//     latency of a decode launch (N = 8) low.
// At N = 16384, d = 2048 it moves the bytes as fast as torch's own copy of
// x does (PERF.md): what is left is the card's streaming rate.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/rms_norm.py):
//   int ptt_rms_norm_fwd(x, w, y, n, d, eps, dtype, wr, k, stream)
//   dtype 0 = float32, 1 = bfloat16; requires d % 8 == 0, 16-byte aligned
//   pointers (the wrapper checks both), 1 <= wr <= 16, 1 <= k <= 8 and
//   wr*32*k >= d / (16 / sizeof(T)).  Returns cudaGetLastError().

#include "dtype.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using ptt::from_f32;
using ptt::to_f32;

constexpr int kMaxWarps = 16;  // warps a row at most: 512 threads a CTA

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int kN = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int kN = 8; };

template <typename T, int K>
__global__ void __launch_bounds__(kMaxWarps * 32)
rms_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, int d, float eps) {
  constexpr int V = VecWidth<T>::kN;
  const int nvec = d / V;
  const int lane = threadIdx.x & 31;
  const int q = threadIdx.x >> 5;
  const int wr = blockDim.x >> 5;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)blockIdx.x * d);
  const uint4* w4 = reinterpret_cast<const uint4*>(w);

  uint4 xv[K], wv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = (k * wr + q) * 32 + lane;
    xv[k] = i < nvec ? xr[i] : zero;
    wv[k] = i < nvec ? w4[i] : zero;
  }
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T* v = reinterpret_cast<const T*>(&xv[k]);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f32(v[j]);
      acc[j] = __fmaf_rn(f, f, acc[j]);
    }
  }
#pragma unroll
  for (int st = 1; st < V; st <<= 1) {
#pragma unroll
    for (int j = 0; j < V; j += 2 * st)
      acc[j] = __fadd_rn(acc[j], acc[j + st]);
  }
  float ss = acc[0];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (wr > 1) {  // uniform over the CTA
    __shared__ float warp_sums[kMaxWarps];
    if (lane == 0) warp_sums[q] = ss;
    __syncthreads();
    ss = 0.f;
    for (int p = 0; p < wr; ++p) ss += warp_sums[p];
  }
  const float r = rsqrtf(ss / (float)d + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)blockIdx.x * d);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = (k * wr + q) * 32 + lane;
    if (i < nvec) {
      const T* xe = reinterpret_cast<const T*>(&xv[k]);
      const T* we = reinterpret_cast<const T*>(&wv[k]);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < V; ++j)
        oe[j] = from_f32<T>(to_f32(xe[j]) * r * to_f32(we[j]));
      yr[i] = o;
    }
  }
}

template <typename T, int K>
void launch(const void* x, const void* w, void* y, int n, int d, float eps,
            int wr, cudaStream_t stream) {
  rms_norm_fwd_kernel<T, K><<<n, wr * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      d, eps);
}

template <typename T>
int dispatch(const void* x, const void* w, void* y, int n, int d, float eps,
             int wr, int k, cudaStream_t s) {
  if ((long long)wr * 32 * k < d / VecWidth<T>::kN)
    return (int)cudaErrorInvalidValue;
  switch (k) {
    case 1: launch<T, 1>(x, w, y, n, d, eps, wr, s); break;
    case 2: launch<T, 2>(x, w, y, n, d, eps, wr, s); break;
    case 3: launch<T, 3>(x, w, y, n, d, eps, wr, s); break;
    case 4: launch<T, 4>(x, w, y, n, d, eps, wr, s); break;
    case 5: launch<T, 5>(x, w, y, n, d, eps, wr, s); break;
    case 6: launch<T, 6>(x, w, y, n, d, eps, wr, s); break;
    case 7: launch<T, 7>(x, w, y, n, d, eps, wr, s); break;
    case 8: launch<T, 8>(x, w, y, n, d, eps, wr, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" int ptt_rms_norm_fwd(const void* x, const void* w, void* y, int n,
                                int d, float eps, int dtype, int wr, int k,
                                void* stream) {
  if (n <= 0 || d <= 0 || d % 8 != 0 || wr < 1 || wr > kMaxWarps ||
      (((uintptr_t)x | (uintptr_t)w | (uintptr_t)y) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = dispatch<float>(x, w, y, n, d, eps, wr, k, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(x, w, y, n, d, eps, wr, k, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
}
