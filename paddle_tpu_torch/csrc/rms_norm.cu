// RMSNorm forward for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * w,
// row by row over x [N, d], arithmetic in fp32, stored in x's dtype.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/rms_norm.py:_fwd_kernel
// (:63, launched by _rms_fwd_impl :70).  The Pallas kernel normalises a
// block of up to 256 rows per grid step, sequentially on one core; here
// the rows are independent CTAs that run in parallel across the SMs.
//
// Bound: memory.  The function reads x and w once and writes y once,
// (2*N*d + d) * sizeof(T) bytes, at 3.35 TB/s on an H100 SXM; its ~4*N*d
// fp32 operations are far below the card's compute rate.  At decode sizes
// (N = number of serving slots, d = 4096) the bytes are a few hundred KB
// and the launch itself dominates.
//
// Design against that bound: one CTA per row, 16-byte vector loads and
// stores (8 bf16 or 4 fp32 per thread access, consecutive threads on
// consecutive addresses), the sum of squares reduced with warp shuffles
// and one shared-memory pass.  The second pass re-reads the row, which the
// first pass left in L1/L2, so device memory sees x about once.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/rms_norm.py):
//   int ptt_rms_norm_fwd(x, w, y, n, d, eps, dtype, stream)
//   dtype 0 = float32, 1 = bfloat16; requires d % 8 == 0 and 16-byte
//   aligned pointers (the wrapper checks both).  Returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int kN = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int kN = 8; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename T>
__global__ void rms_norm_fwd_kernel(const T* __restrict__ x,
                                    const T* __restrict__ w,
                                    T* __restrict__ y, int d, float eps) {
  constexpr int V = VecWidth<T>::kN;
  const int nvec = d / V;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)blockIdx.x * d);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)blockIdx.x * d);

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    uint4 raw = xr[i];
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f32(v[j]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);

  __shared__ float warp_sums[32];
  __shared__ float row_rrms;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float t = lane < nwarps ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) row_rrms = rsqrtf(t / (float)d + eps);
  }
  __syncthreads();
  const float r = row_rrms;

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    uint4 xraw = xr[i];
    uint4 wraw = wr[i];
    const T* xv = reinterpret_cast<const T*>(&xraw);
    const T* wv = reinterpret_cast<const T*>(&wraw);
    uint4 oraw;
    T* ov = reinterpret_cast<T*>(&oraw);
#pragma unroll
    for (int j = 0; j < V; ++j) ov[j] = from_f32<T>(to_f32(xv[j]) * r * to_f32(wv[j]));
    yr[i] = oraw;
  }
}

template <typename T>
void launch(const void* x, const void* w, void* y, int n, int d, float eps,
            cudaStream_t stream) {
  const int nvec = d / VecWidth<T>::kN;
  int threads = ((nvec + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  rms_norm_fwd_kernel<T><<<n, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      d, eps);
}

}  // namespace

extern "C" int ptt_rms_norm_fwd(const void* x, const void* w, void* y, int n,
                                int d, float eps, int dtype, void* stream) {
  if (n <= 0 || d <= 0 || d % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, w, y, n, d, eps, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, y, n, d, eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
