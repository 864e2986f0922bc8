// Half-split rotary position embedding (RoPE) for Hopper (sm_90a):
//   y1 = x1*cos - x2*sin,  y2 = x2*cos + x1*sin
// with x = [x1 | x2] split at D/2 along the last axis, arithmetic in fp32,
// stored in x's dtype.  The backward of the rotation is the same kernel
// with -sin (rotations are orthogonal), selected by `sign`.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/rope.py:_rope_kernel (:41,
// launched by _rope_call :58; its vjp _rope_bwd :94 calls it with -sin).
// The Pallas kernel tiles the sequence into VMEM-sized blocks per grid
// step (the D >= 64 and block gates at :22-38 are TPU tiling rules); here
// every (row, pair) is an independent thread, so any even D is taken.
//
// Shapes (row-major, contiguous):
//   x, y      [B, S, H, D]     float32 or bfloat16
//   cos, sin  [S, D/2]         float32 (the [1, S, 1, D/2] tables, squeezed)
//
// Bound: memory.  The function reads x once and writes y once,
// 2*B*S*H*D*sizeof(T) bytes (the tables, S*D*4 bytes, are small and stay
// in L2), at 3.35 TB/s on an H100 SXM; ~3 fp32 operations per element are
// far below any compute rate.
//
// Design against that bound: one thread per rotation pair (i, i + D/2) of
// one row; consecutive threads take consecutive i, so the loads of x1, of
// x2 and of the tables are coalesced.  Products and sums are rounded one
// by one (__fmul_rn/__fadd_rn: no fused multiply-add contraction), so the
// kernel rounds exactly as the plain PyTorch version does.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/rope.py):
//   int ptt_rope(x, cos, sin, y, rows, S, H, D, sign, dtype, stream)
//   rows = B*S*H; dtype 0 = float32, 1 = bfloat16; sign +1 forward, -1
//   backward.  Returns cudaGetLastError().

#include "dtype.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using ptt::from_f32;
using ptt::to_f32;

template <typename T>
__global__ void rope_kernel(const T* __restrict__ x,
                            const float* __restrict__ cos_t,
                            const float* __restrict__ sin_t,
                            T* __restrict__ y, long long total, int S, int H,
                            int half, float sign) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const long long row = idx / half;          // (b, s, h) flattened
    const int i = (int)(idx - row * half);
    const int s = (int)((row / H) % S);
    const long long base = row * 2 * half;
    const float x1 = to_f32(x[base + i]);
    const float x2 = to_f32(x[base + half + i]);
    const float c = cos_t[(long long)s * half + i];
    const float sn = sign * sin_t[(long long)s * half + i];
    const float y1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, sn));
    const float y2 = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, sn));
    y[base + i] = from_f32<T>(y1);
    y[base + half + i] = from_f32<T>(y2);
  }
}

template <typename T>
void launch(const void* x, const void* c, const void* s, void* y,
            long long rows, int S, int H, int D, float sign,
            cudaStream_t stream) {
  const int half = D / 2;
  const long long total = rows * half;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond this
  rope_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(c),
      static_cast<const float*>(s), static_cast<T*>(y), total, S, H, half,
      sign);
}

}  // namespace

extern "C" int ptt_rope(const void* x, const void* c, const void* s, void* y,
                        long long rows, int S, int H, int D, float sign,
                        int dtype, void* stream) {
  if (rows <= 0 || S <= 0 || H <= 0 || D <= 0 || D % 2 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, c, s, y, rows, S, H, D, sign, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, c, s, y, rows, S, H, D, sign, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
