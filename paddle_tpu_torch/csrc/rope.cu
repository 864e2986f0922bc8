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
// any even D is taken.
//
// Shapes (row-major, contiguous):
//   x, y      [B, S, H, D]     float32 or bfloat16
//   cos, sin  [S, D/2]         float32 (the [1, S, 1, D/2] tables, squeezed)
//
// Bound: memory.  The function reads x once and writes y once,
// 2*B*S*H*D*sizeof(T) bytes, plus the tables once, 2*S*(D/2)*4 bytes, at
// 3.35 TB/s on an H100 SXM; ~3 fp32 operations per element are far below
// any compute rate.
//
// Design against that bound.  A thread owns `vec` consecutive rotation
// pairs (i .. i+vec-1, i + D/2 .. i + D/2 + vec-1) of one head h at one
// position s, and walks the B rows (b, s, h) that share them:
//   - vector route (vec = 8 for bf16, 4 for fp32; needs (D/2) % vec == 0
//     and 16-byte aligned operands): x1 and x2 of a row are one 16-byte
//     load each, kept packed in registers, y1 and y2 one 16-byte store
//     each;
//   - element route (vec = 1): any even D, 2- or 4-byte accesses.
//   - The thread loads its vec cos and vec sin values once and keeps them
//     in registers for all B rows, so the tables cost 8*vec bytes per B
//     rows instead of per row.
//   - Rows are taken kRowUnroll at a time: all their loads are issued
//     before the first store, so each thread keeps 2*kRowUnroll
//     independent loads in flight.
//   - Indices come from the block shape alone: block (px, hb, sy) covers
//     px pair groups of hb heads at sy positions, grid (ceil(S/sy),
//     ceil(H/hb)); there is no division, and the row walk is a pointer
//     stride of S*H*D elements.  The wrapper's rope_plan picks the shape.
// Products and sums are rounded one by one (__fmul_rn/__fsub_rn/__fadd_rn:
// no fused multiply-add contraction), so the kernel rounds exactly as the
// plain PyTorch version does.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/rope.py):
//   int ptt_rope(x, cos, sin, y, B, S, H, D, sign, dtype, vec, px, hb, sy,
//                stream)
//   dtype 0 = float32, 1 = bfloat16; sign +1 forward, -1 backward; vec 1
//   (element route) or 16 / sizeof(T) (vector route).  Returns
//   cudaGetLastError().

#include "dtype.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using ptt::from_f32;
using ptt::to_f32;

constexpr int kRowUnroll = 4;     // rows whose loads are issued together
constexpr int kMaxThreads = 256;  // threads a CTA at most (rope_plan's)

// V consecutive elements of T as loaded and stored: one 16-byte word on
// the vector route (kept packed in 4 registers), one T on the element route
template <typename T, int V> struct Raw { using type = uint4; };
template <typename T> struct Raw<T, 1> { using type = T; };

// V consecutive fp32 table values
template <int V>
struct alignas(4 * V) Floats {
  float v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
rope_kernel(const T* __restrict__ x, const float* __restrict__ cos_t,
            const float* __restrict__ sin_t, T* __restrict__ y, int B, int S,
            int H, int half, float sign) {
  using R = typename Raw<T, V>::type;
  const int s = blockIdx.x * blockDim.z + threadIdx.z;
  const int h = blockIdx.y * blockDim.y + threadIdx.y;
  if (s >= S || h >= H) return;
  const long long d = 2LL * half;
  const long long row_stride = (long long)S * H * d;  // b -> b + 1
  const long long off = ((long long)s * H + h) * d;   // row (0, s, h)
  const float* cs = cos_t + (long long)s * half;
  const float* ss = sin_t + (long long)s * half;
  for (int i = threadIdx.x * V; i < half; i += blockDim.x * V) {
    const Floats<V> c = *reinterpret_cast<const Floats<V>*>(cs + i);
    Floats<V> sn = *reinterpret_cast<const Floats<V>*>(ss + i);
#pragma unroll
    for (int j = 0; j < V; ++j) sn.v[j] = sign * sn.v[j];  // exact: +-1
    const T* xi = x + off + i;
    T* yi = y + off + i;
    for (int b0 = 0; b0 < B; b0 += kRowUnroll) {
      R a[kRowUnroll], e[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        if (b0 + u < B) {
          const T* r = xi + (b0 + u) * row_stride;
          a[u] = *reinterpret_cast<const R*>(r);
          e[u] = *reinterpret_cast<const R*>(r + half);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        if (b0 + u < B) {
          const T* av = reinterpret_cast<const T*>(&a[u]);
          const T* ev = reinterpret_cast<const T*>(&e[u]);
          R o1, o2;
          T* ov1 = reinterpret_cast<T*>(&o1);
          T* ov2 = reinterpret_cast<T*>(&o2);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float x1 = to_f32(av[j]);
            const float x2 = to_f32(ev[j]);
            ov1[j] = from_f32<T>(
                __fsub_rn(__fmul_rn(x1, c.v[j]), __fmul_rn(x2, sn.v[j])));
            ov2[j] = from_f32<T>(
                __fadd_rn(__fmul_rn(x2, c.v[j]), __fmul_rn(x1, sn.v[j])));
          }
          T* r = yi + (b0 + u) * row_stride;
          *reinterpret_cast<R*>(r) = o1;
          *reinterpret_cast<R*>(r + half) = o2;
        }
      }
    }
  }
}

template <typename T, int V>
void launch(const void* x, const void* c, const void* s, void* y, int B,
            int S, int H, int D, float sign, int px, int hb, int sy,
            cudaStream_t stream) {
  const dim3 block(px, hb, sy);
  const dim3 grid((unsigned)((S + sy - 1) / sy),
                  (unsigned)((H + hb - 1) / hb));
  rope_kernel<T, V><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(c),
      static_cast<const float*>(s), static_cast<T*>(y), B, S, H, D / 2, sign);
}

template <typename T>
int dispatch(const void* x, const void* c, const void* s, void* y, int B,
             int S, int H, int D, float sign, int vec, int px, int hb, int sy,
             cudaStream_t st) {
  constexpr int kVec = 16 / (int)sizeof(T);
  if (vec == kVec) {
    const uintptr_t any = (uintptr_t)x | (uintptr_t)c | (uintptr_t)s |
                          (uintptr_t)y;
    if ((D / 2) % kVec != 0 || (any & 15) != 0)
      return (int)cudaErrorInvalidValue;
    launch<T, kVec>(x, c, s, y, B, S, H, D, sign, px, hb, sy, st);
  } else if (vec == 1) {
    launch<T, 1>(x, c, s, y, B, S, H, D, sign, px, hb, sy, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" int ptt_rope(const void* x, const void* c, const void* s, void* y,
                        int B, int S, int H, int D, float sign, int dtype,
                        int vec, int px, int hb, int sy, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D % 2 != 0 || px <= 0 ||
      hb <= 0 || sy <= 0 || sy > 64 || px * hb * sy > kMaxThreads ||
      (H + hb - 1) / hb > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = dispatch<float>(x, c, s, y, B, S, H, D, sign, vec, px, hb, sy, st);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(x, c, s, y, B, S, H, D, sign, vec, px, hb,
                                  sy, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
}
