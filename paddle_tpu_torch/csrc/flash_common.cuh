// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): tile sizes, the rounding of P and dS, and the
// loader that stages a [rows, D] tile of a [B, S, H, D] tensor in shared
// memory.  The dtype conversions come from dtype.cuh.
//
// Thread layout of both kernels: 256 threads as a 16 x 16 grid, tx =
// tid % 16 and ty = tid / 16.  A thread owns rows ty + 16*i (i < 4) and
// columns tx + 16*j (j < 4) of a 64 x 64 score tile, so the 16 threads of
// one row are the 16 lanes of one half-warp and reduce with shuffles.
// Output tiles [64, D] give a thread the same rows and the columns
// c2*64 + tx*4 .. +3 (c2 < D/64), read as float4.
//
// Shared tiles hold fp32 values in rows of D + 4 floats: 16-byte aligned
// for float4 access, and rows tx + 16*j land on distinct banks.

#pragma once

#include "dtype.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

using ptt::from_f32;
using ptt::to_f32;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value

// v rounded to T and widened back: the cast of P or dS to the input dtype
// before a product, as the TPU kernel's `.astype(v.dtype)`.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Stage rows r0 .. r0 + ROWS - 1 of one head into s[ROWS][D + 4] as fp32.
// g points at row 0 of that head; consecutive rows are row_stride
// elements apart.  Rows at or past `valid` (the ragged edge of S) are
// zero-filled.  16-byte loads: consecutive threads read consecutive
// chunks of a row.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* __restrict__ s,
                                          const T* __restrict__ g,
                                          long long row_stride, int r0,
                                          int valid) {
  constexpr int kVec = 16 / (int)sizeof(T);   // elements per 16 bytes
  constexpr int kChunks = D / kVec;            // chunks per row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * kVec;
    float4* dst = reinterpret_cast<float4*>(s + r * (D + 4) + col);
    if (r < valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          g + (long long)(r0 + r) * row_stride + col);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec / 4; ++j)
        dst[j] = make_float4(to_f32(v[4 * j]), to_f32(v[4 * j + 1]),
                             to_f32(v[4 * j + 2]), to_f32(v[4 * j + 3]));
    } else {
#pragma unroll
      for (int j = 0; j < kVec / 4; ++j)
        dst[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Sum over the 16 lanes of a half-warp (the 16 threads of one row).
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// acc[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two [64, D+4]
// fp32 tiles: the score-shaped products Q K^T and dO V^T.
template <int D>
__device__ __forceinline__ void rows_dot_rows(const float* __restrict__ a,
                                              const float* __restrict__ b,
                                              int tx, int ty,
                                              float (&acc)[4][4]) {
  constexpr int LD = D + 4;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// acc[i][c] += sum_x W[row(i)][x] * M[x][col(c)] for x < 64, where W is
// a [64, 64 + 4] fp32 tile read along its rows and M a [64, D + 4] tile;
// row(i) = row0 + rstep * i and col(c) = (c / 4) * 64 + tx * 4 + c % 4.
// This is P V (forward), P^T dO and dS^T Q (dV, dK) and dS K (dQ).
template <int D>
__device__ __forceinline__ void rows_times_tile(const float* __restrict__ w,
                                                const float* __restrict__ m,
                                                int tx, int row0, int rstep,
                                                float (&acc)[4][D / 16]) {
  constexpr int LD = D + 4;
  constexpr int LDW = 64 + 4;
#pragma unroll 2
  for (int x = 0; x < 64; x += 4) {
    float4 wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wv[i] = *reinterpret_cast<const float4*>(w + (row0 + rstep * i) * LDW
                                               + x);
#pragma unroll
    for (int xx = 0; xx < 4; ++xx) {
      const float* mrow = m + (x + xx) * LD + tx * 4;
#pragma unroll
      for (int c2 = 0; c2 < D / 64; ++c2) {
        const float4 mv = *reinterpret_cast<const float4*>(mrow + c2 * 64);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wi = comp(wv[i], xx);
          acc[i][c2 * 4 + 0] = fmaf(wi, mv.x, acc[i][c2 * 4 + 0]);
          acc[i][c2 * 4 + 1] = fmaf(wi, mv.y, acc[i][c2 * 4 + 1]);
          acc[i][c2 * 4 + 2] = fmaf(wi, mv.z, acc[i][c2 * 4 + 2]);
          acc[i][c2 * 4 + 3] = fmaf(wi, mv.w, acc[i][c2 * 4 + 3]);
        }
      }
    }
  }
}

// acc[i][c] += sum_x Wt[x][row0 + i] * M[x][col(c)] for x < 64: the same
// product with W stored transposed ([x][row], rows 64 + 4 floats), so a
// thread's 4 rows are one float4.  This is dQ = dS K from dS^T.
template <int D>
__device__ __forceinline__ void cols_times_tile(const float* __restrict__ wt,
                                                const float* __restrict__ m,
                                                int tx, int row0,
                                                float (&acc)[4][D / 16]) {
  constexpr int LD = D + 4;
  constexpr int LDW = 64 + 4;
#pragma unroll 4
  for (int x = 0; x < 64; ++x) {
    const float4 wv = *reinterpret_cast<const float4*>(wt + x * LDW + row0);
    const float* mrow = m + x * LD + tx * 4;
#pragma unroll
    for (int c2 = 0; c2 < D / 64; ++c2) {
      const float4 mv = *reinterpret_cast<const float4*>(mrow + c2 * 64);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float wi = comp(wv, i);
        acc[i][c2 * 4 + 0] = fmaf(wi, mv.x, acc[i][c2 * 4 + 0]);
        acc[i][c2 * 4 + 1] = fmaf(wi, mv.y, acc[i][c2 * 4 + 1]);
        acc[i][c2 * 4 + 2] = fmaf(wi, mv.z, acc[i][c2 * 4 + 2]);
        acc[i][c2 * 4 + 3] = fmaf(wi, mv.w, acc[i][c2 * 4 + 3]);
      }
    }
  }
}

}  // namespace flash
