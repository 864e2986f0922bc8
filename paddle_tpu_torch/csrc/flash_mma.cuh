// Tensor-core pieces of the bf16 flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd_twopass.cu): the warp-level
// bf16 product mma.sync m16n8k16 with fp32 accumulators, ldmatrix
// fragment loads from shared memory, cp.async copies from device memory
// into shared memory, and the quad-wide row reductions of an m16n8
// accumulator.  The float32 kernels keep flash_common.cuh (CUDA cores).
//
// Fragments of mma.sync.m16n8k16.row.col (lane = threadIdx.x % 32,
// g = lane / 4, t = lane % 4), each 32-bit register holding two bf16 with
// the lower column in the low half:
//   A (16 x 16, row-major): a0 = (row g,   cols 2t, 2t+1)
//                           a1 = (row g+8, cols 2t, 2t+1)
//                           a2 = (row g,   cols 2t+8, 2t+9)
//                           a3 = (row g+8, cols 2t+8, 2t+9)
//   B (16 x 8, col-major):  b0 = (rows 2t, 2t+1, col g), b1 = rows + 8
//   C (16 x 8, fp32):       c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = row g+8
// So two neighbouring C tiles (columns 0-7 and 8-15) are, once rounded to
// bf16, exactly the A fragment of a product over those 16 columns
// (`c_to_a`): P and dS go from one product into the next in registers.
//
// Shared tiles hold bf16 rows of D + kPad elements: the 16 bytes of
// padding put the eight 16-byte row pieces that one ldmatrix phase reads
// (eight consecutive rows, one column chunk) in eight different bank
// groups, so neither ldmatrix nor the cp.async stores conflict.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fmma {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;   // bf16 elements of padding per shared row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy device -> shared that bypasses L1; `valid` false writes 16
// zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4-byte copy (the fp32 row statistics, whose rows need not be 16-byte
// aligned); `valid` false writes a zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b on the tensor cores: bf16 operands, fp32 accumulation.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (rows m0..m0+15, cols k0..k0+15) of a row-major [m][k]
// shared tile with rows of LD elements.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int m0, int k0, int lane) {
  ldmatrix_x4(a, s + (m0 + (lane & 15)) * LD + k0 + ((lane >> 4) << 3));
}

// B fragments of the n8 tiles n0 and n0 + 8 over k0..k0+15, from a tile
// stored [n][k] (K for Q K^T, V for dO V^T, Q for K Q^T): b[0], b[1] are
// tile n0's, b[2], b[3] tile n0 + 8's.
template <int LD>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* s,
                                       int n0, int k0, int lane) {
  ldmatrix_x4(b, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0
                     + (((lane >> 3) & 1) << 3));
}

// The same from a tile stored [k][n] (V for P V, K for dS K, dO and Q for
// P^T dO and dS^T Q), transposed by ldmatrix.
template <int LD>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const bf16* s,
                                             int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, s + (k0 + (lane & 15)) * LD + n0 + ((lane >> 4) << 3));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment over 16 columns made of the C tiles of columns 0-7 (c0)
// and 8-15 (c1), each value rounded to bf16 (the kernels' cast of P or dS
// to the input dtype before the next product).
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Max and sum over the 4 lanes (t = 0..3) that hold one row of a C tile.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x by the special-function unit (relative error about 2^-22).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Queue the copy of rows r0 .. r0 + ROWS - 1 of one head (row 0 at g,
// consecutive rows row_stride elements apart, D bf16 each) into the
// padded shared tile s[ROWS][D + kPad]; rows at or past `valid` are
// zero-filled.  THREADS threads share the 16-byte pieces.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile_async(bf16* s, const bf16* g,
                                                long long row_stride, int r0,
                                                int valid) {
  constexpr int kChunks = D / 8;
  static_assert((ROWS * kChunks) % THREADS == 0, "tile / thread mismatch");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool ok = r < valid;
    cp_async16(s + r * (D + kPad) + col,
               g + (long long)(r0 + (ok ? r : 0)) * row_stride + col, ok);
  }
}

// Queue the copy of n fp32 values x[r0 .. r0 + n - 1] into s, zero past
// `valid` (n <= THREADS).
template <int N, int THREADS>
__device__ __forceinline__ void load_row_async(float* s, const float* x,
                                               int r0, int valid) {
  static_assert(N <= THREADS, "one value per thread");
  if (threadIdx.x < N) {
    const bool ok = (int)threadIdx.x < valid;
    cp_async4(s + threadIdx.x, x + r0 + (ok ? threadIdx.x : 0), ok);
  }
}

}  // namespace fmma
