// The bf16 flash-attention backward on tensor cores, shared by the
// two-pass route (flash_attention_bwd_twopass.cu: its dQ kernel uses the
// helpers, its dK/dV kernel is dkv_tc_kernel<D, false>) and the one-pass
// kernel (flash_attention_bwd.cu: dkv_tc_kernel<D, true>).
//
// S = Q K^T and dP = dO V^T run on CUDA cores as fmaf chains over
// ascending d from zero, the order of PyTorch's float32 matmul on the
// card, so S, P, dP and dS equal the plain version's bit for bit (why
// they must: flash_attention_bwd_twopass.cu's design notes).  Half 0 of
// the CTA (warps 0-1) builds S and P, half 1 (warps 2-3) dP and then dS
// from P passed through shared memory in fp32, each thread an 8 x 8
// micro-tile.  P and dS, cast to bf16, go through shared memory into the
// tensor cores' A fragments (flash_mma.cuh); the products that take them
// accumulate in fp32.

#pragma once

#include "flash_mma.cuh"

#include <math.h>

// In an anonymous namespace, as every kernel of csrc/ is (profiles group
// the port's kernels by that prefix).
namespace {
namespace flash_tc {

using fmma::bf16;

constexpr int kT = 128;   // threads of the bf16 kernels: 4 warps
constexpr int kB = 64;    // rows of a query block and of a key block
constexpr int kH = 64;    // threads of a CUDA-core half (0 builds S, 1 dP)

// The transposed fp32 tile t[d][r] (rows of LDT floats) of rows r < kB of
// a bf16 tile in shared or device memory (row r at src + r * row_stride),
// zero at r >= valid.  Consecutive lanes take consecutive r, so the column
// stores are conflict-free.
template <int D, int LDT = kB>
__device__ __forceinline__ void to_f32_t(float* t, const bf16* src,
                                         long long row_stride, int valid) {
#pragma unroll
  for (int c = threadIdx.x / kB; c < D / 8; c += kT / kB) {
    const int r = threadIdx.x % kB;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      raw = *reinterpret_cast<const uint4*>(src + r * row_stride + c * 8);
    const bf16* x = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      t[(c * 8 + i) * LDT + r] = __bfloat162float(x[i]);
  }
}

// One score-shaped product of a kB x kB tile on CUDA cores,
//   acc[i][j] = sum_d At[d][row(i)] * Bt[d][col(j)],
// one fmaf per d in ascending d from zero: the chain that PyTorch's float32
// matmul on the card (the plain version's q k^T and dO v^T) runs, so S and
// dP equal the plain version's bit for bit.  The kH threads of a half own
// 8 x 8 micro-tiles, rows row(i) = 4 ty + i (i < 4) and 32 + 4 ty + i - 4,
// columns the same in tx (ty = lt / 8, tx = lt % 8): four float4 reads of
// the transposed tiles per 64 fmaf, each quarter-warp reading one
// contiguous 128 bytes or one broadcast 16, so no bank conflicts.  At's
// rows are LDA floats apart (all lanes read the same row d, so any
// stride is conflict-free), Bt's kB.
__device__ __forceinline__ int micro(int x, int i) {
  return i < 4 ? 4 * x + i : 32 + 4 * x + i - 4;
}

template <int D, int LDA = kB>
__device__ __forceinline__ void tile_ffma(const float* At, const float* Bt,
                                          int ty, int tx,
                                          float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const float* ar = At + 4 * ty;
  const float* br = Bt + 4 * tx;
  // operands of step d + 1 are read while step d's fmaf run
  float4 a0 = *reinterpret_cast<const float4*>(ar);
  float4 a1 = *reinterpret_cast<const float4*>(ar + 32);
  float4 b0 = *reinterpret_cast<const float4*>(br);
  float4 b1 = *reinterpret_cast<const float4*>(br + 32);
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    if (d + 1 < D) {
      ar += LDA;
      br += kB;
      a0 = *reinterpret_cast<const float4*>(ar);
      a1 = *reinterpret_cast<const float4*>(ar + 32);
      b0 = *reinterpret_cast<const float4*>(br);
      b1 = *reinterpret_cast<const float4*>(br + 32);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Barrier of the kH threads of half 0 (warps 0-1), barrier 1.
__device__ __forceinline__ void half0_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kH) : "memory");
}

// Row-major kB x kB fp32 tile: the 8 x 8 micro-tile of (ty, tx) as float4s.
__device__ __forceinline__ void put_tile(float* t, int ty, int tx,
                                         const float (&x)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(t + micro(ty, i) * kB + 32 * h + 4 * tx) =
          make_float4(x[i][4 * h], x[i][4 * h + 1], x[i][4 * h + 2],
                      x[i][4 * h + 3]);
}

// dS = P * (dP - delta) in place of dP, P read from the row-major fp32
// tile t; delta per micro-tile row (kRowDelta) or column.
template <bool kRowDelta>
__device__ __forceinline__ void ds_of(const float* t, const float* delta,
                                      int ty, int tx, float (&x)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(
          t + micro(ty, i) * kB + 32 * h + 4 * tx);
      const float p[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * h + e;
        const float dlt =
            kRowDelta ? delta[micro(ty, i)] : delta[micro(tx, j)];
        x[i][j] = p[e] * (x[i][j] - dlt);
      }
    }
}

// The micro-tile rounded to bf16 into a padded [kB][kB + kPad] bf16 tile.
__device__ __forceinline__ void put_tile_bf16(bf16* t, int ty, int tx,
                                              const float (&x)[8][8]) {
  constexpr int LDS = kB + fmma::kPad;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint2 v;
      v.x = fmma::pack_bf16(x[i][4 * h], x[i][4 * h + 1]);
      v.y = fmma::pack_bf16(x[i][4 * h + 2], x[i][4 * h + 3]);
      *reinterpret_cast<uint2*>(t + micro(ty, i) * LDS + 32 * h + 4 * tx) = v;
    }
}

// P = exp(s * scale - lse), each operation rounded on its own (no FMA
// contraction) with the accurate expf: the plain version's arithmetic.
__device__ __forceinline__ float p_of(float s, float scale, float lse) {
  return expf(__fsub_rn(__fmul_rn(s, scale), lse));
}

// Rows of the fp32 Kt tile: kB floats, or kB + 8 where the kernel also
// reads K as the B operand of dS K (kDQ), which puts the eight d rows that
// a half-warp's 64-bit reads touch on distinct banks.
template <bool kDQ>
__host__ __device__ constexpr int kt_stride() {
  return kDQ ? kB + 8 : kB;
}

template <int D, bool kDQ>
constexpr int dkv_tc_smem_bytes() {
  // Kt fp32 [D][kt_stride]; Vt, Qt, dOt fp32 [D][kB]; 2 stages of Q, dO
  // bf16 [kB][D + kPad] and of lse, delta [kB]; P^T bf16 [kB][kB + kPad].
  // P^T in fp32 ([kB][kB]) reuses Qt, dS^T (bf16) reuses dOt.
  return (D * kt_stride<kDQ>() + 3 * D * kB) * 4
         + 4 * kB * (D + fmma::kPad) * 2 + 4 * kB * 4
         + kB * (kB + fmma::kPad) * 2;
}

// The dK/dV walk of one (key block, kv head, batch row) over the G query
// heads of the kv head and their query blocks: the two-pass route's
// dK/dV kernel (kDQ false), and with kDQ the one-pass kernel, which also
// adds each (key block, query block) pair's share of dQ = dS K * scale
// into the fp32 dq_acc [B, Sq, Hq, D] (zeroed by the caller) with
// vector atomics.
template <int D, bool kDQ>
__global__ void __launch_bounds__(kT)
dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv,
              float* __restrict__ dq_acc, int Sq, int Sk, int Hq, int Hkv,
              float scale, int causal) {
  using namespace fmma;
  constexpr int LD = D + kPad;
  constexpr int LDS = kB + kPad;
  constexpr int LDK = kt_stride<kDQ>();
  constexpr int DT = D / 8;
  extern __shared__ uint4 smem_tc[];
  float* sKt = reinterpret_cast<float*>(smem_tc);
  float* sVt = sKt + D * LDK;
  float* sQt = sVt + D * kB;
  float* sdOt = sQt + D * kB;
  bf16* sQ = reinterpret_cast<bf16*>(sdOt + D * kB);   // 2 stages
  bf16* sdO = sQ + 2 * kB * LD;                            // 2 stages
  float* sL = reinterpret_cast<float*>(sdO + 2 * kB * LD);   // 2 x [kB]
  float* sD = sL + 2 * kB;                                   // 2 x [kB]
  bf16* sPt = reinterpret_cast<bf16*>(sD + 2 * kB);
  float* sP32 = sQt;                            // after S^T is built
  bf16* sdSt = reinterpret_cast<bf16*>(sdOt);   // after dP^T is built

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int half = threadIdx.x / kH;        // 0 builds S^T and P^T, 1 dP^T
  const int ty = (threadIdx.x % kH) >> 3;   // micro-tile rows: keys
  const int tx = threadIdx.x & 7;           // micro-tile columns: queries
  // kDQ: grid (kv head, row, key block), so that the heaviest causal key
  // blocks of every (row, kv head) start first and the lightest end the
  // launch; otherwise grid (key block, kv head, row)
  const int kb = kDQ ? blockIdx.z : blockIdx.x;
  const int hk = kDQ ? blockIdx.x : blockIdx.y;
  const int b = kDQ ? blockIdx.y : blockIdx.z;
  const int G = Hq / Hkv;
  const int k0 = kb * kB;

  const long long q_stride = (long long)Hq * D;
  const long long kv_stride = (long long)Hkv * D;

  const int nqb = (Sq + kB - 1) / kB;
  const int qb_start = causal ? kb : 0;
  const int nq = nqb - qb_start;
  const int n_it = G * nq;   // (query head, query block) pairs of the group

  // queue the Q, dO, LSE and delta of iteration `it` into stage `st`
  auto load_q_block = [&](int it, int st) {
    const int h = hk * G + it / nq;
    const int q0 = (qb_start + it % nq) * kB;
    const long long head = (long long)b * Sq * Hq + h;
    const long long row = ((long long)b * Hq + h) * Sq;
    load_tile_async<kB, D, kT>(sQ + st * kB * LD, q + head * D, q_stride, q0,
                               Sq - q0);
    load_tile_async<kB, D, kT>(sdO + st * kB * LD, dout + head * D, q_stride,
                               q0, Sq - q0);
    load_row_async<kB, kT>(sL + st * kB, lse + row, q0, Sq - q0);
    load_row_async<kB, kT>(sD + st * kB, delta + row, q0, Sq - q0);
  };

  load_q_block(0, 0);
  cp_async_commit();
  const bf16* kg = k + ((long long)b * Sk * Hkv + hk) * D;
  const bf16* vg = v + ((long long)b * Sk * Hkv + hk) * D;
  to_f32_t<D, LDK>(sKt, kg + (long long)k0 * kv_stride, kv_stride,
                   Sk - k0);
  to_f32_t<D>(sVt, vg + (long long)k0 * kv_stride, kv_stride, Sk - k0);

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[dt][e] = 0.f;
      dv_acc[dt][e] = 0.f;
    }

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) load_q_block(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cQ = sQ + st * kB * LD;
    const bf16* cdO = sdO + st * kB * LD;
    const float* cL = sL + st * kB;
    const float* cD = sD + st * kB;
    const int q0 = (qb_start + it % nq) * kB;
    to_f32_t<D>(sQt, cQ, LD, kB);
    to_f32_t<D>(sdOt, cdO, LD, kB);
    __syncthreads();

    // S^T (half 0) and dP^T (half 1) on CUDA cores, then P^T and dS^T
    float x[8][8];
    if constexpr (kDQ) {
      if (half)
        tile_ffma<D>(sVt, sdOt, ty, tx, x);
      else
        tile_ffma<D, LDK>(sKt, sQt, ty, tx, x);
    } else {
      tile_ffma<D>(half ? sVt : sKt, half ? sdOt : sQt, ty, tx, x);
    }
    const bool need_mask =
        (causal && k0 + kB - 1 > q0) || (k0 + kB > Sk) || (q0 + kB > Sq);
    if (half == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int query = q0 + micro(tx, j);
        const float lse_q = cL[micro(tx, j)];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int key = k0 + micro(ty, i);
          float p = p_of(x[i][j], scale, lse_q);
          if (need_mask &&
              (key >= Sk || query >= Sq || (causal && key > query)))
            p = 0.f;
          x[i][j] = p;
        }
      }
      put_tile_bf16(sPt, ty, tx, x);
      half0_sync();   // every read of Qt by this half is done
      put_tile(sP32, ty, tx, x);
    }
    __syncthreads();
    if (half == 1) {
      ds_of<false>(sP32, cD, ty, tx, x);
      put_tile_bf16(sdSt, ty, tx, x);
    }
    __syncthreads();

    // dV += P^T(bf16) dO, dK += dS^T(bf16) Q on the tensor cores; warp w
    // owns keys 16 w .. + 15
#pragma unroll
    for (int j = 0; j < kB / 16; ++j) {
      uint32_t pa[4], da[4];
      load_a<LDS>(pa, sPt, warp * 16, j * 16, lane);
      load_a<LDS>(da, sdSt, warp * 16, j * 16, lane);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bb[4];
        load_b_trans<LD>(bb, cdO, j * 16, dt * 8, lane);
        mma(dv_acc[dt], pa, bb[0], bb[1]);
        mma(dv_acc[dt + 1], pa, bb[2], bb[3]);
        load_b_trans<LD>(bb, cQ, j * 16, dt * 8, lane);
        mma(dk_acc[dt], da, bb[0], bb[1]);
        mma(dk_acc[dt + 1], da, bb[2], bb[3]);
      }
    }
    if constexpr (kDQ) {
      // this pair's share of dQ = dS(bf16) K * scale on the tensor cores;
      // warp w owns queries 16 w .. + 15.  A: dS, read from the key-major
      // dS^T tile through ldmatrix.trans; B: K from the fp32 Kt tile (its
      // values are bf16, so the repack is exact), two keys per 64-bit read.
      uint32_t da[kB / 16][4];
#pragma unroll
      for (int j = 0; j < kB / 16; ++j)
        load_a_trans<LDS>(da[j], sdSt, warp * 16, j * 16, lane);
      const int h = hk * G + it / nq;
      float* dq_blk = dq_acc + (((long long)b * Sq + q0) * Hq + h) * D;
      const bool odd = t & 1;
      const int row = warp * 16 + g + (odd ? 8 : 0);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kB / 16; ++j) {
          const float* kp = sKt + (dt * 8 + g) * LDK + j * 16 + 2 * t;
          const float2 k01 = *reinterpret_cast<const float2*>(kp);
          const float2 k89 = *reinterpret_cast<const float2*>(kp + 8);
          mma(c, da[j], pack_bf16(k01.x, k01.y), pack_bf16(k89.x, k89.y));
        }
        // lanes t and t ^ 1 swap halves so that each holds four
        // consecutive columns of one row: one float4 atomic per lane
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
        if (q0 + row < Sq) {
          const float4 val =
              odd ? make_float4(r0 * scale, r1 * scale, c[2] * scale,
                                c[3] * scale)
                  : make_float4(c[0] * scale, c[1] * scale, r0 * scale,
                                r1 * scale);
          atomicAdd(reinterpret_cast<float4*>(
                        dq_blk + (long long)row * Hq * D + dt * 8
                        + 2 * (t & ~1)),
                    val);
        }
      }
    }
    __syncthreads();   // P^T, dS^T and stage st are free
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + warp * 16 + g + r * 8;
    if (row >= Sk) continue;
    const long long off = (((long long)b * Sk + row) * Hkv + hk) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + off + dt * 8) = fmma::pack_bf16(
          dk_acc[dt][2 * r] * scale, dk_acc[dt][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + dt * 8) =
          fmma::pack_bf16(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
    }
  }
}

}  // namespace flash_tc
}  // namespace
