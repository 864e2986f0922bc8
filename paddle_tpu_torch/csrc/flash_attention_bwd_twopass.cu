// Two-pass flash-attention backward for Hopper (sm_90a): a dQ kernel that
// walks key blocks for each query block, then a dK/dV kernel that walks
// query blocks for each key block.  Each rebuilds P = exp(S - lse) from
// the forward's LSE, so P is computed twice (once per pass), and neither
// kernel needs an atomic: every output element has one writer.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py:
// _dq_kernel (:212, launched by _flash_bwd :459) and _dkv_kernel (:248,
// launched by _flash_bwd :476), the route of flash_onepass_bwd=False
// (:454-457).  delta = rowsum(dO * O) is computed outside, as at :450.
//
// Shapes (row-major, contiguous):
//   q, do        [B, Sq, Hq, D]    float32 or bfloat16
//   k, v         [B, Sk, Hkv, D]   query head h reads kv head h / (Hq/Hkv)
//   lse, delta   [B, Hq, Sq]       float32
//   dq           [B, Sq, Hq, D]    q's dtype, written once (dq kernel)
//   dk, dv (dkv kernel), by dtype:
//     bfloat16   [B, Sk, Hkv, D]   k's dtype: each kv head's gradient,
//                                  summed over its G = Hq/Hkv query heads
//                                  in fp32 registers and written once
//     float32    [B, Sk, Hq, D]    fp32 PER QUERY HEAD: the caller sums
//                                  each group of G
// Arithmetic, as the TPU kernels': s = q.k * scale, masked (p = 0 past
// the causal diagonal and the ragged edge); P = exp(s - lse); dP = dO.v;
// dS = P * (dP - delta).  dQ = scale * sum over key blocks of dS K with
// dS cast to k's dtype (:243-246, :246); dV = sum of P^T dO with P cast to
// dO's dtype (:278-280); dK = scale * sum of dS^T Q with dS cast to q's
// dtype (:283-288).  Every product accumulates in fp32.
//
// Bound: operations.  Causal, the dQ pass does 3 score-sized products
// (Q K^T, dO V^T, dS K: 3 * B*Hq*Sq*Sk*D flops) and the dK/dV pass 4
// (Q K^T, dO V^T, P^T dO, dS^T Q); the pair does 7 where the one-pass
// kernel does 5, against the same bytes of q, k, v, o, do, lse and the
// three gradients: far above the H100's ridge at any bound the tensor
// cores set (989 TFLOP/s bf16).
//
// Design.  The Pallas kernels are the two halves of FlashAttention-2 and
// map onto Hopper as they are: the dQ kernel's grid is (query block, bh)
// with K and V walked in a fori_loop; the dK/dV kernel's is (key block,
// bh) with Q and dO walked.  Two routes, chosen by dtype; both are
// kernels of this file, and neither stands in for the other.
//
// bfloat16 (dq_tc_kernel, dkv_tc_kernel): one CTA of 4 warps per (64-row
// block, head, batch row), heaviest causal blocks first, each block's
// operands streamed through a 2-stage cp.async ring of padded bf16 tiles
// (flash_mma.cuh), so block n + 1 is in flight while block n computes.
// The products split by what the result needs:
//   - S = Q K^T and dP = dO V^T run on CUDA cores, as fmaf chains over
//     ascending d from zero, the order of PyTorch's float32 matmul on the
//     card: S, P, dP and dS equal the plain version's bit for bit.  They
//     must.  Where attention sits on one key (row 0 of a causal head
//     always), dP - delta cancels to rounding noise, so dQ there IS the
//     noise of dP's fp32 sum; the tolerance (2^-8 of the row's RMS) holds
//     only that same noise, and a tensor-core sum of the same products,
//     rounded differently, misses it in one such row per head.
//   - dS(bf16) K, P^T(bf16) dO and dS^T(bf16) Q run on the tensor cores
//     (mma.sync m16n8k16, operands through ldmatrix, fp32 accumulators):
//     their fp32 sums only move the result within the final bf16 ulp.
// Warps 0-1 build S and P, warps 2-3 dP and then dS from P passed through
// shared memory in fp32, each thread an 8 x 8 micro-tile (4 float4 reads
// per 64 fmaf, no bank conflicts); P and dS, cast to bf16, go through
// shared memory into the tensor cores' A fragments.  The fp32 copies of
// the CUDA-core operands (transposed, for float4 reads) are made from the
// bf16 tiles in shared memory.
//   dq kernel: Q, dO (fp32), LSE and delta of its query block resident;
//     walks key blocks from 0 up to the causal diagonal (the bound at
//     :220-222); dQ += dS K in registers, written once as dQ * scale.  No
//     atomics and a fixed order, so dQ is bit-identical from launch to
//     launch.
//   dkv kernel: K, V (fp32) of its key block resident; walks the G query
//     heads of its kv head and, for each, the query blocks from the
//     diagonal to the end (:256), computing S^T and dP^T, so that P^T and
//     dS^T come out key-major; dK and dV stay in fp32 registers across the
//     whole group and are written once, in k's dtype: no per-head fp32
//     buffers and no group sum outside.
// The CUDA-core half bounds both kernels: 2 * D fmaf per unmasked score
// (causal: 2 * B*Hq*Sq*Sk*D/2), at most 33.5e12 fmaf/s at the H100's fp32
// rate of 67 TFLOP/s, so at least 2.05 ms each at the training shape
// (B=8, S=2048, Hq=32, D=64); measured times in PERF.md, PR 6.
//
// float32, on CUDA cores (dq and dkv kernels below, the first port's,
// unchanged; TF32 would break the float32 tolerance): one CTA of 256
// threads per (64-row block, query head, batch row), on the 16 x 16
// thread grid and the fp32 shared tiles of flash_common.cuh; the dq
// kernel keeps Q, dO, lse and delta resident and stages dS in shared
// memory, the dkv kernel keeps K and V resident and writes its own query
// head's fp32 dK and dV.  (Its S and dP are the same fmaf chains.)
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/flash_attention.py):
//   int ptt_flash_attention_bwd_dq(q, k, v, do, lse, delta, dq, B, Sq, Sk,
//                                  Hq, Hkv, D, scale, causal, dtype, stream)
//   int ptt_flash_attention_bwd_dkv(q, k, v, do, lse, delta, dk, dv, B,
//                                   Sq, Sk, Hq, Hkv, D, scale, causal,
//                                   dtype, stream)
//   dtype 0 = float32, 1 = bfloat16; D in {64, 128}; Hq % Hkv == 0; 16-byte
//   aligned pointers (the wrapper checks).  Return cudaGetLastError().

#include "flash_common.cuh"
#include "flash_mma.cuh"

#include <math.h>

namespace {

using namespace flash;

// ---------------------------------------------------------------------------
// float32: CUDA cores

template <int D>
constexpr int dq_smem_bytes() {
  return (4 * kBlockQ * (D + 4) + kBlockQ * (kBlockK + 4) + 2 * kBlockQ) * 4;
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (4 * kBlockK * (D + 4) + 2 * kBlockK * (kBlockQ + 4) + 2 * kBlockQ)
         * 4;
}

// Scores and dP of one (query block, key block) pair for the thread's
// rows = queries ty + 16 i and columns = keys tx + 16 j, turned into P and
// dS in place (p = 0 where masked).
template <int D>
__device__ __forceinline__ void p_and_ds(const float* sQ, const float* sK,
                                         const float* sdO, const float* sV,
                                         const float* sLse,
                                         const float* sDelta, int q0, int k0,
                                         int Sq, int Sk, float scale,
                                         int causal, int tx, int ty,
                                         float (&p)[4][4],
                                         float (&ds)[4][4]) {
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
  rows_dot_rows<D>(sQ, sK, tx, ty, s);
  rows_dot_rows<D>(sdO, sV, tx, ty, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = ty + 16 * i;
    const int qpos = q0 + qi;
    const float row_lse = sLse[qi];
    const float row_delta = sDelta[qi];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      float pv = 0.f;
      if (qpos < Sq && kpos < Sk && !(causal && kpos > qpos))
        pv = expf(s[i][j] * scale - row_lse);
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - row_delta);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int Hq, int Hkv, float scale,
                    int causal) {
  constexpr int LD = D + 4;
  constexpr int LDS = kBlockK + 4;
  constexpr int DC = D / 16;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + kBlockQ * LD;
  float* sK = sdO + kBlockQ * LD;
  float* sV = sK + kBlockK * LD;
  float* sdS = sV + kBlockK * LD;       // [query][key]: dS cast to T
  float* sLse = sdS + kBlockQ * LDS;
  float* sDelta = sLse + kBlockQ;

  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qb * kBlockQ;

  const long long q_stride = (long long)Hq * D;
  const long long kv_stride = (long long)Hkv * D;
  const T* qg = q + ((long long)b * Sq * Hq + h) * D;
  const T* dog = dout + ((long long)b * Sq * Hq + h) * D;
  const T* kg = k + ((long long)b * Sk * Hkv + hk) * D;
  const T* vg = v + ((long long)b * Sk * Hkv + hk) * D;
  const float* lse_g = lse + ((long long)b * Hq + h) * Sq;
  const float* delta_g = delta + ((long long)b * Hq + h) * Sq;

  load_tile<T, D, kBlockQ>(sQ, qg, q_stride, q0, Sq - q0);
  load_tile<T, D, kBlockQ>(sdO, dog, q_stride, q0, Sq - q0);
  if (threadIdx.x < kBlockQ) {
    const int r = q0 + threadIdx.x;
    sLse[threadIdx.x] = r < Sq ? lse_g[r] : 0.f;
    sDelta[threadIdx.x] = r < Sq ? delta_g[r] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int nkb = (Sk + kBlockK - 1) / kBlockK;
  // causal: key blocks that intersect the triangle, up to the diagonal
  const int kb_end = causal ? min(nkb, (q0 + kBlockQ + kBlockK - 1) / kBlockK)
                            : nkb;

  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();   // the previous block's reads of sK, sV, sdS
    load_tile<T, D, kBlockK>(sK, kg, kv_stride, k0, Sk - k0);
    load_tile<T, D, kBlockK>(sV, vg, kv_stride, k0, Sk - k0);
    __syncthreads();

    float p[4][4], ds[4][4];
    p_and_ds<D>(sQ, sK, sdO, sV, sLse, sDelta, q0, k0, Sq, Sk, scale, causal,
                tx, ty, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sdS[(ty + 16 * i) * LDS + tx + 16 * j] = round_to<T>(ds[i][j]);
    __syncthreads();   // dS visible to the whole CTA

    // dQ += dS K: rows = queries ty + 16 i
    rows_times_tile<D>(sdS, sK, tx, ty, 16, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    T* dst = dq + ((long long)b * Sq + row) * q_stride + (long long)h * D
             + tx * 4;
#pragma unroll
    for (int c2 = 0; c2 < D / 64; ++c2)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[c2 * 64 + e] = from_f32<T>(acc[i][c2 * 4 + e] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk_acc, float* __restrict__ dv_acc,
                     int Sq, int Sk, int Hq, int Hkv, float scale,
                     int causal) {
  constexpr int LD = D + 4;
  constexpr int LDP = kBlockQ + 4;
  constexpr int DC = D / 16;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kBlockK * LD;
  float* sQ = sV + kBlockK * LD;
  float* sdO = sQ + kBlockQ * LD;
  float* sPt = sdO + kBlockQ * LD;     // [key][query]: P cast to T
  float* sdSt = sPt + kBlockK * LDP;   // [key][query]: dS cast to T
  float* sLse = sdSt + kBlockK * LDP;
  float* sDelta = sLse + kBlockQ;

  const int kb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = kb * kBlockK;

  const long long q_stride = (long long)Hq * D;
  const long long kv_stride = (long long)Hkv * D;
  const T* qg = q + ((long long)b * Sq * Hq + h) * D;
  const T* dog = dout + ((long long)b * Sq * Hq + h) * D;
  const T* kg = k + ((long long)b * Sk * Hkv + hk) * D;
  const T* vg = v + ((long long)b * Sk * Hkv + hk) * D;
  const float* lse_g = lse + ((long long)b * Hq + h) * Sq;
  const float* delta_g = delta + ((long long)b * Hq + h) * Sq;

  load_tile<T, D, kBlockK>(sK, kg, kv_stride, k0, Sk - k0);
  load_tile<T, D, kBlockK>(sV, vg, kv_stride, k0, Sk - k0);

  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[i][c] = 0.f;
      dv[i][c] = 0.f;
    }

  const int nqb = (Sq + kBlockQ - 1) / kBlockQ;
  const int qb_start = causal ? k0 / kBlockQ : 0;

  for (int qb = qb_start; qb < nqb; ++qb) {
    const int q0 = qb * kBlockQ;
    __syncthreads();   // the previous block's reads of sQ, sdO, sPt, sdSt
    load_tile<T, D, kBlockQ>(sQ, qg, q_stride, q0, Sq - q0);
    load_tile<T, D, kBlockQ>(sdO, dog, q_stride, q0, Sq - q0);
    if (threadIdx.x < kBlockQ) {
      const int r = q0 + threadIdx.x;
      sLse[threadIdx.x] = r < Sq ? lse_g[r] : 0.f;
      sDelta[threadIdx.x] = r < Sq ? delta_g[r] : 0.f;
    }
    __syncthreads();

    float p[4][4], ds[4][4];
    p_and_ds<D>(sQ, sK, sdO, sV, sLse, sDelta, q0, k0, Sq, Sk, scale, causal,
                tx, ty, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = ty + 16 * i;
        const int kj = tx + 16 * j;
        sPt[kj * LDP + qi] = round_to<T>(p[i][j]);
        sdSt[kj * LDP + qi] = round_to<T>(ds[i][j]);
      }
    __syncthreads();   // P^T and dS^T visible to the whole CTA

    // dV += P^T dO and dK += dS^T Q: rows = keys ty + 16 i
    rows_times_tile<D>(sPt, sdO, tx, ty, 16, dv);
    rows_times_tile<D>(sdSt, sQ, tx, ty, 16, dk);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Sk) continue;
    const long long off = ((long long)b * Sk + row) * q_stride
                          + (long long)h * D + tx * 4;
#pragma unroll
    for (int c2 = 0; c2 < D / 64; ++c2) {
      *reinterpret_cast<float4*>(dk_acc + off + c2 * 64) = make_float4(
          dk[i][c2 * 4] * scale, dk[i][c2 * 4 + 1] * scale,
          dk[i][c2 * 4 + 2] * scale, dk[i][c2 * 4 + 3] * scale);
      *reinterpret_cast<float4*>(dv_acc + off + c2 * 64) = make_float4(
          dv[i][c2 * 4], dv[i][c2 * 4 + 1], dv[i][c2 * 4 + 2],
          dv[i][c2 * 4 + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: S and dP on CUDA cores (the plain version's rounding), the other
// products on tensor cores

using fmma::bf16;

constexpr int kT = 128;   // threads of the bf16 kernels: 4 warps
constexpr int kB = 64;    // rows of a query block and of a key block
constexpr int kH = 64;    // threads of a CUDA-core half (0 builds S, 1 dP)

// The transposed fp32 tile t[d][r] (rows of kB floats) of rows r < kB of
// a bf16 tile in shared or device memory (row r at src + r * row_stride),
// zero at r >= valid.  Consecutive lanes take consecutive r, so the column
// stores are conflict-free.
template <int D>
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
      t[(c * 8 + i) * kB + r] = __bfloat162float(x[i]);
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
// contiguous 128 bytes or one broadcast 16, so no bank conflicts.
__device__ __forceinline__ int micro(int x, int i) {
  return i < 4 ? 4 * x + i : 32 + 4 * x + i - 4;
}

template <int D>
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
      ar += kB;
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

template <int D>
constexpr int dq_tc_smem_bytes() {
  // Qt, dOt, Kt, Vt fp32 [D][kB]; 2 stages of K, V bf16 [kB][D + kPad];
  // lse and delta [kB].  P (fp32 [kB][kB]) reuses Kt, dS (bf16
  // [kB][kB + kPad]) reuses Vt.
  return 4 * D * kB * 4 + 4 * kB * (D + fmma::kPad) * 2 + 2 * kB * 4;
}

template <int D>
__global__ void __launch_bounds__(kT)
dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv,
             float scale, int causal) {
  using namespace fmma;
  constexpr int LD = D + kPad;
  constexpr int LDS = kB + kPad;
  constexpr int DT = D / 8;
  extern __shared__ uint4 smem_tc[];
  float* sQt = reinterpret_cast<float*>(smem_tc);
  float* sdOt = sQt + D * kB;
  float* sKt = sdOt + D * kB;
  float* sVt = sKt + D * kB;
  bf16* sK = reinterpret_cast<bf16*>(sVt + D * kB);   // 2 stages
  bf16* sV = sK + 2 * kB * LD;                            // 2 stages
  float* sL = reinterpret_cast<float*>(sV + 2 * kB * LD);
  float* sD = sL + kB;
  float* sP = sKt;                              // after S is built
  bf16* sdS = reinterpret_cast<bf16*>(sVt);     // after dP is built

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int half = threadIdx.x / kH;        // 0 builds S and P, 1 dP and dS
  const int ty = (threadIdx.x % kH) >> 3;   // micro-tile rows: queries
  const int tx = threadIdx.x & 7;           // micro-tile columns: keys
  const int nqb = (Sq + kB - 1) / kB;
  const int qb = nqb - 1 - (int)blockIdx.x;   // heaviest causal blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qb * kB;

  const long long q_stride = (long long)Hq * D;
  const long long kv_stride = (long long)Hkv * D;
  const bf16* kg = k + ((long long)b * Sk * Hkv + hk) * D;
  const bf16* vg = v + ((long long)b * Sk * Hkv + hk) * D;

  const int nkb = (Sk + kB - 1) / kB;
  const int kb_end = causal ? min(nkb, (q0 + kB + kB - 1) / kB) : nkb;

  load_tile_async<kB, D, kT>(sK, kg, kv_stride, 0, Sk);
  load_tile_async<kB, D, kT>(sV, vg, kv_stride, 0, Sk);
  cp_async_commit();
  const long long head = (long long)b * Sq * Hq + h;
  to_f32_t<D>(sQt, q + (head + (long long)q0 * Hq) * D, q_stride, Sq - q0);
  to_f32_t<D>(sdOt, dout + (head + (long long)q0 * Hq) * D, q_stride,
              Sq - q0);
  if (threadIdx.x < kB) {
    const int row = q0 + threadIdx.x;
    const long long i = ((long long)b * Hq + h) * Sq + row;
    sL[threadIdx.x] = row < Sq ? lse[i] : 0.f;
    sD[threadIdx.x] = row < Sq ? delta[i] : 0.f;
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int kb = 0; kb < kb_end; ++kb) {
    const int st = kb & 1;
    const int k0 = kb * kB;
    if (kb + 1 < kb_end) {
      const int k1 = k0 + kB;
      load_tile_async<kB, D, kT>(sK + (st ^ 1) * kB * LD, kg, kv_stride, k1,
                                 Sk - k1);
      load_tile_async<kB, D, kT>(sV + (st ^ 1) * kB * LD, vg, kv_stride, k1,
                                 Sk - k1);
    }
    cp_async_commit();
    cp_async_wait<1>();   // block kb has landed
    __syncthreads();
    const bf16* cK = sK + st * kB * LD;
    to_f32_t<D>(sKt, cK, LD, kB);
    to_f32_t<D>(sVt, sV + st * kB * LD, LD, kB);
    __syncthreads();

    // S (half 0) and dP (half 1) on CUDA cores, then P and dS
    float x[8][8];
    tile_ffma<D>(half ? sdOt : sQt, half ? sVt : sKt, ty, tx, x);
    const bool need_mask = (causal && k0 + kB - 1 > q0) || (k0 + kB > Sk);
    if (half == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = micro(ty, i);
        const float lse_r = sL[row];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = k0 + micro(tx, j);
          float p = p_of(x[i][j], scale, lse_r);
          if (need_mask && (key >= Sk || (causal && key > q0 + row)))
            p = 0.f;
          x[i][j] = p;
        }
      }
      half0_sync();   // every read of Kt by this half is done
      put_tile(sP, ty, tx, x);
    }
    __syncthreads();
    if (half == 1) {
      ds_of<true>(sP, sD, ty, tx, x);
      put_tile_bf16(sdS, ty, tx, x);
    }
    __syncthreads();

    // dQ += dS(bf16) K on the tensor cores; warp w owns rows 16 w .. + 15
#pragma unroll
    for (int j = 0; j < kB / 16; ++j) {
      uint32_t da[4];
      load_a<LDS>(da, sdS, warp * 16, j * 16, lane);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bb[4];
        load_b_trans<LD>(bb, cK, j * 16, dt * 8, lane);
        mma(acc[dt], da, bb[0], bb[1]);
        mma(acc[dt + 1], da, bb[2], bb[3]);
      }
    }
    __syncthreads();   // sdS and stage st are free
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Sq) continue;
    bf16* dst = dq + ((long long)b * Sq + row) * q_stride + (long long)h * D
                + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16(acc[dt][2 * r] * scale, acc[dt][2 * r + 1] * scale);
  }
}

template <int D>
constexpr int dkv_tc_smem_bytes() {
  // Kt, Vt, Qt, dOt fp32 [D][kB]; 2 stages of Q, dO bf16 [kB][D + kPad]
  // and of lse, delta [kB]; P^T bf16 [kB][kB + kPad].  P^T in fp32
  // ([kB][kB]) reuses Qt, dS^T (bf16) reuses dOt.
  return 4 * D * kB * 4 + 4 * kB * (D + fmma::kPad) * 2 + 4 * kB * 4
         + kB * (kB + fmma::kPad) * 2;
}

template <int D>
__global__ void __launch_bounds__(kT)
dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
              int Hq, int Hkv, float scale, int causal) {
  using namespace fmma;
  constexpr int LD = D + kPad;
  constexpr int LDS = kB + kPad;
  constexpr int DT = D / 8;
  extern __shared__ uint4 smem_tc[];
  float* sKt = reinterpret_cast<float*>(smem_tc);
  float* sVt = sKt + D * kB;
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
  const int kb = blockIdx.x;               // heaviest causal blocks first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
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
  to_f32_t<D>(sKt, kg + (long long)k0 * kv_stride, kv_stride, Sk - k0);
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
    tile_ffma<D>(half ? sVt : sKt, half ? sdOt : sQt, ty, tx, x);
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

template <typename Kern>
int set_smem(Kern kern, int smem, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;
  int B, Sq, Sk, Hq, Hkv;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a) {
  constexpr int smem = dq_smem_bytes<D>();
  static bool attr_set = false;
  if (int e = set_smem(flash_bwd_dq_kernel<T, D>, smem, attr_set)) return e;
  dim3 grid((a.Sq + kBlockQ - 1) / kBlockQ, a.Hq, a.B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.Sq, a.Sk, a.Hq, a.Hkv, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  constexpr int smem = dkv_smem_bytes<D>();
  static bool attr_set = false;
  if (int e = set_smem(flash_bwd_dkv_kernel<T, D>, smem, attr_set)) return e;
  dim3 grid((a.Sk + kBlockK - 1) / kBlockK, a.Hq, a.B);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.Sq, a.Sk,
      a.Hq, a.Hkv, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_tc(const Args& a) {
  constexpr int smem = dq_tc_smem_bytes<D>();
  static bool attr_set = false;
  if (int e = set_smem(dq_tc_kernel<D>, smem, attr_set)) return e;
  dim3 grid((a.Sq + kB - 1) / kB, a.Hq, a.B);
  dq_tc_kernel<D><<<grid, kT, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), a.Sq, a.Sk, a.Hq, a.Hkv, a.scale,
      a.causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_tc(const Args& a) {
  constexpr int smem = dkv_tc_smem_bytes<D>();
  static bool attr_set = false;
  if (int e = set_smem(dkv_tc_kernel<D>, smem, attr_set)) return e;
  dim3 grid((a.Sk + kB - 1) / kB, a.Hkv, a.B);
  dkv_tc_kernel<D><<<grid, kT, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1), a.Sq, a.Sk,
      a.Hq, a.Hkv, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <bool DQ>
int dispatch(const Args& a, int D, int dtype) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.Hkv <= 0 ||
      a.Hq % a.Hkv != 0 || a.B > 65535 || a.Hq > 65535 ||
      (a.causal && a.Sq != a.Sk) || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (D == 64) return DQ ? launch_dq<float, 64>(a) : launch_dkv<float, 64>(a);
    return DQ ? launch_dq<float, 128>(a) : launch_dkv<float, 128>(a);
  }
  if (dtype == 1) {
    if (D == 64) return DQ ? launch_dq_tc<64>(a) : launch_dkv_tc<64>(a);
    return DQ ? launch_dq_tc<128>(a) : launch_dkv_tc<128>(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ptt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int Sq, int Sk,
    int Hq, int Hkv, int D, float scale, int causal, int dtype,
    void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, B, Sq, Sk, Hq, Hkv,
               scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, D, dtype);
}

extern "C" int ptt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, float scale, int causal, int dtype,
    void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, Hq, Hkv,
               scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, D, dtype);
}
