// One-pass flash-attention backward for Hopper (sm_90a): dQ, dK and dV in
// one kernel from the forward's LSE and delta = rowsum(dO * O), rebuilding
// the softmax weights P once per (query block, key block) pair.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py:
// _onepass_bwd_kernel (:292, launched by _flash_bwd_onepass :351; delta is
// computed outside the kernel, as at :450).
//
// Shapes (row-major, contiguous):
//   q, do        [B, Sq, Hq, D]    float32 or bfloat16
//   k, v         [B, Sk, Hkv, D]   query head h reads kv head h / (Hq/Hkv)
//   lse, delta   [B, Hq, Sq]       float32
//   dq_acc       [B, Sq, Hq, D]    float32, zeroed by the caller; the
//                                  kernel adds scale * dS K into it
//   dk, dv, by dtype:
//     bfloat16   [B, Sk, Hkv, D]   k's dtype: each kv head's gradient,
//                                  summed over its G = Hq/Hkv query heads
//                                  in fp32 registers and written once
//     float32    [B, Sk, Hq, D]    fp32 PER QUERY HEAD: the caller sums
//                                  each group of G
// Arithmetic, as the TPU kernel's: s = q.k * scale, masked (p = 0 past the
// causal diagonal and the ragged edge); P = exp(s - lse); dP = dO.v;
// dS = P * (dP - delta); dV += P^T dO with P cast to dO's dtype; dK +=
// dS^T Q * scale and dQ += dS K * scale with dS cast to the input dtype;
// every product accumulates in fp32.
//
// Bound: operations.  Causal, the function does five score-sized products
// (Q K^T, dO V^T, P^T dO, dS^T Q, dS K: 5 * B*Hq*Sq*Sk*D flops) against
// the bytes of q, k, v, o, do, lse and the three gradients, far above the
// H100's ridge.  Two of them must run on CUDA cores (below), so the
// kernel's floor is theirs: 2 * D fmaf per unmasked score (causal:
// 2 * B*Hq*Sq*Sk*D/2 fmaf) at the fp32 rate of 67 TFLOP/s = 33.5e12
// fmaf/s, 2.05 ms at the training shape (B=8, S=2048, Hq=32, D=64), the
// same floor as one two-pass kernel, since this kernel builds S and dP
// once.
//
// Design, and what differs from the TPU kernel.  The Pallas kernel runs a
// SEQUENTIAL grid over query blocks and keeps dK and dV as whole-[Sk, D]
// fp32 blocks resident in VMEM across it (docstring :295-300, zeroed at
// qi == 0, :303).  Hopper runs CTAs in parallel and in no order, so that
// carry does not exist here.  Instead, FlashAttention-2's order.
//
// bfloat16 (dkv_tc_kernel<D, true>, flash_bwd_tc.cuh): one CTA of 4 warps
// per (64-key block, KV head, batch row); the grid launches the heaviest
// causal key blocks of all (row, kv head) pairs first, so the launch ends
// on the lightest.
// K and V of the key block stay resident (fp32, transposed, for the
// CUDA-core products); the CTA walks the G query heads of its kv head
// and, for each, the query blocks from the causal diagonal to the end,
// their Q, dO, LSE and delta streamed through a 2-stage cp.async ring of
// padded bf16 tiles, so block n + 1 is in flight while block n computes.
// So each K/V tile is read once per group, not once per query head.
//   - S and dP on CUDA cores, as the plain version's ascending-d fmaf
//     chains, bit for bit.  Row 0 of every causal head attends to one
//     key, so dP - delta there cancels to fp32 rounding noise and dQ IS
//     that noise; the dQ tolerance (2^-8 of the row's RMS) holds only the
//     plain version's own noise, which a tensor-core sum of the same
//     products, rounded differently, misses.
//   - P^T(bf16) dO, dS^T(bf16) Q and dS(bf16) K on the tensor cores
//     (mma.sync m16n8k16, operands through ldmatrix; dS for dS K through
//     ldmatrix.trans of the key-major dS^T tile, K repacked from the fp32
//     tile, whose rows are padded to kB + 8 floats so that those reads
//     are conflict-free).
//   - dK and dV stay in fp32 registers across the whole group and are
//     written once as [B, Sk, Hkv, D] in k's dtype: no fp32 per-head
//     buffers and no group sum outside.
//   - Each pair's [64, D] share of dQ * scale goes into dq_acc by fp32
//     vector atomics (atomicAdd on float4, sm_90), one per lane per 8
//     columns after two lanes swap halves of their m16n8 accumulators.
//     dQ's summation order therefore varies from run to run (last-bit
//     differences only).
//
// float32 (flash_bwd_kernel below, the first port's, unchanged; TF32
// would break the float32 tolerance): one CTA of 256 threads per (64-key
// block, QUERY head, batch row) keeps its K and V tiles in fp32 shared
// memory and its dK and dV rows in registers, loops over the query
// blocks that the causal triangle reaches and adds each query block's
// share of dQ into dq_acc with atomicAdd; it writes its own query head's
// fp32 dK and dV, so no two CTAs write the same element, and the caller
// sums each group.  CUDA-core fp32 FMA over float4 shared-memory reads
// (flash_common.cuh), no load/compute overlap.
//
// Measured by chip_smoke.py phase 2 (NVIDIA H100 80GB HBM3, 700.00 W;
// bf16, B=8 S=2048 Hq=32 Hkv=8 D=64 causal, through flash_attention_bwd,
// delta and casts included): 5.9768 ms, against the first design's 12.38,
// SDPA's backward 1.46 and the fp32-rate floor of 2.05 above.  Before the
// grid launched the heaviest key blocks of all heads first (and before
// the wrapper's delta lost one pass), a full run measured 6.75 ms.
// PERF.md's kernel table, row 5, keeps the current numbers.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/flash_attention.py):
//   int ptt_flash_attention_bwd(q, k, v, do, lse, delta, dq_acc, dk, dv, B,
//                               Sq, Sk, Hq, Hkv, D, scale, causal, dtype,
//                               stream)
//   dtype 0 = float32, 1 = bfloat16; D in {64, 128}; Hq % Hkv == 0; 16-byte
//   aligned pointers (the wrapper checks).  Returns cudaGetLastError().

#include "flash_common.cuh"
#include "flash_bwd_tc.cuh"

#include <math.h>

namespace {

using namespace flash;

template <int D>
constexpr int bwd_smem_bytes() {
  return (4 * kBlockK * (D + 4) + 2 * kBlockK * (kBlockQ + 4) + 2 * kBlockQ)
         * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq_acc,
                 float* __restrict__ dk_acc, float* __restrict__ dv_acc,
                 int Sq, int Sk, int Hq, int Hkv, float scale, int causal) {
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

    // scores and dP for rows = queries ty + 16 i, cols = keys tx + 16 j
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
        const int kj = tx + 16 * j;
        const int kpos = k0 + kj;
        float p = 0.f;
        if (qpos < Sq && kpos < Sk && !(causal && kpos > qpos))
          p = expf(s[i][j] * scale - row_lse);
        const float ds = p * (dp[i][j] - row_delta);
        sPt[kj * LDP + qi] = round_to<T>(p);
        sdSt[kj * LDP + qi] = round_to<T>(ds);
      }
    }
    __syncthreads();   // P^T and dS^T visible to the whole CTA

    // dV += P^T dO and dK += dS^T Q: rows = keys ty + 16 i
    rows_times_tile<D>(sPt, sdO, tx, ty, 16, dv);
    rows_times_tile<D>(sdSt, sQ, tx, ty, 16, dk);

    // this query block's share of dQ = dS K: rows = queries ty*4 + i
    float dq[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;
    cols_times_tile<D>(sdSt, sK, tx, ty * 4, dq);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (row >= Sq) continue;
      float* dst = dq_acc + ((long long)b * Sq + row) * q_stride
                   + (long long)h * D + tx * 4;
#pragma unroll
      for (int c2 = 0; c2 < D / 64; ++c2)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          atomicAdd(dst + c2 * 64 + e, dq[i][c2 * 4 + e] * scale);
    }
  }

  // dK (times scale) and dV of this query head, written once
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int B, int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
           cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((Sk + kBlockK - 1) / kBlockK, Hq, B);
  flash_bwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), Sq, Sk, Hq, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, void* dk,
              void* dv, int B, int Sq, int Sk, int Hq, int Hkv, float scale,
              int causal, cudaStream_t stream) {
  using flash_tc::bf16;
  constexpr int smem = flash_tc::dkv_tc_smem_bytes<D, true>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_tc::dkv_tc_kernel<D, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(Hkv, B, (Sk + flash_tc::kB - 1) / flash_tc::kB);
  flash_tc::dkv_tc_kernel<D, true><<<grid, flash_tc::kT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(dq),
      Sq, Sk, Hq, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, void* dk, void* dv,
             int B, int Sq, int Sk, int Hq, int Hkv, int D, float scale,
             int causal, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk,
                         Hq, Hkv, scale, causal, stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk,
                          Hq, Hkv, scale, causal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ptt_flash_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq_acc, void* dk_acc,
                                       void* dv_acc, int B, int Sq, int Sk,
                                       int Hq, int Hkv, int D, float scale,
                                       int causal, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      B > 65535 || Hq > 65535 || (Sk + 63) / 64 > 65535 ||
      (causal && Sq != Sk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, dout, lse, delta, dq_acc, dk_acc, dv_acc,
                           B, Sq, Sk, Hq, Hkv, D, scale, causal, st);
  if (dtype == 1) {
    if (D == 64)
      return launch_tc<64>(q, k, v, dout, lse, delta, dq_acc, dk_acc, dv_acc,
                           B, Sq, Sk, Hq, Hkv, scale, causal, st);
    if (D == 128)
      return launch_tc<128>(q, k, v, dout, lse, delta, dq_acc, dk_acc,
                            dv_acc, B, Sq, Sk, Hq, Hkv, scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}
