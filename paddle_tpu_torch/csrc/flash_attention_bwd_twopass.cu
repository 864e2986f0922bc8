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
//   dk_acc, dv_acc [B, Sk, Hq, D]  float32, PER QUERY HEAD (dkv kernel):
//                                  the caller sums each group of Hq/Hkv
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
// three gradients.
//
// Design.  The Pallas kernels are the two halves of FlashAttention-2 and
// map onto Hopper as they are: the dQ kernel's grid is (query block, bh)
// with K and V walked in a fori_loop; the dK/dV kernel's is (key block,
// bh) with Q and dO walked.  Here each is one CTA of 256 threads per
// (64-row block, query head, batch row), on the 16 x 16 thread grid and
// the fp32 shared tiles of flash_common.cuh:
//   dq kernel:  Q, dO, lse and delta of its query block stay resident in
//     shared memory; it walks key blocks from 0 up to the causal diagonal
//     (the bound at :220-222), staging each K and V tile, rebuilds P, dP
//     and dS, stores dS (cast to k's dtype) as [query][key] in shared
//     memory and adds dS K into fp32 registers; at the end it writes
//     dQ * scale in q's dtype.  No atomics, so dQ is bit-identical from
//     run to run (the one-pass kernel adds dQ with fp32 atomicAdd).
//   dkv kernel: K and V of its key block stay resident; it walks query
//     blocks from the diagonal to the end (:256), staging Q, dO, lse and
//     delta, and keeps dK and dV in registers, as the one-pass kernel
//     (flash_attention_bwd.cu) does without its dQ share.  GQA: each CTA
//     writes its own query head's fp32 dK and dV.
// CUDA-core fp32 FMA over float4 shared-memory reads, no tensor cores and
// no load/compute overlap: a simple kernel that is right first.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/flash_attention.py):
//   int ptt_flash_attention_bwd_dq(q, k, v, do, lse, delta, dq, B, Sq, Sk,
//                                  Hq, Hkv, D, scale, causal, dtype, stream)
//   int ptt_flash_attention_bwd_dkv(q, k, v, do, lse, delta, dk_acc,
//                                   dv_acc, B, Sq, Sk, Hq, Hkv, D, scale,
//                                   causal, dtype, stream)
//   dtype 0 = float32, 1 = bfloat16; D in {64, 128}; Hq % Hkv == 0; 16-byte
//   aligned pointers (the wrapper checks).  Return cudaGetLastError().

#include "flash_common.cuh"

#include <math.h>

namespace {

using namespace flash;

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

template <bool DQ, typename T>
int launch_d(const Args& a, int D) {
  if (D == 64) return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
  if (D == 128) return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
  return (int)cudaErrorInvalidValue;
}

template <bool DQ>
int dispatch(const Args& a, int D, int dtype) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.Hkv <= 0 ||
      a.Hq % a.Hkv != 0 || a.B > 65535 || a.Hq > 65535 ||
      (a.causal && a.Sq != a.Sk))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_d<DQ, float>(a, D);
  if (dtype == 1) return launch_d<DQ, __nv_bfloat16>(a, D);
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
    const void* lse, const void* delta, void* dk_acc, void* dv_acc, int B,
    int Sq, int Sk, int Hq, int Hkv, int D, float scale, int causal,
    int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk_acc, dv_acc, B, Sq, Sk, Hq, Hkv,
               scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, D, dtype);
}
