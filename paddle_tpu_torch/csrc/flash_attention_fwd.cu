// Flash-attention forward for Hopper (sm_90a): blocked online-softmax
// attention that writes O and the row log-sum-exp (LSE), the one softmax
// residual the backward needs.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py:
// _fwd_kernel (:161, launched by _flash_fwd_impl :400).
//
// Shapes (row-major, contiguous):
//   q, o  [B, Sq, Hq, D]       float32 or bfloat16
//   k, v  [B, Sk, Hkv, D]      query head h reads kv head h / (Hq / Hkv)
//   lse   [B, Hq, Sq]          float32, compact (the TPU kernel's
//                              128-lane broadcast is a TPU tiling rule)
// Arithmetic, as the TPU kernel's: scores q.k in fp32 times 1/sqrt(D),
// masked to -1e30 (causal: key > query; and keys past Sk), running max m
// and denominator l in fp32, P = exp(s - m) cast to v's dtype before P V,
// fp32 accumulation, O = acc / max(l, 1e-30), LSE = m + log(max(l, 1e-30)).
//
// Bound: operations.  Causal, the function does 4*B*Hq*Sq*Sk*D/2 flops
// (two products over half the score square) against the bytes of q, k, v,
// o and lse: at the training shape (B=8, S=2048, Hq=32, D=64) about 1,000
// flops per byte, far above the H100's ridge.
//
// Design: one CTA of 256 threads per (64-query block, query head, batch
// row), heaviest causal blocks first.  The query tile stays in shared
// memory as fp32; the CTA walks the key blocks that the causal triangle
// reaches (the TPU kernel's `upper` early exit), staging each K and V tile
// in shared memory and computing the 64 x 64 scores and P V with CUDA-core
// fp32 FMA from float4 shared-memory reads (flash_common.cuh).  GQA needs
// no copies: the CTA reads its kv head directly.  This is a simple kernel
// that is right first: no tensor cores (a float32 input stays true fp32),
// no overlap of loads with compute; mma/wgmma, cp.async/TMA pipelines and
// warp specialisation are later work.
//
// What differs from the TPU kernel: Pallas held whole [S, D] K and V in
// VMEM per grid step; here a K/V tile is 64 rows, restaged per block, and
// S need not be a multiple of the tile (the ragged edge is masked).
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/flash_attention.py):
//   int ptt_flash_attention_fwd(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, D,
//                               scale, causal, dtype, stream)
//   dtype 0 = float32, 1 = bfloat16; D in {64, 128}; Hq % Hkv == 0; 16-byte
//   aligned pointers (the wrapper checks).  Returns cudaGetLastError().

#include "flash_common.cuh"

#include <math.h>

namespace {

using namespace flash;

template <int D>
constexpr int fwd_smem_bytes() {
  return (3 * kBlockK * (D + 4) + kBlockQ * (kBlockK + 4)) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                 float scale, int causal) {
  constexpr int LD = D + 4;
  constexpr int LDP = kBlockK + 4;
  constexpr int DC = D / 16;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBlockQ * LD;
  float* sV = sK + kBlockK * LD;
  float* sP = sV + kBlockK * LD;

  const int nqb = (Sq + kBlockQ - 1) / kBlockQ;
  const int qb = nqb - 1 - (int)blockIdx.x;   // heaviest causal blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qb * kBlockQ;

  const long long q_stride = (long long)Hq * D;
  const long long kv_stride = (long long)Hkv * D;
  const T* qg = q + ((long long)b * Sq * Hq + h) * D;
  const T* kg = k + ((long long)b * Sk * Hkv + hk) * D;
  const T* vg = v + ((long long)b * Sk * Hkv + hk) * D;

  load_tile<T, D, kBlockQ>(sQ, qg, q_stride, q0, Sq - q0);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int n_kb = (Sk + kBlockK - 1) / kBlockK;
  const int upper =
      causal ? min((q0 + kBlockQ + kBlockK - 1) / kBlockK, n_kb) : n_kb;

  for (int kb = 0; kb < upper; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();   // the previous block's reads of sK, sV, sP are done
    load_tile<T, D, kBlockK>(sK, kg, kv_stride, k0, Sk - k0);
    load_tile<T, D, kBlockK>(sV, vg, kv_stride, k0, Sk - k0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    rows_dot_rows<D>(sQ, sK, tx, ty, s);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float val = s[i][j] * scale;
        if (kpos >= Sk || (causal && kpos > qpos)) val = kNegInf;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = round_to<T>(p);
      }
      rs = row_sum16(rs);
      l[i] = alpha * l[i] + rs;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();   // P visible to the whole CTA
    rows_times_tile<D>(sP, sV, tx, ty, 16, acc);
  }

  T* og = o + ((long long)b * Sq * Hq + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = og + (long long)row * q_stride + tx * 4;
#pragma unroll
    for (int c2 = 0; c2 < D / 64; ++c2)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[c2 * 64 + e] = from_f32<T>(acc[i][c2 * 4 + e] / l_safe);
    if (tx == 0)
      lse[((long long)b * Hq + h) * Sq + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
           cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Sq, Sk, Hq, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int Sq, int Sk, int Hq, int Hkv, int D, float scale,
             int causal, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal,
                         stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, scale, causal,
                          stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ptt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int Sq, int Sk, int Hq, int Hkv,
                                       int D, float scale, int causal,
                                       int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      B > 65535 || Hq > 65535 || (causal && Sq != Sk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, D, scale,
                           causal, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, D,
                                   scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
