// Paged flash-decode attention over an int8 KV cache for Hopper (sm_90a):
// one new query token per sequence attends, grouped-query style, over
// that sequence's KV prefix, stored as int8 codes with one f32 absmax
// scale per written entry per kv head, in a shared block arena reached
// through the sequence's block table.
//
// Replaces the TPU kernel
// paddle_tpu/ops/pallas/decode_attention.py:_paged_kernel_q (:583, driven
// by _decode_attention_pallas_paged_q :1041 and _paged_dispatch :981).
//
// Shapes (row-major, contiguous):
//   q, out          [B, Hkv, G, D] f32/bf16  query heads h*G .. h*G+G-1 share kv head h
//   k/v codes       [NB+1, L, Hkv*D] int8     (or [NB+1, L, Hkv, D]: same bytes)
//   k/v scales      [NB+1, L, Hkv] f32        entry (slot, head) = codes * scale
//   tables          [B, max_blocks] int32     arena row of each logical block
//   lens            [B] int32                 LAST valid slot, inclusive
// Each staged K/V element is dequantized as code * scale in fp32 and
// rounded to q's dtype before any dot, as paged_dequant_view
// (decode_attention.py:199) and the Pallas kernel (:648-649, :678-679)
// do.  Logits and the softmax are fp32; P is rounded to q's dtype before
// P V (relative to the running max of the online softmax, as the Pallas
// kernel rounds it relative to its row max), the denominator sums the
// unrounded P, and the output is stored in q's dtype.
//
// Bound: memory.  Per layer the function reads the valid prefix once:
// sum_b (lens[b]+1) * 2 * Hkv * (D + 4) bytes (codes plus scales), half
// of a bf16 cache's D * 2 per head; its 4 * Hq * D operations per slot are
// about 4 per byte, far below the tensor-core ridge.
//
// Design: slice 1's float kernel (csrc/paged_decode_attention.cu) with
// int8 staging.  One CTA per (b, kv head) keeps the G query heads of that
// kv head, an fp32 running max / denominator / accumulator per query head
// in shared memory, and walks the block table for j = 0 .. min(lens[b]/L,
// max_blocks-1): 16-byte loads bring 16 codes of one slot's head row at a
// time, each thread dequantizes them with the slot's scale for this head
// (one f32 load) and stores the rounded values in shared memory as fp32.
// Only valid blocks are read, and in the last block no slot past
// lens[b]: its shared-memory row is zeroed and its logit masked to
// weight 0, so nothing of an unwritten slot (codes or scale) can reach
// the output.
//
// What differs from the TPU kernel: the Pallas kernel zeroes its V scale
// buffer at program 0 because VMEM scratch persists across its sequential
// grid (:599-608).  CTAs here share no state and read only blocks the
// table names for the row, so there is nothing to zero.
//
// Known weakness (later work): as the float kernel, B*Hkv CTAs leave most
// SMs idle at small batch and each CTA stages one block at a time; split-K
// over blocks and cp.async/TMA double buffering come next.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/decode_attention.py):
//   int ptt_paged_decode_attention_int8(q, k_codes, v_codes, k_scales,
//       v_scales, tables, lens, out, B, Hkv, G, D, L, max_blocks, num_rows,
//       scale, dtype, stream)
//   dtype 0 = float32, 1 = bfloat16; D % 16 == 0 and 16-byte aligned
//   pointers (the wrapper checks).  Returns cudaGetLastError().

#include "dtype.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using ptt::from_f32;
using ptt::to_f32;

constexpr int kThreads = 128;
constexpr int kVec = 16;   // int8 codes per 16-byte load

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// fp32 words of shared memory one CTA uses (see the layout below)
__host__ __device__ inline size_t smem_floats(int g, int d, int L) {
  return (size_t)g * d            // q
         + (size_t)L * (d + 1)    // K block, rows padded against bank conflicts
         + (size_t)L * d          // V block
         + (size_t)g * L          // logits / probabilities
         + (size_t)g * d          // accumulator
         + 3 * (size_t)g;         // running max, denominator, rescale
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_int8_kernel(const T* __restrict__ q,
                         const int8_t* __restrict__ k_codes,
                         const int8_t* __restrict__ v_codes,
                         const float* __restrict__ k_scales,
                         const float* __restrict__ v_scales,
                         const int* __restrict__ tables,
                         const int* __restrict__ lens, T* __restrict__ out,
                         int hkv, int g, int d, int L, int max_blocks,
                         int num_rows, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                   // [g][d]
  float* k_s = q_s + g * d;            // [L][d+1]
  float* v_s = k_s + L * (d + 1);      // [L][d]
  float* p_s = v_s + L * d;            // [g][L]
  float* acc_s = p_s + g * L;          // [g][d]
  float* m_s = acc_s + g * d;          // [g]
  float* l_s = m_s + g;                // [g]
  float* a_s = l_s + g;                // [g]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int row_stride = hkv * d;
  const int len = lens[b];
  int nblk = len / L + 1;
  if (nblk > max_blocks) nblk = max_blocks;

  const size_t qoff = ((size_t)b * hkv + h) * g * d;
  for (int i = tid; i < g * d; i += kThreads) {
    q_s[i] = to_f32(q[qoff + i]);
    acc_s[i] = 0.f;
  }
  if (tid < g) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int vpr = d / kVec;  // 16-byte code vectors per head row
  for (int j = 0; j < nblk; ++j) {
    // a table entry outside the arena is clamped to its last row (the
    // trash row), as an out-of-range gather clamps in the JAX package
    const int blk = min(max(tables[(size_t)b * max_blocks + j], 0),
                        num_rows - 1);
    const size_t base = (size_t)blk * L * row_stride + (size_t)h * d;
    const size_t sbase = (size_t)blk * L * hkv + h;
    for (int i = tid; i < L * vpr; i += kThreads) {
      const int l = i / vpr;
      const int c = (i - l * vpr) * kVec;
      if (j * L + l > len) {
        // past the last valid slot: never read, staged as zeros
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          k_s[l * (d + 1) + c + e] = 0.f;
          v_s[l * d + c + e] = 0.f;
        }
        continue;
      }
      const size_t off = base + (size_t)l * row_stride + c;
      const uint4 kraw = *reinterpret_cast<const uint4*>(k_codes + off);
      const uint4 vraw = *reinterpret_cast<const uint4*>(v_codes + off);
      const float ks = k_scales[sbase + (size_t)l * hkv];
      const float vs = v_scales[sbase + (size_t)l * hkv];
      const int8_t* kc = reinterpret_cast<const int8_t*>(&kraw);
      const int8_t* vc = reinterpret_cast<const int8_t*>(&vraw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        k_s[l * (d + 1) + c + e] = round_to<T>((float)kc[e] * ks);
        v_s[l * d + c + e] = round_to<T>((float)vc[e] * vs);
      }
    }
    __syncthreads();

    for (int i = tid; i < g * L; i += kThreads) {
      const int gi = i / L;
      const int l = i - gi * L;
      float s = -INFINITY;
      if (j * L + l <= len) {
        const float* qr = q_s + gi * d;
        const float* kr = k_s + l * (d + 1);
        float acc = 0.f;
        for (int e = 0; e < d; ++e) acc += qr[e] * kr[e];
        s = acc * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();

    if (tid < g) {
      float* pr = p_s + tid * L;
      const float m_old = m_s[tid];
      float m_new = m_old;
      for (int l = 0; l < L; ++l) m_new = fmaxf(m_new, pr[l]);
      float alpha = 1.f;
      float sum = 0.f;
      if (m_new == -INFINITY) {
        // no valid slot seen yet (cannot happen for lens >= 0: block j
        // always holds slot j*L <= lens); keep the state untouched
        for (int l = 0; l < L; ++l) pr[l] = 0.f;
      } else {
        alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        for (int l = 0; l < L; ++l) {
          const float p = pr[l] == -INFINITY ? 0.f : expf(pr[l] - m_new);
          pr[l] = round_to<T>(p);   // P in q's dtype before P V
          sum += p;
        }
      }
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < g * d; i += kThreads) {
      const int gi = i / d;
      const int e = i - gi * d;
      const float* pr = p_s + gi * L;
      float acc = acc_s[i] * a_s[gi];
      for (int l = 0; l < L; ++l) acc += pr[l] * v_s[l * d + e];
      acc_s[i] = acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < g * d; i += kThreads) {
    out[qoff + i] = from_f32<T>(acc_s[i] / l_s[i / d]);
  }
}

template <typename T>
int launch(const void* q, const int8_t* k_codes, const int8_t* v_codes,
           const float* k_scales, const float* v_scales, const int* tables,
           const int* lens, void* out, int B, int hkv, int g, int d, int L,
           int max_blocks, int num_rows, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(g, d, L) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_int8_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(hkv, B);
  paged_decode_int8_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), k_codes, v_codes, k_scales, v_scales, tables,
      lens, static_cast<T*>(out), hkv, g, d, L, max_blocks, num_rows, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptt_paged_decode_attention_int8(
    const void* q, const void* k_codes, const void* v_codes,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* lens, void* out, int B, int hkv, int g, int d, int L,
    int max_blocks, int num_rows, float scale, int dtype, void* stream) {
  if (B <= 0 || hkv <= 0 || g <= 0 || L <= 0 || max_blocks <= 0 ||
      num_rows <= 0 || d <= 0 || d % kVec != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* kc = static_cast<const int8_t*>(k_codes);
  const int8_t* vc = static_cast<const int8_t*>(v_codes);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lens);
  if (dtype == 0)
    return launch<float>(q, kc, vc, ks, vs, tb, ln, out, B, hkv, g, d, L,
                         max_blocks, num_rows, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kc, vc, ks, vs, tb, ln, out, B, hkv, g,
                                 d, L, max_blocks, num_rows, scale, s);
  return (int)cudaErrorInvalidValue;
}
