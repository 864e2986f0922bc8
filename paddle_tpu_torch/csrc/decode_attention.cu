// Flash-decode attention over a DENSE KV cache for Hopper (sm_90a): one new
// query token per sequence attends, grouped-query style, over slots
// 0 .. lens[b] of that sequence's contiguous cache.  The cache of the
// greedy generate() program (and so of the draft model of speculative
// decoding).
//
// Replaces the TPU kernel
// paddle_tpu/ops/pallas/decode_attention.py:_kernel (:398, driven by
// _decode_attention_pallas :912).
//
// Shapes (row-major, contiguous):
//   q, out   [B, Hkv, G, D] f32/bf16  query heads h*G .. h*G+G-1 share kv head h
//   caches   [B, S, Hkv*D] q's dtype  (or [B, S, Hkv, D]: same bytes), any S
//   lens     [B] int32 >= 0           LAST valid slot, inclusive
// Slots 0 .. min(lens[b], S-1) participate; the output is softmax(q K^T /
// sqrt(D)) V with fp32 logits, softmax and accumulation, P rounded to q's
// dtype before P V (relative to the running max of the online softmax, as
// the Pallas kernel rounds it relative to its row max; the denominator sums
// the unrounded P), stored in q's dtype.
//
// Bound: memory.  Per layer the function has to read the valid prefix of
// K and V once, sum_b (lens[b]+1) * 2 * Hkv * D * sizeof(T) bytes; its
// 4 * Hq * D operations per slot are ~2 per byte, far below the
// tensor-core ridge.
//
// Design: the paged kernel (csrc/paged_decode_attention.cu) with the block
// table replaced by the row's contiguous cache.  One CTA per (b, kv head)
// keeps the G query heads of that kv head and an fp32 running max /
// denominator / accumulator per query head in shared memory, and walks the
// row in chunks of kChunk slots, j = 0 .. min(lens[b]/kChunk,
// ceil(S/kChunk) - 1): 16-byte loads stage one chunk of K and V for this
// head in shared memory as fp32; slots past lens[b] or past S are never
// read and are staged as zeros.  Any S is taken: the TPU kernel's S % 8 is
// a tiling rule of that chip, and the draft model pads to max_context +
// max_draft.
//
// What differs from the TPU kernel: Pallas ran the batch as a sequential
// grid on one core and relied on VMEM scratch shared across grid steps
// (vbuf zeroed at program 0 only; the docstring at :402-420).  CTAs here
// share no state, and every CTA reads only the slots it needs.
//
// Known weakness (later work): B*Hkv CTAs (8 at one draft sequence x 8 kv
// heads) leave most SMs idle and each stages one chunk at a time; split-K
// over chunks and cp.async double buffering come next.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/decode_attention.py):
//   int ptt_decode_attention(q, k_cache, v_cache, lens, out, B, Hkv, G, D,
//                            S, scale, dtype, stream)
//   dtype 0 = float32, 1 = bfloat16; D % 8 == 0 and 16-byte aligned
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
constexpr int kChunk = 16;   // cache slots staged per step

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int kN = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int kN = 8; };

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// fp32 words of shared memory one CTA uses (see the layout below)
__host__ __device__ inline size_t smem_floats(int g, int d) {
  return (size_t)g * d                  // q
         + (size_t)kChunk * (d + 1)     // K chunk, rows padded against bank conflicts
         + (size_t)kChunk * d           // V chunk
         + (size_t)g * kChunk           // logits / probabilities
         + (size_t)g * d                // accumulator
         + 3 * (size_t)g;               // running max, denominator, rescale
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
              const T* __restrict__ v_cache, const int* __restrict__ lens,
              T* __restrict__ out, int hkv, int g, int d, int S,
              float scale) {
  constexpr int V = VecWidth<T>::kN;
  constexpr int L = kChunk;
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
  const int len = min(lens[b], S - 1);
  const int nchunk = len / L + 1;

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

  const size_t base = (size_t)b * S * row_stride + (size_t)h * d;
  const int vpr = d / V;  // 16-byte vectors per head row
  for (int j = 0; j < nchunk; ++j) {
    for (int i = tid; i < L * vpr; i += kThreads) {
      const int l = i / vpr;
      const int c = (i - l * vpr) * V;
      const int slot = j * L + l;
      if (slot > len) {
        // past the last valid slot (or the cache): never read, zeros
#pragma unroll
        for (int e = 0; e < V; ++e) {
          k_s[l * (d + 1) + c + e] = 0.f;
          v_s[l * d + c + e] = 0.f;
        }
        continue;
      }
      const size_t off = base + (size_t)slot * row_stride + c;
      const uint4 kraw = *reinterpret_cast<const uint4*>(k_cache + off);
      const uint4 vraw = *reinterpret_cast<const uint4*>(v_cache + off);
      const T* kv = reinterpret_cast<const T*>(&kraw);
      const T* vv = reinterpret_cast<const T*>(&vraw);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        k_s[l * (d + 1) + c + e] = to_f32(kv[e]);
        v_s[l * d + c + e] = to_f32(vv[e]);
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
        // no valid slot seen yet (cannot happen for lens >= 0: chunk j
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
int launch(const void* q, const void* k_cache, const void* v_cache,
           const int* lens, void* out, int B, int hkv, int g, int d, int S,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(g, d) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(hkv, B);
  decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), lens, static_cast<T*>(out), hkv, g, d,
      S, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptt_decode_attention(const void* q, const void* k_cache,
                                    const void* v_cache, const void* lens,
                                    void* out, int B, int hkv, int g, int d,
                                    int S, float scale, int dtype,
                                    void* stream) {
  if (B <= 0 || hkv <= 0 || g <= 0 || d <= 0 || S <= 0 || d % 8 != 0 ||
      B > 65535 || hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  if (dtype == 0)
    return launch<float>(q, k_cache, v_cache, ln, out, B, hkv, g, d, S,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, ln, out, B, hkv, g, d,
                                 S, scale, s);
  return (int)cudaErrorInvalidValue;
}
