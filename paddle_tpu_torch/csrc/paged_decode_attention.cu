// Paged flash-decode attention for Hopper (sm_90a): one new query token
// per sequence attends, grouped-query style, over that sequence's KV prefix
// stored in a shared block arena and reached through its block table.
//
// Replaces the TPU kernel
// paddle_tpu/ops/pallas/decode_attention.py:_paged_kernel (:492, driven by
// _decode_attention_pallas_paged :1019 and _paged_dispatch :981).
//
// Shapes (row-major, contiguous):
//   q, out  [B, Hkv, G, D]            query heads h*G .. h*G+G-1 share kv head h
//   arenas  [NB+1, L, Hkv*D]          (or [NB+1, L, Hkv, D]: same bytes)
//   tables  [B, max_blocks] int32     arena row of each logical block
//   lens    [B] int32                 LAST valid slot, inclusive
// Slots 0..lens[b] participate; the output is softmax(q K^T / sqrt(D)) V
// with fp32 logits, softmax and accumulation, stored in q's dtype.
//
// Bound: memory.  Per layer the function has to read the valid prefix of
// K and V once, sum_b (lens[b]+1) * 2 * Hkv * D * sizeof(T) bytes, at
// 3.35 TB/s on an H100 SXM; its 4 * Hq * D operations per slot are ~2 per
// byte, far below the tensor-core ridge.
//
// Design: one CTA per (b, kv head).  It keeps the G query heads of that kv
// head, an fp32 running max / denominator / accumulator per query head in
// shared memory, and walks the block table for j = 0 .. min(lens[b]/L,
// max_blocks-1): 16-byte vector loads bring one block of K and V for this
// head (D contiguous elements at lane offset h*D of each packed row) into
// shared memory as fp32, G*L logits are computed and masked past lens[b],
// and the online softmax rescales the accumulator before adding P V.  Only
// valid blocks are read, so traffic is O(valid prefix), like the TPU
// kernel's table-indirected DMAs.
//
// What differs from the TPU kernel: Pallas ran the batch as a sequential
// grid on one core and relied on VMEM scratch shared across grid steps
// (vbuf zeroed at program 0 only; the docstring at :503-517).  CTAs run in
// parallel and in no order on Hopper, so nothing is carried between CTAs:
// every CTA reads only the slots it needs and initialises its own state.
// Vacant rows carry all-trash tables; the zero-filled trash row keeps them
// finite.
//
// Known weakness (later work): B*Hkv CTAs (64 at 8 slots x 8 kv heads)
// leave most of the 132 SMs idle at small batch, and each CTA stages one
// block at a time without overlap.  Split-K over blocks, cp.async/TMA
// double buffering and a warp per query head are the next steps.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/decode_attention.py):
//   int ptt_paged_decode_attention(q, k_arena, v_arena, tables, lens, out,
//                                  B, Hkv, G, D, L, max_blocks, num_rows,
//                                  scale, dtype, stream)
//   dtype 0 = float32, 1 = bfloat16; D % 8 == 0 and 16-byte aligned
//   pointers (the wrapper checks).  Returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int kN = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int kN = 8; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
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
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_arena,
                    const T* __restrict__ v_arena,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ out,
                    int hkv, int g, int d, int L, int max_blocks,
                    int num_rows, float scale) {
  constexpr int V = VecWidth<T>::kN;
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

  const int vpr = d / V;  // 16-byte vectors per head row
  for (int j = 0; j < nblk; ++j) {
    // a table entry outside the arena is clamped to its last row (the
    // trash row), as an out-of-range gather clamps in the JAX package
    const int blk = min(max(tables[(size_t)b * max_blocks + j], 0),
                        num_rows - 1);
    const size_t base = (size_t)blk * L * row_stride + (size_t)h * d;
    for (int i = tid; i < L * vpr; i += kThreads) {
      const int l = i / vpr;
      const int c = (i - l * vpr) * V;
      const size_t off = base + (size_t)l * row_stride + c;
      const uint4 kraw = *reinterpret_cast<const uint4*>(k_arena + off);
      const uint4 vraw = *reinterpret_cast<const uint4*>(v_arena + off);
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
        // no valid slot seen yet (cannot happen for lens >= 0: block j
        // always holds slot j*L <= lens); keep the state untouched
        for (int l = 0; l < L; ++l) pr[l] = 0.f;
      } else {
        alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        for (int l = 0; l < L; ++l) {
          const float p = pr[l] == -INFINITY ? 0.f : expf(pr[l] - m_new);
          pr[l] = p;
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
int launch(const void* q, const void* k_arena, const void* v_arena,
           const int* tables, const int* lens, void* out, int B, int hkv,
           int g, int d, int L, int max_blocks, int num_rows, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats(g, d, L) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(hkv, B);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_arena),
      static_cast<const T*>(v_arena), tables, lens, static_cast<T*>(out),
      hkv, g, d, L, max_blocks, num_rows, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptt_paged_decode_attention(
    const void* q, const void* k_arena, const void* v_arena,
    const void* tables, const void* lens, void* out, int B, int hkv, int g,
    int d, int L, int max_blocks, int num_rows, float scale, int dtype,
    void* stream) {
  if (B <= 0 || hkv <= 0 || g <= 0 || L <= 0 || max_blocks <= 0 ||
      num_rows <= 0 ||
      d <= 0 || d % 8 != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lens);
  if (dtype == 0)
    return launch<float>(q, k_arena, v_arena, tb, ln, out, B, hkv, g, d, L,
                         max_blocks, num_rows, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_arena, v_arena, tb, ln, out, B, hkv,
                                 g, d, L, max_blocks, num_rows, scale, s);
  return (int)cudaErrorInvalidValue;
}
