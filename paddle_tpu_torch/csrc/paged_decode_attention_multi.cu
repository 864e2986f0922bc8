// K-wide paged flash-decode attention for Hopper (sm_90a): the attention
// of a speculative-decoding verify forward.  Each sequence brings C = K+1
// query tokens (its last emitted token plus K draft candidates) at global
// slots lens[b] .. lens[b]+C-1; query c attends, grouped-query style, to
// slots <= lens[b] + c of that sequence's KV, stored in a shared block
// arena and reached through the sequence's block table.  One templated
// source serves a float cache and an int8 cache (codes plus one f32 absmax
// scale per written entry per kv head).
//
// Replaces the TPU kernels
//   paddle_tpu/ops/pallas/decode_attention.py:_paged_multi_kernel   (:692)
//   paddle_tpu/ops/pallas/decode_attention.py:_paged_multi_kernel_q (:787)
// driven by _decode_attention_pallas_paged_multi{,_q} (:1079, :1107) and
// _paged_dispatch (:981).
//
// Shapes (row-major, contiguous):
//   q, out      [B, C, Hkv, G, D] f32/bf16  query heads h*G .. h*G+G-1 share kv head h
//   k/v arena   [NB+1, L, Hkv*D] q's dtype  (or [NB+1, L, Hkv, D]: same bytes)
//     or codes  [NB+1, L, Hkv*D] int8       with
//   k/v scales  [NB+1, L, Hkv] f32          entry (slot, head) = codes * scale
//   tables      [B, max_blocks] int32       arena row of each logical block
//   lens        [B] int32 >= 0              global slot of the FIRST query
// Logits, the softmax and the accumulation are fp32.  An int8 entry is
// dequantized as code * scale in fp32 and rounded to q's dtype before any
// dot, as paged_dequant_view and the Pallas kernel do.  P is rounded to q's
// dtype before P V (relative to the running max of the online softmax, as
// the Pallas kernel rounds it relative to its row max), the denominator
// sums the unrounded P, and the output is stored in q's dtype.
//
// Bound: memory.  Per layer the function reads each row's staged prefix
// once, sum_b (lens[b] + C) slots of K and V (2 * Hkv * D * sizeof(T)
// bytes a slot; int8: 2 * Hkv * (D + 4)); its 4 * C * Hq * D operations
// per slot are about 2.5 per byte of a bf16 cache at C = 5, far below the
// tensor-core ridge.
//
// Design: the single-query kernels of csrc/paged_decode_attention{,_int8}.cu
// widened to C*G query rows.  One CTA per (b, kv head) keeps the C*G query
// rows of that head (row r = c*G + gi, the Pallas kernel's order), an fp32
// running max / denominator / accumulator per row in shared memory, and
// walks the block table for j = 0 .. min((lens[b]+C-1)/L, max_blocks-1),
// the Pallas kernel's n_blk clamp.  16-byte loads stage one block of K and
// V for this head in shared memory as fp32; slots past lens[b]+C-1 are
// never read and are staged as zeros.  Row r masks slots past lens[b] +
// r/G to weight 0 (its causal frontier).  A block entirely past a row's
// frontier leaves that row's state bit-identical (alpha = 1, no term
// added), so a row's output does not depend on C, and no CTA state depends
// on B: the output of a query row is the same whatever batch and width it
// rides in.
//
// Rows that are not in spec mode ride the same launch with all-trash
// tables, n_valid = 0 and any lens >= 0: the walk never leaves the table
// (clamped to max_blocks) and an arena index outside [0, num_rows) is
// clamped to the trash row, so they read finite data and stay finite.
//
// What differs from the TPU kernel: Pallas ran the batch as a sequential
// grid on one core, sharing VMEM scratch across grid steps (V buffers
// zeroed at program 0 only, :724-726, :809-811).  CTAs here share no state
// and read only the blocks the table names for the row, so there is
// nothing to zero.
//
// Known weakness (later work): B*Hkv CTAs (64 at 8 slots x 8 kv heads)
// leave half the SMs idle, each CTA stages one block at a time and the dot
// products run on CUDA cores; split-K over blocks, cp.async/TMA double
// buffering and mma.sync on the C*G x L logit tile come next.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/decode_attention.py):
//   int ptt_paged_decode_attention_multi(q, k_arena, v_arena, tables, lens,
//       out, B, C, Hkv, G, D, L, max_blocks, num_rows, scale, dtype, stream)
//   int ptt_paged_decode_attention_multi_int8(q, k_codes, v_codes, k_scales,
//       v_scales, tables, lens, out, B, C, Hkv, G, D, L, max_blocks,
//       num_rows, scale, dtype, stream)
//   dtype 0 = float32, 1 = bfloat16; D % 8 == 0 (float) or D % 16 == 0
//   (int8) and 16-byte aligned pointers (the wrapper checks).  Each returns
//   cudaGetLastError().

#include "dtype.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using ptt::from_f32;
using ptt::to_f32;

constexpr int kThreads = 128;

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int kN = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int kN = 8; };

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// elements of one slot's head row staged per 16-byte load
template <typename T, bool kInt8>
__host__ __device__ constexpr int vec_elems() {
  return kInt8 ? 16 : VecWidth<T>::kN;
}

// fp32 words of shared memory one CTA uses (see the layout below)
__host__ __device__ inline size_t smem_floats(int rows, int d, int L) {
  return (size_t)rows * d          // q
         + (size_t)L * (d + 1)     // K block, rows padded against bank conflicts
         + (size_t)L * d           // V block
         + (size_t)rows * L        // logits / probabilities
         + (size_t)rows * d        // accumulator
         + 3 * (size_t)rows;       // running max, denominator, rescale
}

template <typename T, bool kInt8>
__global__ void __launch_bounds__(kThreads)
paged_multi_kernel(const T* __restrict__ q, const void* __restrict__ k_arena,
                   const void* __restrict__ v_arena,
                   const float* __restrict__ k_scales,
                   const float* __restrict__ v_scales,
                   const int* __restrict__ tables,
                   const int* __restrict__ lens, T* __restrict__ out,
                   int cq, int hkv, int g, int d, int L, int max_blocks,
                   int num_rows, float scale) {
  constexpr int V = vec_elems<T, kInt8>();
  const int rows = cq * g;               // query rows r = c*g + gi
  extern __shared__ float smem[];
  float* q_s = smem;                     // [rows][d]
  float* k_s = q_s + rows * d;           // [L][d+1]
  float* v_s = k_s + L * (d + 1);        // [L][d]
  float* p_s = v_s + L * d;              // [rows][L]
  float* acc_s = p_s + rows * L;         // [rows][d]
  float* m_s = acc_s + rows * d;         // [rows]
  float* l_s = m_s + rows;               // [rows]
  float* a_s = l_s + rows;               // [rows]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int row_stride = hkv * d;
  const int len = lens[b];
  const int last = len + cq - 1;         // last staged slot
  int nblk = last / L + 1;
  if (nblk > max_blocks) nblk = max_blocks;

  for (int i = tid; i < rows * d; i += kThreads) {
    const int r = i / d;
    const int e = i - r * d;
    const int c = r / g;
    const int gi = r - c * g;
    const size_t off =
        ((((size_t)b * cq + c) * hkv + h) * g + gi) * (size_t)d + e;
    q_s[i] = to_f32(q[off]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int vpr = d / V;  // 16-byte vectors per head row
  for (int j = 0; j < nblk; ++j) {
    // a table entry outside the arena is clamped to its last row (the
    // trash row), as an out-of-range gather clamps in the JAX package
    const int blk = min(max(tables[(size_t)b * max_blocks + j], 0),
                        num_rows - 1);
    const size_t base = (size_t)blk * L * row_stride + (size_t)h * d;
    const size_t sbase = (size_t)blk * L * hkv + h;
    for (int i = tid; i < L * vpr; i += kThreads) {
      const int l = i / vpr;
      const int c = (i - l * vpr) * V;
      float* kd = k_s + l * (d + 1) + c;
      float* vd = v_s + l * d + c;
      if (j * L + l > last) {
        // past the last query's frontier: never read, staged as zeros
#pragma unroll
        for (int e = 0; e < V; ++e) {
          kd[e] = 0.f;
          vd[e] = 0.f;
        }
        continue;
      }
      const size_t off = base + (size_t)l * row_stride + c;
      if constexpr (kInt8) {
        const uint4 kraw =
            *reinterpret_cast<const uint4*>(static_cast<const int8_t*>(k_arena) + off);
        const uint4 vraw =
            *reinterpret_cast<const uint4*>(static_cast<const int8_t*>(v_arena) + off);
        const float ks = k_scales[sbase + (size_t)l * hkv];
        const float vs = v_scales[sbase + (size_t)l * hkv];
        const int8_t* kc = reinterpret_cast<const int8_t*>(&kraw);
        const int8_t* vc = reinterpret_cast<const int8_t*>(&vraw);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          kd[e] = round_to<T>((float)kc[e] * ks);
          vd[e] = round_to<T>((float)vc[e] * vs);
        }
      } else {
        const uint4 kraw =
            *reinterpret_cast<const uint4*>(static_cast<const T*>(k_arena) + off);
        const uint4 vraw =
            *reinterpret_cast<const uint4*>(static_cast<const T*>(v_arena) + off);
        const T* kv = reinterpret_cast<const T*>(&kraw);
        const T* vv = reinterpret_cast<const T*>(&vraw);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          kd[e] = to_f32(kv[e]);
          vd[e] = to_f32(vv[e]);
        }
      }
    }
    __syncthreads();

    for (int i = tid; i < rows * L; i += kThreads) {
      const int r = i / L;
      const int l = i - r * L;
      float s = -INFINITY;
      if (j * L + l <= len + r / g) {      // row r's causal frontier
        const float* qr = q_s + r * d;
        const float* kr = k_s + l * (d + 1);
        float acc = 0.f;
        for (int e = 0; e < d; ++e) acc += qr[e] * kr[e];
        s = acc * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();

    for (int r = tid; r < rows; r += kThreads) {
      float* pr = p_s + r * L;
      const float m_old = m_s[r];
      float m_new = m_old;
      for (int l = 0; l < L; ++l) m_new = fmaxf(m_new, pr[l]);
      float alpha = 1.f;
      float sum = 0.f;
      if (m_new == -INFINITY) {
        // no valid slot seen yet (cannot happen for lens >= 0: block 0
        // always holds slot 0 <= lens); keep the state untouched
        for (int l = 0; l < L; ++l) pr[l] = 0.f;
      } else {
        alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        for (int l = 0; l < L; ++l) {
          const float p = pr[l] == -INFINITY ? 0.f : expf(pr[l] - m_new);
          pr[l] = round_to<T>(p);   // P in q's dtype before P V
          sum += p;
        }
      }
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < rows * d; i += kThreads) {
      const int r = i / d;
      const int e = i - r * d;
      const float* pr = p_s + r * L;
      float acc = acc_s[i] * a_s[r];
      for (int l = 0; l < L; ++l) acc += pr[l] * v_s[l * d + e];
      acc_s[i] = acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < rows * d; i += kThreads) {
    const int r = i / d;
    const int e = i - r * d;
    const int c = r / g;
    const int gi = r - c * g;
    const size_t off =
        ((((size_t)b * cq + c) * hkv + h) * g + gi) * (size_t)d + e;
    out[off] = from_f32<T>(acc_s[i] / l_s[r]);
  }
}

template <typename T, bool kInt8>
int launch(const void* q, const void* k_arena, const void* v_arena,
           const float* k_scales, const float* v_scales, const int* tables,
           const int* lens, void* out, int B, int cq, int hkv, int g, int d,
           int L, int max_blocks, int num_rows, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats(cq * g, d, L) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_multi_kernel<T, kInt8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(hkv, B);
  paged_multi_kernel<T, kInt8><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), k_arena, v_arena, k_scales, v_scales, tables,
      lens, static_cast<T*>(out), cq, hkv, g, d, L, max_blocks, num_rows,
      scale);
  return (int)cudaGetLastError();
}

template <bool kInt8>
int dispatch(const void* q, const void* k_arena, const void* v_arena,
             const void* k_scales, const void* v_scales, const void* tables,
             const void* lens, void* out, int B, int cq, int hkv, int g,
             int d, int L, int max_blocks, int num_rows, float scale,
             int dtype, void* stream) {
  if (B <= 0 || cq <= 0 || hkv <= 0 || g <= 0 || L <= 0 ||
      max_blocks <= 0 || num_rows <= 0 || d <= 0 ||
      d % (kInt8 ? 16 : 8) != 0 || B > 65535 || hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lens);
  if (dtype == 0)
    return launch<float, kInt8>(q, k_arena, v_arena, ks, vs, tb, ln, out, B,
                                cq, hkv, g, d, L, max_blocks, num_rows,
                                scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, kInt8>(q, k_arena, v_arena, ks, vs, tb, ln,
                                        out, B, cq, hkv, g, d, L, max_blocks,
                                        num_rows, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ptt_paged_decode_attention_multi(
    const void* q, const void* k_arena, const void* v_arena,
    const void* tables, const void* lens, void* out, int B, int cq, int hkv,
    int g, int d, int L, int max_blocks, int num_rows, float scale,
    int dtype, void* stream) {
  return dispatch<false>(q, k_arena, v_arena, nullptr, nullptr, tables, lens,
                         out, B, cq, hkv, g, d, L, max_blocks, num_rows,
                         scale, dtype, stream);
}

extern "C" int ptt_paged_decode_attention_multi_int8(
    const void* q, const void* k_codes, const void* v_codes,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* lens, void* out, int B, int cq, int hkv, int g, int d, int L,
    int max_blocks, int num_rows, float scale, int dtype, void* stream) {
  return dispatch<true>(q, k_codes, v_codes, k_scales, v_scales, tables,
                        lens, out, B, cq, hkv, g, d, L, max_blocks, num_rows,
                        scale, dtype, stream);
}
