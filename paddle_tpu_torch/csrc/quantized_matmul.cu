// Weight-quantized matrix product for Hopper (sm_90a):
//   y[m, n] = act(acc[m, n] * scale[n] (+ bias[n])),
//   acc[m, n] = sum_k x[m, k] * float(code[k, n])          (fp32)
// with int8 codes [K, N], or int4 codes packed two per byte along
// split-K halves ([K/2, N]: packed row i holds code[i] in its low nibble
// and code[K/2 + i] in its high nibble, sign-extended as (v ^ 8) - 8).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/quantized_matmul.py:
// _kernel (:175), _kernel_bias (:187), _kernel_i4 (:196) and
// _kernel_i4_bias (:208), driven by _qmm_impl (:224, pallas_call :283).
// One templated kernel covers all four bodies: x/y dtype (float32,
// bfloat16), bits (8, 4), bias (with, without) and act (none, relu,
// tanh-GELU, silu, as _apply_act :159).
//
// Shapes (row-major, contiguous): x [M, K]; codes [K, N] int8 or
// [K/2, N] packed int4 (N contiguous, so neighbouring threads read
// neighbouring output columns); scale [N] f32; bias [N] f32; y [M, N].
//
// Bound: at decode (M = slots = 8) the function reads each code byte
// once and does 2*M = 16 operations per int8 byte (32 per int4 byte), so
// it is bound by the weight stream at 3.35 TB/s (bf16 x: at 989 TFLOP/s
// in the tensor cores, or 67 TFLOP/s on the fp32 CUDA cores this kernel
// uses, the ridge lies at 295 or 20 operations per byte).  At prefill
// (M = 256) it is bound by operations.
//
// Design, a simple first kernel on CUDA-core fp32 FMA (products of a bf16
// x and an integer code are exact in fp32, so only the order of the sum
// differs from the plain version):
//  * Grid (m tiles of 8 rows, column tiles of 256, K slices).  A CTA of
//    256 threads owns 8 rows x 256 columns of one K slice of 256 code
//    rows (int8) or 128 packed rows (int4, 256 k).  Each lane reads 8
//    neighbouring columns of one code row with an 8-byte load (a warp
//    reads 256 contiguous bytes of the row) and keeps 8 x 8 fp32
//    accumulators; the 8 warps take consecutive sub-slices of 32 (int8)
//    or 16 (int4) rows.  The CTA's x tile is staged once in shared
//    memory as fp32, [row][8 m], read back as two broadcast float4.
//    Codes become floats by an exponent trick (PRMT or LOP3 and one
//    FADD), not I2F, which issues at 1/8 of the FMA rate on sm_90.
//  * The warps park their partial sums in shared memory; each thread
//    adds one column's eight partials in warp order 0..7 and writes the
//    slice's sum to an fp32 scratch part[slice][m][n]; a second
//    kernel adds the slices in order 0..S-1 and applies the fp32
//    epilogue (scale, bias, act) and the cast.  Splitting K over CTAs
//    keeps enough bytes in flight at decode, where N/256 column tiles
//    alone would leave most SMs idle (4 CTAs at N = 1024).
//  * Each output element's summation order depends on K alone (the
//    slice, warp and row order are fixed by K), never on M or on the
//    row's place in the batch: a 1-slot and an 8-slot engine give the
//    same bits.
//
// Known weaknesses (later work): CUDA cores, not tensor cores (mma.sync
// or wgmma with codes dequantized in shared memory); no cp.async/TMA
// pipeline; the scratch round trip costs S*M*N*8 bytes, which at prefill
// (M = 256) exceeds the weight's own bytes; x is re-staged and the codes
// re-read (from L2) once per 8-row m tile.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/quantized_matmul.py):
//   int ptt_quantized_matmul(x, codes, scale, bias_or_null, y, part,
//                            M, K, N, bits, act, slices, dtype, stream)
//   dtype 0 = float32, 1 = bfloat16; act 0 none, 1 relu, 2 gelu (tanh),
//   3 silu; N % 8 == 0, K even for bits 4; slices = ceil(rows / rows per
//   slice) where rows = K (int8) or K/2 (int4); part holds
//   slices * M * N floats.  Returns cudaGetLastError().

#include "dtype.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using ptt::from_f32;
using ptt::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 8;                 // rows of x per CTA
constexpr int kCols = 8;               // columns per lane
constexpr int kBN = 32 * kCols;        // columns per CTA
constexpr int kSliceRows8 = 256;       // code rows per CTA slice, int8
constexpr int kSliceRows4 = 128;       // packed rows per CTA slice, int4
static_assert(kBN == kThreads, "the reduction gives each thread a column");

__host__ __device__ constexpr int slice_rows(int bits) {
  return bits == 4 ? kSliceRows4 : kSliceRows8;
}

// The codes become floats without I2F, which issues at 1/8 of the FMA
// rate on sm_90 and would cost as much as the FMAs themselves: the code's
// unsigned offset form is placed under the exponent of 2^23 and the
// offset taken off again, exact for every code.
// int8 code c of a word whose bytes were biased by ^ 0x80 (u = code + 128)
__device__ __forceinline__ float byte_s8(uint32_t biased, int c) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + c)) -
         8388736.f;                            // 2^23 + 128
}

// int4 code of the nibble at bit s: (v ^ 8) - 8 maps 0..15 to -8..7
__device__ __forceinline__ float nibble_s4(uint32_t w, int s) {
  return __int_as_float(((w >> s) & 0xFu) ^ 0x4B000008u) - 8388616.f;  // 2^23 + 8
}

// dynamic shared memory (floats): the x tile [half][row][kBM] and one
// [kBM][kBN] partial-sum tile per warp
__host__ __device__ constexpr int smem_floats(int bits) {
  return (bits == 4 ? 2 : 1) * slice_rows(bits) * kBM + kWarps * kBM * kBN;
}

template <typename T, int BITS>
__global__ void __launch_bounds__(kThreads)
qmm_partial_kernel(const T* __restrict__ x, const int8_t* __restrict__ codes,
                   float* __restrict__ part, int M, int K, int N) {
  constexpr int SR = slice_rows(BITS);
  constexpr int WR = SR / kWarps;              // rows per warp
  constexpr int HALVES = BITS == 4 ? 2 : 1;    // k values per code row
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                            // [HALVES][SR][kBM]
  float* red = xs + HALVES * SR * kBM;         // [kWarps][kBM][kBN]

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int s = blockIdx.z;
  const int rows = BITS == 4 ? K / 2 : K;      // code rows
  const int r0 = s * SR;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // stage x[m0 .. m0+7][k] for the slice's k values as fp32 (zeros past
  // M and past the last row); neighbouring threads read neighbouring k
  for (int i = tid; i < HALVES * SR * kBM; i += kThreads) {
    const int r = i % SR;
    const int mi = (i / SR) % kBM;
    const int half = i / (SR * kBM);
    const int row = r0 + r;
    const int m = m0 + mi;
    xs[(half * SR + r) * kBM + mi] =
        (m < M && row < rows) ? to_f32(x[(size_t)m * K + row + half * rows])
                              : 0.f;
  }
  __syncthreads();

  float acc[kBM][kCols];
#pragma unroll
  for (int i = 0; i < kBM; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  const int n = n0 + lane * kCols;
  const bool col_ok = n < N;                   // N % 8 == 0: whole lane
  const int wr0 = warp * WR;
  int wr1 = wr0 + WR;
  if (r0 + wr1 > rows) wr1 = rows - r0;
  if (col_ok) {
    const float4* xs4 = reinterpret_cast<const float4*>(xs);
#pragma unroll 4
    for (int r = wr0; r < wr1; ++r) {
      const uint2 raw = *reinterpret_cast<const uint2*>(
          codes + (size_t)(r0 + r) * N + n);
      const float4 xa = xs4[r * 2];
      const float4 xb = xs4[r * 2 + 1];
      const float xv[kBM] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      if (BITS == 8) {
        const uint32_t bx = raw.x ^ 0x80808080u;
        const uint32_t by = raw.y ^ 0x80808080u;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float w = byte_s8(c < 4 ? bx : by, c & 3);
#pragma unroll
          for (int i = 0; i < kBM; ++i) acc[i][c] = fmaf(xv[i], w, acc[i][c]);
        }
      } else {
        const float4 ya = xs4[(SR + r) * 2];
        const float4 yb = xs4[(SR + r) * 2 + 1];
        const float yv[kBM] = {ya.x, ya.y, ya.z, ya.w,
                               yb.x, yb.y, yb.z, yb.w};
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const uint32_t wd = c < 4 ? raw.x : raw.y;
          const float lo = nibble_s4(wd, 8 * (c & 3));
          const float hi = nibble_s4(wd, 8 * (c & 3) + 4);
#pragma unroll
          for (int i = 0; i < kBM; ++i) {
            acc[i][c] = fmaf(xv[i], lo, acc[i][c]);
            acc[i][c] = fmaf(yv[i], hi, acc[i][c]);
          }
        }
      }
    }
  }

  // each warp parks its partial sums; then every thread adds one column's
  // eight warp partials in warp order 0..7 and writes the slice's sum
  float* mine = red + warp * kBM * kBN;
#pragma unroll
  for (int i = 0; i < kBM; ++i) {
    float4* dst = reinterpret_cast<float4*>(mine + i * kBN + lane * kCols);
    dst[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    dst[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  const int nc = n0 + tid;                     // kBN == kThreads
#pragma unroll
  for (int i = 0; i < kBM; ++i) {
    float sum = red[i * kBN + tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += red[(w * kBM + i) * kBN + tid];
    const int m = m0 + i;
    if (m < M && nc < N) part[((size_t)s * M + m) * N + nc] = sum;
  }
}

template <int ACT>
__device__ __forceinline__ float apply_act(float v) {
  if (ACT == 1) return fmaxf(v, 0.f);
  if (ACT == 2) {
    const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    return v * 0.5f * (1.f + tanhf(inner));
  }
  if (ACT == 3) return v * (1.f / (1.f + expf(-v)));
  return v;
}

template <typename T, int ACT, bool BIAS>
__global__ void __launch_bounds__(kThreads)
qmm_epilogue_kernel(const float* __restrict__ part,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, T* __restrict__ y,
                    int M, int N, int slices) {
  const size_t total = (size_t)M * N;
  const size_t stride = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kThreads) {
    const int n = (int)(i % N);
    float acc = part[i];
    for (int s = 1; s < slices; ++s) acc += part[s * stride + i];
    float v = acc * scale[n];
    if (BIAS) v = v + bias[n];
    y[i] = from_f32<T>(apply_act<ACT>(v));
  }
}

template <typename T, int ACT, bool BIAS>
cudaError_t launch_epilogue(const float* part, const float* scale,
                            const float* bias, void* y, int M, int N,
                            int slices, cudaStream_t stream) {
  const size_t total = (size_t)M * N;
  size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65535 * 16) blocks = 65535 * 16;
  qmm_epilogue_kernel<T, ACT, BIAS><<<(unsigned)blocks, kThreads, 0,
                                      stream>>>(
      part, scale, bias, static_cast<T*>(y), M, N, slices);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_epilogue_act(const float* part, const float* scale,
                                const float* bias, void* y, int M, int N,
                                int slices, int act, cudaStream_t s) {
  const bool b = bias != nullptr;
  switch (act) {
    case 0: return b ? launch_epilogue<T, 0, true>(part, scale, bias, y, M, N, slices, s)
                     : launch_epilogue<T, 0, false>(part, scale, bias, y, M, N, slices, s);
    case 1: return b ? launch_epilogue<T, 1, true>(part, scale, bias, y, M, N, slices, s)
                     : launch_epilogue<T, 1, false>(part, scale, bias, y, M, N, slices, s);
    case 2: return b ? launch_epilogue<T, 2, true>(part, scale, bias, y, M, N, slices, s)
                     : launch_epilogue<T, 2, false>(part, scale, bias, y, M, N, slices, s);
    case 3: return b ? launch_epilogue<T, 3, true>(part, scale, bias, y, M, N, slices, s)
                     : launch_epilogue<T, 3, false>(part, scale, bias, y, M, N, slices, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* x, const int8_t* codes, const float* scale,
           const float* bias, void* y, float* part, int M, int K, int N,
           int bits, int act, int slices, cudaStream_t stream) {
  const int rows = bits == 4 ? K / 2 : K;
  const int sr = slice_rows(bits);
  if (slices != (rows + sr - 1) / sr || slices > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (N + kBN - 1) / kBN;
  const int m_tiles = (M + kBM - 1) / kBM;
  if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(m_tiles, n_tiles, slices);
  const size_t smem = smem_floats(bits) * sizeof(float);
  cudaError_t e;
  if (bits == 8) {
    e = cudaFuncSetAttribute(qmm_partial_kernel<T, 8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    qmm_partial_kernel<T, 8><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), codes, part, M, K, N);
  } else {
    e = cudaFuncSetAttribute(qmm_partial_kernel<T, 4>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    qmm_partial_kernel<T, 4><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), codes, part, M, K, N);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_epilogue_act<T>(part, scale, bias, y, M, N, slices, act,
                                     stream);
}

}  // namespace

extern "C" int ptt_quantized_matmul(const void* x, const void* codes,
                                    const void* scale, const void* bias,
                                    void* y, void* part, int M, int K, int N,
                                    int bits, int act, int slices, int dtype,
                                    void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % 8 != 0 || slices <= 0 ||
      (bits != 8 && bits != 4) || (bits == 4 && K % 2 != 0) || act < 0 ||
      act > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* c = static_cast<const int8_t*>(codes);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return launch<float>(x, c, sc, b, y, p, M, K, N, bits, act, slices, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, c, sc, b, y, p, M, K, N, bits, act,
                                 slices, s);
  return (int)cudaErrorInvalidValue;
}
