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
// x/y dtype (float32, bfloat16), bits (8, 4), bias (with, without) and
// act (none, relu, tanh-GELU, silu, as _apply_act :159) are one entry.
//
// Shapes (row-major, contiguous): x [M, K]; codes [K, N] int8 or
// [K/2, N] packed int4 (N contiguous, the at-rest format of the JAX
// package, unchanged); scale [N] f32; bias [N] f32; y [M, N].
//
// Bound: at decode (M = 8 slots) the function reads each code byte once
// and does 2 M = 16 operations per int8 byte (32 per int4 byte): bound by
// the weight stream at 3.35 TB/s (the bf16 tensor cores' ridge is 295
// operations a byte).  At a 256-row prefill chunk it is bound by
// operations (989 TFLOP/s in bf16).
//
// bfloat16 x: the tensor cores (mma.sync m16n8k16, bf16 operands, fp32
// accumulators; csrc/flash_mma.cuh), one launch:
//  * "Swap AB": the weights are the MMA's A operand (16 output columns n
//    on its row side) and x its B operand (8 rows m on its column side),
//    so M = 8 fills a tile with no padding.  A warp owns groups of 32
//    columns.  One ldmatrix.trans of a group's staged codes, read as
//    16-bit elements, hands a lane the words (k 2t, n 2g), (2t, 2g+1),
//    (2t+1, 2g), (2t+1, 2g+1): the even bytes are the A register of
//    column 2g (two k of one column, as the fragment wants), the bytes
//    shifted by 8 that of column 2g + 1, so the group's 32 columns are two
//    m16 tiles (even and odd columns) and no code is moved twice.  Codes
//    become bf16 in registers, exactly: an int8 code c as (0x4300 | c &
//    0x7f) - (0x4300 | c & 0x80) read as bf16 (128 + low 7 bits, minus 128
//    or 256: bit operations and one bf16x2 add for two codes; bf16 has 7
//    mantissa bits, so the fp32 exponent trick of the float32 route does
//    not carry over), an int4 code as (0x4300 | v ^ 8) - 136.  Every code
//    is exact in bf16 and every product of a bf16 x and a code exact in
//    fp32.  x reaches the B fragments by ldmatrix from rows padded by 16
//    bytes.
//  * Codes and x stream through a 4-stage cp.async ring (16-byte copies,
//    32 code rows a stage), the codes' rows padded by 16 bytes so the
//    ldmatrix rows hit 8 different bank groups; a thread's copy addresses
//    are made once and stepped by a stride.
//  * Split-K in one launch: K is cut into P pieces (P <= 8), and the P
//    CTAs of an output tile form a thread-block cluster.  Each CTA runs
//    one mma chain over its piece, parks its fp32 tile in shared memory,
//    and after a cluster barrier each CTA sums a 1/P share of the tile
//    over the P pieces in order 0..P-1 through distributed shared memory
//    (all P loads in flight at once), applies the fp32 epilogue (scale,
//    bias, act, each rounded on its own as the plain version does) and
//    stores bf16.  No partial sums go to device memory.
//  * Tiles (ops/quantized_matmul.py tc_tile): up to M = 64 one m tile of
//    ceil(M / 8) n8 tiles, a warp per 32 columns and up to four warps a
//    CTA, as many as still give a CTA per SM (at M = 8: 896 CTAs for N =
//    14336, 256 for N = 1024); past M = 64, 128 x 128 tiles of four warps
//    of 64 columns x 64 rows.
//  * Each output element's summation order is a function of K and bits
//    alone: the pieces (tc_split_plan in ops/quantized_matmul.py), the
//    chain of k16 steps ascending within a piece (int4: per 16 packed
//    rows the low-nibble k, then the high-nibble k), the identity k
//    order inside an instruction, and the pieces summed in order.  Tile
//    shapes only choose which CTA and which lane computes an element, so
//    a row's bits are the same at every M, whatever rows ride with it: a
//    1-slot and an 8-slot engine give the same tokens.
//  * Measured by chip_smoke.py phase 2 (NVIDIA H100 80GB HBM3, 700.00 W;
//    L2 flushed): M=8 K=4096 N=14336 int8 0.0322 ms against a byte bound
//    of 0.0176 (the bf16 GEMM 0.0468), a launch's fill and its cluster
//    barriers and reduction taking much of the gap; M=256 0.1516 against
//    an operation bound of 0.0304 (the GEMM 0.0476), bound by the
//    shared-memory traffic of the fragment loads and the per-piece
//    reduction, far from the tensor cores' rate (later work: wgmma with
//    x read from shared memory by the tensor cores).  PERF.md's kernel
//    table, rows 11-11d, keeps the current times.
//
// float32 x: CUDA-core fp32 FMA (TF32 would break the float32 tolerance,
// atol 1e-4): grid (m tiles of 8 rows, column tiles of 256, K slices of
// 256 code rows); each lane reads 8 columns of a code row with an 8-byte
// load and keeps 8 x 8 fp32 accumulators, codes become floats by the fp32
// exponent trick (PRMT or LOP3 and one FADD), each slice's sum goes to an
// fp32 scratch part[slice][m][n], and a second kernel adds the slices in
// order 0..S-1 and applies the epilogue.  Its order too depends on K
// alone.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/quantized_matmul.py):
//   int ptt_quantized_matmul(x, codes, scale, bias_or_null, y, part,
//                            M, K, N, bits, act, split, piece_rows, dtype,
//                            stream)
//   dtype 0 = float32: split = ceil(rows / 256 (int8) or 128 (int4))
//     slices, part holds split * M * N floats, piece_rows unused;
//   dtype 1 = bfloat16: split = P pieces (1..8) of piece_rows code rows
//     (a multiple of 16), part unused (null); N % 16 == 0, K % 16 == 0
//     (int4: K % 32 == 0);
//   act 0 none, 1 relu, 2 gelu (tanh), 3 silu; N % 8 == 0, K even for
//   bits 4.  Returns cudaGetLastError().

#include "flash_mma.cuh"

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

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

__device__ __forceinline__ float act_of(int act, float v) {
  switch (act) {
    case 1: return apply_act<1>(v);
    case 2: return apply_act<2>(v);
    case 3: return apply_act<3>(v);
  }
  return v;
}

// ---------------------------------------------------------------------------
// bfloat16 x: tensor cores, split-K over a cluster
// ---------------------------------------------------------------------------

constexpr int kMaxSplit = 8;        // CTAs of a cluster: pieces of K
constexpr int kRows = 32;           // code rows a stage (two k16 steps)
constexpr int kXLd = kRows + fmma::kPad;   // bf16 per staged x row

template <int BITS, int MT, int NG, int WN, int WM>
struct Tc {
  static constexpr int kWarps = WN * WM;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStages = 4;
  static constexpr int kBN = 32 * NG * WN;         // columns n a CTA
  static constexpr int kBM = 8 * MT * WM;          // rows m a CTA
  static constexpr int kXT = BITS == 4 ? 2 : 1;    // x tiles a stage
  static constexpr int kCodeRow = kBN + 16;        // bytes a staged code row
  static constexpr int kCodeBytes = kRows * kCodeRow;
  static constexpr int kXBytes = kXT * kBM * kXLd * 2;
  static constexpr int kStageBytes = kCodeBytes + kXBytes;
  static constexpr int kPartRow = kBN + 4;         // floats a partial row
  static constexpr int kPartBytes = kBM * kPartRow * 4;
  static constexpr int kSmem = kStages * kStageBytes > kPartBytes
                                   ? kStages * kStageBytes
                                   : kPartBytes;
  static_assert(kCodeBytes % 16 == 0 && kStageBytes % 16 == 0, "alignment");
};

// a + b on bf16x2 (exact here: every sum is an integer of at most 8 bits)
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d) : "r"(a), "r"(0x3F803F80u), "r"(b));
  return d;
}

// The int8 codes in bytes 0 and 2 of r as bf16x2 (byte 0 in the low
// half), exactly: (0x4300 | c & 0x7f) = 128 + (c & 127), minus 128 (c >= 0)
// or 256 (c < 0).
__device__ __forceinline__ uint32_t deq8(uint32_t r) {
  return add_bf16x2((r & 0x007F007Fu) | 0x43004300u,
                    (r & 0x00800080u) | 0xC300C300u);
}

// The int4 codes in the low nibbles of bytes 0 and 2 of r as bf16x2,
// exactly: (0x4300 | v ^ 8) = 128 + (v ^ 8), minus 136.
__device__ __forceinline__ uint32_t deq4(uint32_t r) {
  return add_bf16x2((r & 0x000F000Fu) ^ 0x43084308u, 0xC308C308u);
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(fmma::smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(fmma::smem_u32(p)));
}

// B fragments of the n8 tiles (rows of x) row0 + 8 mt, mt < MT, over the
// k16 step at k0 of a staged x tile.
template <int MT>
__device__ __forceinline__ void load_x(uint32_t (&b)[MT][2], const bf16* xs,
                                       int row0, int k0, int lane) {
#pragma unroll
  for (int mt = 0; mt + 1 < MT; mt += 2) {
    uint32_t r[4];
    fmma::load_b<kXLd>(r, xs, row0 + 8 * mt, k0, lane);
    b[mt][0] = r[0];
    b[mt][1] = r[1];
    b[mt + 1][0] = r[2];
    b[mt + 1][1] = r[3];
  }
  if (MT & 1)
    ldmatrix_x2(b[MT - 1][0], b[MT - 1][1],
                xs + (row0 + 8 * (MT - 1) + (lane & 7)) * kXLd + k0
                    + (((lane >> 3) & 1) << 3));
}

template <int BITS, int MT, int NG, int WN, int WM>
__global__ void __launch_bounds__(Tc<BITS, MT, NG, WN, WM>::kThreads)
qmm_tc_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ codes,
              const float* __restrict__ scale, const float* __restrict__ bias,
              bf16* __restrict__ y, int M, int K, int N, int act,
              int piece_rows) {
  using C = Tc<BITS, MT, NG, WN, WM>;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();   // the pieces of K
  const int piece = (int)cluster.block_rank();
  const int pieces = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wn = warp % WN;
  const int wm = warp / WN;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.y * C::kBN;
  const int m0 = blockIdx.z * C::kBM;
  const int rows = BITS == 4 ? K / 2 : K;           // code rows
  const int r_begin = piece * piece_rows;
  const int r_end = min(rows, r_begin + piece_rows);
  const int n_stages = r_end > r_begin ? (r_end - r_begin + kRows - 1) / kRows
                                       : 0;

  // Queue stage `st` (code rows r_begin + 32 st ..) into ring slot `slot`:
  // rows at or past the piece's end, columns past N and rows of x past M
  // are zero-filled and never read.  A thread copies the same 16-byte
  // chunks of every stage, so their stage-0 addresses are made once; a
  // chunk index past the tile (dst < 0) copies nothing, not even zeros.
  constexpr int kCodeChunks = kRows * (C::kBN / 16);
  constexpr int kCodeIt = (kCodeChunks + C::kThreads - 1) / C::kThreads;
  constexpr int kXChunks = C::kBM * (kRows / 8);
  constexpr int kXIt = (kXChunks + C::kThreads - 1) / C::kThreads;
  const int8_t* c_src[kCodeIt];
  int c_dst[kCodeIt], c_row[kCodeIt];
#pragma unroll
  for (int i = 0; i < kCodeIt; ++i) {
    const int c = tid + i * C::kThreads;
    const int r = c / (C::kBN / 16);
    const int col = (c % (C::kBN / 16)) * 16;
    // a chunk past N never loads (its row is past r_end)
    c_row[i] = n0 + col < N ? r_begin + r : r_end;
    c_src[i] = codes + (size_t)(r_begin + r) * N + n0 + col;
    c_dst[i] = c < kCodeChunks ? r * C::kCodeRow + col : -1;
  }
  const bf16* x_src[kXIt];
  int x_dst[kXIt], x_row[kXIt];
#pragma unroll
  for (int i = 0; i < kXIt; ++i) {
    const int c = tid + i * C::kThreads;
    const int m = c / (kRows / 8);
    const int kk = (c % (kRows / 8)) * 8;
    x_row[i] = m0 + m < M ? r_begin + kk : r_end;
    x_src[i] = x + (size_t)(m0 + m) * K + r_begin + kk;
    x_dst[i] = c < kXChunks ? m * kXLd + kk : -1;
  }
  auto load_stage = [&](int st, int slot) {
    uint8_t* cs = smem + slot * C::kStageBytes;
    bf16* xs = reinterpret_cast<bf16*>(cs + C::kCodeBytes);
    const int dr = st * kRows;
#pragma unroll
    for (int i = 0; i < kCodeIt; ++i) {
      const bool ok = c_row[i] + dr < r_end;
      if (kCodeChunks % C::kThreads == 0 || c_dst[i] >= 0)
        fmma::cp_async16(cs + c_dst[i],
                         ok ? c_src[i] + (size_t)dr * N : codes, ok);
    }
#pragma unroll
    for (int h = 0; h < C::kXT; ++h)
#pragma unroll
      for (int i = 0; i < kXIt; ++i) {
        const bool ok = x_row[i] + dr < r_end;
        if (kXChunks % C::kThreads == 0 || x_dst[i] >= 0)
          fmma::cp_async16(xs + h * C::kBM * kXLd + x_dst[i],
                           ok ? x_src[i] + h * rows + dr : x, ok);
      }
  };

  // acc[gi][p][mt]: the m16 x n8 tile of group gi's columns of parity p
  // (below) and the n8 tile mt of x rows
  float acc[NG][2][MT][4];
#pragma unroll
  for (int gi = 0; gi < NG; ++gi)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gi][p][mt][e] = 0.f;

#pragma unroll
  for (int i = 0; i < C::kStages - 1; ++i) {
    if (i < n_stages) load_stage(i, i);
    fmma::cp_async_commit();
  }
  const int xrow0 = wm * MT * 8;
  // this lane's row of the code tile for ldmatrix.trans (matrix lane / 8:
  // k rows 0-7 or 8-15 of the step, bytes 0-15 or 16-31 of the group)
  const int a_off = ((lane & 7) + 8 * (lane >> 4)) * C::kCodeRow
                    + 16 * ((lane >> 3) & 1) + 32 * NG * wn;
  for (int it = 0; it < n_stages; ++it) {
    fmma::cp_async_wait<C::kStages - 2>();   // stage `it` has landed
    __syncthreads();                         // and slot it - 1 is free
    {
      const int nx = it + C::kStages - 1;
      if (nx < n_stages) load_stage(nx, nx % C::kStages);
      fmma::cp_async_commit();
    }
    const uint8_t* cs = smem + (it % C::kStages) * C::kStageBytes;
    const bf16* xs = reinterpret_cast<const bf16*>(cs + C::kCodeBytes);
#pragma unroll
    for (int s = 0; s < kRows / 16; ++s) {
      // r[gi][q]: bytes (k 2t, n 2g), (2t, 2g+1), (2t+1, 2g), (2t+1, 2g+1)
      // of group gi's matrix q (k rows 8 (q >> 1) .., columns 16 (q & 1)
      // ..): the even bytes pair two k of column 2g, the odd ones of 2g + 1
      uint32_t r[NG][4];
#pragma unroll
      for (int gi = 0; gi < NG; ++gi)
        ldmatrix_x4_trans(r[gi], cs + 16 * s * C::kCodeRow + a_off + 32 * gi);
      uint32_t b[MT][2];
#pragma unroll
      for (int hi = 0; hi < (BITS == 4 ? 2 : 1); ++hi) {
        // int4: packed row i carries k = i (low nibble) and k = K/2 + i
        // (high nibble): the step's low-nibble product, then its high one
        load_x<MT>(b, xs + hi * C::kBM * kXLd, xrow0, 16 * s, lane);
#pragma unroll
        for (int gi = 0; gi < NG; ++gi)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            uint32_t a[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              a[q] = BITS == 8 ? deq8(r[gi][q] >> (8 * p))
                               : deq4(r[gi][q] >> (8 * p + 4 * hi));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              fmma::mma(acc[gi][p][mt], a, b[mt][0], b[mt][1]);
          }
      }
    }
  }
  fmma::cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring: it becomes `part`

  // the piece's tile [kBM][kPartRow] fp32: acc[gi][p][mt][2 h + e] is
  // column 32 (NG wn + gi) + 16 h + 2 g + p, row xrow0 + 8 mt + 2 t + e
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int gi = 0; gi < NG; ++gi)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float2*>(
              part + (xrow0 + 8 * mt + 2 * t + e) * C::kPartRow
              + 32 * (NG * wn + gi) + 16 * h + 2 * g) =
              make_float2(acc[gi][0][mt][2 * h + e],
                          acc[gi][1][mt][2 * h + e]);
  cluster.sync();    // every piece's tile is in its CTA's shared memory

  // this CTA's share of the tile: 4 columns at a time, the pieces summed
  // in order 0 .. P-1, then the epilogue
  constexpr int kQuads = C::kBM * C::kBN / 4;
  const int per = (kQuads + pieces - 1) / pieces;
  const int q_end = min(kQuads, (piece + 1) * per);
  for (int qd = piece * per + tid; qd < q_end; qd += C::kThreads) {
    const int ml = qd / (C::kBN / 4);
    const int nl = (qd % (C::kBN / 4)) * 4;
    const int m = m0 + ml;
    const int n = n0 + nl;
    if (m >= M || n >= N) continue;
    float4* mine = reinterpret_cast<float4*>(part + ml * C::kPartRow + nl);
    float4 v[kMaxSplit];   // every piece's value in flight at once
#pragma unroll
    for (int p = 0; p < kMaxSplit; ++p)
      if (p < pieces) v[p] = *cluster.map_shared_rank(mine, p);
    float4 s = v[0];
#pragma unroll
    for (int p = 1; p < kMaxSplit; ++p)
      if (p < pieces) {
        s.x += v[p].x;
        s.y += v[p].y;
        s.z += v[p].z;
        s.w += v[p].w;
      }
    const float4 sc = *reinterpret_cast<const float4*>(scale + n);
    // product, then sum, each rounded on its own (no FMA contraction), as
    // the plain version's epilogue
    float o[4] = {__fmul_rn(s.x, sc.x), __fmul_rn(s.y, sc.y),
                  __fmul_rn(s.z, sc.z), __fmul_rn(s.w, sc.w)};
    if (bias != nullptr) {
      const float4 bi = *reinterpret_cast<const float4*>(bias + n);
      o[0] = __fadd_rn(o[0], bi.x);
      o[1] = __fadd_rn(o[1], bi.y);
      o[2] = __fadd_rn(o[2], bi.z);
      o[3] = __fadd_rn(o[3], bi.w);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = act_of(act, o[i]);
    *reinterpret_cast<uint2*>(y + (size_t)m * N + n) =
        make_uint2(fmma::pack_bf16(o[0], o[1]), fmma::pack_bf16(o[2], o[3]));
  }
  cluster.sync();    // no CTA leaves while another reads its tile
}

template <int BITS, int MT, int NG, int WN, int WM>
int launch_tc(const void* x, const int8_t* codes, const float* scale,
              const float* bias, void* y, int M, int K, int N, int act,
              int split, int piece_rows, cudaStream_t stream) {
  using C = Tc<BITS, MT, NG, WN, WM>;
  auto kern = qmm_tc_kernel<BITS, MT, NG, WN, WM>;
  static bool attr_set = false;   // internal linkage: this library's own
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int n_tiles = (N + C::kBN - 1) / C::kBN;
  const int m_tiles = (M + C::kBM - 1) / C::kBM;
  if (n_tiles > 65535 || m_tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, n_tiles, m_tiles);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const bf16*>(x), codes, scale, bias,
      static_cast<bf16*>(y), M, K, N, act, piece_rows);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The tile (ops/quantized_matmul.py tc_tile): mt n8 tiles of x rows a
// warp, ng groups of 32 columns a warp, wn warps along n, wm along m.
template <int BITS>
int launch_tc_tile(const void* x, const int8_t* codes, const float* scale,
                   const float* bias, void* y, int M, int K, int N, int act,
                   int split, int piece_rows, int mt, int ng, int wn, int wm,
                   cudaStream_t s) {
#define PTT_QMM_TC(MT, NG, WN, WM)                                          \
  if (mt == MT && ng == NG && wn == WN && wm == WM)                         \
    return launch_tc<BITS, MT, NG, WN, WM>(x, codes, scale, bias, y, M, K,  \
                                           N, act, split, piece_rows, s);
#define PTT_QMM_TC_WN(MT) PTT_QMM_TC(MT, 1, 1, 1) PTT_QMM_TC(MT, 1, 2, 1)  \
  PTT_QMM_TC(MT, 1, 4, 1)
  PTT_QMM_TC_WN(1) PTT_QMM_TC_WN(2) PTT_QMM_TC_WN(3) PTT_QMM_TC_WN(4)
  PTT_QMM_TC_WN(5) PTT_QMM_TC_WN(6) PTT_QMM_TC_WN(7) PTT_QMM_TC_WN(8)
  PTT_QMM_TC(8, 2, 2, 2)
#undef PTT_QMM_TC_WN
#undef PTT_QMM_TC
  return (int)cudaErrorInvalidValue;
}

int launch_bf16(const void* x, const int8_t* codes, const float* scale,
                const float* bias, void* y, int M, int K, int N, int bits,
                int act, int split, int piece_rows, int tile,
                cudaStream_t s) {
  const int rows = bits == 4 ? K / 2 : K;
  if (N % 16 != 0 || K % (bits == 4 ? 32 : 16) != 0 || split < 1 ||
      split > kMaxSplit || piece_rows <= 0 || piece_rows % 16 != 0 ||
      (long long)split * piece_rows < rows ||
      (long long)(split - 1) * piece_rows >= rows)
    return (int)cudaErrorInvalidValue;
  const int mt = tile & 15, ng = (tile >> 4) & 15, wn = (tile >> 8) & 15,
            wm = tile >> 12;
  return bits == 4
             ? launch_tc_tile<4>(x, codes, scale, bias, y, M, K, N, act,
                                 split, piece_rows, mt, ng, wn, wm, s)
             : launch_tc_tile<8>(x, codes, scale, bias, y, M, K, N, act,
                                 split, piece_rows, mt, ng, wn, wm, s);
}

// ---------------------------------------------------------------------------
// float32 x: CUDA cores, K slices through an fp32 scratch
// ---------------------------------------------------------------------------

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

template <int BITS>
__global__ void __launch_bounds__(kThreads)
qmm_partial_kernel(const float* __restrict__ x,
                   const int8_t* __restrict__ codes,
                   float* __restrict__ part, int M, int K, int N) {
  constexpr int SR = slice_rows(BITS);
  constexpr int WR = SR / kWarps;              // rows per warp
  constexpr int HALVES = BITS == 4 ? 2 : 1;    // k values per code row
  extern __shared__ __align__(16) float fsmem[];
  float* xs = fsmem;                           // [HALVES][SR][kBM]
  float* red = xs + HALVES * SR * kBM;         // [kWarps][kBM][kBN]

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int s = blockIdx.z;
  const int rows = BITS == 4 ? K / 2 : K;      // code rows
  const int r0 = s * SR;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // stage x[m0 .. m0+7][k] for the slice's k values (zeros past M and
  // past the last row); neighbouring threads read neighbouring k
  for (int i = tid; i < HALVES * SR * kBM; i += kThreads) {
    const int r = i % SR;
    const int mi = (i / SR) % kBM;
    const int half = i / (SR * kBM);
    const int row = r0 + r;
    const int m = m0 + mi;
    xs[(half * SR + r) * kBM + mi] =
        (m < M && row < rows) ? x[(size_t)m * K + row + half * rows] : 0.f;
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

template <int ACT, bool BIAS>
__global__ void __launch_bounds__(kThreads)
qmm_epilogue_kernel(const float* __restrict__ part,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, float* __restrict__ y,
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
    y[i] = apply_act<ACT>(v);
  }
}

template <int ACT, bool BIAS>
cudaError_t launch_epilogue(const float* part, const float* scale,
                            const float* bias, void* y, int M, int N,
                            int slices, cudaStream_t stream) {
  const size_t total = (size_t)M * N;
  size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65535 * 16) blocks = 65535 * 16;
  qmm_epilogue_kernel<ACT, BIAS><<<(unsigned)blocks, kThreads, 0, stream>>>(
      part, scale, bias, static_cast<float*>(y), M, N, slices);
  return cudaGetLastError();
}

cudaError_t launch_epilogue_act(const float* part, const float* scale,
                                const float* bias, void* y, int M, int N,
                                int slices, int act, cudaStream_t s) {
  const bool b = bias != nullptr;
  switch (act) {
    case 0: return b ? launch_epilogue<0, true>(part, scale, bias, y, M, N, slices, s)
                     : launch_epilogue<0, false>(part, scale, bias, y, M, N, slices, s);
    case 1: return b ? launch_epilogue<1, true>(part, scale, bias, y, M, N, slices, s)
                     : launch_epilogue<1, false>(part, scale, bias, y, M, N, slices, s);
    case 2: return b ? launch_epilogue<2, true>(part, scale, bias, y, M, N, slices, s)
                     : launch_epilogue<2, false>(part, scale, bias, y, M, N, slices, s);
    case 3: return b ? launch_epilogue<3, true>(part, scale, bias, y, M, N, slices, s)
                     : launch_epilogue<3, false>(part, scale, bias, y, M, N, slices, s);
  }
  return cudaErrorInvalidValue;
}

int launch_f32(const void* x, const int8_t* codes, const float* scale,
               const float* bias, void* y, float* part, int M, int K, int N,
               int bits, int act, int slices, cudaStream_t stream) {
  const int rows = bits == 4 ? K / 2 : K;
  const int sr = slice_rows(bits);
  if (part == nullptr || slices != (rows + sr - 1) / sr || slices > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (N + kBN - 1) / kBN;
  const int m_tiles = (M + kBM - 1) / kBM;
  if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(m_tiles, n_tiles, slices);
  const size_t smem = smem_floats(bits) * sizeof(float);
  const float* xf = static_cast<const float*>(x);
  cudaError_t e;
  if (bits == 8) {
    e = cudaFuncSetAttribute(qmm_partial_kernel<8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    qmm_partial_kernel<8><<<grid, kThreads, smem, stream>>>(xf, codes, part,
                                                            M, K, N);
  } else {
    e = cudaFuncSetAttribute(qmm_partial_kernel<4>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    qmm_partial_kernel<4><<<grid, kThreads, smem, stream>>>(xf, codes, part,
                                                            M, K, N);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_epilogue_act(part, scale, bias, y, M, N, slices, act,
                                  stream);
}

}  // namespace

extern "C" int ptt_quantized_matmul(const void* x, const void* codes,
                                    const void* scale, const void* bias,
                                    void* y, void* part, int M, int K, int N,
                                    int bits, int act, int split,
                                    int piece_rows, int tile, int dtype,
                                    void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % 8 != 0 || split <= 0 ||
      (bits != 8 && bits != 4) || (bits == 4 && K % 2 != 0) || act < 0 ||
      act > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* c = static_cast<const int8_t*>(codes);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0)
    return launch_f32(x, c, sc, b, y, static_cast<float*>(part), M, K, N,
                      bits, act, split, s);
  if (dtype == 1)
    return launch_bf16(x, c, sc, b, y, M, K, N, bits, act, split, piece_rows,
                       tile, s);
  return (int)cudaErrorInvalidValue;
}
