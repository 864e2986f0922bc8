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
// flops per byte, far above the H100's ridge.  So the products have to
// run on the tensor cores, and the one thing that can starve them is the
// feed: shared-memory reads per product, and loads that do not overlap.
//
// Two routes, chosen by dtype; both are kernels of this file, and neither
// stands in for the other:
//
// bfloat16 (flash_fwd_tc_kernel): FlashAttention-2 on the tensor cores,
// with the pieces of flash_mma.cuh.  One CTA of WARPS warps per
// (WARPS * MT * 16-query block, query head, batch row), heaviest causal
// blocks first; each warp owns MT m16 row tiles.  The Q tile is copied to
// shared memory once; K and V tiles of BN keys stream through a 2-stage
// cp.async ring of padded bf16 tiles, so block kb + 1 is in flight while
// block kb computes.  S = Q K^T runs on mma.sync m16n8k16 (Q and K through
// ldmatrix), the online softmax runs on the accumulators in registers
// (row max and sum over the 4 lanes of a row, exp2 with the scale folded
// into log2 units), and P's fp32 accumulators are rounded to bf16 and
// repacked straight into the A fragments of P V (V through
// ldmatrix.trans): P never touches shared memory.  Only blocks that cross
// the causal diagonal or the ragged end of Sk take a mask, and a warp
// whose rows all precede the block's first key skips it.  O and LSE are
// written once.  Tiles (launch_tc's WARPS, MT, BN at the dispatch below):
// the fastest of six tried for each head dim on an H100 SXM.  At D = 64
// (the training shape, B=8 S=2048) 4 warps of two m16 tiles, 128 query
// rows per CTA; at D = 128 (the 8B drafter's prefill, B=1 S=512, and
// S=1000) 8 warps of one, also 128 rows.  Wider key blocks, or more tiles
// per warp at D = 128, spill registers.
//
// float32 (flash_fwd_kernel): the CUDA-core kernel of the first port,
// unchanged.  TF32 tensor cores would keep only ~10 bits of each product,
// far outside the float32 tolerance (atol 1e-4), so a float32 input stays
// true fp32: one CTA of 256 threads per 64-query block, the query tile in
// shared memory as fp32, each K and V tile staged and multiplied with
// fp32 FMA from float4 shared-memory reads (flash_common.cuh).
//
// What differs from the TPU kernel: Pallas held whole [S, D] K and V in
// VMEM per grid step; here a K/V tile is one block of keys, restaged per
// block, and S need not be a multiple of the tile (the ragged edge is
// masked).  The bf16 route rounds P against the running max, as the TPU
// kernel does.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/flash_attention.py):
//   int ptt_flash_attention_fwd(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, D,
//                               scale, causal, dtype, stream)
//   dtype 0 = float32, 1 = bfloat16; D in {64, 128}; Hq % Hkv == 0; 16-byte
//   aligned pointers (the wrapper checks).  Returns cudaGetLastError().

#include "flash_common.cuh"
#include "flash_mma.cuh"

#include <math.h>

namespace {

using namespace flash;

// ---------------------------------------------------------------------------
// float32: CUDA cores

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

// ---------------------------------------------------------------------------
// bfloat16: tensor cores

using fmma::bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D, int WARPS, int MT, int BN>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                    float scale, int causal) {
  using namespace fmma;
  constexpr int kThreadsTc = WARPS * 32;
  constexpr int BM = WARPS * MT * 16;   // query rows per CTA
  constexpr int LD = D + kPad;
  constexpr int KD = D / 16;            // k16 steps over the head dim
  constexpr int NT = BN / 8;            // n8 tiles of a score row
  constexpr int DT = D / 8;             // n8 tiles of an output row
  extern __shared__ uint4 smem_tc[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_tc);
  bf16* sK = sQ + BM * LD;              // 2 stages of [BN][LD]
  bf16* sV = sK + 2 * BN * LD;          // 2 stages of [BN][LD]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nqb = (Sq + BM - 1) / BM;
  const int qb = nqb - 1 - (int)blockIdx.x;   // heaviest causal blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qb * BM;
  const int wq0 = q0 + warp * MT * 16;        // this warp's first row

  const long long q_stride = (long long)Hq * D;
  const long long kv_stride = (long long)Hkv * D;
  const bf16* qg = q + ((long long)b * Sq * Hq + h) * D;
  const bf16* kg = k + ((long long)b * Sk * Hkv + hk) * D;
  const bf16* vg = v + ((long long)b * Sk * Hkv + hk) * D;

  const int n_kb = (Sk + BN - 1) / BN;
  const int kb_end = causal ? min(n_kb, (q0 + BM + BN - 1) / BN) : n_kb;

  load_tile_async<BM, D, kThreadsTc>(sQ, qg, q_stride, q0, Sq - q0);
  load_tile_async<BN, D, kThreadsTc>(sK, kg, kv_stride, 0, Sk);
  load_tile_async<BN, D, kThreadsTc>(sV, vg, kv_stride, 0, Sk);
  cp_async_commit();

  // m and l per row half (rows g and g + 8 of each m16 tile); m in log2
  // units (scores times scale * log2 e); l is this lane's partial sum over
  // its own columns, reduced over the quad at the end.
  float acc[MT][DT][4], m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_run[mt][r] = kNegInf;
      l_run[mt][r] = 0.f;
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][dt][e] = 0.f;
  }
  const float sl2 = scale * kLog2e;

  for (int kb = 0; kb < kb_end; ++kb) {
    const int st = kb & 1;
    if (kb + 1 < kb_end) {
      const int k1 = (kb + 1) * BN;
      load_tile_async<BN, D, kThreadsTc>(sK + (st ^ 1) * BN * LD, kg,
                                         kv_stride, k1, Sk - k1);
      load_tile_async<BN, D, kThreadsTc>(sV + (st ^ 1) * BN * LD, vg,
                                         kv_stride, k1, Sk - k1);
    }
    cp_async_commit();
    cp_async_wait<1>();   // block kb (and, first, Q) has landed
    __syncthreads();

    const int k0 = kb * BN;
    if (!(causal && wq0 + MT * 16 - 1 < k0)) {
      const bf16* cK = sK + st * BN * LD;
      const bf16* cV = sV + st * BN * LD;

      // S = Q K^T
      float s[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          load_a<LD>(a[mt], sQ, (warp * MT + mt) * 16, kk * 16, lane);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t bb[4];
          load_b<LD>(bb, cK, nt * 8, kk * 16, lane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma(s[mt][nt], a[mt], bb[0], bb[1]);
            mma(s[mt][nt + 1], a[mt], bb[2], bb[3]);
          }
        }
      }

      // scale into log2 units; mask only the blocks that need it
      const bool need_mask =
          (causal && k0 + BN - 1 > wq0) || (k0 + BN > Sk);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float val = s[mt][nt][e] * sl2;
            if (need_mask) {
              const int row = wq0 + mt * 16 + g + (e >> 1) * 8;
              const int key = k0 + nt * 8 + 2 * t + (e & 1);
              if (key >= Sk || (causal && key > row)) val = kNegInf;
            }
            s[mt][nt][e] = val;
          }

      // online softmax in registers
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m_run[mt][r];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mx = fmaxf(mx, fmaxf(s[mt][nt][2 * r], s[mt][nt][2 * r + 1]));
          mx = quad_max(mx);
          const float alpha = exp2_approx(m_run[mt][r] - mx);
          m_run[mt][r] = mx;
          float rs = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = exp2_approx(s[mt][nt][2 * r + e] - mx);
              s[mt][nt][2 * r + e] = p;
              rs += p;
            }
          l_run[mt][r] = l_run[mt][r] * alpha + rs;
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) {
            acc[mt][dt][2 * r] *= alpha;
            acc[mt][dt][2 * r + 1] *= alpha;
          }
        }

      // O += P V, P rounded to bf16 in registers
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          c_to_a(pa[mt], s[mt][2 * j], s[mt][2 * j + 1]);
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t bb[4];
          load_b_trans<LD>(bb, cV, j * 16, dt * 8, lane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma(acc[mt][dt], pa[mt], bb[0], bb[1]);
            mma(acc[mt][dt + 1], pa[mt], bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();   // stage st is free for block kb + 2
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = fmaxf(quad_sum(l_run[mt][r]), 1e-30f);
      const int row = wq0 + mt * 16 + g + r * 8;
      if (row >= Sq) continue;
      bf16* orow = o + ((long long)b * Sq + row) * q_stride
                   + (long long)h * D + 2 * t;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<uint32_t*>(orow + dt * 8) =
            pack_bf16(acc[mt][dt][2 * r] / l, acc[mt][dt][2 * r + 1] / l);
      if (t == 0)
        lse[((long long)b * Hq + h) * Sq + row] =
            m_run[mt][r] * kLn2 + logf(l);
    }
}

template <int D, int WARPS, int MT, int BN>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              void* lse, int B, int Sq, int Sk, int Hq, int Hkv, float scale,
              int causal, cudaStream_t stream) {
  constexpr int BM = WARPS * MT * 16;
  constexpr int smem = (BM + 4 * BN) * (D + fmma::kPad) * 2;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<D, WARPS, MT, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((Sq + BM - 1) / BM, Hq, B);
  flash_fwd_tc_kernel<D, WARPS, MT, BN><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), Sq, Sk, Hq, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int Sq, int Sk, int Hq, int Hkv,
                                       int D, float scale, int causal,
                                       int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      B > 65535 || Hq > 65535 || (causal && Sq != Sk) ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D == 64 ? launch<float, 64>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv,
                                       scale, causal, st)
                   : launch<float, 128>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv,
                                        scale, causal, st);
  if (dtype == 1)
    return D == 64 ? launch_tc<64, 4, 2, 64>(q, k, v, o, lse, B, Sq, Sk, Hq,
                                             Hkv, scale, causal, st)
                   : launch_tc<128, 8, 1, 64>(q, k, v, o, lse, B, Sq, Sk, Hq,
                                              Hkv, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
