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
//   part_acc    [B, Hkv, n_splits, R, D] f32  the splits' partial results
//   part_ml     [B, Hkv, n_splits, R, 2] f32  (R = C*G query rows), scratch
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
// tensor-core ridge, so the design fills the card with loads in flight
// and keeps the CUDA-core arithmetic off the critical path.
//
// Design: flash-decoding (split-K over the block walk), two kernels.
//   Split kernel, grid (split, kv head, row).  A split is a fixed run of
//   bps = max(1, 128 / L) blocks of the table: split s covers blocks
//   s*bps .. s*bps + bps - 1, clamped to the row's own walk
//   nblk = min((lens[b] + C - 1) / L + 1, max_blocks), the Pallas
//   kernel's n_blk clamp.  The wrapper computes bps and the split count
//   n_splits = ceil(max_blocks / bps) from max_blocks and L alone; a CTA
//   whose split starts at or past nblk exits at once.  At phase 2's
//   shape that is 384 CTAs where one CTA per (row, kv head) gave 64.
//   The CTA loads its split's table entries once, then streams the blocks
//   of K and V through a 3-stage cp.async ring (16 bytes a thread, slots
//   past the last query zero-filled and never read from the arena), so
//   two blocks are in flight while one computes.  The int8 entry stages
//   codes and scales in the ring and dequantizes a landed block once into
//   a T tile in shared memory, which the rows then read as the float
//   entry reads its stage.  The CTA holds the R = C*G query rows of its
//   kv head (row r = c*G + gi, the Pallas kernel's order).
//   - bfloat16, on the tensor cores (mma.sync m16n8k16, flash_mma.cuh):
//     the rows pad to m16 tiles (R = 20 -> 32); two warps per tile, each
//     keeping the tile's Q as A fragments in registers for the whole walk
//     and half of its D output columns as fp32 accumulators.  Per 16
//     slots a warp builds S = Q K^T (K through ldmatrix from rows padded
//     by 16 bytes, so no bank conflicts), updates the online softmax of
//     its two rows per thread with quad shuffles, rounds P to bf16 into
//     the A fragment of P V (as the forward kernel does) and adds P V (V
//     through ldmatrix.trans).  A block of L slots is staged as L rounded
//     up to 16, the extra rows zero and masked.
//   - float32, on CUDA cores (TF32 would break the float32 tolerance):
//     D/16 lanes per row, each keeping 16 elements of its row's q and
//     fp32 accumulator in registers, so a slot's logit is 16 fmaf per
//     lane and a log2(D/16)-step xor-shuffle sum within the lane group;
//     every lane of the group then runs the row's online softmax on the
//     same values.  Lane k reads the 16-byte chunks k, k + D/16, ... of a
//     slot row, so all groups of a warp read the same chunks: one
//     shared-memory wavefront per load.
//   Logits are exact products of q's dtype summed in fp32 (in another
//   order than the plain version's); the online softmax updates per 16
//   slots (bf16) or 8 (float32).  The CTA writes its rows' unnormalized
//   (acc, m, l) to part_acc and part_ml.
//   Merge kernel, grid (query row, kv head, row), D threads: the row's
//   splits s < ceil(nblk / bps), weight w_s = exp(m_s - max m);
//   out = sum(w acc) / sum(w l), rounded to T, summed in a fixed order.
//
// Why a row's output does not depend on its batch: the split boundaries
// are multiples of bps, a function of L only, and every quantity of a CTA
// (its blocks, its rows' frontiers) comes from its own row's lens, table
// and q.  The merge reads the row's own splits in a fixed order.  B, the
// number of SMs and the other rows never enter.  A block or a whole split
// past a query row's frontier (lens[b] + r/G) leaves that row's state
// untouched: masked logits are -inf, the running max does not move
// (alpha = exp(0) = 1), P is 0, so acc and l are unchanged bit for bit;
// a split that saw no slot of the row keeps m = -inf, l = 0, acc = 0, and
// the merge skips it (weight 0, never exp(-inf - -inf)).  So a row's
// output does not depend on C either.
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
// nothing to zero; the walk is cut across CTAs and merged, which the
// sequential TPU grid had no need for.
//
// Measured by chip_smoke.py phase 2 (NVIDIA H100 80GB HBM3, 700.00 W; bf16,
// B=8 C=5 Hkv=8 G=4 D=128 L=16, lens up to 2042, L2 flushed): 0.0304 ms,
// split and merge together, against a byte bound of 0.0073, SDPA over
// the pre-gathered view 0.1203 and the first design's 1.5370; the int8
// cache 0.0344; the longest row alone (B=1) 0.0238.  PERF.md's kernel
// table, rows 9 and 10, keeps the current numbers.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/decode_attention.py):
//   int ptt_paged_decode_attention_multi(q, k_arena, v_arena, tables, lens,
//       out, part_acc, part_ml, B, C, Hkv, G, D, L, max_blocks, num_rows,
//       bps, n_splits, scale, dtype, stream)
//   int ptt_paged_decode_attention_multi_int8(q, k_codes, v_codes, k_scales,
//       v_scales, tables, lens, out, part_acc, part_ml, B, C, Hkv, G, D, L,
//       max_blocks, num_rows, bps, n_splits, scale, dtype, stream)
//   dtype 0 = float32, 1 = bfloat16; D in {32, 64, 128, 256}; at most 512
//   threads a CTA (bf16: 64 per 16 query rows; float32: C*G*D/16);
//   bps <= 128 and bps * n_splits >= max_blocks; 16-byte aligned pointers
//   (the wrapper checks).  Each launches the split kernel and the merge kernel
//   and returns cudaGetLastError().

#include "dtype.cuh"
#include "flash_mma.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using ptt::from_f32;
using ptt::to_f32;

constexpr int kStages = 3;        // blocks of the cp.async ring
constexpr int kTile = 8;          // slots per online-softmax update (fp32)
constexpr int kElems = 16;        // elements of a row per lane (fp32)
constexpr int kMaxThreads = 512;
constexpr int kMaxBps = 128;      // blocks per split (128 / L, L >= 1)

template <typename T> struct Vec;   // elements of T in 16 bytes
template <> struct Vec<float> { static constexpr int kN = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int kN = 8; };

// bfloat16 runs on the tensor cores, float32 on CUDA cores
template <typename T> struct OnTensorCores {
  static constexpr bool value = false;
};
template <> struct OnTensorCores<__nv_bfloat16> {
  static constexpr bool value = true;
};

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* f) {
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < Vec<T>::kN; ++e) f[e] = to_f32(v[e]);
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// Staged slots per block (a multiple of the m16n8k16 depth on the tensor
// cores) and elements per staged T row (bf16 rows padded by 16 bytes, so
// that ldmatrix reads eight rows on eight bank groups).
template <typename T>
__host__ __device__ constexpr int staged_slots(int L) {
  return OnTensorCores<T>::value ? round16(L) : L;
}
template <typename T>
__host__ __device__ constexpr int staged_row(int d) {
  return OnTensorCores<T>::value ? d + fmma::kPad : d;
}

// Shared memory of the split kernel: the ring of K and V blocks (T tiles,
// or int8 codes plus the ring of scales and one dequantized K and V tile).
template <typename T, bool kInt8>
__host__ __device__ constexpr int smem_bytes(int L, int d) {
  return kInt8 ? kStages * 2 * L * d + round16(kStages * 2 * L * 4)
                     + 2 * staged_slots<T>(L) * staged_row<T>(d)
                           * (int)sizeof(T)
               : kStages * 2 * staged_slots<T>(L) * staged_row<T>(d)
                     * (int)sizeof(T);
}

template <typename T, int GS>
__host__ __device__ constexpr int split_threads(int rows) {
  return OnTensorCores<T>::value
             ? 64 * ((rows + 15) / 16)   // two warps per m16 tile of rows
             : ((rows * GS + 31) / 32 * 32 < 128 ? 128
                                                 : (rows * GS + 31) / 32 * 32);
}

template <typename T, bool kInt8, int GS>
__global__ void __launch_bounds__(kMaxThreads)
paged_multi_kernel(const T* __restrict__ q, const void* __restrict__ k_arena,
                   const void* __restrict__ v_arena,
                   const float* __restrict__ k_scales,
                   const float* __restrict__ v_scales,
                   const int* __restrict__ tables,
                   const int* __restrict__ lens, float* __restrict__ part_acc,
                   float* __restrict__ part_ml, int cq, int hkv, int g, int L,
                   int max_blocks,
                   int num_rows, int bps, int n_splits, float scale) {
  constexpr int D = 16 * GS;
  constexpr bool kTC = OnTensorCores<T>::value;
  constexpr int LDT = staged_row<T>(D);   // elements per staged T row
  constexpr int TB = (int)sizeof(T);

  const int sp = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int len = lens[b];
  const int last = len + cq - 1;         // last staged slot
  int nblk = last / L + 1;
  if (nblk > max_blocks) nblk = max_blocks;
  const int j_begin = sp * bps;
  if (j_begin >= nblk) return;           // uniform: no barrier skipped
  const int n_it = min(j_begin + bps, nblk) - j_begin;
  const int Lp = staged_slots<T>(L);

  __shared__ int blk_s[kMaxBps];         // this split's arena rows
  extern __shared__ uint4 smem_multi[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem_multi);
  // one staged block of K (or of V): codes, or a T tile
  const int stage_bytes = kInt8 ? L * D : Lp * LDT * TB;
  float* ring_sc = reinterpret_cast<float*>(ring + kStages * 2 * stage_bytes);
  T* dq_k = reinterpret_cast<T*>(
      ring + kStages * 2 * stage_bytes + round16(kStages * 2 * L * 4));
  T* dq_v = dq_k + Lp * LDT;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int rows = cq * g;
  const size_t row_stride = (size_t)hkv * D;

  // a table entry outside the arena is clamped to its last row (the
  // trash row), as an out-of-range gather clamps in the JAX package
  for (int i = tid; i < n_it; i += nthreads)
    blk_s[i] = min(max(tables[(size_t)b * max_blocks + j_begin + i], 0),
                   num_rows - 1);
  if constexpr (kInt8) {
    // rows L .. Lp - 1 of the dequantized tiles stay zero
    for (int i = tid; i < (Lp - L) * LDT; i += nthreads) {
      dq_k[L * LDT + i] = from_f32<T>(0.f);
      dq_v[L * LDT + i] = from_f32<T>(0.f);
    }
  }
  __syncthreads();

  // queue block `it` of the split into stage st; slots past the last
  // query (and rows L .. Lp - 1) are zero-filled, never read
  auto load_block = [&](int it, int st) {
    const int j = j_begin + it;
    const int ES = kInt8 ? 1 : TB;
    const size_t base = ((size_t)blk_s[it] * L * row_stride
                         + (size_t)h * D) * ES;
    const uint8_t* kg = static_cast<const uint8_t*>(k_arena) + base;
    const uint8_t* vg = static_cast<const uint8_t*>(v_arena) + base;
    uint8_t* ks = ring + (st * 2) * stage_bytes;
    uint8_t* vs = ks + stage_bytes;
    const int cpr = D * ES / 16;          // 16-byte chunks per row
    const int nrow = kInt8 ? L : Lp;
    const int srow = kInt8 ? D : LDT * TB; // staged row bytes
    for (int i = tid; i < nrow * cpr; i += nthreads) {
      const int l = i / cpr;
      const int x = (i - l * cpr) * 16;
      const bool ok = l < L && j * L + l <= last;
      const size_t off = ok ? (size_t)l * row_stride * ES + x : 0;
      fmma::cp_async16(ks + l * srow + x, kg + off, ok);
      fmma::cp_async16(vs + l * srow + x, vg + off, ok);
    }
    if constexpr (kInt8) {
      const size_t sbase = (size_t)blk_s[it] * L * hkv + h;
      float* sk = ring_sc + st * 2 * L;
      for (int l = tid; l < L; l += nthreads) {
        const bool ok = j * L + l <= last;
        const size_t off = ok ? sbase + (size_t)l * hkv : sbase;
        fmma::cp_async4(sk + l, k_scales + off, ok);
        fmma::cp_async4(sk + L + l, v_scales + off, ok);
      }
    }
  };

  // --- per-thread state -------------------------------------------------
  // tensor cores: warp w owns rows 16 (w % MT) .. + 15 (m16 tile mt) and
  // output columns (w / MT) * D/2 .. + D/2 - 1; each thread holds rows
  // ra = 16 mt + g and rb = ra + 8 of the C fragments
  // CUDA cores: GS lanes per row, 16 elements each
  constexpr int KS = D / 16;              // m16n8k16 steps over D
  constexpr int NT = kTC ? D / 16 : 1;    // n8 tiles of this warp's half
  uint32_t qa[kTC ? KS : 1][4];
  float acc[kTC ? NT : 1][kTC ? 4 : kElems];
  float qr[kTC ? 1 : kElems];
  float m2[2] = {-INFINITY, -INFINITY}, l2[2] = {0.f, 0.f};

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int MT = (rows + 15) / 16;
  const int mt = warp % MT;
  const int dpart = warp / MT;
  const int tg = lane >> 2;               // mma groupID
  const int t4 = lane & 3;
  // the rows this thread's values belong to
  const int ra = kTC ? mt * 16 + tg : tid / GS;
  const int rb = ra + 8;
  const int kl = tid % GS;
  const bool active = kTC ? true : ra < rows;
  const unsigned gmask = ((1u << GS) - 1u) << (lane & ~(GS - 1));
  const int front_a = ra < rows ? len + ra / g : -1;   // causal frontiers
  const int front_b = rb < rows ? len + rb / g : -1;

  auto q_row = [&](int r) {
    const int c = r / g;
    return q + ((((size_t)b * cq + c) * hkv + h) * g + (r - c * g))
                   * (size_t)D;
  };
  if constexpr (kTC) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int col = ks * 16 + 2 * t4;
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (ra < rows) {
        v[0] = *reinterpret_cast<const uint32_t*>(q_row(ra) + col);
        v[2] = *reinterpret_cast<const uint32_t*>(q_row(ra) + col + 8);
      }
      if (rb < rows) {
        v[1] = *reinterpret_cast<const uint32_t*>(q_row(rb) + col);
        v[3] = *reinterpret_cast<const uint32_t*>(q_row(rb) + col + 8);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[ks][e] = v[e];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  } else {
    constexpr int CN = Vec<T>::kN;
    if (active) {
#pragma unroll
      for (int i = 0; i < kElems / CN; ++i)
        unpack<T>(*reinterpret_cast<const uint4*>(q_row(ra)
                                                  + (kl + GS * i) * CN),
                  qr + i * CN);
    }
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[0][e] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_it) load_block(s, s);
    fmma::cp_async_commit();
  }

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    if (it + kStages - 1 < n_it)
      load_block(it + kStages - 1, (it + kStages - 1) % kStages);
    fmma::cp_async_commit();
    fmma::cp_async_wait<kStages - 1>();   // block `it` has landed
    __syncthreads();

    const T* kt;
    const T* vt;
    if constexpr (kInt8) {
      // dequantize the landed codes once: code * scale in fp32, rounded
      // to T, as paged_dequant_view
      constexpr int CN = Vec<T>::kN;
      const int8_t* kc =
          reinterpret_cast<const int8_t*>(ring + st * 2 * stage_bytes);
      const int8_t* vc = kc + stage_bytes;
      const float* sk = ring_sc + st * 2 * L;
      const int cpr = D / 16;
      for (int i = tid; i < 2 * L * cpr; i += nthreads) {
        const bool is_v = i >= L * cpr;
        const int ii = is_v ? i - L * cpr : i;
        const int l = ii / cpr;
        const int x = (ii - l * cpr) * 16;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            (is_v ? vc : kc) + l * D + x);
        const float sc = sk[(is_v ? L : 0) + l];
        const int8_t* cd = reinterpret_cast<const int8_t*>(&raw);
        T* dst = (is_v ? dq_v : dq_k) + l * LDT + x;
#pragma unroll
        for (int e0 = 0; e0 < 16; e0 += CN) {
          uint4 packed;
          T* pv = reinterpret_cast<T*>(&packed);
#pragma unroll
          for (int e = 0; e < CN; ++e)
            pv[e] = from_f32<T>((float)cd[e0 + e] * sc);
          *reinterpret_cast<uint4*>(dst + e0) = packed;
        }
      }
      __syncthreads();
      kt = dq_k;
      vt = dq_v;
    } else {
      kt = reinterpret_cast<const T*>(ring + st * 2 * stage_bytes);
      vt = kt + Lp * LDT;
    }
    const int slot0 = (j_begin + it) * L;

    if constexpr (kTC) {
      using fmma::bf16;
      const bf16* kb = reinterpret_cast<const bf16*>(kt);
      const bf16* vb = reinterpret_cast<const bf16*>(vt);
      for (int cs = 0; cs < Lp; cs += 16) {
        // S = Q K^T over 16 slots: n8 tiles cs .. cs+7 (s0), +8 (s1)
        float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t bb[4];
          fmma::load_b<LDT>(bb, kb, cs, ks * 16, lane);
          fmma::mma(s0, qa[ks], bb[0], bb[1]);
          fmma::mma(s1, qa[ks], bb[2], bb[3]);
        }
        float p0[4], p1[4];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int front = hr ? front_b : front_a;
          float v[4] = {s0[2 * hr], s0[2 * hr + 1], s1[2 * hr],
                        s1[2 * hr + 1]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int l = cs + (e >> 1) * 8 + 2 * t4 + (e & 1);
            v[e] = (l < L && slot0 + l <= front) ? v[e] * scale : -INFINITY;
          }
          float mx = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
          mx = fmaxf(m2[hr], fmma::quad_max(mx));
          // mx = -inf: no slot of the row seen yet, the state stays as
          // it is (the quad's shuffles still run in every lane)
          const bool seen = mx != -INFINITY;
          float alpha = 1.f;
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          if (seen) {
            alpha = m2[hr] == -INFINITY ? 0.f : expf(m2[hr] - mx);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[e] = v[e] == -INFINITY ? 0.f : expf(v[e] - mx);
          }
          const float psum = fmma::quad_sum((p[0] + p[1]) + (p[2] + p[3]));
          if (seen) {
            l2[hr] = l2[hr] * alpha + psum;
            m2[hr] = mx;
          }
          p0[2 * hr] = p[0];
          p0[2 * hr + 1] = p[1];
          p1[2 * hr] = p[2];
          p1[2 * hr + 1] = p[3];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            acc[nt][2 * hr] *= alpha;
            acc[nt][2 * hr + 1] *= alpha;
          }
        }
        // O += P(bf16) V over the 16 slots, this warp's D/2 columns
        uint32_t pa[4];
        fmma::c_to_a(pa, p0, p1);   // P in q's dtype before P V
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t bb[4];
          fmma::load_b_trans<LDT>(bb, vb, cs, dpart * (D / 2) + nt * 8,
                                  lane);
          fmma::mma(acc[nt], pa, bb[0], bb[1]);
          fmma::mma(acc[nt + 1], pa, bb[2], bb[3]);
        }
      }
    } else if (active) {
      constexpr int CN = Vec<T>::kN;
      constexpr int NCH = kElems / CN;
      for (int t0 = 0; t0 < L; t0 += kTile) {
        float s[kTile];
#pragma unroll
        for (int jj = 0; jj < kTile; ++jj) {
          const int l = t0 + jj;
          float part = 0.f;
          if (l < L) {
            const T* kr = kt + l * LDT;
#pragma unroll
            for (int i = 0; i < NCH; ++i) {
              float f[CN];
              unpack<T>(*reinterpret_cast<const uint4*>(
                            kr + (kl + GS * i) * CN), f);
#pragma unroll
              for (int e = 0; e < CN; ++e)
                part = fmaf(qr[i * CN + e], f[e], part);
            }
          }
#pragma unroll
          for (int o = GS / 2; o > 0; o >>= 1)
            part += __shfl_xor_sync(gmask, part, o);
          s[jj] = (l < L && slot0 + l <= front_a) ? part * scale
                                                  : -INFINITY;
        }
        float mx = m2[0];
#pragma unroll
        for (int jj = 0; jj < kTile; ++jj) mx = fmaxf(mx, s[jj]);
        if (mx == -INFINITY) continue;   // no slot of this row seen yet
        const float alpha = m2[0] == -INFINITY ? 0.f : expf(m2[0] - mx);
        float pr[kTile];
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < kTile; ++jj) {
          const float p = s[jj] == -INFINITY ? 0.f : expf(s[jj] - mx);
          pr[jj] = round_to<T>(p);   // P in q's dtype before P V
          sum += p;
        }
        l2[0] = l2[0] * alpha + sum;
        m2[0] = mx;
#pragma unroll
        for (int e = 0; e < kElems; ++e) acc[0][e] *= alpha;
#pragma unroll
        for (int jj = 0; jj < kTile; ++jj) {
          const int l = t0 + jj;
          if (l >= L) break;
          const T* vr = vt + l * LDT;
#pragma unroll
          for (int i = 0; i < NCH; ++i) {
            float f[CN];
            unpack<T>(*reinterpret_cast<const uint4*>(
                          vr + (kl + GS * i) * CN), f);
#pragma unroll
            for (int e = 0; e < CN; ++e)
              acc[0][i * CN + e] = fmaf(pr[jj], f[e], acc[0][i * CN + e]);
          }
        }
      }
    }
    __syncthreads();   // stage st (and the dequantized tile) are free
  }

  // the split's unnormalized (acc, m, l) of each row it holds
  const size_t row0 = ((size_t)b * hkv + h) * n_splits + sp;
  float* ml = part_ml;
  if constexpr (kTC) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = hr ? rb : ra;
      if (r >= rows) continue;
      float* pacc = part_acc + (row0 * rows + r) * D + dpart * (D / 2)
                    + 2 * t4;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(pacc + nt * 8) =
            make_float2(acc[nt][2 * hr], acc[nt][2 * hr + 1]);
      if (dpart == 0 && t4 == 0) {
        ml[(row0 * rows + r) * 2] = m2[hr];
        ml[(row0 * rows + r) * 2 + 1] = l2[hr];
      }
    }
  } else {
    if (!active) return;
    constexpr int CN = Vec<T>::kN;
    float* pacc = part_acc + (row0 * rows + ra) * D;
#pragma unroll
    for (int i = 0; i < kElems / CN; ++i)
#pragma unroll
      for (int e = 0; e < CN; e += 4)
        *reinterpret_cast<float4*>(pacc + (kl + GS * i) * CN + e) =
            make_float4(acc[0][i * CN + e], acc[0][i * CN + e + 1],
                        acc[0][i * CN + e + 2], acc[0][i * CN + e + 3]);
    if (kl == 0) {
      ml[(row0 * rows + ra) * 2] = m2[0];
      ml[(row0 * rows + ra) * 2 + 1] = l2[0];
    }
  }
}

// The merge, one CTA of D threads per (query row, kv head, row): warp 0
// reads the row's splits s < ceil(nblk / bps) and turns them into weights
// w_s = exp(m_s - max m) (0 for a split that saw no slot of the row) and
// the denominator sum(w_s l_s), a fixed lane order and a fixed xor tree;
// then each thread sums w_s acc_s over its element in ascending s.
template <typename T>
__global__ void __launch_bounds__(256)
paged_multi_kernel_merge(const int* __restrict__ lens,
                         const float* __restrict__ part_acc,
                         const float* __restrict__ part_ml,
                         T* __restrict__ out, int cq, int hkv, int g, int d,
                         int L, int max_blocks, int bps, int n_splits) {
  extern __shared__ float w_s[];         // [n_splits] weights, then 1/den
  const int r = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = cq * g;
  int nblk = (lens[b] + cq - 1) / L + 1;
  if (nblk > max_blocks) nblk = max_blocks;
  const int ns = (nblk + bps - 1) / bps;
  const size_t row0 = ((size_t)b * hkv + h) * n_splits * rows + r;
  const float* ml = part_ml;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float mx = -INFINITY;
    for (int s = lane; s < ns; s += 32)
      mx = fmaxf(mx, ml[(row0 + (size_t)s * rows) * 2]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float den = 0.f;
    for (int s = lane; s < ns; s += 32) {
      const float ms = ml[(row0 + (size_t)s * rows) * 2];
      // a split that saw no slot of the row: weight 0, never
      // exp(-inf - -inf)
      const float w = ms == -INFINITY ? 0.f : expf(ms - mx);
      w_s[s] = w;
      den += w * ml[(row0 + (size_t)s * rows) * 2 + 1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, o);
    if (lane == 0) w_s[n_splits] = den;
  }
  __syncthreads();
  const float den = w_s[n_splits];
  const int c = r / g;
  const int gi = r - c * g;
  T* o = out + ((((size_t)b * cq + c) * hkv + h) * g + gi) * (size_t)d;
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    float num = 0.f;
#pragma unroll 4
    for (int s = 0; s < ns; ++s) {
      const float w = w_s[s];
      if (w != 0.f) num += w * part_acc[(row0 + (size_t)s * rows) * d + e];
    }
    o[e] = from_f32<T>(num / den);
  }
}

template <typename T, bool kInt8, int GS>
int launch(const void* q, const void* k_arena, const void* v_arena,
           const float* k_scales, const float* v_scales, const int* tables,
           const int* lens, void* out, float* part_acc, float* part_ml,
           int B, int cq, int hkv, int g, int L, int max_blocks,
           int num_rows, int bps, int n_splits, float scale,
           cudaStream_t stream) {
  constexpr int D = 16 * GS;
  const int rows = cq * g;
  const int threads = split_threads<T, GS>(rows);
  if (threads > kMaxThreads || bps > kMaxBps)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes<T, kInt8>(L, D);
  if (smem > 227 * 1024 - kMaxBps * 4) return (int)cudaErrorInvalidValue;
  static int attr_set = 0;   // blk_s adds static shared memory
  if (smem > attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_multi_kernel<T, kInt8, GS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = smem;
  }
  dim3 grid(n_splits, hkv, B);
  paged_multi_kernel<T, kInt8, GS><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), k_arena, v_arena, k_scales, v_scales, tables,
      lens, part_acc, part_ml, cq, hkv, g, L, max_blocks, num_rows, bps,
      n_splits, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_multi_kernel_merge<T>
      <<<dim3(rows, hkv, B), D, (n_splits + 1) * sizeof(float), stream>>>(
          lens, part_acc, part_ml, static_cast<T*>(out), cq, hkv, g, D, L,
          max_blocks, bps, n_splits);
  return (int)cudaGetLastError();
}

// The operands of one call, as the C entries receive them.
struct Args {
  const void *q, *k, *v, *k_scales, *v_scales, *tables, *lens;
  void *out, *part_acc, *part_ml;
  int B, cq, hkv, g, d, L, max_blocks, num_rows, bps, n_splits;
  float scale;
  int dtype;
  cudaStream_t stream;
};

template <typename T, bool kInt8, int GS>
int launch_args(const Args& a) {
  return launch<T, kInt8, GS>(
      a.q, a.k, a.v, static_cast<const float*>(a.k_scales),
      static_cast<const float*>(a.v_scales),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.lens),
      a.out, static_cast<float*>(a.part_acc),
      static_cast<float*>(a.part_ml), a.B, a.cq, a.hkv, a.g, a.L,
      a.max_blocks, a.num_rows, a.bps, a.n_splits, a.scale, a.stream);
}

template <typename T, bool kInt8>
int launch_d(const Args& a) {
  switch (a.d) {
    case 32: return launch_args<T, kInt8, 2>(a);
    case 64: return launch_args<T, kInt8, 4>(a);
    case 128: return launch_args<T, kInt8, 8>(a);
    case 256: return launch_args<T, kInt8, 16>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kInt8>
int dispatch(const Args& a) {
  if (a.B <= 0 || a.cq <= 0 || a.hkv <= 0 || a.g <= 0 || a.L <= 0 ||
      a.max_blocks <= 0 || a.num_rows <= 0 || a.bps <= 0 ||
      a.n_splits <= 0 || (long long)a.bps * a.n_splits < a.max_blocks ||
      a.B > 65535 || a.hkv > 65535)
    return (int)cudaErrorInvalidValue;
  if (a.dtype == 0) return launch_d<float, kInt8>(a);
  if (a.dtype == 1) return launch_d<__nv_bfloat16, kInt8>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ptt_paged_decode_attention_multi(
    const void* q, const void* k_arena, const void* v_arena,
    const void* tables, const void* lens, void* out, void* part_acc,
    void* part_ml, int B, int cq, int hkv, int g, int d, int L,
    int max_blocks, int num_rows, int bps, int n_splits, float scale,
    int dtype, void* stream) {
  const Args a{q, k_arena, v_arena, nullptr, nullptr, tables, lens, out,
               part_acc, part_ml, B, cq, hkv, g, d, L, max_blocks, num_rows,
               bps, n_splits, scale, dtype,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a);
}

extern "C" int ptt_paged_decode_attention_multi_int8(
    const void* q, const void* k_codes, const void* v_codes,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* lens, void* out, void* part_acc, void* part_ml, int B,
    int cq, int hkv, int g, int d, int L, int max_blocks, int num_rows,
    int bps, int n_splits, float scale, int dtype, void* stream) {
  const Args a{q, k_codes, v_codes, k_scales, v_scales, tables, lens, out,
               part_acc, part_ml, B, cq, hkv, g, d, L, max_blocks, num_rows,
               bps, n_splits, scale, dtype,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a);
}
