// K-wide paged flash-decode attention for Hopper (sm_90a): the attention
// of a speculative-decoding verify forward.  Each sequence brings C = K+1
// query tokens (its last emitted token plus K draft candidates) at global
// slots lens[b] .. lens[b]+C-1; query c attends, grouped-query style, to
// slots <= lens[b] + c of that sequence's KV, stored in a shared block
// arena and reached through the sequence's block table.  One source serves
// a float cache and an int8 cache (codes plus one f32 absmax scale per
// written entry per kv head).
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
//   part        [B, Hkv, n_splits, R, D+4] f32  scratch (R = C*G query
//               rows): each split's unnormalized accumulator, then its
//               (running max, denominator)
//
// Bound: memory, sum_b (lens[b] + C) slots of K and V read once; its 4 * C
// * Hq * D operations per slot are about 2.5 per byte of a bf16 cache at
// C = 5, far below the tensor-core ridge.
//
// Design: split-K flash-decoding over the block walk, csrc/decode_split.cuh
// with its PagedWalk (the one-token paged decode is the same kernel at
// C = 1): a split of bps = max(1, 128 / L) blocks per CTA, grid (split,
// kv head, row), a 3-stage cp.async ring, bf16 S and P V on mma.sync
// tiles, float32 on CUDA cores, then a merge kernel that reads a row's
// splits in a fixed order.  At phase 2's shape that is 384 CTAs where one
// CTA per (row, kv head) gave 64.  A row's output bits do not depend on
// the batch it rides in, nor on C; the header says why.
//
// Measured by chip_smoke.py phase 2 (NVIDIA H100 80GB HBM3, 700.00 W; bf16,
// B=8 C=5 Hkv=8 G=4 D=128 L=16, lens up to 2042, L2 flushed): 0.0301 ms,
// split and merge together, against a byte bound of 0.0073, SDPA over
// the pre-gathered view 0.1192 and the first design's 1.5370; the int8
// cache 0.0340; the longest row alone (B=1) 0.0218.  PERF.md's kernel
// table, rows 9 and 10, keeps the current numbers.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/decode_attention.py):
//   int ptt_paged_decode_attention_multi(q, k_arena, v_arena, tables, lens,
//       out, part, B, C, Hkv, G, D, L, max_blocks, num_rows,
//       bps, n_splits, scale, dtype, stream)
//   int ptt_paged_decode_attention_multi_int8(q, k_codes, v_codes, k_scales,
//       v_scales, tables, lens, out, part, B, C, Hkv, G, D, L,
//       max_blocks, num_rows, bps, n_splits, scale, dtype, stream)
//   dtype 0 = float32, 1 = bfloat16; D in {32, 64, 128, 256}; at most 512
//   threads a CTA (bf16: 64 per 16 query rows; float32: C*G*D/16);
//   bps <= 128 and bps * n_splits >= max_blocks; 16-byte aligned pointers
//   (the wrapper checks).  Each launches the split kernel and the merge kernel
//   and returns cudaGetLastError().

#include "decode_split.cuh"

namespace {

using dsplit::PagedWalk;

int run(const dsplit::Args<PagedWalk>& a, bool int8, int max_blocks,
        int num_rows) {
  if (max_blocks <= 0 || num_rows <= 0 ||
      (long long)a.bps * a.n_splits < max_blocks)
    return (int)cudaErrorInvalidValue;
  return int8 ? dsplit::dispatch<PagedWalk, true>(a)
              : dsplit::dispatch<PagedWalk, false>(a);
}

}  // namespace

extern "C" int ptt_paged_decode_attention_multi(
    const void* q, const void* k_arena, const void* v_arena,
    const void* tables, const void* lens, void* out, void* part, int B,
    int cq, int hkv, int g, int d, int L, int max_blocks, int num_rows,
    int bps, int n_splits, float scale, int dtype, void* stream) {
  const PagedWalk walk{static_cast<const int*>(tables), max_blocks,
                       num_rows};
  const dsplit::Args<PagedWalk> a{
      q, k_arena, v_arena, nullptr, nullptr, lens, out, part,
      walk, B, cq, hkv, g, d, L, bps, n_splits, scale, dtype,
      static_cast<cudaStream_t>(stream)};
  return run(a, false, max_blocks, num_rows);
}

extern "C" int ptt_paged_decode_attention_multi_int8(
    const void* q, const void* k_codes, const void* v_codes,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* lens, void* out, void* part, int B,
    int cq, int hkv, int g, int d, int L, int max_blocks, int num_rows,
    int bps, int n_splits, float scale, int dtype, void* stream) {
  const PagedWalk walk{static_cast<const int*>(tables), max_blocks,
                       num_rows};
  const dsplit::Args<PagedWalk> a{
      q, k_codes, v_codes, k_scales, v_scales, lens, out, part, walk, B,
      cq, hkv, g, d, L, bps, n_splits, scale, dtype,
      static_cast<cudaStream_t>(stream)};
  return run(a, true, max_blocks, num_rows);
}
