// Paged flash-decode attention for Hopper (sm_90a): one new query token
// per sequence attends, grouped-query style, over that sequence's KV prefix
// stored in a shared block arena and reached through its block table.
//
// Replaces the TPU kernel
// paddle_tpu/ops/pallas/decode_attention.py:_paged_kernel (:492, driven by
// _decode_attention_pallas_paged :1019 and _paged_dispatch :981).
//
// Shapes (row-major, contiguous):
//   q, out    [B, Hkv, G, D] f32/bf16     query heads h*G .. h*G+G-1 share kv head h
//   arenas    [NB+1, L, Hkv*D] q's dtype  (or [NB+1, L, Hkv, D]: same bytes)
//   tables    [B, max_blocks] int32       arena row of each logical block
//   lens      [B] int32 >= 0              LAST valid slot, inclusive
//   part      [B, Hkv, n_splits, G, D+4] f32  scratch: each split's
//             unnormalized accumulator, then its (running max, denominator)
// Slots 0..lens[b] participate; the output is softmax(q K^T / sqrt(D)) V
// with fp32 logits, softmax and accumulation, P rounded to q's dtype
// before P V, stored in q's dtype.
//
// Bound: memory.  Per layer the function has to read the valid prefix of
// K and V once, sum_b (lens[b]+1) * 2 * Hkv * D * sizeof(T) bytes, at
// 3.35 TB/s on an H100 SXM; its 4 * Hq * D operations per slot are ~2 per
// byte, far below the tensor-core ridge.
//
// Design: the K-wide verify kernel at C = 1 (the verify's query c attends
// to slots <= lens[b] + c, this kernel's one query to slots <= lens[b]):
// split-K flash-decoding over the block walk from csrc/decode_split.cuh
// with its PagedWalk.  A CTA walks a fixed run of bps = max(1, 128 / L)
// blocks of one row's table for one kv head (grid (split, kv head, row)),
// streams them through a 3-stage cp.async ring, and runs the G query rows
// (padded to one m16 tile) on mma.sync in bf16, on CUDA cores in float32;
// a merge kernel weights the row's splits in a fixed order.  At phase 2's
// shape (B=8, Hkv=8, lens up to 2047, L=16) that is 384 CTAs where one CTA
// per (row, kv head) gave 64, each walking at most 128 slots where one CTA
// walked all 2048 of the longest row.  Split boundaries depend on L only,
// so a row's output bits do not depend on the batch it rides in.
//
// What differs from the TPU kernel: Pallas ran the batch as a sequential
// grid on one core and relied on VMEM scratch shared across grid steps
// (vbuf zeroed at program 0 only; the docstring at :503-517).  CTAs run in
// parallel and in no order on Hopper, so nothing is carried between CTAs;
// the walk is cut across CTAs and merged.  Vacant rows carry all-trash
// tables; the trash row keeps them finite.
//
// Measured by chip_smoke.py phase 2 (NVIDIA H100 80GB HBM3, 700.00 W; bf16,
// B=8 Hkv=8 G=4 D=128 L=16, lens up to 2047, L2 flushed): 0.0241 ms, split
// and merge together, against a byte bound of 0.0071, SDPA over the
// pre-gathered view 0.1016 and the first design's 0.6225 (one CTA per
// row and kv head).  PERF.md's kernel table, row 1, keeps the current
// numbers.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/decode_attention.py):
//   int ptt_paged_decode_attention(q, k_arena, v_arena, tables, lens, out,
//                                  part, B, Hkv, G, D, L, max_blocks,
//                                  num_rows, bps, n_splits, scale, dtype,
//                                  stream)
//   dtype 0 = float32, 1 = bfloat16; D in {32, 64, 128, 256}; bps <= 128
//   and bps * n_splits >= max_blocks; 16-byte aligned pointers (the
//   wrapper checks).  Launches the split kernel and the merge kernel and
//   returns cudaGetLastError().

#include "decode_split.cuh"

extern "C" int ptt_paged_decode_attention(
    const void* q, const void* k_arena, const void* v_arena,
    const void* tables, const void* lens, void* out, void* part, int B,
    int hkv, int g, int d, int L, int max_blocks, int num_rows, int bps, int n_splits, float scale, int dtype,
    void* stream) {
  using dsplit::PagedWalk;
  if (max_blocks <= 0 || num_rows <= 0 ||
      (long long)bps * n_splits < max_blocks)
    return (int)cudaErrorInvalidValue;
  const PagedWalk walk{static_cast<const int*>(tables), max_blocks,
                       num_rows};
  const dsplit::Args<PagedWalk> a{
      q, k_arena, v_arena, nullptr, nullptr, lens, out, part,
      walk, B, 1, hkv, g, d, L, bps, n_splits, scale, dtype,
      static_cast<cudaStream_t>(stream)};
  return dsplit::dispatch<PagedWalk, false>(a);
}
