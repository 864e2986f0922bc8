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
//   lens            [B] int32 >= 0            LAST valid slot, inclusive
//   part            [B, Hkv, n_splits, G, D+4] f32  scratch: each split's
//                   unnormalized accumulator, then its (running max,
//                   denominator)
// Each staged K/V element is dequantized as code * scale in fp32 and
// rounded to q's dtype before any dot, as paged_dequant_view
// (ops/decode_attention.py) and the Pallas kernel (:648-649, :678-679) do.
// Logits and the softmax are fp32; P is rounded to q's dtype before P V
// (relative to the running max of the online softmax, as the Pallas
// kernel rounds it relative to its row max), and the output is stored in
// q's dtype.
//
// Bound: memory.  Per layer the function reads the valid prefix once:
// sum_b (lens[b]+1) * 2 * Hkv * (D + 4) bytes (codes plus scales), half
// of a bf16 cache's D * 2 per head; its 4 * Hq * D operations per slot are
// about 4 per byte, far below the tensor-core ridge.
//
// Design: the int8 K-wide verify kernel at C = 1, as
// paged_decode_attention.cu is the float one: split-K flash-decoding over
// the block walk of csrc/decode_split.cuh with its PagedWalk and its int8
// staging (codes and scales through the 3-stage cp.async ring, a landed
// block dequantized once into a T tile that the rows read).  A CTA walks
// a fixed run of bps = max(1, 128 / L) blocks of one row's table for one
// kv head (grid (split, kv head, row)), the G query rows (padded to one
// m16 tile) on mma.sync in bf16, on CUDA cores in float32; a merge kernel
// weights the row's splits in a fixed order.  Split boundaries depend on
// L only, so a row's output bits do not depend on the batch it rides in.
// Only blocks the table names for the row are read, and no slot past
// lens[b] reaches the output (its logit is masked, its staged row zero).
//
// What differs from the TPU kernel: the Pallas kernel zeroes its V scale
// buffer at program 0 because VMEM scratch persists across its sequential
// grid (:599-608).  CTAs here share no state, so there is nothing to
// zero; the walk is cut across CTAs and merged.  Head dims are the
// template's, 32, 64, 128 or 256 (the first design took any D % 16 == 0).
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/decode_attention.py):
//   int ptt_paged_decode_attention_int8(q, k_codes, v_codes, k_scales,
//       v_scales, tables, lens, out, part, B, Hkv, G, D, L, max_blocks,
//       num_rows, bps, n_splits, scale, dtype, stream)
//   dtype 0 = float32, 1 = bfloat16; D in {32, 64, 128, 256}; bps <= 128
//   and bps * n_splits >= max_blocks; 16-byte aligned pointers (the
//   wrapper checks).  Launches the split kernel and the merge kernel and
//   returns cudaGetLastError().

#include "decode_split.cuh"

extern "C" int ptt_paged_decode_attention_int8(
    const void* q, const void* k_codes, const void* v_codes,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* lens, void* out, void* part, int B, int hkv, int g, int d,
    int L, int max_blocks, int num_rows, int bps, int n_splits, float scale,
    int dtype, void* stream) {
  using dsplit::PagedWalk;
  if (max_blocks <= 0 || num_rows <= 0 ||
      (long long)bps * n_splits < max_blocks)
    return (int)cudaErrorInvalidValue;
  const PagedWalk walk{static_cast<const int*>(tables), max_blocks,
                       num_rows};
  const dsplit::Args<PagedWalk> a{
      q, k_codes, v_codes, k_scales, v_scales, lens, out, part,
      walk, B, 1, hkv, g, d, L, bps, n_splits, scale, dtype,
      static_cast<cudaStream_t>(stream)};
  return dsplit::dispatch<PagedWalk, true>(a);
}
