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
//   q, out    [B, Hkv, G, D] f32/bf16  query heads h*G .. h*G+G-1 share kv head h
//   caches    [B, S, Hkv*D] q's dtype  (or [B, S, Hkv, D]: same bytes), any S
//   lens      [B] int32 >= 0           LAST valid slot, inclusive
//   part      [B, Hkv, n_splits, G, D+4] f32  scratch: each split's
//             unnormalized accumulator, then its (running max, denominator)
// Slots 0 .. min(lens[b], S-1) participate; the output is softmax(q K^T /
// sqrt(D)) V with fp32 logits, softmax and accumulation, P rounded to q's
// dtype before P V (relative to the running max of the online softmax, as
// the Pallas kernel rounds it relative to its row max; the denominator sums
// the unrounded P), stored in q's dtype.
//
// Bound: memory.  Per layer the function has to read the valid prefix of
// K and V once, sum_b (lens[b]+1) * 2 * Hkv * D * sizeof(T) bytes; its
// 4 * Hq * D operations per slot are ~2 per byte, far below the
// tensor-core ridge.  At the drafter's B=1 that is about 2 MB, under a
// microsecond at the card's memory rate: the launch is latency-bound, so
// the design spreads one row over many CTAs.
//
// Design: the paged decode (csrc/paged_decode_attention.cu) with the block
// table replaced by the row's contiguous cache: split-K flash-decoding from
// csrc/decode_split.cuh with its DenseWalk.  A chunk of kChunk = 16 slots
// plays the role of a block; a CTA walks a fixed run of chunks of one row
// for one kv head (grid (split, kv head, row)), the split length set by
// the wrapper from S alone (decode_split_plan), streams them through a
// 3-stage cp.async ring, and runs the G query rows on mma.sync in bf16,
// on CUDA cores in float32; a merge kernel weights the row's splits in a
// fixed order.  Slots past lens[b] (so every slot >= S) are zero-filled in
// the ring, never read.  Any S is taken: the TPU kernel's S % 8 is a
// tiling rule of that chip, and the draft model pads to max_context +
// max_draft.  A row's output bits do not depend on the batch.
//
// What differs from the TPU kernel: Pallas ran the batch as a sequential
// grid on one core and relied on VMEM scratch shared across grid steps
// (vbuf zeroed at program 0 only; the docstring at :402-420).  CTAs here
// share no state, and every CTA reads only the slots it needs; the walk is
// cut across CTAs and merged.
//
// Measured by chip_smoke.py phase 2 (NVIDIA H100 80GB HBM3, 700.00 W; bf16,
// B=1 Hkv=8 G=4 D=128 S=516 lens 514, L2 flushed): 0.0148 ms, split and
// merge together, against a byte bound of 0.0006 (two empty launches take
// about 0.008 ms in the same timing), SDPA over the dense cache 0.0237 and
// the first design's 0.1299.  PERF.md's kernel table, row 12, keeps the
// current numbers.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/decode_attention.py):
//   int ptt_decode_attention(q, k_cache, v_cache, lens, out, part, B, Hkv,
//                            G, D, S, cps, n_splits, scale, dtype, stream)
//   dtype 0 = float32, 1 = bfloat16; D in {32, 64, 128, 256}; cps (chunks
//   per split) <= 128 and cps * n_splits >= ceil(S / 16); 16-byte aligned
//   pointers (the wrapper checks).  Launches the split kernel and the merge
//   kernel and returns cudaGetLastError().

#include "decode_split.cuh"

namespace {
constexpr int kChunk = 16;   // cache slots per block of the walk
}  // namespace

extern "C" int ptt_decode_attention(const void* q, const void* k_cache,
                                    const void* v_cache, const void* lens,
                                    void* out, void* part, int B, int hkv, int g, int d, int S,
                                    int cps, int n_splits, float scale,
                                    int dtype, void* stream) {
  using dsplit::DenseWalk;
  if (S <= 0 || (long long)cps * n_splits < (S + kChunk - 1) / kChunk)
    return (int)cudaErrorInvalidValue;
  const dsplit::Args<DenseWalk> a{
      q, k_cache, v_cache, nullptr, nullptr, lens, out, part,
      DenseWalk{S}, B, 1, hkv, g, d, kChunk, cps, n_splits, scale, dtype,
      static_cast<cudaStream_t>(stream)};
  return dsplit::dispatch<DenseWalk, false>(a);
}
