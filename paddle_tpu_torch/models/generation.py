"""Generation pieces of the serving path and of ``generate()``: port of
``paddle_tpu/models/generation.py`` — ``GenerationConfig`` (:56, every
field of the reference's program key), the dense cache of ``generate()``
(``init_kv_cache`` :76, ``cache_scatter`` :96, ``cache_prefill_write``
:314, ``cached_decode_attention`` :325), ``init_paged_kv_arena`` (:113,
float and int8 caches), ``quantize_kv_heads`` (:152), the decode / chunk
/ verify scatters with their trash routing and their quantize-on-append
``_q`` twins (:174-311), one layer's cache write and attention in each
cache form (``attend_decode``, ``attend_chunk``, ``attend_verify``: the
dispatch every model's attention shares),``filter_top_k_top_p`` (:342), ``sample_token``
(:368), ``decode_scan_body`` (:437), ``beam_scan_body`` (:460) and
``GenerationMixin.generate`` (:638) with its program (``_generate_compiled``
:535): greedy, sampled or beam search.  The sampled draws are JAX's
threefry bits (``inference/threefry.py``): ``generate(do_sample=True,
seed=s)`` splits ``PRNGKey(s)`` into the first token's key and the
loop's, splits the loop's key once a step, and draws one categorical over
the whole ``[B, V]`` batch from each key, as the JAX ``generate()`` does.

``generate_program`` is the whole generation (cast, zero-filled caches,
prefill, first draw, ``max_new_tokens - 1`` decode steps, and for beams
the backtrace and the length-penalty pick).  On the card ``generate()``
replays it as one captured CUDA graph per (B, prompt length,
max_cache_len, config, parameter structure), the key of the reference's
compiled program (``inference/llm.py:GenerateGraph``); on the CPU it runs
eagerly.

The JAX scatters return new arrays (the engine donates the old ones);
here they write the cache IN PLACE with ``index_put_`` and return it, so
steady-state serving never holds a second copy of the pool.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import to_dtype
from ..ops.decode_attention import (cache_shape, decode_attention,
                                    decode_attention_paged,
                                    decode_attention_paged_multi,
                                    paged_arena_shape,
                                    paged_prefix_attention,
                                    paged_scale_shape)


@dataclass(frozen=True)
class GenerationConfig:
    """The static generation options: the fields of the reference's
    program key (``generate()`` and ``LLMPredictor`` read all of them; the
    serving engine's per-request planes override the sampling fields
    there).  Frozen, so hashable."""
    max_new_tokens: int = 32
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0                   # 0 = full softmax
    top_p: float = 1.0               # nucleus sampling; 1.0 = off
    num_beams: int = 1               # > 1 = beam search (greedy scoring)
    length_penalty: float = 0.0      # beam score /= len ** alpha
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    compute_dtype: str = "bfloat16"
    cache_dtype: Optional[str] = None  # default: compute_dtype


def init_kv_cache(num_layers, batch, max_cache_len, num_kv_heads, head_dim,
                  dtype, device) -> List[Tuple]:
    """Per-layer (k, v) dense slot caches of ``generate()``, zero-filled:
    packed ``[B, S, H_kv*D]`` when the head geometry allows, else
    ``[B, S, H_kv, D]`` (``cache_shape``)."""
    shape = cache_shape(batch, num_kv_heads, max_cache_len, head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(num_layers)]


def cache_scatter(cache, lens, new_kv):
    """Write one new [B, H_kv, D] entry at each sequence's slot
    ``lens[b]`` of a dense cache, in place (one row write per sequence).
    Returns the cache."""
    b = cache.shape[0]
    rows = torch.arange(b, device=cache.device)
    cache.index_put_((rows, lens.long()), new_kv.reshape(
        (b,) + tuple(cache.shape[2:])).to(cache.dtype))
    return cache


def cache_prefill_write(cache, kv_bshd):
    """Write prompt K/V planes ([B, S, H_kv, D], as the prefill attention
    produces them) into a dense cache from slot 0, in place.  Returns the
    cache."""
    b, s = kv_bshd.shape[:2]
    cache[:, :s] = kv_bshd.reshape((b, s) + tuple(cache.shape[2:])).to(
        cache.dtype)
    return cache


def cached_decode_attention(q, k_cache, v_cache, lens):
    """One-token GQA attention over the valid prefix of a dense cache:
    q [B, H_q, D]; lens [B] = index of the LAST valid slot.  The dense
    decode kernel on the card (``ops/decode_attention.py``)."""
    return decode_attention(q, k_cache, v_cache, lens)


def init_paged_kv_arena(num_layers, num_blocks, block_len, num_kv_heads,
                        head_dim, dtype, device) -> List[Tuple]:
    """Per-layer (k, v) paged block arenas: one
    ``[num_blocks + 1, block_len, ...]`` pool per layer
    (``paged_arena_shape``) shared by every slot through per-slot block
    tables.  The extra last row (index ``num_blocks``) is the TRASH
    block: writes from vacant/frozen rows and from pad positions of a
    prefill chunk land there.  Zero fill is required, not cosmetic:
    reads past a row's ``lens`` are masked to weight 0, which is exact
    only against finite data (0 * NaN = NaN).

    ``dtype=torch.int8`` selects the QUANTIZED cache: each layer yields
    ``(k_codes, v_codes, k_scales, v_scales)``, int8 code arenas plus
    zeroed f32 ``[num_blocks + 1, block_len, H_kv]`` scale arenas
    (``paged_scale_shape``, trash row included; ``quantize_kv_heads``)."""
    shape = paged_arena_shape(num_blocks + 1, num_kv_heads, block_len,
                              head_dim)
    if dtype == torch.int8:
        sshape = paged_scale_shape(num_blocks + 1, num_kv_heads, block_len)
        return [(torch.zeros(shape, dtype=torch.int8, device=device),
                 torch.zeros(shape, dtype=torch.int8, device=device),
                 torch.zeros(sshape, dtype=torch.float32, device=device),
                 torch.zeros(sshape, dtype=torch.float32, device=device))
                for _ in range(num_layers)]
    if not dtype.is_floating_point:
        raise ValueError(f"KV arena dtype {dtype}: a float dtype or int8 "
                         f"(the quantized cache)")
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(num_layers)]


def quantize_kv_heads(kv):
    """Per-entry per-kv-head absmax int8 quantization of K/V planes:
    ``kv`` [..., H_kv, D] -> ``(codes int8 [..., H_kv, D], scales f32
    [..., H_kv])`` with ``codes * scales[..., None] ~= kv``.  One scale
    per WRITTEN entry per kv head, so every append quantizes exactly
    what it writes and a value's dequantized form never changes after
    its write.  The absmax is floored at 1e-8, so an all-zero plane
    gets a tiny finite scale and codes 0."""
    f = kv.float()
    absmax = torch.clamp_min(torch.amax(f.abs(), dim=-1), 1e-8)
    # a true division by a tensor (CUDA divides by a Python scalar as a
    # product with its reciprocal, which is not the same float)
    scales = absmax / torch.full_like(absmax, 127.0)
    codes = torch.clamp(torch.round(f / scales[..., None]), -127, 127)
    return codes.to(torch.int8), scales


def _paged_decode_route(arena, tables, lens):
    """(blk, off) arena coordinates of one [B] decode append at slot
    ``lens[b]``: arena row ``tables[b, lens[b] // L]``, offset
    ``lens[b] % L``.  The block index is clamped to the table width, as
    the JAX gather clamps an out-of-range index."""
    block_len = arena.shape[1]
    lens = lens.long()
    col = torch.clamp(lens // block_len, max=tables.shape[1] - 1)
    rows = torch.arange(tables.shape[0], device=tables.device)
    return tables[rows, col].long(), lens % block_len


def paged_cache_scatter(arena, tables, lens, new_kv):
    """Write one new [B, H_kv, D] decode entry at each sequence's slot
    ``lens[b]`` through its block table, in place.  Vacant and frozen
    rows carry all-trash tables, so their writes land in the trash
    block.  Returns the arena."""
    blk, off = _paged_decode_route(arena, tables, lens)
    new_kv = new_kv.reshape((tables.shape[0],) + tuple(arena.shape[2:]))
    arena.index_put_((blk, off), new_kv.to(arena.dtype))
    return arena


def paged_cache_scatter_q(arena, scales, tables, lens, new_kv):
    """Quantize-on-append twin of ``paged_cache_scatter`` for the int8
    cache: the new [B, H_kv, D] entry is quantized per kv head
    (``quantize_kv_heads``) and its codes and scales are written in
    place through ONE route (``_paged_decode_route``), so the two planes
    cannot desynchronise.  Vacant rows all write the trash row at
    their frozen slot: with duplicate (blk, off) coordinates
    ``index_put_`` may take one writer's codes and another's scale, in
    the trash row only, and both are finite.  Returns
    ``(arena, scales)``."""
    codes, s = quantize_kv_heads(new_kv)
    blk, off = _paged_decode_route(arena, tables, lens)
    arena.index_put_((blk, off), codes.reshape(
        (tables.shape[0],) + tuple(arena.shape[2:])))
    scales.index_put_((blk, off), s)
    return arena, scales


def _paged_chunk_route(arena, tables, start: int, n_valid: int, c: int):
    """(blk, off) coordinates of a batch-1 chunk of ``c`` consecutive
    positions ``start .. start+c-1`` through ``tables`` ([1,
    max_blocks]); positions ``>= n_valid`` route to the trash row."""
    block_len = arena.shape[1]
    trash = arena.shape[0] - 1
    pos = start + torch.arange(c, device=tables.device)
    idx = torch.clamp(pos // block_len, max=tables.shape[1] - 1)
    blk = torch.where(pos < n_valid, tables[0, idx].long(),
                      torch.full_like(pos, trash))
    return blk, pos % block_len


def paged_chunk_scatter(arena, tables, start: int, n_valid: int, new_kv):
    """Write a batch-1 prefill chunk's K/V planes ([C, H_kv, D]) at
    global positions ``start .. start+C-1`` through the slot's block
    table, in place; positions ``>= n_valid`` (the pad tail of the last
    chunk) write to the trash row.  Returns the arena."""
    c = new_kv.shape[0]
    blk, off = _paged_chunk_route(arena, tables, start, n_valid, c)
    new_kv = new_kv.reshape((c,) + tuple(arena.shape[2:]))
    arena.index_put_((blk, off), new_kv.to(arena.dtype))
    return arena


def paged_chunk_scatter_q(arena, scales, tables, start: int, n_valid: int,
                          new_kv):
    """Quantize-on-append twin of ``paged_chunk_scatter``: the chunk's
    [C, H_kv, D] planes are quantized per position per kv head and both
    codes and scales are written in place through one
    ``_paged_chunk_route``,
    pad-tail positions (``>= n_valid``) trash-routed in both arenas.  The
    pad positions all land in the trash row, where ``index_put_`` may
    pair one writer's codes with another's scale; both are finite.
    Returns ``(arena, scales)``."""
    c = new_kv.shape[0]
    codes, s = quantize_kv_heads(new_kv)
    blk, off = _paged_chunk_route(arena, tables, start, n_valid, c)
    arena.index_put_((blk, off), codes.reshape((c,) + tuple(arena.shape[2:])))
    scales.index_put_((blk, off), s)
    return arena, scales


def _paged_verify_route(arena, tables, lens, n_valid, c: int):
    """(blk, off) arena coordinates of a verify forward's per-row spans
    ``lens[b] .. lens[b]+c-1`` through each row's table: the logical
    block index is clamped to the table width (``min(pos // L,
    max_blocks - 1)``) and columns ``>= n_valid[b]`` route to the trash
    row.  The one source of the verify routing math, shared by the code
    and scale scatters."""
    block_len = arena.shape[1]
    trash = arena.shape[0] - 1
    cols = torch.arange(c, dtype=torch.long, device=tables.device)
    pos = lens.long()[:, None] + cols[None, :]                 # [B, C]
    idx = torch.clamp(pos // block_len, max=tables.shape[1] - 1)
    blk = torch.where(cols[None, :] < n_valid.long()[:, None],
                      torch.gather(tables.long(), 1, idx),
                      torch.full_like(pos, trash))
    return blk, pos % block_len


def paged_verify_scatter(arena, tables, lens, n_valid, new_kv):
    """Write a verify forward's K/V planes ([B, C, H_kv, D]) at per-row
    global positions ``lens[b] .. lens[b]+C-1`` through each row's block
    table, in place.  Columns ``>= n_valid[b]`` (the draft-pad tail, and
    every column of a row not in spec mode this step) write to the trash
    row: a rejected draft's K/V is finite garbage inside its own row's
    blocks behind the ``lens`` mask, never another sequence's data.
    Returns the arena."""
    b, c = new_kv.shape[:2]
    blk, off = _paged_verify_route(arena, tables, lens, n_valid, c)
    arena.index_put_((blk, off), new_kv.reshape(
        (b, c) + tuple(arena.shape[2:])).to(arena.dtype))
    return arena


def paged_verify_scatter_q(arena, scales, tables, lens, n_valid, new_kv):
    """Quantize-on-append twin of ``paged_verify_scatter`` for the int8
    cache: the [B, C, H_kv, D] planes are quantized per position per kv
    head (``quantize_kv_heads``) and codes and scales are written in
    place through one ``_paged_verify_route``, so the rollback guarantee
    holds for both planes.  Trash-routed columns all land in the trash
    row, where ``index_put_`` may pair one writer's codes with another's
    scale; both are finite.  Returns ``(arena, scales)``."""
    b, c = new_kv.shape[:2]
    codes, s = quantize_kv_heads(new_kv)
    blk, off = _paged_verify_route(arena, tables, lens, n_valid, c)
    arena.index_put_((blk, off), codes.reshape(
        (b, c) + tuple(arena.shape[2:])))
    scales.index_put_((blk, off), s)
    return arena, scales


def attend_decode(q1, k1, v1, kv, lens):
    """One layer's decode-step cache write and attention, in each cache
    form: ``generate()``'s dense (k_cache, v_cache) pair, the paged
    triple, or the int8 cache's 5-tuple (quantize on append, dequantize
    in the read).  q1 [B, H_q, D] contiguous; k1, v1 [B, H_kv, D] the new
    token's K/V, written at slot ``lens[b]``.  Returns the attention
    output of the decode kernels (``ops/decode_attention.py``)."""
    if len(kv) == 2:
        k_cache, v_cache = kv
        cache_scatter(k_cache, lens, k1)
        cache_scatter(v_cache, lens, v1)
        return cached_decode_attention(q1, k_cache, v_cache, lens)
    if len(kv) == 5:
        k_arena, v_arena, k_s, v_s, tables = kv
        paged_cache_scatter_q(k_arena, k_s, tables, lens, k1)
        paged_cache_scatter_q(v_arena, v_s, tables, lens, v1)
        return decode_attention_paged(q1, k_arena, v_arena, tables, lens,
                                      kv_scales=(k_s, v_s))
    k_arena, v_arena, tables = kv
    paged_cache_scatter(k_arena, tables, lens, k1)
    paged_cache_scatter(v_arena, tables, lens, v1)
    return decode_attention_paged(q1, k_arena, v_arena, tables, lens)


def attend_chunk(q, k, v, kv, start: int, n_valid: int):
    """One layer's prefill-chunk cache write and attention for ONE
    sequence over the paged cache (triple or int8 5-tuple): q [1, C,
    H_q, D], k/v [1, C, H_kv, D] at global positions ``start ..
    start+C-1``, positions ``>= n_valid`` trash-routed; attention is
    causal over the written prefix."""
    start_t = torch.full((1,), start, dtype=torch.int32, device=q.device)
    if len(kv) == 5:
        k_arena, v_arena, k_s, v_s, tables = kv
        paged_chunk_scatter_q(k_arena, k_s, tables, start, n_valid, k[0])
        paged_chunk_scatter_q(v_arena, v_s, tables, start, n_valid, v[0])
        return paged_prefix_attention(q, k_arena, v_arena, tables, start_t,
                                      kv_scales=(k_s, v_s))
    k_arena, v_arena, tables = kv
    paged_chunk_scatter(k_arena, tables, start, n_valid, k[0])
    paged_chunk_scatter(v_arena, tables, start, n_valid, v[0])
    return paged_prefix_attention(q, k_arena, v_arena, tables, start_t)


def attend_verify(q, k, v, kv, lens, n_valid):
    """One layer's speculative-verify cache write and attention over the
    paged cache (triple or int8 5-tuple): q [B, C, H_q, D] contiguous,
    k/v [B, C, H_kv, D] at per-row positions ``lens[b] .. lens[b]+C-1``,
    columns ``>= n_valid[b]`` trash-routed; attention causal per query
    offset (the K-wide verify kernel)."""
    if len(kv) == 5:
        k_arena, v_arena, k_s, v_s, tables = kv
        paged_verify_scatter_q(k_arena, k_s, tables, lens, n_valid, k)
        paged_verify_scatter_q(v_arena, v_s, tables, lens, n_valid, v)
        return decode_attention_paged_multi(q, k_arena, v_arena, tables,
                                            lens, kv_scales=(k_s, v_s))
    k_arena, v_arena, tables = kv
    paged_verify_scatter(k_arena, tables, lens, n_valid, k)
    paged_verify_scatter(v_arena, tables, lens, n_valid, v)
    return decode_attention_paged_multi(q, k_arena, v_arena, tables, lens)


def filter_top_k_top_p(lg, top_k, top_p):
    """Per-row filtering of temperature-scaled logits ``lg [..., V]``:
    top-k (``top_k[...] <= 0`` keeps everything), then nucleus top-p over
    the top-k-filtered distribution (``top_p[...] = 1`` keeps everything).
    One descending sort serves both: each filter keeps a prefix of sorted
    order, so the cut is a per-row threshold logit and ties at the
    threshold are kept.  Dropped logits become ``-inf``."""
    v = lg.shape[-1]
    srt = torch.sort(lg, dim=-1, descending=True).values
    j = torch.arange(v, device=lg.device)
    tk = top_k[..., None]
    keep_k = (tk <= 0) | (j < tk)
    probs = torch.softmax(torch.where(keep_k, srt, float("-inf")), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # the smallest prefix with cumulative mass >= p; position 0 always kept
    keep = keep_k & ((cum - probs) < top_p[..., None])
    nkeep = torch.clamp_min(keep.sum(-1), 1)
    kth = torch.gather(srt, -1, (nkeep - 1)[..., None])
    return torch.where(lg < kth, float("-inf"), lg)


def sample_token(logits, key, cfg: GenerationConfig):
    """Greedy argmax, or the temperature/top-k/top-p categorical of the
    whole ``[B, V]`` batch from one key (``key`` [2] int64 words): the
    static config of ``generate()``.  Pure top-k takes the k-th largest
    logit (``torch.topk``, as ``lax.top_k``) as its threshold; any top-p
    goes through ``filter_top_k_top_p``."""
    from ..inference import threefry
    if not cfg.do_sample:
        return torch.argmax(logits.float(), dim=-1).to(torch.int32)
    lg = logits.float()
    # a division by a tensor keeps the card's bits equal to the CPU's
    lg = lg / torch.full_like(lg, max(cfg.temperature, 1e-6))
    if cfg.top_k and cfg.top_k > 0 and cfg.top_p >= 1.0:
        kth = torch.topk(lg, cfg.top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, float("-inf"), lg)
    elif (cfg.top_k and cfg.top_k > 0) or cfg.top_p < 1.0:
        rows = lg.shape[:-1]
        lg = filter_top_k_top_p(
            lg, torch.full(rows, int(cfg.top_k or 0), dtype=torch.int64,
                           device=lg.device),
            torch.full(rows, float(cfg.top_p), dtype=torch.float32,
                       device=lg.device))
    return threefry.categorical(key, lg).to(torch.int32)


def decode_scan_body(model, cfg: GenerationConfig):
    """The per-token body of ``generate()``'s decode loop: decode_step ->
    sample -> EOS mask -> lens advance.  carry = (tok, lens, kvs, key,
    done); a sampled config splits the carried key once a step (the
    first half draws, the second is carried).  Returns (carry', emitted
    tokens [B] int32).  Done rows emit ``pad_token_id`` (when an EOS is
    configured) and hold their ``lens``."""
    from ..inference import threefry

    def body(carry):
        tok, lens, kvs, key, done = carry
        logits, kvs = model.decode_step(tok, lens, kvs)
        if cfg.do_sample:
            key_t, key = threefry.split(key)
        else:
            key_t = key
        nxt = sample_token(logits, key_t, cfg)
        if cfg.eos_token_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, cfg.pad_token_id),
                              nxt)
            done_n = done | (nxt == cfg.eos_token_id)
        else:
            done_n = done
        lens_n = torch.where(done, lens, lens + 1)
        return (nxt, lens_n, kvs, key, done_n), nxt
    return body


def top_k_desc(x, k: int):
    """``jax.lax.top_k`` along the last axis: the ``k`` largest values in
    descending order and their indices, ties broken by the lower index.
    ``torch.topk`` promises no order among equal values, so this is a
    stable descending sort cut to ``k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _repeat_rows(t, k: int):
    """``jnp.repeat(t, k, axis=0)``: each row ``k`` times in a row, as a
    new contiguous tensor (the caches are then written in place)."""
    rest = tuple(t.shape[1:])
    return t[:, None].expand((t.shape[0], k) + rest).contiguous().reshape(
        (t.shape[0] * k,) + rest)


def beam_scan_body(model, cfg: GenerationConfig, b: int, k: int):
    """The per-token beam-search body over a ``[B*K]``-row dense cache:
    decode_step -> log-softmax -> (finished beams offer only EOS at zero
    cost) -> the K best of the ``K * V`` candidates of each batch row ->
    every cache row gathered from its parent row and written back in
    place (the reference's ``kc[rows]``) -> EOS and length bookkeeping.
    carry = (tok [B*K], lens [B*K], kvs, log_probs [B, K], beam_len [B,
    K], done [B, K]); returns (carry', (token [B, K], parent [B, K] int32,
    log_probs [B, K], beam_len [B, K])): the per-step scores let a
    block-serving host truncate the tree mid-block and still score at
    exactly ``max_new_tokens`` (``LLMPredictor``)."""
    def body(carry):
        tok, lens, kvs, lp, blen, done = carry
        logits, kvs = model.decode_step(tok, lens, kvs)        # [B*K, V]
        vocab = logits.shape[-1]
        step_lp = torch.log_softmax(logits.float(), dim=-1).reshape(
            b, k, vocab)
        if cfg.eos_token_id is not None:
            # built from an index compare: a scalar write would copy a
            # host tensor, which a CUDA graph capture refuses
            ids = torch.arange(vocab, device=logits.device)
            only_eos = torch.full((vocab,), -1e9, dtype=torch.float32,
                                  device=logits.device).masked_fill(
                                      ids == cfg.eos_token_id, 0.0)
            step_lp = torch.where(done[:, :, None], only_eos, step_lp)
        flat = (lp[:, :, None] + step_lp).reshape(b, k * vocab)
        top_lp, top_idx = top_k_desc(flat, k)                    # [B, K]
        parent = torch.div(top_idx, vocab, rounding_mode="floor")
        tok_idx = (top_idx % vocab).to(torch.int32)
        rows = (torch.arange(b, device=parent.device)[:, None] * k
                + parent).reshape(-1)
        for kc, vc in kvs:
            kc.copy_(kc.index_select(0, rows))
            vc.copy_(vc.index_select(0, rows))
        lens_g = lens.index_select(0, rows)
        done_g = torch.gather(done, 1, parent)
        blen_g = torch.gather(blen, 1, parent)
        if cfg.eos_token_id is not None:
            emit = torch.where(done_g, torch.full_like(tok_idx,
                                                       cfg.pad_token_id),
                               tok_idx)
            done_n = done_g | (tok_idx == cfg.eos_token_id)
        else:
            emit = tok_idx
            done_n = done_g
        lens_n = torch.where(done_g.reshape(-1), lens_g, lens_g + 1)
        blen_n = blen_g + (~done_g).to(torch.int32)
        return ((emit.reshape(-1), lens_n, kvs, top_lp, blen_n, done_n),
                (emit, parent.to(torch.int32), top_lp, blen_n))
    return body


def beam_expand(logits, lens, cfg: GenerationConfig):
    """The beam prefill's tail: the K best first tokens of each batch row
    (log-softmax, ``top_k_desc``) and the lengths repeated to ``[B*K]``
    rows (the caller repeats the caches the same way).  Returns (tok0 [B,
    K] int32, lens [B*K], log probs [B, K], beam lengths [B, K] (ones),
    done [B, K])."""
    b, k = logits.shape[0], cfg.num_beams
    lp0 = torch.log_softmax(logits.float(), dim=-1)
    top_lp, tok0 = top_k_desc(lp0, k)
    tok0 = tok0.to(torch.int32)
    done0 = (torch.zeros((b, k), dtype=torch.bool, device=logits.device)
             if cfg.eos_token_id is None else tok0 == cfg.eos_token_id)
    blen0 = torch.ones((b, k), dtype=torch.int32, device=logits.device)
    return tok0, _repeat_rows(lens, k), top_lp, blen0, done0


def beam_pick(seqs, lp, blen, length_penalty: float):
    """The best beam of each batch row under the length penalty
    (``score = lp / len ** alpha``, first index on ties) from the
    backtraced ``seqs`` [T, B, K]: returns [B, T] int32."""
    if length_penalty:
        score = lp / (blen.float() ** float(length_penalty))
    else:
        score = lp
    best = torch.argmax(score, dim=-1)                           # [B]
    out = seqs.permute(1, 0, 2)                                  # [B, T, K]
    idx = best[:, None, None].expand(out.shape[0], out.shape[1], 1)
    return torch.gather(out, 2, idx)[..., 0].to(torch.int32)


@contextmanager
def _params_as(model, dtype: torch.dtype):
    """Run with the model's float parameters in ``dtype``: the JAX
    package's once-per-call cast (``swap_call``).  Parameters already in
    ``dtype`` are used as they are, so a model stored in the compute dtype
    is never copied (at 8B a float32 copy would take 32 GB); the others
    get a cast copy for the call and are restored after it.  Inside a
    CUDA graph capture the cast is captured too, so every replay casts
    the live parameters again, as the reference casts inside its
    program."""
    saved = []
    try:
        for p in model.parameters():
            if p.is_floating_point() and p.dtype != dtype:
                saved.append((p, p.data))
                p.data = p.data.to(dtype)
        yield
    finally:
        for p, data in saved:
            p.data = data


def generate_program(model, cfg: GenerationConfig, ids, lens, key,
                     max_cache_len: int):
    """The whole of ``generate()`` as one program: the parameters cast to
    ``cfg.compute_dtype`` where they differ, zero-filled dense caches of
    ``max_cache_len`` slots, the prefill, the first draw and
    ``cfg.max_new_tokens - 1`` decode steps; for ``cfg.num_beams > 1``
    the top-k expansion to ``[B*K]`` rows, the beam steps, the backtrace
    (``gather_tree``) and the best beam under the length penalty.  ids
    [B, S] int32, lens [B] int32, key [2] int64 threefry words.  No host
    read, so it can be captured.  Returns [B, max_new_tokens] int32."""
    from ..inference import threefry
    from ..nn.functional import gather_tree
    n_layers, hkv, d = model.kv_cache_spec()
    cdt = to_dtype(cfg.compute_dtype)
    kdt = to_dtype(cfg.cache_dtype) if cfg.cache_dtype is not None else cdt
    b = ids.shape[0]
    steps = int(cfg.max_new_tokens) - 1
    with _params_as(model, cdt):
        kvs = init_kv_cache(n_layers, b, int(max_cache_len), hkv, d, kdt,
                            ids.device)
        logits, kvs = model.prefill(ids, lens, kvs)
        if cfg.num_beams > 1:
            k = cfg.num_beams
            tok0, lens_bk, lp, blen, done = beam_expand(logits, lens, cfg)
            kvs = [(_repeat_rows(kc, k), _repeat_rows(vc, k))
                   for kc, vc in kvs]
            toks = [tok0]
            parents = [torch.arange(k, dtype=torch.int32,
                                    device=ids.device).expand(b, k)]
            carry = (tok0.reshape(-1), lens_bk, kvs, lp, blen, done)
            body = beam_scan_body(model, cfg, b, k)
            for _ in range(steps):
                carry, (emit, parent, _lp, _blen) = body(carry)
                toks.append(emit)
                parents.append(parent)
            seqs = gather_tree(torch.stack(toks), torch.stack(parents))
            return beam_pick(seqs, carry[3], carry[4], cfg.length_penalty)
        key0, keyr = (threefry.split(key) if cfg.do_sample else (key, key))
        tok = sample_token(logits, key0, cfg)
        done = (torch.zeros((b,), dtype=torch.bool, device=ids.device)
                if cfg.eos_token_id is None else tok == cfg.eos_token_id)
        toks = [tok]
        carry = (tok, lens, kvs, keyr, done)
        body = decode_scan_body(model, cfg)
        for _ in range(steps):
            carry, nxt = body(carry)
            toks.append(nxt)
    return torch.stack(toks, dim=1)


def parameter_structure(model):
    """The identity, address and dtype of every parameter and buffer: the
    last part of a ``generate()`` program's key.  A rebinding (``p.data =
    ...``, a ``.to()`` that casts or moves) changes it, so a captured
    graph never reads freed or stale weights; an in-place update
    (``load_state_dict``, an optimizer step) keeps it."""
    return tuple((id(t), t.data_ptr(), t.dtype)
                 for t in list(model.parameters()) + list(model.buffers()))


class GenerationMixin:
    """Adds ``generate`` to a causal LM that implements
    ``prefill(ids, lens, kvs) -> (last logits [B, V], kvs)`` over dense
    caches, ``decode_step(tokens [B], lens, kvs)`` (the dense ``(k, v)``
    form among others) and ``kv_cache_spec()``.  On the card each call
    replays one captured CUDA graph of ``generate_program`` per (B, S,
    max_cache_len, ``GenerationConfig``, ``parameter_structure``, and
    for a converted model ``FLAGS_use_int8_matmul_kernel``), as the
    reference compiles one program per key; on the CPU the program runs
    eagerly.  Buffers are
    never cast: a converted layer's int8 codes stay int8 and its scales
    float32."""

    def _generate_graph(self, b: int, s: int, max_cache_len: int,
                        cfg: GenerationConfig):
        """The captured program of this key, captured on first use.
        Entries of another parameter structure can never hit again and
        pin their graphs' memory: they are evicted, as the reference
        evicts its stale executables."""
        from ..inference.llm import GenerateGraph
        from ..core.flags import flag
        from ..nn.quant.quant_layers import holds_int8_layers
        cache = self.__dict__.setdefault("_generate_graphs", {})
        struct = parameter_structure(self)
        # a graph records one route of the converted int8 layers
        # (QuantizedLinearInfer): the flag that picks it is in the key
        # of a converted model
        route = (bool(flag("use_int8_matmul_kernel"))
                 if holds_int8_layers(self) else None)
        keyt = (b, s, max_cache_len, cfg, struct, route)
        hit = cache.get(keyt)
        if hit is not None:
            return hit
        for stale in [k for k in cache if k[4] != struct]:
            del cache[stale]
        graph = cache[keyt] = GenerateGraph(self, cfg, b, s, max_cache_len)
        return graph

    @torch.no_grad()
    def generate(self, input_ids, seq_lens=None, max_new_tokens=32,
                 do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                 num_beams=1, length_penalty=0.0, eos_token_id=None,
                 pad_token_id=0, max_cache_len=None,
                 compute_dtype="bfloat16", cache_dtype=None, seed=0):
        """Generate ``max_new_tokens`` tokens after the (right-padded)
        prompt ``input_ids`` [B, S]; ``seq_lens`` [B] are the true prompt
        lengths (default: S).  Greedy; with ``do_sample=True`` a
        temperature/top-k/top-p draw from the threefry stream of
        ``seed``; with ``num_beams > 1`` beam search (greedy scoring,
        ``length_penalty`` at the pick).  Returns an int32 tensor [B,
        max_new_tokens] on the model's device (``pad_token_id`` after
        EOS)."""
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if num_beams < 1:
            raise ValueError(f"num_beams must be >= 1, got {num_beams}")
        if num_beams > 1 and do_sample:
            raise ValueError(
                "num_beams > 1 is greedy beam search; do_sample=True is "
                "not supported together with beams")
        dev = next(self.parameters()).device
        ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(
            input_ids, torch.Tensor) else input_ids).to(dev, torch.int32)
        b, s = ids.shape
        if seq_lens is None:
            lens = torch.full((b,), s, dtype=torch.int32, device=dev)
        else:
            lens_np = np.asarray(seq_lens.cpu() if isinstance(
                seq_lens, torch.Tensor) else seq_lens)
            if lens_np.shape != (b,) or (lens_np < 1).any() or \
                    (lens_np > s).any():
                raise ValueError(
                    f"seq_lens must be [{b}] ints in [1, {s}], got "
                    f"{lens_np.tolist()}")
            lens = torch.as_tensor(lens_np.astype(np.int32), device=dev)
        if max_cache_len is None:
            max_cache_len = s + max_new_tokens
        if max_cache_len < s + max_new_tokens:
            raise ValueError(
                f"max_cache_len ({max_cache_len}) < prompt + new tokens "
                f"({s} + {max_new_tokens})")
        from ..inference import threefry
        cdt = to_dtype(compute_dtype)
        kdt = to_dtype(cache_dtype) if cache_dtype is not None else cdt
        if kdt != cdt:
            # the JAX gate sends a mixed (q, cache) dtype pair to its XLA
            # path; the dense kernel takes one dtype
            raise NotImplementedError(
                f"generate(cache_dtype={cache_dtype!r}) other than "
                f"compute_dtype ({compute_dtype!r}) is not ported yet "
                f"(ROADMAP.md, Queue 1: LLMPredictor and the dense "
                f"generate programs)")
        cfg = GenerationConfig(
            max_new_tokens=int(max_new_tokens), do_sample=bool(do_sample),
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), num_beams=int(num_beams),
            length_penalty=float(length_penalty),
            eos_token_id=eos_token_id, pad_token_id=int(pad_token_id),
            compute_dtype=str(compute_dtype),
            cache_dtype=None if cache_dtype is None else str(cache_dtype))
        from ..inference.llm import graphs_on
        key = threefry.as_key(threefry.prng_key(seed), dev)
        modes = [(m, m.training) for m in self.modules()]
        try:
            self.eval()
            if graphs_on(dev):
                graph = self._generate_graph(b, s, int(max_cache_len), cfg)
                return graph(ids, lens, key)
            return generate_program(self, cfg, ids, lens, key,
                                    int(max_cache_len))
        finally:
            for m, mode in modes:
                m.training = mode
