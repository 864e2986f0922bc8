"""Generation pieces of the serving path and of greedy ``generate()``:
port of ``paddle_tpu/models/generation.py`` — ``GenerationConfig`` (:56,
the fields the engine reads), the dense cache of ``generate()``
(``init_kv_cache`` :76, ``cache_scatter`` :96, ``cache_prefill_write``
:314, ``cached_decode_attention`` :325), ``init_paged_kv_arena`` (:113,
float and int8 caches), ``quantize_kv_heads`` (:152), the decode / chunk
/ verify scatters with their trash routing and their quantize-on-append
``_q`` twins (:174-311), and the greedy half of ``decode_scan_body``
(:437) and ``GenerationMixin.generate`` (:638).

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
                                    paged_arena_shape, paged_scale_shape)


@dataclass(frozen=True)
class GenerationConfig:
    """The generation options the greedy serving path reads."""
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


def decode_scan_body(model, cfg: GenerationConfig):
    """The greedy per-token body of ``generate()``'s decode loop:
    decode_step -> argmax -> EOS mask -> lens advance.  carry = (tok,
    lens, kvs, done); returns (carry', emitted tokens [B] int32).  Done
    rows emit ``pad_token_id`` (when an EOS is configured) and hold
    their ``lens``."""
    def body(carry):
        tok, lens, kvs, done = carry
        logits, kvs = model.decode_step(tok, lens, kvs)
        nxt = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        if cfg.eos_token_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, cfg.pad_token_id),
                              nxt)
            done_n = done | (nxt == cfg.eos_token_id)
        else:
            done_n = done
        lens_n = torch.where(done, lens, lens + 1)
        return (nxt, lens_n, kvs, done_n), nxt
    return body


@contextmanager
def _params_as(model, dtype: torch.dtype):
    """Run with the model's float parameters in ``dtype``: the JAX
    package's once-per-call cast (``swap_call``).  Parameters already in
    ``dtype`` are used as they are, so a model stored in the compute dtype
    is never copied (at 8B a float32 copy would take 32 GB); the others
    get a cast copy for the call and are restored after it."""
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


class GenerationMixin:
    """Adds greedy ``generate`` to a causal LM that implements
    ``prefill(ids, lens, kvs) -> (last logits [B, V], kvs)`` over dense
    caches, ``decode_step(tokens [B], lens, kvs)`` (the dense ``(k, v)``
    form among others) and ``kv_cache_spec()``.  The JAX package compiles
    the program once per shape; here it runs eagerly: cast the
    parameters (only where the dtype differs), prefill, then
    ``max_new_tokens - 1`` decode steps."""

    @torch.no_grad()
    def generate(self, input_ids, seq_lens=None, max_new_tokens=32,
                 do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                 num_beams=1, length_penalty=0.0, eos_token_id=None,
                 pad_token_id=0, max_cache_len=None,
                 compute_dtype="bfloat16", cache_dtype=None, seed=0):
        """Generate ``max_new_tokens`` greedy tokens after the
        (right-padded) prompt ``input_ids`` [B, S]; ``seq_lens`` [B] are
        the true prompt lengths (default: S).  Returns an int32 tensor
        [B, max_new_tokens] on the model's device (``pad_token_id`` after
        EOS).  Sampling and beam search are not ported."""
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if num_beams < 1:
            raise ValueError(f"num_beams must be >= 1, got {num_beams}")
        if num_beams > 1 and do_sample:
            raise ValueError(
                "num_beams > 1 is greedy beam search; do_sample=True is "
                "not supported together with beams")
        if do_sample:
            raise NotImplementedError(
                "generate(do_sample=True) is not ported to paddle_tpu_torch "
                "yet (ROADMAP.md, Queue 1: sampling and speculation)")
        if num_beams > 1:
            raise NotImplementedError(
                f"generate(num_beams={num_beams}) (beam search) is not "
                f"ported to paddle_tpu_torch yet (ROADMAP.md, Queue 1: "
                f"LLMPredictor and the dense generate programs)")
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
        cfg = GenerationConfig(eos_token_id=eos_token_id,
                               pad_token_id=int(pad_token_id),
                               compute_dtype=str(compute_dtype))
        n_layers, hkv, d = self.kv_cache_spec()
        modes = [(m, m.training) for m in self.modules()]
        try:
            self.eval()
            with _params_as(self, cdt):
                kvs = init_kv_cache(n_layers, b, int(max_cache_len), hkv, d,
                                    kdt, dev)
                logits, kvs = self.prefill(ids, lens, kvs)
                tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
                done = (torch.zeros((b,), dtype=torch.bool, device=dev)
                        if eos_token_id is None else tok == eos_token_id)
                toks = [tok]
                carry = (tok, lens, kvs, done)
                body = decode_scan_body(self, cfg)
                for _ in range(int(max_new_tokens) - 1):
                    carry, nxt = body(carry)
                    toks.append(nxt)
        finally:
            for m, mode in modes:
                m.training = mode
        return torch.stack(toks, dim=1)
