"""Paged-KV generation pieces of the serving path: port of
``paddle_tpu/models/generation.py`` — ``GenerationConfig`` (:56, the
fields the engine reads), ``init_paged_kv_arena`` (:113, float and int8
caches), ``quantize_kv_heads`` (:152), and the decode / chunk scatters
with their trash routing and their quantize-on-append ``_q`` twins
(:174-259).

The JAX scatters return new arrays (the engine donates the old ones);
here they write the arena IN PLACE with ``index_put_`` and return it, so
steady-state serving never holds a second copy of the pool.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..ops.decode_attention import paged_arena_shape, paged_scale_shape


@dataclass(frozen=True)
class GenerationConfig:
    """The generation options the greedy serving path reads."""
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    compute_dtype: str = "bfloat16"
    cache_dtype: Optional[str] = None  # default: compute_dtype


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
