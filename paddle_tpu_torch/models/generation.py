"""Paged-KV generation pieces of the serving path: port of
``paddle_tpu/models/generation.py`` — ``GenerationConfig`` (:56, the
fields the engine reads), ``init_paged_kv_arena`` (:113, float dtypes),
and the decode / chunk scatters with their trash routing (:174-201,
:217-244).

The JAX scatters return new arrays (the engine donates the old ones);
here they write the arena IN PLACE with ``index_put_`` and return it, so
steady-state serving never holds a second copy of the pool.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..ops.decode_attention import paged_arena_shape


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
    only against finite data (0 * NaN = NaN)."""
    if not dtype.is_floating_point:
        raise NotImplementedError(
            f"KV arena dtype {dtype}: only float caches are ported yet "
            f"(ROADMAP.md, Queue 1: int8 KV cache)")
    shape = paged_arena_shape(num_blocks + 1, num_kv_heads, block_len,
                              head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(num_layers)]


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
