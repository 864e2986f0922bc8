"""The serving engine's two device programs as plain torch functions:
port of ``build_chunk_prefill`` (:516) and ``_build_paged_decode_block``
(:350) of ``paddle_tpu/inference/llm.py`` with ``_pack_paged_kvs`` /
``_flatten_paged_kvs`` (:331-347), float KV cache and greedy only.

They take and return what the JAX programs take and return, minus the
parameter list (the model holds its weights) and the sampling planes
(greedy).  The arenas are updated IN PLACE — the torch counterpart of the
JAX programs' donated arena arguments — and handed back for symmetry.
The decode block is a Python loop of ``steps`` decode steps; capturing
it as a CUDA graph is later work.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..models.generation import GenerationConfig
from .sampling import decode_scan_step, sample_rows


def _pack_paged_kvs(flat_arenas: Sequence[torch.Tensor], tables):
    """Per-layer (k, v, tables) triples from the flat arena list."""
    return [(flat_arenas[i], flat_arenas[i + 1], tables)
            for i in range(0, len(flat_arenas), 2)]


def _flatten_paged_kvs(kvs) -> List[torch.Tensor]:
    """Inverse of ``_pack_paged_kvs`` minus the tables."""
    flat = []
    for entry in kvs:
        flat += list(entry[:-1])
    return flat


@torch.no_grad()
def chunk_prefill(model, ids, start: int, n_valid: int, tables,
                  flat_arenas: Sequence[torch.Tensor]):
    """ONE prompt chunk of ONE sequence: ids [1, C] at global positions
    ``start .. start+C-1``, K/V written through ``tables`` ([1,
    max_blocks]); ``n_valid`` is the prompt's true length.  Returns
    ``(tok [1] int32, *flat_arenas)``: the greedy token at prompt
    position ``n_valid - 1``, meaningful only on the chunk that covers
    it."""
    logits, kvs = model.prefill_chunk(ids, start, n_valid,
                                      _pack_paged_kvs(flat_arenas, tables))
    return (sample_rows(logits),) + tuple(_flatten_paged_kvs(kvs))


@torch.no_grad()
def paged_decode_block(model, cfg: GenerationConfig, steps: int, tok, lens,
                       done, budget, tables,
                       flat_arenas: Sequence[torch.Tensor]):
    """``steps`` greedy decode steps over every slot row.  tok/lens/
    budget [B] int32, done [B] bool, tables [B, max_blocks] int32.
    Returns ``(toks [B, steps], tok', lens', done', budget',
    *flat_arenas)``."""
    carry = (tok, lens, _pack_paged_kvs(flat_arenas, tables), done, budget)
    toks = []
    for _ in range(int(steps)):
        carry, nxt = decode_scan_step(model, cfg, carry)
        toks.append(nxt)
    tok_f, lens_f, kvs_f, done_f, budget_f = carry
    return ((torch.stack(toks, dim=1), tok_f, lens_f, done_f, budget_f)
            + tuple(_flatten_paged_kvs(kvs_f)))
