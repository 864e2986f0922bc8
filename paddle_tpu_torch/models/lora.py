"""LoRA math for batched multi-adapter serving: the gathered (BGMV-style)
low-rank delta and the adapter context of the projection sites.  A copy
of ``paddle_tpu/models/lora.py`` on torch tensors.

A LoRA adapter replaces a projection ``y = x W`` with ``y = x W + x A B``
(``A: [d_in, r]``, ``B: [r, d_out]``, the ``alpha / r`` scaling folded
into ``B`` at registration).  Serving K fine-tuned variants of one base
model in one continuous batch needs that delta PER ROW: per-row adapter
ids index stacked ``[slots+1, L, d_in, r]`` / ``[slots+1, L, r, d_out]``
arenas, and two small batched products contract the gathered stacks:

    h     = einsum('b...i,bir->b...r', x, A_stack[ids][:, layer])
    delta = einsum('b...r,bro->b...o', h, B_stack[ids][:, layer])

The arenas' LAST row is the NULL adapter (all zeros, never written):
base-model rows gather zeros and their delta is an exact ``+ 0.0``.
Rank is zero-padded to the arena width, exact for the same reason.

**How the delta reaches the model.**  The serving programs call the
model's unchanged ``decode_step`` / ``prefill_chunk`` / ``verify_step``
inside :func:`lora_context` over the stacks :func:`gather_lora` gathered
from the dispatch's ``lora`` planes; the attention projections call
:func:`maybe_lora` (a no-op outside any context) to add their row's
delta.  The context is plain Python state: a captured CUDA graph records
the gathers and products while it is active, so the gathers must run
inside the captured function over static ``ids`` and the store's arenas,
and every replay then re-gathers from the live arenas.

The adapter weights keep the reference's numpy layout (``A [L, d_in,
r]``, ``B [L, r, d_out]``), so both packages read the same arrays; a
torch ``Linear.weight`` is ``[out, in]``, so :func:`merged_adapter` adds
``(A @ B).T``.  It is the parity oracle's tool: it folds the adapter into
the model's projection weights in place and restores them with
``copy_`` on exit, never by rebinding a parameter (a rebinding would
make the captured ``generate()`` graphs of the model refuse to replay).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# the attention projections LoRA targets (the classic q/k/v/o set);
# adapter weight dicts and the AdapterStore arenas are keyed by these
LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj")


def attn_lora_dims(config) -> Dict[str, Tuple[int, int]]:
    """``target -> (d_in, d_out)`` for a GQA attention stack described by
    ``config`` (``hidden_size``, ``num_key_value_heads``, ``head_dim``):
    the shape contract between adapters, the AdapterStore arenas and the
    model's projection hooks."""
    h = int(config.hidden_size)
    kv_out = int(config.num_key_value_heads) * int(config.head_dim)
    return {"q_proj": (h, h), "k_proj": (h, kv_out),
            "v_proj": (h, kv_out), "o_proj": (h, h)}


# the active context: {target: (Ag, Bg)} with Ag [B, L, d_in, r] / Bg
# [B, L, r, d_out], already GATHERED per dispatch row.  Module state, set
# only around a serving program's model call
_ACTIVE: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None


def gather_lora(planes) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Gather per-row adapter stacks from a dispatch's ``lora`` planes:
    ``planes = {"ids": [B] int32, "a": {target: arena}, "b": {target:
    arena}}`` with arenas ``[slots+1, L, d_in, r]`` / ``[slots+1, L, r,
    d_out]``.  One gather per target and plane per dispatch (hoisted out
    of the decode loop: the ids are loop-invariant), sized ``B * L * d *
    r``."""
    ids = planes["ids"]
    return {t: (planes["a"][t].index_select(0, ids),
                planes["b"][t].index_select(0, ids))
            for t in planes["a"]}


@contextmanager
def lora_context(gathered: Optional[Dict[str, Tuple]]):
    """Activate a gathered adapter context for the duration of a model
    call (``None`` = explicit no-op, so callers can wrap
    unconditionally)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = gathered
    try:
        yield
    finally:
        _ACTIVE = prev


def lora_delta(target: str, layer_idx: int,
               x: torch.Tensor) -> Optional[torch.Tensor]:
    """The gathered low-rank delta for ``target`` at ``layer_idx``: ``x``
    is the projection INPUT ([B, S, d_in]), the result [B, S, d_out] in
    ``x.dtype``; None when no context is active."""
    if _ACTIVE is None or target not in _ACTIVE:
        return None
    a_g, b_g = _ACTIVE[target]
    a_l = a_g[:, layer_idx]            # [B, d_in, r]
    b_l = b_g[:, layer_idx]            # [B, r, d_out]
    h = torch.einsum("b...i,bir->b...r", x, a_l)
    return torch.einsum("b...r,bro->b...o", h, b_l).to(x.dtype)


def maybe_lora(out: torch.Tensor, x: torch.Tensor, target: str,
               layer_idx: int) -> torch.Tensor:
    """The hook the projection sites call: ``out`` plus ``x``'s per-row
    adapter delta when a context is active, ``out`` unchanged
    otherwise."""
    d = lora_delta(target, layer_idx, x)
    return out if d is None else out + d


def merged_weight_delta(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``A @ B`` per layer: the dense ``[d_in, d_out]`` weight delta of one
    (already scaled) adapter layer, in the reference's ``[in, out]``
    layout."""
    return np.asarray(a, np.float32) @ np.asarray(b, np.float32)


@contextmanager
def merged_adapter(model, adapter):
    """Fold ``adapter`` into ``model``'s attention projection weights in
    place for the duration of the block, restoring the originals on exit:
    the per-request merged-weights oracle the batched gathered path is
    held against.  ``model`` exposes ``attn_projections()`` (a per-layer
    ``{target: Linear}`` list); ``adapter.weights[target] = (A [L, d_in,
    r], B [L, r, d_out])`` with the scaling folded into B.  The delta
    ``(A @ B).T`` (``merged_weight_delta`` in float32, computed on the
    weight's device) is added in place and the saved weights come back by
    ``copy_``: the parameters keep their storage."""
    saved = []
    try:
        with torch.no_grad():
            for li, layer_projs in enumerate(model.attn_projections()):
                for t, lin in layer_projs.items():
                    if t not in adapter.weights:
                        continue
                    a, b = (torch.from_numpy(np.asarray(x[li], np.float32))
                            .to(lin.weight.device)
                            for x in adapter.weights[t])
                    w = lin.weight
                    saved.append((w, w.detach().clone()))
                    w.add_((a @ b).t().to(w.dtype))
        yield model
    finally:
        with torch.no_grad():
            for w, orig in saved:
                w.copy_(orig)
