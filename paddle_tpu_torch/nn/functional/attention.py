"""The rest of ``paddle_tpu/nn/functional/attention.py``: varlen and
CSR-sparse attention, and ``sdp_kernel``.

All three are XLA math in the JAX package (no Pallas kernel), so they
are plain torch here on every device (each casts its inputs under the
AMP rule by the reference's op name):

- ``flash_attn_unpadded`` (:113): packed ``[total, H, D]`` sequences are
  gathered into ``[B, max_len, H, D]`` (a row past a sequence's length
  repeats its last row and is zeroed; a length-0 sequence's index -1
  wraps, as ``jnp.take``'s does), keys past each length are masked by
  an additive -1e30, ``_xla_attention`` runs with ``scale`` and
  ``causal`` (its offset is ``max_seqlen_k - max_seqlen_q`` for every
  sequence, not each sequence's own), and the valid rows are added back
  into ``[total_q, H, D]``.
- ``sparse_attention`` (:174): the CSR pattern is scattered into a dense
  boolean mask and the attention runs dense and masked, softmax in
  float32; the masks' 0 means masked, and a fully masked row gives 0.
- ``sdp_kernel`` (:160): a context that selects nothing, as in the
  reference.
"""

from __future__ import annotations

import math

import torch

from . import _attention_math
from ...amp.auto_cast import cast as _amp_cast
from ...ops.flash_attention import NEG_INF

__all__ = ["flash_attn_unpadded", "sparse_attention", "sdp_kernel"]


def _gather_seqs(packed, cu, max_len):
    """``[total, H, D]`` -> ``[B, max_len, H, D]``: row ``j`` of sequence
    ``i`` is ``packed[cu[i] + min(j, len_i - 1)]``, zero past ``len_i``."""
    pos = torch.arange(max_len, device=packed.device)
    start, length = cu[:-1, None], (cu[1:] - cu[:-1])[:, None]
    idx = start + torch.minimum(pos[None, :], length - 1)
    idx = torch.where(idx < 0, idx + packed.shape[0], idx)
    seqs = packed[idx]
    valid = (pos[None, :] < length)[..., None, None]
    return seqs * valid


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False, name=None):
    """Varlen attention over packed q ``[total_q, H, D]`` and k/v
    ``[total_k, Hkv, D]`` with cumulative lengths ``cu_seqlens_*``
    ``[B + 1]``; returns ``[total_q, H, D]``.  ``dropout`` and
    ``return_softmax`` are accepted and not read, as in the
    reference."""
    query, key, value = _amp_cast("flash_attn_unpadded", query, key, value)
    cu_q = cu_seqlens_q.to(query.device).long()
    cu_k = cu_seqlens_k.to(query.device).long()
    qd = _gather_seqs(query, cu_q, max_seqlen_q)
    kd = _gather_seqs(key, cu_k, max_seqlen_k)
    vd = _gather_seqs(value, cu_k, max_seqlen_k)
    lens_q = cu_q[1:] - cu_q[:-1]
    lens_k = cu_k[1:] - cu_k[:-1]
    keys = torch.arange(max_seqlen_k, device=query.device)
    mask = torch.where(keys[None, None, None, :] < lens_k[:, None, None,
                                                          None],
                       0.0, NEG_INF)
    out = _attention_math(qd, kd, vd, mask, causal, scale=scale)
    flat = out.reshape(-1, out.shape[-2], out.shape[-1])
    rows = torch.arange(max_seqlen_q, device=query.device)
    pos = (cu_q[:-1, None] + rows[None, :]).reshape(-1)
    valid = (rows[None, :] < lens_q[:, None]).reshape(-1)
    total_q = query.shape[0]
    dest = torch.where(valid, pos, total_q - 1)
    return torch.zeros_like(query).index_add(
        0, dest, flat * valid[:, None, None])


class sdp_kernel:
    """Context selecting attention backends; selects nothing, as the
    reference's."""

    def __init__(self, enable_flash=True, enable_math=True,
                 enable_mem_efficient=True):
        self.enable_flash = enable_flash

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention restricted to a CSR pattern.  q/k/v: [B, H, S, D];
    ``sparse_csr_offset`` [B, H, S+1] row offsets; ``sparse_csr_columns``
    [B, H, nnz] column indices; ``key_padding_mask`` [B, S] and
    ``attn_mask`` [S, S] with 0 meaning masked.  Softmax runs over each
    row's stored columns only."""
    query, key, value = _amp_cast("sparse_attention", query, key, value)
    b, h, s, d = query.shape
    dev = query.device
    offset = sparse_csr_offset.to(dev).long()
    cols = sparse_csr_columns.to(dev).long()
    slot = torch.arange(cols.shape[-1], device=dev)
    # the row of each slot: how many rows end at or before it; a slot
    # past offset[..., -1] lands in row S, a spare row the slice drops
    # (JAX drops such updates as out of bounds)
    rows = (slot[None, None, None, :] >= offset[..., 1:, None]).sum(dim=-2)
    mask = torch.zeros((b, h, s + 1, s), dtype=torch.bool, device=dev)
    bidx = torch.arange(b, device=dev)[:, None, None].expand_as(rows)
    hidx = torch.arange(h, device=dev)[None, :, None].expand_as(rows)
    mask[bidx, hidx, rows, cols.clamp(0, s - 1)] = True
    mask = mask[:, :, :s]
    scores = torch.einsum("bhsd,bhtd->bhst", query.float(), key.float())
    scores = scores / math.sqrt(d)
    if key_padding_mask is not None:
        mask = mask & (key_padding_mask.to(dev)[:, None, None, :] != 0)
    if attn_mask is not None:
        mask = mask & (attn_mask.to(dev)[None, None, :, :] != 0)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask, probs, 0.0)
    return torch.einsum("bhst,bhtd->bhsd", probs.to(query.dtype), value)
