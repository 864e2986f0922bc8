"""Functionals of the serving and training paths.

- ``swiglu`` and ``llama_rope`` (port of
  ``paddle_tpu/incubate/nn/functional/__init__.py:50-108``): with
  ``position_ids`` the rotation is plain torch math, without them it is
  the RoPE kernel (``ops/rope.py``), as in the JAX package.
- ``scaled_dot_product_attention`` (``nn/functional/attention.py:26-52,
  82-110``): the flash-attention Function when there is no mask, else the
  ``_xla_attention`` math in plain torch.
- ``cross_entropy`` (``nn/functional/loss.py:30-74``): hard integer
  labels with ``ignore_index`` and ``reduction="mean"`` only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.flash_attention import NEG_INF, flash_attention
from ..ops.rope import apply_rope


def swiglu(x: torch.Tensor, y: torch.Tensor = None) -> torch.Tensor:
    """``silu(x) * y``; with ``y=None`` x's last axis is split in two
    halves (gate, up)."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return F.silu(x) * y


def _rotate_half(v: torch.Tensor) -> torch.Tensor:
    v1, v2 = torch.chunk(v, 2, dim=-1)
    return torch.cat([-v2, v1], dim=-1)


def llama_rope(q: torch.Tensor, k: torch.Tensor,
               rotary_emb_base: float = 10000.0,
               position_ids: torch.Tensor = None):
    """HF-Llama rotate_half RoPE with concat(freqs, freqs) tables.
    q/k: [B, S, H, D]; position_ids: [B, S] (or [1, S], broadcast), or
    None for positions ``0 .. S-1``.  inv_freq, cos and sin are computed
    in fp32 and the rotation runs in fp32 before the cast back, exactly
    as the JAX package does.  Without position_ids q and k go through
    ``apply_rope`` (the RoPE kernel on the card, differentiable)."""
    d = q.shape[-1]
    inv_freq = 1.0 / (rotary_emb_base ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=q.device) / d))
    if position_ids is None:
        t = torch.arange(q.shape[1], dtype=torch.float32, device=q.device)
        freqs = torch.outer(t, inv_freq)
        cos_h = torch.cos(freqs)[None, :, None, :]
        sin_h = torch.sin(freqs)[None, :, None, :]
        return apply_rope(q, cos_h, sin_h), apply_rope(k, cos_h, sin_h)
    freqs = position_ids.to(q.device)[..., None].float() * inv_freq
    cos_h = torch.cos(freqs)[:, :, None, :]
    sin_h = torch.sin(freqs)[:, :, None, :]
    cos2 = torch.cat([cos_h, cos_h], dim=-1)
    sin2 = torch.cat([sin_h, sin_h], dim=-1)

    def rotate_one(xa):
        xf = xa.float()
        return (xf * cos2 + _rotate_half(xf) * sin2).to(xa.dtype)

    return rotate_one(q), rotate_one(k)


def _attention_math(q, k, v, mask=None, causal=False):
    """``_xla_attention`` (no dropout): scores in q's dtype, causal mask
    -1e30 with the ``sk - sq`` offset, additive mask, fp32 softmax cast
    to q's dtype, GQA by repeating kv heads.  q/k/v: [B, S, H, D]."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if kt.shape[1] != qt.shape[1]:
        rep = qt.shape[1] // kt.shape[1]
        kt = kt.repeat_interleave(rep, dim=1)
        vt = vt.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
    if causal:
        sq, sk = logits.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, NEG_INF)
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vt).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """q/k/v: [B, S, H, D] (the reference API layout).  Without a mask
    (and with equal q/k lengths, the flash kernels' self-attention
    layout) this is ``flash_attention``, the kernels on the card; with a
    mask it is the ``_xla_attention`` math in plain torch on every
    device, as the JAX package runs XLA there."""
    p = dropout_p if training else 0.0
    if p > 0.0:
        raise NotImplementedError(
            "scaled_dot_product_attention with dropout_p > 0 is not ported "
            "(the JAX package draws its bits from jax.random) "
            "(ROADMAP.md, Queue 1: training)")
    if attn_mask is None and query.shape[1] == key.shape[1]:
        return flash_attention(query, key, value, causal=is_causal)
    return _attention_math(query, key, value, attn_mask, is_causal)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Mean negative log-likelihood of hard integer labels over the
    positions whose label is not ``ignore_index``.  ``log_softmax`` runs
    in the logits' dtype, as ``jax.nn.log_softmax`` does.  labels:
    ``input.shape[:-1]`` (or with a trailing 1).  Class weights, soft
    labels, label smoothing, other reductions, another axis and
    ``use_softmax=False`` are not ported."""
    unported = {"weight": weight is not None,
                "reduction": reduction != "mean",
                "soft_label": bool(soft_label),
                "axis": axis not in (-1, input.ndim - 1),
                "use_softmax": not use_softmax,
                "label_smoothing": label_smoothing != 0.0}
    for name, on in unported.items():
        if on:
            raise NotImplementedError(
                f"cross_entropy({name}=...) is not ported: only hard "
                f"integer labels, ignore_index and reduction='mean' are "
                f"(ROADMAP.md, Queue 1: training)")
    if label.dtype.is_floating_point or label.dtype == torch.bool:
        raise NotImplementedError(
            "cross_entropy takes hard integer labels only (ROADMAP.md, "
            "Queue 1: training)")
    idx = label.long()
    if idx.ndim == input.ndim:
        idx = idx.squeeze(-1)
    logp = torch.log_softmax(input, dim=-1)
    valid = idx != ignore_index
    safe = torch.where(valid, idx, torch.zeros_like(idx))
    picked = torch.gather(logp, -1, safe[..., None]).squeeze(-1)
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    n_valid = torch.clamp(valid.to(logp.dtype).sum(), min=1.0)
    return loss.sum() / n_valid
