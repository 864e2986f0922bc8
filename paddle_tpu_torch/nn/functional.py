"""LLM functionals of the serving path: ``swiglu`` and the
``position_ids`` branch of ``llama_rope`` (port of
``paddle_tpu/incubate/nn/functional/__init__.py:50-108``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
    """HF-Llama rotate_half RoPE with concat(freqs, freqs) tables at
    explicit positions.  q/k: [B, S, H, D]; position_ids: [B, S] (or
    [1, S], broadcast).  inv_freq, cos and sin are computed in fp32 and
    the rotation runs in fp32 before the cast back, exactly as the JAX
    package does.  The ``position_ids=None`` branch (the RoPE kernel of
    the training path) is not ported yet."""
    if position_ids is None:
        raise NotImplementedError(
            "llama_rope without position_ids (the RoPE kernel, "
            "ops/pallas/rope.py) is not ported yet: see ROADMAP.md Queue 2")
    d = q.shape[-1]
    inv_freq = 1.0 / (rotary_emb_base ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=q.device) / d))
    freqs = position_ids.to(q.device)[..., None].float() * inv_freq
    cos_h = torch.cos(freqs)[:, :, None, :]
    sin_h = torch.sin(freqs)[:, :, None, :]
    cos2 = torch.cat([cos_h, cos_h], dim=-1)
    sin2 = torch.cat([sin_h, sin_h], dim=-1)

    def rotate_one(xa):
        xf = xa.float()
        return (xf * cos2 + _rotate_half(xf) * sin2).to(xa.dtype)

    return rotate_one(q), rotate_one(k)
