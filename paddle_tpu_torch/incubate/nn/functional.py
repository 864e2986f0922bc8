"""Fused functionals: port of ``paddle_tpu/incubate/nn/functional``.

``swiglu`` and ``llama_rope`` live in ``paddle_tpu_torch.nn.functional``
and are re-exported here.  ``fused_linear_cross_entropy`` (:285-350) is
the ``lm_head`` product and the softmax cross entropy over token chunks,
so the ``[N, vocab]`` logits never exist whole: the forward keeps each
row's fp32 log-sum-exp and nothing else of a chunk, and the backward
computes each chunk's logits again, turns them into ``softmax - onehot``
and accumulates dH and an fp32 dW chunk by chunk.  The JAX package runs
the same computation as a ``lax.scan`` of ``jax.checkpoint``-ed chunks in
XLA; here the per-chunk products are ``torch.matmul`` (fp32 outputs of
bf16 operands through ``torch.mm(..., out_dtype=torch.float32)`` on the
card), and no kernel of the port is involved.
"""

from __future__ import annotations

import torch

from ...amp.auto_cast import cast as _amp_cast
from ...nn.functional import llama_rope, swiglu  # noqa: F401

__all__ = ["swiglu", "llama_rope", "fused_linear_cross_entropy"]


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an fp32 result accumulated in fp32 (the
    reference's ``preferred_element_type=float32``)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk_rows(n: int, chunk: int):
    c = min(chunk, n)
    return [(s, min(s + c, n)) for s in range(0, n, c)]


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight, labels, ignore_index, chunk):
        n = hidden.shape[0]
        v = weight.shape[1]
        lse = torch.empty(n, dtype=torch.float32, device=hidden.device)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        count = torch.zeros((), dtype=torch.int64, device=hidden.device)
        for s, e in _chunk_rows(n, chunk):
            logits = _mm_f32(hidden[s:e], weight)          # [c, V] fp32
            lse_c = torch.logsumexp(logits, dim=-1)
            l_c = labels[s:e]
            idx = torch.clamp(l_c, 0, v - 1)
            picked = torch.gather(logits, 1, idx[:, None])[:, 0]
            valid = l_c != ignore_index
            nll = torch.where(valid, lse_c - picked, torch.zeros_like(lse_c))
            total = total + nll.sum()
            count = count + valid.sum()
            lse[s:e] = lse_c
        denom = torch.clamp_min(count, 1).to(torch.float32)
        ctx.save_for_backward(hidden, weight, labels, lse, denom)
        ctx.ignore_index, ctx.chunk = ignore_index, chunk
        return total / denom

    @staticmethod
    def backward(ctx, g):
        hidden, weight, labels, lse, denom = ctx.saved_tensors
        n, v = hidden.shape[0], weight.shape[1]
        scale = g.to(torch.float32) / denom
        dh = torch.empty_like(hidden) if ctx.needs_input_grad[0] else None
        dw = (torch.zeros(weight.shape, dtype=torch.float32,
                          device=weight.device)
              if ctx.needs_input_grad[1] else None)
        for s, e in _chunk_rows(n, ctx.chunk):
            h_c, l_c = hidden[s:e], labels[s:e]
            valid = l_c != ctx.ignore_index
            # d(lse - picked)/dlogits = softmax - onehot, on valid rows
            dl = torch.exp(_mm_f32(h_c, weight) - lse[s:e, None])
            idx = torch.clamp(l_c, 0, v - 1)
            dl.scatter_add_(1, idx[:, None], torch.full(
                (e - s, 1), -1.0, dtype=dl.dtype, device=dl.device))
            dl.mul_(torch.where(valid, scale, torch.zeros_like(scale))[:, None])
            if dh is not None:
                dh[s:e] = _mm_f32(dl.to(weight.dtype), weight.t())
            if dw is not None:
                dw += _mm_f32(h_c.t(), dl.to(hidden.dtype))
        if dw is not None:
            dw = dw.to(weight.dtype)
        return dh, dw, None, None, None


def fused_linear_cross_entropy(hidden, weight, labels, ignore_index=-100,
                               chunk=2048, name=None):
    """Mean NLL over non-ignored tokens of ``softmax(hidden @ weight)``.

    hidden: [N, H] (or [B, S, H], flattened); weight: [H, V] (the
    reference's layout: give a torch ``Linear``'s ``weight.t()``);
    labels: [N] int.  Chunks of ``chunk`` rows (the last one shorter
    where N % chunk != 0, which counts as the reference's ignored
    padding rows); the mean divides by ``max(#valid, 1)``.  Returns a
    float32 scalar."""
    hidden, weight = _amp_cast("fused_linear_cross_entropy", hidden, weight)
    hf = hidden.reshape(-1, hidden.shape[-1])
    lf = labels.reshape(-1).to(device=hf.device, dtype=torch.int64)
    return _FusedLinearCE.apply(hf, weight, lf, int(ignore_index),
                                int(chunk))
