"""Fused functionals: port of ``paddle_tpu/incubate/nn/functional``.

"Fused" names one call per op, as in the reference; which of them reach
a kernel of the port follows the JAX package:

- ``fused_rms_norm`` (:25) is ``nn.functional.rms_norm`` (the RMSNorm
  kernel on the card when a weight is given); like the reference it
  reads neither ``norm_bias`` nor ``begin_norm_axis``.
- ``memory_efficient_attention`` (:355) is
  ``scaled_dot_product_attention``: the flash-attention forward kernel
  when ``attn_bias`` is None and there is no dropout; like the
  reference it reads neither ``scale`` nor ``training``.
- ``fused_layer_norm`` (:31), ``fused_linear`` (:38; the reference's
  ``[in, out]`` weight unless ``transpose_weight``),
  ``fused_rotary_position_embedding`` (:111; interleaved tables, both
  rotation styles, ``time_major``, ``position_ids`` and user tables),
  ``fused_dropout_add`` (:191; the threefry dropout of
  ``nn.functional``), ``masked_multihead_attention`` (:197) and
  ``fused_bias_act`` (:362) are plain torch, as they are XLA there.
- ``swiglu`` and ``llama_rope`` live in ``paddle_tpu_torch.nn.functional``
  and are re-exported here.
- ``fused_linear_cross_entropy`` (:285-350) is the ``lm_head`` product
  and the softmax cross entropy over token chunks, so the ``[N, vocab]``
  logits never exist whole: the forward keeps each row's fp32
  log-sum-exp and nothing else of a chunk, and the backward computes
  each chunk's logits again, turns them into ``softmax - onehot`` and
  accumulates dH and an fp32 dW chunk by chunk.  The JAX package runs
  the same computation as a ``lax.scan`` of ``jax.checkpoint``-ed chunks
  in XLA; here the per-chunk products are ``torch.matmul`` (fp32
  outputs of bf16 operands through ``torch.mm(..., out_dtype=
  torch.float32)`` on the card), and no kernel of the port is involved.
"""

from __future__ import annotations

import math

import torch

from ....amp.auto_cast import cast as _amp_cast
from ....nn import functional as F
from ....nn.functional import llama_rope, swiglu  # noqa: F401
from ....ops.flash_attention import NEG_INF

__all__ = ["fused_rms_norm", "fused_layer_norm", "fused_linear",
           "fused_rotary_position_embedding", "rotary_position_embedding",
           "llama_rope", "fused_dropout_add", "masked_multihead_attention",
           "memory_efficient_attention", "fused_bias_act",
           "swiglu", "fused_linear_cross_entropy"]


def fused_rms_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, **kwargs):
    out = F.rms_norm(x, norm_weight, epsilon)
    return (out,) if kwargs.get("return_tuple") else out


def fused_layer_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-5,
                     begin_norm_axis=-1, **kwargs):
    shape = tuple(x.shape[begin_norm_axis:]) if begin_norm_axis != -1 \
        else (x.shape[-1],)
    return F.layer_norm(x, shape, norm_weight, norm_bias, epsilon)


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """``x @ weight (+ bias)`` with the reference's ``[in, out]`` weight
    (``[out, in]`` with ``transpose_weight``)."""
    x, weight, bias = _amp_cast("fused_linear", x, weight, bias)
    out = torch.matmul(x, weight.T if transpose_weight else weight)
    return out if bias is None else out + bias


def _rotate_half(v):
    v1, v2 = torch.chunk(v, 2, dim=-1)
    return torch.cat([-v2, v1], dim=-1)


def _rotate_every_two(v):
    """NeoX adjacent pairs: ``rot[2i] = -v[2i+1]``, ``rot[2i+1] = v[2i]``."""
    return torch.stack([-v[..., 1::2], v[..., 0::2]], dim=-1).reshape(
        v.shape)


def _take_rows(table, idx):
    """``table[idx]`` as JAX gathers it: a negative index wraps, and any
    index still outside the table clamps to its nearest row."""
    n = table.shape[0]
    idx = idx.long()
    return table[torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)]


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False,
                                    rotary_emb_base=10000.0):
    """RoPE of each given tensor of q, k, v (``[B, S, H, D]``, or ``[S, B,
    H, D]`` with ``time_major``), the reference's conventions: built
    tables are interleaved (slot ``j`` uses exponent ``(j//2*2)/D``), user
    tables are read in the same layout; ``use_neox_rotary_style`` rotates
    adjacent pairs, else halves; the rotation runs in float32.  With
    ``position_ids`` [B, S] the rows are looked up as JAX gathers them
    (clamped), so a position past a built table's S rows takes its last
    row.  Returns the rotated tensors (one alone when one is given)."""
    present = [t for t in (q, k, v) if t is not None]
    present = list(_amp_cast("fused_rope", *present))
    dev = present[0].device
    seq_axis = 0 if time_major else 1
    if sin is None or cos is None:
        d = q.shape[-1]
        exps = torch.div(torch.arange(d, dtype=torch.float32, device=dev),
                         2, rounding_mode="floor") * 2.0 / d
        inv_freq = 1.0 / (rotary_emb_base ** exps)
        t = torch.arange(q.shape[seq_axis], dtype=torch.float32, device=dev)
        emb = torch.outer(t, inv_freq)
        cos_arr, sin_arr = torch.cos(emb), torch.sin(emb)
    else:
        cos_arr = cos.to(dev).reshape(-1, cos.shape[-1]).float()
        sin_arr = sin.to(dev).reshape(-1, sin.shape[-1]).float()
    if position_ids is not None:
        pos = position_ids.to(dev)
        cos_t, sin_t = _take_rows(cos_arr, pos), _take_rows(sin_arr, pos)
        if time_major:
            cos_t, sin_t = cos_t.transpose(0, 1), sin_t.transpose(0, 1)
        cos_t, sin_t = cos_t[:, :, None, :], sin_t[:, :, None, :]
    elif time_major:
        cos_t, sin_t = cos_arr[:, None, None, :], sin_arr[:, None, None, :]
    else:
        cos_t, sin_t = cos_arr[None, :, None, :], sin_arr[None, :, None, :]
    rotate = _rotate_every_two if use_neox_rotary_style else _rotate_half

    def rotate_one(xa):
        xf = xa.float()
        return (xf * cos_t + rotate(xf) * sin_t).to(xa.dtype)

    outs = tuple(rotate_one(a) for a in present)
    return outs if len(outs) > 1 else outs[0]


rotary_position_embedding = fused_rotary_position_embedding


def fused_dropout_add(x, y, p=0.0, training=True, mode="upscale_in_train",
                      name=None):
    return F.dropout(x, p, training=training, mode=mode) + y


def masked_multihead_attention(x, cache_kv=None, src_mask=None,
                               sequence_lengths=None, num_heads=None,
                               **kwargs):
    """One decode step: each row's new token attends over its cache.

    x: [B, 3*H*D] packed q, k, v of the step; cache_kv: [2, B, H, max_seq,
    D]; sequence_lengths: [B] ints, the tokens already cached (the new
    one is written there, clamped to ``max_seq - 1``; default 0);
    src_mask: additive [B|1, 1, 1, L] with L <= max_seq, right-padded
    with zeros (slots past each length are masked anyway).  Returns
    ``(out [B, H*D], new cache)``; ``cache_kv`` is not changed.  The
    reference blends the new k/v in by a one-hot product; here they are
    written into a copy, the same values for finite caches."""
    if cache_kv is None:
        raise ValueError("masked_multihead_attention requires cache_kv")
    max_seq, h, d = cache_kv.shape[3], cache_kv.shape[2], cache_kv.shape[4]
    if num_heads is not None and num_heads != h:
        raise ValueError(f"num_heads ({num_heads}) != cache heads ({h})")
    if x.shape[-1] != 3 * h * d:
        raise ValueError(
            f"x last dim ({x.shape[-1]}) != 3*H*D ({3 * h * d})")
    x, cache_kv, src_mask = _amp_cast("masked_multihead_attention", x,
                                      cache_kv, src_mask)
    b = x.shape[0]
    dev = x.device
    rows = torch.arange(b, device=dev)
    if sequence_lengths is None:
        seq_lens = torch.zeros((b,), dtype=torch.long, device=dev)
    else:
        seq_lens = sequence_lengths.to(dev).long()
    seq_lens = seq_lens.clamp(max=max_seq - 1)
    qkv = x.reshape(b, 3, h, d)
    q = qkv[:, 0]                                          # [B, H, D]
    new_cache = cache_kv.clone()
    new_cache[0, rows, :, seq_lens] = qkv[:, 1].to(new_cache.dtype)
    new_cache[1, rows, :, seq_lens] = qkv[:, 2].to(new_cache.dtype)
    k_cache, v_cache = new_cache[0], new_cache[1]
    logits = torch.einsum("bhd,bhsd->bhs", q, k_cache) / F._in_dtype(
        math.sqrt(d), q.dtype)
    valid = torch.arange(max_seq, device=dev)[None, :] <= seq_lens[:, None]
    logits = torch.where(valid[:, None, :], logits, NEG_INF)
    if src_mask is not None:
        m = src_mask.to(dev)
        m = m.reshape(m.shape[0], 1, m.shape[-1])
        if m.shape[-1] > max_seq:
            m = m[..., :max_seq]
        elif m.shape[-1] < max_seq:
            m = torch.nn.functional.pad(m, (0, max_seq - m.shape[-1]))
        logits = logits + m.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhs,bhsd->bhd", probs, v_cache)
    return out.reshape(b, h * d), new_cache


def memory_efficient_attention(query, key, value, attn_bias=None, p=0.0,
                               scale=None, training=True):
    """``scaled_dot_product_attention(q, k, v, attn_bias, p)``: the
    flash-attention kernel on the card without a bias or dropout."""
    return F.scaled_dot_product_attention(query, key, value,
                                          attn_mask=attn_bias, dropout_p=p)


def fused_bias_act(x, bias=None, act_method="gelu", **kwargs):
    act = {"gelu": F.gelu, "relu": F.relu, "silu": F.silu,
           "swiglu": swiglu}[act_method]
    if bias is not None:
        x = x + bias
    return act(x)


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
