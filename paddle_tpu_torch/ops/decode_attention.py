"""Paged decode attention: the CUDA kernel
``csrc/paged_decode_attention.cu`` and its plain PyTorch version, plus
the chunk-prefill attention (plain math in the JAX package too).

Port of the paged float-cache path of
``paddle_tpu/ops/pallas/decode_attention.py``: the at-rest layout helpers
``packed_ok`` (:130), ``paged_arena_shape`` (:145) and
``paged_gather_view`` (:164) unchanged, ``decode_attention_paged``
(:1175) over ``_decode_attention_xla`` (:1136) math, and
``paged_prefix_attention`` (:1219) over the ``_paged_multi_xla`` body
(:1280-1311).

``decode_attention_paged`` launches the kernel for CUDA tensors (or
raises on what the kernel cannot take) and runs
``decode_attention_paged_plain`` for CPU tensors; nothing sends a CUDA
tensor to the plain version.  The kernel has no backward: on the card it
raises when grad mode is on and an input requires grad, rather than
return an output detached from them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_LANES = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_MAX = 227 * 1024

KERNEL = _build.register(_build.Kernel(
    "paged_decode_attention", "ptt_paged_decode_attention",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]))


def packed_ok(num_kv_heads: int, head_dim: int) -> bool:
    """Can this head geometry use the packed [.., H*D] layout?"""
    w = num_kv_heads * head_dim
    return w % _LANES == 0 and (_LANES % head_dim == 0
                                or head_dim % _LANES == 0)


def paged_arena_shape(num_blocks, num_kv_heads, block_len, head_dim):
    """At-rest PAGED KV arena shape: ``num_blocks`` blocks of
    ``block_len`` slots shared by every sequence, packed [NB, L, H*D]
    when the head geometry allows, else [NB, L, H, D].  Both layouts
    hold the same bytes in the same order."""
    if packed_ok(num_kv_heads, head_dim):
        return (num_blocks, block_len, num_kv_heads * head_dim)
    return (num_blocks, block_len, num_kv_heads, head_dim)


def paged_gather_view(arena, tables):
    """Dense per-sequence view of a paged arena: gather each row's
    blocks through its table and fold the block axis into a
    [B, max_blocks * L, ...] cache.  Table entries past a sequence's
    allocation point at the trash block (last arena row); its contents
    are finite and hidden by the ``lens`` mask."""
    g = arena[tables.long()]           # [B, max_blocks, L, ...]
    b, nb, blk_len = g.shape[:3]
    return g.reshape((b, nb * blk_len) + tuple(g.shape[3:]))


def _decode_attention_math(q4, k_cache, v_cache, lens):
    """``_decode_attention_xla``: one-token GQA attention over a dense
    [B, S, ...] cache, fp32 logits and softmax, probabilities cast to
    q's dtype before the PV product.  Returns [B, H_kv, G, D]."""
    b, hkv, g, d = q4.shape
    s_max = k_cache.shape[1]
    k_cache = k_cache.reshape(b, s_max, hkv, d)
    v_cache = v_cache.reshape(b, s_max, hkv, d)
    logits = torch.einsum("bkgd,bskd->bkgs", q4.float(), k_cache.float())
    logits = logits / math.sqrt(d)
    valid = (torch.arange(s_max, device=q4.device)[None, :]
             <= lens.long()[:, None])                        # [B, S]
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q4.dtype)
    return torch.einsum("bkgs,bskd->bkgd", probs, v_cache.to(q4.dtype))


def _head_geometry(q, arena):
    b, hq, d = q.shape
    if arena.ndim == 3:
        if arena.shape[2] % d:
            raise ValueError(f"arena row width {arena.shape[2]} is not a "
                             f"multiple of head_dim {d}")
        hkv = arena.shape[2] // d
    elif arena.ndim == 4:
        if arena.shape[3] != d:
            raise ValueError(f"arena head_dim {arena.shape[3]} != q head_dim "
                             f"{d}")
        hkv = arena.shape[2]
    else:
        raise ValueError(f"arena must be [NB+1, L, H*D] or [NB+1, L, H, D], "
                         f"got shape {tuple(arena.shape)}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    return b, hq, d, hkv, hq // hkv


def decode_attention_paged_plain(q, k_arena, v_arena, tables, lens):
    """Plain version: the gather view of each row plus the
    ``_decode_attention_xla`` math.  q: [B, H_q, D]; returns
    [B, H_q * D] in q.dtype."""
    b, hq, d, hkv, g = _head_geometry(q, k_arena)
    out = _decode_attention_math(q.reshape(b, hkv, g, d),
                                 paged_gather_view(k_arena, tables),
                                 paged_gather_view(v_arena, tables), lens)
    return out.reshape(b, hq * d)


def _check_operands(q, k_arena, v_arena, tables, lens):
    """Raise on what the kernel cannot take; returns (B, Hq, D, Hkv,
    G)."""
    b, hq, d, hkv, g = _head_geometry(q, k_arena)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_arena, v_arena)):
        raise RuntimeError(
            "paged decode kernel has no backward (it serves under "
            "torch.no_grad()); its output would silently drop the "
            "gradient of q, k_arena and v_arena")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged decode kernel takes float32 or bfloat16 q, "
                        f"got {q.dtype}")
    for name, a in (("k_arena", k_arena), ("v_arena", v_arena)):
        if a.dtype != q.dtype:
            raise TypeError(f"paged decode kernel needs {name} dtype == q "
                            f"dtype, got {a.dtype} vs {q.dtype}")
        if a.shape != k_arena.shape:
            raise ValueError("k_arena and v_arena shapes differ")
    for name, t in (("tables", tables), ("lens", lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("k_arena", k_arena), ("v_arena", v_arena),
                    ("tables", tables), ("lens", lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged decode kernel needs a contiguous {name}")
    for name, t in (("q", q), ("k_arena", k_arena), ("v_arena", v_arena)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged decode kernel needs a 16-byte aligned "
                             f"{name}")
    if tables.ndim != 2 or tables.shape[0] != b or tables.shape[1] < 1 \
            or lens.shape != (b,):
        raise ValueError(f"tables must be [B, max_blocks] and lens [B] for "
                         f"B={b}, got {tuple(tables.shape)} and "
                         f"{tuple(lens.shape)}")
    if d % 8:
        raise ValueError(f"paged decode kernel needs head_dim % 8 == 0, "
                         f"got {d}")
    if b > 65535:
        raise ValueError(f"paged decode kernel takes at most 65535 rows, "
                         f"got {b}")
    blk_len = k_arena.shape[1]
    smem = 4 * (2 * g * d + blk_len * (2 * d + 1) + g * blk_len + 3 * g)
    if smem > _SMEM_MAX:
        raise ValueError(f"paged decode kernel: G={g}, D={d}, L={blk_len} "
                         f"need {smem} bytes of shared memory (> {_SMEM_MAX})")
    return b, hq, d, hkv, g


def _decode_attention_paged_cuda(q, k_arena, v_arena, tables, lens):
    b, hq, d, hkv, g = _check_operands(q, k_arena, v_arena, tables, lens)
    out = torch.empty_like(q)
    if b == 0:
        return out.reshape(b, hq * d)
    KERNEL.launch(
        _build.ptr(q), _build.ptr(k_arena), _build.ptr(v_arena),
        _build.ptr(tables), _build.ptr(lens), _build.ptr(out),
        b, hkv, g, d, k_arena.shape[1], tables.shape[1], k_arena.shape[0],
        1.0 / math.sqrt(d), _DTYPES[q.dtype], _build.stream_ptr(q))
    return out.reshape(b, hq * d)


def decode_attention_paged(q, k_arena, v_arena, tables, lens):
    """One-token GQA attention over a PAGED cache prefix.

    q: [B, H_q, D]; arenas: ``paged_arena_shape`` pools (packed
    [NB+1, L, H_kv*D] or unpacked [NB+1, L, H_kv, D], last row = trash
    block); tables: [B, max_blocks] int32 arena row per logical block;
    lens: [B] int32 = index of the LAST valid slot.  Returns
    [B, H_q * D] in q.dtype.  CUDA tensors launch the kernel; CPU
    tensors run ``decode_attention_paged_plain``."""
    if q.device.type == "cuda":
        return _decode_attention_paged_cuda(q, k_arena, v_arena, tables,
                                            lens)
    if q.device.type == "cpu":
        return decode_attention_paged_plain(q, k_arena, v_arena, tables,
                                            lens)
    raise ValueError(f"decode_attention_paged: unsupported device {q.device}")


def paged_prefix_attention(q, k_arena, v_arena, tables, start):
    """Chunked-prefill attention over the paged cache: C chunk queries
    at global positions ``start + row`` attend causally over everything
    already written through the block table (prefix-cached blocks,
    earlier chunks and this chunk's own K/V, scattered before this
    read).  Plain torch math on every device, as in the JAX package:
    the gather view plus fp32 logits and softmax, probabilities cast to
    q's dtype before PV.

    q: [B, C, H_q, D]; arenas/tables as ``decode_attention_paged``;
    start: [B] first global position of the chunk.  Returns
    [B, C, H_q, D] in q.dtype; rows past the prompt's true length are
    garbage the caller ignores."""
    b, cc, hq, d = q.shape
    kd = paged_gather_view(k_arena, tables)
    vd = paged_gather_view(v_arena, tables)
    s = kd.shape[1]
    hkv = kd[0, 0].numel() // d
    kd = kd.reshape(b, s, hkv, d)
    vd = vd.reshape(b, s, hkv, d)
    g = hq // hkv
    q5 = q.reshape(b, cc, hkv, g, d)
    logits = torch.einsum("bckgd,bskd->bckgs", q5.float(), kd.float())
    logits = logits / math.sqrt(d)
    pos = (start.reshape(b, 1).long()
           + torch.arange(cc, device=q.device)[None, :])          # [B, C]
    keep = torch.arange(s, device=q.device)[None, None, :] <= pos[:, :, None]
    logits = logits.masked_fill(~keep[:, :, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bckgs,bskd->bckgd", probs, vd.to(q.dtype))
    return out.reshape(b, cc, hq, d)
