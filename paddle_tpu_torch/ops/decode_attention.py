"""Decode attention: the CUDA kernels ``csrc/paged_decode_attention.cu``,
``csrc/paged_decode_attention_int8.cu``,
``csrc/paged_decode_attention_multi.cu`` and ``csrc/decode_attention.cu``
and their plain PyTorch versions, plus the chunk-prefill attention (plain
math in the JAX package too).

Port of ``paddle_tpu/ops/pallas/decode_attention.py``: the at-rest layout
helpers ``packed_ok`` (:130), ``cache_shape`` (:137),
``paged_arena_shape`` (:145), ``paged_scale_shape`` (:156),
``paged_gather_view`` (:164) and ``paged_dequant_view`` (:177) unchanged;
``decode_attention`` (:1155, the dense cache of ``generate()``) and
``decode_attention_paged`` (:1175) over ``_decode_attention_xla`` (:1136)
math; ``decode_attention_paged_multi`` (:1243, the speculative verify
forward's K-wide attention) and ``paged_prefix_attention`` (:1219), both
over the ``_paged_multi_xla`` body (:1280-1311).

``decode_attention``, ``decode_attention_paged`` and
``decode_attention_paged_multi`` launch a kernel for CUDA tensors (or
raise on what the kernel cannot take) and run their plain versions for
CPU tensors; nothing sends a CUDA tensor to a plain version.  A float
paged cache launches the float kernel, an int8 one (``kv_scales`` given)
the int8 kernel.  The kernels have no backward: on the card they raise
when grad mode is on and an input requires grad, rather than return an
output detached from them.
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
KERNEL_INT8 = _build.register(_build.Kernel(
    "paged_decode_attention_int8", "ptt_paged_decode_attention_int8",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]))
# the K-wide verify kernels: one source, a float and an int8 entry point
KERNEL_MULTI = _build.register(_build.Kernel(
    "paged_decode_attention_multi", "ptt_paged_decode_attention_multi",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]))
KERNEL_MULTI_INT8 = _build.register(_build.Kernel(
    "paged_decode_attention_multi_int8",
    "ptt_paged_decode_attention_multi_int8",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    source="paged_decode_attention_multi"))
_SPLIT_SLOTS = 128      # cache slots one CTA of the K-wide kernel walks
_MULTI_HEAD_DIMS = (32, 64, 128, 256)
_MULTI_MAX_THREADS = 512   # threads of one K-wide split CTA
_MULTI_STAGES = 3       # blocks in the K-wide kernel's cp.async ring
KERNEL_DENSE = _build.register(_build.Kernel(
    "decode_attention", "ptt_decode_attention",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]))
_DENSE_CHUNK = 16       # cache slots the dense kernel stages per step


def packed_ok(num_kv_heads: int, head_dim: int) -> bool:
    """Can this head geometry use the packed [.., H*D] layout?"""
    w = num_kv_heads * head_dim
    return w % _LANES == 0 and (_LANES % head_dim == 0
                                or head_dim % _LANES == 0)


def cache_shape(batch, num_kv_heads, max_cache_len, head_dim):
    """At-rest DENSE KV cache shape (``generate()``): packed
    [B, S, H*D] when the head geometry allows, else [B, S, H, D]."""
    if packed_ok(num_kv_heads, head_dim):
        return (batch, max_cache_len, num_kv_heads * head_dim)
    return (batch, max_cache_len, num_kv_heads, head_dim)


def paged_arena_shape(num_blocks, num_kv_heads, block_len, head_dim):
    """At-rest PAGED KV arena shape: ``num_blocks`` blocks of
    ``block_len`` slots shared by every sequence, packed [NB, L, H*D]
    when the head geometry allows, else [NB, L, H, D].  Both layouts
    hold the same bytes in the same order."""
    if packed_ok(num_kv_heads, head_dim):
        return (num_blocks, block_len, num_kv_heads * head_dim)
    return (num_blocks, block_len, num_kv_heads, head_dim)


def paged_scale_shape(num_blocks, num_kv_heads, block_len):
    """At-rest shape of an int8 arena's absmax-scale plane: one f32
    scale per block slot per kv head (``quantize_kv_heads``)."""
    return (num_blocks, block_len, num_kv_heads)


def paged_gather_view(arena, tables):
    """Dense per-sequence view of a paged arena: gather each row's
    blocks through its table and fold the block axis into a
    [B, max_blocks * L, ...] cache.  Table entries past a sequence's
    allocation point at the trash block (last arena row); its contents
    are finite and hidden by the ``lens`` mask."""
    g = arena[tables.long()]           # [B, max_blocks, L, ...]
    b, nb, blk_len = g.shape[:3]
    return g.reshape((b, nb * blk_len) + tuple(g.shape[3:]))


def paged_dequant_view(arena, scales, tables, out_dtype):
    """Dense DEQUANTIZED per-sequence view of an int8 paged arena: the
    gather of ``paged_gather_view`` with each entry's per-kv-head scale
    multiplied back in fp32, then cast to ``out_dtype`` (the compute
    dtype).  The one definition of the dequant math that the plain
    versions share and the int8 kernel repeats."""
    if arena.dtype != torch.int8:
        raise TypeError(
            f"paged_dequant_view: kv_scales supplied for a {arena.dtype} "
            f"arena — scale planes only ride an int8 code arena (a float "
            f"cache must pass kv_scales=None)")
    idx = tables.long()
    g = arena[idx].float()                  # [B, max_blocks, L, ...]
    s = scales[idx]                         # [B, max_blocks, L, H_kv]
    if arena.ndim == 3:
        s = s.repeat_interleave(arena.shape[2] // scales.shape[2], dim=-1)
    else:
        s = s[..., None]
    deq = (g * s).to(out_dtype)
    b, nb, blk_len = deq.shape[:3]
    return deq.reshape((b, nb * blk_len) + tuple(deq.shape[3:]))


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
    """(B, Hq, D, Hkv, G) of q [B, Hq, D] or [B, C, Hq, D] over a packed
    [.., L or S, Hkv*D] or unpacked [.., L or S, Hkv, D] cache."""
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
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


def _dense_views(k_arena, v_arena, tables, kv_scales, dtype):
    """Each row's dense K and V: the gather view of a float cache, or the
    dequantized view of an int8 cache (``kv_scales`` given)."""
    if kv_scales is None:
        return (paged_gather_view(k_arena, tables),
                paged_gather_view(v_arena, tables))
    return (paged_dequant_view(k_arena, kv_scales[0], tables, dtype),
            paged_dequant_view(v_arena, kv_scales[1], tables, dtype))


def decode_attention_paged_plain(q, k_arena, v_arena, tables, lens,
                                 kv_scales=None):
    """Plain version: each row's dense (dequantized, for an int8 cache)
    view plus the ``_decode_attention_xla`` math.  q: [B, H_q, D];
    returns [B, H_q * D] in q.dtype."""
    b, hq, d, hkv, g = _head_geometry(q, k_arena)
    kd, vd = _dense_views(k_arena, v_arena, tables, kv_scales, q.dtype)
    out = _decode_attention_math(q.reshape(b, hkv, g, d), kd, vd, lens)
    return out.reshape(b, hq * d)


def verify_split_plan(max_blocks, blk_len):
    """(blocks per split, number of splits) of the K-wide kernel: each CTA
    walks a fixed run of ``max(1, 128 // blk_len)`` blocks of a row's
    table, and the grid holds enough splits for a full table.  A function
    of ``max_blocks`` and ``blk_len`` alone, never of the batch, the
    verify width or the card, so a row's split boundaries (and so its
    output bits) are the same whatever batch it rides in."""
    bps = max(1, _SPLIT_SLOTS // blk_len)
    return bps, -(-max_blocks // bps)


def verify_partials(b, cq, hkv, g, d, max_blocks, blk_len, device):
    """The K-wide kernel's scratch: each split's unnormalized accumulator
    ``[B, Hkv, n_splits, C*G, D]`` and its (running max, denominator)
    ``[B, Hkv, n_splits, C*G, 2]``, fp32, uninitialized (a split writes
    the rows it walks; the merge reads only a row's own splits)."""
    _, n_splits = verify_split_plan(max_blocks, blk_len)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty(b, hkv, n_splits, cq * g, d, **f32),
            torch.empty(b, hkv, n_splits, cq * g, 2, **f32))


def _multi_smem(blk_len, d, item, int8):
    """Shared memory of the K-wide split kernel: the ring of K and V
    blocks, or for int8 the ring of codes and scales (padded to 16 bytes)
    and one dequantized K and V tile, plus the split's table entries (512
    bytes).  A bfloat16 tile (the tensor-core route) holds the block's
    slots rounded up to 16, in rows padded by 16 bytes."""
    tc = item == 2
    tile = (-(-blk_len // 16) * 16 if tc else blk_len) \
        * (d + 8 if tc else d) * item
    if not int8:
        return _MULTI_STAGES * 2 * tile + 512
    return _MULTI_STAGES * 2 * blk_len * d \
        + -(-_MULTI_STAGES * 2 * blk_len * 4 // 16) * 16 + 2 * tile + 512


def _multi_threads(rows, d, item):
    """Threads of a K-wide split CTA: two warps per 16 query rows on the
    tensor cores (bfloat16), D/16 lanes per row on CUDA cores
    (float32)."""
    if item == 2:
        return 64 * -(-rows // 16)
    return max(128, -(-rows * d // 16 // 32) * 32)


def _check_operands(q, k_arena, v_arena, tables, lens, kv_scales=None):
    """Raise on what a paged kernel (the int8 one with ``kv_scales``; the
    K-wide one for q [B, C, Hq, D]) cannot take; returns (B, Hq, D, Hkv,
    G)."""
    b, hq, d, hkv, g = _head_geometry(q, k_arena)
    multi = q.ndim == 4
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_arena, v_arena)):
        raise RuntimeError(
            "paged decode kernel has no backward (it serves under "
            "torch.no_grad()); its output would silently drop the "
            "gradient of q, k_arena and v_arena")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged decode kernel takes float32 or bfloat16 q, "
                        f"got {q.dtype}")
    arena_dt = q.dtype if kv_scales is None else torch.int8
    for name, a in (("k_arena", k_arena), ("v_arena", v_arena)):
        if a.dtype != arena_dt:
            raise TypeError(f"paged decode kernel needs {name} dtype "
                            f"{arena_dt} (q {q.dtype}, "
                            f"{'int8 cache' if kv_scales is not None else 'float cache'}"
                            f"), got {a.dtype}")
        if a.shape != k_arena.shape:
            raise ValueError("k_arena and v_arena shapes differ")
    operands = [("q", q), ("k_arena", k_arena), ("v_arena", v_arena)]
    if kv_scales is not None:
        want = paged_scale_shape(k_arena.shape[0], hkv, k_arena.shape[1])
        for name, t in zip(("k_scales", "v_scales"), kv_scales):
            if t.dtype != torch.float32 or tuple(t.shape) != want:
                raise ValueError(f"int8 paged decode kernel needs float32 "
                                 f"{name} of shape {want}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
            operands.append((name, t))
    for name, t in (("tables", tables), ("lens", lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in operands + [("tables", tables), ("lens", lens)]:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged decode kernel needs a contiguous {name}")
    for name, t in operands:
        if t.data_ptr() % 16:
            raise ValueError(f"paged decode kernel needs a 16-byte aligned "
                             f"{name}")
    if tables.ndim != 2 or tables.shape[0] != b or tables.shape[1] < 1 \
            or lens.shape != (b,):
        raise ValueError(f"tables must be [B, max_blocks] and lens [B] for "
                         f"B={b}, got {tuple(tables.shape)} and "
                         f"{tuple(lens.shape)}")
    vec = 8 if kv_scales is None else 16      # elements per 16-byte load
    if d % vec:
        raise ValueError(f"paged decode kernel needs head_dim % {vec} == 0, "
                         f"got {d}")
    if b > 65535:
        raise ValueError(f"paged decode kernel takes at most 65535 rows, "
                         f"got {b}")
    blk_len = k_arena.shape[1]
    rows = g * (q.shape[1] if multi else 1)     # query rows per CTA
    if multi:
        if d not in _MULTI_HEAD_DIMS:
            raise ValueError(f"K-wide paged decode kernel takes head_dim in "
                             f"{_MULTI_HEAD_DIMS}, got {d}")
        threads = _multi_threads(rows, d, q.element_size())
        if threads > _MULTI_MAX_THREADS:
            raise ValueError(f"K-wide paged decode kernel: C*G={rows} query "
                             f"rows at D={d} need {threads} threads "
                             f"(> {_MULTI_MAX_THREADS})")
        smem = _multi_smem(blk_len, d, q.element_size(),
                           kv_scales is not None)
    else:
        smem = 4 * (2 * rows * d + blk_len * (2 * d + 1) + rows * blk_len
                    + 3 * rows)
    if smem > _SMEM_MAX:
        raise ValueError(f"paged decode kernel: {rows} query rows, D={d}, "
                         f"L={blk_len} need {smem} bytes of shared memory "
                         f"(> {_SMEM_MAX})")
    return b, hq, d, hkv, g


def _decode_attention_paged_cuda(q, k_arena, v_arena, tables, lens,
                                 kv_scales=None):
    b, hq, d, hkv, g = _check_operands(q, k_arena, v_arena, tables, lens,
                                       kv_scales)
    out = torch.empty_like(q)
    if b == 0:
        return out.reshape(b, hq * d)
    geometry = (b, hkv, g, d, k_arena.shape[1], tables.shape[1],
                k_arena.shape[0], 1.0 / math.sqrt(d), _DTYPES[q.dtype],
                _build.stream_ptr(q))
    if kv_scales is None:
        KERNEL.launch(
            _build.ptr(q), _build.ptr(k_arena), _build.ptr(v_arena),
            _build.ptr(tables), _build.ptr(lens), _build.ptr(out), *geometry)
    else:
        KERNEL_INT8.launch(
            _build.ptr(q), _build.ptr(k_arena), _build.ptr(v_arena),
            _build.ptr(kv_scales[0]), _build.ptr(kv_scales[1]),
            _build.ptr(tables), _build.ptr(lens), _build.ptr(out), *geometry)
    return out.reshape(b, hq * d)


def decode_attention_paged(q, k_arena, v_arena, tables, lens,
                           kv_scales=None):
    """One-token GQA attention over a PAGED cache prefix.

    q: [B, H_q, D]; arenas: ``paged_arena_shape`` pools (packed
    [NB+1, L, H_kv*D] or unpacked [NB+1, L, H_kv, D], last row = trash
    block); tables: [B, max_blocks] int32 arena row per logical block;
    lens: [B] int32 = index of the LAST valid slot; kv_scales: None for
    a float cache, or the int8 cache's ``(k_scales, v_scales)`` pair of
    [NB+1, L, H_kv] f32 planes.  Returns [B, H_q * D] in q.dtype.  CUDA
    tensors launch the float or the int8 kernel; CPU tensors run
    ``decode_attention_paged_plain``."""
    if q.device.type == "cuda":
        return _decode_attention_paged_cuda(q, k_arena, v_arena, tables,
                                            lens, kv_scales)
    if q.device.type == "cpu":
        return decode_attention_paged_plain(q, k_arena, v_arena, tables,
                                            lens, kv_scales)
    raise ValueError(f"decode_attention_paged: unsupported device {q.device}")


def decode_attention_paged_multi_plain(q, k_arena, v_arena, tables, lens,
                                       kv_scales=None):
    """``_paged_multi_xla``: each row's dense (dequantized, for an int8
    cache) view plus fp32 logits and softmax, query c masked to slots
    ``<= lens[b] + c``, probabilities cast to q's dtype before PV.
    q: [B, C, H_q, D]; returns [B, C, H_q, D] in q.dtype."""
    b, cc, hq, d = q.shape
    kd, vd = _dense_views(k_arena, v_arena, tables, kv_scales, q.dtype)
    s = kd.shape[1]
    hkv = kd[0, 0].numel() // d
    kd = kd.reshape(b, s, hkv, d)
    vd = vd.reshape(b, s, hkv, d)
    g = hq // hkv
    q5 = q.reshape(b, cc, hkv, g, d)
    logits = torch.einsum("bckgd,bskd->bckgs", q5.float(), kd.float())
    logits = logits / math.sqrt(d)
    pos = (lens.reshape(b, 1).long()
           + torch.arange(cc, device=q.device)[None, :])          # [B, C]
    keep = torch.arange(s, device=q.device)[None, None, :] <= pos[:, :, None]
    logits = logits.masked_fill(~keep[:, :, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bckgs,bskd->bckgd", probs, vd.to(q.dtype))
    return out.reshape(b, cc, hq, d)


def _decode_attention_paged_multi_cuda(q, k_arena, v_arena, tables, lens,
                                       kv_scales=None):
    b, hq, d, hkv, g = _check_operands(q, k_arena, v_arena, tables, lens,
                                       kv_scales)
    cc = q.shape[1]
    out = torch.empty_like(q)
    if b == 0 or cc == 0:
        return out
    blk_len, mb = k_arena.shape[1], tables.shape[1]
    bps, n_splits = verify_split_plan(mb, blk_len)
    part_acc, part_ml = verify_partials(b, cc, hkv, g, d, mb, blk_len,
                                        q.device)
    geometry = (b, cc, hkv, g, d, blk_len, mb, k_arena.shape[0], bps,
                n_splits, 1.0 / math.sqrt(d), _DTYPES[q.dtype],
                _build.stream_ptr(q))
    if kv_scales is None:
        KERNEL_MULTI.launch(
            _build.ptr(q), _build.ptr(k_arena), _build.ptr(v_arena),
            _build.ptr(tables), _build.ptr(lens), _build.ptr(out),
            _build.ptr(part_acc), _build.ptr(part_ml), *geometry)
    else:
        KERNEL_MULTI_INT8.launch(
            _build.ptr(q), _build.ptr(k_arena), _build.ptr(v_arena),
            _build.ptr(kv_scales[0]), _build.ptr(kv_scales[1]),
            _build.ptr(tables), _build.ptr(lens), _build.ptr(out),
            _build.ptr(part_acc), _build.ptr(part_ml), *geometry)
    return out


def decode_attention_paged_multi(q, k_arena, v_arena, tables, lens,
                                 kv_scales=None):
    """K-wide GQA attention over a PAGED cache prefix: the speculative
    verify forward's attention (one target forward scores the last
    emitted token plus K draft candidates).

    q: [B, C, H_q, D], query c at global slot ``lens[b] + c`` (its K/V
    scattered through the table before this read); arenas/tables/
    kv_scales as ``decode_attention_paged``; lens: [B] int32 global slot
    of the FIRST query.  Query c attends over slots ``<= lens[b] + c``,
    the prefix sequential decode would have given it.  Returns
    [B, C, H_q, D] in q.dtype.  CUDA tensors launch the float or the int8
    K-wide kernel; CPU tensors run ``decode_attention_paged_multi_plain``."""
    if q.device.type == "cuda":
        return _decode_attention_paged_multi_cuda(q, k_arena, v_arena,
                                                  tables, lens, kv_scales)
    if q.device.type == "cpu":
        return decode_attention_paged_multi_plain(q, k_arena, v_arena,
                                                  tables, lens, kv_scales)
    raise ValueError(f"decode_attention_paged_multi: unsupported device "
                     f"{q.device}")


def paged_prefix_attention(q, k_arena, v_arena, tables, start,
                           kv_scales=None):
    """Chunked-prefill attention over the paged cache: C chunk queries
    at global positions ``start + row`` attend causally over everything
    already written through the block table (prefix-cached blocks,
    earlier chunks and this chunk's own K/V, scattered before this
    read).  Plain torch math on every device, as in the JAX package (the
    ``_paged_multi_xla`` body it shares with the verify attention's
    plain version): prefill is compute-bound over the chunk, not
    cache-sweep-bound.

    q: [B, C, H_q, D]; arenas/tables/kv_scales as
    ``decode_attention_paged``; start: [B] first global position of the
    chunk.  Returns [B, C, H_q, D] in q.dtype; rows past the prompt's
    true length are garbage the caller ignores."""
    return decode_attention_paged_multi_plain(q, k_arena, v_arena, tables,
                                              start, kv_scales)


def decode_attention_plain(q, k_cache, v_cache, lens):
    """Plain version of the dense decode: the ``_decode_attention_xla``
    math.  q: [B, H_q, D]; returns [B, H_q * D] in q.dtype."""
    b, hq, d, hkv, g = _head_geometry(q, k_cache)
    out = _decode_attention_math(q.reshape(b, hkv, g, d), k_cache, v_cache,
                                 lens)
    return out.reshape(b, hq * d)


def _check_dense(q, k_cache, v_cache, lens):
    """Raise on what the dense kernel cannot take; returns (B, Hq, D,
    Hkv, G)."""
    b, hq, d, hkv, g = _head_geometry(q, k_cache)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_cache, v_cache)):
        raise RuntimeError(
            "decode attention kernel has no backward (it serves under "
            "torch.no_grad()); its output would silently drop the "
            "gradient of q, k_cache and v_cache")
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode attention kernel takes float32 or bfloat16 "
                        f"q, got {q.dtype}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype:
            raise TypeError(f"decode attention kernel needs {name} dtype == "
                            f"q dtype ({q.dtype}), got {t.dtype}")
        if t.shape != k_cache.shape:
            raise ValueError("k_cache and v_cache shapes differ")
    if k_cache.shape[0] != b or k_cache.shape[1] < 1:
        raise ValueError(f"caches must be [B, S, ...] with B={b}, S >= 1, "
                         f"got {tuple(k_cache.shape)}")
    if lens.dtype != torch.int32 or lens.shape != (b,):
        raise TypeError(f"lens must be int32 [{b}], got {lens.dtype} "
                        f"{tuple(lens.shape)}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lens", lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode attention kernel needs a contiguous "
                             f"{name}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode attention kernel needs a 16-byte "
                             f"aligned {name}")
    if d % 8:
        raise ValueError(f"decode attention kernel needs head_dim % 8 == 0, "
                         f"got {d}")
    if b > 65535 or g > 128:
        raise ValueError(f"decode attention kernel takes at most 65535 rows "
                         f"and 128 query heads per kv head, got B={b}, G={g}")
    smem = 4 * (2 * g * d + _DENSE_CHUNK * (2 * d + 1) + g * _DENSE_CHUNK
                + 3 * g)
    if smem > _SMEM_MAX:
        raise ValueError(f"decode attention kernel: G={g}, D={d} need "
                         f"{smem} bytes of shared memory (> {_SMEM_MAX})")
    return b, hq, d, hkv, g


def _decode_attention_cuda(q, k_cache, v_cache, lens):
    b, hq, d, hkv, g = _check_dense(q, k_cache, v_cache, lens)
    out = torch.empty_like(q)
    if b == 0:
        return out.reshape(b, hq * d)
    KERNEL_DENSE.launch(
        _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
        _build.ptr(lens), _build.ptr(out), b, hkv, g, d, k_cache.shape[1],
        1.0 / math.sqrt(d), _DTYPES[q.dtype], _build.stream_ptr(q))
    return out.reshape(b, hq * d)


def decode_attention(q, k_cache, v_cache, lens):
    """One-token GQA attention over the valid prefix of a DENSE cache.

    q: [B, H_q, D]; k_cache/v_cache: packed [B, S, H_kv*D] or unpacked
    [B, S, H_kv, D] (``cache_shape``), any S; lens: [B] int32 = index of
    the LAST valid slot (the just-written token); slots ``<= lens``
    participate.  Returns [B, H_q * D] in q.dtype.  CUDA tensors launch
    the dense kernel; CPU tensors run ``decode_attention_plain``."""
    if q.device.type == "cuda":
        return _decode_attention_cuda(q, k_cache, v_cache, lens)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lens)
    raise ValueError(f"decode_attention: unsupported device {q.device}")
