"""Int8/int4-weight matrix product: the CUDA kernel
``csrc/quantized_matmul.cu`` (bf16 x on the tensor cores, K split over a
thread-block cluster by ``tc_split_plan``; float32 x on CUDA cores, K
split into slices by ``_num_slices``) and its plain PyTorch version.

Port of ``paddle_tpu/ops/pallas/quantized_matmul.py``: ``pack_int4`` /
``unpack_int4`` (:126-156, the split-K-halves layout byte for byte),
``dequant_view`` (:365), the plain version (the math of
``dequant_matmul_xla``, :373), ``quantized_matmul`` (:323) and the serving
entry ``routed_quantized_matmul`` (:398).

``quantized_matmul`` launches the kernel for CUDA tensors (or raises on
what it cannot take) and runs ``quantized_matmul_plain`` for CPU
tensors.  The reference's route gate is dropped, not ported: its
``max_m`` cap and ``rows_below_min`` rule (:75-99) are TPU tiling rules,
and the port's kernel tiles M and N itself, so every shape the kernel
takes goes to it.  As in the reference, the int8 form without bias or
act is differentiable in x (``_qmm`` custom_vjp :294-316; here a
``torch.autograd.Function`` whose backward is ``_qmm_bwd``'s plain
math); the int4 and fused-epilogue forms raise in grad mode when x
requires grad.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ACTS = {None: 0, "none": 0, "relu": 1, "gelu": 2, "silu": 3}
# float32 x: code rows per K slice of one CTA (csrc/quantized_matmul.cu
# kSliceRows*)
_SLICE_ROWS = {8: 256, 4: 128}
# bfloat16 x (tensor cores): code rows per mma step, the most pieces of K
# (CTAs of a cluster) and the steps for each piece
_TC_STEP = 16
_TC_MAX_PIECES = 8
_TC_MIN_STEPS = 16
# the bfloat16 route's tiles (tc_tile): warps along N (32 columns each),
# tried widest first, the fewest CTAs a launch should give the card, and
# the tile past M = 64 (mt, ng, wn, wm)
_TC_WNS = (4, 2, 1)
_TC_MIN_CTAS = 132
_TC_LARGE = (8, 2, 2, 2)

KERNEL = _build.register(_build.Kernel(
    "quantized_matmul", "ptt_quantized_matmul",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]))


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """[K, N] int8 codes in [-8, 7] -> [K//2, N] packed int8.  Split-K
    halves: packed row i carries codes[i] in the low nibble and
    codes[K//2 + i] in the high nibble.  K must be even."""
    k = codes.shape[0]
    if k % 2:
        raise ValueError(
            f"pack_int4: K ({k}) must be even to pack two codes per byte")
    half = k // 2
    lo = codes[:half].to(torch.int32) & 0xF
    hi = (codes[half:].to(torch.int32) & 0xF) << 4
    v = lo | hi                                       # 0 .. 255
    return torch.where(v > 127, v - 256, v).to(torch.int8)


def _unpack_nibbles(packed_i32):
    # sign-extend each nibble: (v ^ 8) - 8 maps 0..15 -> -8..7
    lo = ((packed_i32 & 0xF) ^ 8) - 8
    hi = (((packed_i32 >> 4) & 0xF) ^ 8) - 8
    return lo, hi


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: [K//2, N] packed int8 -> [K, N] int8."""
    lo, hi = _unpack_nibbles(packed.to(torch.int32))
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def _true_k(qweight, bits):
    return qweight.shape[0] * 2 if bits == 4 else qweight.shape[0]


def _codes(qweight, bits):
    return unpack_int4(qweight) if bits == 4 else qweight


def dequant_view(qweight, scales, bits=8, dtype=torch.float32):
    """The dequantized weight [K, N] in ``dtype``: codes x scales in
    float32 (int4 unpacked first), then cast."""
    w = _codes(qweight, bits).float() * scales.float()[None, :]
    return w.to(dtype)


def _apply_act(acc, act):
    if act is None or act == "none":
        return acc
    if act == "relu":
        return torch.clamp_min(acc, 0.0)
    if act == "gelu":
        inner = 0.7978845608028654 * (acc + 0.044715 * acc * acc * acc)
        return acc * 0.5 * (1.0 + torch.tanh(inner))
    if act == "silu":
        return acc * (1.0 / (1.0 + torch.exp(-acc)))
    raise ValueError(f"quantized_matmul: unsupported epilogue act {act!r}")


def quantized_matmul_plain(x, qweight, scales, out_dtype=None, bias=None,
                           act=None, bits=8):
    """Plain version, the kernel's math: codes upcast, an fp32
    product-sum (``x.float() @ codes.float()``: a bf16 x times an integer
    code is exact in fp32, as the reference's ``preferred_element_type=
    f32`` dot), the per-output-channel scale, bias and act as an fp32
    epilogue, then the cast.  x: [..., K]; returns [..., N]."""
    k = _true_k(qweight, bits)
    n = qweight.shape[1]
    if x.shape[-1] != k:
        raise ValueError(
            f"quantized_matmul: x last dim ({x.shape[-1]}) != weight K ({k})")
    acc = x.reshape(-1, k).float() @ _codes(qweight, bits).float()
    acc = acc * scales.float()[None, :]
    if bias is not None:
        acc = acc + bias.float()[None, :]
    acc = _apply_act(acc, act)
    return acc.to(out_dtype or x.dtype).reshape(tuple(x.shape[:-1]) + (n,))


def _num_slices(k, bits):
    """K slices of the float32 route: ceil(code rows / slice rows)."""
    rows = k // 2 if bits == 4 else k
    return -(-rows // _SLICE_ROWS[bits])


def tc_split_plan(k, bits):
    """(pieces, code rows a piece) of the bfloat16 route: the code rows (K,
    or K/2 packed int4 rows) in mma steps of 16, cut into at most 8 pieces
    and no more than one for each 16 steps, piece p covering rows
    [p * rows_a_piece, (p + 1) * rows_a_piece).  Each piece is one mma chain
    over its steps in ascending order, and the pieces are summed in order
    0..P-1, so an output element's summation order is a function of K and
    bits alone, never of M, N or the card."""
    rows = k // 2 if bits == 4 else k
    steps = -(-rows // _TC_STEP)
    pieces = min(_TC_MAX_PIECES, max(1, -(-steps // _TC_MIN_STEPS)))
    return pieces, -(-steps // pieces) * _TC_STEP


def tc_tile(m, n, pieces):
    """(mt, ng, wn, wm) of the bfloat16 route's CTA tile: a warp holds
    ``mt`` n8 tiles of x rows and ``ng`` groups of 32 columns, ``wn`` warps
    along N, ``wm`` along M.  Up to M = 64 one m tile of ceil(M / 8) n8
    tiles, one group a warp and the most warps along N that still give
    the card a CTA per SM; past it 128 x 128 tiles of four warps of 64
    columns x 64 rows.  The tile only places the work: the summation
    order is ``tc_split_plan``'s, so a row's bits do not depend on it."""
    if m > 64:
        return _TC_LARGE
    mt = -(-m // 8)
    for wn in _TC_WNS:
        if -(-n // (32 * wn)) * pieces >= _TC_MIN_CTAS or wn == 1:
            return mt, 1, wn, 1


def _tile_code(tile):
    """The C entry's encoding of a tile (mt, ng, wn, wm)."""
    mt, ng, wn, wm = tile
    return mt + 16 * ng + 256 * wn + 4096 * wm


def _check_operands(x2, qweight, scales, out_dtype, bias, act, bits):
    """Raise on what the kernel cannot take; returns (M, K, N)."""
    if bits not in (8, 4):
        raise ValueError(f"quantized_matmul: bits must be 8 or 4, got {bits}")
    if act not in ACTS:
        raise ValueError(f"quantized_matmul: unsupported epilogue act {act!r}")
    if x2.dtype not in _DTYPES:
        raise TypeError(f"quantized_matmul kernel takes float32 or bfloat16 "
                        f"x, got {x2.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"quantized_matmul kernel writes float32 or bfloat16, "
                        f"got {out_dtype}")
    if out_dtype != x2.dtype:
        raise TypeError(f"quantized_matmul kernel writes x's dtype "
                        f"({x2.dtype}), got out_dtype {out_dtype}")
    if qweight.dtype != torch.int8:
        raise TypeError(f"quantized_matmul kernel needs int8 codes, got "
                        f"{qweight.dtype}")
    if x2.ndim != 2 or qweight.ndim != 2:
        raise ValueError("quantized_matmul kernel needs x [M, K] and codes "
                         "[K, N] (or [K//2, N] packed int4)")
    m, k = x2.shape
    n = qweight.shape[1]
    if _true_k(qweight, bits) != k:
        raise ValueError(f"quantized_matmul: x last dim ({k}) != weight K "
                         f"({_true_k(qweight, bits)})")
    if n % 8:
        raise ValueError(f"quantized_matmul kernel needs N % 8 == 0, got {n}")
    if x2.dtype == torch.bfloat16:
        kmul = 32 if bits == 4 else 16
        if n % 16 or k % kmul:
            raise ValueError(f"quantized_matmul tensor-core kernel (bf16 x) "
                             f"needs N % 16 == 0 and K % {kmul} == 0 "
                             f"(int{bits}), got N={n} K={k}")
    if m > (1 << 31) - 1 or n // 256 + 1 > 65535 \
            or _num_slices(k, bits) > 65535:
        raise ValueError(f"quantized_matmul kernel: shape M={m} K={k} N={n} "
                         f"is past its grid limits")
    planes = [("scales", scales)] + ([("bias", bias)] if bias is not None
                                     else [])
    for name, t in planes:
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"quantized_matmul kernel needs float32 {name} "
                             f"of shape ({n},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in [("x", x2), ("codes", qweight)] + planes:
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"quantized_matmul kernel needs a contiguous "
                             f"{name}")
        if t.data_ptr() % 16:
            raise ValueError(f"quantized_matmul kernel needs a 16-byte "
                             f"aligned {name}")
    return m, k, n


def _qmm_cuda(x2, qweight, scales, out_dtype, bias, act, bits):
    m, k, n = _check_operands(x2, qweight, scales, out_dtype, bias, act,
                              bits)
    y = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    if m == 0:
        return y
    if x2.dtype == torch.bfloat16:     # one launch, no scratch
        split, piece_rows = tc_split_plan(k, bits)
        tile = _tile_code(tc_tile(m, n, split))
        part = None
    else:
        split, piece_rows, tile = _num_slices(k, bits), 0, 0
        part = torch.empty((split * m * n,), dtype=torch.float32,
                           device=x2.device)
    KERNEL.launch(
        _build.ptr(x2), _build.ptr(qweight), _build.ptr(scales),
        ctypes.c_void_p(None if bias is None else bias.data_ptr()),
        _build.ptr(y), ctypes.c_void_p(None if part is None
                                       else part.data_ptr()),
        m, k, n, bits, ACTS[act], split, piece_rows, tile,
        _DTYPES[x2.dtype], _build.stream_ptr(x2))
    return y


def _qmm_dispatch(x2, qweight, scales, out_dtype, bias, act, bits):
    if x2.device.type == "cuda":
        return _qmm_cuda(x2, qweight, scales, out_dtype, bias, act, bits)
    if x2.device.type == "cpu":
        return quantized_matmul_plain(x2, qweight, scales, out_dtype, bias,
                                      act, bits)
    raise ValueError(f"quantized_matmul: unsupported device {x2.device}")


class _QMM(torch.autograd.Function):
    """The int8 form without bias or act, differentiable in x: backward
    ``dx = g @ (codes * scale)^T`` in fp32, cast to x's dtype (the
    reference's ``_qmm_bwd``, plain math there too); codes and scales
    take no gradient."""

    @staticmethod
    def forward(ctx, x2, qweight, scales, out_dtype):
        ctx.save_for_backward(qweight, scales)
        ctx.x_dtype = x2.dtype
        return _qmm_dispatch(x2, qweight, scales, out_dtype, None, None, 8)

    @staticmethod
    def backward(ctx, g):
        qweight, scales = ctx.saved_tensors
        w = qweight.float() * scales.float()[None, :]
        return (g.float() @ w.t()).to(ctx.x_dtype), None, None, None


def quantized_matmul(x, qweight, scales, out_dtype=None, bias=None,
                     act=None, bits=8):
    """x: [..., K] float; qweight: [K, N] int8 (or [K//2, N] packed int4
    with ``bits=4``); scales: [N] f32; bias: [N] f32 or None; act: None,
    "relu", "gelu" (tanh form), "silu".  Returns ``act(x @ codes * scales
    [+ bias])`` as [..., N] in ``out_dtype`` (default x's dtype).  CUDA
    tensors launch the kernel; CPU tensors run the plain version."""
    k = _true_k(qweight, bits)
    n = qweight.shape[1]
    if x.shape[-1] != k:
        raise ValueError(
            f"quantized_matmul: x last dim ({x.shape[-1]}) != weight K ({k})")
    out_dtype = out_dtype or x.dtype
    x2 = x.reshape(-1, k)
    scales = scales.float()
    bias = None if bias is None else bias.float()
    needs_grad = torch.is_grad_enabled() and x.requires_grad
    if needs_grad and bits == 8 and bias is None and act is None:
        y = _QMM.apply(x2, qweight, scales, out_dtype)
    else:
        if needs_grad:
            raise RuntimeError(
                "quantized_matmul: only the int8 form without bias or act "
                "is differentiable (as in the reference); the int4 and "
                "fused-epilogue forms are inference-only")
        y = _qmm_dispatch(x2, qweight, scales, out_dtype, bias, act, bits)
    return y.reshape(tuple(x.shape[:-1]) + (n,))


def routed_quantized_matmul(x, qweight, scales, bits=8, out_dtype=None,
                            bias=None):
    """The serving engine's entry (``wq_linear``): ``quantized_matmul``
    with the reference's signature minus the route gate's ``max_m`` and
    ``require_flag`` (the kernel takes every M; see the module note)."""
    return quantized_matmul(x, qweight, scales, out_dtype=out_dtype,
                            bias=bias, bits=bits)

