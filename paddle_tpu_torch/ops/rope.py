"""Half-split RoPE: the CUDA kernel ``csrc/rope.cu``, its plain PyTorch
version, and the dispatcher op over both.

Port of ``paddle_tpu/ops/pallas/rope.py`` (``_rope_kernel`` :41,
``_rope_call`` :58, ``apply_rope`` custom_vjp :84-100).  The arithmetic is
the kernel's: ``y1 = x1*cos - x2*sin``, ``y2 = x2*cos + x1*sin`` in fp32
over the halves ``x = [x1 | x2]``, cast back to x's dtype.  The backward
is the same rotation with ``-sin`` (rotations are orthogonal), as
``_rope_bwd`` (:94-97) does; on the card it is the same kernel again.

``apply_rope`` is the dispatcher op ``paddle_tpu_torch::apply_rope``
(``_dispatch.kernel_op``), so an exported graph (``jit.save``) holds the
op, not the branch that picked the route.  Its CUDA body launches the
kernel (or raises on what it cannot take) and its CPU body runs
``apply_rope_plain``, chosen by the dispatcher from the tensor's device;
nothing sends a CUDA tensor to the plain version.  Its gradient is the
same op with the opposite sign.  The TPU gates (``D >= 64``, VMEM
blocks, :22-38) are tiling rules of that chip and are not carried over:
the kernel takes any even D, 16 bytes an access where
``(D/2) % vec == 0`` (the vector route) and one element an
access otherwise (the element route); ``rope_plan`` says which and how
the work is cut.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import _build
from ._dispatch import kernel_op

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = _build.register(_build.Kernel(
    "rope", "ptt_rope",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]))

# threads a CTA aims at
_CTA_THREADS = 256


class RopePlan(NamedTuple):
    """How ``csrc/rope.cu`` cuts x [B, S, H, D]: a thread owns ``vec``
    consecutive rotation pairs of one head at one position and walks the
    B rows of that (s, h).  A CTA is ``px`` threads over a head's
    ``(D/2) / vec`` pair groups (looping where there are more), times
    ``hb`` heads, times ``sy`` positions; the grid is ``grid`` = (ceil(S /
    sy), ceil(H / hb))."""
    vec: int
    px: int
    hb: int
    sy: int
    grid: Tuple[int, int]


def rope_plan(b: int, s: int, h: int, d: int, dtype: torch.dtype,
              aligned: bool = True) -> RopePlan:
    """The vector route (``vec`` = 16 bytes of ``dtype``) where ``(D/2) %
    vec == 0`` and the operands are 16-byte ``aligned``, else the element
    route (``vec`` = 1)."""
    half = d // 2
    vec = 16 // dtype.itemsize
    if half % vec or not aligned:
        vec = 1
    px = min(half // vec, _CTA_THREADS)
    hb = min(h, max(1, _CTA_THREADS // px))
    sy = min(64, max(1, _CTA_THREADS // (px * hb)))
    return RopePlan(vec, px, hb, sy, (-(-s // sy), -(-h // hb)))


def _check_tables(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: [B, S, H, D] with even D; cos/sin: [1, S, 1, D/2]."""
    if x.ndim != 4 or x.shape[-1] % 2:
        raise ValueError(f"apply_rope: x must be [B, S, H, D] with even D, "
                         f"got shape {tuple(x.shape)}")
    want = (1, x.shape[1], 1, x.shape[-1] // 2)
    for name, t in (("cos", cos), ("sin", sin)):
        if tuple(t.shape) != want:
            raise ValueError(f"apply_rope: {name} must be {want}, got "
                             f"{tuple(t.shape)}")


def apply_rope_plain(x: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor) -> torch.Tensor:
    """Reference math on any device: the half-split rotation in fp32
    (float64 stays float64), cast back to ``x.dtype``."""
    _check_tables(x, cos, sin)
    ct = torch.promote_types(x.dtype, torch.float32)
    d = x.shape[-1]
    xf = x.to(ct)
    c, s = cos.to(ct), sin.to(ct)
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def _check_operands(x, cos, sin):
    """Raise on what the kernel cannot take."""
    _check_tables(x, cos, sin)
    if x.dtype not in _DTYPES:
        raise TypeError(f"rope kernel takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32:
            raise TypeError(f"rope kernel takes float32 {name}, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"rope: {name} on {t.device}, x on {x.device}")
    b, s, h, _ = x.shape
    if max(b, s, h) >= 2 ** 31:
        raise ValueError(f"rope kernel takes B, S, H < 2**31, got {b}, {s}, "
                         f"{h}")


def _rope_cuda(x, cos, sin, sign: float):
    _check_operands(x, cos, sin)
    x = x.contiguous()
    b, s, h, d = x.shape
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    c = cos.reshape(s, d // 2).contiguous()
    sn = sin.reshape(s, d // 2).contiguous()
    ptrs = [t.data_ptr() for t in (x, c, sn, y)]
    plan = rope_plan(b, s, h, d, x.dtype,
                     aligned=not any(p % 16 for p in ptrs))
    if plan.grid[1] > 65535:
        raise ValueError(f"rope kernel: {h} heads need {plan.grid[1]} "
                         f"head tiles, more than 65535")
    KERNEL.launch(*ptrs, b, s, h, d, float(sign), _DTYPES[x.dtype],
                  plan.vec, plan.px, plan.hb, plan.sy, _build.stream_ptr(x))
    return y


def _rope_cpu(x, cos, sin, sign: float):
    return apply_rope_plain(x, cos, sin if sign > 0 else -sin)


def _setup_context(ctx, inputs, output):
    _x, cos, sin, sign = inputs
    ctx.save_for_backward(cos, sin)
    ctx.sign = sign


def _backward(ctx, g):
    cos, sin = ctx.saved_tensors
    return rope_op(g, cos, sin, -ctx.sign), None, None, None


# The rotation by ``sign`` * theta: the kernel for CUDA tensors, the
# plain version for CPU tensors.
rope_op = kernel_op(
    "apply_rope", "(Tensor x, Tensor cos, Tensor sin, float sign) -> Tensor",
    cuda=_rope_cuda, cpu=_rope_cpu,
    fake=lambda x, cos, sin, sign: x.new_empty(x.shape),
    setup_context=_setup_context, backward=_backward)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [1, S, 1, D/2] fp32 (half-split
    convention).  Differentiable in x; the tables get no gradient, as in
    the JAX package."""
    return rope_op(x, cos, sin, 1.0)
