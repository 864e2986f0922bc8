"""RMSNorm: the CUDA forward kernel ``csrc/rms_norm.cu``, its plain
PyTorch version, and the dispatcher op over both.

Port of ``paddle_tpu/ops/pallas/rms_norm.py`` (``_fwd_kernel`` :63,
``_rms_fwd_impl`` :70, the ``_rms`` custom_vjp :87-111, ``rms_norm``
:114).  The arithmetic is the JAX package's, kernel and XLA fallback
alike (``nn/functional/norm.py:59-65``): ``y = x * rsqrt(mean(x^2) + eps)
* w`` per row in fp32, cast back to x's dtype.  The backward is
``_rms_bwd``'s row-local math (:98-108) in plain torch on both devices,
as it is XLA (not a kernel) in the JAX package; it saves only (x, w) and
recomputes the row statistic.

``rms_norm`` is the dispatcher op ``paddle_tpu_torch::rms_norm``
(``_dispatch.kernel_op``), so a traced or exported graph (``jit.save``)
holds the op itself, not the branch that picked the route, and a
selective-checkpoint policy sees it.  Its CUDA body is the kernel and
its CPU body the plain version, chosen by the dispatcher from the
tensor's device, and nothing else: there is no switch that sends a CUDA
tensor to the plain version, and a CUDA tensor the kernel cannot take
raises.  Its gradient is ``rms_norm_bwd``; where nothing needs a
gradient the op runs the forward without recording one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from ._dispatch import kernel_op

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = _build.register(_build.Kernel(
    "rms_norm", "ptt_rms_norm_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p]))

# warps a row at most (the kernel's limit); 16-byte vectors a lane before
# the plan takes another warp; vectors a lane at most (the kernel's limit)
_MAX_WARPS, _VECS, _MAX_VECS = 16, 2, 8


class RmsNormPlan(NamedTuple):
    """How ``csrc/rms_norm.cu`` reduces a row of d elements: a CTA of
    ``warps`` warps holds it, lane l of warp q the 16-byte vectors ``(k *
    warps + q) * 32 + l`` for k < ``vecs`` (those below ``d / vec``),
    ``vec`` elements a vector.  The sum of squares runs in that order:
    each lane keeps one fp32 fma chain per element position j over its
    vectors k, adds the ``vec`` chains in a pairwise tree ((0+1)+(2+3))
    + ..., a butterfly of xor shuffles (16, 8, 4, 2, 1) sums the 32 lanes,
    then the warps' sums are added in order 0 .. warps-1.  The row count
    is only the number of CTAs."""
    warps: int
    vecs: int
    vec: int


@functools.lru_cache(maxsize=None)
def rms_norm_plan(d: int, dtype: torch.dtype) -> RmsNormPlan:
    """The fewest warps that hold a row of ``d`` elements of ``dtype`` at
    no more than 2 vectors a lane (at most 16 warps, then up to 8 vectors
    a lane), and the vectors a lane then takes: d = 2048 bf16, 4 warps;
    d = 4096 bf16, 8 warps (2 vectors a lane each).  Two vectors a lane
    gave the shortest decode launch on the H100 (``PERF.md``)."""
    vec = 16 // dtype.itemsize
    nvec = d // vec
    warps = min(_MAX_WARPS, max(1, -(-nvec // (32 * _VECS))))
    return RmsNormPlan(warps, max(1, -(-nvec // (32 * warps))), vec)


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                   epsilon: float = 1e-6) -> torch.Tensor:
    """Reference math on any device: fp32 mean of squares, rsqrt, scale
    by the fp32 weight, cast back to ``x.dtype`` (float64 stays
    float64)."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct)
    rrms = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + epsilon)
    return (xf * rrms * weight.to(ct)).to(x.dtype)


def _check_operands(x: torch.Tensor, weight: torch.Tensor) -> int:
    """Raise on what the kernel cannot take; returns the row count.  One
    test of all the kernel needs; ``_refuse`` says what failed."""
    d = x.shape[-1]
    n = x.numel() // d if d else 0
    if not (x.dtype in _DTYPES and weight.dtype == x.dtype
            and weight.get_device() == x.get_device()
            and weight.shape == (d,) and d % 8 == 0
            and d * x.element_size() <= 512 * _MAX_WARPS * _MAX_VECS
            and x.is_contiguous() and weight.is_contiguous()
            and not (x.data_ptr() | weight.data_ptr()) % 16
            and n < 2 ** 31):
        _refuse(x, weight, d, n)
    return n


def _refuse(x, weight, d, n):
    if x.dtype not in _DTYPES:
        raise TypeError(f"rms_norm kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if weight.dtype != x.dtype:
        raise TypeError(f"rms_norm kernel needs weight dtype == x dtype, "
                        f"got {weight.dtype} vs {x.dtype}")
    if weight.device != x.device:
        raise ValueError(f"rms_norm: weight on {weight.device}, x on "
                         f"{x.device}")
    if weight.shape != (d,):
        raise ValueError(f"rms_norm: weight shape {tuple(weight.shape)} != "
                         f"({d},)")
    if d % 8 != 0:
        raise ValueError(f"rms_norm kernel needs the row width d % 8 == 0, "
                         f"got d={d}")
    if d * x.element_size() > 512 * _MAX_WARPS * _MAX_VECS:
        raise ValueError(f"rms_norm kernel holds rows of at most "
                         f"{32 * _MAX_WARPS * _MAX_VECS} 16-byte vectors, "
                         f"got d={d} in {x.dtype}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm kernel needs contiguous x and weight")
    if x.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("rms_norm kernel needs 16-byte aligned x and weight")
    raise ValueError(f"rms_norm kernel takes < 2**31 rows, got {n}")


def _rms_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                   epsilon: float) -> torch.Tensor:
    n = _check_operands(x, weight)
    y = torch.empty_like(x)
    if n == 0:
        return y
    d = x.shape[-1]
    plan = rms_norm_plan(d, x.dtype)
    KERNEL.launch(x.data_ptr(), weight.data_ptr(), y.data_ptr(), n, d,
                  epsilon, _DTYPES[x.dtype], plan.warps, plan.vecs,
                  _build.stream_ptr(x))
    return y


def _rms_norm_cpu(x, weight, epsilon):
    return rms_norm_plain(x, weight, epsilon)


def rms_norm_bwd(x, weight, g, epsilon):
    """``_rms_bwd``: dx and dw from the saved (x, w) and the output
    gradient, in fp32 (float64 stays float64); dx in x's dtype, dw in
    w's."""
    ct = torch.promote_types(x.dtype, torch.float32)
    d = x.shape[-1]
    xf = x.reshape(-1, d).to(ct)
    gf = g.reshape(-1, d).to(ct)
    wf = weight.to(ct)
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + epsilon)
    xhat = xf * r
    gw = gf * wf
    dx = r * (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    dw = (gf * xhat).sum(dim=0)
    return dx.reshape(x.shape).to(x.dtype), dw.to(weight.dtype)


def _setup_context(ctx, inputs, output):
    x, weight, epsilon = inputs
    ctx.save_for_backward(x, weight)
    ctx.epsilon = epsilon


def _backward(ctx, g):
    x, weight = ctx.saved_tensors
    dx, dw = rms_norm_bwd(x, weight, g, ctx.epsilon)
    return dx, dw, None


rms_norm_op = kernel_op(
    "rms_norm", "(Tensor x, Tensor weight, float epsilon) -> Tensor",
    cuda=_rms_norm_cuda, cpu=_rms_norm_cpu,
    fake=lambda x, weight, epsilon: x.new_empty(x.shape),
    setup_context=_setup_context, backward=_backward)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """x: [..., d]; weight: [d].  CUDA tensors run the kernel (or
    raise); CPU tensors run ``rms_norm_plain``.  Differentiable in x and
    weight through ``rms_norm_bwd``."""
    return rms_norm_op(x, weight, float(epsilon))
