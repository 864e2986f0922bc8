"""RMSNorm: the CUDA forward kernel ``csrc/rms_norm.cu``, its plain
PyTorch version, and the autograd Function over both.

Port of ``paddle_tpu/ops/pallas/rms_norm.py`` (``_fwd_kernel`` :63,
``_rms_fwd_impl`` :70, the ``_rms`` custom_vjp :87-111, ``rms_norm``
:114).  The arithmetic is the JAX package's, kernel and XLA fallback
alike (``nn/functional/norm.py:59-65``): ``y = x * rsqrt(mean(x^2) + eps)
* w`` per row in fp32, cast back to x's dtype.  The backward is
``_rms_bwd``'s row-local math (:98-108) in plain torch on both devices,
as it is XLA (not a kernel) in the JAX package; it saves only (x, w) and
recomputes the row statistic.

``rms_norm`` takes the kernel for a CUDA tensor and the plain version for
a CPU tensor, and nothing else: there is no switch that sends a CUDA
tensor to the plain version, and a CUDA tensor the kernel cannot take
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = _build.register(_build.Kernel(
    "rms_norm", "ptt_rms_norm_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]))


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
    """Raise on what the kernel cannot take; returns the row count."""
    d = x.shape[-1]
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
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm kernel needs contiguous x and weight")
    if x.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("rms_norm kernel needs 16-byte aligned x and weight")
    n = x.numel() // d
    if n >= 2 ** 31:
        raise ValueError(f"rms_norm kernel takes < 2**31 rows, got {n}")
    return n


def _rms_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                   epsilon: float) -> torch.Tensor:
    n = _check_operands(x, weight)
    d = x.shape[-1]
    y = torch.empty_like(x)
    if n == 0:
        return y
    KERNEL.launch(_build.ptr(x), _build.ptr(weight), _build.ptr(y), n, d,
                  float(epsilon), _DTYPES[x.dtype], _build.stream_ptr(x))
    return y


def _rms_norm_fwd(x, weight, epsilon):
    if x.device.type == "cuda":
        return _rms_norm_cuda(x, weight, epsilon)
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, epsilon)
    raise ValueError(f"rms_norm: unsupported device {x.device}")


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


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, epsilon):
        ctx.save_for_backward(x, weight)
        ctx.epsilon = epsilon
        return _rms_norm_fwd(x, weight, epsilon)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, g, ctx.epsilon)
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """x: [..., d]; weight: [d].  CUDA tensors run the kernel (or
    raise); CPU tensors run ``rms_norm_plain``.  Differentiable in x and
    weight through ``rms_norm_bwd``."""
    return _RMSNorm.apply(x, weight, float(epsilon))
