"""RMSNorm forward: the CUDA kernel ``csrc/rms_norm.cu`` and its plain
PyTorch version.

Port of ``paddle_tpu/ops/pallas/rms_norm.py`` (``_fwd_kernel`` :63,
``_rms_fwd_impl`` :70, ``rms_norm`` :114).  The arithmetic is the JAX
package's, kernel and XLA fallback alike (``nn/functional/norm.py:59-65``):
``y = x * rsqrt(mean(x^2) + eps) * w`` per row in fp32, cast back to x's
dtype.  Only the forward is here; the backward comes with training.

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
    by the fp32 weight, cast back to ``x.dtype``."""
    xf = x.float()
    rrms = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + epsilon)
    return (xf * rrms * weight.float()).to(x.dtype)


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


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """x: [..., d]; weight: [d].  CUDA tensors run the kernel (or
    raise); CPU tensors run ``rms_norm_plain``."""
    if x.device.type == "cuda":
        return _rms_norm_cuda(x, weight, epsilon)
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, epsilon)
    raise ValueError(f"rms_norm: unsupported device {x.device}")
