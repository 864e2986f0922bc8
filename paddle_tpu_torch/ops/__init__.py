"""Kernels of the port and their plain PyTorch versions."""

from . import (decode_attention, flash_attention,  # noqa: F401
               fused_optimizer, quantized_matmul, rms_norm,
               rope)  # (each registers its KERNELS)
from ._build import KERNELS, build_all  # noqa: F401
