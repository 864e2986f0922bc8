"""Kernels of the port and their plain PyTorch versions."""

from . import (decode_attention, flash_attention, rms_norm,  # noqa: F401
               rope)  # (each registers its KERNELS)
from ._build import KERNELS, build_all  # noqa: F401
