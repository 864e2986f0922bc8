"""Kernels of the port and their plain PyTorch versions."""

from . import decode_attention, rms_norm  # noqa: F401  (registers KERNELS)
from ._build import KERNELS, build_all  # noqa: F401
