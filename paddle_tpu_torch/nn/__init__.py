"""Layers and functionals of the port."""

from . import functional  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_, clip_grad_value_)
from .norm import RMSNorm  # noqa: F401
