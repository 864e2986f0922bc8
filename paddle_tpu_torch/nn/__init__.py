"""Layers and functionals of the port."""

from .clip import ClipGradByGlobalNorm  # noqa: F401
from .norm import RMSNorm  # noqa: F401
