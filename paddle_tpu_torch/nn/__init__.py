"""Layers and functionals of the port."""

from .norm import RMSNorm  # noqa: F401
