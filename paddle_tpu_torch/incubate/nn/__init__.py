"""Incubating functionals and layers (``paddle_tpu/incubate/nn``)."""

from . import functional  # noqa: F401
from .layer import FusedFeedForward, FusedMultiHeadAttention  # noqa: F401
