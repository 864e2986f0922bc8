"""Incubating functionals (``paddle_tpu/incubate/nn``)."""

from . import functional  # noqa: F401
