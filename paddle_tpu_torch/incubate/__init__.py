"""Incubating functionals of the port (``paddle_tpu/incubate``)."""

from . import nn  # noqa: F401
