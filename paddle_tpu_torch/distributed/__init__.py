"""Distributed utilities of the port (so far only ``recompute``)."""

from .utils import recompute  # noqa: F401
