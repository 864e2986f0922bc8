"""Distributed utilities of the port (so far ``recompute`` and
``recompute_sequential``)."""

from .utils import recompute, recompute_sequential  # noqa: F401
