"""Core state of the port: the flag registry and the key generator."""

from . import flags, generator  # noqa: F401
