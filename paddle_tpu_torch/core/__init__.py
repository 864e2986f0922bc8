"""Core of the port: the flag registry and the key generator, and the
tensor facade's modules (``tensor``, ``tape``, ``dispatch``, ``dtypes``,
``device``, ``errors``, ``pytree``), imported where used."""

from . import flags, generator  # noqa: F401
