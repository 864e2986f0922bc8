"""The framework surface of the port: so far ``io`` (``save``,
``load``)."""

from .io import load, save  # noqa: F401
