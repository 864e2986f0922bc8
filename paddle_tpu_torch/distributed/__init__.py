"""Distributed utilities of the port: ``recompute`` and
``recompute_sequential``, and the process's rank and world size
(``get_rank``, ``get_world_size``)."""

from .env import get_rank, get_world_size  # noqa: F401
from .utils import recompute, recompute_sequential  # noqa: F401
