"""Automatic mixed precision of the port (``paddle_tpu/amp``).

``auto_cast`` sets a per-op dtype rule that the port's ops consult at
their call sites (``auto_cast.cast``); the white and black op lists are
the JAX package's.  ``GradScaler`` is dynamic loss scaling with the
found-inf skip.
"""

from . import debugging  # noqa: F401
from .auto_cast import (amp_decorate, amp_guard, auto_cast,  # noqa: F401
                        black_list, decorate, white_list)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401

__all__ = ["auto_cast", "amp_guard", "decorate", "amp_decorate",
           "GradScaler", "AmpScaler", "white_list", "black_list",
           "debugging"]
