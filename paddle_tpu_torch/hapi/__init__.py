"""paddle_tpu_torch.hapi: the high-level ``Model`` API (port of
``paddle_tpu/hapi``), with its callbacks, ``summary`` and ``flops``."""

from . import callbacks  # noqa: F401
from .dynamic_flops import flops  # noqa: F401
from .model import Model  # noqa: F401
from .model_summary import summary  # noqa: F401

__all__ = ["Model", "callbacks", "summary", "flops"]
