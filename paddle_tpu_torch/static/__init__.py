"""``paddle.static`` of the port: ``InputSpec`` and the static
quantization namespace (``static.quantization``: ``quant_post_static``
and the reference's aliases); the rest is ROADMAP.md, Queue 1, item
13."""

from ..jit.api import InputSpec  # noqa: F401
from . import quantization  # noqa: F401
