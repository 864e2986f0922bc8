"""``paddle.static`` of the port: so far ``InputSpec`` (the rest is
ROADMAP.md, Queue 1, item 13)."""

from ..jit.api import InputSpec  # noqa: F401
