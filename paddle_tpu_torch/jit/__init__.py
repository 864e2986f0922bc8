"""The compiled-step surface of the port: ``TrainStep``, and
``InputSpec``."""

from .api import InputSpec  # noqa: F401
from .train_step import TrainStep  # noqa: F401
