"""The compiled-step surface of the port: ``TrainStep``."""

from .train_step import TrainStep  # noqa: F401
