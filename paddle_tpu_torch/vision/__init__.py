"""The vision package of the port: ``vision.models``, the JAX package's
model zoo (``paddle_tpu/vision/models``) in torch."""

from . import models  # noqa: F401
