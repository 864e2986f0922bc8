"""``paddle_tpu_torch.jit``: ``to_static`` (eager, dy2static-converted),
``save``/``load`` over ``torch.export`` programs, ``TranslatedLayer``,
``TrainStep``, the shape-bucketing helpers and ``InputSpec``."""

from .api import (InputSpec, TranslatedLayer, ignore_module,  # noqa: F401
                  load, not_to_static, save, to_static)
from .bucketing import (BucketedFunction, bucketed,  # noqa: F401
                        default_buckets, pad_to_bucket)
from .train_step import TrainStep  # noqa: F401

__all__ = ["to_static", "not_to_static", "ignore_module", "save", "load",
           "TranslatedLayer", "TrainStep", "BucketedFunction", "bucketed",
           "default_buckets", "pad_to_bucket"]
