"""The vision package of the port (``paddle_tpu/vision``): the model zoo
(``models``), the datasets and transforms (numpy, as the reference's)
and the detection ops (``ops``)."""

from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import ops  # noqa: F401
from . import transforms  # noqa: F401
