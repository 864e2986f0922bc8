"""paddle_tpu_torch.autograd: port of ``paddle_tpu/autograd``.

``backward``/``grad`` run torch autograd (``core.tape``); ``PyLayer``
is a ``torch.autograd.Function`` that keeps the reference's class-based
API; ``vjp``/``jvp``/``jacobian``/``hessian`` keep the reference's
return structures.
"""

from ..core.tape import backward, grad, no_grad, enable_grad, set_grad_enabled
from .py_layer import PyLayer, PyLayerContext
from .functional import jvp, vjp, jacobian, hessian

__all__ = [
    "backward", "grad", "no_grad", "enable_grad", "set_grad_enabled",
    "PyLayer", "PyLayerContext", "jvp", "vjp", "jacobian", "hessian",
]
