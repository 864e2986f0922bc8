"""``paddle.static`` of the port (port of ``paddle_tpu/static/__init__.py``).

- Program capture: ``data`` + ``program_guard`` + ``Executor`` +
  ``append_backward`` (``program.py``), the build-program-then-run
  workflow, replayed on the card.
- The control-flow ops ``cond``/``while_loop``/``case``/``switch_case``
  (``control_flow.py``), lowered to ``torch.cond``/``while_loop`` when
  ``jit.save`` exports them.
- The jit bridge: ``InputSpec`` and ``save/load_inference_model`` over
  ``jit.save``/``jit.load`` artifacts (the deployment path), and the
  static quantization namespace (``static.quantization``).
"""

from ..jit.api import InputSpec
from ..jit.api import load as _jit_load
from ..jit.api import save as _jit_save
from . import nn  # noqa: F401
from . import quantization  # noqa: F401
from .control_flow import case, cond, switch_case, while_loop  # noqa: F401
from .program import (  # noqa: F401
    Executor, Program, append_backward, data, default_main_program,
    default_startup_program, global_scope, program_guard,
)

__all__ = [
    "InputSpec", "save_inference_model", "load_inference_model",
    "Program", "program_guard", "data", "Executor", "append_backward",
    "default_main_program", "default_startup_program", "global_scope", "nn",
    "cond", "while_loop", "case", "switch_case",
]


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         **kwargs):
    """``jit.save`` of ``program=`` (a Layer or callable) at the feed
    variables' shapes and dtypes."""
    program = kwargs.get("program")
    if program is None:
        raise ValueError(
            "save_inference_model requires program=<Layer or callable>; "
            "in this framework an inference program is a traced callable")
    specs = [InputSpec(tuple(v.shape), v.dtype) for v in feed_vars]
    _jit_save(program, path_prefix, input_spec=specs)


def load_inference_model(path_prefix, executor=None, **kwargs):
    """``jit.load`` of the artifact, on the card (or on ``device="cpu"``)."""
    return _jit_load(path_prefix, **kwargs)
