"""``jit``'s user surface: ``InputSpec``, ``to_static``, ``not_to_static``,
``ignore_module``, ``save``, ``load`` and ``TranslatedLayer``.

Port of ``paddle_tpu/jit/api.py``.

- ``to_static`` (:42, :168) wraps a function, a method or a Layer's
  forward in a ``StaticFunction`` that runs the dy2static-converted
  function (``jit/dy2static.py``) EAGERLY, with autograd, as the port's
  ``TrainStep`` runs eagerly: there is no per-signature compiled program,
  so a parameter update is seen by the next call because every call reads
  the parameters as they are ("Known differences of jit and static",
  ROADMAP.md).
- ``save`` (:222) exports, with ``torch.export`` (non-strict), the function
  ``(param_values, *inputs)`` of the Layer's converted forward, as the
  reference exports ``pure(p_values, *inputs)``: the parameters and
  buffers are inputs of the program, so the program file holds no
  weights.  ``<prefix>.ptpu_torch_model`` is the program
  (``torch.export.save``); ``<prefix>.ptpu_params`` is a pickle in the
  reference's layout (``names``, ``values``, ``in_spec``, ``precision``)
  with every value as numpy at its exact bits (bf16 as the ``uint16``
  view, its dtype under ``dtypes``) and the port's ``format`` tag.  A
  ``None`` or ``-1`` dimension of an ``InputSpec`` becomes a dynamic
  dimension (``torch.export.Dim.DYNAMIC``).  ``precision="bfloat16"`` or
  ``"float16"`` stores the float parameters in that dtype and casts float
  inputs at the program's boundary (:268-296).  The kernels are
  dispatcher ops (``paddle_tpu_torch::rms_norm``, ``::apply_rope``,
  ``::flash_attention_fwd``, ``::quantized_matmul``), so the program
  holds them and picks the kernel or the plain version by the device it
  runs on: an artifact exported on one device runs on the other.
- ``load`` (:349) reads an artifact back as a ``TranslatedLayer`` on the
  card, or on ``device="cpu"``; the program is moved there with
  ``torch.export.passes.move_to_device_pass`` (which also rewrites the
  device of the constants the graph makes, such as an ``arange``).

Neither package loads the other's artifact: the reference's
``.ptpu_model`` is a StableHLO program, the port's a ``torch.export``
one, and each raises on the other's.
"""

from __future__ import annotations

import copy
import functools
import io
import os
import pickle
import time
from typing import List, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..device import dtype_name, resolve_device, to_dtype

PROGRAM_SUFFIX = ".ptpu_torch_model"
PARAMS_SUFFIX = ".ptpu_params"
REFERENCE_PROGRAM_SUFFIX = ".ptpu_model"
ARTIFACT_FORMAT = "paddle_tpu_torch.jit/1"
KNOWN_DIFFERENCES = 'ROADMAP.md, "Known differences of jit and static"'
_PRECISIONS = ("bfloat16", "float16")


class InputSpec:
    """Analogue of ``paddle.static.InputSpec``; ``dtype`` is a torch
    dtype (a name such as ``"float32"`` is converted)."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = to_dtype(dtype)
        self.name = name


class StaticFunction:
    """The dy2static-converted function, called eagerly (see the module
    note).  As a method decorator it binds to the instance it is read
    from."""

    def __init__(self, function, input_spec=None, build_strategy=None,
                 backend=None, full_graph=True):
        functools.update_wrapper(self, function)
        if full_graph:
            from .dy2static import convert_to_static
            function = convert_to_static(function)
        self._function = function
        self._input_spec = input_spec
        self._instance = None   # bound Layer when used as a method

    def __get__(self, instance, owner):
        if instance is None:
            return self
        bound = copy.copy(self)
        bound._instance = instance
        return bound

    @property
    def function(self):
        return self._function

    def __call__(self, *args, **kwargs):
        if self._instance is not None:
            return self._function(self._instance, *args, **kwargs)
        return self._function(*args, **kwargs)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Mirror ``paddle.jit.to_static`` (decorator or call form; a Layer's
    forward is replaced in place)."""

    def decorate(fn):
        if isinstance(fn, torch.nn.Module):
            static = StaticFunction(type(fn).forward, input_spec)
            static._instance = fn
            fn.forward = static
            return fn
        return StaticFunction(fn, input_spec)

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn=None):
    if fn is None:
        return lambda f: f
    return fn


def ignore_module(modules):
    pass


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def _program_function(layer):
    """(module whose state the program reads, or None; the converted
    function of the inputs)."""
    from .dy2static import convert_to_static
    module = layer if isinstance(layer, torch.nn.Module) else None
    fn = layer.forward if module is not None else layer
    if module is None and isinstance(getattr(fn, "__self__", None),
                                     torch.nn.Module):
        module = fn.__self__       # a Layer's bound method
    if isinstance(fn, StaticFunction):
        return module, functools.partial(fn._function, fn._instance) \
            if fn._instance is not None else fn._function
    raw = getattr(fn, "__func__", None)
    bound = getattr(fn, "__self__", None)
    if raw is not None and bound is not None:
        # bound method: convert the function and rebind self, else the
        # traced inputs would shift into the self slot
        return module, functools.partial(convert_to_static(raw), bound)
    return module, convert_to_static(fn)


def _state(module):
    """(names, tensors): the state dict, then any non-persistent buffer,
    so the program reads every tensor of the module as an input."""
    if module is None:
        return [], []
    state = dict(module.state_dict(keep_vars=True))
    for name, b in module.named_buffers():
        state.setdefault(name, b)
    return list(state), [t.detach() for t in state.values()]


class _Pure(torch.nn.Module):
    """``pure(p_values, *inputs)``: the module's state swapped for
    ``params``, the inputs cast at the boundary under ``precision``, the
    outputs flattened to a tuple."""

    def __init__(self, fn, module, names, precision):
        super().__init__()
        self._fn = fn
        self._held = [module]       # not a submodule: its state is input
        self._names = names
        self._pdt = None if precision is None else to_dtype(precision)

    def forward(self, params, *inputs):
        from torch.nn.utils.stateless import _reparametrize_module
        if self._pdt is not None:
            inputs = tuple(i.to(self._pdt) if i.is_floating_point() else i
                           for i in inputs)
        module = self._held[0]
        if module is None:
            out = self._fn(*inputs)
        else:
            with _reparametrize_module(module, dict(zip(self._names,
                                                        params)),
                                       tie_weights=True):
                out = self._fn(*inputs)
        return tuple(pytree.tree_leaves(out))


def _host_bits(t: torch.Tensor):
    from ..inference.prefixcache import host_rows
    return host_rows(t)


def _tensor_of_bits(a: np.ndarray, name: str) -> torch.Tensor:
    from ..inference.prefixcache import _BIT_VIEWS
    dt = to_dtype(name)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, copy=True)   # torch takes no read-only buffer
    view = _BIT_VIEWS.get(dt)
    if view is None:
        return torch.from_numpy(a)
    return torch.from_numpy(a.view(view[1])).view(dt)


def save(layer, path, input_spec=None, precision=None, **configs):
    """Export ``layer`` (a Layer, a Layer's bound method or a function) at
    ``input_spec`` and write ``path + ".ptpu_torch_model"`` and ``path +
    ".ptpu_params"`` (see the module note).  A Layer is put in ``eval()``
    mode first, as in the reference.  Returns ``{"export_s", "write_s",
    "bytes"}``: the seconds of the export and of writing both files, and
    their size."""
    if input_spec is None:
        raise ValueError("jit.save requires input_spec (the program's input "
                         "shapes and dtypes)")
    if precision is not None:
        precision = dtype_name(to_dtype(precision))
        if precision not in _PRECISIONS:
            raise ValueError(f"jit.save precision must be bfloat16/float16, "
                             f"got {precision!r}")
    specs = [s if isinstance(s, InputSpec) else InputSpec(s.shape, s.dtype)
             for s in input_spec]
    if isinstance(layer, torch.nn.Module):
        layer.eval()
    module, fn = _program_function(layer)
    names, values = _state(module)
    dev = values[0].device if values else torch.device("cpu")
    if precision is not None:
        pdt = to_dtype(precision)
        values = [v.to(pdt) if v.is_floating_point() else v for v in values]
    examples, dims = [], []
    for s in specs:
        dyn = {j: torch.export.Dim.DYNAMIC for j, d in enumerate(s.shape)
               if d is None or d == -1}
        shape = [2 if j in dyn else d for j, d in enumerate(s.shape)]
        examples.append(torch.zeros(shape, dtype=s.dtype, device=dev))
        dims.append(dyn or None)
    t0 = time.perf_counter()
    with torch.no_grad():
        ep = torch.export.export(
            _Pure(fn, module, names, precision), (values, *examples),
            dynamic_shapes=([None] * len(values), tuple(dims)),
            strict=False)
    t1 = time.perf_counter()
    # the example inputs are the weights themselves: the program file
    # keeps none of them
    ep.example_inputs = None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    buf = io.BytesIO()          # torch.export names its files .pt2
    torch.export.save(ep, buf)
    with open(path + PROGRAM_SUFFIX, "wb") as f:
        f.write(buf.getvalue())
    bits = [_host_bits(v) for v in values]
    with open(path + PARAMS_SUFFIX, "wb") as f:
        pickle.dump({"format": ARTIFACT_FORMAT, "names": names,
                     "values": [b for b, _ in bits],
                     "dtypes": [d for _, d in bits],
                     "in_spec": [(s.shape, dtype_name(s.dtype))
                                 for s in specs],
                     "precision": precision,
                     "exported_on": dev.type}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    return {"export_s": t1 - t0, "write_s": time.perf_counter() - t1,
            "bytes": sum(os.path.getsize(path + sfx)
                         for sfx in (PROGRAM_SUFFIX, PARAMS_SUFFIX))}


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

class Artifact:
    """A ``jit.save`` artifact read from disk: the exported program, the
    parameter names and host tensors, the input spec and the export
    precision."""

    def __init__(self, path: str):
        from .. import ops  # noqa: F401  (registers the kernels' ops)
        from ..ops import quantized_matmul, rms_norm, rope  # noqa: F401
        if not os.path.isfile(path + PROGRAM_SUFFIX):
            if os.path.isfile(path + REFERENCE_PROGRAM_SUFFIX):
                raise ValueError(
                    f"{path}{REFERENCE_PROGRAM_SUFFIX} is a paddle_tpu "
                    f"(JAX, StableHLO) artifact; paddle_tpu_torch loads "
                    f"only its own {PROGRAM_SUFFIX} programs: see "
                    f"{KNOWN_DIFFERENCES}")
            raise FileNotFoundError(f"no jit.save artifact at {path} "
                                    f"({path}{PROGRAM_SUFFIX} is missing)")
        with open(path + PARAMS_SUFFIX, "rb") as f:
            meta = pickle.load(f)
        if not isinstance(meta, dict) or \
                meta.get("format") != ARTIFACT_FORMAT:
            raise ValueError(
                f"{path}{PARAMS_SUFFIX} is not a paddle_tpu_torch "
                f"{ARTIFACT_FORMAT} parameter file (a paddle_tpu one holds "
                f"no format tag): see {KNOWN_DIFFERENCES}")
        with open(path + PROGRAM_SUFFIX, "rb") as f:
            self.program = torch.export.load(io.BytesIO(f.read()))
        self.names: List[str] = meta["names"]
        self.values = [_tensor_of_bits(a, d)
                       for a, d in zip(meta["values"], meta["dtypes"])]
        self.in_spec = [(tuple(s), to_dtype(d)) for s, d in meta["in_spec"]]
        self.precision: Optional[str] = meta["precision"]
        self.exported_on: str = meta["exported_on"]

    def placed(self, device: torch.device):
        """(the program as a callable module on ``device``, the
        parameters there)."""
        from torch.export.passes import move_to_device_pass
        ep = self.program
        if device.type != self.exported_on or device.type == "cuda":
            ep = move_to_device_pass(ep, str(device))
        return ep.module(), [v.to(device) for v in self.values]


def as_input(a, device) -> torch.Tensor:
    """A fed value (tensor, numpy array or number) as a tensor on
    ``device``."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device)


class TranslatedLayer:
    """A loaded inference program (≙ jit/translated_layer.py): the
    exported program and its weights on one device."""

    def __init__(self, artifact: Artifact, device: torch.device):
        self._artifact = artifact
        self.device = device
        self._module, self._params = artifact.placed(device)
        self._in_spec = artifact.in_spec
        self.training = False

    def __call__(self, *args):
        out = self._module(self._params,
                           *[as_input(a, self.device) for a in args])
        return out[0] if len(out) == 1 else tuple(out)

    def eval(self):
        return self

    def state_dict(self):
        return dict(zip(self._artifact.names, self._params))


def load(path, device=None, **configs) -> TranslatedLayer:
    """Read a ``jit.save`` artifact as a callable ``TranslatedLayer`` on
    the CUDA card (raises without CUDA), or on ``device="cpu"``."""
    return TranslatedLayer(Artifact(path), resolve_device(device))
