"""The Predictor (≙ AnalysisPredictor): port of
``paddle_tpu/inference/predictor.py``.

``Config`` names a ``jit.save`` artifact (``<prefix>.ptpu_torch_model``
and ``<prefix>.ptpu_params``); ``create_predictor`` loads it and places
the program and the weights on the card (or on the CPU after
``disable_gpu()``).  The reference compiles the loaded program once
(:248-261); here, on the card, ``run`` captures ONE CUDA graph per input
signature (shapes and dtypes) at the first run of that signature, with
the discipline of every graph of the port (``inference.llm.
CapturedGraph`` in the dense programs' shared pool: a warm-up on a side
stream, then the capture; a capture that fails raises, nothing falls
back to an eager run), and replays it after that, copying the outputs
out.  On the CPU the program runs eagerly.  Each run holds cuDNN's TF32
off, so float32 convolutions run as the eager layers run them
(``nn.functional.conv.exact_fp32``), which an exported graph cannot
carry.

``clone()`` shares the weights, the graphs and the lock.  With
``enable_memory_optim`` each predictor stages the fed inputs into device
buffers of its own, reused from feed to feed, which ``run`` copies into
the graph's input buffers under the lock; the handles are marked consumed
after the run, so a second ``run()`` on consumed handles raises, as the
reference's donated buffers do (:278-283).  A clone never writes into
another's inputs: the graph's buffers are written only under the lock.  ``set_compilation_cache_dir`` records a directory and
makes it, and nothing is compiled into it: the port compiles only its
kernels, which ``ops/_build.py`` builds ("Known differences of jit and
static", ROADMAP.md).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..jit.api import PROGRAM_SUFFIX, Artifact, as_input
from . import llm
from .llm import graphs_on


class Config:
    """≙ ``paddle_infer.Config`` (analysis_config.cc).

    - ``enable_use_gpu(device_id=)`` / ``set_device_id`` choose the card
      (the default); ``disable_gpu()`` runs on the CPU.
    - ``enable_memory_optim`` stages fed inputs into the predictor's own
      device buffers (the reference donates them to its executable).
    - ``set_compilation_cache_dir``: made, unused (see the module note).
    - precision is an EXPORT-time property: pass ``precision="bfloat16"``
      to ``jit.save``; ``Predictor.precision_mode`` reports it.
    - ``pass_builder()`` lists and deletes the predictor-level passes
      that exist (``input_donation``, ``persistent_compile_cache``);
      ``switch_ir_optim(False)`` gates them without erasing settings.
    """

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        if prog_file is not None and prog_file.endswith(PROGRAM_SUFFIX):
            self._prefix = prog_file[: -len(PROGRAM_SUFFIX)]
        else:
            self._prefix = prog_file
        self._params_file = params_file
        self._cache_dir: Optional[str] = None
        self._memory_optim = False
        self._glog_info = False
        self._device = "gpu"
        self._device_id = 0
        self._ir_optim = True
        self._math_threads = None

    def set_model(self, prefix: str, params_file: Optional[str] = None):
        self._prefix = prefix
        self._params_file = params_file

    def model_dir(self):
        return self._prefix

    def enable_memory_optim(self, flag: bool = True):
        """Stage fed inputs into the predictor's own device buffers."""
        self._memory_optim = flag

    def memory_optim_enabled(self) -> bool:
        return self._effective_memory_optim()

    # switch_ir_optim(False) gates these without erasing the settings
    def _effective_memory_optim(self) -> bool:
        return bool(self._ir_optim and self._memory_optim)

    def _effective_cache_dir(self):
        return self._cache_dir if self._ir_optim else None

    def disable_glog_info(self):
        self._glog_info = False

    def set_compilation_cache_dir(self, path: str):
        self._cache_dir = path

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0,
                       *a, **k):
        self._device = "gpu"
        self._device_id = int(device_id)

    def set_device_id(self, device_id: int):
        self._device_id = int(device_id)

    set_tpu_device_id = set_device_id

    def device_id(self) -> int:
        return self._device_id

    tpu_device_id = device_id

    def disable_gpu(self):
        self._device = "cpu"

    def _torch_device(self) -> torch.device:
        if self._device == "cpu":
            return torch.device("cpu")
        return resolve_device(f"cuda:{self._device_id}")

    def set_cpu_math_library_num_threads(self, n: int):
        self._math_threads = int(n)

    def cpu_math_library_num_threads(self) -> int:
        return self._math_threads or 1

    def switch_ir_optim(self, flag: bool = True):
        """False GATES the predictor-level passes (input staging and the
        cache directory) without destroying their settings; toggling back
        on restores them."""
        self._ir_optim = flag

    def ir_optim(self) -> bool:
        return self._ir_optim

    def delete_pass(self, name: str):
        self.pass_builder().delete_pass(name)

    def pass_builder(self):
        """The passes that exist in this serving stack, as a controllable
        registry: the fixed one (the exported program, one CUDA graph per
        input signature on the card) and the two knobs above it."""
        cfg = self

        class _PassBuilder:
            def all_passes(self):
                passes = ["torch.export:fixed-pipeline(program,"
                          "cuda-graph-per-signature)"]
                if cfg._effective_memory_optim():
                    passes.append("input_donation")
                if cfg._effective_cache_dir():
                    passes.append("persistent_compile_cache")
                return passes

            def delete_pass(self, name):
                if name == "input_donation":
                    cfg._memory_optim = False
                elif name == "persistent_compile_cache":
                    cfg._cache_dir = None
                # the fixed pipeline is not deletable; unknown names are
                # ignored like the reference

        return _PassBuilder()

    def summary(self) -> str:
        return (f"Config(model={self._prefix!r}, device={self._device}"
                f":{self._device_id}, cache_dir={self._cache_dir!r}, "
                f"memory_optim={self._memory_optim})")


class _IOHandle:
    """Tensor handle (≙ ZeroCopyTensor) on the predictor's device."""

    def __init__(self, name: str, shape, dtype, device=None, staging=False):
        self.name = name
        self._shape = tuple(shape)
        self._dtype = dtype
        self._device = device
        self._staging = staging     # reuse one device buffer across feeds
        self._buffer: Optional[torch.Tensor] = None
        self._array: Optional[torch.Tensor] = None

    def shape(self):
        return list(self._shape)

    def copy_from_cpu(self, data):
        t = as_input(data, "cpu")
        buf = self._buffer
        if not self._staging:
            self._array = t.to(self._device, copy=True)
            return
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._buffer = torch.empty(t.shape, dtype=t.dtype,
                                             device=self._device)
        buf.copy_(t)
        self._array = buf

    def share_external_data(self, array):
        """Take a tensor on the predictor's device without staging."""
        self._array = as_input(array, self._device)

    def copy_to_cpu(self) -> np.ndarray:
        if self._array is None:
            raise RuntimeError(f"output {self.name!r} not produced yet; "
                               "call predictor.run() first")
        t = self._array.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy()
        return t.numpy()

    def to_device_array(self):
        return self._array


class _Shared:
    """What clones share: the program and weights on the device, the
    graphs by input signature, the lock."""

    def __init__(self, config: Config):
        prefix = config.model_dir()
        if prefix is None:
            raise ValueError("Config has no model path")
        cache = config._effective_cache_dir()
        if cache:
            os.makedirs(cache, exist_ok=True)
        self.device = config._torch_device()
        art = Artifact(prefix)
        self.module, self.params = art.placed(self.device)
        self.in_spec = art.in_spec
        self.precision = art.precision
        self.exported_on = art.exported_on
        self.staging = bool(config._effective_memory_optim()
                            and self.in_spec)
        self.graphs: Dict[tuple, "_SignatureGraph"] = {}
        self.lock = threading.Lock()


class _SignatureGraph:
    """The program for one input signature as one CUDA graph over static
    input buffers; outputs are copied out of the graph's own buffers."""

    def __init__(self, shared: _Shared, inputs: List[torch.Tensor]):
        self.inputs = [t.clone() for t in inputs]
        module, params, static = shared.module, shared.params, self.inputs
        self.prog = llm._dense_capture(lambda: module(params, *static),
                                       shared.device)

    def run(self, inputs):
        for buf, t in zip(self.inputs, inputs):
            if t is not buf:
                buf.copy_(t)
        return [o.clone() for o in self.prog.replay()]


def _signature(tensors):
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


class Predictor:
    def __init__(self, config: Config, _shared: Optional[_Shared] = None):
        self.config = config
        self._shared = _shared if _shared is not None else _Shared(config)
        sh = self._shared
        self._inputs: Dict[str, _IOHandle] = {}
        self._outputs: Dict[str, _IOHandle] = {}
        for i, (shape, dtype) in enumerate(sh.in_spec):
            name = f"input_{i}"
            self._inputs[name] = _IOHandle(name, shape, dtype, sh.device,
                                           sh.staging)

    @property
    def _param_values(self):
        return self._shared.params

    @property
    def device(self) -> torch.device:
        return self._shared.device

    # -- reference API surface --
    def get_input_names(self) -> List[str]:
        return list(self._inputs)

    def get_input_handle(self, name: str) -> _IOHandle:
        return self._inputs[name]

    def get_output_names(self) -> List[str]:
        self._ensure_ran()
        return list(self._outputs)

    def get_output_handle(self, name: str) -> _IOHandle:
        self._ensure_ran()
        return self._outputs[name]

    def run(self, inputs: Optional[List] = None):
        """Run the program.  Either feed through the input handles
        (reference style; returns True) or pass arrays and get numpy
        arrays back."""
        sh = self._shared
        if inputs is not None:
            tensors = [as_input(a, sh.device) for a in inputs]
        else:
            tensors = []
            for name, h in self._inputs.items():
                if h._array is None:
                    raise RuntimeError(f"input {name!r} not set; call "
                                       "copy_from_cpu first")
                tensors.append(h._array)
            if sh.staging:
                # the staged feeds are consumed by the run
                for h in self._inputs.values():
                    h._array = None
        with sh.lock:
            outs = self._run(tensors)
        self._outputs = {}
        for i, o in enumerate(outs):
            h = _IOHandle(f"output_{i}", o.shape, o.dtype, sh.device)
            h._array = o
            self._outputs[h.name] = h
        if inputs is not None:
            return [self._outputs[n].copy_to_cpu() for n in self._outputs]
        return True

    def _run(self, tensors):
        from ..nn.functional.conv import _cudnn_full_fp32
        sh = self._shared
        with _cudnn_full_fp32(), torch.no_grad():
            if not graphs_on(sh.device):
                return list(sh.module(sh.params, *tensors))
            sig = _signature(tensors)
            g = sh.graphs.get(sig)
            if g is None:
                g = sh.graphs[sig] = _SignatureGraph(sh, tensors)
            return g.run(tensors)

    def _ensure_ran(self):
        if not self._outputs:
            raise RuntimeError("no outputs yet; call run() first")

    def precision_mode(self) -> Optional[str]:
        """Export-time compute precision of the loaded artifact (set via
        ``jit.save(precision=...)``); None = full precision."""
        return self._shared.precision

    def clone(self) -> "Predictor":
        """Share weights, graphs and the lock with a new handle
        (per-thread serving, ≙ AnalysisPredictor::Clone)."""
        return Predictor(self.config, _shared=self._shared)


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
