"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package grows
beside it slice by slice and imports nothing of it (nor JAX).

- Slice 1, paged Llama serving: ``inference.ServingEngine`` over
  ``models.LlamaForCausalLM``, with paged flash-decode attention and
  RMSNorm as hand-written CUDA kernels for Hopper (``csrc/``).
- Slice 2, Llama pretraining: ``jit.TrainStep`` with
  ``optimizer.AdamW`` and ``nn.ClipGradByGlobalNorm`` over the model's
  training forward, with flash-attention forward and backward and RoPE
  as further CUDA kernels, and RMSNorm differentiable.
- Slice 3, quantized serving: the same engine with an int8 KV cache
  and int8/int4 weights (``quantization`` holds the absmax rule), with
  int8 paged flash-decode and the quantized matmul as CUDA kernels.
- Slice 4, greedy speculative decoding: ``submit(spec_decode=K)`` with
  an n-gram or a draft-model drafter (``inference.speculative``) and the
  greedy dense ``generate()``, with the K-wide paged verify attention
  (float and int8) and dense flash-decode as CUDA kernels.
- Slice 5, the rest of single-device pretraining: the flag registry
  (``core.flags``) and the key generator (``core.generator``), LR
  schedulers (``optimizer.lr``), SGD, Momentum and Adam, bf16 moments
  by stochastic rounding, gradient merge and ``run_steps``, with the
  fused AdamW update and the two-pass flash-attention backward as CUDA
  kernels.
- Slice 15, the rest of the pretraining surface: the named remat
  policies (``distributed.recompute``), ``incubate``'s fused linear
  cross entropy, AMP with ``GradScaler`` (``amp``), the eager
  optimizers and regularizers (``optimizer``, ``regularizer``,
  ``nn.clip``), threefry dropout, the rest of ``cross_entropy`` and the
  train step's instruments, with the twin of the pretrain example
  (``examples.llama_pretrain``); no kernel is added, the flash forward
  becomes a dispatcher op a save policy can keep.
- Slice 14, observability: the metrics registry, the flight recorder,
  spans and the goodput ledger (``observability``, ``runtime``) around
  the serving engine, and the engine's fault injector
  (``inference.faultinject``); no kernel is added.
- Slice 16, the dense generation programs: ``generate()`` (greedy,
  sampled and beam search) replays one captured CUDA graph per program
  key, the ``inference.LLMPredictor`` session runs its prefill and decode
  block as two graphs and saves and loads its own artifact, the
  attention takes the ``cache=`` form, and ``examples.llama_serve`` is
  the twin of the serving example; no kernel is added.
- Slice 17, the fleet layer: token streaming out of the engine, the
  ``inference.Router`` over N replicas with affinity, failover and
  prefill/decode disaggregation, the framed wire transport and process
  replicas, and the fleet observability plane
  (``observability.fleet``); no kernel is added.
- Slice 18, multi-tenant LoRA serving and fair-share admission
  (``inference.AdapterStore``, ``models.lora``); no kernel is added.
- Slice 19, the NLP model zoo: ``models.GPTForCausalLM`` through every
  serving surface (the engine, speculation, quantized weights and KV,
  ``generate()``, ``LLMPredictor`` and its artifact) and pretraining,
  the ERNIE/BERT encoders with their heads, ``nn.LayerNorm`` and the
  ``nn.Transformer*`` layers, and ``llama_3_70b_config``; no kernel is
  added: the existing ones run at G = 1, head dim 64 and with the
  quantized matmul's bias epilogue.
- Slice 20, the vision and OCR path: ``nn``'s convolutions, pooling,
  batch/group/instance norms, recurrent layers, activations, containers,
  losses (``ctc_loss``) and common ops, the vision zoo
  (``vision.models``: ResNet and the rest) and PP-OCR detection and
  recognition (``models.ocr``); no kernel is added: convolutions,
  batch norm and the LSTM are torch's (cuDNN on the card), as they are
  XLA ops in the JAX package.
- Slice 21, the hapi training surface: ``Model`` (``prepare``/``fit``/
  ``evaluate``/``predict``/``save``/``load``) with its callbacks,
  ``summary`` and ``flops``, the data pipeline (``io``: datasets,
  samplers and the ``DataLoader`` with thread and process workers),
  ``metric``, ``save``/``load`` in the reference's file envelope
  (``framework.io``), ``static.InputSpec``, ``vision.datasets``,
  ``vision.transforms`` and the detection ops (``vision.ops``), with the
  twin of the CIFAR example (``examples.resnet_cifar``); no kernel is
  added.
- Slice 22, quantization: ``quantization`` (QAT, PTQ, the observers and
  fake quanters, ``QuantConfig``, ``weight_only_quantize``,
  ``fuse_act_into_quant_linear``), ``nn.quant`` (the QAT wrappers and
  the converted int8 layers) and ``static.quantization``; a converted
  Llama or GPT serves through ``generate()`` and ``LLMPredictor`` from
  its int8 codes, on the quantized-matmul kernel under
  ``FLAGS_use_int8_matmul_kernel``; no kernel is added.
- Slice 23, jit and static: ``jit`` (``to_static`` with dy2static,
  ``save``/``load`` over ``torch.export`` programs, bucketing),
  ``static`` (``Program``, ``Executor``, ``append_backward``, the
  control-flow ops, ``static.nn``) and ``inference.create_predictor``,
  one captured CUDA graph per input signature on the card; RMSNorm, RoPE
  and the quantized matmul become dispatcher ops, so an exported
  program carries the kernels; no kernel is added.

- Slice 24, the rest of ``nn`` and ``incubate.nn``: the ``nn.Layer``
  facade (``create_parameter``, ``ParamAttr``, ``Parameter``, the
  initializers), ``LazyGuard``, ``nn.BeamSearchDecoder`` and
  ``dynamic_decode``, ``one_hot``, varlen and CSR-sparse attention, and
  ``incubate.nn``'s fused functionals and layers; ``fused_rms_norm`` and
  ``memory_efficient_attention`` reach the RMSNorm and flash-forward
  kernels; no kernel is added.

- Slice 25, the tensor facade: ``Tensor`` (a ``torch.Tensor`` subclass
  that adds the reference's surface), ``to_tensor``, the dtypes (``int64``
  is ``int32``, as in the reference's 32-bit JAX), places, the grad
  modes, ``grad``, per-use gradient hooks, the op dispatcher
  (``core.dispatch``: AMP under the reference's op names and
  ``op::<name>`` spans), ``tensor`` (the registry's 289 tensor ops with
  the reference's signatures and result dtypes, threefry draws
  bit-equal to the reference's), the port's ``ops.yaml`` registry and
  ``_C_ops``, and ``autograd`` (``PyLayer``, ``vjp``/``jvp``/
  ``jacobian``/``hessian``); a decoder written against this API reaches
  the RMSNorm and flash kernels through ``_C_ops``; no kernel is added.

Entry points run on the CUDA card unless called with ``device="cpu"``
(an ``nn.Layer``'s ``create_parameter``: unless ``set_device("cpu")``).
"""

# ---- core ----
from .core.tensor import Tensor, to_tensor, is_tensor  # noqa: F401
from .core.tape import (no_grad, enable_grad,  # noqa: F401
                        set_grad_enabled, is_grad_enabled)
from .core.tape import grad as _tape_grad
from .core.dtypes import (  # noqa: F401
    bool_ as bool, uint8, int8, int16, int32, int64, float16, bfloat16,
    float32, float64, complex64, complex128, float8_e4m3fn, float8_e5m2,
    set_default_dtype, get_default_dtype,
)
from .core.generator import (seed, get_rng_state,  # noqa: F401
                             set_rng_state, Generator)
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.device import (  # noqa: F401
    set_device, get_device, CPUPlace, TPUPlace, CUDAPlace,
    is_compiled_with_cuda, is_compiled_with_tpu, device_count,
)

# ---- ops (also attaches the Tensor methods) ----
from .tensor import *  # noqa: F401,F403
from . import tensor  # noqa: F401
from . import _C_ops  # noqa: F401

# ---- subsystems ----
from . import (amp, autograd, core, device, distributed,  # noqa: F401
               framework, hapi, incubate, inference, io, jit, metric,
               models, nn, observability, ops, optimizer, quantization,
               regularizer, runtime, static, vision)
from .framework.io import load, save  # noqa: F401
from .hapi.dynamic_flops import flops  # noqa: F401
from .hapi.model import Model  # noqa: F401
from .hapi.model_summary import summary  # noqa: F401
from .nn.lazy import LazyGuard  # noqa: F401
from .autograd.py_layer import PyLayer  # noqa: F401

import torch as _torch

dtype = _torch.dtype
grad = _tape_grad


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Configure the numpy printing a ``Tensor``'s repr uses (the
    reference's ``paddle.set_printoptions`` subset)."""
    import numpy as _np
    kw = {}
    if precision is not None:
        kw["precision"] = precision
    if threshold is not None:
        kw["threshold"] = threshold
    if edgeitems is not None:
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        kw["linewidth"] = linewidth
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    _np.set_printoptions(**kw)


def iinfo(dtype_):
    from .core.dtypes import convert_dtype
    return _torch.iinfo(convert_dtype(dtype_))


def finfo(dtype_):
    from .core.dtypes import convert_dtype
    return _torch.finfo(convert_dtype(dtype_))


def get_cuda_rng_state():
    """The generator's state (one logical generator, as the
    reference's)."""
    return [get_rng_state()]


def set_cuda_rng_state(state_list):
    if state_list:
        set_rng_state(state_list[0])


def disable_static():
    """Eager execution is the default and only mode (the reference's
    no-op)."""


def enable_static():
    """Static graphs are built under ``static.program_guard`` (the
    reference's no-op)."""


def in_dynamic_mode() -> bool:
    """True when executing eagerly (not while ``torch.compile`` or
    ``torch.export`` traces)."""
    return not _torch.compiler.is_compiling()
