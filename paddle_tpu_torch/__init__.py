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

Entry points run on the CUDA card unless called with ``device="cpu"``.
"""

from . import (amp, core, device, distributed, framework,  # noqa: F401
               hapi, incubate, inference, io, jit, metric, models, nn,
               observability, ops, optimizer, quantization, regularizer,
               runtime, static, vision)
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.generator import seed  # noqa: F401
from .framework.io import load, save  # noqa: F401
from .hapi.dynamic_flops import flops  # noqa: F401
from .hapi.model import Model  # noqa: F401
from .hapi.model_summary import summary  # noqa: F401
