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

Entry points run on the CUDA card unless called with ``device="cpu"``.
"""

from . import (core, device, distributed, inference,  # noqa: F401
               jit, models, nn, ops, optimizer, quantization)
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.generator import seed  # noqa: F401
