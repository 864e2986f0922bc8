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

Entry points run on the CUDA card unless called with ``device="cpu"``.
"""

from . import (device, distributed, inference, jit,  # noqa: F401
               models, nn, ops, optimizer, quantization)


def set_flags(flags) -> None:
    """The JAX package's ``set_flags``.  The port reads no flags: each
    ported path runs the JAX package's default route, and the routes the
    flags choose instead (``adamw_rsqrt_update``, the fused AdamW kernel,
    the two-pass flash backward) are not ported, so every call raises."""
    raise NotImplementedError(
        f"set_flags({dict(flags)!r}): the port reads no flags and runs "
        f"only the default routes (ROADMAP.md, Queue 1: training)")
