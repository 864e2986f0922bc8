"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package grows
beside it slice by slice and imports nothing of it (nor JAX).  Slice 1 is
paged Llama serving: ``inference.ServingEngine`` over
``models.LlamaForCausalLM``, with the paged flash-decode attention and
RMSNorm as hand-written CUDA kernels for Hopper (``csrc/``).  Entry
points run on the CUDA card unless called with ``device="cpu"``.
"""

from . import device, inference, models, nn, ops  # noqa: F401
