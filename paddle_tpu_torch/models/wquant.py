"""Quantized-weight serving: the code+scale context of the projection
sites.  A copy of ``paddle_tpu/models/wquant.py`` on torch tensors.

``ServingEngine(weight_dtype="int8"|"int4")`` quantizes every hot
projection weight once at load into an int8 code plane (int4 packs two
codes per byte) plus a per-output-channel f32 scale plane
(``inference/llm.py`` ``build_weight_quant_plan``).  The serving programs
call the models' unchanged ``decode_step`` / ``prefill_chunk`` inside
:func:`wquant_context`; the projection sites call :func:`wq_linear`,
which routes the matmul through the quantized kernel when the active
context holds planes for ``(layer_idx, target)`` and is the plain
``lin(x)`` everywhere else (training, float serving).

Non-projection parameters (embeddings, norms, ``lm_head``) stay float.
The reference swaps each quantized weight for a zero-size placeholder
inside its traced programs; the port's model keeps its float weights on
the device beside the planes (ROADMAP.md, known differences).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import torch

from ..ops.quantized_matmul import routed_quantized_matmul

# the projection set the serving quantizer targets; the model's
# quant_projections() returns per-layer dicts keyed by these names
QUANT_TARGETS_LLAMA = ("q_proj", "k_proj", "v_proj", "o_proj",
                       "gate_proj", "up_proj", "down_proj")


class WeightQuantContext:
    """The planes for one model call: ``planes[(layer_idx, target)] =
    (codes, scales)`` with codes ``[K, N]`` int8 (``[K//2, N]`` packed
    for int4) and scales ``[N]`` f32; ``bits`` is 8 or 4.  (The
    reference's ``max_m`` route cap is a TPU tiling rule the port does
    not have.)"""

    __slots__ = ("planes", "bits")

    def __init__(self, planes: Dict[Tuple[int, str], Tuple], bits: int):
        self.planes = planes
        self.bits = bits


# the active context: module state, set only around a model call
_ACTIVE: Optional[WeightQuantContext] = None


@contextmanager
def wquant_context(ctx: Optional[WeightQuantContext]):
    """Activate a weight-quant context for the duration of a model call
    (``None`` = explicit no-op, so callers can wrap unconditionally)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = ctx
    try:
        yield
    finally:
        _ACTIVE = prev


def wq_linear(lin: torch.nn.Linear, x: torch.Tensor, target: str,
              layer_idx: int) -> torch.Tensor:
    """Projection-site hook: ``lin``'s matmul through the quantized
    codes+scales when the active context registers ``(layer_idx,
    target)``, the plain ``lin(x)`` otherwise.  The bias (always float)
    joins the kernel's f32 epilogue."""
    ctx = _ACTIVE
    if ctx is None:
        return lin(x)
    entry = ctx.planes.get((layer_idx, target))
    if entry is None:
        return lin(x)
    codes, scales = entry
    return routed_quantized_matmul(x, codes, scales, bits=ctx.bits,
                                   bias=lin.bias)
