"""Weight bridge from the JAX package's Llama to the port's.

``llama_state_from_jax`` maps the JAX model's ``named_parameters()``
(``paddle_tpu/nn/layer/layers.py:169``), handed over as numpy arrays, onto
``paddle_tpu_torch.models.LlamaForCausalLM``'s state dict.  The module
names are identical; the one difference is the Linear layout: a JAX
``nn.Linear`` stores its weight as ``[in, out]``
(``create_parameter((in_features, out_features))``), torch's as
``[out, in]``, so every projection and ``lm_head`` is transposed.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

LINEAR_NAMES = frozenset({"q_proj", "k_proj", "v_proj", "o_proj",
                          "gate_proj", "up_proj", "down_proj", "lm_head"})


def _is_linear_weight(name: str) -> bool:
    parts = name.split(".")
    return len(parts) >= 2 and parts[-1] == "weight" \
        and parts[-2] in LINEAR_NAMES


def llama_state_from_jax(named_arrays: Mapping[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """``{jax parameter name: array}`` -> a state dict for
    ``LlamaForCausalLM.load_state_dict`` (CPU tensors, the arrays'
    dtypes; Linear weights transposed to ``[out, in]``)."""
    out = {}
    for name, arr in named_arrays.items():
        a = np.asarray(arr)
        if _is_linear_weight(name):
            if a.ndim != 2:
                raise ValueError(f"{name}: a Linear weight must be 2-D, got "
                                 f"shape {a.shape}")
            a = a.T
        out[name] = torch.from_numpy(np.array(a, order="C"))  # owned copy
    return out

