"""Weight bridge from the JAX package's models to the port's.

``llama_state_from_jax``, ``gpt_state_from_jax`` and
``ernie_state_from_jax`` map the JAX model's ``named_parameters()``
(``paddle_tpu/nn/layer/layers.py:169``), handed over as numpy arrays,
onto the state dict of the port's ``LlamaForCausalLM``,
``GPTForCausalLM`` or ERNIE/BERT model (and the ``nn.Transformer*``
layers).  The module names are identical; the one difference is the
Linear layout: a JAX ``nn.Linear`` stores its weight as ``[in, out]``
(``create_parameter((in_features, out_features))``), torch's as
``[out, in]``, so every Linear weight is transposed.  Biases, LayerNorm
weights and embeddings are not.  GPT's fused ``qkv_proj`` ``[h, 3h]``
becomes ``[3h, h]``, whose output splits as the reference's ``[b, s, 3,
H, D]``.  ERNIE's tied pretraining decoder has no weight of its own on
either side: the word embedding is the one tensor, and
``cls.decoder_bias`` the decoder's only parameter.

``vision_state_from_jax`` (also ``ocr_state_from_jax``) maps the vision
zoo's and the OCR models' parameters AND buffers (a batch norm's
``_mean`` and ``_variance``), deciding by the port model's module types,
not by a name rule: only the weight of a ``torch.nn.Linear`` is
transposed; convolution, transposed-convolution, recurrent (an LSTM's
2-D ``weight_ih_l0`` included) and norm tensors cross as they are.

``optimizer_state_from_jax``/``optimizer_state_to_jax`` carry an
optimizer's ``state_dict()`` across the same way: the reference's keys
(``{accumulator}_{index}``, ``master_{index}``, ``LR_Scheduler``; a
Momentum's ``velocity_{index}`` among them), the index mapped through
the parameter names, the entries of Linear weights transposed (by the
name rule, or with ``linear=linear_weight_names(model)`` by type).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# the module names whose ``weight`` is a Linear's, per model family
LINEAR_NAMES_BY_FAMILY = {
    "llama": frozenset({"q_proj", "k_proj", "v_proj", "o_proj",
                        "gate_proj", "up_proj", "down_proj", "lm_head"}),
    "gpt": frozenset({"qkv_proj", "out_proj", "fc_in", "fc_out",
                      "lm_head"}),
    # ERNIE/BERT and the nn.Transformer* layers
    "ernie": frozenset({"q_proj", "k_proj", "v_proj", "out_proj",
                        "linear1", "linear2", "dense", "classifier",
                        "transform", "decoder", "seq_relationship"}),
}
LINEAR_NAMES = frozenset().union(*LINEAR_NAMES_BY_FAMILY.values())


def _is_linear_weight(name: str, linear_names=LINEAR_NAMES) -> bool:
    parts = name.split(".")
    return len(parts) >= 2 and parts[-1] == "weight" \
        and parts[-2] in linear_names


def _state_from_jax(named_arrays, family):
    names = LINEAR_NAMES_BY_FAMILY[family]
    out = {}
    for name, arr in named_arrays.items():
        a = np.asarray(arr)
        if _is_linear_weight(name, names):
            if a.ndim != 2:
                raise ValueError(f"{name}: a Linear weight must be 2-D, got "
                                 f"shape {a.shape}")
            a = a.T
        out[name] = torch.from_numpy(np.array(a, order="C"))  # owned copy
    return out


def llama_state_from_jax(named_arrays: Mapping[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """``{jax parameter name: array}`` -> a state dict for
    ``LlamaForCausalLM.load_state_dict`` (CPU tensors, the arrays'
    dtypes; Linear weights transposed to ``[out, in]``)."""
    return _state_from_jax(named_arrays, "llama")


def gpt_state_from_jax(named_arrays: Mapping[str, np.ndarray]
                       ) -> Dict[str, torch.Tensor]:
    """The same for ``GPTForCausalLM`` (``qkv_proj``, ``out_proj``,
    ``fc_in``, ``fc_out`` and ``lm_head`` transposed)."""
    return _state_from_jax(named_arrays, "gpt")


def ernie_state_from_jax(named_arrays: Mapping[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """The same for the ERNIE/BERT models and the ``nn.Transformer*``
    layers (attention projections, ``linear1``/``linear2``, the pooler's
    ``dense``, the heads' ``classifier``, ``transform``, untied
    ``decoder`` and ``seq_relationship`` transposed)."""
    return _state_from_jax(named_arrays, "ernie")


def linear_weight_names(model: torch.nn.Module) -> frozenset:
    """The state-dict names of ``model``'s Linear weights (by module
    type), the tensors whose layout differs between the packages."""
    return frozenset(f"{name}.weight" if name else "weight"
                     for name, m in model.named_modules()
                     if isinstance(m, torch.nn.Linear))


def vision_state_from_jax(named_arrays: Mapping[str, np.ndarray],
                          model: torch.nn.Module
                          ) -> Dict[str, torch.Tensor]:
    """``{jax parameter or buffer name: array}`` (the JAX model's
    ``named_parameters()`` and ``named_buffers()``) -> a state dict for
    the port ``model``'s ``load_state_dict``: CPU tensors in the arrays'
    dtypes, the weights of ``model``'s ``torch.nn.Linear`` modules
    transposed to ``[out, in]``, everything else as it is."""
    linear = linear_weight_names(model)
    out = {}
    for name, arr in named_arrays.items():
        a = np.asarray(arr)
        if name in linear:
            if a.ndim != 2:
                raise ValueError(f"{name}: a Linear weight must be 2-D, got "
                                 f"shape {a.shape}")
            a = a.T
        out[name] = torch.from_numpy(np.array(a, order="C"))  # owned copy
    return out


ocr_state_from_jax = vision_state_from_jax


def _entry_index(key: str):
    """(accumulator name, parameter index) of a state-dict key, or None
    for ``LR_Scheduler`` and anything without a numeric suffix."""
    name, _, idx = key.rpartition("_")
    return (name, int(idx)) if name and idx.isdigit() else None


def _bridge_state(state, src_names, dst_names, to_torch: bool,
                  linear=None):
    dst_index = {n: i for i, n in enumerate(dst_names)}
    out = {}
    for key, value in state.items():
        entry = _entry_index(key)
        if entry is None:
            out[key] = value
            continue
        acc, i = entry
        name = src_names[i]
        a = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) \
            else np.asarray(value)
        is_linear = (name in linear) if linear is not None \
            else _is_linear_weight(name)
        if is_linear and a.ndim == 2:
            a = a.T
        a = np.array(a, order="C")      # an owned copy
        out[f"{acc}_{dst_index[name]}"] = torch.from_numpy(a) if to_torch \
            else a
    return out


def optimizer_state_from_jax(state: Mapping, jax_names, torch_names=None,
                             linear=None) -> Dict:
    """A JAX ``Optimizer.state_dict()`` handed over as numpy (``LR_Scheduler``
    as its dict) -> a state dict for the port optimizer's
    ``set_state_dict``.  ``jax_names``: the JAX optimizer's parameter
    names in its parameter order; ``torch_names``: the port optimizer's
    (default the same order).  Keys keep their accumulator names
    (``moment1_0``, ``beta1_pow_0``, ``master_0``, ...) with the index
    mapped by name; Linear weights' entries are transposed to
    ``[out, in]`` (``linear``: the set of names to transpose, e.g.
    ``linear_weight_names(model)``; default the name rule)."""
    return _bridge_state(state, list(jax_names),
                         list(torch_names or jax_names), to_torch=True,
                         linear=linear)


def optimizer_state_to_jax(state: Mapping, torch_names, jax_names=None,
                           linear=None) -> Dict:
    """The inverse of ``optimizer_state_from_jax``: the port optimizer's
    ``state_dict()`` -> numpy arrays under the JAX optimizer's keys,
    Linear weights' entries transposed back to ``[in, out]``."""
    return _bridge_state(state, list(torch_names),
                         list(jax_names or torch_names), to_torch=False,
                         linear=linear)
