"""``save`` and ``load``: port of ``paddle_tpu/framework/io.py``.

The file is the reference's envelope: a pickle (protocol 4) in which
every tensor is ``{"__paddle_tpu_tensor__": True, "data": ndarray}``,
a bf16 tensor as float32 data with ``"__bf16__": True``; nested dicts,
lists and tuples (state dicts, optimizer states) keep their shape and
other objects pass as they are.  A file either package writes loads in
the other at this level.  The tensors inside are each package's own:
a port ``nn.Linear`` weight is ``[out, in]`` and the reference's ``[in,
out]``, so a model's weights cross packages through
``models.convert.vision_state_from_jax`` and its kin, not as they are.
``load`` returns CPU tensors (``Model.load`` and ``load_state_dict``
copy them onto the model's device).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]

_SENTINEL = "__paddle_tpu_tensor__"
_BF16 = "__bf16__"


def _encode(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return {_SENTINEL: True, _BF16: True, "data": t.float().numpy()}
        return {_SENTINEL: True, "data": t.numpy()}
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_encode(v) for v in obj)
    return obj


def _decode(obj):
    if isinstance(obj, dict):
        if obj.get(_SENTINEL):
            t = torch.from_numpy(np.array(obj["data"], copy=True))
            if obj.get(_BF16):
                t = t.to(torch.bfloat16)
            return t
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_decode(v) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_encode(obj), f, protocol=protocol)


def load(path, **configs):
    with open(path, "rb") as f:
        return _decode(pickle.load(f))
