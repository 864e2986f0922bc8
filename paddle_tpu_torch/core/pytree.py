"""Tensor-aware pytree flatten/unflatten helpers: port of
``paddle_tpu/core/pytree.py`` over ``torch.utils._pytree``.

The reference strips its Tensors to ``jax.Array``s at a trace boundary
and re-boxes them on the way out; here a leaf is any ``torch.Tensor``,
stripped to a plain tensor and re-boxed as a facade ``Tensor``."""

from __future__ import annotations

import torch
from torch.utils import _pytree

from .tensor import Tensor, as_facade


def is_tensor_leaf(x):
    return isinstance(x, torch.Tensor)


def flatten_tensors(tree):
    """-> (raw_leaves, treedef, is_tensor_flags)."""
    leaves, treedef = _pytree.tree_flatten(tree)
    flags = [is_tensor_leaf(leaf) for leaf in leaves]
    raw = [leaf.as_subclass(torch.Tensor) if f and isinstance(leaf, Tensor)
           else leaf for leaf, f in zip(leaves, flags)]
    return raw, treedef, flags


def unflatten_tensors(raw_leaves, treedef, flags):
    rebuilt = [as_facade(v) if f else v for v, f in zip(raw_leaves, flags)]
    return _pytree.tree_unflatten(rebuilt, treedef)
