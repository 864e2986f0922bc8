"""Einsum: port of ``paddle_tpu/tensor/einsum.py`` (``torch.einsum``
over the operands promoted to one dtype)."""

from __future__ import annotations

import torch

from ..core.dispatch import dispatch
from ._helpers import asarray

__all__ = ["einsum"]


def einsum(equation, *operands):
    return dispatch("einsum", lambda *arrays: torch.einsum(
        equation, *arrays), *[asarray(t) for t in operands], promote=0)
