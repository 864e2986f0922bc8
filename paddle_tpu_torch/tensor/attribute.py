"""Tensor attribute ops: port of ``paddle_tpu/tensor/attribute.py``."""

from __future__ import annotations

import torch

from ..core.dispatch import wrap
from ..core.dtypes import is_complex as _dt_is_complex
from ..core.dtypes import is_floating_point as _dt_is_float
from ..core.dtypes import is_integer as _dt_is_int
from ._helpers import asarray

__all__ = ["is_complex", "is_floating_point", "is_integer", "shape",
           "real", "imag"]

from .math import real, imag  # noqa: E402


def is_complex(x):
    return _dt_is_complex(asarray(x).dtype)


def is_floating_point(x):
    return _dt_is_float(asarray(x).dtype)


def is_integer(x):
    return _dt_is_int(asarray(x).dtype)


def shape(input):
    a = asarray(input)
    return wrap(torch.tensor(list(a.shape), dtype=torch.int32,
                             device=a.device))
