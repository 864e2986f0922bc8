"""Dtype system: port of ``paddle_tpu/core/dtypes.py``.

The reference runs JAX with x64 off, so its widest integer, float and
complex types are 32-bit and ``int64``/``float64``/``complex128`` are
names of the 32-bit types (``dtypes.py:19-31``).  The port keeps that
policy: ``int64 is torch.int32``, ``float64 is torch.float32`` and
``complex128 is torch.complex64``, and every facade op returns the
reference's result dtype (``canonical`` below folds a 64-bit torch dtype
onto its 32-bit name).  Dtypes are torch dtypes, also accepted as the
reference's strings, numpy dtypes and Python types.

A numpy array whose dtype is named ``bfloat16`` (what the reference's
``numpy()`` returns) is read through its ``uint16`` bits
(``from_numpy``), so no ``ml_dtypes`` is needed.
"""

from __future__ import annotations

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int32
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float32
complex64 = torch.complex64
complex128 = torch.complex64
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2

_ALIASES = {
    "bool": bool_,
    "uint8": uint8,
    "int8": int8,
    "int16": int16,
    "int32": int32,
    "int64": int64,
    "float16": float16,
    "half": float16,
    "bfloat16": bfloat16,
    "bf16": bfloat16,
    "float32": float32,
    "float": float32,
    "float64": float64,
    "double": float64,
    "complex64": complex64,
    "complex128": complex128,
    "float8_e4m3fn": float8_e4m3fn,
    "float8_e5m2": float8_e5m2,
}

# a 64-bit torch dtype -> the 32-bit dtype the reference computes in
_WIDE = {torch.int64: torch.int32, torch.float64: torch.float32,
         torch.complex128: torch.complex64, torch.uint64: torch.uint32}

# The reference's promotion rule: JAX's lattice with x64 off
# (``jax/_src/dtypes.py``, ``_type_promotion_lattice``) and weakly typed
# Python scalars.  A float16 tensor plus a float32 0-d tensor is float32
# (torch says float16), an int32 tensor plus ``1.5`` is float32, a bf16
# tensor plus ``1.5`` stays bf16, and a 64-bit result is its 32-bit type.
# Each node's immediate supertypes ("i*", "f*", "c*" are the weak Python
# int, float and complex):
_LATTICE = {
    "b1": ("i*",), "u8": ("i16", "u16"), "u16": ("i32", "u32"),
    "u32": ("i64", "u64"), "u64": ("f*",), "i*": ("u8", "i8"),
    "i8": ("i16",), "i16": ("i32",), "i32": ("i64",), "i64": ("f*",),
    "f*": ("c*", "bf16", "f16"), "bf16": ("f32",), "f16": ("f32",),
    "f32": ("f64",), "f64": ("c128",), "c*": ("c64",), "c64": ("c128",),
    "c128": ()}

_CODE = {torch.bool: "b1", torch.uint8: "u8", torch.uint16: "u16",
         torch.uint32: "u32", torch.uint64: "u64", torch.int8: "i8",
         torch.int16: "i16", torch.int32: "i32", torch.int64: "i64",
         torch.bfloat16: "bf16", torch.float16: "f16",
         torch.float32: "f32", torch.float64: "f64",
         torch.complex64: "c64", torch.complex128: "c128"}
# a lattice node as the dtype the reference computes in (x64 off)
_DTYPE = {"b1": torch.bool, "u8": torch.uint8, "u16": torch.uint16,
          "u32": torch.uint32, "u64": torch.uint32, "i8": torch.int8,
          "i16": torch.int16, "i32": torch.int32, "i64": torch.int32,
          "i*": torch.int32, "bf16": torch.bfloat16, "f16": torch.float16,
          "f32": torch.float32, "f64": torch.float32, "f*": torch.float32,
          "c64": torch.complex64, "c128": torch.complex64,
          "c*": torch.complex64}


def _uppers():
    up = {}

    def walk(n):
        if n not in up:
            s = {n}
            for m in _LATTICE[n]:
                s |= walk(m)
            up[n] = s
        return up[n]

    for n in _LATTICE:
        walk(n)
    return up


_UP = _uppers()
_JOIN = {}
for _a in _LATTICE:
    for _b in _LATTICE:
        _common = _UP[_a] & _UP[_b]
        _JOIN[_a, _b] = next(n for n in _common if _UP[n] == _common)


def _code(x):
    if isinstance(x, torch.Tensor):
        return _CODE.get(x.dtype)
    if isinstance(x, bool):
        return "b1"
    if isinstance(x, int):
        return "i*"
    if isinstance(x, float):
        return "f*"
    if isinstance(x, complex):
        return "c*"
    return None


def result_type(*operands) -> torch.dtype:
    """The reference's result dtype of an elementwise op over tensors and
    Python scalars."""
    node = None
    for x in operands:
        c = _code(x)
        if c is None:
            return torch.result_type(*operands)
        node = c if node is None else _JOIN[node, c]
    return _DTYPE[node]


FLOATING = (float16, bfloat16, float32, float8_e4m3fn, float8_e5m2)
INTEGER = (uint8, int8, int16, int32)
COMPLEX = (complex64,)


def canonical(dtype: torch.dtype) -> torch.dtype:
    """The dtype the reference gives a value of ``dtype``: 64-bit types
    fold onto their 32-bit names."""
    return _WIDE.get(dtype, dtype)


def convert_dtype(dtype):
    """Normalise a dtype spec (str | torch/numpy dtype | Python type) to
    a torch dtype; ``None`` stays ``None``."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return canonical(dtype)
    if isinstance(dtype, str):
        try:
            return _ALIASES[dtype]
        except KeyError:
            raise ValueError(f"unsupported dtype string {dtype!r}") from None
    if dtype is bool:
        return bool_
    if dtype is int:
        return int64
    if dtype is float:
        return float32
    if dtype is complex:
        return complex64
    try:
        name = np.dtype(dtype).name
    except TypeError:
        name = getattr(dtype, "name", str(dtype))
    try:
        return _ALIASES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}") from None


def dtype_name(dtype) -> str:
    """Canonical string name for a dtype (``"float32"``, ``"bfloat16"``)."""
    return str(convert_dtype(dtype)).rsplit(".", 1)[-1]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype) in FLOATING


def is_integer(dtype) -> bool:
    return convert_dtype(dtype) in INTEGER


def is_complex(dtype) -> bool:
    return convert_dtype(dtype) in COMPLEX


_default_dtype = float32


def set_default_dtype(d):
    """``paddle.set_default_dtype``."""
    global _default_dtype
    d = convert_dtype(d)
    if d not in (float16, bfloat16, float32):
        raise ValueError(f"default dtype must be floating, got "
                         f"{dtype_name(d)}")
    _default_dtype = d


def get_default_dtype() -> str:
    """``paddle.get_default_dtype`` (the canonical string)."""
    return dtype_name(_default_dtype)


def default_float_dtype() -> torch.dtype:
    return _default_dtype


def from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A host tensor of ``arr`` in the reference's dtype: a ``bfloat16``
    array through its ``uint16`` bits, a 64-bit one narrowed to 32 bits.
    The result never shares ``arr``'s buffer."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    elif arr.dtype == np.uint64:
        arr = arr.astype(np.uint32)
    elif arr.dtype == np.complex128:
        arr = arr.astype(np.complex64)
    else:
        arr = np.array(arr, copy=True, order="C")
    return torch.from_numpy(arr)
