"""Global flag registry.

Port of ``paddle_tpu/core/flags.py``: ``define_flag``, ``set_flags``,
``get_flags`` and ``flag``, the ``FLAGS_`` prefix, ``NotFoundError`` for
an unknown name and the ``FLAGS_<name>`` environment override read when
a flag is defined.  Every flag of the JAX package is defined here with
its default (``paddle_tpu/core/flags.py:70-101``).

The port reads three of them, which pick routes of the training step:
``adamw_rsqrt_update`` (the epsilon-hat Adam form), ``flash_onepass_bwd``
(the one-pass or the two-pass flash-attention backward) and
``use_fused_adamw_kernel`` (the fused AdamW kernel).  Those take any
value.  Every other flag selects a route the port does not have yet, so
setting it to anything but its default (by ``set_flags`` or by the
environment) raises ``NotImplementedError`` naming the ROADMAP item that
brings the route.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Iterable, Union

_lock = threading.Lock()
_FLAGS: Dict[str, Any] = {}
_DEFS: Dict[str, dict] = {}

# flag -> where its other route is queued (ROADMAP.md, Queue 1)
_UNPORTED = {
    "check_nan_inf": "item 13 (framework surface: the eager NaN/Inf scan)",
    "benchmark": "item 13 (framework surface: eager op timing)",
    "use_autotune": "item 13 (framework surface: the kernel autotuner)",
    "use_decode_attention_kernel": "item 11 (the XLA decode path: "
                                   "attention without the decode kernel)",
    "use_int8_matmul_kernel": "item 13 (QuantizedLinearInfer with the "
                              "int8 matmul kernel)",
    "eager_log_level": "item 13 (framework surface: eager dispatch "
                       "logging)",
    "low_precision_op_list": "item 2 (AMP)",
    "default_dtype": "item 13 (framework surface: the default dtype)",
    "prefer_pallas_kernels": "item 13 (framework surface: the plain "
                             "routes in place of the kernels)",
    "allocator_strategy": "item 13 (framework surface: allocator "
                          "settings)",
}


class NotFoundError(KeyError):
    """An unknown flag name (the JAX package's ``core.errors``
    ``NotFoundError``, a ``KeyError``)."""


def _coerce(value: str, default: Any):
    if isinstance(default, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(value)
    if isinstance(default, float):
        return float(value)
    return value


def _check_ported(name: str, value: Any, how: str) -> None:
    if name in _UNPORTED and value != _DEFS[name]["default"]:
        raise NotImplementedError(
            f"{how} FLAGS_{name}={value!r}: the port runs only the default "
            f"route ({_DEFS[name]['default']!r}); the other is ROADMAP.md, "
            f"Queue 1, {_UNPORTED[name]}")


def _key(name: str) -> str:
    key = name[len("FLAGS_"):] if name.startswith("FLAGS_") else name
    if key not in _FLAGS:
        raise NotFoundError(f"unknown flag {name!r}")
    return key


def define_flag(name: str, default: Any, help_str: str = "") -> None:
    """Register a flag; ``FLAGS_<name>`` in the environment overrides its
    default."""
    with _lock:
        _DEFS[name] = {"default": default, "help": help_str}
        env = os.environ.get("FLAGS_" + name)
        value = _coerce(env, default) if env is not None else default
        _check_ported(name, value, "environment")
        _FLAGS[name] = value


def set_flags(flags: Dict[str, Any]) -> None:
    """Set flag values, ``paddle.set_flags``.  All names are checked
    before any value changes."""
    with _lock:
        keys = [(_key(k), v) for k, v in flags.items()]
        for key, v in keys:
            _check_ported(key, v, "set_flags")
        for key, v in keys:
            _FLAGS[key] = v


def get_flags(flags: Union[str, Iterable[str]]) -> Dict[str, Any]:
    """``{"FLAGS_<name>": value}`` for the given names."""
    if isinstance(flags, str):
        flags = [flags]
    with _lock:
        return {"FLAGS_" + key: _FLAGS[key]
                for key in (_key(k) for k in flags)}


def flag(name: str) -> Any:
    """Fast internal accessor."""
    return _FLAGS[name]


define_flag("check_nan_inf", False,
            "scan op outputs for NaN/Inf in eager mode")
define_flag("benchmark", False, "block on every op for accurate eager timing")
define_flag("use_autotune", True, "enable kernel autotuning cache")
define_flag("adamw_rsqrt_update", False,
            "Adam/AdamW update via m_hat * rsqrt(v_hat + eps^2), the "
            "original Adam paper's epsilon-hat variant, instead of "
            "m_hat / (sqrt(v_hat) + eps)")
define_flag("flash_onepass_bwd", True,
            "flash-attention backward as one dq+dk+dv kernel; disable for "
            "the two-pass form (a dq kernel, then a dk/dv kernel)")
define_flag("use_fused_adamw_kernel", False,
            "route single-device AdamW updates through the fused AdamW "
            "kernel (one pass over p, g, m and v per parameter)")
define_flag("use_decode_attention_kernel", True,
            "fused flash-decode attention kernel for cached decode")
define_flag("use_int8_matmul_kernel", False,
            "route int8-weight linears through the quantized matmul kernel")
define_flag("eager_log_level", 0, "verbosity of eager dispatch logging")
define_flag("low_precision_op_list", 0, "record ops executed under AMP")
define_flag("default_dtype", "float32", "default floating point dtype")
define_flag("prefer_pallas_kernels", True,
            "use the kernels for flash-attention/norms")
define_flag("allocator_strategy", "auto_growth",
            "accepted for API parity")
