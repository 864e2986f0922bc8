"""AMP debugging utilities: port of ``paddle_tpu/amp/debugging.py``.

``enable_tensor_checker`` sets ``FLAGS_check_nan_inf``, as the reference
does; the port's flag registry refuses that route until the eager NaN/Inf
scan is ported (ROADMAP.md, Queue 1, item 13), so it raises there.
``collect_operator_stats`` collects nothing, as the reference's.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from ..core.flags import set_flags

__all__ = ["check_numerics", "enable_tensor_checker",
           "disable_tensor_checker", "collect_operator_stats", "DebugMode"]


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 4


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """(NaN count, Inf count) of ``tensor`` as int64 tensors; raises
    ``FloatingPointError`` when either is non-zero."""
    arr = torch.as_tensor(tensor)
    num_nan = int(torch.isnan(arr).sum())
    num_inf = int(torch.isinf(arr).sum())
    if num_nan or num_inf:
        raise FloatingPointError(
            f"numerics check failed for {op_type}:{var_name} — "
            f"{num_nan} NaN, {num_inf} Inf values")
    return torch.tensor(num_nan), torch.tensor(num_inf)


def enable_tensor_checker():
    set_flags({"FLAGS_check_nan_inf": True})


def disable_tensor_checker():
    set_flags({"FLAGS_check_nan_inf": False})


@contextmanager
def collect_operator_stats():
    yield
