"""``auto_cast``, ``decorate`` and the per-op cast rule: port of
``paddle_tpu/amp/auto_cast.py``.

The JAX package casts at its one dispatch point: every op passes its
name to ``_amp_hook`` (``paddle_tpu/core/dispatch.py:126-137``), and when
the hook names a dtype, every floating input of the op is cast to it.
The port has no dispatch layer, so each op on the port's paths calls
``cast(op_name, *tensors)`` itself with the name the JAX package gives
that op: ``linear`` (every projection and ``lm_head``), ``embedding``,
``rms_norm``, ``llama_rope``, ``sdpa`` and ``flash_attention``,
``swiglu``, ``add`` (the residual adds), ``dropout``,
``cross_entropy``, ``nll_loss`` and ``fused_linear_cross_entropy``.
``torch.autocast`` is not used: its op lists are not the JAX package's.

The rule (``_amp_hook``): O1 casts the white-list ops to the AMP dtype
and leaves every other op's inputs as they come; O2 casts the
black-list ops to float32 and every other op to the AMP dtype.  Custom
lists join the lists.  The state is per thread, as the reference's; a
recomputed segment (``distributed.recompute``) replays the state of its
first forward (``snapshot``/``restored``).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

from ..device import to_dtype

# op categories (the JAX package's lists, python/paddle/amp/amp_lists.py)
WHITE_LIST = {
    "matmul", "linear", "conv1d", "conv2d", "conv3d", "bmm", "mv", "einsum",
    "addmm", "flash_attention", "sdpa", "conv1d_transpose", "conv2d_transpose",
    "conv3d_transpose", "lstm", "gru", "rnn_tanh",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "mean", "sum", "softmax",
    "log_softmax", "cross_entropy", "nll_loss", "layer_norm", "rms_norm",
    "batch_norm", "group_norm", "instance_norm", "norm", "cumsum", "logsumexp",
    "sigmoid_focal_loss", "bce_with_logits", "binary_cross_entropy", "pow",
    "mse_loss", "l1_loss", "kl_div", "softmax_with_cross_entropy", "erfinv",
    "acos", "asin", "cosh", "sinh", "tan", "atanh", "acosh", "asinh",
    "reciprocal", "rsqrt",
}


def white_list():
    return {"float16": {"O1": sorted(WHITE_LIST), "O2": sorted(WHITE_LIST)}}


def black_list():
    return {"float16": {"O1": sorted(BLACK_LIST), "O2": sorted(BLACK_LIST)}}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()
        self.trace = None       # a list while ``_trace_ops`` records


_state = _AmpState()


def _amp_hook(op_name):
    if not _state.enabled:
        return None
    if op_name in _state.custom_black or op_name in BLACK_LIST:
        return torch.float32 if _state.level == "O2" else None
    if op_name in _state.custom_white or op_name in WHITE_LIST:
        return _state.dtype
    if _state.level == "O2":
        return _state.dtype
    return None


def cast(op_name, *tensors):
    """The inputs of op ``op_name`` as the rule casts them: every
    floating tensor to the hook's dtype when it names one; anything else
    (integer labels, ``None``) as given.  Returns a tuple."""
    if not _state.enabled:
        return tensors
    d = _amp_hook(op_name)
    if d is not None:
        tensors = tuple(
            t.to(d) if isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.dtype != d else t for t in tensors)
    if _state.trace is not None:
        _state.trace.append((op_name, tuple(
            t.dtype for t in tensors
            if isinstance(t, torch.Tensor) and t.is_floating_point())))
    return tensors


def snapshot():
    """The current AMP state, for ``restored``."""
    return (_state.enabled, _state.dtype, _state.level,
            frozenset(_state.custom_white), frozenset(_state.custom_black))


@contextmanager
def restored(snap):
    """Run under a state taken by ``snapshot``."""
    prev = snapshot()
    (_state.enabled, _state.dtype, _state.level, _state.custom_white,
     _state.custom_black) = snap
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level, _state.custom_white,
         _state.custom_black) = prev


@contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """``paddle.amp.auto_cast``; bfloat16 by default (float16 also
    accepted)."""
    with restored((bool(enable), to_dtype(dtype), level,
                   frozenset(custom_white_list or ()),
                   frozenset(custom_black_list or ()))):
        yield


amp_guard = auto_cast


@contextmanager
def _trace_ops():
    """Record ``(op name, floating input dtypes after the cast)`` of
    every op that consults the rule while AMP is on; yields the list."""
    prev, _state.trace = _state.trace, []
    try:
        yield _state.trace
    finally:
        _state.trace = prev


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate``: O2 casts the models' parameters to the
    AMP dtype (in place, so the optimizers keep their parameters) and
    turns on the optimizers' master weights unless ``master_weight`` is
    False."""
    d = to_dtype(dtype)
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype=d)
    if optimizers is not None:
        single_opt = not isinstance(optimizers, (list, tuple))
        opt_list = [optimizers] if single_opt else list(optimizers)
        for opt in opt_list:
            if master_weight is not False:
                opt._multi_precision = True
        if single_model and single_opt:
            return model_list[0], opt_list[0]
        return model_list if not single_model else model_list[0], opt_list
    return model_list[0] if single_model else model_list


amp_decorate = decorate
