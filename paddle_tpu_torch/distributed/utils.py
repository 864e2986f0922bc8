"""``recompute`` (activation checkpointing) with the named save policies,
and ``recompute_sequential``: port of
``paddle_tpu/distributed/utils.py:24-141``.

The JAX package wraps the function in ``jax.checkpoint`` with a
rematerialisation policy; here it is
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` with a
selective-checkpoint policy (``create_selective_checkpoint_contexts``):
the forward keeps the function's inputs and the outputs of the ops the
policy saves, and the backward runs the function again, taking those
ops' outputs from what was kept instead of computing them.

The policies by name (``_resolve_policy``):
- ``full`` (``None``) and ``nothing_saveable``: keep nothing;
- ``dots`` (``dots_with_no_batch_dims_saveable``): keep the outputs of
  the products without batch dims (``mm``, ``addmm``: every linear
  projection); ``dots_saveable`` also those with batch dims (``bmm``);
- ``everything_saveable``: keep everything, i.e. no checkpoint;
- ``save_attn``: keep the flash-attention forward's O and LSE (the op
  ``paddle_tpu_torch::flash_attention_fwd``, the reference's
  ``"attn_out"`` tag), so the backward does not launch the forward
  kernel again;
- ``save_attn_mlp``: also the products run under
  ``checkpoint_name("mlp_gate_up")`` (the Llama MLP's gate and up
  projections).
A callable is taken as a policy function of torch's selective
checkpoint (``(ctx, op, *args, **kwargs) -> CheckpointPolicy`` or a
bool).  An unknown name raises the reference's ``ValueError``.

RMSNorm, RoPE and the quantized matmul are dispatcher ops too
(``paddle_tpu_torch::rms_norm``, ``::apply_rope``,
``::quantized_matmul``), so a policy sees them; no named policy saves
them, so every policy but ``everything_saveable`` recomputes them, as
every JAX policy but that one recomputes the reference's Pallas calls.

Keys: as in the reference (:84-103), ``recompute`` draws one key from
the generator and pushes it around the function, so draws inside derive
from it, and the backward's run pushes the same key: dropout masks of
the recompute equal those of the first forward.  Where the function
draws, the reference's no-grad probe run (which draws from the outer
stream before the key is drawn) is reproduced: the function is run once
without grad, then the key is drawn and the real run made.  Where it
does not draw (the Llama layers), the first run under the key the next
draw will return is already the real one.  The AMP state of the first
forward is replayed in the backward's run.
"""

from __future__ import annotations

import functools
import threading
from contextlib import contextmanager

import torch
import torch.utils.checkpoint as _ckpt

from ..amp.auto_cast import restored as _amp_restored
from ..amp.auto_cast import snapshot as _amp_snapshot
from ..core import generator as _generator
from ..ops import flash_attention as _flash  # noqa: F401 (registers the op)

__all__ = ["recompute", "recompute_sequential", "checkpoint_name"]

_aten = torch.ops.aten
_DOTS_NO_BATCH = frozenset({_aten.mm.default, _aten.addmm.default})
_DOTS = _DOTS_NO_BATCH | {_aten.bmm.default, _aten.baddbmm.default}
_ATTN_OUT = frozenset(
    {torch.ops.paddle_tpu_torch.flash_attention_fwd.default})

_tag = threading.local()


@contextmanager
def checkpoint_name(name: str):
    """Name the products computed inside (``jax.ad_checkpoint.
    checkpoint_name``): a policy saving ``name`` keeps their outputs."""
    prev = getattr(_tag, "name", None)
    _tag.name = name
    try:
        yield
    finally:
        _tag.name = prev


def _save_only(ops):
    def policy(ctx, op, *args, **kwargs):
        return (_ckpt.CheckpointPolicy.MUST_SAVE if op in ops
                else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def _save_names(*names):
    ops = _ATTN_OUT if "attn_out" in names else frozenset()

    def policy(ctx, op, *args, **kwargs):
        if op in ops or (op in _DOTS
                         and getattr(_tag, "name", None) in names):
            return _ckpt.CheckpointPolicy.MUST_SAVE
        return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE
    return policy


_EVERYTHING = object()
_POLICIES = {
    "full": None,
    "dots": _save_only(_DOTS_NO_BATCH),
    "dots_saveable": _save_only(_DOTS),
    "nothing_saveable": None,
    "everything_saveable": _EVERYTHING,
    "save_attn": _save_names("attn_out"),
    "save_attn_mlp": _save_names("attn_out", "mlp_gate_up"),
}


def _resolve_policy(policy):
    if policy is None or callable(policy):
        return policy
    if policy not in _POLICIES:
        raise ValueError(
            f"recompute: unknown policy {policy!r}; one of {list(_POLICIES)}")
    return _POLICIES[policy]


def recompute(function, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` keeping only what ``policy``
    saves; the rest is recomputed in the backward pass."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)     # always non-reentrant here
    policy = _resolve_policy(kwargs.pop("policy", None))
    amp_state = _amp_snapshot()
    gen = _generator.default_generator()

    def call(key):
        drawn = []

        def run(*a, **kw):
            with _amp_restored(amp_state):
                _generator.push_trace_key(key)
                try:
                    return function(*a, **kw)
                finally:
                    drawn.append(_generator.trace_draws())
                    _generator.pop_trace_key()

        if policy is _EVERYTHING:
            out = run(*args, **kwargs)
        else:
            ctx = {} if policy is None else dict(context_fn=functools.partial(
                _ckpt.create_selective_checkpoint_contexts, policy))
            out = _ckpt.checkpoint(run, *args, use_reentrant=False,
                                   preserve_rng_state=preserve, **ctx,
                                   **kwargs)
        return out, drawn[0] > 0

    out, drew = call(gen.peek())
    if not drew:
        gen.draw()              # the key the run was made under
        return out
    # the function draws: the reference's probe draws from the outer
    # stream first, then the key is drawn
    del out
    with torch.no_grad():
        function(*args, **kwargs)
    return call(gen.draw())[0]


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Checkpoint a sequence of layers in ``ctx["segments"]`` segments
    (one segment without ``ctx``), each a ``recompute`` call."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    if segments <= 1:
        def run_all(*a):
            out = a if len(a) > 1 else a[0]
            for layer in layers:
                out = layer(out)
            return out
        return recompute(run_all, *args, **kwargs)
    seg_size = (len(layers) + segments - 1) // segments
    out = args if len(args) > 1 else args[0]
    for s in range(0, len(layers), seg_size):
        chunk = layers[s:s + seg_size]

        def run_chunk(x, _chunk=chunk):
            for layer in _chunk:
                x = layer(x)
            return x

        out = recompute(run_chunk, out, **kwargs)
    return out
