"""``recompute`` (activation checkpointing): port of
``paddle_tpu/distributed/utils.py:24-116``.

The JAX package wraps the function in ``jax.checkpoint``; here it is
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the
forward keeps only the function's inputs, and the backward runs the
function again to rebuild what it needs.  Only full rematerialisation
(``policy=None``, alias ``"full"``) is ported; the named save policies
raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch.utils.checkpoint

# the JAX package's named policies (distributed/utils.py:_resolve_policy)
_NAMED_POLICIES = ("dots", "dots_saveable", "nothing_saveable",
                   "everything_saveable", "save_attn", "save_attn_mlp")


def recompute(function, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` without keeping its
    activations; they are recomputed in the backward pass."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)     # always non-reentrant here
    policy = kwargs.pop("policy", None)
    if policy not in (None, "full"):
        if callable(policy) or policy in _NAMED_POLICIES:
            raise NotImplementedError(
                f"recompute(policy={policy!r}) is not ported: only full "
                f"recompute (policy=None) is (ROADMAP.md, Queue 1: "
                f"training)")
        raise ValueError(f"recompute: unknown policy {policy!r}; one of "
                         f"{['full', *_NAMED_POLICIES]}")
    return torch.utils.checkpoint.checkpoint(
        function, *args, use_reentrant=False, preserve_rng_state=preserve,
        **kwargs)
