"""Eager op dispatch: port of ``paddle_tpu/core/dispatch.py``.

Every facade op funnels through :func:`dispatch`::

    out = dispatch("matmul", impl, x, y)

``impl`` is torch math over the op's tensor inputs (attributes closed
over).  The dispatcher, in the reference's order:

- opens the ``op::<name>`` span on ``runtime.HostTracer`` while it is
  enabled (the reference's :113-119);
- applies the port's AMP rule under the reference's op name
  (``amp.auto_cast.cast``, the reference's ``_amp_cast_hook`` at
  :124-131), which also records the op in an AMP trace;
- replaces each use of a hooked tensor by its per-use edge
  (``core.tensor.edge``), so hooks fire per consuming op;
- detaches the inputs marked in ``nondiff`` and the outputs from
  ``n_diff`` on (indices, the reference's non-differentiable slots);
- casts the inputs from ``promote`` on to the reference's result dtype
  (``core.dtypes.result_type``, with the closed-over operands ``weak``),
  after the AMP cast as the reference's ``jnp`` op promotes after its
  AMP cast;
- runs ``impl`` with torch-function dispatch off and returns facade
  tensors, 64-bit results narrowed to the reference's 32-bit dtypes; an
  output that is one of the inputs comes back as a new tensor, as every
  reference op returns a new one.

The rule is decided once a call, here: an op whose tensor inputs are all
plain ``torch.Tensor``s (the port's own model code calls
``nn.functional``'s ``add``, ``multiply``, ``concat``, ``split`` and
``flatten``, which are these ops) casts nothing, so torch's ops promote
by torch's rule, and returns torch's plain results, still under AMP and
spans: the reference's dtypes are the facade tensors' rule, and nothing
changes for torch tensors.

There is no tape of its own: torch autograd records ``impl``'s ops.
``FLAGS_check_nan_inf`` stays refused (``core.flags``).  The port's
``static`` records torch calls through its ``TorchFunctionMode``, which
sees the torch calls ``impl`` makes, so no static-graph hook is
needed.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch._C import DisableTorchFunctionSubclass as _NoTF

from ..amp.auto_cast import _state as _amp_state
from ..amp.auto_cast import cast as _amp_cast
from ..runtime import HostTracer as _tracer
from .dtypes import _WIDE, result_type
from .tensor import Tensor, _hooked, edge


def _one(o, ins, detach, facade):
    if detach and o.requires_grad:
        o = o.detach()
    if not facade:
        return o
    narrow = _WIDE.get(o.dtype)
    if narrow is not None:
        o = o.to(narrow)
    else:
        for t in ins:
            if o is t:
                o = o.view_as(o)
                break
    if type(o) is torch.Tensor:
        o.__class__ = Tensor
    return o


def wrap(out, ins=(), n_diff=None, facade=True):
    """Facade tensors of ``impl``'s result (a tensor, a tuple or a list;
    plain ones as torch gives them unless ``facade``); outputs from
    ``n_diff`` on are detached."""
    if isinstance(out, torch.Tensor):
        return _one(out, ins, n_diff is not None and n_diff < 1, facade)
    if isinstance(out, (tuple, list)):
        res = [_one(o, ins, n_diff is not None and i >= n_diff, facade)
               if isinstance(o, torch.Tensor) else o
               for i, o in enumerate(out)]
        return res if isinstance(out, list) else tuple(res)
    return out


def is_facade_call(args) -> bool:
    """Whether the facade's rule applies to a call on ``args`` (tensors,
    or lists of them, among other values): a facade tensor among them,
    or no tensor at all."""
    flat = []
    for a in args:
        if isinstance(a, (list, tuple)):
            flat.extend(x for x in a if isinstance(x, torch.Tensor))
        elif isinstance(a, torch.Tensor):
            flat.append(a)
    return not flat or any(isinstance(t, Tensor) for t in flat)


def wrap_like(out, args):
    """``out`` as facade tensors when ``is_facade_call(args)``, else as
    it is (a function of the port called on plain tensors)."""
    return wrap(out) if is_facade_call(args) else out


def _promoted(tensors, k, weak, facade):
    """``tensors`` with those from ``k`` on cast to the reference's
    result dtype over them and ``weak`` on a facade call (uncast on plain
    torch tensors); a Python scalar among them becomes a 0-d tensor."""
    if not facade and all(isinstance(t, torch.Tensor) for t in tensors):
        return tensors
    dev = next(t.device for t in tensors[k:] if isinstance(t, torch.Tensor))
    d = result_type(*tensors[k:], *weak) if facade else None
    out = list(tensors[:k])
    for t in tensors[k:]:
        if not isinstance(t, torch.Tensor):
            t = torch.tensor(t, dtype=d, device=dev)
        elif d is not None and t.dtype != d:
            t = t.to(d)
        out.append(t)
    return out


def _run(op_name, impl, tensors, nondiff, n_diff, amp, promote, weak):
    facade = is_facade_call(tensors)
    with _NoTF():
        if amp and _amp_state.enabled:
            tensors = _amp_cast(op_name, *tensors)
        if _hooked[0]:
            tensors = tuple(edge(t) if isinstance(t, Tensor) else t
                            for t in tensors)
        if nondiff is not None:
            tensors = tuple(
                t.detach() if nd and isinstance(t, torch.Tensor) else t
                for t, nd in zip(tensors, nondiff))
        # plain aliases: ``impl``'s operators and indexing are torch's
        tensors = tuple(_plain(t) if isinstance(t, Tensor) else t
                        for t in tensors)
        if promote is not None:
            tensors = _promoted(tensors, promote, weak, facade)
        return wrap(impl(*tensors), tensors, n_diff, facade)


def _plain(t):
    """A plain alias of facade tensor ``t``; a static program's variable
    keeps its id, so ``static``'s recording mode still sees it."""
    a = t.as_subclass(torch.Tensor)
    vid = t.__dict__.get("_static_var_id")
    if vid is not None:
        a._static_var_id = vid
        a._static_name = t.__dict__.get("_static_name")
    return a


def dispatch(op_name: str, impl: Callable, *tensors,
             nondiff: Sequence[bool] = None, n_diff: int = None,
             amp: bool = True, promote: int = None, weak: tuple = ()):
    """Run ``impl(*tensors)`` as the facade op ``op_name``.

    nondiff: per input, True => no gradient flows into that slot.
    n_diff: when ``impl`` returns a tuple, how many leading outputs are
      differentiable (the rest, e.g. argmax indices, are detached).
    amp: False for an op that writes into its input (``setitem``).
    promote: the inputs from this index on take one dtype before
      ``impl`` runs: on a facade call the reference's result dtype over
      them and ``weak`` (the Python scalars or tensors ``impl`` closes
      over, which are not cast); a Python scalar input becomes a 0-d
      tensor of that dtype.
    """
    if _tracer.enabled:
        _tracer.begin(f"op::{op_name}")
        try:
            return _run(op_name, impl, tensors, nondiff, n_diff, amp,
                        promote, weak)
        finally:
            _tracer.end()
    return _run(op_name, impl, tensors, nondiff, n_diff, amp, promote, weak)
