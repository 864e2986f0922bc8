"""Control-flow ops: ``cond`` / ``while_loop`` / ``case`` / ``switch_case``.

Port of ``paddle_tpu/static/control_flow.py:80-195`` (``paddle.static.nn``'s
control flow, and the runtime the dy2static transforms call).  In eager
mode the predicate is a concrete value, so the chosen branch simply runs
in Python, side effects included.  While ``torch.export`` traces
(``traced``: ``torch.compiler.is_exporting()``, or a fake tensor) a tensor
predicate lowers to ``torch.cond`` and a traced loop to
``torch._higher_order_ops.while_loop``, the counterparts of ``lax.cond``
and ``lax.while_loop``, so an exported program (``jit.save``) carries the
branch or the loop instead of the one path the tracer happened to take.

The reference's checks are kept: the branches of a traced ``cond`` must
return the same structure with leaves of one shape and dtype, the
loop vars must be a non-empty list or tuple, ``switch_case`` refuses an
empty or duplicated branch table.  Under a trace every output leaf is a
tensor (``torch.cond`` returns tensors only; a Python number a branch
returns comes back as a 0-d tensor), each branch's outputs are copies,
since a higher-order op may not return its inputs, and the functions
handed to ``torch.cond`` and ``while_loop`` change no Python state
(torch traces them with dynamo, which refuses that).
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import is_fake

__all__ = ["cond", "while_loop", "case", "switch_case"]


def traced(v) -> bool:
    """True for a tensor seen by a tracer (``torch.export``): its value
    is not known, so control flow over it must be lowered."""
    return isinstance(v, torch.Tensor) and (
        torch.compiler.is_exporting() or is_fake(v))


def scalar_tensor(v, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a 0-d tensor on ``like``'s device, made by a
    factory op: a tensor constant (``torch.as_tensor(True)``) cannot live
    in a traced ``torch.cond``/``while_loop`` subgraph of an exported
    program."""
    if isinstance(v, torch.Tensor):
        return v
    dt = (torch.bool if isinstance(v, bool) else torch.int64
          if isinstance(v, int) else torch.get_default_dtype())
    return like.new_full((), v, dtype=dt)


def _as_pred(v, like) -> torch.Tensor:
    """A traced predicate as the bool scalar tensor ``torch.cond`` and
    ``while_loop`` take."""
    return scalar_tensor(v, like).reshape(()).to(torch.bool)


def _tensor_leaves(out, like):
    """``out`` with every leaf a tensor of its own (a copy: a higher-order
    op may not return its inputs; a Python number becomes a 0-d tensor).
    Pure, as the functions a higher-order op traces must be."""
    return pytree.tree_map(lambda v: v.clone() if isinstance(v, torch.Tensor)
                           else scalar_tensor(v, like), out)


def _leaf_sig(v):
    if isinstance(v, torch.Tensor):
        return tuple(v.shape), v.dtype
    return (), (torch.bool if isinstance(v, bool) else torch.int64
                if isinstance(v, int) else torch.get_default_dtype())


def _check_same(a, b):
    """The reference's check that the branches agree: the same pytree
    structure, and leaves of the same shape and dtype (a Python number is
    the 0-d tensor ``torch.cond`` would make of it)."""
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    if sa != sb:
        raise ValueError(
            "control flow: branches must return the same pytree "
            f"structure (got {sb} vs {sa})")
    for x, y in zip(la, lb):
        if _leaf_sig(x) != _leaf_sig(y):
            raise ValueError(
                "control flow: branches must return the same pytree "
                f"structure with leaves of one shape and dtype (got "
                f"{_leaf_sig(y)} vs {_leaf_sig(x)})")


def cond(pred, true_fn, false_fn, name=None):
    """Run ``true_fn()`` if pred else ``false_fn()``.  Traced, both
    branches must return structures of matching shapes and dtypes: each
    runs once under the tracer for the structure check (its ops are dead
    code the export drops), then ``torch.cond`` traces both."""
    if not traced(pred):
        return true_fn() if bool(pred) else false_fn()
    _check_same(true_fn(), false_fn())
    return torch.cond(_as_pred(pred, pred),
                      lambda: _tensor_leaves(true_fn(), pred),
                      lambda: _tensor_leaves(false_fn(), pred), ())


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """While loop over a tuple/list of loop vars.

    cond_fn(*vars) -> bool scalar; body_fn(*vars) -> same-structured vars.
    Tracedness is decided from the loop vars and the first condition (a
    condition over a closed-over traced value lowers too)."""
    if not isinstance(loop_vars, (list, tuple)) or not loop_vars:
        raise TypeError("while_loop: loop_vars must be a non-empty "
                        "list/tuple")
    init = tuple(loop_vars)
    first = cond_fn(*init)
    if not (traced(first) or any(traced(v) for v in
                                 pytree.tree_leaves(init))):
        vars_ = init
        go = bool(first)
        while go:
            out = body_fn(*vars_)
            vars_ = tuple(out) if isinstance(out, (list, tuple)) else (out,)
            go = bool(cond_fn(*vars_))
        return list(vars_)
    like = next(v for v in (first, *pytree.tree_leaves(init)) if traced(v))
    carry0, spec = pytree.tree_flatten(_tensor_leaves(init, like))

    def c(*carry):
        return _as_pred(cond_fn(*pytree.tree_unflatten(list(carry), spec)),
                        like)

    def b(*carry):
        out = body_fn(*pytree.tree_unflatten(list(carry), spec))
        out = tuple(out) if isinstance(out, (list, tuple)) else (out,)
        return tuple(pytree.tree_leaves(_tensor_leaves(out, like)))

    from torch._higher_order_ops.while_loop import while_loop as _while
    final = _while(c, b, tuple(carry0))
    return list(pytree.tree_unflatten(list(final), spec))


def case(pred_fn_pairs, default=None, name=None):
    """First pair whose pred is true wins (reference ``static.nn.case``;
    when ``default`` is None the last pair's fn doubles as the
    default)."""
    if not pred_fn_pairs:
        raise TypeError("case: pred_fn_pairs must be non-empty")
    pairs = list(pred_fn_pairs)
    if default is None:
        default = pairs[-1][1]
        pairs = pairs[:-1]
        if not pairs:
            return default()
    if not any(traced(p) for p, _ in pairs):
        for p, fn in pairs:
            if bool(p):
                return fn()
        return default()

    def build(i):
        if i == len(pairs):
            return default
        return lambda: cond(pairs[i][0], pairs[i][1], build(i + 1))

    return build(0)()


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Dispatch on an integer index (reference ``static.nn.switch_case``).
    branch_fns: dict {index: fn}, a list of (index, fn), or a list of
    fns.  An unmatched index takes ``default``, else the last branch."""
    if not branch_fns:
        raise TypeError("switch_case: branch_fns must be non-empty")
    if isinstance(branch_fns, dict):
        items = sorted(branch_fns.items(), key=lambda kv: kv[0])
    elif isinstance(branch_fns[0], (list, tuple)):
        items = sorted(((i, f) for i, f in branch_fns), key=lambda kv: kv[0])
    else:
        items = list(enumerate(branch_fns))
    seen = set()
    for k, _ in items:
        if k in seen:
            raise ValueError(f"switch_case: duplicate branch index {k}")
        seen.add(k)
    fns = [f for _, f in items] + ([default] if default is not None else [])
    if not traced(branch_index):
        i = int(branch_index)
        for key, fn in items:
            if key == i:
                return fn()
        return fns[-1]()
    idx = torch.as_tensor(branch_index).reshape(())

    def build(j):
        if j == len(items):
            return fns[-1]
        return lambda: cond(idx == items[j][0], items[j][1], build(j + 1))

    return build(0)()
