"""dy2static: AST conversion of Python control flow for ``to_static`` and
``jit.save``.

Port of ``paddle_tpu/jit/dy2static.py``.  The AST passes (return
restructuring, return-in-loop lowering, break/continue lowering and the
control-flow transformer, ``_ControlFlowTransformer`` and
``convert_to_static``) are the reference's, copied as they are: they are
pure ``ast``.  The runtime converters the transformed code calls (the
``_jst`` namespace: ``convert_ifelse``, ``convert_while``, the logical
ops, ``range_cond``/``range_final``, ``Undefined``) are rewired to
:mod:`paddle_tpu_torch.static.control_flow`:

- every ``if``/``while``/``for range()`` statement is rewritten into a call
  to a ``convert_*`` helper, passing the (possibly-undefined) local
  variables the construct reads/writes;
- at run time the helper checks whether the predicate is traced (a fake
  tensor while ``torch.export`` traces, ``control_flow.traced``): a
  concrete predicate executes the chosen branch directly (exact eager
  semantics, side effects included), a traced one lowers to
  ``torch.cond`` / ``while_loop`` through ``static/control_flow.py``;
- ``break``/``continue`` lower to loop-carried guard booleans before
  conversion (reference ``break_continue_transformer.py:88``): jumps become
  flag assignments, trailing statements get ``if not flag`` guards, the
  loop condition gains ``and not break_flag``, and ``for i in range()``
  loops rewrite to an explicit iterator-variable while form so the loop
  variable lands on the break iteration's value exactly like Python;
- early returns restructure via else-absorption (reference
  ``return_transformer.py:122``): an ``if`` whose branch tail-returns
  absorbs the trailing statements into its other branch, so every path
  tail-returns and the both-branches-return conversion applies;
- the few constructs still inexpressible under tracing (``return`` inside
  a traced loop, jumps inside try/with) are left as plain Python but their
  predicate is wrapped in :func:`assert_not_traced`, which raises a clear
  error naming the construct instead of the tracer's data-dependent
  branch error.

``to_static`` runs the converted function eagerly, so there every
predicate is concrete and the conversion changes nothing; it matters
where ``jit.save`` exports the function.
"""

from __future__ import annotations

import ast
import functools
import inspect
import itertools
import textwrap

import torch
import torch.utils._pytree as pytree

from ..static.control_flow import scalar_tensor
from ..static.control_flow import traced as _is_tracer

_JST = "__ptpu_jst__"
_MODULE_IDS = itertools.count()


class Undefined:
    """Placeholder for a local that is not yet bound at the control-flow
    site (reference: dy2static UndefinedVar)."""

    _singleton = None

    def __new__(cls):
        if cls._singleton is None:
            cls._singleton = super().__new__(cls)
        return cls._singleton

    def __repr__(self):
        return "<undefined>"


UNDEFINED = Undefined()

# return-value slot sentinel for returns lowered inside traced loops
# (``rv = RET_UNSET`` before the loop; the slot is only read when the
# paired return-flag is True).  A DISTINCT instance from UNDEFINED: only
# this sentinel opts into select-with-zero-fill in convert_ifelse —
# genuinely unbound user locals must keep erroring.
RET_UNSET = Undefined.__new__(type("RetUnset", (Undefined,), {}))


def _as_bool(v, like) -> torch.Tensor:
    return scalar_tensor(v, like).to(torch.bool)


# ---------------------------------------------------------------------------
# runtime converters (the _jst namespace inside transformed code)
# ---------------------------------------------------------------------------

def _select_with_unset(pred, true_fn, false_fn, in_values):
    """Traced if/else where a branch may yield the RET_UNSET sentinel
    (a return-value slot not yet assigned): both branches run in the
    current trace (they are pure generated fns) and leaves select
    element-wise, with a sentinel SLOT on one side zero-filled with the
    other side's whole pytree structure (so ``return a, b`` in a loop
    works — the slot adopts the tuple shape).  Validity is tracked by
    the paired return flag, so the zeros are never observed (reference
    analogue: RETURN_NO_VALUE init in return_transformer.py:122)."""
    out_t = true_fn(*in_values)
    out_f = false_fn(*in_values)
    pv = _as_bool(pred, pred).reshape(())

    def zeros(tree):
        return pytree.tree_map(
            lambda v: torch.zeros_like(scalar_tensor(v, pred)), tree)

    def select_slot(t, f):
        if t is RET_UNSET and f is RET_UNSET:
            return RET_UNSET
        if t is RET_UNSET:
            t = zeros(f)
        elif f is RET_UNSET:
            f = zeros(t)
        raw_t, td_t = pytree.tree_flatten(t)
        raw_f, td_f = pytree.tree_flatten(f)
        if td_t != td_f:
            raise ValueError(
                "control flow: branches must return the same pytree "
                f"structure (got {td_t} vs {td_f})")
        leaves = [torch.where(pv, scalar_tensor(a, pred),
                              scalar_tensor(b, pred))
                  for a, b in zip(raw_t, raw_f)]
        return pytree.tree_unflatten(leaves, td_t)

    if isinstance(out_t, (tuple, list)) and \
            isinstance(out_f, (tuple, list)) and len(out_t) == len(out_f):
        # locals tuples from generated branch fns: select slot-wise so a
        # RET_UNSET slot can adopt the other side's nested structure
        return tuple(select_slot(t, f) for t, f in zip(out_t, out_f))
    return select_slot(out_t, out_f)


def _contains_unset(values):
    return any(leaf is RET_UNSET for leaf in pytree.tree_leaves(tuple(values)))


def convert_ifelse(pred, true_fn, false_fn, in_values):
    """if/else over possibly-traced predicate.

    true_fn/false_fn take ``in_values`` (current values of the locals the
    branches read) and return the tuple of locals the branches assign.
    """
    if _is_tracer(pred):
        if _contains_unset(in_values):
            return _select_with_unset(pred, true_fn, false_fn, in_values)
        from ..static.control_flow import cond
        return cond(pred, lambda: true_fn(*in_values),
                    lambda: false_fn(*in_values))
    if bool(pred):
        return true_fn(*in_values)
    return false_fn(*in_values)


def _zero_like(probe):
    """A zero-valued init matching a probe value's type (for loop carries
    that are assigned before read every iteration).  Tuples (e.g. a
    multi-value return slot) zero element-wise, keeping the structure."""
    if isinstance(probe, (tuple, list)):
        return type(probe)(_zero_like(p) for p in probe)
    if isinstance(probe, torch.Tensor):
        return torch.zeros_like(probe)
    if isinstance(probe, bool):
        return False
    if isinstance(probe, (int, float)):
        return type(probe)(0)
    return probe      # UNDEFINED or None


def _traced_while(cond_fn, body_fn, loop_vars):
    from ..static.control_flow import while_loop
    if any(v is UNDEFINED or v is RET_UNSET for v in loop_vars):
        # body-local temps (e.g. a nested loop's iterator/guard flags)
        # are unbound at loop entry but assigned before read every
        # iteration: probe one body evaluation for their types and
        # start them at zero.  A genuine read-before-assign of the
        # unbound local raises inside the probe, as it should.
        # NOTE: the probe runs one extra (traced) body evaluation;
        # functionalized bodies are pure, but a body that mutates
        # closed-over Python state (e.g. list.append) sees one extra
        # call — an accepted trace-time hazard
        probe = body_fn(*loop_vars)
        for v, p in zip(loop_vars, probe):
            if (v is UNDEFINED or v is RET_UNSET) and \
                    (p is UNDEFINED or p is RET_UNSET):
                # e.g. a local only assigned under a traced conditional:
                # one body evaluation cannot determine its type, and
                # while_loop would fail on the sentinel with an opaque
                # structure error — raise the clear message here.
                raise NotImplementedError(
                    "dy2static: a variable carried by a traced while "
                    "loop is unbound at loop entry and still unbound "
                    "after one loop iteration (it is only assigned "
                    "under a traced conditional). Initialize it before "
                    "the loop.")
        loop_vars = tuple(
            _zero_like(p) if (v is UNDEFINED or v is RET_UNSET) else v
            for v, p in zip(loop_vars, probe))
    out = while_loop(cond_fn, body_fn, list(loop_vars))
    return tuple(out)


def convert_while(cond_fn, body_fn, loop_vars):
    """while over possibly-traced condition; loop_vars is a tuple of the
    locals carried across iterations.  Returns the final loop_vars.

    Tracedness follows the CONDITION: a concrete condition runs the loop
    eagerly (which unrolls under an outer trace — traced loop vars flow
    through fine, and python-only body ops like list indexing keep
    working); the moment the condition becomes traced, the remaining
    iterations lower to ``while_loop`` from the current state."""
    first = cond_fn(*loop_vars)
    if _is_tracer(first):
        return _traced_while(cond_fn, body_fn, loop_vars)
    vars_ = tuple(loop_vars)
    cont = bool(first)
    while cont:
        vars_ = tuple(body_fn(*vars_))
        nxt = cond_fn(*vars_)
        if _is_tracer(nxt):
            return _traced_while(cond_fn, body_fn, vars_)
        cont = bool(nxt)
    return vars_


def convert_logical_and(lhs_fn, rhs_fn):
    l = lhs_fn()
    if _is_tracer(l):
        return torch.logical_and(_as_bool(l, l), _as_bool(rhs_fn(), l))
    if not bool(l):
        return l  # python short-circuit semantics
    return rhs_fn()


def convert_logical_or(lhs_fn, rhs_fn):
    l = lhs_fn()
    if _is_tracer(l):
        return torch.logical_or(_as_bool(l, l), _as_bool(rhs_fn(), l))
    if bool(l):
        return l
    return rhs_fn()


def convert_logical_not(v):
    if _is_tracer(v):
        return torch.logical_not(_as_bool(v, v))
    return not bool(v)


def concrete_true(v):
    """True only for a CONCRETELY truthy value — traced values yield False
    (used by lowered non-range for loops to execute a real ``break`` when
    the guard flag is concrete)."""
    return (not _is_tracer(v)) and bool(v)


def assert_not_traced(pred, construct):
    """Clear trace-time error for constructs dy2static cannot convert."""
    if _is_tracer(pred):
        raise NotImplementedError(
            f"to_static: {construct} cannot be converted to traced "
            "control flow (torch.cond / while_loop; break/continue and "
            "one-sided returns ARE converted; the remaining unsupported "
            "forms are `return` inside a traced loop and jumps inside "
            "try/with). Hoist the return out of the loop or compute the "
            "predicate outside the traced function. (reference analogue: "
            "dy2static loop/return transformers)")
    return pred


def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def range_final(i_after, start, stop, step):
    """Post-loop fixup for converted ``for i in range()``: the while form
    leaves i at the first FAILING value; Python leaves it at the last
    YIELDED value (and unbound when the range was empty).  When the bounds
    are concrete the trip count is statically known even if the body traced,
    so exact Python semantics apply; with traced bounds a zero-trip loop
    yields ``start`` (documented deviation — "unbound" has no traced
    representation) instead of the out-of-range ``start - step``."""
    if not (_is_tracer(start) or _is_tracer(stop) or _is_tracer(step)):
        trip = len(range(_int(start), _int(stop), _int(step)))
        if trip == 0:
            return UNDEFINED  # zero iterations: Python leaves i unbound
        return i_after - step
    like = next(v for v in (i_after, start, stop, step) if _is_tracer(v))
    iv = scalar_tensor(i_after, like)
    return torch.where(iv == start, scalar_tensor(start, like).to(iv.dtype),
                       iv - step)


def range_cond(i, stop, step):
    """Sign-aware range continuation test usable both ways."""
    if _is_tracer(step):
        return torch.where(step > 0, scalar_tensor(i, step) < stop,
                           scalar_tensor(i, step) > stop)
    return i < stop if step > 0 else i > stop


# ---------------------------------------------------------------------------
# AST analysis helpers
# ---------------------------------------------------------------------------

_SCOPE_BARRIERS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                   ast.ClassDef)


def _walk_scope(node):
    """Yield nodes of the statement without descending into nested defs
    (a nested def is yielded but its body — with its own returns, stores,
    loads — belongs to the inner scope and is never entered)."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, _SCOPE_BARRIERS):
            continue
        for child in ast.iter_child_nodes(n):
            stack.append(child)


def _names(nodes, ctx_types):
    out = set()
    for root in nodes:
        for n in _walk_scope(root):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ctx_types):
                out.add(n.id)
    return out


def _stores(nodes):
    return _names(nodes, (ast.Store,))


def _loads(nodes):
    return _names(nodes, (ast.Load,))


def _has_node(nodes, kinds):
    for root in nodes:
        for n in _walk_scope(root):
            if isinstance(n, kinds):
                return True
    return False


def _scan_loop_jumps(body, kinds, only_guarded=False):
    """True when a statement of ``kinds`` belonging to THIS loop level
    occurs in ``body`` (nested loops keep their own jumps; nested defs are
    barriers).  ``only_guarded=True`` matches only occurrences inside
    try/with — the forms the guard-flag lowering cannot express."""
    def scan(stmts, guarded):
        for s in stmts:
            if isinstance(s, kinds) and (guarded or not only_guarded):
                return True
            if isinstance(s, (ast.For, ast.While, *_SCOPE_BARRIERS)):
                continue
            g = guarded or isinstance(s, (ast.Try, ast.With))
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(s, field, None)
                if sub and scan(sub, g):
                    return True
            for h in getattr(s, "handlers", []) or []:
                if scan(h.body, g):
                    return True
        return False
    return scan(body, False)


def _loop_controls_for_body(body):
    """break/continue belonging to THIS loop (not nested loops)."""
    return _scan_loop_jumps(body, (ast.Break, ast.Continue))


def _ends_with_return(body):
    return bool(body) and isinstance(body[-1], ast.Return)


def _parse_range_for(node):
    """(start, stop, step) AST nodes when ``node`` is ``for <Name> in
    range(...)`` with 1-3 positional args, else None."""
    if not (isinstance(node.iter, ast.Call)
            and isinstance(node.iter.func, ast.Name)
            and node.iter.func.id == "range"
            and not node.iter.keywords
            and 1 <= len(node.iter.args) <= 3
            and isinstance(node.target, ast.Name)):
        return None
    args = node.iter.args
    if len(args) == 1:
        return ast.Constant(value=0), args[0], ast.Constant(value=1)
    if len(args) == 2:
        return args[0], args[1], ast.Constant(value=1)
    return args[0], args[1], args[2]


# ---------------------------------------------------------------------------
# code-construction helpers
# ---------------------------------------------------------------------------

def _name_load(n):
    return ast.Name(id=n, ctx=ast.Load())


def _name_store(n):
    return ast.Name(id=n, ctx=ast.Store())


def _jst_attr(fn_name):
    return ast.Attribute(value=_name_load(_JST), attr=fn_name,
                         ctx=ast.Load())


def _guard_defined(names):
    """try: name \n except (NameError, UnboundLocalError): name = UNDEFINED"""
    stmts = []
    for n in sorted(names):
        stmts.append(ast.Try(
            body=[ast.Expr(value=_name_load(n))],
            handlers=[ast.ExceptHandler(
                type=ast.Tuple(elts=[_name_load("NameError"),
                                     _name_load("UnboundLocalError")],
                               ctx=ast.Load()),
                name=None,
                body=[ast.Assign(targets=[_name_store(n)],
                                 value=_jst_attr("UNDEFINED"))])],
            orelse=[], finalbody=[]))
    return stmts


def _tuple_load(names):
    return ast.Tuple(elts=[_name_load(n) for n in names], ctx=ast.Load())


def _tuple_store(names):
    return ast.Tuple(elts=[_name_store(n) for n in names], ctx=ast.Store())


def _return_tuple(names):
    return ast.Return(value=_tuple_load(names))


# ---------------------------------------------------------------------------
# pass 1: early-return restructuring (else-absorption)
# ---------------------------------------------------------------------------

def _all_paths_return(stmts):
    """Deep tail check: every execution path through this block ends in a
    Return (an If counts when both branches do)."""
    if not stmts:
        return False
    last = stmts[-1]
    if isinstance(last, ast.Return):
        return True
    if isinstance(last, ast.If):
        return bool(last.orelse) and _all_paths_return(last.body) \
            and _all_paths_return(last.orelse)
    return False


def _restructure_returns(stmts):
    """Rewrite a block so every Return sits in tail position: an If whose
    branch tail-returns absorbs the trailing statements into the other
    branch (reference return/early_return transformers).  Dead code after
    a Return is dropped.  Does not descend into loops or nested defs —
    loop-internal returns keep the assert_not_traced fallback."""
    out = []
    for i, s in enumerate(stmts):
        rest = stmts[i + 1:]
        if isinstance(s, ast.Return):
            out.append(s)
            return out  # rest is unreachable
        if isinstance(s, ast.If) and _has_node([s], (ast.Return,)):
            body = _restructure_returns(s.body)
            orelse = _restructure_returns(s.orelse) if s.orelse else []
            b_ret, o_ret = _all_paths_return(body), _all_paths_return(orelse)
            if b_ret and o_ret:
                out.append(ast.If(test=s.test, body=body, orelse=orelse))
                return out  # rest unreachable
            if b_ret and rest:
                out.append(ast.If(
                    test=s.test, body=body,
                    orelse=_restructure_returns(orelse + rest)))
                return out
            if o_ret and rest:
                out.append(ast.If(
                    test=s.test, body=_restructure_returns(body + rest),
                    orelse=orelse))
                return out
            out.append(ast.If(test=s.test, body=body, orelse=orelse))
            continue
        out.append(s)
    return out


def _lower_returns(func_def):
    """Normalize ``func_def.body`` so all returns are tail-position.  Adds
    an explicit ``return None`` for the implicit fall-through when the
    function mixes returning and non-returning paths."""
    body = func_def.body
    if not _has_node(body, (ast.Return,)):
        return
    restructured = _restructure_returns(body)
    if not _all_paths_return(restructured):
        restructured = _restructure_returns(
            restructured + [ast.Return(value=ast.Constant(value=None))])
    func_def.body = restructured


# ---------------------------------------------------------------------------
# pass 0: return-inside-loop lowering (return flag + value slot)
# ---------------------------------------------------------------------------

class _ReturnInLoopLowering(ast.NodeTransformer):
    """Lowers ``return <expr>`` inside loops into flag dataflow the later
    passes can convert (reference
    ``python/paddle/jit/dy2static/return_transformer.py:122`` — their
    RETURN_NO_VALUE init plays the role of our RET_UNSET sentinel):

        __ret_flag = False          # before the loop
        __ret_val  = _jst.RET_UNSET
        for/while ...:
            ... __ret_flag = True; __ret_val = expr; break ...
        if __ret_flag:
            return __ret_val        # pass 1 else-absorbs; pass 2 lowers
                                    # the injected break

    One flag/value pair per function; nested loops compose because the
    inner loop's synthesized post-loop ``if __ret_flag: return __ret_val``
    is itself a return inside the outer loop, which the outer visit
    lowers to ``if __ret_flag: __ret_flag = True; ... break`` — i.e. a
    plain flag-break cascade.  Bare ``return`` (no value) keeps the
    existing clear trace-time error path.  Returns inside a loop's
    ``else`` clause are function-scope (they run after the loop) and are
    left to passes 1/2.
    """

    def __init__(self):
        self.flag = "__ptpu_ret_flag"
        self.val = "__ptpu_ret_val"
        self.used = False

    def visit_FunctionDef(self, node):
        return node

    def visit_AsyncFunctionDef(self, node):
        return node

    def visit_Lambda(self, node):
        return node

    def visit_ClassDef(self, node):
        return node

    def _replace_returns(self, stmts):
        """Replace value-returns in this statement list (descending into
        If branches; loops at this depth were already visited bottom-up
        and contain no returns).  Returns None when a bare return is
        found (caller leaves the loop unlowered)."""
        out = []
        for s in stmts:
            if isinstance(s, ast.Return):
                if s.value is None:
                    return None
                out.append(ast.Assign(targets=[_name_store(self.flag)],
                                      value=ast.Constant(value=True)))
                out.append(ast.Assign(targets=[_name_store(self.val)],
                                      value=s.value))
                out.append(ast.Break())
                return out  # rest unreachable
            if isinstance(s, ast.If):
                body = self._replace_returns(s.body)
                orelse = self._replace_returns(s.orelse)
                if body is None or orelse is None:
                    return None
                out.append(ast.If(test=s.test, body=body or [ast.Pass()],
                                  orelse=orelse))
                continue
            out.append(s)
        return out

    def _lower_loop(self, node):
        self.generic_visit(node)  # inner loops first (bottom-up)
        if not _has_node(node.body, (ast.Return,)):
            return node
        new_body = self._replace_returns(node.body)
        if new_body is None:
            return node  # bare return: keep the clear fallback error
        if _has_node(new_body, (ast.Return,)):
            # A return survived the walk (nested in try/with, which
            # _replace_returns does not descend into and pass 2 cannot
            # lower anyway) — leave the loop untouched so the generic
            # return-in-loop error path fires instead of injecting dead
            # flag plumbing around a half-lowered loop.
            return node
        node.body = new_body or [ast.Pass()]
        self.used = True
        init = [ast.Assign(targets=[_name_store(self.flag)],
                           value=ast.Constant(value=False)),
                ast.Assign(targets=[_name_store(self.val)],
                           value=_jst_attr("RET_UNSET"))]
        post = ast.If(test=_name_load(self.flag),
                      body=[ast.Return(value=_name_load(self.val))],
                      orelse=[])
        return init + [node, post]

    visit_While = _lower_loop
    visit_For = _lower_loop


# ---------------------------------------------------------------------------
# pass 2: break/continue lowering (guard-flag dataflow)
# ---------------------------------------------------------------------------

class _JumpLowering(ast.NodeTransformer):
    """Rewrites loops containing break/continue (or an else clause) into
    guard-flag form with no jump statements (reference
    break_continue_transformer.py:88):

    - ``break`` -> ``flag = True``; trailing statements of every enclosing
      block up to the loop get an ``if not flag`` guard; the loop condition
      gains ``and not flag``;
    - ``continue`` -> same with a per-iteration flag reset at body top;
    - ``for i in range(...)`` rewrites to an explicit iterator-variable
      while loop (i assigned from the iterator at body top, so after a
      break ``i`` holds the break iteration's value exactly like Python);
    - non-range ``for`` keeps its header and guards the whole body with
      ``if not break_flag`` (iterations after a break are no-ops);
    - ``while``/``for`` ``else`` clauses run under ``if not break_flag``.

    Loops whose jumps sit inside try/with, or that contain ``return``, are
    left untouched (assert_not_traced fallback)."""

    def __init__(self):
        self.n = 0

    def _fresh(self, kind):
        self.n += 1
        return f"__ptpu_low_{kind}_{self.n}"

    def visit_FunctionDef(self, node):
        return node

    def visit_AsyncFunctionDef(self, node):
        return node

    def visit_Lambda(self, node):
        return node

    def visit_ClassDef(self, node):
        return node

    def _jumps_unlowerable(self, body):
        """Jumps inside try/with (this loop's jumps only) can't be
        guard-lowered."""
        return _scan_loop_jumps(body, (ast.Break, ast.Continue),
                                only_guarded=True)

    def _lower_block(self, stmts, brk, cont, on_jump=None):
        """on_jump: nullary callable returning fresh statements inserted
        before each break/continue flag set (the for-loop shadow capture
        — Python's post-loop loop-variable value is its value AT the jump
        site, body mutations included)."""
        out = []
        for i, s in enumerate(stmts):
            rest = stmts[i + 1:]
            if isinstance(s, ast.Break):
                if on_jump is not None:
                    out.extend(on_jump())
                out.append(ast.Assign(targets=[_name_store(brk)],
                                      value=ast.Constant(value=True)))
                return out  # rest unreachable
            if isinstance(s, ast.Continue):
                if on_jump is not None:
                    out.extend(on_jump())
                out.append(ast.Assign(targets=[_name_store(cont)],
                                      value=ast.Constant(value=True)))
                return out
            if isinstance(s, ast.If) and _loop_controls_for_body([s]):
                new_if = ast.If(
                    test=s.test,
                    body=self._lower_block(s.body, brk, cont, on_jump)
                    or [ast.Pass()],
                    orelse=self._lower_block(s.orelse, brk, cont, on_jump))
                out.append(new_if)
                if rest:
                    flags = [_name_load(brk)]
                    if cont is not None:
                        flags.append(_name_load(cont))
                    guard = ast.UnaryOp(
                        op=ast.Not(),
                        operand=(flags[0] if len(flags) == 1 else
                                 ast.BoolOp(op=ast.Or(), values=flags)))
                    out.append(ast.If(
                        test=guard,
                        body=self._lower_block(rest, brk, cont, on_jump) or
                        [ast.Pass()],
                        orelse=[]))
                return out
            out.append(s)
        return out

    def _loop_prep(self, node):
        """Common gating + flag allocation.  Returns None when the loop
        must stay untouched."""
        has_jumps = _loop_controls_for_body(node.body)
        if not has_jumps and not node.orelse:
            return None
        if _has_node(node.body, (ast.Return,)) or \
                self._jumps_unlowerable(node.body):
            return None
        brk = self._fresh("brk")
        has_cont = self._has_continue(node.body)
        cont = self._fresh("cont") if has_cont else None
        return brk, cont

    @staticmethod
    def _has_continue(body):
        return _scan_loop_jumps(body, (ast.Continue,))

    def _finish(self, out, node, brk):
        if node.orelse:
            out.append(ast.If(
                test=ast.UnaryOp(op=ast.Not(), operand=_name_load(brk)),
                body=node.orelse, orelse=[]))
        return out

    def visit_While(self, node):
        self.generic_visit(node)  # inner loops first
        prep = self._loop_prep(node)
        if prep is None:
            return node
        brk, cont = prep
        body = ([ast.Assign(targets=[_name_store(cont)],
                            value=ast.Constant(value=False))]
                if cont else [])
        body += self._lower_block(node.body, brk, cont) or [ast.Pass()]
        # flag first: after a break the original condition must not be
        # re-evaluated (it may crash or repeat side effects)
        test = ast.BoolOp(op=ast.And(), values=[
            ast.UnaryOp(op=ast.Not(), operand=_name_load(brk)),
            node.test])
        out = [ast.Assign(targets=[_name_store(f)],
                          value=ast.Constant(value=False))
               for f in ([brk] + ([cont] if cont else []))]
        out.append(ast.While(test=test, body=body, orelse=[]))
        return self._finish(out, node, brk)

    def visit_For(self, node):
        self.generic_visit(node)
        prep = self._loop_prep(node)
        if prep is None:
            return node
        brk, cont = prep
        reset = ([ast.Assign(targets=[_name_store(cont)],
                             value=ast.Constant(value=False))]
                 if cont else [])
        init_brk = [ast.Assign(targets=[_name_store(f)],
                               value=ast.Constant(value=False))
                    for f in ([brk] + ([cont] if cont else []))]

        rng = _parse_range_for(node)
        if rng is None:
            # keep the iterator and guard the body; a REAL break fires when
            # the flag is concretely True (stops consuming the iterator —
            # critical for infinite/shared generators), while a traced flag
            # leaves concrete_true False and the finite iterator unrolls
            # with a no-op guarded body.  Shadows track the loop variables
            # (every Store-context Name in the target, so tuple-unpacking
            # works; subscript/attribute targets read their base/index —
            # Load ctx — and get no shadow) so post-loop reads see what
            # Python sees: the value AT the jump site (body mutations
            # included — capture runs at each break/continue and at the
            # end of an un-jumped iteration, while the For header keeps
            # rebinding the target on the no-op post-break iterations).
            tgt_names = [n.id for n in ast.walk(node.target)
                         if isinstance(n, ast.Name)
                         and isinstance(n.ctx, ast.Store)]
            shadows = [(nm, self._fresh("item")) for nm in tgt_names]

            def capture():
                return [ast.Assign(targets=[_name_store(sh)],
                                   value=_name_load(nm))
                        for nm, sh in shadows]
            # top capture keeps the shadow bound on every active
            # iteration (a jump-site capture alone would be branch-local
            # inside a traced conditional — UNDEFINED on the other arm);
            # the end/jump-site captures overwrite it with the value at
            # the jump site so body mutations are kept
            guarded = capture() + (self._lower_block(
                list(node.body) + capture(), brk, cont,
                on_jump=capture) or [ast.Pass()])
            body = reset + [
                ast.If(test=ast.UnaryOp(op=ast.Not(),
                                        operand=_name_load(brk)),
                       body=guarded, orelse=[]),
                ast.If(test=ast.Call(func=_jst_attr("concrete_true"),
                                     args=[_name_load(brk)], keywords=[]),
                       body=[ast.Break()], orelse=[]),
            ]
            out = init_brk + [
                ast.For(target=node.target, iter=node.iter, body=body,
                        orelse=[])]
            if shadows:
                # zero-trip loops leave both names unbound: restore the
                # targets from the shadows only when the shadows exist
                out.append(ast.Try(
                    body=[ast.Assign(targets=[_name_store(nm)],
                                     value=_name_load(sh))
                          for nm, sh in shadows],
                    handlers=[ast.ExceptHandler(
                        type=ast.Tuple(elts=[_name_load("NameError"),
                                             _name_load("UnboundLocalError")],
                                       ctx=ast.Load()),
                        name=None, body=[ast.Pass()])],
                    orelse=[], finalbody=[]))
            return self._finish(out, node, brk)

        start, stop, step = rng
        lowered = self._lower_block(node.body, brk, cont) or [ast.Pass()]
        ivar = node.target.id
        itv, stopv, stepv = (self._fresh("it"), self._fresh("stop"),
                             self._fresh("step"))
        pre = [ast.Assign(targets=[_name_store(itv)], value=start),
               ast.Assign(targets=[_name_store(stopv)], value=stop),
               ast.Assign(targets=[_name_store(stepv)], value=step),
               # pre-bind the loop var so traced zero-trip loops have a
               # carried value (post-zero-trip reads see start — documented
               # deviation from Python's unbound)
               ast.Assign(targets=[_name_store(ivar)],
                          value=_name_load(itv))] + init_brk
        test = ast.BoolOp(op=ast.And(), values=[
            ast.Call(func=_jst_attr("range_cond"),
                     args=[_name_load(itv), _name_load(stopv),
                           _name_load(stepv)], keywords=[]),
            ast.UnaryOp(op=ast.Not(), operand=_name_load(brk))])
        body = reset + [
            ast.Assign(targets=[_name_store(ivar)], value=_name_load(itv)),
            ast.Assign(targets=[_name_store(itv)],
                       value=ast.BinOp(left=_name_load(itv), op=ast.Add(),
                                       right=_name_load(stepv))),
        ] + lowered
        out = pre + [ast.While(test=test, body=body, orelse=[])]
        return self._finish(out, node, brk)


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------

class _ControlFlowTransformer(ast.NodeTransformer):
    """Rewrites if/while/for statements in one function scope.  Nested
    function defs are left untouched (convert them separately)."""

    def __init__(self, local_names):
        self.locals = set(local_names)
        self.n = 0

    def _uid(self, kind):
        self.n += 1
        return f"__ptpu_{kind}_{self.n}"

    # do not descend into nested scopes
    def visit_FunctionDef(self, node):
        return node

    def visit_AsyncFunctionDef(self, node):
        return node

    def visit_Lambda(self, node):
        return node

    def visit_ClassDef(self, node):
        return node

    def _convert_test(self, test):
        """Convert and/or/not over possibly-traced values inside a
        predicate expression (short-circuit preserved when concrete)."""
        if isinstance(test, ast.BoolOp):
            sub = [self._convert_test(v) for v in test.values]
            fn = ("convert_logical_and" if isinstance(test.op, ast.And)
                  else "convert_logical_or")
            expr = sub[0]
            for rhs in sub[1:]:
                expr = ast.Call(
                    func=_jst_attr(fn),
                    args=[ast.Lambda(args=_empty_args(), body=expr),
                          ast.Lambda(args=_empty_args(), body=rhs)],
                    keywords=[])
            return expr
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return ast.Call(func=_jst_attr("convert_logical_not"),
                            args=[self._convert_test(test.operand)],
                            keywords=[])
        return test

    # ---- if ----------------------------------------------------------
    def visit_If(self, node):
        self.generic_visit(node)
        branches = node.body + node.orelse
        has_return = _has_node(branches, (ast.Return,))
        test = self._convert_test(node.test)

        if _loop_controls_for_body(branches):
            # break/continue belong to an enclosing loop: hoisting the
            # branch into a function would be a SyntaxError.  Leave the if
            # as Python; the enclosing loop is likewise left unconverted
            # (its body contains the jump), so the predicate guard below
            # gives the clear trace-time error.
            node.test = ast.Call(
                func=_jst_attr("assert_not_traced"),
                args=[test, ast.Constant(
                    value="'if' containing break/continue")],
                keywords=[])
            return node

        if has_return:
            both_return = (_ends_with_return(node.body)
                           and node.orelse and _ends_with_return(node.orelse))
            if not both_return:
                # leave as Python; raise clearly if the pred is traced
                node.test = ast.Call(
                    func=_jst_attr("assert_not_traced"),
                    args=[test, ast.Constant(
                        value="'if' with a one-sided return")],
                    keywords=[])
                return node
            # both branches return: branch fns keep their returns
            in_vars = sorted((_loads(branches) | _loads([node.test]))
                             & self.locals)
            tname, fname = self._uid("true_fn"), self._uid("false_fn")
            t_def = _make_funcdef(tname, in_vars, node.body)
            f_def = _make_funcdef(fname, in_vars, node.orelse)
            call = ast.Call(
                func=_jst_attr("convert_ifelse"),
                args=[test, _name_load(tname), _name_load(fname),
                      _tuple_load(in_vars)],
                keywords=[])
            return (_guard_defined(in_vars) +
                    [t_def, f_def, ast.Return(value=call)])

        stores = sorted(_stores(branches))
        self.locals.update(stores)
        in_vars = sorted(((_loads(branches) | _loads([node.test]))
                          & self.locals) | set(stores))
        out_vars = stores
        if not out_vars:
            # pure side-effect if (e.g. list.append) — run under convert
            # with no outputs
            tname, fname = self._uid("true_fn"), self._uid("false_fn")
            t_def = _make_funcdef(tname, in_vars,
                                  node.body + [_return_tuple([])])
            f_def = _make_funcdef(fname, in_vars,
                                  (node.orelse or [ast.Pass()]) +
                                  [_return_tuple([])])
            call = ast.Call(func=_jst_attr("convert_ifelse"),
                            args=[test, _name_load(tname), _name_load(fname),
                                  _tuple_load(in_vars)],
                            keywords=[])
            return (_guard_defined(in_vars) +
                    [t_def, f_def, ast.Expr(value=call)])

        tname, fname = self._uid("true_fn"), self._uid("false_fn")
        t_def = _make_funcdef(tname, in_vars,
                              node.body + [_return_tuple(out_vars)])
        f_def = _make_funcdef(fname, in_vars,
                              (node.orelse or [ast.Pass()]) +
                              [_return_tuple(out_vars)])
        call = ast.Call(func=_jst_attr("convert_ifelse"),
                        args=[test, _name_load(tname), _name_load(fname),
                              _tuple_load(in_vars)],
                        keywords=[])
        assign = ast.Assign(targets=[_tuple_store(out_vars)], value=call)
        return _guard_defined(set(in_vars) | set(out_vars)) + \
            [t_def, f_def, assign]

    # ---- while -------------------------------------------------------
    def visit_While(self, node):
        self.generic_visit(node)
        test = self._convert_test(node.test)
        unsupported = (_has_node(node.body, (ast.Return,))
                       or _loop_controls_for_body(node.body)
                       or node.orelse)
        if unsupported:
            node.test = ast.Call(
                func=_jst_attr("assert_not_traced"),
                args=[test, ast.Constant(
                    value="'while' with break/continue/return/else")],
                keywords=[])
            return node

        stores = sorted(_stores(node.body))
        self.locals.update(stores)
        loop_vars = sorted((set(stores) |
                            (_loads([node.test]) & self.locals)))
        cname, bname = self._uid("while_cond"), self._uid("while_body")
        c_def = _make_funcdef(cname, loop_vars, [ast.Return(value=test)])
        b_def = _make_funcdef(bname, loop_vars,
                              node.body + [_return_tuple(loop_vars)])
        call = ast.Call(func=_jst_attr("convert_while"),
                        args=[_name_load(cname), _name_load(bname),
                              _tuple_load(loop_vars)],
                        keywords=[])
        assign = ast.Assign(targets=[_tuple_store(loop_vars)], value=call)
        return _guard_defined(loop_vars) + [c_def, b_def, assign]

    # ---- for range() -------------------------------------------------
    def visit_For(self, node):
        self.generic_visit(node)
        rng = _parse_range_for(node)
        unsupported = (_has_node(node.body, (ast.Return,))
                       or _loop_controls_for_body(node.body)
                       or node.orelse)
        if rng is None or unsupported:
            return node  # plain python iteration (unrolls under trace)

        start, stop, step = rng
        ivar = node.target.id
        start_v = self._uid("start")
        stop_v = self._uid("stop")
        step_v = self._uid("step")
        self.locals.update({ivar, start_v, stop_v, step_v})
        pre = [ast.Assign(targets=[_name_store(start_v)], value=start),
               ast.Assign(targets=[_name_store(stop_v)], value=stop),
               ast.Assign(targets=[_name_store(step_v)], value=step),
               ast.Assign(targets=[_name_store(ivar)],
                          value=_name_load(start_v))]

        stores = sorted(set(_stores(node.body)) | {ivar})
        self.locals.update(stores)
        loop_vars = sorted(set(stores) | {ivar, stop_v, step_v})
        test = ast.Call(func=_jst_attr("range_cond"),
                        args=[_name_load(ivar), _name_load(stop_v),
                              _name_load(step_v)],
                        keywords=[])
        incr = ast.Assign(
            targets=[_name_store(ivar)],
            value=ast.BinOp(left=_name_load(ivar), op=ast.Add(),
                            right=_name_load(step_v)))
        cname, bname = self._uid("for_cond"), self._uid("for_body")
        c_def = _make_funcdef(cname, loop_vars, [ast.Return(value=test)])
        b_def = _make_funcdef(bname, loop_vars,
                              node.body + [incr, _return_tuple(loop_vars)])
        call = ast.Call(func=_jst_attr("convert_while"),
                        args=[_name_load(cname), _name_load(bname),
                              _tuple_load(loop_vars)],
                        keywords=[])
        assign = ast.Assign(targets=[_tuple_store(loop_vars)], value=call)
        fixup = ast.Assign(
            targets=[_name_store(ivar)],
            value=ast.Call(func=_jst_attr("range_final"),
                           args=[_name_load(ivar), _name_load(start_v),
                                 _name_load(stop_v), _name_load(step_v)],
                           keywords=[]))
        return pre + \
            _guard_defined(set(loop_vars) - {ivar, start_v, stop_v, step_v}) \
            + [c_def, b_def, assign, fixup]


def _empty_args():
    return ast.arguments(posonlyargs=[], args=[], vararg=None,
                         kwonlyargs=[], kw_defaults=[], kwarg=None,
                         defaults=[])


def _make_funcdef(name, argnames, body):
    return ast.FunctionDef(
        name=name,
        args=ast.arguments(
            posonlyargs=[],
            args=[ast.arg(arg=a, annotation=None) for a in argnames],
            vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None,
            defaults=[]),
        body=body or [ast.Pass()],
        decorator_list=[],
        returns=None)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

import weakref

# Keyed on the FUNCTION OBJECT (weakly), not fn.__code__: two closures
# produced by the same factory share one code object but capture different
# cell values, which the conversion bakes into its globals snapshot.
_CONVERT_CACHE = weakref.WeakKeyDictionary()


def _cache_put(fn, converted):
    try:
        _CONVERT_CACHE[fn] = converted
    except TypeError:
        pass


def _needs_conversion(tree):
    return any(isinstance(node, (ast.If, ast.While, ast.For))
               for node in ast.walk(tree))


def convert_to_static(fn):
    """AST-convert a function's Python control flow for tracing.  Returns
    the converted function, or ``fn`` unchanged when there is nothing to
    convert or the source is unavailable (builtins, REPL lambdas)."""
    try:
        cached = _CONVERT_CACHE.get(fn)
    except TypeError:
        cached = None  # non-weakref-able callables (builtins, partials)
    if cached is not None:
        return cached
    code = getattr(fn, "__code__", None)
    if code is not None and "__class__" in code.co_freevars:
        # zero-arg super() needs the compiler-provided __class__ cell,
        # which a module-level recompile cannot reproduce — leave the
        # function unconverted rather than break it at call time
        return fn
    try:
        source = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(source)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return fn
    if not isinstance(tree.body[0], (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
        return fn
    func_def = tree.body[0]
    if not _needs_conversion(func_def):
        _cache_put(fn, fn)
        return fn
    func_def.decorator_list = []

    # pass 0: returns inside loops -> flag/value slots + break (must run
    # first so pass 1 sees the synthesized post-loop return-if and pass 2
    # sees the injected break).
    ril = _ReturnInLoopLowering()
    ril_body = []
    for s in func_def.body:
        r = ril.visit(s)
        ril_body.extend(r if isinstance(r, list) else [r])
    func_def.body = ril_body

    # pass 1: early-return restructuring; pass 2: break/continue lowering.
    # Both are pure AST->AST and must run before the control-flow
    # transformer so it only ever sees jump-free loops and tail returns.
    _lower_returns(func_def)
    jl = _JumpLowering()
    lowered_body = []
    for s in func_def.body:
        r = jl.visit(s)
        lowered_body.extend(r if isinstance(r, list) else [r])
    func_def.body = lowered_body

    arg_names = {a.arg for a in (func_def.args.posonlyargs +
                                 func_def.args.args +
                                 func_def.args.kwonlyargs)}
    if func_def.args.vararg:
        arg_names.add(func_def.args.vararg.arg)
    if func_def.args.kwarg:
        arg_names.add(func_def.args.kwarg.arg)
    local_names = arg_names | _stores(func_def.body)

    transformer = _ControlFlowTransformer(local_names)
    func_def.body = [transformer.visit(s) for s in func_def.body]
    # flatten lists returned by statement replacements
    def _flatten(stmts):
        out = []
        for s in stmts:
            if isinstance(s, list):
                out.extend(_flatten(s))
            else:
                out.append(s)
        return out
    func_def.body = _flatten(func_def.body)
    ast.fix_missing_locations(tree)

    import sys
    import types
    # the converted function's globals are a module of their own,
    # registered in sys.modules: torch's while_loop traces its body with
    # dynamo, which finds a function's globals through its module's name
    # and would not find the copy's extra names in the original module
    mod = types.ModuleType(f"{__name__}._converted_{next(_MODULE_IDS)}")
    glb = mod.__dict__
    glb.update(getattr(fn, "__globals__", {}))
    glb["__name__"] = mod.__name__
    sys.modules[mod.__name__] = mod
    glb[_JST] = sys.modules[__name__]
    if getattr(fn, "__closure__", None):
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                glb[name] = cell.cell_contents
            except ValueError:
                pass
    try:
        code = compile(tree, filename=f"<dy2static:{fn.__name__}>",
                       mode="exec")
        exec(code, glb)
        converted = glb[func_def.name]
    except Exception:
        return fn  # conversion must never break a function that traces fine
    converted = functools.wraps(fn)(converted)
    converted.__ptpu_dy2static__ = True
    _cache_put(fn, converted)
    return converted
