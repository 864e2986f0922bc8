"""The port's dy2static (``paddle_tpu_torch.jit.dy2static``) and
``to_static`` held against the JAX package's, case for case with
``tests/test_dy2static.py``, on the same numpy inputs.

Each case runs the function three ways: the reference's ``to_static``
(traced by ``jax.jit``: its control flow lowers to ``lax``), the port's
``to_static`` (the converted function, eagerly) and, where the case's
predicate is a tensor, the port's traced path: ``jit.save`` exports the
converted function with ``torch.export`` (``torch.cond`` /
``while_loop``) and ``jit.load`` runs the program on the CPU.  Outputs
agree within ``rtol 1e-6`` (float32).  The reference's cases that expect
a trace-time error hold the port's export to the same error class.
"""

import itertools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import to_static as ref_to_static
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch.jit import InputSpec
from paddle_tpu_torch.jit import to_static
from paddle_tpu_torch.jit.dy2static import Undefined, convert_to_static

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    if hasattr(v, "_value"):
        return np.asarray(v._value)
    return np.asarray(v)


def _args(args, make):
    return [make(a) if isinstance(a, np.ndarray) else a for a in args]


def _ref(x):
    return paddle.to_tensor(np.asarray(x, dtype=np.float32))


def _tor(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _a(x):
    return np.asarray(x, dtype=np.float32)


def _same(got, want, msg=""):
    gs = got if isinstance(got, (tuple, list)) else (got,)
    ws = want if isinstance(want, (tuple, list)) else (want,)
    assert len(gs) == len(ws), msg
    for g, w in zip(gs, ws):
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, err_msg=msg)


def _exported(f, args, tmp_path, name):
    """The port's traced path: ``jit.save`` of the converted ``f`` with
    the numpy arguments of ``args`` as inputs (the others bound); returns
    the loaded program, on the CPU."""
    pos = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]
    conv = convert_to_static(f)

    def g(*ts):
        it = iter(ts)
        return conv(*[next(it) if i in pos else a
                      for i, a in enumerate(args)])

    prefix = str(tmp_path / name)
    tjit.save(g, prefix, input_spec=[InputSpec(args[i].shape, "float32")
                                     for i in pos])
    loaded = tjit.load(prefix, device="cpu")
    return lambda *a: loaded(*[_tor(v) for v in a
                               if isinstance(v, np.ndarray)])


def exported(f, args, tmp_path, name="f"):
    return _exported(f, args, tmp_path, name)(*args)


def check(f, *cases, tmp_path=None, eager=None):
    """For each case (a tuple of arguments: numpy arrays become tensors):
    the reference's ``to_static`` vs the port's, eager Python vs the
    port's, and, with ``tmp_path``, the port's exported program (one
    export per set of bound non-array arguments) vs the reference.
    ``eager`` maps a case to the arguments of the plain Python call."""
    programs = {}
    for n, args in enumerate(cases):
        want = ref_to_static(f)(*_args(args, _ref))
        _same(to_static(f)(*_args(args, _tor)), want, f"to_static {n}")
        plain = eager(args) if eager else args
        _same(f(*_args(plain, _tor)), want, f"eager {n}")
        if tmp_path is not None:
            key = tuple((i, a) for i, a in enumerate(args)
                        if not isinstance(a, np.ndarray))
            if key not in programs:
                programs[key] = _exported(f, args, tmp_path,
                                          f"f{len(programs)}")
            _same(programs[key](*args), want, f"exported {n}")


def test_tensor_if_matches_eager(tmp_path):
    def f(x):
        if x.mean() > 0:
            y = x * 2.0
        else:
            y = x - 1.0
        return y

    check(f, *[(_a([sign * 1.5, sign * 0.5]),) for sign in (1.0, -1.0)],
          tmp_path=tmp_path)


class _RefNet(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = paddle.nn.Linear(4, 4)

    def forward(self, x):
        h = self.fc(x)
        if h.mean() > 0:
            out = paddle.nn.functional.relu(h)
        else:
            out = h * 0.1
        return out


class _PortNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        from paddle_tpu_torch import nn
        self.fc = nn.Linear(4, 4, device="cpu")

    def forward(self, x):
        from paddle_tpu_torch.nn import functional as F
        h = self.fc(x)
        if h.mean() > 0:
            out = F.relu(h)
        else:
            out = h * 0.1
        return out


def test_if_model_layer(tmp_path):
    paddle.seed(0)
    rnet = _RefNet()
    pnet = _PortNet()
    with torch.no_grad():
        pnet.fc.weight.copy_(torch.tensor(np.asarray(
            rnet.fc.weight._value)).t())
        pnet.fc.bias.copy_(torch.tensor(np.asarray(rnet.fc.bias._value)))
    x = np.random.default_rng(0).standard_normal((2, 4)).astype(np.float32)
    for sign in (1.0, -1.0):
        want = ref_to_static(rnet)(_ref(sign * x))
        got = to_static(pnet)(_tor(sign * x))
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-6)
    tjit.save(pnet, str(tmp_path / "net"),
              input_spec=[InputSpec([2, 4], "float32")])
    loaded = tjit.load(str(tmp_path / "net"), device="cpu")
    for sign in (1.0, -1.0):
        np.testing.assert_allclose(
            _np(loaded(_tor(sign * x))), _np(rnet(_ref(sign * x))),
            rtol=1e-5, atol=1e-6)


def test_if_without_else_and_new_var(tmp_path):
    def f(x):
        y = x
        if x.sum() > 0:
            y = y + 10.0
        return y

    check(f, *[(_a(v),) for v in ([1.0, 2.0], [-1.0, -2.0])],
          tmp_path=tmp_path)


def test_while_tensor_cond(tmp_path):
    def f(x):
        s = x
        while s.sum() < 100.0:
            s = s * 2.0
        return s

    check(f, (_a([1.0, 2.0]),), tmp_path=tmp_path)


def test_for_range_traced_bound(tmp_path):
    def f(x, n):
        acc = x
        for i in range(n):
            acc = acc + 1.0
        return acc

    want = ref_to_static(f)(_ref([0.0, 0.0]),
                            paddle.to_tensor(np.int32(5)))
    got = to_static(f)(_tor([0.0, 0.0]), torch.tensor(5, dtype=torch.int32))
    _same(got, want)
    np.testing.assert_allclose(_np(got), [5.0, 5.0])
    prefix = str(tmp_path / "f")
    tjit.save(convert_to_static(f), prefix,
              input_spec=[InputSpec([2], "float32"), InputSpec([], "int32")])
    out = tjit.load(prefix, device="cpu")(_tor([0.0, 0.0]),
                                          torch.tensor(5, dtype=torch.int32))
    _same(out, want)


def test_for_range_python_bound(tmp_path):
    def f(x):
        acc = x * 0.0
        for i in range(3):
            acc = acc + x
        return acc

    check(f, (_a([1.0, 2.0]),), tmp_path=tmp_path)


def test_for_range_post_loop_var_matches_python(tmp_path):
    def f(x):
        for i in range(3):
            x = x + i
        return x * i

    check(f, (_a([1.0]),), tmp_path=tmp_path)


def test_closure_factory_not_cross_cached():
    def make(scale):
        def f(x):
            if x.mean() > 0:
                y = x * scale
            else:
                y = x
            return y
        return f

    fa, fb = make(2.0), make(3.0)
    for f, want in ((fa, 2.0), (fb, 3.0)):
        ref = ref_to_static(f)(_ref([1.0]))
        got = to_static(f)(_tor([1.0]))
        _same(got, ref)
        np.testing.assert_allclose(_np(got), [want])


def test_nested_if_in_while(tmp_path):
    def f(x):
        s = x
        while s.sum() < 50.0:
            if s.mean() > 5.0:
                s = s + 10.0
            else:
                s = s * 2.0
        return s

    check(f, (_a([1.0, 2.0]),), tmp_path=tmp_path)


def test_both_branches_return(tmp_path):
    def f(x):
        if x.mean() > 0:
            return x * 2.0
        else:
            return x - 1.0

    check(f, *[(_a([sign, sign * 2.0]),) for sign in (1.0, -1.0)],
          tmp_path=tmp_path)


def test_one_sided_return_converts(tmp_path):
    def f(x):
        if x.mean() > 0:
            return x * 2.0
        return x - 1.0

    check(f, *[(_a([sign, sign * 2.0]),) for sign in (1.0, -1.0)],
          tmp_path=tmp_path)


def test_one_sided_return_with_trailing_code(tmp_path):
    def f(x):
        y = x + 1.0
        if y.mean() > 2.0:
            return y * 10.0
        y = y * 2.0
        return y + 0.5

    check(f, *[(_a(v),) for v in ([5.0], [-5.0])],
          tmp_path=tmp_path)


def test_while_break_traced_parity(tmp_path):
    def f(x, limit):
        s = x
        while s.sum() < limit:
            s = s * 2.0
            if s.max() > 30.0:
                break
        return s

    check(f, *[(_a([start]), _a(limit))
               for start, limit in ((1.0, 100.0), (1.0, 4.0), (50.0, 10.0))],
          tmp_path=tmp_path)


def test_while_true_break_pattern(tmp_path):
    def f(x):
        s = x
        while True:
            s = s + 1.0
            if s.sum() > 10.0:
                break
        return s

    check(f, *[(_a([v]),) for v in (0.0, 9.5, 42.0)],
          tmp_path=tmp_path)


def test_for_range_continue_traced_parity(tmp_path):
    def f(x, n):
        s = x
        for i in range(n):
            if s.sum() > 6.0:
                continue
            s = s + float(1.0)
        return s

    check(f, (_a([0.0]), _a(10)), tmp_path=tmp_path,
          eager=lambda args: (args[0], 10))


def test_for_range_break_loop_var_value(tmp_path):
    def f(x, n):
        s = x
        for i in range(n):
            s = s + 1.0
            if s.sum() > 3.0:
                break
        return s + i

    check(f, (_a([0.0]), 10), tmp_path=tmp_path)


def test_for_else_and_while_else(tmp_path):
    def f(x, thresh):
        s = x
        for i in range(4):
            s = s + 1.0
            if s.sum() > thresh:
                break
        else:
            s = s * 10.0
        return s

    check(f, *[(_a([0.0]), _a(thresh),) for thresh in (2.0, 100.0)],
          tmp_path=tmp_path)


def test_return_inside_traced_while_loop(tmp_path):
    def f(x, limit):
        s = x
        while s.sum() < limit:
            s = s * 2.0
            if s.max() > 30.0:
                return s + 100.0
        return s

    check(f, *[(_a(v), _a(lim))
               for v, lim in (([1.0], 100.0), ([1.0], 8.0), ([50.0], 10.0))],
          tmp_path=tmp_path)


def test_return_inside_for_loop_traced_cond(tmp_path):
    def f(x):
        for i in range(5):
            if x.sum() > i:
                return x * i
        return x - 1.0

    check(f, *[(_a(v),) for v in ([1.0, 2.0], [100.0, 1.0], [-5.0, 0.0])],
          tmp_path=tmp_path)


def test_return_inside_nested_loops(tmp_path):
    def f(x):
        for i in range(3):
            for j in range(3):
                if (x.sum() + i + j) > 4.0:
                    return x * (i * 10 + j)
        return x - 7.0

    check(f, *[(_a(v),) for v in ([1.0, 2.0], [-9.0, 0.0], [9.0, 9.0])],
          tmp_path=tmp_path)


def test_return_inside_noniterator_for(tmp_path):
    def f(x):
        for w in [0.5, 1.5, 2.5]:
            if x.sum() < w:
                return x * w
        return x * 0.0

    check(f, *[(_a(v),) for v in ([0.4, 0.0], [2.0, 0.0], [9.0, 9.0])],
          tmp_path=tmp_path)


def test_tuple_return_inside_traced_loop(tmp_path):
    def f(x, lim):
        s = x
        while s.sum() < lim:
            s = s + s
            if s.sum() > 30.0:
                return s + 100.0, s
        return s, s * 2.0

    check(f, *[(_a(v), _a(lim)) for v, lim in (([1.0], 100.0), ([1.0], 8.0))],
          tmp_path=tmp_path)


def test_bare_return_inside_loop_keeps_clear_error(tmp_path):
    def f(x):
        for i in range(3):
            if x.sum() > i:
                return
        return x

    with pytest.raises(NotImplementedError):
        ref_to_static(f)(_ref([5.0]))
    # eagerly the predicate is concrete, so the port runs Python's return
    assert to_static(f)(_tor([5.0])) is None
    with pytest.raises(NotImplementedError):
        exported(f, [_a([5.0])], tmp_path)


def test_logical_ops_in_predicate(tmp_path):
    def f(x):
        if x.mean() > 0 and x.max() < 10.0:
            y = x + 1.0
        else:
            y = x - 1.0
        return y

    check(f, *[(_a(v),) for v in ([1.0, 2.0], [-1.0, 2.0], [1.0, 20.0])],
          tmp_path=tmp_path)


def test_not_in_predicate(tmp_path):
    def f(x):
        if not (x.mean() > 0):
            y = x * 3.0
        else:
            y = x
        return y

    check(f, *[(_a([sign]),) for sign in (1.0, -1.0)],
          tmp_path=tmp_path)


def test_var_defined_only_in_branches(tmp_path):
    def f(x):
        if x.mean() > 0:
            z = x * 2.0
        else:
            z = x * -3.0
        return z + 1.0

    check(f, *[(_a([sign, sign]),) for sign in (1.0, -1.0)],
          tmp_path=tmp_path)


def test_grad_through_converted_if():
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.jit.dy2static import convert_to_static as ref_convert

    def f(x):
        if x.mean() > 0:
            y = (x * x).sum()
        else:
            y = (x * 3.0).sum()
        return y

    rconv = ref_convert(f)
    pconv = convert_to_static(f)

    def pure(xa):
        out = rconv(Tensor(xa))
        return out._value if isinstance(out, Tensor) else out

    for sign in (1.0, -1.0):
        xa = np.asarray([sign * 1.0, sign * 2.0], np.float32)
        want = jax.grad(pure)(jnp.asarray(xa))
        xt = torch.tensor(xa, requires_grad=True)
        pconv(xt).backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want),
                                   rtol=RTOL)


def test_conversion_cache_and_unconvertible_passthrough():
    def plain(x):
        return x + 1

    assert convert_to_static(plain) is plain
    assert convert_to_static(plain) is plain
    assert convert_to_static(len) is len


def test_nested_loop_break_only_exits_inner():
    def f(x):
        s = x
        for i in range(3):
            for j in range(5):
                s = s + 1.0
                if s.sum() > 4.0:
                    break
            s = s + 0.25
        return s

    # the unrolled traced breaks of range loops are exported in
    # test_return_inside_nested_loops; here eagerly and by the reference
    check(f, (_a([0.0]),))


def test_continue_skips_rest_concrete_and_traced(tmp_path):
    def f(x, flag):
        out = x
        i = 0
        while i < 6:
            i = i + 1
            if flag and i % 2 == 0:
                continue
            out = out + 10.0
        return out

    check(f, *[(_a([0.0]), flag,) for flag in (True, False)],
          tmp_path=tmp_path)


def test_break_does_not_reevaluate_condition(tmp_path):
    def f(x):
        vals = [1.0, 2.0, 3.0]
        i = 0
        while vals[i] > 0:
            x = x + vals[i]
            i = i + 1
            if i == len(vals):
                break
        return x

    check(f, (_a([0.0]),), tmp_path=tmp_path)


def test_generator_break_stops_consumption(tmp_path):
    def f(x):
        n = 0
        for v in itertools.count():
            x = x + 1.0
            n = n + 1
            if n >= 3:
                break
        return x

    check(f, (_a([0.0]),), tmp_path=tmp_path)


class _RefBase(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = paddle.nn.Linear(4, 4)

    def forward(self, x):
        return self.fc(x)


class _RefChild(_RefBase):
    def forward(self, x):
        y = super().forward(x)
        for i in range(2):
            y = y + 1.0
        return y


class _PortBase(torch.nn.Module):
    def __init__(self):
        super().__init__()
        from paddle_tpu_torch import nn
        self.fc = nn.Linear(4, 4, device="cpu")

    def forward(self, x):
        return self.fc(x)


class _PortChild(_PortBase):
    def forward(self, x):
        y = super().forward(x)
        for i in range(2):
            y = y + 1.0
        return y


def test_jit_save_super_forward(tmp_path):
    paddle.seed(0)
    rnet, pnet = _RefChild(), _PortChild()
    rnet.eval()
    with torch.no_grad():
        pnet.fc.weight.copy_(torch.tensor(np.asarray(
            rnet.fc.weight._value)).t())
        pnet.fc.bias.copy_(torch.tensor(np.asarray(rnet.fc.bias._value)))
    x = np.random.default_rng(0).standard_normal((2, 4)).astype(np.float32)
    ref = rnet(_ref(x))
    paddle.jit.save(rnet, str(tmp_path / "r"),
                    input_spec=[paddle.static.InputSpec([2, 4], "float32")])
    tjit.save(pnet, str(tmp_path / "p"),
              input_spec=[InputSpec([2, 4], "float32")])
    want = paddle.jit.load(str(tmp_path / "r"))(_ref(x))
    got = tjit.load(str(tmp_path / "p"), device="cpu")(_tor(x))
    np.testing.assert_allclose(_np(want), _np(ref), rtol=1e-5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


def test_noniterator_for_break_loop_var_traced(tmp_path):
    def f(x):
        w = 0.0
        for w in [0.1, 0.2, 0.3]:
            if x.sum() < w:
                break
        return x * w

    check(f, *[(_a(v),) for v in ([0.01, 0.01], [0.15, 0.0], [5.0, 5.0])],
          tmp_path=tmp_path)


def test_noniterator_for_break_tuple_target():
    def f(x):
        a, b = 0.0, 0.0
        for a, b in [(0.1, 1.0), (0.2, 2.0), (0.3, 3.0)]:
            if x.sum() < a:
                break
        return x * a + b

    # the same lowering is exported in
    # test_noniterator_for_break_loop_var_traced
    check(f, *[(_a(v),) for v in ([0.01, 0.01], [0.15, 0.0], [5.0, 5.0])])


def test_for_break_body_mutation_of_loop_var():
    def f(x):
        for a in [1.0, 2.0, 3.0]:
            a = a * 10.0
            if x.sum() > a:
                break
        return x + a

    # the same lowering is exported in test_return_inside_noniterator_for
    check(f, *[(_a(v),) for v in ([100.0], [15.0], [0.5])])


def test_for_continue_body_mutation_of_loop_var(tmp_path):
    def f(x):
        for a in [1.0, 2.0, 3.0]:
            a = a * 10.0
            if a > 15.0:
                continue
            a = a + 0.5
        return x + a

    check(f, (_a([1.0]),), tmp_path=tmp_path)


def test_for_subscript_target_break_no_clobber(tmp_path):
    def f(x):
        d = [0.0, 0.0, 0.0, 0.0]
        i = 0
        for d[i] in [1.0, 2.0, 3.0]:
            i += 1
            if d[0] > 100.0:
                break
        return x + i

    check(f, (_a([1.0]),), tmp_path=tmp_path)


def test_traced_while_undefined_carry_clear_error(tmp_path):
    def f(x):
        i = 0
        while (x + i).sum() < 10.0:
            if i > 5:
                y = x * 2.0
            i += 1
        return y

    with pytest.raises(NotImplementedError, match="unbound at loop entry"):
        ref_to_static(f)(_ref([0.5, 0.5]))
    # eagerly the loop runs in Python and never binds y: Python raises,
    # the converted function returns dy2static's unbound sentinel
    with pytest.raises(UnboundLocalError):
        f(_tor([0.5, 0.5]))
    assert isinstance(to_static(f)(_tor([0.5, 0.5])), Undefined)
    with pytest.raises(NotImplementedError, match="unbound at loop entry"):
        exported(f, [_a([0.5, 0.5])], tmp_path)


class _RefMethodNet(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.s = 2.0

    def forward(self, x):
        y = x
        for i in range(2):
            y = y + self.s
        return y


class _PortMethodNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.s = 2.0

    def forward(self, x):
        y = x
        for i in range(2):
            y = y + self.s
        return y


def test_jit_save_bound_method(tmp_path):
    x = _a([1.0, 2.0])
    rnet, pnet = _RefMethodNet(), _PortMethodNet()
    paddle.jit.save(rnet.forward, str(tmp_path / "r"),
                    input_spec=[paddle.static.InputSpec([2], "float32")])
    tjit.save(pnet.forward, str(tmp_path / "p"),
              input_spec=[InputSpec([2], "float32")])
    want = paddle.jit.load(str(tmp_path / "r"))(_ref(x))
    got = tjit.load(str(tmp_path / "p"), device="cpu")(_tor(x))
    _same(got, want)
    _same(got, pnet(_tor(x)))


def test_return_in_try_inside_loop_keeps_clear_error(tmp_path):
    def f(x, lim):
        s = x
        while s.sum() < lim:
            s = s * 2.0
            try:
                if s.max() > 30.0:
                    return s + 100.0
            finally:
                pass
        return s

    with pytest.raises(NotImplementedError):
        ref_to_static(f)(_ref([1.0]), _ref(100.0))
    _same(to_static(f)(_tor([1.0]), _tor(100.0)),
          f(_tor([1.0]), _tor(100.0)))
    with pytest.raises(NotImplementedError):
        exported(f, [_a([1.0]), _a(100.0)], tmp_path)


def test_return_in_try_concrete_loop_still_works(tmp_path):
    def f(x):
        for i in range(4):
            try:
                if i == 2:
                    return x * i
            finally:
                pass
        return x - 1.0

    check(f, (_a([3.0]),), tmp_path=tmp_path)
