"""The autograd surface of the port (``core.tape``, the per-use hooks of
``core.tensor``, ``autograd``) held against the reference.

Each case of ``tests/test_autograd.py`` (twelve) and
``tests/test_double_backward.py`` (six) runs in both packages on the same
numpy inputs and the results are compared; then the probes that tell the
two autograd rules apart (a hook per consuming op, ``stop_gradient`` on a
non-leaf), torch's in-place refusal, ``PyLayer``, the functional
transforms and ``no_grad`` as a decorator.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    from paddle_tpu_torch import device as tdevice
    prev = tdevice._layer_device
    pt.set_device("cpu")
    yield
    tdevice._layer_device = prev


def _np(t):
    if t is None:
        return None
    return np.asarray(t._value) if hasattr(t, "_value") else t.numpy()


def _same(case):
    """Run ``case(P)`` in both packages and compare what it returns."""
    want, got = case(paddle), case(pt)
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        if w is None or isinstance(w, (bool, int, str)):
            assert w == g, (i, w, g)
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"result {i}")


# ---- tests/test_autograd.py ----

def _accumulation(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    (x * 2).sum().backward()
    g1 = _np(x.grad)
    (x * 3).sum().backward()
    g2 = _np(x.grad)
    x.clear_grad()
    return [g1, g2, x.grad is None]


def _no_grad(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    with P.no_grad():
        y = x * 2
    return [bool(y.stop_gradient)]


def _stop_gradient_leaf(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    y = P.to_tensor([3.0, 4.0])
    (x * y).sum().backward()
    return [_np(x.grad), y.grad is None]


def _grad_api(P):
    x = P.to_tensor(2.0, stop_gradient=False)
    y = P.to_tensor(3.0, stop_gradient=False)
    gx, gy = P.grad(x * x * y, [x, y])
    return [float(gx), float(gy), x.grad is None]


def _register_hook(P):
    x = P.to_tensor([1.0, 1.0], stop_gradient=False)
    seen = []

    def hook(g):
        seen.append(_np(g).copy())
        return g * 2

    x.register_hook(hook)
    (x * 3).sum().backward()
    return [len(seen), _np(x.grad)]


def _retain_graph(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    z = x * 2 * 3
    z.backward(retain_graph=True)
    z.backward(retain_graph=False)
    return [_np(x.grad)]


def _multi_output(P):
    x = P.to_tensor(np.array([[3., 1., 2.]], np.float32),
                    stop_gradient=False)
    vals, idx = P.topk(x, 2)
    vals.sum().backward()
    return [_np(x.grad), _np(idx)]


def _pylayer(P):
    class Double(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2

        @staticmethod
        def backward(ctx, grad):
            (x,) = ctx.saved_tensor()
            return grad * 2

    x = P.to_tensor([1.5], stop_gradient=False)
    y = Double.apply(x)
    y.backward()
    return [_np(y), _np(x.grad)]


def _functional(P):
    def f(x):
        return x * x

    x = P.to_tensor([1.0, 2.0])
    _, g = P.autograd.vjp(f, x)
    _, t = P.autograd.jvp(f, x)
    j = P.autograd.jacobian(f, x)
    return [_np(g), _np(t), _np(j)]


def _double_use(P):
    x = P.to_tensor([2.0], stop_gradient=False)
    (x * x).backward()
    return [_np(x.grad)]


def _diamond(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    (x * 2 + x * 3).backward()
    return [_np(x.grad)]


def _detach(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    y = (x * 2).detach()
    z = y * 3
    z.backward()
    return [x.grad is None]


# ---- tests/test_double_backward.py ----

def _poly(P):
    x = P.to_tensor(np.float32([2.0, -1.5]), stop_gradient=False)
    (g1,) = P.grad((x * x * x).sum(), [x], create_graph=True)
    (g2,) = P.grad(g1.sum(), [x])
    return [_np(g1), _np(g2)]


def _matmul_tanh(P):
    wn = np.random.default_rng(0).standard_normal((3, 3)).astype(np.float32)
    xn = np.random.default_rng(1).standard_normal((3,)).astype(np.float32)
    x = P.to_tensor(xn, stop_gradient=False)
    w = P.to_tensor(wn)
    y = P.tanh(P.matmul(w, x)).sum()
    (g1,) = P.grad(y, [x], create_graph=True)
    (g2,) = P.grad(g1.sum(), [x])
    return [_np(g1), _np(g2)]


def _linear(P, i, o, src=None):
    """A Linear of each package; the port's carries the reference's
    weights (``[in, out]`` there, ``[out, in]`` here)."""
    if P is paddle:
        lin = P.nn.Linear(i, o)
        # the weights as made (the reference's case may train them)
        lin.initial = (np.array(lin.weight._value, copy=True),
                       np.array(lin.bias._value, copy=True))
        return lin
    lin = P.nn.Linear(i, o, device="cpu")
    w, b = src.initial
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
        lin.bias.copy_(torch.from_numpy(b.copy()))
    return lin


_LAYERS = {}


def _through_layers(P):
    if P is paddle:
        paddle.seed(7)
        _LAYERS["lin"] = lin = _linear(P, 4, 1)
    else:
        lin = _linear(P, 4, 1, _LAYERS["lin"])
    x = P.to_tensor(np.random.default_rng(2).standard_normal(
        (2, 4)).astype(np.float32), stop_gradient=False)
    y = P.nn.functional.softplus(lin(x)).sum()
    (gx,) = P.grad(y, [x], create_graph=True)
    (gx * gx).sum().backward()
    w = _np(lin.weight.grad)
    return [_np(gx), w if P is paddle else w.T]


def _penalty_training(P):
    if P is paddle:
        paddle.seed(0)
        l1, l2 = _linear(P, 4, 8), _linear(P, 8, 1)
        _LAYERS["gp"] = (l1, l2)
        net = P.nn.Sequential(l1, P.nn.Tanh(), l2)
        opt = P.optimizer.Adam(learning_rate=5e-2,
                               parameters=net.parameters())
    else:
        j1, j2 = _LAYERS["gp"]
        net = torch.nn.Sequential(_linear(P, 4, 8, j1), torch.nn.Tanh(),
                                  _linear(P, 8, 1, j2))
        opt = P.optimizer.Adam(learning_rate=5e-2,
                               parameters=net.parameters())
    xv = np.random.default_rng(3).standard_normal((8, 4)).astype(
        np.float32)

    def penalty_loss():
        x = P.to_tensor(xv, stop_gradient=False)
        (gx,) = P.grad(net(x).sum(), [x], create_graph=True)
        gnorm = P.sqrt((gx * gx).sum(axis=-1))
        return ((gnorm - 1.0) ** 2).mean()

    first = float(penalty_loss())
    for _ in range(5):
        loss = penalty_loss()
        loss.backward()
        opt.step()
        opt.clear_grad()
    return [first, float(penalty_loss())]


def _pylayer_create_graph(P):
    class Cube(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            return g * 3.0 * x * x

    x = P.to_tensor(np.float32([2.0]), stop_gradient=False)
    (g1,) = P.grad(Cube.apply(x).sum(), [x], create_graph=True)
    (g2,) = P.grad(g1.sum(), [x])
    return [_np(g1), _np(g2)]


def _create_graph_retains(P):
    x = P.to_tensor(np.float32([1.0]), stop_gradient=False)
    (g1,) = P.grad((x * x).sum(), [x], create_graph=True)
    (g2,) = P.grad(g1.sum(), [x])
    return [_np(g2)]


CASES = {
    "grad_accumulation_and_clear": _accumulation, "no_grad": _no_grad,
    "stop_gradient_leaf": _stop_gradient_leaf, "grad_api": _grad_api,
    "register_hook": _register_hook, "retain_graph": _retain_graph,
    "multi_output_op_grad": _multi_output, "pylayer": _pylayer,
    "functional_vjp_jvp_jacobian": _functional,
    "double_use_of_tensor": _double_use, "diamond_graph": _diamond,
    "detach": _detach,
    "grad_of_grad_polynomial": _poly,
    "grad_of_grad_matmul_tanh": _matmul_tanh,
    "second_order_through_layers": _through_layers,
    "gradient_penalty_training": _penalty_training,
    "pylayer_create_graph": _pylayer_create_graph,
    "retain_graph_implied_by_create_graph": _create_graph_retains,
}


@pytest.mark.parametrize("name", list(CASES))
def test_case_matches_reference(name):
    _same(CASES[name])


# ---- the probes that tell the two autograd rules apart ----

def _hook_per_edge(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    calls = []

    def clip(g):
        calls.append(1)
        return P.clip(g, -1.5, 1.5)

    x.register_hook(clip)
    (x * x + x).sum().backward()
    return [len(calls), _np(x.grad)]


def test_hook_fires_once_per_consuming_op():
    _same(_hook_per_edge)
    n, g = _hook_per_edge(pt)
    assert n == 3 and g.tolist() == [3.0, 4.0]


def _nonleaf_cut(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    y = x * 2
    y.stop_gradient = True
    (y * x).sum().backward()
    return [_np(x.grad)]


def test_stop_gradient_on_a_non_leaf_cuts():
    _same(_nonleaf_cut)
    assert _nonleaf_cut(pt)[0].tolist() == [2.0, 4.0]


def test_hook_removed_and_on_torch_calls():
    x = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    calls = []
    h = x.register_hook(lambda g: calls.append(1))
    # a torch method on a facade tensor is a consuming op too
    (torch.sin(x) + x.exp()).sum().backward()
    assert len(calls) == 2
    h.remove()
    (x * 2).sum().backward()
    assert len(calls) == 2


def test_hook_count_follows_the_tensors_life():
    """The count that turns the per-use wrapping on holds only the hooks
    of live tensors: a hooked tensor freed without ``remove()`` stops
    counting (its graph, while alive, still runs the hook), a deep copy
    counts its own, and a late ``remove()`` does not count twice."""
    import copy
    import gc
    from paddle_tpu_torch.core import tensor as T
    gc.collect()
    base = T._hooked[0]
    x = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    y = x * 2
    calls = []
    h = y.register_hook(lambda g: calls.append(1))
    z = (y * y).sum()
    del y
    gc.collect()
    assert T._hooked[0] == base + 1        # the graph holds y
    z.backward()
    assert len(calls) == 2
    del z
    gc.collect()
    assert T._hooked[0] == base
    h.remove()
    assert T._hooked[0] == base
    w = pt.to_tensor([1.0], stop_gradient=False)
    w.register_hook(lambda g: g * 2)
    w2 = copy.deepcopy(w)
    assert T._hooked[0] == base + 2
    (w2 * 3).sum().backward()
    assert w2.grad.tolist() == [6.0]
    del w, w2
    gc.collect()
    assert T._hooked[0] == base


def test_in_place_on_a_leaf_is_refused():
    """The reference lets ``x.add_(y)`` turn a leaf that needs a gradient
    into a non-leaf (which then gets no ``.grad``, ROADMAP Queue 3);
    torch refuses it (README, 'Known differences of the tensor
    facade')."""
    jx = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    jx.add_(paddle.to_tensor([1.0, 1.0]))
    (jx * 2).sum().backward()
    assert jx.grad is None
    x = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    with pytest.raises(RuntimeError, match="leaf Variable"):
        x.add_(pt.to_tensor([1.0, 1.0]))
    with pytest.raises(RuntimeError, match="leaf Variable"):
        x[0] = 3.0
    with pytest.raises(RuntimeError, match="Known differences"):
        pt.reshape_(x, [2, 1])
    y = x * 2          # a non-leaf takes in-place ops, as in torch
    y.add_(1.0)
    y.sum().backward()
    assert x.grad.tolist() == [2.0, 2.0]


def test_view_cannot_be_cut_in_place():
    x = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    v = (x * 2)[:1]
    with pytest.raises(RuntimeError, match="Known differences"):
        v.stop_gradient = True


def test_grad_errors_are_the_references():
    for P in (paddle, pt):
        x = P.to_tensor([1.0, 2.0], stop_gradient=False)
        u = P.to_tensor([3.0], stop_gradient=False)
        with pytest.raises(ValueError, match="appears unused"):
            P.grad((x * 2).sum(), [x, u])
        assert P.grad((x * 2).sum(), [x, u], allow_unused=True)[1] is None
        with pytest.raises(ValueError, match="non-scalar"):
            P.grad(x * 2, [x])
        with pytest.raises(ValueError, match="non-scalar"):
            (x * 2).backward()


def _pylayer_two_inputs(P):
    class Mix(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, a, b, scale=1.0):
            ctx.save_for_backward(a, b)
            ctx.scale = scale
            return a * b * scale

        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensor()
            return g * b * ctx.scale, g * a * ctx.scale

    a = P.to_tensor([1.0, 2.0], stop_gradient=False)
    b = P.to_tensor([3.0, -1.0], stop_gradient=False)
    p = Mix.apply(a, b, scale=2.0)
    (p * p).sum().backward()
    return [_np(p), _np(a.grad), _np(b.grad)]


def test_pylayer_two_inputs_and_kwargs():
    _same(_pylayer_two_inputs)


def test_pylayer_two_outputs_get_both_gradients():
    """The reference's tape hands a PyLayer's backward only its first
    output's gradient (ROADMAP Queue 3); the port hands it one per
    output."""
    class Split(pt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, a):
            return a * 2, a * 3

        @staticmethod
        def backward(ctx, g1, g2):
            return g1 * 2 + g2 * 3

    a = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    p, q = Split.apply(a)
    (p.sum() + (q * q).sum()).backward()
    assert a.grad.tolist() == [2 + 3 * 6.0, 2 + 3 * 12.0]


def _transforms(P):
    def f(x, y):
        return (x * x * y).sum()

    def g(x):
        return P.tanh(x) * x

    x = P.to_tensor([0.5, -1.0, 2.0])
    y = P.to_tensor([1.5, 0.25, -0.5])
    out, (gx, gy) = P.autograd.vjp(f, [x, y])
    _, tan = P.autograd.jvp(g, x, P.to_tensor([1.0, 2.0, 3.0]))
    jx, jy = P.autograd.jacobian(f, [x, y])
    h = P.autograd.hessian(lambda v: (v * v * v).sum(), x)
    (hxx, hxy), (hyx, hyy) = P.autograd.hessian(f, [x, y])
    return [_np(out), _np(gx), _np(gy), _np(tan), _np(jx), _np(jy),
            _np(h), _np(hxx), _np(hxy), _np(hyx), _np(hyy)]


def test_vjp_jvp_jacobian_hessian_structures():
    _same(_transforms)


def test_no_grad_as_a_decorator_and_grad_modes():
    @pt.no_grad()
    def double(x):
        return x * 2

    @pt.no_grad
    def triple(x):
        return x * 3

    x = pt.to_tensor([1.0], stop_gradient=False)
    assert double(x).stop_gradient and triple(x).stop_gradient
    assert pt.is_grad_enabled()
    with pt.set_grad_enabled(False):
        assert not pt.is_grad_enabled()
        with pt.enable_grad():
            assert not (x * 2).stop_gradient
    assert pt.is_grad_enabled()
    pt.set_grad_enabled(False)
    try:
        assert (x * 2).stop_gradient
    finally:
        pt.set_grad_enabled(True)
