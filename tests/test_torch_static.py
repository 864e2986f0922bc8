"""The port's static graph (``paddle_tpu_torch.static``: ``Program``,
``program_guard``, ``data``, ``Executor``, ``append_backward``,
``Optimizer.minimize`` on a program variable, ``static.nn``) and its
control-flow ops (``cond``, ``while_loop``, ``case``, ``switch_case``)
held against the JAX package's, case for case with
``tests/test_static.py`` and ``tests/test_control_flow.py``, on the same
numpy feeds and bridged weights.

The reference's "traced" control-flow cases run under ``jax.jit``
(``lax.cond``/``lax.while_loop``); the port's counterpart is a program
exported by ``jit.save`` (``torch.cond``/``while_loop``) and run by
``jit.load`` on the CPU.  Values agree within ``rtol 1e-6`` (float32);
the Executors run on ``"cpu"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import static as rstatic
from paddle_tpu.core.tensor import Tensor
import paddle_tpu_torch as tpt
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import static
from paddle_tpu_torch.jit import InputSpec

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(v, dtype=torch.float32):
    return torch.tensor(np.asarray(v), dtype=dtype)


def traced(fn, specs, tmp_path, name="f"):
    """``fn`` exported by ``jit.save`` at ``specs`` and loaded on the
    CPU."""
    tjit.save(fn, str(tmp_path / name), input_spec=specs)
    return tjit.load(str(tmp_path / name), device="cpu")


def _hops(loaded):
    return {n.target for n in loaded._artifact.program.graph.nodes
            if n.op == "call_function"} & {torch.ops.higher_order.cond,
                                           torch.ops.higher_order.while_loop}


def _bridge_linear(rlin, tlin):
    with torch.no_grad():
        tlin.weight.copy_(torch.tensor(np.asarray(rlin.weight._value)).t())
        tlin.bias.copy_(torch.tensor(np.asarray(rlin.bias._value)))


# ---------------------------------------------------------------------------
# tests/test_static.py
# ---------------------------------------------------------------------------

def test_program_capture_and_run():
    rng = np.random.default_rng(0)
    xv = rng.random((4, 8)).astype("float32")
    yv = rng.random((4, 8)).astype("float32")
    rprog = rstatic.Program()
    with rstatic.program_guard(rprog):
        x = rstatic.data("x", [4, 8], "float32")
        y = rstatic.data("y", [4, 8], "float32")
        z = paddle.add(paddle.multiply(x, y), paddle.to_tensor(1.0))
        w = z.sum()
    want = rstatic.Executor().run(rprog, feed={"x": xv, "y": yv},
                                  fetch_list=[z, w])
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [4, 8], "float32")
        y = static.data("y", [4, 8], "float32")
        z = torch.add(torch.mul(x, y), torch.tensor(1.0))
        w = z.sum()
    assert len(prog.ops) >= 3
    got = static.Executor("cpu").run(prog, feed={"x": xv, "y": yv},
                                     fetch_list=[z, w])
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-5)
    np.testing.assert_allclose(got[0], xv * yv + 1.0, rtol=1e-6)


def test_program_str_and_missing_feed():
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [2, 2], "float32")
        y = torch.exp(x)
    s = str(prog)
    assert "exp" in s and s.startswith("Program(ops=1, feeds=['x'])")
    with pytest.raises(ValueError, match="missing feed"):
        static.Executor("cpu").run(prog, feed={}, fetch_list=[y])
    with pytest.raises(ValueError, match="missing feed"):
        rprog = rstatic.Program()
        with rstatic.program_guard(rprog):
            ry = paddle.exp(rstatic.data("x", [2, 2], "float32"))
        rstatic.Executor().run(rprog, feed={}, fetch_list=[ry])


def test_symbolic_ops_execute_nothing_eagerly():
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [3], "float32")
        y = torch.sqrt(x)
        # program variables know shape and dtype but hold no data
        assert tuple(y.shape) == (3,) and y.dtype == torch.float32
        assert y.device.type == "meta"
        with pytest.raises(Exception):
            y.tolist()
    t = torch.tensor(np.float32(4.0))
    assert float(torch.sqrt(t)) == 2.0
    assert len(prog.ops) == 1


def test_append_backward_grad_fetch():
    rng = np.random.default_rng(1)
    xv = rng.random((2, 4)).astype("float32")
    rlin = paddle.nn.Linear(4, 3)
    rprog = rstatic.Program()
    with rstatic.program_guard(rprog):
        x = rstatic.data("x", [2, 4], "float32")
        loss = rlin(x).sum()
        rgrads = rstatic.append_backward(loss)
    by_name = {p.name: g for p, g in rgrads}
    (rgw,) = rstatic.Executor().run(rprog, feed={"x": xv},
                                    fetch_list=[by_name[rlin.weight.name]])
    lin = tnn.Linear(4, 3, device="cpu")
    _bridge_linear(rlin, lin)
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [2, 4], "float32")
        loss = lin(x).sum()
        grads = static.append_backward(loss)
    assert grads
    by_id = {id(p): g for p, g in grads}
    gw, gb = static.Executor("cpu").run(
        prog, feed={"x": xv},
        fetch_list=[by_id[id(lin.weight)], by_id[id(lin.bias)]])
    # torch's Linear weight is [out, in]: the reference's transposed
    np.testing.assert_allclose(gw.T, np.asarray(rgw), rtol=1e-5)
    np.testing.assert_allclose(gw.T, xv.T @ np.ones((2, 3), np.float32),
                               rtol=1e-5)
    np.testing.assert_allclose(gb, np.full(3, 2.0, np.float32))


def test_static_training_with_minimize():
    rng = np.random.default_rng(0)
    xv = rng.standard_normal((8, 2)).astype("float32")
    yv = (xv @ np.array([[2.0], [-1.0]], np.float32)).astype("float32")
    rlin = paddle.nn.Linear(2, 1)
    lin = tnn.Linear(2, 1, device="cpu")
    _bridge_linear(rlin, lin)
    rsgd = paddle.optimizer.SGD(learning_rate=0.1,
                                parameters=rlin.parameters())
    sgd = tpt.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
    rprog, prog = rstatic.Program(), static.Program()
    with rstatic.program_guard(rprog):
        x = rstatic.data("x", [8, 2], "float32")
        y = rstatic.data("y", [8, 1], "float32")
        rloss = ((rlin(x) - y) ** 2).mean()
        rsgd.minimize(rloss)
    with static.program_guard(prog):
        x = static.data("x", [8, 2], "float32")
        y = static.data("y", [8, 1], "float32")
        loss = ((lin(x) - y) ** 2).mean()
        sgd.minimize(loss)
    rexe, exe = rstatic.Executor(), static.Executor("cpu")
    rl, tl = [], []
    for _ in range(30):
        rl.append(float(rexe.run(rprog, feed={"x": xv, "y": yv},
                                 fetch_list=[rloss])[0]))
        tl.append(float(exe.run(prog, feed={"x": xv, "y": yv},
                                fetch_list=[loss])[0]))
    assert tl[-1] < tl[0] * 0.1
    np.testing.assert_allclose(tl, rl, rtol=1e-4)
    np.testing.assert_allclose(lin.weight.detach().numpy().T,
                               np.asarray(rlin.weight._value), rtol=1e-4)


def test_executors_at_two_places_share_the_users_parameters():
    """An Executor at another place than the parameters trains a copy
    there and writes each update back: the user's parameters stay where
    they are, and a second Executor at another place (``"cpu:0"`` is
    another place than the parameters' ``cpu``) goes on from them, as
    does the first after a change the user makes in between.  The steps
    equal one Executor's on a copy of the module, with the user's change
    made at the same point."""
    import copy
    rng = np.random.default_rng(1)
    xv = rng.standard_normal((8, 2)).astype("float32")
    yv = (xv @ np.array([[2.0], [-1.0]], np.float32)).astype("float32")
    base = tnn.Linear(2, 1, device="cpu")
    runs = []
    for places in (("cpu:0", "cpu"), ("cpu", "cpu")):
        lin = copy.deepcopy(base)
        weight, ptr = lin.weight, lin.weight.data_ptr()
        sgd = tpt.optimizer.SGD(learning_rate=0.1,
                                parameters=lin.parameters())
        prog = static.Program()
        with static.program_guard(prog):
            x = static.data("x", [8, 2], "float32")
            y = static.data("y", [8, 1], "float32")
            loss = ((lin(x) - y) ** 2).mean()
            sgd.minimize(loss)
        exes = [static.Executor(p) for p in places]
        losses = []
        for i in range(6):
            if i == 4:
                with torch.no_grad():
                    lin.weight.mul_(0.5)
            losses.append(float(exes[i % 2].run(
                prog, feed={"x": xv, "y": yv}, fetch_list=[loss])[0]))
        assert lin.weight is weight and weight.data_ptr() == ptr
        assert weight.device.type == "cpu"
        assert any(c.placed for c in exes[0]._cache.values()) == (
            places[0] == "cpu:0")
        runs.append((losses, weight.detach().clone()))
    (got, w_got), (want, w_want) = runs
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(w_got, w_want, rtol=1e-6, atol=1e-7)


def test_static_nn_fc():
    xv = np.random.default_rng(2).standard_normal((4, 16)).astype("float32")
    rprog = rstatic.Program()
    with rstatic.program_guard(rprog):
        rh = rstatic.nn.fc(rstatic.data("x", [4, 16], "float32"), 8,
                           activation="relu")
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [4, 16], "float32")
        h = static.nn.fc(x, 8, activation="relu")
        assert tuple(h.shape) == (4, 8)
    # the builders' fresh weights: the reference's copied into the port's
    (rw, rb), (w, b) = (sorted(p.all_parameters(),
                               key=lambda t: len(t.shape), reverse=True)
                        for p in (rprog, prog))
    with torch.no_grad():
        w.copy_(torch.tensor(np.asarray(rw._value)).t())
        b.copy_(torch.tensor(np.asarray(rb._value)))
    (want,) = rstatic.Executor().run(rprog, feed={"x": xv}, fetch_list=[rh])
    (hv,) = static.Executor("cpu").run(prog, feed={"x": xv},
                                       fetch_list=[h])
    assert hv.shape == (4, 8) and (hv >= 0).all()
    np.testing.assert_allclose(hv, np.asarray(want), rtol=1e-5, atol=1e-6)


def test_executor_cache_reuse():
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [2], "float32")
        y = torch.mul(x, 3.0)
    exe = static.Executor("cpu")
    (a,) = exe.run(prog, feed={"x": np.ones(2, np.float32)}, fetch_list=[y])
    n_entries = len(exe._cache)
    (b,) = exe.run(prog, feed={"x": np.zeros(2, np.float32)},
                   fetch_list=[y])
    assert len(exe._cache) == n_entries
    np.testing.assert_array_equal(a, [3.0, 3.0])
    np.testing.assert_array_equal(b, [0.0, 0.0])


def test_data_requires_guard():
    with pytest.raises(RuntimeError, match="program_guard"):
        static.data("x", [1], "float32")
    with pytest.raises(RuntimeError, match="program_guard"):
        rstatic.data("x", [1], "float32")


# ---------------------------------------------------------------------------
# tests/test_control_flow.py
# ---------------------------------------------------------------------------

def test_cond_eager():
    rx = paddle.to_tensor(np.float32(3.0))
    x = _t(3.0)
    for hi, want in ((2, 6.0), (5, 2.0)):
        r = rstatic.cond(rx > hi, lambda: rx * 2, lambda: rx - 1)
        g = static.cond(x > hi, lambda: x * 2, lambda: x - 1)
        assert float(g) == float(r) == want


def test_cond_traced_under_jit(tmp_path):
    def rf(xv):
        x = Tensor(xv)
        return rstatic.cond(x > 0, lambda: x * 2, lambda: x - 1)._value

    jf = jax.jit(rf)
    loaded = traced(lambda x: static.cond(x > 0, lambda: x * 2,
                                          lambda: x - 1),
                    [InputSpec([], "float32")], tmp_path)
    assert _hops(loaded) == {torch.ops.higher_order.cond}
    for v, want in ((3.0, 6.0), (-3.0, -4.0)):
        assert float(loaded(_t(v))) == float(jf(jnp.float32(v))) == want


def test_cond_gradient_through_branch(tmp_path):
    def loss(xv):
        x = Tensor(xv)
        return rstatic.cond(x > 0, lambda: x * x, lambda: -x)._value

    loaded = traced(lambda x: static.cond(x > 0, lambda: x * x,
                                          lambda: -x),
                    [InputSpec([], "float32")], tmp_path)
    for v, want in ((3.0, 6.0), (-3.0, -1.0)):
        ref = float(jax.grad(loss)(jnp.float32(v)))
        x = _t(v).requires_grad_()
        static.cond(x > 0, lambda: x * x, lambda: -x).backward()
        xl = _t(v).requires_grad_()
        loaded(xl).backward()
        assert float(x.grad) == float(xl.grad) == ref == want


def test_while_loop_eager():
    ri, rs = rstatic.while_loop(lambda i, s: i < 5,
                                lambda i, s: (i + 1, s + float(2.0)),
                                [paddle.to_tensor(np.int32(0)),
                                 paddle.to_tensor(np.float32(0.0))])
    i2, s2 = static.while_loop(lambda i, s: i < 5,
                               lambda i, s: (i + 1, s + float(2.0)),
                               [_t(0, torch.int32), _t(0.0)])
    assert int(i2) == int(ri) == 5 and float(s2) == float(rs) == 10.0


def test_while_loop_traced(tmp_path):
    def rf(n):
        i2, s2 = rstatic.while_loop(
            lambda i, s: i._value < n,
            lambda i, s: (Tensor(i._value + 1), Tensor(s._value + 2.0)),
            [Tensor(jnp.int32(0)), Tensor(jnp.float32(0.0))])
        return s2._value

    def f(n):
        i2, s2 = static.while_loop(lambda i, s: i < n,
                                   lambda i, s: (i + 1, s + 2.0),
                                   [n * 0, n.new_zeros((), dtype=torch
                                                       .float32)])
        return s2

    loaded = traced(f, [InputSpec([], "int32")], tmp_path)
    assert _hops(loaded) == {torch.ops.higher_order.while_loop}
    for n in (7, 3):
        assert float(loaded(_t(n, torch.int32))) == \
            float(jax.jit(rf)(jnp.int32(n))) == 2.0 * n


def test_while_loop_validates_loop_vars():
    for sc in (rstatic, static):
        with pytest.raises(TypeError, match="loop_vars"):
            sc.while_loop(lambda: True, lambda: (), [])


def test_case_eager_and_default():
    rx, x = paddle.to_tensor(np.float32(1.0)), _t(1.0)
    for mid, want in ((0, 2.0), (1.5, -98.0)):
        r = rstatic.case([(rx > 2, lambda: rx * 10),
                          (rx > mid, lambda: rx + 1)],
                         default=lambda: rx - 99)
        g = static.case([(x > 2, lambda: x * 10), (x > mid, lambda: x + 1)],
                        default=lambda: x - 99)
        assert float(g) == float(r) == want


def test_case_traced(tmp_path):
    def rf(xv):
        x = Tensor(xv)
        return rstatic.case([(x > 2, lambda: x * 10), (x > 0, lambda: x + 1)],
                            default=lambda: x - 99)._value

    loaded = traced(
        lambda x: static.case([(x > 2, lambda: x * 10),
                               (x > 0, lambda: x + 1)],
                              default=lambda: x - 99),
        [InputSpec([], "float32")], tmp_path)
    assert _hops(loaded) == {torch.ops.higher_order.cond}
    for v, want in ((3.0, 30.0), (1.0, 2.0), (-1.0, -100.0)):
        assert float(loaded(_t(v))) == float(jax.jit(rf)(jnp.float32(v))) \
            == want


def test_switch_case_eager():
    r = rstatic.switch_case(paddle.to_tensor(np.int32(1)),
                            {0: lambda: paddle.to_tensor(np.float32(10)),
                             1: lambda: paddle.to_tensor(np.float32(20))})
    g = static.switch_case(_t(1, torch.int32),
                           {0: lambda: _t(10.0), 1: lambda: _t(20.0)})
    assert float(g) == float(r) == 20.0
    r = rstatic.switch_case(paddle.to_tensor(np.int32(7)),
                            {0: lambda: paddle.to_tensor(np.float32(10))},
                            default=lambda: paddle.to_tensor(np.float32(-1)))
    g = static.switch_case(_t(7, torch.int32), {0: lambda: _t(10.0)},
                           default=lambda: _t(-1.0))
    assert float(g) == float(r) == -1.0


def test_switch_case_traced(tmp_path):
    def rf(iv):
        return rstatic.switch_case(
            Tensor(iv),
            {0: lambda: Tensor(jnp.float32(10.0)),
             2: lambda: Tensor(jnp.float32(30.0))},
            default=lambda: Tensor(jnp.float32(-1.0)))._value

    def f(i):
        # branch values from factory ops: a tensor constant cannot live
        # in a traced torch.cond branch
        return static.switch_case(
            i, {0: lambda: torch.full((), 10.0), 2: lambda: torch.full(
                (), 30.0)}, default=lambda: torch.full((), -1.0))

    loaded = traced(f, [InputSpec([], "int32")], tmp_path)
    assert _hops(loaded) == {torch.ops.higher_order.cond}
    for i, want in ((0, 10.0), (2, 30.0), (5, -1.0)):
        assert float(loaded(_t(i, torch.int32))) == \
            float(jax.jit(rf)(jnp.int32(i))) == want


def test_cond_with_paddle_ops_inside_branches(tmp_path):
    from paddle_tpu_torch.nn import functional as F
    xv = np.asarray([1.0, -2.0, 4.0], np.float32)

    def rf(v):
        x = Tensor(v)
        return rstatic.cond(x.sum() > 0,
                            lambda: paddle.nn.functional.relu(x),
                            lambda: x * 0)._value

    loaded = traced(lambda x: static.cond(x.sum() > 0, lambda: F.relu(x),
                                          lambda: x * 0),
                    [InputSpec([3], "float32")], tmp_path)
    want = np.asarray(jax.jit(rf)(jnp.asarray(xv)))
    np.testing.assert_allclose(loaded(_t(xv)).numpy(), want)
    np.testing.assert_allclose(want, [1.0, 0.0, 4.0])
    np.testing.assert_allclose(loaded(_t(-xv)).numpy(),
                               np.asarray(jax.jit(rf)(jnp.asarray(-xv))))


def test_exports_and_nn_alias():
    from paddle_tpu_torch.static import nn as snn
    assert snn.cond is static.cond and snn.while_loop is static.while_loop
    assert "cond" in static.__all__ and "switch_case" in static.__all__
    assert sorted(static.__all__) == sorted(rstatic.__all__)


def test_switch_case_duplicate_index_rejected():
    for sc, mk in ((rstatic, lambda: paddle.to_tensor(np.int32(0))),
                   (static, lambda: _t(0, torch.int32))):
        with pytest.raises(ValueError, match="duplicate"):
            sc.switch_case(mk(), [(1, lambda: 1), (1, lambda: 2)])


def test_traced_type_consistency_raw_arrays(tmp_path):
    def rf(xv):
        out = rstatic.cond(Tensor(xv) > 0,
                           lambda: {"a": xv * 2, "b": Tensor(xv + 1)},
                           lambda: {"a": xv * 3, "b": Tensor(xv - 1)})
        return out["a"] + out["b"]._value

    kinds = []

    def f(x):
        out = static.cond(x > 0, lambda: {"a": x * 2, "b": x + 1},
                          lambda: {"a": x * 3, "b": x - 1})
        kinds.append(sorted(out) == ["a", "b"] and all(
            isinstance(v, torch.Tensor) for v in out.values()))
        return out["a"] + out["b"]

    loaded = traced(f, [InputSpec([], "float32")], tmp_path)
    assert kinds == [True]
    for v in (2.0, -2.0):
        assert float(loaded(_t(v))) == float(jax.jit(rf)(jnp.float32(v)))
    assert float(loaded(_t(2.0))) == 7.0


def test_cond_traced_structure_mismatch_raises(tmp_path):
    def rf(xv):
        return rstatic.cond(Tensor(xv) > 0,
                            lambda: (Tensor(xv), xv),
                            lambda: (xv, Tensor(xv)))

    with pytest.raises(ValueError, match="same pytree|Tensors vs raw"):
        jax.jit(lambda v: rf(v) and v)(jnp.float32(1.0))
    # the port: a tensor and a Python number swap places
    with pytest.raises(ValueError, match="same pytree"):
        traced(lambda x: static.cond(x.sum() > 0, lambda: (x, 1.0),
                                     lambda: (1.0, x))[0],
               [InputSpec([2], "float32")], tmp_path)
    with pytest.raises(ValueError, match="same pytree"):
        traced(lambda x: static.cond(x.sum() > 0, lambda: (x, x),
                                     lambda: [x, x])[0],
               [InputSpec([2], "float32")], tmp_path, "g")


def test_switch_case_empty_rejected():
    with pytest.raises(TypeError, match="non-empty"):
        rstatic.switch_case(paddle.to_tensor(np.int32(0)), [])
    with pytest.raises(TypeError, match="non-empty"):
        static.switch_case(_t(0, torch.int32), [])


def test_while_loop_body_may_box_raw_init(tmp_path):
    def rf(n):
        out = rstatic.while_loop(
            lambda i: Tensor(i) < n if not isinstance(i, Tensor) else i < n,
            lambda i: (Tensor((i if not isinstance(i, Tensor)
                               else i._value) + 1),),
            [jnp.int32(0)])
        v = out[0]
        return v._value if isinstance(v, Tensor) else v

    # the init var is a Python int; the body returns tensors
    loaded = traced(lambda n: static.while_loop(
        lambda i: i < n, lambda i: (torch.as_tensor(i) + 1,), [0])[0],
        [InputSpec([], "int64")], tmp_path)
    assert int(loaded(_t(3, torch.int64))) == int(jax.jit(rf)(jnp.int32(3))) \
        == 3


def test_while_loop_traced_output_typing_matches_eager(tmp_path):
    def body(i):
        return (torch.as_tensor(i) + 1,)

    def cond_fn(i):
        return torch.as_tensor(i) < 2

    out_eager = static.while_loop(cond_fn, body, [0])
    assert isinstance(out_eager[0], torch.Tensor) and int(out_eager[0]) == 2
    kinds = []

    def f(n):
        out = static.while_loop(lambda i: i < n, body, [0])
        kinds.append(isinstance(out[0], torch.Tensor))
        return out[0]

    loaded = traced(f, [InputSpec([], "int64")], tmp_path)
    assert kinds == [True] and int(loaded(_t(2, torch.int64))) == 2
    rout = rstatic.while_loop(
        lambda i: Tensor((i._value if isinstance(i, Tensor) else i) < 2),
        lambda i: (Tensor((i._value if isinstance(i, Tensor) else i) + 1),),
        [jnp.int32(0)])
    assert isinstance(rout[0], Tensor) and int(rout[0]) == 2
