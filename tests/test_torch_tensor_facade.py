"""The port's ``Tensor`` facade against the reference's: ``to_tensor``
(default dtypes, ``place``, ``stop_gradient``, a bf16 numpy array), the
dtype aliases and ``convert_dtype``, places, the operators and
r-operators, ``__getitem__``/``__setitem__``, the conversions and
``repr``, and the 41 methods the facade attaches (the registry's
``tensor_method`` names ``torch.Tensor`` lacks).  Each case runs in both
packages on the same numpy input; values and dtype names are equal."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch.core.dtypes import dtype_name

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    from paddle_tpu_torch import device as tdevice
    prev = tdevice._layer_device
    pt.set_device("cpu")
    yield
    tdevice._layer_device = prev


def _np(t):
    return np.asarray(t._value) if hasattr(t, "_value") else t.numpy()


def _name(t):
    return dtype_name(t.dtype) if isinstance(t, torch.Tensor) else \
        dtype_name(str(t.dtype))


def _same(want, got, exact=False):
    """Tensors (or nests of them) equal in dtype name and values."""
    if isinstance(want, (list, tuple)):
        assert len(want) == len(got)
        for w, g in zip(want, got):
            _same(w, g, exact)
        return
    if not hasattr(want, "_value"):
        assert want == got, (want, got)
        return
    assert isinstance(got, pt.Tensor), type(got)
    assert _name(got) == _name(want), (_name(got), _name(want))
    w, g = _np(want), _np(got)
    assert w.shape == g.shape
    if exact or w.dtype.kind not in "fc":
        np.testing.assert_array_equal(g, w.astype(g.dtype))
    else:
        np.testing.assert_allclose(g, w.astype(g.dtype), rtol=1e-6,
                                   atol=1e-6)


# ---- to_tensor ----

TO_TENSOR = {
    "float_list": [1.0, 2.5],
    "int_list": [1, 2, 3],
    "bool_list": [True, False],
    "scalar_float": 1.5,
    "scalar_int": 7,
    "nested": [[1.0, 2.0], [3.0, 4.0]],
    "complex": [1 + 2j, 3.0],
    "np_float64": np.array([1.25, 2.5]),
    "np_int64": np.array([3, 4], np.int64),
    "np_float16": np.array([0.5, 1.5], np.float16),
    "np_uint8": np.array([1, 255], np.uint8),
    "np_int8": np.array([-3, 4], np.int8),
    "np_bool": np.array([True, False]),
}


@pytest.mark.parametrize("case", list(TO_TENSOR))
def test_to_tensor_default_dtypes(case):
    data = TO_TENSOR[case]
    _same(paddle.to_tensor(data), pt.to_tensor(data), exact=True)


@pytest.mark.parametrize("dtype", ["float32", "int64", "float64", "int32",
                                   "bfloat16", "float16", "bool", "int8"])
def test_to_tensor_with_dtype(dtype):
    data = [[0.5, 1.5], [2.0, -3.0]]
    want = paddle.to_tensor(data, dtype=dtype)
    got = pt.to_tensor(data, dtype=dtype)
    assert _name(got) == _name(want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        want._value).astype(got.numpy().dtype))


def test_to_tensor_bf16_numpy_and_stop_gradient_and_place():
    bf = np.asarray(paddle.to_tensor([1.5, -2.25, 3.0],
                                     dtype="bfloat16")._value)
    assert bf.dtype.name == "bfloat16"
    t = pt.to_tensor(bf)
    assert t.dtype == torch.bfloat16
    assert t.numpy().tolist() == [1.5, -2.25, 3.0]
    assert t.numpy().dtype == np.float32
    x = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    assert not x.stop_gradient and x.requires_grad and x.is_leaf
    assert pt.to_tensor([1.0]).stop_gradient
    y = pt.to_tensor(x)               # a copy, cut from x's graph
    assert y.stop_gradient and y.data_ptr() != x.data_ptr()
    for place in ("cpu", pt.CPUPlace()):
        assert pt.to_tensor([1], place=place).place == pt.CPUPlace()
    assert pt.is_tensor(torch.ones(1)) and pt.is_tensor(x)
    assert not pt.is_tensor(np.ones(1))


def test_int_stop_gradient_is_a_flag():
    i = pt.to_tensor([1, 2])
    assert i.stop_gradient
    i.stop_gradient = False
    assert not i.stop_gradient and not i.requires_grad


# ---- dtypes and places ----

def test_dtype_aliases_and_convert_dtype():
    from paddle_tpu.core import dtypes as jd
    from paddle_tpu_torch.core import dtypes as td
    assert pt.int64 is torch.int32 and pt.float64 is torch.float32
    assert pt.complex128 is torch.complex64 and pt.bool is torch.bool
    for name in jd._ALIASES:
        assert td.dtype_name(name) == jd.dtype_name(name), name
        assert td.convert_dtype(name) == getattr(pt, jd.dtype_name(name))
    for spec in (bool, int, float, np.float16, np.int8, "float32"):
        assert td.dtype_name(spec) == jd.dtype_name(spec), spec
    # a 64-bit type names the 32-bit one the reference computes in (its
    # dtype_name of np.int64 says "int64", yet its arrays are int32)
    for spec, name in ((np.int64, "int32"), (np.float64, "float32"),
                       (torch.int64, "int32"), (torch.float64, "float32"),
                       (np.complex128, "complex64")):
        assert td.dtype_name(spec) == name, spec
    with pytest.raises(ValueError, match="'float65'"):
        td.convert_dtype("float65")
    for d in ("float32", "int64", "bfloat16", "complex64", "bool"):
        assert td.is_floating_point(d) == jd.is_floating_point(d)
        assert td.is_integer(d) == jd.is_integer(d)
        assert td.is_complex(d) == jd.is_complex(d)
    assert pt.get_default_dtype() == paddle.get_default_dtype() == "float32"
    try:
        pt.set_default_dtype("bfloat16")
        assert pt.to_tensor([1.0]).dtype == torch.bfloat16
        assert pt.zeros([2]).dtype == torch.bfloat16
        with pytest.raises(ValueError):
            pt.set_default_dtype("int32")
    finally:
        pt.set_default_dtype("float32")
    assert pt.iinfo("int64").max == np.iinfo(np.int32).max
    assert pt.finfo("float64").eps == np.finfo(np.float32).eps
    assert pt.dtype is torch.dtype


def test_places_and_device_state():
    from paddle_tpu_torch.core import device as cdev
    assert pt.CPUPlace() == cdev.Place("cpu")
    assert pt.CUDAPlace(1) == pt.TPUPlace(1) == cdev.Place("gpu", 1)
    assert pt.CPUPlace().is_cpu_place() and pt.CUDAPlace().is_gpu_place()
    assert repr(pt.CUDAPlace(0)) == "Place(gpu:0)"
    assert pt.get_device() == "cpu"
    assert pt.is_compiled_with_cuda() and not paddle.is_compiled_with_cuda()
    assert pt.zeros([1]).place == pt.CPUPlace()
    assert cdev.to_torch_device("cpu").type == "cpu"
    assert cdev.device_count("cpu") == 1
    cdev.synchronize()
    assert isinstance(cdev.memory_stats(), dict)


# ---- operators ----

A = np.array([[0.5, -1.5, 2.0], [3.0, 0.25, -4.0]], np.float32)
B = np.array([[1.5, 2.0, -0.5], [0.75, -2.0, 1.25]], np.float32)
IA = np.array([[5, -3, 2], [7, 1, -4]], np.int32)
IB = np.array([[2, 3, 1], [3, 2, 5]], np.int32)

BINARY = ["__add__", "__sub__", "__mul__", "__truediv__", "__floordiv__",
          "__mod__", "__pow__", "__eq__", "__ne__", "__lt__", "__le__",
          "__gt__", "__ge__"]
REVERSED = ["__radd__", "__rsub__", "__rmul__", "__rtruediv__",
            "__rfloordiv__", "__rmod__", "__rpow__"]


def _pair(P, a, b):
    return P.to_tensor(a), P.to_tensor(b)


@pytest.mark.parametrize("op", BINARY)
@pytest.mark.parametrize("kind", ["float", "int", "int_float_scalar",
                                  "float_int_scalar", "f16_f32_0d"])
def test_operators(op, kind):
    for P in (paddle, pt):
        if kind == "float":
            x, y = _pair(P, A, B)
        elif kind == "int":
            x, y = _pair(P, IA, IB)
        elif kind == "int_float_scalar":
            x, y = P.to_tensor(IB), 1.5
        elif kind == "float_int_scalar":
            x, y = P.to_tensor(A), 3
        else:
            x = P.to_tensor(A.astype(np.float16))
            y = P.to_tensor(np.float32(1.25))
        out = getattr(x, op)(y)
        if P is paddle:
            want = out
        else:
            got = out
    _same(want, got)


@pytest.mark.parametrize("op", REVERSED)
def test_reversed_operators(op):
    want = getattr(paddle.to_tensor(B), op)(2)
    got = getattr(pt.to_tensor(B), op)(2)
    _same(want, got)


def test_matmul_unary_bitwise_operators():
    _same(paddle.to_tensor(A) @ paddle.to_tensor(B.T),
          pt.to_tensor(A) @ pt.to_tensor(B.T))
    _same(-paddle.to_tensor(A), -pt.to_tensor(A))
    _same(abs(paddle.to_tensor(A)), abs(pt.to_tensor(A)))
    for op in ("__and__", "__or__", "__xor__", "__lshift__", "__rshift__"):
        _same(getattr(paddle.to_tensor(np.abs(IA)), op)(
            paddle.to_tensor(IB)),
            getattr(pt.to_tensor(np.abs(IA)), op)(pt.to_tensor(IB)))
    _same(~paddle.to_tensor(IA), ~pt.to_tensor(IA))
    assert (pt.to_tensor(A) == None) is False  # noqa: E711
    assert (pt.to_tensor(A) != None) is True  # noqa: E711


INDEX = {
    "int": lambda: 1,
    "neg": lambda: -1,
    "slice": lambda: (slice(None), slice(1, None)),
    "step": lambda: (slice(None), slice(None, None, 2)),
    "ellipsis": lambda: (Ellipsis, 0),
    "none": lambda: (None, 1),
    "list": lambda: [1, 0, 1],
    "np_bool": lambda: np.array([True, False]),
    "mixed": lambda: (1, [0, 2]),
}


@pytest.mark.parametrize("case", list(INDEX))
def test_getitem(case):
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    _same(paddle.to_tensor(x)[INDEX[case]()], pt.to_tensor(x)[INDEX[case]()])


def test_getitem_with_tensors_and_setitem():
    """Tensor indices against the reference; ``__setitem__`` against
    numpy (the reference's raises TypeError for every value: its
    ``isinstance`` tuple holds the module's ``complex`` function, ROADMAP
    Queue 3)."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    for P in (paddle, pt):
        t = P.to_tensor(x)
        idx = P.to_tensor(np.array([2, 0], np.int64))
        mask = P.to_tensor(x > 5)
        got = [t[idx], t[mask], t[1, idx]]
        if P is paddle:
            want = got
            with pytest.raises(TypeError, match="isinstance"):
                t[0] = P.to_tensor(np.float32(7.5))
    _same(want, got)
    t = pt.to_tensor(x)
    t[0] = 7.5
    t[1, 1:3] = pt.to_tensor(np.array([-1.0, -2.0], np.float32))
    t[pt.to_tensor(x > 5)] = 0.0
    t[2] = pt.to_tensor(np.array([1, 2, 3, 4], np.int32))
    t[[0, 1], 0] = np.array([9, 8])
    ref = x.copy()
    ref[0] = 7.5
    ref[1, 1:3] = [-1.0, -2.0]
    ref[x > 5] = 0.0
    ref[2] = [1, 2, 3, 4]
    ref[[0, 1], 0] = [9, 8]
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), ref)


def test_setitem_records_a_gradient_on_a_non_leaf():
    x = pt.to_tensor(np.array([1.0, 2.0, 3.0], np.float32),
                     stop_gradient=False)
    y = x * 2
    y[1] = pt.to_tensor(np.float32(5.0))
    (y * y).sum().backward()
    assert x.grad.tolist() == [8.0, 0.0, 24.0]


# ---- conversions ----

def test_astype_numpy_item_tolist_clone_detach():
    for P in (paddle, pt):
        x = P.to_tensor(A, stop_gradient=False)
        res = [x.astype("int32"), x.astype(P.bfloat16).astype("float32"),
               x.cast("float16"), x.clone(), x.detach()]
        if P is paddle:
            want = res
            witems = (x[0, 1].item(), x.tolist(), x.numpy().tolist())
        else:
            got = res
            assert (x[0, 1].item(), x.tolist(), x.numpy().tolist()) == \
                witems
            assert not res[3].stop_gradient and res[4].stop_gradient
    _same(want, got)


def test_repr_is_the_references():
    for data, kw in (([[1.0, 2.0], [3.0, 4.0]], {}),
                     ([1, 2, 3], {}),
                     ([0.5], {"stop_gradient": False})):
        assert repr(pt.to_tensor(data, **kw)) == repr(
            paddle.to_tensor(data, **kw))


def test_reference_attributes():
    x = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    assert x.name.startswith("tensor_")
    x.name = "w"
    assert x.name == "w"
    assert not x.persistable
    x.persistable = True
    assert x.persistable
    assert type(x.value) is torch.Tensor
    (x * x).sum().backward()
    assert x.gradient().tolist() == [2.0, 4.0]
    x.clear_gradient()
    assert x.grad is None and x.gradient() is None
    x.set_value(np.array([5.0, 6.0]))
    assert x.tolist() == [5.0, 6.0] and x.dtype == torch.float32
    assert isinstance(pt.nn.Parameter(torch.ones(2)), pt.Tensor)
    # results of torch calls on facade tensors are facade tensors
    assert type(torch.sin(x)) is pt.Tensor and type(x.sum()) is pt.Tensor
    assert type(x.shape) is torch.Size


def test_facade_ops_record_into_a_static_program():
    """The port's ``static`` records torch calls through its
    ``TorchFunctionMode``: facade ops on program variables (chained, so
    a variable that came back as a facade tensor is read again) are
    recorded and replayed by the ``Executor``."""
    from paddle_tpu_torch import static
    wn = np.arange(12, dtype=np.float32).reshape(3, 4) / 10
    xn = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)
    w = pt.to_tensor(wn)
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [2, 3], "float32")
        y = pt.matmul(x, w)
        z = pt.sum(pt.exp(y) * 2.0 + y[:, :2].sum())
        q = pt.concat([x + 1.0, pt.tanh(x)], axis=0)
    out = static.Executor("cpu").run(main, feed={"x": xn},
                                     fetch_list=[z, q])
    yn = xn @ wn
    np.testing.assert_allclose(out[0], (np.exp(yn) * 2 + yn[:, :2].sum())
                               .sum(), rtol=1e-5)
    np.testing.assert_allclose(out[1], np.concatenate([xn + 1, np.tanh(xn)]),
                               rtol=1e-6)


def test_copy_and_pickle_keep_the_facade():
    import copy
    import pickle
    x = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    x.name = "w"
    for y in (copy.deepcopy(x), pickle.loads(pickle.dumps(x))):
        assert type(y) is pt.Tensor and y.name == "w"
        assert not y.stop_gradient and y.tolist() == [1.0, 2.0]
        assert y.data_ptr() != x.data_ptr()
    with pytest.raises(RuntimeError, match="graph leaves"):
        copy.deepcopy(x * 2)


# ---- the 41 attached methods ----

def _attached():
    from paddle_tpu_torch.ops.registry import registry
    return sorted(s.op for s in registry()
                  if s.tensor_method and not hasattr(torch.Tensor, s.op))


ATTACHED = _attached()


def test_attached_methods_are_the_41():
    assert len(ATTACHED) == 41
    for name in ATTACHED:
        assert name in vars(pt.Tensor), name


@pytest.mark.parametrize("name", ATTACHED)
def test_attached_method_matches_reference(name):
    from test_torch_op_sweep import _build, _port
    jargs, jkw = _build(name)
    targs, tkw = _port(jargs), _port(jkw)
    if name == "log_normal":
        # the method passes the tensor as ``mean``: the reference's
        # ``jnp.exp(mean + ...)`` refuses a Tensor there (ROADMAP Queue 3)
        with pytest.raises(ValueError, match="__jax_array__"):
            paddle.to_tensor(A).log_normal()
        pt.seed(3)
        out = pt.to_tensor(A).log_normal()
        assert out.shape == A.shape and bool(pt.all(out > 0))
        return
    if isinstance(jargs[0], list):
        # a list input: the method on a tensor whose rows are the list
        if len({tuple(t.shape) for t in jargs[0]}) == 1:
            jargs[0], targs[0] = paddle.stack(jargs[0]), pt.stack(targs[0])
        else:
            sq = (A @ A.T).astype(np.float32)
            jargs[0], targs[0] = paddle.to_tensor(sq), pt.to_tensor(sq)
    paddle.seed(3)
    pt.seed(3)
    want = getattr(jargs[0], name)(*jargs[1:], **jkw)
    got = getattr(targs[0], name)(*targs[1:], **tkw)
    if name == "eigvals":
        assert _name(got) == _name(want)
        np.testing.assert_allclose(np.sort_complex(got.numpy()),
                                   np.sort_complex(_np(want)), rtol=1e-5)
        return
    _same(want, got)
