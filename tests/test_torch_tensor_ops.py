"""The tensor ops' traps, held against the reference: the promotion
lattice, index and reduction dtypes, the functions whose torch namesakes
differ (``median``, ``split``, ``equal``), the shared method names that
keep torch's meaning (the README's list), the random ops (threefry bits,
the normals' ulps, the laws' moments), the AMP op trace at O1 and O2 and
the ``op::<name>`` spans."""

import os
import re

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch.core.dtypes import dtype_name

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# ---- promotion ----

DTYPES = ["bool", "uint8", "int8", "int16", "int32", "bfloat16", "float16",
          "float32", "complex64"]
SCALARS = [True, 3, 1.5, 2j]


def _operand(P, spec):
    if isinstance(spec, str):
        return P.to_tensor(np.array([1, 0, 1]), dtype=spec)
    return spec


@pytest.mark.parametrize("a", DTYPES)
def test_promotion_lattice(a):
    """Every pair of tensor dtypes and every Python scalar: the result
    dtype of ``add`` (and of ``multiply`` against a 0-d tensor) is the
    reference's."""
    for b in DTYPES + SCALARS:
        want = paddle.add(_operand(paddle, a), _operand(paddle, b))
        got = pt.add(_operand(pt, a), _operand(pt, b))
        assert _name(got) == _name(want), (a, b)
        np.testing.assert_array_equal(
            _np(got).astype(np.complex64), _np(want).astype(np.complex64))
        if isinstance(b, str):
            zero_d = pt.multiply(_operand(pt, a), pt.to_tensor(
                np.array(2, dtype=b if b != "bfloat16" else "float32"),
                dtype=b))
            jzero_d = paddle.multiply(_operand(paddle, a), paddle.to_tensor(
                np.array(2, dtype=b if b != "bfloat16" else "float32"),
                dtype=b))
            assert _name(zero_d) == _name(jzero_d), (a, b, "0-d")


def test_half_plus_float32_0d_is_float32():
    x = pt.to_tensor([1.0, 2.0], dtype="float16")
    y = pt.to_tensor(1.0)
    assert (x + y).dtype == torch.float32       # torch says float16
    assert (x + 1.5).dtype == torch.float16
    assert (pt.to_tensor([1, 2]) + 1.5).dtype == torch.float32


@pytest.mark.parametrize("op", ["add", "maximum", "concat", "where",
                                "clip", "matmul"])
def test_plain_tensor_calls_keep_torch_rules(op):
    """A facade op whose tensor inputs are all plain ``torch.Tensor``s
    (the port's models call ``nn.functional``'s ``add``/``concat``, which
    are these ops) casts nothing and returns torch's plain result; the
    same call on facade tensors takes the reference's dtype."""
    h = torch.tensor([1.0, 2.0], dtype=torch.float16)
    f0 = torch.tensor(3.0)
    i64 = torch.tensor([1, 2], dtype=torch.int64)
    calls = {
        "add": (lambda P, a, b: P.add(a, b), (h, f0), torch.float16),
        "maximum": (lambda P, a, b: P.maximum(a, b), (h, f0), torch.float16),
        "concat": (lambda P, a, b: P.concat([a, b]), (i64, i64), torch.int64),
        "where": (lambda P, a, b: P.where(a > 1, a, b), (i64, i64),
                  torch.int64),
        "clip": (lambda P, a, b: P.clip(a, min=b), (h, f0), torch.float16),
        "matmul": (lambda P, a, b: P.matmul(a, b), (i64, i64), torch.int64)}
    fn, args, plain_dtype = calls[op]
    want = {"add": torch.add(h, f0), "maximum": torch.maximum(h, f0),
            "concat": torch.cat([i64, i64]),
            "where": torch.where(i64 > 1, i64, i64),
            "clip": torch.clamp(h, min=f0),
            "matmul": torch.matmul(i64, i64)}[op]
    out = fn(pt, *args)
    assert type(out) is torch.Tensor and out.dtype == plain_dtype, out
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    facade = fn(pt, *[pt.to_tensor(a) for a in args])
    jax_out = fn(paddle, *[paddle.to_tensor(a.numpy()) for a in args])
    assert isinstance(facade, pt.Tensor)
    assert _name(facade) == _name(jax_out), (_name(facade), _name(jax_out))
    np.testing.assert_allclose(_np(facade).astype(np.float32),
                               _np(jax_out).astype(np.float32))


def test_reduction_and_index_dtypes():
    for P in (paddle, pt):
        i = P.to_tensor([1, 2, 3])
        b = P.to_tensor([True, False, True])
        f = P.to_tensor([[3.0, 1.0, 2.0], [0.5, 4.0, -1.0]])
        res = [P.sum(i), P.sum(b), P.mean(i), P.argmax(f), P.argmin(f, 1),
               P.argsort(f), P.topk(f, 2)[1], P.nonzero(f > 1),
               P.unique(P.to_tensor([3, 1, 3]), return_inverse=True)[1],
               P.prod(i), P.cumsum(b), P.count_nonzero(f)]
        if P is paddle:
            want = res
    for w, g in zip(want, res):
        assert _name(g) == _name(w), (_name(g), _name(w))
        np.testing.assert_array_equal(_np(g), _np(w))
    assert _name(res[0]) == "int32" and _name(res[2]) == "float32"


def test_functions_whose_torch_namesakes_differ():
    x = pt.to_tensor([1.0, 2.0, 3.0, 4.0])
    assert float(pt.median(x)) == 2.5 == float(paddle.median(
        paddle.to_tensor([1.0, 2.0, 3.0, 4.0])))
    assert float(x.median()) == 2.0                 # torch's method
    parts = pt.split(pt.arange(6), 2)
    assert [p.tolist() for p in parts] == [[0, 1, 2], [3, 4, 5]]
    assert len(pt.arange(6).split(2)) == 3          # torch's method
    # an uneven count is refused, as by the reference (nn.functional's
    # split is the same function)
    from paddle_tpu_torch.nn import functional as F
    for split in (pt.split, F.split, paddle.split):
        P = paddle if split is paddle.split else pt
        with pytest.raises(ValueError):
            split(P.arange(6), 4)
    eq = pt.equal(pt.to_tensor([1, 2]), pt.to_tensor([1, 3]))
    assert eq.tolist() == [True, False]
    assert pt.to_tensor([1, 2]).equal(pt.to_tensor([1, 2])) is True
    t = pt.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    assert pt.transpose(t, [1, 0]).shape == (3, 2)
    assert t.transpose(0, 1).shape == (3, 2)
    idx = pt.to_tensor([1, 0])
    assert pt.gather(t, idx).tolist() == [[3.0, 4.0, 5.0], [0.0, 1.0, 2.0]]
    assert pt.sort(t, descending=True)[0].tolist() == [2.0, 1.0, 0.0]


def _readme_method_list():
    with open(os.path.join(REPO, "README.md")) as f:
        text = f.read()
    block = text.split("<!-- facade-methods -->")[1]
    return sorted(re.findall(r"`([a-z_0-9]+)`", block))


def _method_differs(op):
    from test_torch_op_sweep import _build, _close, _flat, _port
    from paddle_tpu.core.tensor import Tensor as JTensor
    jargs, jkw = _build(op)
    if not jargs or not isinstance(jargs[0], JTensor):
        return True
    targs, tkw = _port(jargs), _port(jkw)
    paddle.seed(5)
    pt.seed(5)
    try:
        want = getattr(jargs[0], op)(*jargs[1:], **jkw)
        got = getattr(targs[0], op)(*targs[1:], **tkw)
    except Exception:
        return True
    jf, tf = _flat(want, JTensor), _flat(got, torch.Tensor)
    if not jf:
        try:
            return not bool(want == got)
        except Exception:
            return True
    if len(jf) != len(tf):
        return True
    try:
        for a, b in zip(jf, tf):
            assert _name(b) == _name(a)
            _close(op, "method", b.detach().float().numpy()
                   if b.dtype == torch.bfloat16 else b.detach().numpy(),
                   _np(a))
    except AssertionError:
        return True
    return False


def test_shared_method_names_that_differ_are_the_readmes():
    """The registry's methods that ``torch.Tensor`` already has keep
    torch's meaning; the ones whose call at the sweep's inputs differs
    from the reference's method (or raises on either side) are exactly
    the README's list, where each has the function to use."""
    from paddle_tpu_torch.ops.registry import registry
    shared = sorted(s.op for s in registry()
                    if s.tensor_method and hasattr(torch.Tensor, s.op))
    assert len(shared) == 190
    differ = [op for op in shared if _method_differs(op)]
    assert differ == _readme_method_list()


# ---- random ----

THREEFRY = {
    "rand": lambda P: P.rand([3, 5]),
    "uniform": lambda P: P.uniform([4, 3], min=-2.0, max=3.0),
    "randint": lambda P: P.randint(-5, 17, [6, 7]),
    "randint_wide": lambda P: P.randint(0, 2 ** 31 - 1, [50]),
    "randperm_1": lambda P: P.randperm(1),
    "randperm": lambda P: P.randperm(40),
    "randperm_two_rounds": lambda P: P.randperm(3000),
    "bernoulli": lambda P: P.bernoulli(P.to_tensor(
        np.linspace(0.05, 0.95, 24).astype(np.float32).reshape(4, 6))),
    "uniform_": lambda P: P.uniform_(P.zeros([5]), 0.0, 2.0),
    "dropout": lambda P: P.nn.functional.dropout(P.ones([4, 8]), 0.3),
}


@pytest.mark.parametrize("case", list(THREEFRY))
def test_threefry_draws_are_bit_equal(case):
    for seed in (0, 11):
        paddle.seed(seed)
        pt.seed(seed)
        paddle.rand([2])          # a draw before: the offset advances
        pt.rand([2])
        want, got = THREEFRY[case](paddle), THREEFRY[case](pt)
        assert _name(got) == _name(want)
        np.testing.assert_array_equal(_np(got), _np(want))


NORMALS = {
    "normal": lambda P: P.normal(0.5, 2.0, [64]),
    "standard_normal": lambda P: P.standard_normal([8, 8]),
    "randn": lambda P: P.randn([100]),
    "normal_tensor_mean": lambda P: P.normal(
        P.to_tensor(np.linspace(-1, 1, 10).astype(np.float32)), 0.5),
    "normal_": lambda P: P.normal_(P.zeros([30]), 1.0, 3.0),
}


@pytest.mark.parametrize("case", list(NORMALS))
def test_normals_within_ulps(case):
    paddle.seed(4)
    pt.seed(4)
    want, got = NORMALS[case](paddle), NORMALS[case](pt)
    assert _name(got) == _name(want)
    w = _np(want)
    eps = np.finfo(np.float32).eps
    np.testing.assert_allclose(_np(got), w, rtol=0,
                               atol=8 * eps * max(1.0, np.abs(w).max()))


def _moments(x):
    x = np.asarray(x, np.float64)
    return x.mean(), x.var()


def test_law_only_draws_moments_and_supports():
    pt.seed(9)
    n = 40000
    lam = pt.full([n], 3.5)
    m, v = _moments(pt.poisson(lam).numpy())
    assert abs(m - 3.5) < 5 * np.sqrt(3.5 / n) and abs(v - 3.5) < 0.15
    cnt = pt.full([n], 10.0)
    prob = pt.full([n], 0.3)
    b = pt.binomial(cnt, prob)
    assert b.dtype == torch.int32 and int(b.min()) >= 0 and int(b.max()) <= 10
    m, v = _moments(b.numpy())
    assert abs(m - 3.0) < 5 * np.sqrt(2.1 / n) and abs(v - 2.1) < 0.1
    g = pt.standard_gamma(pt.full([n], 2.0))
    m, v = _moments(g.numpy())
    assert abs(m - 2.0) < 5 * np.sqrt(2.0 / n) and abs(v - 2.0) < 0.15
    e = pt.zeros([n]).exponential_(2.0)
    m, v = _moments(e.numpy())
    assert float(e.min()) >= 0 and abs(m - 0.5) < 5 * 0.5 / np.sqrt(n)
    probs = pt.to_tensor([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]])
    draws = pt.multinomial(probs, 4000, replacement=True)
    assert draws.dtype == torch.int32 and draws.shape == (2, 4000)
    freq = np.stack([np.bincount(r, minlength=3) / 4000
                     for r in draws.numpy()])
    np.testing.assert_allclose(freq, probs.numpy(), atol=0.04)
    one = pt.multinomial(probs, 3, replacement=False).numpy()
    assert all(sorted(r) == [0, 1, 2] for r in one)
    # the reference's draws share these laws and dtypes
    paddle.seed(9)
    assert _name(paddle.poisson(paddle.full([4], 3.5))) == \
        _name(pt.poisson(pt.full([4], 3.5)))
    assert _name(paddle.multinomial(paddle.to_tensor([0.5, 0.5]), 1)) == \
        _name(pt.multinomial(pt.to_tensor([0.5, 0.5]), 1))


def test_rng_state_round_trip_and_generator():
    pt.seed(21)
    state = pt.get_rng_state()
    a = pt.rand([4]).numpy()
    pt.set_rng_state(state)
    assert np.array_equal(pt.rand([4]).numpy(), a)
    pt.set_cuda_rng_state(pt.get_cuda_rng_state())
    assert pt.get_rng_state() == pt.get_cuda_rng_state()[0]
    assert isinstance(pt.Generator(3), pt.core.generator.Generator)


# ---- AMP op trace and spans ----

def _program(P):
    """A small facade program: names the AMP rule and the spans see."""
    rng = np.random.default_rng(5)
    x = P.to_tensor(rng.standard_normal((4, 8)).astype(np.float32))
    w = P.to_tensor(rng.standard_normal((8, 6)).astype(np.float32),
                    stop_gradient=False)
    h = P.matmul(x, w)
    h = P.tanh(h) + 1.0
    h = h * P.exp(h * 0.1)
    s = P.concat([h, h], axis=-1)
    s = P.transpose(P.reshape(s, [2, 2, 12]), [0, 2, 1])
    z = P.sum(s, axis=1) - P.mean(s)
    z = z[0] + P.sqrt(P.abs(z[1]))
    # functions, not methods: a shared method name keeps torch's meaning
    return (P.mean(P.log(1.0 + z * z)), z)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_op_trace_matches_jax(level):
    """The facade program's ops consult the AMP rule under the
    reference's names, in its order, with its cast dtypes (as
    ``test_zoo_amp_op_trace_matches_jax`` holds the vision zoo)."""
    import importlib

    import jax.numpy as jnp
    from paddle_tpu.core import dispatch as jdispatch
    tcast = importlib.import_module("paddle_tpu_torch.amp.auto_cast")
    jdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    log = []
    orig = jdispatch._dispatch_impl

    def rec(op_name, impl, tensor_args, *a, **k):
        d = jdispatch._amp_cast_hook(op_name)
        dts = tuple(jdt[str(jnp.dtype(d if d is not None else t.dtype))]
                    for t in tensor_args
                    if getattr(t, "dtype", None) is not None
                    and jnp.issubdtype(t.dtype, jnp.floating))
        log.append((op_name, dts))
        return orig(op_name, impl, tensor_args, *a, **k)

    jdispatch._dispatch_impl = rec
    try:
        with paddle.amp.auto_cast(level=level):
            jloss, jz = _program(paddle)
    finally:
        jdispatch._dispatch_impl = orig
    with tcast._trace_ops() as got, pt.amp.auto_cast(level=level):
        loss, z = _program(pt)
    assert len(got) > 15
    assert got == log
    assert _name(loss) == _name(jloss) and _name(z) == _name(jz)
    np.testing.assert_allclose(_np(z).astype(np.float32),
                               _np(jz).astype(np.float32), rtol=2e-2,
                               atol=2e-2)


def test_op_spans_in_the_references_order():
    from paddle_tpu.runtime import HostTracer as JTracer
    from paddle_tpu_torch.runtime import HostTracer as TTracer

    def spans(tracer, P):
        tracer.clear()
        tracer.enable()
        try:
            _program(P)
        finally:
            tracer.disable()
        ev = sorted((e for e in tracer.events() if e[0] == 0
                     and e[5].startswith("op::")), key=lambda e: e[1])
        tracer.clear()
        return [e[5] for e in ev]

    want = spans(JTracer, paddle)
    got = spans(TTracer, pt)
    assert len(got) > 15 and got == want
