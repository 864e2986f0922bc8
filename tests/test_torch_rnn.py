"""The port's recurrent layers held against the JAX package's on the CPU,
on the JAX layers' weights (the parameter names are the same on both
sides and cross as they are): the three cells, ``SimpleRNN``, ``LSTM``
and ``GRU`` forward (one and two layers, bidirectional, ``time_major``,
given initial states), the generic ``RNN`` and ``BiRNN`` wrappers, and
the gradients of the input and of every parameter (the reference's
eager tape against torch autograd, one random cotangent).

Tolerance (float32; the recurrences sum in other orders): outputs,
states and gradients within ``1e-5`` of the reference's largest entry
(``max(1, |ref|)``).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn as tnn

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = REL * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol, (what,)


def _bridge(jl, tl):
    state = {n: torch.from_numpy(np.array(p._value, copy=True))
             for n, p in jl.named_parameters()}
    tl.load_state_dict(state, strict=True)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _run(jl, tl, x, states=None, **kw):
    """Both layers on x (and states); compares every output, then the
    gradients of a random projection of them."""
    _bridge(jl, tl)
    xj = paddle.to_tensor(x, stop_gradient=False)
    xt = torch.tensor(x, requires_grad=True)
    if states is None:
        jout, tout = jl(xj, **kw), tl(xt, **kw)
    else:
        jst = [paddle.to_tensor(s) for s in states]
        tst = [torch.from_numpy(s) for s in states]
        jst = jst[0] if len(jst) == 1 else tuple(jst)
        tst = tst[0] if len(tst) == 1 else tuple(tst)
        jout, tout = jl(xj, jst, **kw), tl(xt, tst, **kw)
    jo, to = _flat(jout), _flat(tout)
    assert len(jo) == len(to)
    jloss, tloss = None, 0
    for k, (a, b) in enumerate(zip(jo, to)):
        _close(b.detach().numpy(), np.asarray(a._value), f"output {k}")
        g = _rand(tuple(b.shape), 100 + k)
        term = (a * paddle.to_tensor(g)).sum()
        jloss = term if jloss is None else jloss + term
        tloss = tloss + (b * torch.from_numpy(g)).sum()
    jloss.backward()
    tloss.backward()
    _close(xt.grad.numpy(), np.asarray(xj.grad._value), "input grad")
    tparams = dict(tl.named_parameters())
    for name, p in jl.named_parameters():
        _close(tparams[name].grad.numpy(), np.asarray(p.grad._value),
               f"{name} grad")


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
@pytest.mark.parametrize("given", [False, True])
def test_cells(cell, given):
    paddle.seed(1)
    jl = getattr(jnn, cell)(5, 7)
    tl = getattr(tnn, cell)(5, 7, device="cpu")
    x = _rand((3, 5), 2)
    states = None
    if given:
        states = [_rand((3, 7), 3)] + ([_rand((3, 7), 4)]
                                       if cell == "LSTMCell" else [])
    _run(jl, tl, x, states)


LAYERS = [
    ("SimpleRNN", dict()),
    ("LSTM", dict()),
    ("GRU", dict()),
    ("LSTM", dict(direction="bidirect")),
    ("GRU", dict(direction="bidirectional", num_layers=2)),
    ("LSTM", dict(num_layers=2)),
    ("SimpleRNN", dict(num_layers=2, direction="bidirect")),
    ("LSTM", dict(time_major=True)),
    ("GRU", dict(time_major=True, direction="bidirect")),
]


@pytest.mark.parametrize("name,kw", LAYERS)
@pytest.mark.parametrize("given", [False, True])
def test_layers(name, kw, given):
    paddle.seed(2)
    jl = getattr(jnn, name)(4, 6, **kw)
    tl = getattr(tnn, name)(4, 6, device="cpu", **kw)
    x = _rand((5, 3, 4) if kw.get("time_major") else (3, 5, 4), 5)
    states = None
    if given:
        n = kw.get("num_layers", 1) * (2 if "direction" in kw else 1)
        states = [_rand((n, 3, 6), 6)] + ([_rand((n, 3, 6), 7)]
                                          if name == "LSTM" else [])
    _run(jl, tl, x, states)


def test_names_order_and_init():
    j = jnn.LSTM(4, 6, num_layers=2, direction="bidirect")
    t = tnn.LSTM(4, 6, num_layers=2, direction="bidirect", device="cpu",
                 seed=3)
    assert [n for n, _ in t.named_parameters()] == \
        [n for n, _ in j.named_parameters()]
    for n, p in t.named_parameters():
        assert 0 < float(p.detach().abs().max()) <= 6 ** -0.5, n


def test_sequence_length_and_dropout_are_not_applied():
    """Accepted and ignored, as the reference's forward ignores them."""
    paddle.seed(4)
    jl = jnn.LSTM(4, 6, num_layers=2, dropout=0.5)
    tl = tnn.LSTM(4, 6, num_layers=2, dropout=0.5, device="cpu")
    _bridge(jl, tl)
    assert tl.dropout == 0.5
    x = _rand((3, 5, 4), 8)
    lens = np.array([5, 2, 3], np.int64)
    want = np.asarray(jl(paddle.to_tensor(x),
                         sequence_length=paddle.to_tensor(lens))[0]._value)
    got = tl(torch.from_numpy(x), sequence_length=torch.from_numpy(lens))[0]
    _close(got.detach().numpy(), want)
    _close(tl(torch.from_numpy(x))[0].detach().numpy(), want)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("time_major", [False, True])
def test_rnn_wrapper(reverse, time_major):
    paddle.seed(5)
    jl = jnn.RNN(jnn.GRUCell(4, 6), is_reverse=reverse,
                 time_major=time_major)
    tl = tnn.RNN(tnn.GRUCell(4, 6, device="cpu"), is_reverse=reverse,
                 time_major=time_major)
    _run(jl, tl, _rand((3, 5, 4), 9))


def test_birnn():
    paddle.seed(6)
    jl = jnn.BiRNN(jnn.LSTMCell(4, 6), jnn.LSTMCell(4, 6))
    tl = tnn.BiRNN(tnn.LSTMCell(4, 6, device="cpu"),
                   tnn.LSTMCell(4, 6, device="cpu"))
    _run(jl, tl, _rand((3, 5, 4), 10))
