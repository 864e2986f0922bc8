"""Threefry dropout of the port held against the JAX package's on the CPU:
the same seed and the same number of draws give the same masks, eagerly,
in scaled-dot-product and flash attention, inside ``TrainStep`` (where
draws derive from the step's pushed key) and inside a recomputed segment
(whose backward run pushes the same key again).

Masks are compared exactly: dropout outputs are equal bit for bit (a
division by ``1 - p`` rounds the same in both); attention with dropout
within ``atol 1e-5`` (the softmax sums in other orders; a mask that
differed would move an output by about a probability, far above that);
``alpha_dropout`` within ``atol 1e-6`` (XLA may fuse its affine map into
an FMA); train steps within ``rtol 1e-5`` (losses) and ``atol 1e-5``
(parameters), as ``test_torch_train.py``.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import generator as jgen
from paddle_tpu.distributed.utils import recompute as jrecompute
from paddle_tpu.jit.train_step import TrainStep as JTrainStep
from paddle_tpu.nn import functional as JF
import paddle_tpu_torch
from paddle_tpu_torch.core import generator as tgen
from paddle_tpu_torch.distributed import recompute
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.optimizer import SGD


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _seed(s):
    paddle_tpu_torch.seed(s)
    paddle.seed(s)


def _x(shape, seed=0):
    return np.random.default_rng(seed).uniform(
        0.5, 1.5, shape).astype(np.float32)


def _both(fn_j, fn_t, x, **kw):
    return (np.asarray(fn_j(paddle.to_tensor(x), **kw).numpy()),
            fn_t(torch.from_numpy(x.copy()), **kw).numpy())


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("axis", [None, 1, [0, 2]])
def test_dropout_masks_equal_jax(p, mode, axis):
    _seed(11)
    x = _x((3, 5, 17))
    for _ in range(3):      # three draws: the offsets advance alike
        want, got = _both(JF.dropout, tF.dropout, x, p=p, mode=mode,
                          axis=axis)
        assert np.array_equal(got, want)
        assert 0 < (got == 0).mean() < 1 or p in (0.1, 0.9)


def test_dropout_off_outside_training_and_downscaled_in_infer():
    x = _x((4, 6))
    want, got = _both(JF.dropout, tF.dropout, x, p=0.3, training=False,
                      mode="downscale_in_infer")
    assert np.array_equal(got, want)
    got = tF.dropout(torch.from_numpy(x), p=0.3, training=False)
    assert np.array_equal(got.numpy(), x)


@pytest.mark.parametrize("fn", ["dropout2d", "dropout3d"])
def test_channel_dropout_masks_equal_jax(fn):
    _seed(4)
    x = _x((2, 6, 3, 4) if fn == "dropout2d" else (2, 6, 2, 3, 4))
    want, got = _both(getattr(JF, fn), getattr(tF, fn), x, p=0.4)
    assert np.array_equal(got, want)


def test_alpha_dropout_equals_jax():
    _seed(5)
    x = _x((7, 9)) - 1.0
    want, got = _both(JF.alpha_dropout, tF.alpha_dropout, x, p=0.25)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_generator_draws_follow_the_reference_offsets():
    _seed(3)
    for _ in range(4):
        k = tgen.default_generator().draw()
        jk = jgen.default_generator().next_key()
        assert list(k.tf) == np.asarray(jax.random.key_data(jk)).tolist()
    assert tgen.get_rng_state() == jgen.get_rng_state() == [(3, 4)]
    # under a pushed key, draws are fold_in(key, counter) and leave the
    # offset alone
    base = tgen.draw()
    jbase = jgen.default_generator().next_key()
    tgen.push_trace_key(base)
    jgen.push_trace_key(jbase)
    try:
        for _ in range(3):
            assert list(tgen.draw().tf) == np.asarray(jax.random.key_data(
                jgen.next_key())).tolist()
    finally:
        tgen.pop_trace_key()
        jgen.pop_trace_key()
    assert tgen.get_rng_state() == jgen.get_rng_state() == [(3, 5)]


def _qkv(seed, b=2, s=12, hq=4, hk=2, d=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hk, d)).astype(np.float32),
            rng.standard_normal((b, s, hk, d)).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("api", ["sdpa", "flash_attention"])
def test_attention_dropout_equals_jax(causal, api):
    q, k, v = _qkv(8)
    _seed(21)
    for _ in range(2):
        if api == "sdpa":
            want = JF.scaled_dot_product_attention(
                *map(paddle.to_tensor, (q, k, v)), dropout_p=0.2,
                is_causal=causal)
            got = tF.scaled_dot_product_attention(
                *map(torch.from_numpy, (q, k, v)), dropout_p=0.2,
                is_causal=causal)
        else:
            want = JF.flash_attention(*map(paddle.to_tensor, (q, k, v)),
                                      dropout=0.2, causal=causal)
            got = tF.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                     dropout=0.2, causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                   atol=1e-5, rtol=0)


# ---- inside TrainStep and inside a recomputed segment ----

class _JNet(paddle.nn.Layer):
    def __init__(self, remat):
        super().__init__()
        self.fc = paddle.nn.Linear(8, 8)
        self.remat = remat

    def forward(self, x):
        def body(h):
            return JF.dropout(self.fc(h), 0.3)
        return jrecompute(body, x) if self.remat else body(x)


class _TNet(torch.nn.Module):
    def __init__(self, remat):
        super().__init__()
        self.fc = torch.nn.Linear(8, 8)
        self.remat = remat

    def forward(self, x):
        def body(h):
            return tF.dropout(tF.linear(h, self.fc.weight, self.fc.bias),
                              0.3)
        return recompute(body, x) if self.remat else body(x)


def _nets(remat):
    paddle.seed(1)
    jnet = _JNet(remat)
    tnet = _TNet(remat)
    with torch.no_grad():
        tnet.fc.weight.copy_(torch.from_numpy(
            np.asarray(jnet.fc.weight._value).T.copy()))
        tnet.fc.bias.copy_(torch.from_numpy(
            np.asarray(jnet.fc.bias._value).copy()))
    return jnet, tnet


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("how", ["call", "run_steps"])
def test_dropout_in_train_step_equals_jax(remat, how):
    jnet, tnet = _nets(remat)
    x = _x((4, 8), 2)
    y = _x((4, 8), 3)
    jstep = JTrainStep(jnet, lambda n, a, b: ((n(a) - b) ** 2).mean(),
                       paddle.optimizer.SGD(0.1, parameters=jnet.parameters()))
    tstep = TrainStep(tnet, lambda n, a, b: ((n(a) - b) ** 2).mean(),
                      SGD(0.1, parameters=tnet.parameters()))
    _seed(9)
    jl, tl = [], []
    for _ in range(3):
        if how == "call":
            jl.append(float(jstep(paddle.to_tensor(x), paddle.to_tensor(y))))
            tl.append(float(tstep(x, y)))
        else:
            jl.append(float(jstep.run_steps(paddle.to_tensor(x),
                                            paddle.to_tensor(y), steps=2)))
            tl.append(float(tstep.run_steps(x, y, steps=2)))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    np.testing.assert_allclose(tnet.fc.weight.detach().numpy().T,
                               np.asarray(jnet.fc.weight._value), atol=1e-5)
    assert len(set(tl)) == 3        # a new mask each step


def test_eager_recompute_masks_equal_jax_and_the_first_forward():
    jnet, tnet = _nets(True)
    x = _x((4, 8), 5)
    _seed(13)
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jout = jnet(jx)
    jout.sum().backward()
    tx = torch.tensor(x, requires_grad=True)
    tout = tnet(tx)
    tout.sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(),
                               np.asarray(jout.numpy()), atol=1e-6)
    np.testing.assert_allclose(tnet.fc.weight.grad.numpy().T,
                               np.asarray(jnet.fc.weight.grad.numpy()),
                               atol=1e-5)
    # the backward's run drew the forward's mask: the gradient through the
    # dropout is zero exactly where the forward dropped
    kept = tout.detach() != 0
    h = tF.linear(tx.detach(), tnet.fc.weight.detach(), tnet.fc.bias.detach())
    want_gx = ((kept.float() / 0.7) @ tnet.fc.weight.detach())
    np.testing.assert_allclose(tx.grad.numpy(), want_gx.numpy(), atol=1e-5)
    assert h.shape == tout.shape
    # the probe and the key drew from the outer stream like the reference's
    assert tgen.get_rng_state() == [(13, 2)]
