"""The port's vision zoo held against the JAX package's on the CPU, on the
JAX models' weights and batch-norm buffers carried by the weight bridge
(``vision_state_from_jax``): ResNet-18 and ResNet-50 at 2x3x64x64 in
NCHW and NHWC, eval and train (logits and the buffers after the
forward); three ``TrainStep`` calls of ResNet-18 with Momentum against
the JAX ``TrainStep`` (losses, parameters, velocities and buffers); the
rest of the zoo case for case with the reference's tier-1 and ``slow``
split (``tests/test_vision_models.py``); and ``reference_init`` drawing
every convolution, norm and recurrent weight of a ResNet-18, a DBNet and
a CRNN as its initializer says.

Tolerances (float32; convolutions and statistics sum in other orders):
logits within ``1e-5`` of their largest entry (``max(1, |ref|)``),
buffers ``atol 1e-5, rtol 1e-5``, block gradients ``1e-5`` of the largest entry;
ResNet-50's train-mode logits within ``1e-3`` of the largest entry: its
last stage normalizes 8 values per channel (2 images of 2x2), and each
package's float32 forward is itself up to 3.3e-4 of the largest logit
away from a float64 run of the same weights (the reference's 7.9e-4 at
2.4, the port's 3.1e-4; measured on these inputs), its buffers ``atol
5e-5, rtol 1e-4`` (a tenth of those activations' batch statistics).  The train
steps' tolerances are in ``test_resnet18_train_steps_match_jax``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.jit.train_step import TrainStep as JTrainStep
from paddle_tpu.vision import models as jm
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import vision_state_from_jax
from paddle_tpu_torch.nn.common import materialize
from paddle_tpu_torch.nn.conv import _ConvNd
from paddle_tpu_torch.nn.norm import (GroupNorm, _BatchNormBase,
                                      _InstanceNormBase)
from paddle_tpu_torch.nn.rnn import _RNNBase
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as tm

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rel=REL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _arrays(jnet):
    out = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    out.update({n: np.asarray(b._value) for n, b in jnet.named_buffers()})
    return out


def _pair(name, seed=0, **kw):
    paddle.seed(seed)
    jnet = getattr(jm, name)(**kw)
    tnet = getattr(tm, name)(device="cpu", **kw)
    tnet.load_state_dict(vision_state_from_jax(_arrays(jnet), tnet),
                         strict=True)
    return jnet, tnet


def _images(b=2, size=64, seed=0, c=3):
    return np.random.default_rng(seed).standard_normal(
        (b, c, size, size)).astype(np.float32)


def _buffers_close(jnet, tnet, atol=1e-5, rtol=1e-5):
    jb = dict(jnet.named_buffers())
    for name, b in tnet.named_buffers():
        np.testing.assert_allclose(b.numpy(), np.asarray(jb[name]._value),
                                   atol=atol, rtol=rtol, err_msg=name)


@pytest.fixture(scope="module")
def resnets():
    return {(depth, df): _pair(f"resnet{depth}", num_classes=7,
                               data_format=df)
            for depth in (18, 50) for df in ("NCHW", "NHWC")}


@pytest.mark.parametrize("depth", [18, 50])
@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_resnet_logits_and_buffers(resnets, depth, df, mode):
    jnet, tnet = resnets[(depth, df)]
    getattr(jnet, mode)()
    getattr(tnet, mode)()
    x = _images(seed=depth)
    want = np.asarray(jnet(paddle.to_tensor(x))._value)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))
    loose = (depth, mode) == (50, "train")
    _close(got.numpy(), want, 1e-3 if loose else REL,
           what=f"resnet{depth} {df} {mode}")
    _buffers_close(jnet, tnet, atol=5e-5 if loose else 1e-5,
                   rtol=1e-4 if loose else 1e-5)


def test_resnet_nhwc_input_format():
    """A declared NHWC input needs no entry transpose in an NHWC tower,
    and gives the NCHW tower's logits."""
    _, a = _pair("resnet18", num_classes=5)
    _, b = _pair("resnet18", num_classes=5, data_format="NHWC",
                 input_format="NHWC")
    a.eval()
    b.eval()
    x = _images(seed=3)
    with torch.no_grad():
        want = a(torch.from_numpy(x))
        got = b(torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 2, 3, 1))))
    _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("block", ["BasicBlock", "BottleneckBlock"])
def test_block_gradients_match_jax(block):
    """A residual block with its strided downsample in train mode: the
    output and the gradients of the input and of every parameter against
    ``jax.vjp`` of the reference's block (its TrainStep's derivative), one
    random cotangent."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core import tape as jtape
    from paddle_tpu.core.tensor import Tensor as JTensor
    from paddle_tpu.vision.models import resnet as jres

    from paddle_tpu_torch.vision.models import resnet as tres
    paddle.seed(3)
    cin, planes = 8, 4
    exp = getattr(jres, block).expansion
    jds = paddle.nn.Sequential(paddle.nn.Conv2D(cin, planes * exp, 1,
                                                stride=2, bias_attr=False),
                               paddle.nn.BatchNorm2D(planes * exp))
    jb = getattr(jres, block)(cin, planes, 2, jds)
    with torch.device("meta"):
        tds = tnn.Sequential(tnn.Conv2D(cin, planes * exp, 1, stride=2,
                                        bias_attr=False),
                             tnn.BatchNorm2D(planes * exp))
        tb = getattr(tres, block)(cin, planes, 2, tds)
    materialize(tb, "cpu")
    tb.load_state_dict(vision_state_from_jax(_arrays(jb), tb))
    x = _images(b=4, size=12, c=cin, seed=4)
    params = list(jb.parameters())

    def f(pv, a):
        saved = [p._value for p in params]
        try:
            for p, v in zip(params, pv):
                p._value = v
            with jtape.no_grad():
                return jb(JTensor(a))._value
        finally:
            for p, v in zip(params, saved):
                p._value = v

    out, vjp = jax.vjp(f, [p._value for p in params], jnp.asarray(x))
    g = np.random.default_rng(5).standard_normal(out.shape).astype(
        np.float32)
    gp, gx = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    o = tb(xt)
    grads = torch.autograd.grad((o * torch.from_numpy(g)).sum(),
                                [xt] + list(tb.parameters()))
    _close(o.detach().numpy(), out, what="output")
    _close(grads[0].numpy(), gx, what="input grad")
    for (name, _), a, b in zip(jb.named_parameters(), gp, grads[1:]):
        _close(b.numpy(), a, what=name)


def _rel_frob(got, want):
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def test_resnet18_train_steps_match_jax():
    """Three ``TrainStep`` calls (Momentum 0.9, lr 0.01, fresh 4x3x64x64
    batches, 10 classes) of the JAX and the port ResNet-18 from one
    state: losses ``rtol 1e-5``; every parameter within ``1e-4`` of its
    largest entry (measured: 3.3e-5, the first convolution's); each
    parameter's update (``p3 - p0``) and velocity within ``5e-3`` in
    relative Frobenius norm.  The last two read the few activations that
    sit on a ReLU or max-pool boundary, which float32 noise tips either
    way in a batch of four: the first convolution's velocity measured
    9.4e-4 with one CPU thread and 1.4e-5 with eight (another summation
    order); an update rule that differed (a momentum, a learning rate)
    would differ by order one.  Batch-norm buffers ``atol 1e-5, rtol
    1e-4``.
    ``test_block_gradients_match_jax`` holds the derivative itself to the
    reference's per element at ``1e-5``."""
    lr = 0.01
    jnet, tnet = _pair("resnet18", seed=1, num_classes=10)
    p0 = {n: p.detach().numpy().copy() for n, p in tnet.named_parameters()}
    jnet.train()
    tnet.train()
    jstep = JTrainStep(jnet, lambda n, x, y: JF.cross_entropy(n(x), y)
                       .mean(), paddle.optimizer.Momentum(
                           learning_rate=lr, momentum=0.9,
                           parameters=jnet.parameters()))
    tstep = TrainStep(tnet, lambda n, x, y: TF.cross_entropy(n(x), y)
                      .mean(), Momentum(learning_rate=lr, momentum=0.9,
                                        parameters=tnet.parameters()))
    rng = np.random.default_rng(2)
    jl, tl = [], []
    for _ in range(3):
        x = rng.standard_normal((4, 3, 64, 64)).astype(np.float32)
        y = rng.integers(0, 10, (4,)).astype(np.int64)
        jl.append(float(jstep(paddle.to_tensor(x), paddle.to_tensor(y))))
        tl.append(float(tstep(x, y)))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert len(set(tl)) == 3
    tparams = dict(tnet.named_parameters())
    tindex = {n: i for i, n in enumerate(tparams)}
    for i, (name, p) in enumerate(jnet.named_parameters()):
        want = np.asarray(p._value)
        vel = np.asarray(jstep._state[i]["velocity"])
        if name == "fc.weight":                 # the one Linear weight
            want, vel = want.T, vel.T
        got = tparams[name].detach().numpy()
        _close(got, want, 1e-4, name)
        assert _rel_frob(got - p0[name], want - p0[name]) <= 5e-3, name
        assert _rel_frob(tstep._state[tindex[name]]["velocity"].numpy(),
                         vel) <= 5e-3, name
    _buffers_close(jnet, tnet, rtol=1e-4)


# the reference's tier-1 and slow split, case for case
ZOO = [
    pytest.param("alexnet", marks=pytest.mark.slow),
    "squeezenet1_1", "shufflenet_v2_x0_25",
    pytest.param("vgg11", marks=pytest.mark.slow),
    pytest.param("mobilenet_v1", marks=pytest.mark.slow),
    pytest.param("mobilenet_v2", marks=pytest.mark.slow),
    pytest.param("mobilenet_v3_small", marks=pytest.mark.slow),
    pytest.param("mobilenet_v3_large", marks=pytest.mark.slow),
    pytest.param("squeezenet1_0", marks=pytest.mark.slow),
    pytest.param("densenet121", marks=pytest.mark.slow),
    pytest.param("googlenet", marks=pytest.mark.slow),
    pytest.param("shufflenet_v2_swish", marks=pytest.mark.slow),
]


def _zoo_check(name, size=64, **kw):
    jnet, tnet = _pair(name, **kw)
    jnet.eval()
    tnet.eval()
    x = _images(size=size, seed=5)
    want = np.asarray(jnet(paddle.to_tensor(x))._value)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))
    assert np.all(np.isfinite(got.numpy()))
    _close(got.numpy(), want, what=name)
    return got


@pytest.mark.parametrize("name", ZOO)
def test_zoo_forward(name):
    out = _zoo_check(name, size=96 if name == "alexnet" else 64,
                     num_classes=8)
    assert tuple(out.shape) == (2, 8)


@pytest.mark.slow
def test_inception_v3():
    assert tuple(_zoo_check("inception_v3", size=96, num_classes=8).shape) \
        == (2, 8)


@pytest.mark.slow
def test_no_head_variant():
    out = _zoo_check("mobilenet_v2", num_classes=0, with_pool=True)
    assert out.shape[0] == 2 and out.shape[1] == 1280


@pytest.mark.slow
def test_vgg_batch_norm():
    _zoo_check("vgg11", batch_norm=True, num_classes=8)


def test_lenet():
    paddle.seed(0)
    jnet = jm.LeNet()
    tnet = tm.LeNet(device="cpu")
    tnet.load_state_dict(vision_state_from_jax(_arrays(jnet), tnet))
    x = _images(size=28, c=1)
    _close(tnet(torch.from_numpy(x)).detach().numpy(),
           np.asarray(jnet(paddle.to_tensor(x))._value))


def _check_init(model):
    """Every convolution, norm and recurrent weight as its initializer
    draws it: not all zero, within its uniform bound; norm weights one and
    biases zero; batch-norm buffers zeros and ones."""
    seen = set()
    for name, m in model.named_modules():
        if isinstance(m, _ConvNd):
            w = m.weight.detach()
            bound = (6.0 / m._fan_in) ** 0.5
            assert 0 < float(w.abs().max()) <= bound * (1 + 1e-6), name
            assert float(w.std()) > bound / 4, name
            assert m.bias is None or float(m.bias.abs().max()) == 0, name
            seen.add("transposed conv" if type(m).__name__.endswith(
                "Transpose") else "conv")
        elif isinstance(m, (_BatchNormBase, GroupNorm, _InstanceNormBase)):
            assert torch.equal(m.weight, torch.ones_like(m.weight)), name
            assert float(m.bias.abs().max()) == 0, name
            if isinstance(m, _BatchNormBase):
                assert float(m._mean.abs().max()) == 0, name
                assert torch.equal(m._variance,
                                   torch.ones_like(m._variance)), name
            seen.add("norm")
        elif isinstance(m, _RNNBase):
            bound = m.hidden_size ** -0.5
            for pn, p in m.named_parameters():
                assert 0 < float(p.detach().abs().max()) <= bound * (1 + 1e-6), pn
            seen.add("rnn")
        elif isinstance(m, torch.nn.Linear):
            assert float(m.weight.detach().abs().max()) > 0, name
    return seen


def test_reference_init_draws_every_vision_weight():
    assert _check_init(tm.resnet18(device="cpu", seed=3)) == \
        {"conv", "norm"}
    assert _check_init(tmodels.DBNet(device="cpu", seed=4)) == \
        {"conv", "transposed conv", "norm"}
    assert _check_init(tmodels.CRNN(device="cpu", seed=5)) == \
        {"conv", "norm", "rnn"}
    a = tm.resnet18(device="cpu", seed=3).conv1.weight
    b = tm.resnet18(device="cpu", seed=4).conv1.weight
    assert not torch.equal(a, b)            # the draws follow the seed
    g = tnn.GroupNorm(2, 4, device="cpu")
    assert torch.equal(g.weight, torch.ones(4))


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_resnet_amp_op_trace_matches_jax(level, mode):
    """Under ``auto_cast`` every op of a ResNet-18 forward consults the
    rule under the reference's name and casts as it does: the sequence
    of (op name, floating input dtypes) equals the JAX dispatcher's."""
    import importlib

    import jax.numpy as jnp
    from paddle_tpu.core import dispatch as jdispatch

    from paddle_tpu_torch import amp as tamp
    tcast = importlib.import_module("paddle_tpu_torch.amp.auto_cast")
    jdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    jnet, tnet = _pair("resnet18", num_classes=5)
    getattr(jnet, mode)()
    getattr(tnet, mode)()
    x = _images(seed=6)
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
            jnet(paddle.to_tensor(x))
    finally:
        jdispatch._dispatch_impl = orig
    with tcast._trace_ops() as got, tamp.auto_cast(level=level), \
            torch.no_grad():
        tnet(torch.from_numpy(x))
    names = {n for n, _ in got}
    assert names >= {"conv2d", "batch_norm", "relu", "max_pool2d", "add",
                     "adaptive_avg_pool2d", "flatten", "linear"}
    assert got == [e for e in log if e[0] in names]


def test_momentum_state_bridge_finds_linear_weights_by_type():
    """A JAX Momentum's eager ``state_dict()`` after one step on a LeNet
    (its Linear layers are ``fc.0``/``fc.1``/``fc.2``, names no name rule
    lists) crosses to the port's optimizer with the Linear velocities
    transposed (``linear_weight_names``), equals the port's own after the
    same step, and crosses back exactly."""
    from paddle_tpu_torch.models import (linear_weight_names,
                                         optimizer_state_from_jax,
                                         optimizer_state_to_jax)
    paddle.seed(2)
    jnet = jm.LeNet()
    tnet = tm.LeNet(device="cpu")
    tnet.load_state_dict(vision_state_from_jax(_arrays(jnet), tnet))
    x = _images(b=3, size=28, c=1, seed=8)
    y = np.array([1, 4, 7], np.int64)
    jopt = paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                     parameters=jnet.parameters())
    topt = Momentum(learning_rate=0.01, momentum=0.9,
                    parameters=tnet.parameters())
    JF.cross_entropy(jnet(paddle.to_tensor(x)), paddle.to_tensor(y)) \
        .mean().backward()
    jopt.step()
    TF.cross_entropy(tnet(torch.from_numpy(x)), torch.from_numpy(y)) \
        .mean().backward()
    topt.step()
    names = [n for n, _ in jnet.named_parameters()]
    jstate = {k: np.asarray(v._value) for k, v in jopt.state_dict().items()
              if hasattr(v, "_value")}
    linear = linear_weight_names(tnet)
    assert linear == {"fc.0.weight", "fc.1.weight", "fc.2.weight"}
    bridged = optimizer_state_from_jax(jstate, names, linear=linear)
    tstate = topt.state_dict()
    assert {k for k in bridged if k.startswith("velocity")} == \
        {k for k in tstate if k.startswith("velocity")}
    for k, v in bridged.items():
        if k.startswith("velocity"):
            assert tuple(v.shape) == tuple(tstate[k].shape), k
            _close(v.numpy(), tstate[k].numpy(), what=k)
    back = optimizer_state_to_jax(bridged, names, linear=linear)
    for k, v in jstate.items():
        assert np.array_equal(back[k], v), k


# the reference's tier-1 and slow split of these models, case for case
AMP_ZOO = [
    "squeezenet1_1", "shufflenet_v2_x0_25",
    pytest.param("mobilenet_v1", marks=pytest.mark.slow),
    pytest.param("mobilenet_v2", marks=pytest.mark.slow),
    pytest.param("mobilenet_v3_small", marks=pytest.mark.slow),
    pytest.param("mobilenet_v3_large", marks=pytest.mark.slow),
    pytest.param("densenet121", marks=pytest.mark.slow),
    pytest.param("googlenet", marks=pytest.mark.slow),
    pytest.param("inception_v3", marks=pytest.mark.slow),
]


@pytest.mark.parametrize("name", AMP_ZOO)
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_zoo_amp_op_trace_matches_jax(name, level):
    """``test_resnet_amp_op_trace_matches_jax`` on the rest of the zoo
    (eval, 2x3x64x64, 96x96 for Inception-v3): the tensor ops of the
    blocks (``concat``, ``split``, ``multiply``, ``add``, ``flatten``)
    consult the rule under the reference's names too, in the
    reference's order, with the reference's cast dtypes."""
    import importlib

    import jax.numpy as jnp
    from paddle_tpu.core import dispatch as jdispatch

    from paddle_tpu_torch import amp as tamp
    tcast = importlib.import_module("paddle_tpu_torch.amp.auto_cast")
    jdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    jnet, tnet = _pair(name, num_classes=5)
    jnet.eval()
    tnet.eval()
    x = _images(size=96 if name == "inception_v3" else 64, seed=6)
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
            jnet(paddle.to_tensor(x))
    finally:
        jdispatch._dispatch_impl = orig
    with tcast._trace_ops() as got, tamp.auto_cast(level=level), \
            torch.no_grad():
        tnet(torch.from_numpy(x))
    names = {n for n, _ in got}
    block_ops = {"concat", "split", "multiply", "add"} & {
        n for n, _ in log}
    assert names >= block_ops | {"flatten"}, names
    assert got == [e for e in log if e[0] in names]
