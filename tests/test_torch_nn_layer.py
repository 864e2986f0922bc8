"""The port's ``nn.Layer`` facade, ``Parameter``/``ParamAttr``, the
initializers and ``LazyGuard`` held against the JAX package's on the CPU
(the reference's ``tests/test_nn.py:24``, ``:50``, ``:251`` and
``tests/test_lazy_init.py``):

- registration, ``state_dict`` names, ``set_state_dict`` from numpy,
  hooks with ``remove()``, ``named_sublayers``, ``add_parameter``/
  ``add_sublayer``, non-persistable buffers, ``full_name``, ``astype``,
  ``to(device, dtype, blocking)``, ``clear_gradients``;
- ``create_parameter`` with ``ParamAttr`` (name, learning rate,
  regularizer, trainable, need_clip), ``attr=False``, a bare
  initializer, the Xavier-uniform/zero defaults; the port's optimizer
  and clip read ``optimize_attr`` and ``need_clip``;
- the initializers: what is deterministic exactly (``Constant``,
  ``Assign``, ``Dirac``, ``calculate_gain``, the fans), what is random by
  its law (bounds, moments within a stated tolerance, truncation,
  ``Orthogonal``'s QᵀQ = I), never the JAX package's threefry bits;
- ``LazyGuard``: parameters born in host RAM, moved in place at the
  first forward or kept by an explicit ``.to``, nesting, training after
  the guard, raising without CUDA when the CPU was not asked for;
- ``layer_state_from_jax``: a facade model's outputs equal the JAX
  model's within ``1e-5`` of the largest entry (float32).
"""

import copy
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as pt
from paddle_tpu.nn import initializer as JI
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import layer_state_from_jax
from paddle_tpu_torch.nn import initializer as TI

REL = 1e-5


@pytest.fixture
def on_cpu():
    """``set_device("cpu")`` for the facade, restored afterwards."""
    prev = tdevice._layer_device
    pt.set_device("cpu")
    yield
    tdevice._layer_device = prev


def _a(*shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(4, 8)
        self.fc2 = jnn.Linear(8, 2)
        self.scale = self.create_parameter((2,), default_initializer=(
            JI.Constant(1.5)))
        self.register_buffer("step", paddle.zeros([1]))
        self.register_buffer("scratch", paddle.zeros([3]),
                             persistable=False)

    def forward(self, x):
        return self.fc2(jnn.functional.relu(self.fc1(x))) * self.scale


class _TNet(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(4, 8, device="cpu")
        self.fc2 = tnn.Linear(8, 2, device="cpu")
        self.scale = self.create_parameter((2,), default_initializer=(
            TI.Constant(1.5)))
        self.register_buffer("step", torch.zeros(1))
        self.register_buffer("scratch", torch.zeros(3), persistable=False)

    def forward(self, x):
        return self.fc2(tnn.functional.relu(self.fc1(x))) * self.scale


def _bridged(jnet, tnet):
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    arrays.update({n: np.asarray(b._value)
                   for n, b in jnet.named_buffers()
                   if n in dict(tnet.state_dict())})
    missing, unexpected = tnet.set_state_dict(
        layer_state_from_jax(arrays, tnet))
    assert not missing and not unexpected, (missing, unexpected)
    return tnet


def test_registration_state_dict_and_bridge_match_jax(on_cpu):
    jnet, tnet = _JNet(), _TNet()
    assert set(tnet.state_dict()) == set(jnet.state_dict()) == {
        "fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias", "scale", "step"}
    assert [n for n, _ in tnet.named_parameters()] == \
        [n for n, _ in jnet.named_parameters()]
    _bridged(jnet, tnet)
    x = _a(3, 4)
    _close(tnet(torch.from_numpy(x)).detach().numpy(),
           jnet(paddle.to_tensor(x)).numpy(), what="forward")
    # round trip through numpy
    twin = _TNet()
    twin.set_state_dict({k: v.numpy() for k, v in tnet.state_dict().items()})
    assert torch.equal(twin.fc1.weight, tnet.fc1.weight)


def test_set_state_dict_reports_and_refuses(on_cpu):
    net = _TNet()
    missing, unexpected = net.set_state_dict({"scale": np.ones(2),
                                              "extra": np.ones(1)})
    assert unexpected == ["extra"] and "fc1.weight" in missing
    assert torch.equal(net.scale.detach(), torch.ones(2))
    with pytest.raises(ValueError, match="shape mismatch"):
        net.set_state_dict({"scale": np.ones(3)})
    assert net.load_dict == net.set_state_dict


@pytest.mark.parametrize("replace", [False, True])
def test_forward_hooks_match_jax(on_cpu, replace):
    jnet, tnet = _JNet(), _TNet()
    _bridged(jnet, tnet)
    outs = []
    for pkg, net, wrap in ((paddle, jnet, paddle.to_tensor),
                           (torch, tnet, torch.from_numpy)):
        calls = []

        def pre(layer, inp, calls=calls):
            calls.append("pre")
            return (inp[0] * 2.0,) if replace else None

        def post(layer, inp, out, calls=calls):
            calls.append("post")
            return out + 1.0 if replace else None

        h1 = net.register_forward_pre_hook(pre)
        h2 = net.register_forward_post_hook(post)
        first = net(wrap(_a(2, 4)))
        h1.remove()
        h2.remove()
        net(wrap(_a(2, 4)))
        assert calls == ["pre", "post"]
        outs.append(np.asarray(first.numpy() if pkg is paddle
                               else first.detach().numpy()))
    _close(outs[1], outs[0], what="hooked forward")


def test_sublayers_and_names_match_jax(on_cpu):
    jnet, tnet = _JNet(), _TNet()
    for net, lin in ((jnet, jnn.Linear(2, 2)),
                     (tnet, tnn.Linear(2, 2, device="cpu"))):
        assert net.add_sublayer("extra", lin) is lin
    got = [n for n, _ in tnet.named_sublayers(include_self=True)]
    want = [n for n, _ in jnet.named_sublayers(include_self=True)]
    assert got == want == ["", "fc1", "fc2", "extra"]
    assert len(tnet.sublayers()) == len(jnet.sublayers()) == 3
    assert tnet.full_name() == "_tnet" and jnet.full_name() == "_jnet"
    assert tnn.Layer("scope").full_name() == jnn.Layer("scope").full_name()
    p = tnet.create_parameter((3,))
    assert tnet.add_parameter("extra_p", p) is p
    assert "extra_p" in tnet.state_dict()


def test_astype_to_and_clear_gradients(on_cpu):
    net = _TNet()
    net(torch.ones(2, 4)).sum().backward()
    assert net.scale.grad is not None
    net.clear_gradients()
    assert all(p.grad is None for p in net.parameters())
    net.astype("float64")
    assert net.scale.dtype == torch.float64 and net._dtype == torch.float64
    assert net.step.dtype == torch.float64
    net.to("cpu", "bfloat16", True)
    assert net.fc1.weight.dtype == torch.bfloat16
    net.to(device="cpu", dtype=torch.float32, blocking=False)
    assert net.fc1.weight.dtype == torch.float32
    assert isinstance(net.scale, tnn.Parameter)


def test_create_parameter_param_attr_matches_jax(on_cpu):
    reg = object()
    for layer, attr_cls, const in ((jnn.Layer(), jnn.ParamAttr, JI.Constant),
                                   (tnn.Layer(), tnn.ParamAttr,
                                    TI.Constant)):
        attr = attr_cls(name="w0", initializer=const(0.25),
                        learning_rate=0.5, regularizer=reg, trainable=False,
                        need_clip=False)
        p = layer.create_parameter((2, 3), attr=attr)
        assert p.name == "w0" and p.trainable is False
        assert p.stop_gradient is True and p.need_clip is False
        assert p.optimize_attr == {"learning_rate": 0.5}
        assert p.regularizer is reg and p.persistable is True
        assert layer.create_parameter((2,), attr=False) is None
        named = layer.create_parameter((2,), attr="b0", is_bias=True)
        assert named.name == "b0" and named.trainable is True
        np.testing.assert_array_equal(np.asarray(
            named.numpy() if hasattr(named, "_value")
            else named.detach().numpy()), np.zeros(2))
        bare = layer.create_parameter((3,), attr=const(2.0))
        assert float(np.asarray(bare.numpy() if hasattr(bare, "_value")
                                else bare.detach()).max()) == 2.0
    p = tnn.Layer().create_parameter((3,), attr=tnn.ParamAttr(
        name="p", trainable=False, need_clip=False, learning_rate=0.5))
    assert isinstance(p, torch.nn.Parameter) and not p.requires_grad
    twin = copy.deepcopy(p)
    assert (twin.name, twin.need_clip, twin.optimize_attr, twin.trainable) \
        == ("p", False, {"learning_rate": 0.5}, False)
    assert twin.optimize_attr is not p.optimize_attr
    p.trainable = True
    assert p.requires_grad and not p.stop_gradient


@pytest.mark.parametrize("shape", [(64, 32), (512, 16), (8, 3, 5, 5)])
def test_create_parameter_default_weight_is_xavier_uniform(on_cpu, shape):
    w = tnn.Layer().create_parameter(shape).detach()
    fi, fo = JI._fans(shape)
    limit = math.sqrt(6.0 / (fi + fo))
    assert w.dtype == torch.float32 and tuple(w.shape) == shape
    assert float(w.abs().max()) <= limit
    # U(-l, l): variance l^2 / 3, within 5 standard errors
    n = w.numel()
    var = float(w.double().var())
    assert abs(var - limit ** 2 / 3) <= 5 * limit ** 2 * math.sqrt(
        4 / 45 / n), (var, limit ** 2 / 3)


def test_parameter_attributes_reach_optimizer_and_clip(on_cpu):
    layer = tnn.Layer()
    fast = layer.create_parameter((4,), attr=tnn.ParamAttr(
        learning_rate=0.5, initializer=TI.Constant(1.0)))
    free = layer.create_parameter((4,), attr=tnn.ParamAttr(
        need_clip=False, initializer=TI.Constant(1.0)))
    fast.grad = torch.full((4,), 2.0)
    free.grad = torch.full((4,), 2.0)
    clipped = tnn.ClipGradByGlobalNorm(0.1)([(fast, fast.grad),
                                            (free, free.grad)])
    assert torch.equal(clipped[1][1], free.grad)
    assert float(clipped[0][1].norm()) == pytest.approx(0.1, rel=1e-5)
    opt = topt.SGD(learning_rate=0.1, parameters=[fast])
    opt.step()
    np.testing.assert_allclose(fast.detach().numpy(), 1.0 - 0.1 * 0.5 * 2.0,
                               rtol=1e-6)


# ---- initializers ----

@pytest.mark.parametrize("name,param", [
    ("sigmoid", None), ("linear", None), ("conv1d", None), ("conv2d", None),
    ("conv3d", None), ("tanh", None), ("relu", None), ("selu", None),
    ("leaky_relu", None), ("leaky_relu", 0.2), ("other", None)])
def test_calculate_gain_exact(name, param):
    assert TI.calculate_gain(name, param) == JI.calculate_gain(name, param)


@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (6, 2, 3), (4, 3, 2, 5),
                                   (2, 3, 1, 2, 2)])
def test_fans_exact(shape):
    assert TI._fans(shape) == JI._fans(shape)


@pytest.mark.parametrize("make", [
    lambda I: I.Constant(2.5), lambda I: I.Constant(-1),
    lambda I: I.Assign(np.arange(6).reshape(2, 3)),
    lambda I: I.Assign([[1.5, 2.0, -3.0], [0.0, 4.0, 5.0]]),
    lambda I: I.Dirac(), lambda I: I.Dirac(groups=2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deterministic_initializers_exact(on_cpu, make, dtype):
    shape = (2, 3)
    if isinstance(make(TI), TI.Dirac):
        shape = (4, 2, 3, 3)
    want = np.asarray(make(JI)(shape, jnp.dtype(dtype)).astype(jnp.float32))
    got = make(TI)(shape, dtype)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


def _moments(t):
    a = t.double()
    return float(a.mean()), float(a.std())


N_DRAW = (256, 512)


@pytest.mark.parametrize("case", [
    ("normal", lambda I: I.Normal(0.5, 2.0), 0.5, 2.0),
    ("xavier_normal", lambda I: I.XavierNormal(), 0.0,
     math.sqrt(2.0 / sum(N_DRAW))),
    ("xavier_normal fans", lambda I: I.XavierNormal(10, 30, gain=2.0), 0.0,
     2.0 * math.sqrt(2.0 / 40)),
    ("kaiming_normal", lambda I: I.KaimingNormal(), 0.0,
     math.sqrt(2.0) / math.sqrt(N_DRAW[0])),
    ("kaiming_normal leaky", lambda I: I.KaimingNormal(
        fan_in=64, negative_slope=0.1, nonlinearity="leaky_relu"), 0.0,
     math.sqrt(2.0 / 1.01) / 8.0),
])
def test_normal_initializers_by_law(on_cpu, case):
    """Mean within 5 standard errors, std within 2% (n = 131072)."""
    _, make, mean, std = case
    t = make(TI)(N_DRAW, "float32")
    m, s = _moments(t)
    n = t.numel()
    assert abs(m - mean) <= 5 * std / math.sqrt(n), (m, mean)
    assert abs(s - std) <= 0.02 * std, (s, std)
    # the reference's draw has the same law (its std within 2% too)
    ref = np.asarray(make(JI)(N_DRAW, jnp.float32))
    assert abs(ref.std() - std) <= 0.02 * std


@pytest.mark.parametrize("case", [
    ("uniform", lambda I: I.Uniform(-0.5, 1.5), -0.5, 1.5),
    ("xavier_uniform", lambda I: I.XavierUniform(), None, None),
    ("kaiming_uniform", lambda I: I.KaimingUniform(), None, None),
])
def test_uniform_initializers_by_law(on_cpu, case):
    name, make, lo, hi = case
    fi, fo = JI._fans(N_DRAW)
    if name == "xavier_uniform":
        hi = math.sqrt(6.0 / (fi + fo))
        lo = -hi
    elif name == "kaiming_uniform":
        hi = math.sqrt(2.0) * math.sqrt(3.0 / fi)
        lo = -hi
    t = make(TI)(N_DRAW, "float32")
    assert float(t.min()) >= lo and float(t.max()) <= hi
    m, s = _moments(t)
    width = hi - lo
    n = t.numel()
    assert abs(m - (lo + hi) / 2) <= 5 * width / math.sqrt(12 * n)
    assert abs(s - width / math.sqrt(12)) <= 0.02 * width / math.sqrt(12)


@pytest.mark.parametrize("a,b", [(-2.0, 2.0), (-1.0, 0.5), (0.0, 3.0)])
def test_truncated_normal_by_law(on_cpu, a, b):
    """Inside (a, b) after mean 0.25 and std 0.5; standardized moments of
    the truncated law within 2% (std) and 5 standard errors (mean)."""
    t = TI.TruncatedNormal(0.25, 0.5, a, b)(N_DRAW, "float32")
    raw = (t.double() - 0.25) / 0.5
    assert float(raw.min()) > a - 1e-6 and float(raw.max()) < b + 1e-6
    phi = lambda z: math.exp(-z * z / 2) / math.sqrt(2 * math.pi)  # noqa
    cdf = lambda z: 0.5 * (1 + math.erf(z / math.sqrt(2)))  # noqa
    z = cdf(b) - cdf(a)
    mean = (phi(a) - phi(b)) / z
    var = 1 + (a * phi(a) - b * phi(b)) / z - mean ** 2
    n = raw.numel()
    assert abs(float(raw.mean()) - mean) <= 5 * math.sqrt(var / n)
    assert abs(float(raw.std()) - math.sqrt(var)) <= 0.02 * math.sqrt(var)
    ref = (np.asarray(JI.TruncatedNormal(0.25, 0.5, a, b)(
        N_DRAW, jnp.float32)) - 0.25) / 0.5
    assert ref.min() > a - 1e-6 and ref.max() < b + 1e-6


@pytest.mark.parametrize("shape,gain", [((6, 6), 1.0), ((9, 4), 2.0),
                                        ((3, 8), 1.0), ((4, 2, 3), 0.5)])
def test_orthogonal_by_law(on_cpu, shape, gain):
    q = TI.Orthogonal(gain)(shape, "float32")
    assert tuple(q.shape) == shape
    flat = q.reshape(shape[0], -1).double() / gain
    small = flat @ flat.T if flat.shape[0] <= flat.shape[1] else \
        flat.T @ flat
    np.testing.assert_allclose(small.numpy(), np.eye(small.shape[0]),
                               atol=1e-5)
    ref = np.asarray(JI.Orthogonal(gain)(shape, jnp.float32)).reshape(
        shape[0], -1) / gain
    rsmall = ref @ ref.T if ref.shape[0] <= ref.shape[1] else ref.T @ ref
    np.testing.assert_allclose(rsmall, np.eye(rsmall.shape[0]), atol=1e-5)


def test_draws_follow_the_port_generator(on_cpu):
    pt.seed(7)
    a = TI.Normal()((4, 4), "float32")
    b = TI.Normal()((4, 4), "float32")
    pt.seed(7)
    assert torch.equal(TI.Normal()((4, 4), "float32"), a)
    assert not torch.equal(a, b)


@pytest.mark.parametrize("make", [lambda I: I.Normal(0.5, 2.0),
                                  lambda I: I.Uniform(-1.0, 3.0)])
def test_host_draws_in_pieces_depend_on_the_key_alone(on_cpu, monkeypatch,
                                                      make):
    """A host tensor larger than ``_HOST_PIECE`` is drawn in pieces on a
    thread pool: the values do not depend on the thread count, each
    piece has its own stream, and the law holds."""
    monkeypatch.setattr(TI, "_HOST_PIECE", 1000)
    prev = torch.get_num_threads()
    draws = []
    try:
        for threads in (1, 4):
            torch.set_num_threads(threads)
            pt.seed(11)
            draws.append(make(TI)((64, 512), "float32"))
    finally:
        torch.set_num_threads(prev)
    assert torch.equal(draws[0], draws[1])
    flat = draws[0].reshape(-1)
    assert not torch.equal(flat[:1000], flat[1000:2000])
    want = np.asarray(make(JI)((64, 512), jnp.float32))
    m, s = _moments(draws[0])
    assert abs(m - want.mean()) < 0.05 and abs(s / want.std() - 1) < 0.02


def test_set_global_initializer_is_stored_and_not_read(on_cpu):
    """As in the reference, ``create_parameter`` does not consult it."""
    try:
        TI.set_global_initializer(TI.Constant(3.0), TI.Constant(4.0))
        JI.set_global_initializer(JI.Constant(3.0), JI.Constant(4.0))
        assert isinstance(TI._global_weight_init, TI.Constant)
        tb = tnn.Layer().create_parameter((3,), is_bias=True)
        jb = jnn.Layer().create_parameter((3,), is_bias=True)
        np.testing.assert_array_equal(tb.detach().numpy(), jb.numpy())
    finally:
        TI.set_global_initializer(None, None)
        JI.set_global_initializer(None, None)


# ---- LazyGuard ----

@pytest.fixture
def meta_target(monkeypatch):
    """Make the device a lazily built layer moves to ``meta`` (a device
    other than the host it is born on), for the facade and the port's
    layers alike."""
    monkeypatch.setattr(tnn.layers, "layer_device",
                        lambda: torch.device("meta"))
    real = tdevice.resolve_device
    monkeypatch.setattr(
        tdevice, "resolve_device",
        lambda d=None: torch.device("meta") if d is None else real(d))


class _Facade(tnn.Layer):
    def __init__(self, device=None):
        super().__init__()
        self.w = self.create_parameter((8, 4))
        self.head = tnn.Linear(4, 2, device=device)

    def forward(self, x):
        return self.head(tnn.functional.relu(x @ self.w))


def _deferred(net):
    return {n: m.__dict__.get("_lazy_target")
            for n, m in net.named_modules() if "_lazy_hook" in m.__dict__}


def test_lazy_guard_places_params_on_host_and_moves_on_use(on_cpu):
    """Born on the host, each module remembers its target (the CPU here:
    the card's move is phase 8b's) and its first forward places the whole
    tree and drops every hook; the parameters stay the same objects."""
    with pt.LazyGuard():
        net = _Facade("cpu")
    params = list(net.parameters())
    assert all(p.device.type == "cpu" for p in params)
    assert _deferred(net) == {"": torch.device("cpu"),
                              "head": torch.device("cpu")}
    opt = topt.SGD(learning_rate=0.1, parameters=net.parameters())
    out = net(torch.ones(2, 8))
    assert tuple(out.shape) == (2, 2) and _deferred(net) == {}
    assert [id(p) for p in net.parameters()] == [id(p) for p in params]
    assert [id(p) for p in opt._parameter_list] == [id(p) for p in params]
    assert not net._forward_pre_hooks and not net.head._forward_pre_hooks


def test_lazy_guard_targets_the_card_unless_cpu_is_asked(meta_target):
    """Without ``"cpu"`` the target is the device resolved for the card
    (``meta`` stands in for it here); an explicit ``.to`` places the
    tree and forgets every deferral."""
    with pt.LazyGuard():
        net = _Facade()
    assert all(p.device.type == "cpu" for p in net.parameters())
    assert set(_deferred(net).values()) == {torch.device("meta")}
    net.to("cpu")
    assert _deferred(net) == {}
    out = net(torch.ones(2, 8))
    assert out.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in net.parameters())


def test_lazy_guard_restores_and_nests():
    assert not tnn.in_lazy_mode()
    with pt.LazyGuard():
        assert tnn.in_lazy_mode()
        with pt.LazyGuard():
            assert tnn.in_lazy_mode()
        assert tnn.in_lazy_mode()
    assert not tnn.in_lazy_mode() and not jnn.in_lazy_mode()


def test_lazy_init_never_touches_the_target_device(meta_target):
    seen = []

    class Probe:
        def __call__(self, shape, dtype):
            arr = torch.zeros(shape, dtype=dtype)
            seen.append((torch.get_default_device().type, arr.device.type))
            return arr

    with pt.LazyGuard():
        p = tnn.Layer().create_parameter((4, 4),
                                         default_initializer=Probe())
    assert seen == [("cpu", "cpu")] and p.device.type == "cpu"
    tnn.Layer().create_parameter((4, 4), default_initializer=Probe())
    assert seen[-1] == ("meta", "meta")


def test_lazy_model_trains_after_guard_like_jax(on_cpu):
    with paddle.LazyGuard():
        jnet = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(),
                              jnn.Linear(8, 2))
    with pt.LazyGuard():
        tnet = tnn.Sequential(tnn.Linear(4, 8, device="cpu"), tnn.ReLU(),
                              tnn.Linear(8, 2, device="cpu"))
    arrays = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    tnet.load_state_dict(layer_state_from_jax(arrays, tnet))
    jopt = paddle.optimizer.SGD(learning_rate=0.1,
                                parameters=jnet.parameters())
    topt_ = topt.SGD(learning_rate=0.1, parameters=tnet.parameters())
    x = _a(4, 4, seed=5)
    y = np.zeros(4, np.int64)
    jl, tl = [], []
    for _ in range(3):
        loss = jnn.functional.cross_entropy(jnet(paddle.to_tensor(x)),
                                            paddle.to_tensor(y))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss))
        tloss = tnn.functional.cross_entropy(tnet(torch.from_numpy(x)),
                                             torch.from_numpy(y))
        tloss.backward()
        topt_.step()
        topt_.clear_grad()
        tl.append(float(tloss))
    _close(tl, jl, what="losses")
    assert tl[-1] < tl[0]


def test_lazy_and_facade_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    prev = tdevice._layer_device
    tdevice._layer_device = None
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tnn.Layer().create_parameter((2,))
        with pt.LazyGuard(), pytest.raises(RuntimeError,
                                           match="CUDA is not available"):
            tnn.Linear(4, 2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt.set_device("gpu")
        assert pt.set_device("cpu") == torch.device("cpu")
        assert tdevice.layer_device() == torch.device("cpu")
    finally:
        tdevice._layer_device = prev


def test_existing_layers_keep_their_classes():
    from paddle_tpu_torch.models.ocr import CRNN
    from paddle_tpu_torch.vision.models import LeNet
    assert issubclass(tnn.Layer, torch.nn.Module)
    assert issubclass(LeNet, tnn.Layer) and issubclass(CRNN, tnn.Layer)
    net = LeNet(device="cpu")
    assert isinstance(net, torch.nn.Module) and net.full_name() == "lenet"
    assert net(torch.zeros(1, 1, 28, 28)).shape == (1, 10)
