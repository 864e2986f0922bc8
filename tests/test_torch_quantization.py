"""The port's quantization (``paddle_tpu_torch.quantization`` and
``paddle_tpu_torch.nn.quant``) held against the JAX package's on the
CPU, case for case with ``tests/test_quantization.py``, on the same numpy
inputs and bridged weights (``models.convert.vision_state_from_jax``):

- the QDQ rules (``fake_quant``, ``quantize_tensor``,
  ``dequantize_tensor``), the straight-through gradient and the
  observers: bit-equal to the reference's;
- QAT: the wrapped layer types, eager training steps and steps under
  ``TrainStep`` (losses, parameters and the quanters' buffers within
  ``1e-5``), and ``convert``'s int8 codes and scales bit-equal to the
  reference's from the same weights;
- PTQ: the activation scales (the first layer's input is the batch
  itself, so its scale is bit-equal; a deeper layer's input comes out
  of the other package's float32 convolution or product, so its scale
  agrees to float32 rounding, ``rtol 1e-6``), converted outputs within
  ``1e-5``, and ``bit_length=4`` codes bit-equal;
- ``QuantConfig``'s type and layer overrides with an explicit ``None``,
  the state dict's names and round trip, no duplicate parameters,
  ``quant_post_static``;
- the quantized matmul's fused bias+act epilogue (the plain version)
  against the unfused product and the reference's interpret-mode
  kernel; ``fuse_act_into_quant_linear`` and the fused layer's
  differentiable route under grad, under both values of
  ``FLAGS_use_int8_matmul_kernel``;
- the forward half of ``test_int8_ptq_through_predictor``.

Tolerances: outputs within ``1e-5`` of the reference's largest entry
(``max(1, |ref|)``), float32.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import quantization as jq
from paddle_tpu.nn import quant as jnq
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.models.convert import vision_state_from_jax
from paddle_tpu_torch.nn import quant as tnq

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def kernel_flag():
    """Sets ``FLAGS_use_int8_matmul_kernel`` for one test, then restores
    the default."""
    yield lambda on: set_flags({"FLAGS_use_int8_matmul_kernel": on})
    set_flags({"FLAGS_use_int8_matmul_kernel": False})


def _close(got, want, rel=REL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol, (what, err, tol)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _j(a):
    return paddle.to_tensor(np.array(a, copy=True))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return np.asarray(t._value) if hasattr(t, "_value") \
        else t.detach().cpu().numpy()


def _jnet():
    return jnn.Sequential(
        jnn.Conv2D(3, 8, 3, padding=1), jnn.ReLU(),
        jnn.AdaptiveAvgPool2D(1), jnn.Flatten(),
        jnn.Linear(8, 4))


def _tnet():
    return tnn.Sequential(
        tnn.Conv2D(3, 8, 3, padding=1, device="cpu"), tnn.ReLU(),
        tnn.AdaptiveAvgPool2D(1), tnn.Flatten(),
        tnn.Linear(8, 4, device="cpu"))


def _jax_state(jmodel):
    state = {n: np.asarray(p._value) for n, p in jmodel.named_parameters()}
    state.update({n: np.asarray(b._value)
                  for n, b in jmodel.named_buffers()})
    return state


def _bridge(jmodel, tmodel):
    """Load ``jmodel``'s parameters and buffers into ``tmodel`` (Linear
    weights transposed, by the port model's types)."""
    tmodel.load_state_dict(vision_state_from_jax(_jax_state(jmodel),
                                                 tmodel))
    return tmodel


def _pair(seed=0):
    paddle.seed(seed)
    jnet = _jnet()
    return jnet, _bridge(jnet, _tnet())


def _hold_state(jmodel, tmodel, rel=REL):
    """Every parameter and buffer of ``tmodel`` against ``jmodel``'s."""
    want = vision_state_from_jax(_jax_state(jmodel), tmodel)
    got = tmodel.state_dict()
    assert set(got) == set(want)
    for name, t in got.items():
        if t.dtype == torch.bool:
            assert torch.equal(t, want[name]), name
        else:
            _close(t.numpy(), want[name].numpy(), rel, name)


def _types(model):
    return [type(m).__name__ for m in model.modules()]


# ---------------------------------------------------------------- QDQ


def test_fake_quant_roundtrip():
    x = np.linspace(-1, 1, 17, dtype=np.float32)
    scale = np.float32(1.0 / 127)
    want = _np(jq.fake_quant(_j(x), _j(scale), bits=8))
    got = tq.fake_quant(_t(x), _t(scale), bits=8).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - x).max() <= (1.0 / 127) / 2 + 1e-7


@pytest.mark.parametrize("bits,axis", [(8, 1), (4, 1), (8, 0), (8, None)])
def test_quantize_dequantize_tensor(bits, axis):
    w = _rand((4, 6), 0)
    red = np.abs(w).max() if axis is None else np.abs(w).max(axis=1 - axis)
    scale = (red / (2 ** (bits - 1) - 1)).astype(np.float32)
    jcodes = jq.quantize_tensor(_j(w), _j(scale), bits=bits, axis=axis)
    codes = tq.quantize_tensor(_t(w), _t(scale), bits=bits, axis=axis)
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), _np(jcodes))
    dq = tq.dequantize_tensor(codes, _t(scale), axis=axis)
    np.testing.assert_array_equal(
        dq.numpy(), _np(jq.dequantize_tensor(jcodes, _j(scale), axis=axis)))
    assert np.abs(dq.numpy() - w).max() < float(scale.max())


def test_fake_quant_ste_gradient():
    x = np.array([0.3, -0.7, 2.5], np.float32)
    scale = np.float32(1.0 / 127)
    jx = paddle.to_tensor(x.copy(), stop_gradient=False)
    jq.fake_quant(jx, _j(scale)).sum().backward()
    tx = _t(x).requires_grad_(True)
    y = tq.fake_quant(tx, _t(scale))
    y.sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), _np(jx.grad))
    np.testing.assert_array_equal(tx.grad.numpy(), [1.0, 1.0, 1.0])


@pytest.mark.parametrize("name,kw", [
    ("AbsmaxObserver", {}), ("MovingAverageAbsmaxObserver", {}),
    ("MovingAverageAbsmaxObserver", {"moving_rate": 0.7}),
    ("PerChannelAbsmaxObserver", {"quant_axis": 1}),
    ("PerChannelAbsmaxObserver", {"quant_axis": -1, "bit_length": 4}),
])
def test_observers_bit_equal(name, kw):
    jobs, tobs = getattr(jq, name)(**kw), getattr(tq, name)(**kw)
    for i in range(4):
        x = _rand((3, 5, 6), i, scale=1.0 + i)
        jout = jobs(_j(x))
        tout = tobs(_t(x))
        np.testing.assert_array_equal(tout.numpy(), _np(jout))
    np.testing.assert_array_equal(tobs.scales().numpy(),
                                  _np(jobs.scales()))
    assert tobs.bit_length() == jobs.bit_length()
    assert tobs.quant_axis() == jobs.quant_axis()
    np.testing.assert_array_equal(
        tq.absmax_to_scales(tobs.scales(), tobs.bit_length()).numpy(),
        _np(jq.absmax_to_scales(_np(jobs.scales()), jobs.bit_length())))


@pytest.mark.parametrize("rate", [0.9, 0.5])
def test_activation_quanter_ema_bit_equal(rate):
    jquant = jq.FakeQuanterWithAbsMaxObserver(moving_rate=rate)
    tquant = tq.FakeQuanterWithAbsMaxObserver(moving_rate=rate)
    for i in range(3):
        x = _rand((4, 7), 10 + i, scale=0.5 + i)
        np.testing.assert_array_equal(tquant(_t(x)).numpy(),
                                      _np(jquant(_j(x))))
        np.testing.assert_array_equal(tquant.scale.numpy(),
                                      _np(jquant.scale))
    assert bool(tquant._initialized)
    jquant.eval()
    tquant.eval()
    x = _rand((4, 7), 20, scale=9.0)
    np.testing.assert_array_equal(tquant(_t(x)).numpy(), _np(jquant(_j(x))))
    np.testing.assert_array_equal(tquant.scale.numpy(), _np(jquant.scale))


def test_weight_quanter_floors_after_the_divide():
    w = _rand((4, 6), 3)
    w[1] = 0.0                  # a dead channel: the floor decides
    jw = jq.FakeQuanterChannelWiseAbsMaxObserver(quant_axis=0)
    tw = tq.FakeQuanterChannelWiseAbsMaxObserver(quant_axis=0)
    np.testing.assert_array_equal(tw(_t(w)).numpy(), _np(jw(_j(w))))
    np.testing.assert_array_equal(tw.scales().numpy(), _np(jw.scales()))
    assert tw.scales()[1].item() == np.float32(1e-9)


def test_exports_match_the_reference():
    assert tq.__all__ == jq.__all__
    assert tnq.__all__ == jnq.__all__
    for name in tq.__all__:
        assert hasattr(tq, name), name
    for name in tnq.__all__:
        assert hasattr(tnq, name), name


# ---------------------------------------------------------------- QAT

QAT_CFG = dict(activation=(jq.FakeQuanterWithAbsMaxObserver,
                           tq.FakeQuanterWithAbsMaxObserver),
               weight=(jq.FakeQuanterChannelWiseAbsMaxObserver,
                       tq.FakeQuanterChannelWiseAbsMaxObserver))


def _qat_pair(seed):
    jnet, tnet = _pair(seed)
    jqat = jq.QAT(jq.QuantConfig(activation=QAT_CFG["activation"][0],
                                 weight=QAT_CFG["weight"][0]))
    tqat = tq.QAT(tq.QuantConfig(activation=QAT_CFG["activation"][1],
                                 weight=QAT_CFG["weight"][1]))
    return jqat, tqat, jqat.quantize(jnet), tqat.quantize(tnet)


def _batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 3, 8, 8)).astype(np.float32),
            rng.integers(0, 4, size=(b,)).astype(np.int64))


def test_qat_quantize_and_train():
    jqat, tqat, jm, tm = _qat_pair(1)
    assert "QuantedConv2D" in _types(tm) and "QuantedLinear" in _types(tm)
    jo = jopt.SGD(learning_rate=0.05, parameters=jm.parameters())
    to = topt.SGD(learning_rate=0.05, parameters=tm.parameters())
    x, y = _batch(1)
    jm.train()
    tm.train()
    jl, tl = [], []
    for _ in range(5):
        loss = jnn.functional.cross_entropy(jm(_j(x)), _j(y))
        loss.backward()
        jo.step()
        jo.clear_grad()
        jl.append(float(loss))
        loss = tnn.functional.cross_entropy(tm(_t(x)), _t(y))
        loss.backward()
        to.step()
        to.clear_grad()
        tl.append(float(loss.detach()))
    _close(tl, jl, what="losses")
    assert tl[-1] < tl[0]
    _hold_state(jm, tm)
    infer = tqat.convert(tm)
    assert "QuantizedLinearInfer" in _types(infer)
    assert "QuantizedConv2DInfer" in _types(infer)
    infer.eval()
    out = infer(_t(x))
    assert tuple(out.shape) == (4, 4) and torch.isfinite(out).all()


def test_qat_under_train_step_matches_jax():
    from paddle_tpu.jit.train_step import TrainStep as JStep
    from paddle_tpu_torch.jit.train_step import TrainStep as TStep
    jqat, tqat, jm, tm = _qat_pair(7)
    jm.train()
    tm.train()
    jstep = JStep(jm, lambda net, a, b: jnn.functional.cross_entropy(
        net(a), b), jopt.SGD(learning_rate=0.05, parameters=jm.parameters()))
    tstep = TStep(tm, lambda net, a, b: tnn.functional.cross_entropy(
        net(a), b), topt.SGD(learning_rate=0.05, parameters=tm.parameters()))
    x, y = _batch(7)
    jl = [float(jstep(_j(x), _j(y))) for _ in range(4)]
    tl = [float(tstep(_t(x), _t(y))) for _ in range(4)]
    _close(tl, jl, what="losses")
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]
    _hold_state(jm, tm)


def test_qat_convert_codes_bit_equal():
    """Converted codes and scales of the same weights equal the
    reference's bit for bit (the trained JAX weights bridged into the port
    model first), and the converted models agree."""
    jqat, tqat, jm, tm = _qat_pair(3)
    jo = jopt.SGD(learning_rate=0.05, parameters=jm.parameters())
    x, y = _batch(3)
    jm.train()
    for _ in range(2):
        loss = jnn.functional.cross_entropy(jm(_j(x)), _j(y))
        loss.backward()
        jo.step()
        jo.clear_grad()
    _bridge(jm, tm)
    ji, ti = jqat.convert(jm), tqat.convert(tm)
    for k in (0, 4):
        jl, tl = ji[k], ti[k]
        assert type(tl).__name__ == type(jl).__name__
        assert tl.qweight.dtype == torch.int8
        np.testing.assert_array_equal(tl.qweight.numpy(), _np(jl.qweight))
        np.testing.assert_array_equal(tl.weight_scale.numpy(),
                                      _np(jl.weight_scale))
        np.testing.assert_array_equal(tl._act_scale.numpy(),
                                      _np(jl._act_scale))
        assert tl._bits == jl._bits == 8
    assert ti[4].qweight.shape == (8, 4)      # [in, out], the kernel's K, N
    ji.eval()
    ti.eval()
    _close(ti(_t(x)).detach().numpy(), _np(ji(_j(x))), what="converted")


def test_qat_convert_close_to_float():
    jnet, tnet = _pair(2)
    x = _rand((2, 3, 8, 8), 2)
    ref = tnet(_t(x)).detach().numpy()
    jqat = jq.QAT(jq.QuantConfig(
        activation=None, weight=jq.FakeQuanterChannelWiseAbsMaxObserver))
    tqat = tq.QAT(tq.QuantConfig(
        activation=None, weight=tq.FakeQuanterChannelWiseAbsMaxObserver))
    jinf = jqat.convert(jqat.quantize(jnet))
    tinf = tqat.convert(tqat.quantize(tnet))
    out = tinf(_t(x)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=0.1, rtol=0.1)
    _close(out, _np(jinf(_j(x))), what="converted")


def test_quant_config_type_override():
    for pkg, nn_, make in ((jq, jnn, _jnet), (tq, tnn, _tnet)):
        cfg = pkg.QuantConfig(activation=None, weight=None)
        cfg.add_type_config(nn_.Linear,
                            weight=pkg.FakeQuanterChannelWiseAbsMaxObserver)
        q = pkg.QAT(cfg).quantize(make())
        names = [type(q[i]).__name__ for i in range(5)]
        assert "QuantedLinear" in names and "QuantedConv2D" not in names


def test_quant_config_explicit_none_exempts_layer():
    for pkg, make in ((jq, _jnet), (tq, _tnet)):
        model = make()
        cfg = pkg.QuantConfig(
            activation=pkg.FakeQuanterWithAbsMaxObserver,
            weight=pkg.FakeQuanterChannelWiseAbsMaxObserver)
        cfg.add_layer_config(model[4], activation=None, weight=None)
        q = pkg.QAT(cfg).quantize(model)
        names = [type(q[i]).__name__ for i in range(5)]
        assert "QuantedConv2D" in names and "QuantedLinear" not in names
        assert names[4] == "Linear"
    with pytest.raises(TypeError, match="quanter class or factory"):
        tq.QuantConfig(activation=3)


def test_qat_state_dict_roundtrip():
    jqat, tqat, jm, tm = _qat_pair(4)
    x = _rand((1, 3, 8, 8), 4)
    jm.train()
    tm.train()
    jm(_j(x))
    tm(_t(x))
    sd = tm.state_dict()
    assert set(sd) == set(jm.state_dict())
    assert any("scale" in k for k in sd)
    _hold_state(jm, tm)
    other = tqat.quantize(_tnet())
    other.load_state_dict(sd)
    tm.eval()
    other.eval()
    np.testing.assert_array_equal(other(_t(x)).detach().numpy(),
                                  tm(_t(x)).detach().numpy())


def test_qat_no_duplicate_params():
    _, _, jm, tm = _qat_pair(5)
    ids = [id(p) for p in tm.parameters()]
    assert len(ids) == len(set(ids)) == len(list(jm.parameters()))
    assert not any("_float_layer" in k for k in tm.state_dict())


# ---------------------------------------------------------------- PTQ


def _ptq_pair(seed, act=(jq.AbsmaxObserver, tq.AbsmaxObserver),
              weight=(None, None)):
    jnet, tnet = _pair(seed)
    jptq = jq.PTQ(jq.QuantConfig(activation=act[0], weight=weight[0]))
    tptq = tq.PTQ(tq.QuantConfig(activation=act[1], weight=weight[1]))
    return jptq, tptq, jptq.quantize(jnet), tptq.quantize(tnet)


@pytest.mark.parametrize("obs", ["AbsmaxObserver",
                                 "MovingAverageAbsmaxObserver"])
def test_ptq_calibrate_convert(obs):
    jptq, tptq, jm, tm = _ptq_pair(3, act=(getattr(jq, obs),
                                           getattr(tq, obs)))
    ref_in = _rand((2, 3, 8, 8), 30)
    ref = tm(_t(ref_in)).detach().numpy()      # observers are identity
    _close(ref, _np(jm(_j(ref_in))), what="observed")
    for i in range(3):
        x = _rand((2, 3, 8, 8), 31 + i)
        jm(_j(x))
        tm(_t(x))
    ji, ti = jptq.convert(jm), tptq.convert(tm)
    assert "QuantizedConv2DInfer" in _types(ti)
    assert "QuantizedLinearInfer" in _types(ti)
    # the first layer observes the batch itself: bit-equal; the Linear's
    # input comes out of each package's float32 convolution
    np.testing.assert_array_equal(ti[0]._act_scale.numpy(),
                                  _np(ji[0]._act_scale))
    np.testing.assert_allclose(ti[4]._act_scale.numpy(),
                               _np(ji[4]._act_scale), rtol=1e-6)
    for k in (0, 4):
        np.testing.assert_array_equal(ti[k].qweight.numpy(),
                                      _np(ji[k].qweight))
        np.testing.assert_array_equal(ti[k].weight_scale.numpy(),
                                      _np(ji[k].weight_scale))
    out = ti(_t(ref_in)).detach().numpy()
    _close(out, _np(ji(_j(ref_in))), what="converted")
    np.testing.assert_allclose(out, ref, atol=0.15, rtol=0.15)


def test_ptq_honors_weight_bits():
    jm = jnn.Sequential(jnn.Linear(8, 4))
    tm = tnn.Sequential(tnn.Linear(8, 4, device="cpu"))
    _bridge(jm, tm)
    x = _rand((2, 8), 8)
    out = []
    for pkg, m, wrap in ((jq, jm, _j), (tq, tm, _t)):
        ptq = pkg.PTQ(pkg.QuantConfig(
            activation=pkg.AbsmaxObserver,
            weight=pkg.config.quanter_factory(pkg.PerChannelAbsmaxObserver,
                                              bit_length=4)))
        q = ptq.quantize(m)
        q(wrap(x))
        out.append(ptq.convert(q)[0])
    jl, tl = out
    assert tl._bits == jl._bits == 4
    qw = tl.qweight.numpy()
    assert qw.max() <= 7 and qw.min() >= -7
    np.testing.assert_array_equal(qw, _np(jl.qweight))
    np.testing.assert_array_equal(tl.weight_scale.numpy(),
                                  _np(jl.weight_scale))


def test_ptq_refuses_a_quanter_as_observer():
    ptq = tq.PTQ(tq.QuantConfig(
        activation=tq.FakeQuanterWithAbsMaxObserver))
    with pytest.raises(TypeError, match="must be an observer class"):
        ptq.quantize(_tnet())


def test_static_quant_post_static():
    from paddle_tpu.static.quantization import quant_post_static as jqps
    from paddle_tpu_torch.static.quantization import \
        quant_post_static as tqps
    jnet, tnet = _pair(11)
    xs = _rand((16, 3, 8, 8), 11)
    jloader = [(_j(xs[i * 4:(i + 1) * 4]),) for i in range(4)]
    tloader = [(_t(xs[i * 4:(i + 1) * 4]),) for i in range(4)]
    jq_model = jqps(jnet, jloader, batch_nums=3)
    tq_model = tqps(tnet, tloader, batch_nums=3)
    assert "QuantizedConv2DInfer" in _types(tq_model)
    assert "QuantizedLinearInfer" in _types(tq_model)
    assert "Conv2D" in _types(tnet) and "QuantizedConv2DInfer" \
        not in _types(tnet)                   # the float model untouched
    out = tq_model(_t(xs[:2])).detach().numpy()
    assert np.isfinite(out).all()
    _close(out, _np(jq_model(_j(xs[:2]))), what="converted")


# ------------------------------------------- the kernel's epilogues


def _qmm_inputs():
    rng = np.random.default_rng(0)
    m, k, n = 16, 128, 256
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.integers(-127, 127, (k, n)).astype(np.int8),
            rng.uniform(0.01, 0.02, (n,)).astype(np.float32),
            rng.standard_normal((n,)).astype(np.float32))


def _gelu_tanh(v):
    return 0.5 * v * (1 + np.tanh(0.7978845608028654 *
                                  (v + 0.044715 * v ** 3)))


@pytest.mark.parametrize("act", ["relu", "gelu", "silu"])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_epilogue_matches_unfused(act, bias):
    """dequant + bias + act in the kernel's epilogue (the plain version)
    == the unfused product + act, and == the reference's interpret-mode
    kernel."""
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas.quantized_matmul import \
        quantized_matmul as jqmm
    from paddle_tpu_torch.ops.quantized_matmul import quantized_matmul
    x, qw, s, b = _qmm_inputs()
    ref = {"relu": lambda v: np.maximum(v, 0), "gelu": _gelu_tanh,
           "silu": lambda v: v / (1 + np.exp(-v))}[act]
    base = quantized_matmul(_t(x), _t(qw), _t(s)).numpy().astype(np.float64)
    if bias:
        base = base + b
    got = quantized_matmul(_t(x), _t(qw), _t(s),
                           bias=_t(b) if bias else None, act=act).numpy()
    np.testing.assert_allclose(got, ref(base), rtol=1e-5, atol=1e-5)
    want = np.asarray(jqmm(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(s),
                           bias=jnp.asarray(b) if bias else None, act=act))
    _close(got, want, what=act)


def _act_net(pkg_nn, linear_kw):
    return pkg_nn.Sequential(pkg_nn.Linear(32, 64, **linear_kw),
                             pkg_nn.GELU(),
                             pkg_nn.Linear(64, 32, **linear_kw),
                             pkg_nn.ReLU(),
                             pkg_nn.Linear(32, 16, **linear_kw),
                             pkg_nn.Tanh())          # tanh is not fusable


@pytest.mark.parametrize("kernel", [False, True])
def test_fuse_act_pass_and_layer_parity(kernel, kernel_flag):
    paddle.seed(0)
    jm = _act_net(jnn, {})
    tm = _bridge(jm, _act_net(tnn, {"device": "cpu"}))
    x = _rand((4, 32), 1)
    jq.weight_only_quantize(jm)
    tq.weight_only_quantize(tm)
    kernel_flag(kernel)
    want = _np(jm(_j(x)))
    unfused = tm(_t(x)).detach().numpy()
    _close(unfused, want, what="unfused")
    assert tq.fuse_act_into_quant_linear(tm) == 2
    assert jq.fuse_act_into_quant_linear(jm) == 2
    assert tm[0]._fused_act == "gelu" and tm[2]._fused_act == "relu"
    assert type(tm[1]).__name__ == "Identity"
    assert isinstance(tm[4], tnq.QuantizedLinearInfer) \
        and tm[4]._fused_act is None
    assert tq.fuse_act_into_quant_linear(tm) == 0
    got = tm(_t(x)).detach().numpy()
    _close(got, _np(jm(_j(x))), what="fused")
    # the fused GELU is the tanh approximation: <= ~3e-3 from the exact
    np.testing.assert_allclose(got, unfused, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kernel", [False, True])
def test_fused_act_grad_fallback(kernel, kernel_flag):
    """A fused-act layer fed an x that requires grad keeps the graph:
    the differentiable dequant route, under either flag value; its
    gradient equals the reference's."""
    paddle.seed(2)
    jm = jnn.Sequential(jnn.Linear(16, 32), jnn.GELU())
    tm = _bridge(jm, tnn.Sequential(tnn.Linear(16, 32, device="cpu"),
                                    tnn.GELU()))
    for pkg, m in ((jq, jm), (tq, tm)):
        pkg.weight_only_quantize(m)
        assert pkg.fuse_act_into_quant_linear(m) == 1
    kernel_flag(kernel)
    x = _rand((4, 16), 3)
    jx = paddle.to_tensor(x.copy(), stop_gradient=False)
    jm(jx).sum().backward()
    tx = _t(x).requires_grad_(True)
    out = tm(tx)
    assert out.requires_grad, "output silently detached"
    out.sum().backward()
    assert float(tx.grad.abs().sum()) > 0
    _close(tx.grad.numpy(), _np(jx.grad), what="grad")
    with torch.no_grad():
        _close(tm(_t(x)).numpy(), _np(jm(_j(x))), what="no-grad route")


def test_kernel_route_is_differentiable_in_x(kernel_flag):
    """Unfused under the flag: the quantized matmul's int8 form is
    differentiable in x and the bias (added after it) takes its
    gradient."""
    paddle.seed(4)
    jm = jnn.Sequential(jnn.Linear(16, 32))
    tm = _bridge(jm, tnn.Sequential(tnn.Linear(16, 32, device="cpu")))
    jq.weight_only_quantize(jm)
    tq.weight_only_quantize(tm)
    kernel_flag(True)
    x = _rand((4, 16), 5)
    jx = paddle.to_tensor(x.copy(), stop_gradient=False)
    jm(jx).sum().backward()
    tx = _t(x).requires_grad_(True)
    tm(tx).sum().backward()
    _close(tx.grad.numpy(), _np(jx.grad), what="grad")
    assert tm[0].bias.grad is not None
    np.testing.assert_allclose(tm[0].bias.grad.numpy(), 4.0)


def test_empty_like_has_the_linear_shape():
    """``QuantizedLinearInfer.empty_like``: the converted layer of a
    Linear's shape (what an artifact's load fills), the Linear's bias
    kept, bits and the folded act as given."""
    lin = tnn.Linear(6, 10, device="cpu")
    q = tnq.QuantizedLinearInfer.empty_like(lin, bits=4, fused_act="relu")
    assert q.qweight.shape == (6, 10) and q.qweight.dtype == torch.int8
    assert q.weight_scale.shape == (10,)
    assert q.weight_scale.dtype == torch.float32
    assert q.bias is lin.bias
    assert (q._bits, q._fused_act) == (4, "relu")
    assert (q.in_features, q.out_features) == (6, 10)


def test_int8_ptq_forward_half_of_the_predictor_case(kernel_flag):
    """The forward half of the reference's
    ``test_int8_ptq_through_predictor``: PTQ-calibrate, convert, fold the
    GELU; int8 outputs stay close to the float model's and equal the
    reference's.  (The ``jit.save`` + ``create_predictor`` half is
    ``tests/test_torch_predictor.py::test_int8_ptq_through_predictor``.)"""
    paddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(32, 64), jnn.GELU(), jnn.Linear(64, 16))
    tm = _bridge(jm, tnn.Sequential(tnn.Linear(32, 64, device="cpu"),
                                    tnn.GELU(),
                                    tnn.Linear(64, 16, device="cpu")))
    rng = np.random.default_rng(0)
    calib = [rng.standard_normal((8, 32)).astype(np.float32)
             for _ in range(4)]
    ref_out = tm(_t(calib[0])).detach().numpy()
    for pkg, m, wrap in ((jq, jm, _j), (tq, tm, _t)):
        ptq = pkg.PTQ(pkg.QuantConfig(activation=pkg.AbsmaxObserver,
                                      weight=None))
        ptq.quantize(m)
        for batch in calib:
            m(wrap(batch))
        ptq.convert(m)
    assert any(isinstance(s, tnq.QuantizedLinearInfer) for s in tm.modules())
    q_out = tm(_t(calib[0])).detach().numpy()
    rel = np.abs(q_out - ref_out).max() / (np.abs(ref_out).max() + 1e-9)
    assert rel < 0.05, rel
    _close(q_out, _np(jm(_j(calib[0]))), what="converted")
    assert tq.fuse_act_into_quant_linear(tm) == 1
    assert jq.fuse_act_into_quant_linear(jm) == 1
    want = _np(jm(_j(calib[0])))
    for kernel in (False, True):
        kernel_flag(kernel)
        _close(tm(_t(calib[0])).detach().numpy(), want,
               what=f"fused, kernel={kernel}")
