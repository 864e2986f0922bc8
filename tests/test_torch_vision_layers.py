"""The port's vision and OCR layers held against the JAX package's on the
CPU, on the same numpy inputs: every convolution form (paddings, groups,
dilation, channels-last, 1-D/2-D/3-D, transposes with
``output_padding``), the pools, batch norm (train and eval, the buffers
after two calls, bf16 buffers, ``use_global_stats``), group, instance,
local-response and spectral norm, ``interpolate`` in every mode, the
activations, containers, common ops and losses, and ``ctc_loss`` with
its gradient (a label too long for its input included).

Tolerances (float32; both sides sum in other orders): values and input
gradients within ``1e-5`` of the reference's largest entry (``max(1,
|ref|)``); batch-norm buffers ``atol 1e-6``; bf16 buffers within one
bf16 ulp of the reference's (its float32 statistics are summed in
another order before the one rounding).  Gradients come from
``jax.vjp`` of the reference's functional (the way its ``TrainStep``
differentiates) and from torch autograd, with one cotangent.
"""

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rand(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol, (what, err, tol)


def _both(jfn, tfn, inputs, diff=(0,), seed=7, rel=REL):
    """Outputs of both functionals on ``inputs`` (numpy), and the
    gradients of ``<out, g>`` for a random cotangent ``g`` with respect to
    the inputs indexed by ``diff``."""
    def jf(*arrs):
        full = list(map(jnp.asarray, inputs))
        for i, a in zip(diff, arrs):
            full[i] = a
        return jfn(*[JTensor(a) for a in full])._value

    want, vjp = jax.vjp(jf, *[jnp.asarray(inputs[i]) for i in diff])
    g = _rand(np.shape(want), seed)
    wgrads = vjp(jnp.asarray(g, dtype=want.dtype))
    tin = [torch.tensor(np.array(a, copy=True)) for a in inputs]
    for i in diff:
        tin[i].requires_grad_(True)
    got = tfn(*tin)
    _close(got.detach().numpy(), want, rel, "value")
    if diff:
        (got * torch.from_numpy(g)).sum().backward()
        for i, wg in zip(diff, wgrads):
            _close(tin[i].grad.numpy(), wg, rel, f"grad {i}")
    return got


# ---------------------------------------------------------------- conv

CONV = [
    # (n, x shape, w shape, kwargs)
    (2, (2, 4, 9, 8), (6, 4, 3, 3), dict(padding=1)),
    (2, (2, 4, 9, 8), (6, 4, 3, 3), dict(padding=[1, 2], stride=2)),
    (2, (2, 4, 9, 8), (6, 4, 3, 2), dict(padding=[[1, 0], [0, 2]])),
    (2, (2, 4, 9, 8), (6, 4, 3, 3), dict(padding=[1, 0, 2, 1])),
    (2, (2, 4, 9, 8), (6, 4, 3, 3), dict(padding="SAME", stride=2)),
    (2, (2, 4, 9, 8), (6, 4, 3, 3), dict(padding="VALID")),
    (2, (2, 4, 9, 8), (6, 4, 3, 3), dict(padding=2, dilation=2)),
    (2, (2, 4, 9, 8), (6, 2, 3, 3), dict(padding=1, groups=2)),
    (2, (2, 9, 8, 4), (6, 4, 3, 3), dict(padding=1, stride=2,
                                         data_format="NHWC")),
    (2, (2, 9, 8, 4), (4, 1, 3, 3), dict(padding="SAME", groups=4,
                                         data_format="NHWC")),
    (1, (2, 4, 11), (6, 4, 3), dict(padding=1, stride=2)),
    (1, (2, 11, 4), (6, 4, 3), dict(padding="SAME", data_format="NLC")),
    (3, (1, 3, 5, 6, 4), (4, 3, 3, 3, 3), dict(padding=1)),
    (3, (1, 5, 6, 4, 3), (4, 3, 2, 3, 3), dict(padding="SAME", stride=2,
                                               data_format="NDHWC")),
]


@pytest.mark.parametrize("n,xs,ws,kw", CONV)
def test_conv_forms(n, xs, ws, kw):
    name = f"conv{n}d"
    x, w, b = _rand(xs, 1), _rand(ws, 2) * 0.3, _rand((ws[0],), 3)
    _both(lambda a, c, d: getattr(JF, name)(a, c, d, **kw),
          lambda a, c, d: getattr(TF, name)(a, c, d, **kw), [x, w, b],
          diff=(0, 1, 2))


CONV_T = [
    (2, (2, 4, 5, 6), (4, 3, 3, 3), dict(stride=2, padding=1,
                                         output_padding=1)),
    (2, (2, 4, 5, 6), (4, 3, 2, 2), dict(stride=2)),
    (2, (2, 4, 5, 6), (4, 3, 3, 3), dict(stride=2, padding=[[1, 0],
                                                            [0, 2]])),
    (2, (2, 4, 5, 6), (4, 3, 3, 3), dict(stride=1, padding=2, dilation=2)),
    (2, (2, 4, 5, 6), (4, 3, 3, 3), dict(stride=2, padding=[2, 0, 0, 1],
                                         output_padding=1)),
    (2, (2, 4, 5, 6), (4, 3, 3, 3), dict(stride=3, padding=0,
                                         output_padding=2)),
    (2, (2, 5, 6, 4), (4, 3, 3, 3), dict(stride=2, padding=1,
                                         data_format="NHWC")),
    (1, (2, 4, 7), (4, 3, 4), dict(stride=2, padding=1, output_padding=1)),
    (3, (1, 3, 3, 4, 3), (3, 2, 2, 2, 2), dict(stride=2)),
]


@pytest.mark.parametrize("n,xs,ws,kw", CONV_T)
def test_conv_transpose_forms(n, xs, ws, kw):
    name = f"conv{n}d_transpose"
    x, w, b = _rand(xs, 1), _rand(ws, 2) * 0.3, _rand((ws[1],), 3)
    _both(lambda a, c, d: getattr(JF, name)(a, c, d, **kw),
          lambda a, c, d: getattr(TF, name)(a, c, d, **kw), [x, w, b],
          diff=(0, 1, 2))


@pytest.mark.parametrize("kw", [dict(groups=2), dict(padding="SAME"),
                                dict(padding="VALID")])
def test_conv_transpose_refusals_follow_the_reference(kw):
    x, w = _rand((1, 4, 5, 5)), _rand((4, 2, 3, 3))
    with pytest.raises(ValueError):
        JF.conv2d_transpose(JTensor(jnp.asarray(x)), JTensor(jnp.asarray(w)),
                            stride=2, **kw)
    with pytest.raises(ValueError, match="reference"):
        TF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                            stride=2, **kw)


def test_conv_layers_shapes_and_init():
    c = tnn.Conv2D(4, 6, 3, groups=2, device="cpu")
    assert tuple(c.weight.shape) == (6, 2, 3, 3)
    assert float(c.weight.detach().abs().max()) <= (6.0 / 18) ** 0.5
    assert float(c.bias.abs().max()) == 0.0
    t = tnn.Conv2DTranspose(4, 6, 2, stride=2, device="cpu")
    assert tuple(t.weight.shape) == (4, 6, 2, 2)
    j = jnn.Conv1DTranspose(4, 6, 3)
    p = tnn.Conv1DTranspose(4, 6, 3, device="cpu")
    assert tuple(p.weight.shape) == tuple(j.weight.shape)
    assert tnn.Conv3D(2, 3, (1, 2, 3), bias_attr=False,
                      device="cpu").bias is None


# ------------------------------------------------------------- pooling

POOLS = [
    ("max_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool2d", (2, 3, 9, 8), dict(kernel_size=2, ceil_mode=True)),
    ("max_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2,
                                      padding="SAME")),
    ("max_pool2d", (2, 9, 8, 3), dict(kernel_size=3, stride=2, padding=1,
                                      data_format="NHWC")),
    ("max_pool2d", (2, 3, 8, 8), dict(kernel_size=(2, 1), stride=(2, 1))),
    ("avg_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=1, padding=1)),
    ("avg_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1,
                                      exclusive=False)),
    ("avg_pool2d", (2, 3, 9, 8), dict(kernel_size=2, padding="SAME")),
    ("avg_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=2,
                                      ceil_mode=True)),
    ("avg_pool2d", (2, 3, 9, 8), dict(kernel_size=3, padding=2,
                                      exclusive=False)),
    ("max_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=2)),
    ("avg_pool2d", (2, 9, 8, 3), dict(kernel_size=3, padding=1,
                                      data_format="NHWC")),
    ("max_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool1d", (2, 3, 11), dict(kernel_size=4, stride=2)),
    ("max_pool3d", (1, 2, 5, 6, 4), dict(kernel_size=2, stride=2)),
    ("avg_pool3d", (1, 2, 5, 6, 4), dict(kernel_size=3, padding=1)),
    ("adaptive_avg_pool2d", (2, 3, 9, 8), dict(output_size=(3, 5))),
    ("adaptive_avg_pool2d", (2, 9, 8, 3), dict(output_size=1,
                                               data_format="NHWC")),
    ("adaptive_max_pool2d", (2, 3, 9, 8), dict(output_size=(4, 3))),
    ("adaptive_avg_pool1d", (2, 3, 10), dict(output_size=4)),
    ("adaptive_max_pool1d", (2, 3, 10), dict(output_size=5)),
    ("adaptive_avg_pool3d", (1, 2, 5, 6, 4), dict(output_size=(2, 3, 2))),
    ("adaptive_max_pool3d", (1, 2, 5, 6, 4), dict(output_size=2)),
]


@pytest.mark.parametrize("name,xs,kw", POOLS)
def test_pools(name, xs, kw):
    x = _rand(xs, 4)
    _both(lambda a: getattr(JF, name)(a, **kw),
          lambda a: getattr(TF, name)(a, **kw), [x])


def test_return_mask_is_ignored_as_by_the_reference():
    x = _rand((1, 2, 6, 6))
    want = JF.max_pool2d(JTensor(jnp.asarray(x)), 2, return_mask=True)
    got = TF.max_pool2d(torch.from_numpy(x), 2, return_mask=True)
    assert isinstance(got, torch.Tensor) and not isinstance(want, tuple)
    _close(got.numpy(), want._value)


@pytest.mark.parametrize("layer,kw", [
    ("MaxPool2D", dict(kernel_size=3, stride=2, padding=1)),
    ("AvgPool2D", dict(kernel_size=2, stride=2)),
    ("AdaptiveAvgPool2D", dict(output_size=(2, 3))),
    ("AdaptiveMaxPool2D", dict(output_size=2))])
def test_pool_layers(layer, kw):
    x = _rand((2, 3, 8, 7))
    want = getattr(jnn, layer)(**kw)(JTensor(jnp.asarray(x)))._value
    _close(getattr(tnn, layer)(**kw)(torch.from_numpy(x)).numpy(), want)


# -------------------------------------------------------------- norms

def _bn_pair(c, df="NCHW", cls="BatchNorm2D", **kw):
    j = getattr(jnn, cls)(c, data_format=df, **kw)
    t = getattr(tnn, cls)(c, data_format=df, device="cpu", **kw)
    w, b = _rand((c,), 11), _rand((c,), 12)
    j.weight.set_value(jnp.asarray(w))
    j.bias.set_value(jnp.asarray(b))
    with torch.no_grad():
        t.weight.copy_(torch.from_numpy(w))
        t.bias.copy_(torch.from_numpy(b))
    return j, t


def _buffers_close(j, t, atol=1e-6):
    for name in ("_mean", "_variance"):
        want = np.asarray(getattr(j, name)._value, dtype=np.float32)
        got = getattr(t, name).detach().float().numpy()
        np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("cls,df,xs", [
    ("BatchNorm2D", "NCHW", (4, 3, 5, 6)),
    ("BatchNorm2D", "NHWC", (4, 5, 6, 3)),
    ("BatchNorm1D", "NCL", (6, 3)),
    ("BatchNorm1D", "NCL", (4, 3, 7)),
    ("BatchNorm3D", "NCDHW", (2, 3, 3, 4, 2)),
])
def test_batch_norm_train_eval_and_buffers(cls, df, xs):
    j, t = _bn_pair(3, df, cls)
    for step in range(2):                     # two calls move the buffers
        x = _rand(xs, 20 + step) * 2.0 + 3.0
        want = j(JTensor(jnp.asarray(x)))._value
        got = t(torch.from_numpy(x))
        _close(got.detach().numpy(), want)
    _buffers_close(j, t)
    assert float(t._mean.abs().max()) > 0.5    # the statistics moved
    j.eval()
    t.eval()
    x = _rand(xs, 30)
    _close(t(torch.from_numpy(x)).detach().numpy(),
           j(JTensor(jnp.asarray(x)))._value)
    _buffers_close(j, t)


def test_batch_norm_gradient_through_batch_statistics():
    x = _rand((4, 3, 5, 6), 5) + 1.0
    w, b = _rand((3,), 6), _rand((3,), 7)

    def jbn(a, wt, bs):
        return JF.batch_norm(a, JTensor(jnp.zeros(3)), JTensor(jnp.ones(3)),
                             wt, bs, training=True)

    def tbn(a, wt, bs):
        return TF.batch_norm(a, torch.zeros(3), torch.ones(3), wt, bs,
                             training=True)

    _both(jbn, tbn, [x, w, b], diff=(0, 1, 2))


def test_batch_norm_use_global_stats_and_bf16_buffers():
    j, t = _bn_pair(3, use_global_stats=True)
    x = _rand((4, 3, 5, 6), 8) + 2.0
    _close(t(torch.from_numpy(x)).detach().numpy(),
           j(JTensor(jnp.asarray(x)))._value)
    _buffers_close(j, t)
    assert float(t._mean.abs().max()) == 0.0       # nothing was updated
    j, t = _bn_pair(3)
    j.to(dtype="bfloat16")
    t.to(torch.bfloat16)
    assert t._mean.dtype == torch.bfloat16 and t.weight.dtype == \
        torch.bfloat16
    for step in range(2):
        x = (_rand((4, 3, 5, 6), 40 + step) * 2.0 + 3.0)
        xj = JTensor(jnp.asarray(x).astype(jnp.bfloat16))
        xt = torch.from_numpy(x).to(torch.bfloat16)
        want = np.asarray(j(xj)._value.astype(jnp.float32))
        got = t(xt)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=2 ** -7,
                                   atol=2 ** -7)
    for name in ("_mean", "_variance"):
        want = np.asarray(getattr(j, name)._value.astype(jnp.float32))
        got = getattr(t, name).float().numpy()
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0,
                                   err_msg=name)      # one bf16 ulp


def test_sync_batch_norm_is_a_local_batch_norm():
    net = tnn.Sequential(tnn.Conv2D(3, 4, 1, device="cpu"),
                         tnn.BatchNorm2D(4, device="cpu"))
    net[1]._mean.fill_(0.5)
    conv = tnn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(conv[1], tnn.SyncBatchNorm)
    assert float(conv[1]._mean[0]) == 0.5


@pytest.mark.parametrize("case", ["group", "group_nhwc", "instance", "lrn",
                                  "lrn_nhwc", "normalize", "layer"])
def test_other_norms(case):
    x = _rand((2, 6, 5, 4), 9) * 3.0 + 1.0
    w, b = _rand((6,), 1), _rand((6,), 2)
    if case.startswith("group"):
        df = "NHWC" if case.endswith("nhwc") else "NCHW"
        if df == "NHWC":
            x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
        _both(lambda a, c, d: JF.group_norm(a, 3, 1e-5, c, d, df),
              lambda a, c, d: TF.group_norm(a, 3, 1e-5, c, d, df),
              [x, w, b], diff=(0, 1, 2))
    elif case == "instance":
        _both(lambda a, c, d: JF.instance_norm(a, weight=c, bias=d),
              lambda a, c, d: TF.instance_norm(a, weight=c, bias=d),
              [x, w, b], diff=(0, 1, 2))
    elif case.startswith("lrn"):
        df = "NHWC" if case.endswith("nhwc") else "NCHW"
        _both(lambda a: JF.local_response_norm(a, 3, data_format=df),
              lambda a: TF.local_response_norm(a, 3, data_format=df), [x])
    elif case == "normalize":
        _both(lambda a: JF.normalize(a, p=2, axis=1),
              lambda a: TF.normalize(a, p=2, axis=1), [x])
    else:
        _both(lambda a: JF.layer_norm(a, [5, 4]),
              lambda a: TF.layer_norm(a, [5, 4]), [x])


def test_norm_layers():
    x = _rand((2, 6, 5, 4), 3)
    for jl, tl in ((jnn.GroupNorm(3, 6), tnn.GroupNorm(3, 6, device="cpu")),
                   (jnn.InstanceNorm2D(6), tnn.InstanceNorm2D(6,
                                                              device="cpu")),
                   (jnn.LocalResponseNorm(3), tnn.LocalResponseNorm(3))):
        _close(tl(torch.from_numpy(x)).detach().numpy(),
               jl(JTensor(jnp.asarray(x)))._value)


def test_spectral_norm():
    jsn = jnn.SpectralNorm((6, 4, 3, 3), dim=0, power_iters=2)
    tsn = tnn.SpectralNorm((6, 4, 3, 3), dim=0, power_iters=2, device="cpu")
    assert not tsn.weight_u.requires_grad
    with torch.no_grad():
        tsn.weight_u.copy_(torch.from_numpy(np.asarray(jsn.weight_u._value)))
        tsn.weight_v.copy_(torch.from_numpy(np.asarray(jsn.weight_v._value)))
    w = _rand((6, 4, 3, 3), 5)
    _both(lambda a: jsn(a), lambda a: tsn(a), [w])


# -------------------------------------------------------- interpolate

INTERP = [
    ((2, 3, 4, 6), dict(scale_factor=2, mode="nearest")),
    ((2, 3, 4, 6), dict(size=(7, 5), mode="nearest")),
    ((2, 4, 6, 3), dict(size=(9, 4), mode="nearest", data_format="NHWC")),
    ((2, 3, 4, 6), dict(scale_factor=2, mode="bilinear")),
    ((2, 3, 8, 9), dict(size=(3, 4), mode="bilinear")),
    ((2, 3, 5, 6), dict(size=(7, 4), mode="bilinear", align_corners=True)),
    ((2, 5, 6, 3), dict(size=(8, 3), mode="bilinear", data_format="NHWC")),
    ((2, 3, 4, 6), dict(size=(6, 9), mode="bicubic")),
    ((2, 3, 7), dict(size=12, mode="linear", data_format="NCW")),
    ((2, 3, 7), dict(size=5, mode="nearest", data_format="NCW")),
    ((1, 2, 3, 4, 5), dict(size=(5, 3, 7), mode="trilinear",
                           data_format="NCDHW")),
]


@pytest.mark.parametrize("xs,kw", INTERP)
def test_interpolate_modes(xs, kw):
    x = _rand(xs, 6)
    _both(lambda a: JF.interpolate(a, **kw),
          lambda a: TF.interpolate(a, **kw), [x])


def test_upsample_layers():
    x = _rand((1, 2, 3, 4))
    for j, t in ((jnn.Upsample(scale_factor=2), tnn.Upsample(scale_factor=2)),
                 (jnn.UpsamplingBilinear2D(size=(5, 7)),
                  tnn.UpsamplingBilinear2D(size=(5, 7))),
                 (jnn.UpsamplingNearest2D(scale_factor=3),
                  tnn.UpsamplingNearest2D(scale_factor=3))):
        _close(t(torch.from_numpy(x)).numpy(),
               j(JTensor(jnp.asarray(x)))._value)


# -------------------------------------------------------- activations

ACTS = [("relu", {}), ("relu6", {}), ("elu", dict(alpha=0.7)), ("selu", {}),
        ("celu", dict(alpha=1.3)), ("gelu", {}),
        ("gelu", dict(approximate=True)), ("silu", {}), ("swish", {}),
        ("sigmoid", {}), ("hardsigmoid", {}),
        ("hardsigmoid", dict(slope=0.2, offset=0.4)), ("hardswish", {}),
        ("hardtanh", dict(min=-0.5, max=0.7)), ("hardshrink", {}),
        ("softshrink", dict(threshold=0.3)), ("tanhshrink", {}),
        ("leaky_relu", dict(negative_slope=0.2)), ("log_sigmoid", {}),
        ("maxout", dict(groups=2)), ("softplus", dict(beta=2.0)),
        ("softsign", {}), ("tanh", {}), ("mish", {}),
        ("softmax", dict(axis=1)), ("log_softmax", {}), ("glu", {}),
        ("thresholded_relu", dict(threshold=0.2)),
        ("rrelu", dict(training=False))]


@pytest.mark.parametrize("name,kw", ACTS)
def test_activations(name, kw):
    x = _rand((2, 4, 3, 6), 13) * 3.0
    _both(lambda a: getattr(JF, name)(a, **kw),
          lambda a: getattr(TF, name)(a, **kw), [x])


def test_hardsigmoid_keeps_the_reference_constants():
    x = torch.tensor([-3.0, 0.0, 3.0, 2.9])
    want = torch.clamp(0.1666667 * x + 0.5, 0.0, 1.0)
    assert torch.equal(TF.hardsigmoid(x), want)
    assert not torch.equal(want, torch.nn.functional.hardsigmoid(x))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_prelu(fmt):
    x = _rand((2, 3, 4, 5) if fmt == "NCHW" else (2, 4, 5, 3), 2)
    w = np.array([0.1, 0.2, 0.3], np.float32)
    _both(lambda a, c: JF.prelu(a, c, fmt), lambda a, c: TF.prelu(a, c, fmt),
          [x, w], diff=(0, 1))
    layer = tnn.PReLU(3, init=0.25, data_format=fmt, device="cpu")
    assert torch.equal(layer.weight, torch.full((3,), 0.25))


def test_activation_layers():
    x = _rand((2, 6), 4) * 4
    for name, kw in (("ReLU", {}), ("Hardswish", {}), ("Hardsigmoid", {}),
                     ("LeakyReLU", dict(negative_slope=0.1)),
                     ("Softmax", dict(axis=0)), ("GELU", {}),
                     ("Softplus", {}), ("ELU", {}), ("Swish", {}),
                     ("ThresholdedReLU", {}), ("Maxout", dict(groups=3))):
        want = getattr(jnn, name)(**kw)(JTensor(jnp.asarray(x)))._value
        got = getattr(tnn, name)(**kw)(torch.from_numpy(x))
        _close(got.numpy(), want, what=name)


def test_rrelu_and_gumbel_draw_the_reference_noise():
    x = _rand((3, 5), 1)
    paddle.seed(5)
    import paddle_tpu_torch as ptt
    ptt.seed(5)
    _close(TF.rrelu(torch.from_numpy(x), training=True).numpy(),
           JF.rrelu(JTensor(jnp.asarray(x)), training=True)._value)
    assert TF.gumbel_softmax(torch.from_numpy(x)).shape == (3, 5)


# --------------------------------------------------------- containers

def test_containers_name_children_as_the_reference():
    def names(m):
        return [n for n, _ in m.named_parameters()]

    for build in (lambda nn, **f: nn.Sequential(
                      nn.Conv2D(3, 4, 1, **f), nn.ReLU(), nn.Linear(4, 2, **f)),
                  lambda nn, **f: nn.Sequential(
                      ("conv", nn.Conv2D(3, 4, 1, **f)), ("act", nn.ReLU())),
                  lambda nn, **f: nn.Sequential(OrderedDict(
                      [("a", nn.Conv2D(3, 4, 1, **f))])),
                  lambda nn, **f: nn.LayerList(
                      [nn.Conv2D(3, 4, 1, **f), nn.Conv2D(4, 4, 1, **f)]),
                  lambda nn, **f: nn.LayerDict(
                      {"x": nn.Conv2D(3, 4, 1, **f)})):
        assert names(build(tnn, device="cpu")) == names(build(jnn))
    seq = tnn.Sequential(tnn.ReLU(), tnn.Tanh(), tnn.Sigmoid())
    assert isinstance(seq[1:], tnn.Sequential) and len(seq[1:]) == 2
    ll = tnn.LayerList([tnn.ReLU()])
    ll.append(tnn.Tanh())
    ll.insert(0, tnn.Sigmoid())
    assert [type(m).__name__ for m in ll] == ["Sigmoid", "ReLU", "Tanh"]
    pl = tnn.ParameterList([torch.nn.Parameter(torch.ones(2))])
    assert len(pl) == 1 and [n for n, _ in pl.named_parameters()] == ["0"]
    x = torch.randn(2, 3)
    assert torch.equal(seq(x), torch.sigmoid(torch.tanh(torch.relu(x))))


# --------------------------------------------------------- common ops

@pytest.mark.parametrize("mode,pad,df", [
    ("constant", [1, 2, 0, 3], "NCHW"), ("reflect", [2, 1, 1, 2], "NCHW"),
    ("replicate", [1, 2, 3, 0], "NCHW"), ("circular", [2, 2, 1, 0], "NCHW"),
    ("constant", [1, 2, 0, 3], "NHWC"),
    ("constant", [0, 0, 1, 0, 2, 1, 0, 1], "NCHW")])
def test_pad(mode, pad, df):
    x = _rand((2, 3, 5, 6), 3)
    _both(lambda a: JF.pad(a, pad, mode=mode, value=0.5, data_format=df),
          lambda a: TF.pad(a, pad, mode=mode, value=0.5, data_format=df),
          [x])


@pytest.mark.parametrize("case", [
    "pixel_shuffle", "pixel_shuffle_nhwc", "pixel_unshuffle",
    "pixel_unshuffle_nhwc", "channel_shuffle", "channel_shuffle_nhwc",
    "unfold", "fold", "cosine_similarity", "label_smooth", "flatten",
    "zeropad2d"])
def test_common_ops(case):
    df = "NHWC" if case.endswith("nhwc") else "NCHW"
    op = case.replace("_nhwc", "")
    if op == "pixel_shuffle":
        x = _rand((2, 8, 3, 4) if df == "NCHW" else (2, 3, 4, 8))
        _both(lambda a: JF.pixel_shuffle(a, 2, df),
              lambda a: TF.pixel_shuffle(a, 2, df), [x])
    elif op == "pixel_unshuffle":
        x = _rand((2, 2, 4, 6) if df == "NCHW" else (2, 4, 6, 2))
        _both(lambda a: JF.pixel_unshuffle(a, 2, df),
              lambda a: TF.pixel_unshuffle(a, 2, df), [x])
    elif op == "channel_shuffle":
        x = _rand((2, 6, 3, 4) if df == "NCHW" else (2, 3, 4, 6))
        _both(lambda a: JF.channel_shuffle(a, 3, df),
              lambda a: TF.channel_shuffle(a, 3, df), [x])
    elif op == "unfold":
        x = _rand((2, 3, 7, 6))
        _both(lambda a: JF.unfold(a, [3, 2], [2, 1], [1, 0, 2, 1], [1, 2]),
              lambda a: TF.unfold(a, [3, 2], [2, 1], [1, 0, 2, 1], [1, 2]),
              [x])
    elif op == "fold":
        x = _rand((2, 12, 20))
        _both(lambda a: JF.fold(a, [5, 6], 2, 1, [0, 0], 1),
              lambda a: TF.fold(a, [5, 6], 2, 1, [0, 0], 1), [x])
    elif op == "cosine_similarity":
        _both(lambda a, b: JF.cosine_similarity(a, b, axis=1),
              lambda a, b: TF.cosine_similarity(a, b, axis=1),
              [_rand((3, 5), 1), _rand((3, 5), 2)], diff=(0, 1))
    elif op == "label_smooth":
        _both(lambda a: JF.label_smooth(a, epsilon=0.2),
              lambda a: TF.label_smooth(a, epsilon=0.2),
              [np.eye(4, dtype=np.float32)[[0, 2, 3]]])
    elif op == "flatten":
        x = _rand((2, 3, 4, 5))
        want = jnn.Flatten(1, 2)(JTensor(jnp.asarray(x)))._value
        _close(tnn.Flatten(1, 2)(torch.from_numpy(x)).numpy(), want)
    else:
        x = _rand((2, 3, 4, 5))
        _both(lambda a: JF.zeropad2d(a, [1, 0, 2, 1]),
              lambda a: TF.zeropad2d(a, [1, 0, 2, 1]), [x])


def test_bilinear_and_embedding_layers():
    x1, x2 = _rand((4, 3), 1), _rand((4, 5), 2)
    w, b = _rand((2, 3, 5), 3), _rand((1, 2), 4)
    _both(JF.bilinear, TF.bilinear, [x1, x2, w, b], diff=(0, 1, 2, 3))
    emb = tnn.Embedding(6, 3, padding_idx=2, device="cpu")
    assert float(emb.weight[2].abs().max()) == 0.0
    with torch.no_grad():
        emb.weight.fill_(1.0)
    out = emb(torch.tensor([[2, 1]]))
    assert torch.equal(out[0, 0], torch.zeros(3))
    assert torch.equal(out[0, 1], torch.ones(3))
    jb = jnn.Bilinear(3, 5, 2)
    tb = tnn.Bilinear(3, 5, 2, device="cpu")
    assert tuple(tb.weight.shape) == tuple(jb.weight.shape)
    assert tuple(tb.bias.shape) == tuple(jb.bias.shape)


def test_grid_ops():
    theta = _rand((2, 2, 3), 1) * 0.3 + np.array([[1, 0, 0], [0, 1, 0]],
                                                 np.float32)
    for ac in (True, False):
        _both(lambda t: JF.affine_grid(t, [2, 3, 4, 5], align_corners=ac),
              lambda t: TF.affine_grid(t, [2, 3, 4, 5], align_corners=ac),
              [theta])
    x = _rand((2, 3, 6, 7), 2)
    grid = np.clip(_rand((2, 4, 5, 2), 3) * 0.7, -1.2, 1.2)
    for mode in ("bilinear", "nearest"):
        for pm in ("zeros", "border"):
            _both(lambda a, g: JF.grid_sample(a, g, mode, pm),
                  lambda a, g: TF.grid_sample(a, g, mode, pm), [x, grid],
                  diff=(0,) if mode == "nearest" else (0, 1))


# -------------------------------------------------------------- losses

def _p(shape, seed):
    return 1 / (1 + np.exp(-_rand(shape, seed)))


LOSSES = [
    ("mse_loss", lambda: [_rand((4, 3), 1), _rand((4, 3), 2)], {}),
    ("l1_loss", lambda: [_rand((4, 3), 1), _rand((4, 3), 2)],
     dict(reduction="sum")),
    ("smooth_l1_loss", lambda: [_rand((4, 3), 1) * 2, _rand((4, 3), 2)],
     dict(delta=0.7)),
    ("binary_cross_entropy", lambda: [_p((4, 3), 1),
                                      (_p((4, 3), 2) > 0.5)
                                      .astype(np.float32)], {}),
    ("binary_cross_entropy_with_logits",
     lambda: [_rand((4, 3), 1) * 3, _p((4, 3), 2)], {}),
    ("binary_cross_entropy_with_logits",
     lambda: [_rand((4, 3), 1) * 3, _p((4, 3), 2), np.ones((4, 3),
                                                           np.float32),
              "none", np.float32([1.0, 2.0, 0.5])], {}),
    ("kl_div", lambda: [np.log(_p((4, 3), 1)), _p((4, 3), 2)],
     dict(reduction="batchmean")),
    ("kl_div", lambda: [np.log(_p((4, 3), 1)), np.log(_p((4, 3), 2))],
     dict(log_target=True)),
    ("margin_ranking_loss", lambda: [_rand((5,), 1), _rand((5,), 2),
                                     np.sign(_rand((5,), 3))],
     dict(margin=0.2)),
    ("hinge_embedding_loss", lambda: [_rand((5,), 1),
                                      np.sign(_rand((5,), 3))], {}),
    ("cosine_embedding_loss", lambda: [_rand((5, 4), 1), _rand((5, 4), 2),
                                       np.sign(_rand((5,), 3))],
     dict(margin=0.1)),
    ("triplet_margin_loss", lambda: [_rand((5, 4), 1), _rand((5, 4), 2),
                                     _rand((5, 4), 3)], dict(swap=True)),
    ("log_loss", lambda: [_p((4, 1), 1), (_p((4, 1), 2) > 0.5)
                          .astype(np.float32)], {}),
    ("square_error_cost", lambda: [_rand((4, 3), 1), _rand((4, 3), 2)], {}),
    ("sigmoid_focal_loss", lambda: [_rand((4, 3), 1) * 2,
                                    (_p((4, 3), 2) > 0.5).astype(np.float32),
                                    np.float32([2.0])], {}),
    ("dice_loss", lambda: [_p((3, 4, 5), 1),
                           np.random.default_rng(2).integers(
                               0, 5, (3, 4, 1))], {}),
    ("poisson_nll_loss", lambda: [_rand((4, 3), 1), np.abs(_rand((4, 3), 2))
                                  * 3], dict(full=True)),
    ("poisson_nll_loss", lambda: [_p((4, 3), 1) + 0.5,
                                  np.abs(_rand((4, 3), 2))],
     dict(log_input=False)),
    ("multi_label_soft_margin_loss",
     lambda: [_rand((4, 3), 1), (_p((4, 3), 2) > 0.5).astype(np.float32)],
     {}),
    ("soft_margin_loss", lambda: [_rand((4, 3), 1),
                                  np.sign(_rand((4, 3), 2))], {}),
]


@pytest.mark.parametrize("i", range(len(LOSSES)))
def test_losses(i):
    name, make, kw = LOSSES[i]
    args = make()
    keep = [k for k, a in enumerate(args) if not isinstance(a, str)]

    def call(fn, tensors):
        full, it = [], iter(tensors)
        for a in args:
            full.append(a if isinstance(a, str) else next(it))
        return fn(*full, **kw)

    _both(lambda *t: call(getattr(JF, name), t),
          lambda *t: call(getattr(TF, name), t), [args[k] for k in keep])


def test_loss_layers():
    x, y = _rand((4, 3), 1), _rand((4, 3), 2)
    for jl, tl in ((jnn.MSELoss(), tnn.MSELoss()),
                   (jnn.L1Loss("sum"), tnn.L1Loss("sum")),
                   (jnn.SmoothL1Loss(), tnn.SmoothL1Loss()),
                   (jnn.SoftMarginLoss(), tnn.SoftMarginLoss())):
        _close(tl(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
               jl(JTensor(jnp.asarray(x)), JTensor(jnp.asarray(y)))._value)
    labels = np.array([0, 2, 1, 2], np.int64)
    _close(tnn.CrossEntropyLoss()(torch.from_numpy(x),
                                  torch.from_numpy(labels)).numpy(),
           jnn.CrossEntropyLoss()(JTensor(jnp.asarray(x)),
                                  JTensor(jnp.asarray(labels)))._value)


def _ctc_inputs(t=12, b=3, c=6, lens=(4, 2, 3), in_lens=(12, 9, 12),
                seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, b, c)).astype(np.float32)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels = rng.integers(1, c, (b, max(lens))).astype(np.int64)
    labels[1, :2] = 3                    # a repeated label needs a blank
    return (lp.astype(np.float32), labels, np.array(in_lens, np.int64),
            np.array(lens, np.int64))


@pytest.mark.parametrize("case", ["mean", "sum", "none", "norm_by_times",
                                  "too_long", "blank_last"])
def test_ctc_loss_and_gradient(case):
    kw = dict(reduction="none" if case == "too_long" else
              ("mean" if case in ("norm_by_times", "blank_last") else case))
    if case == "norm_by_times":
        kw["norm_by_times"] = True
    if case == "too_long":
        # a label of 6 needs at least 6 steps (7 with the repeat): 4 given
        lp, labels, il, ll = _ctc_inputs(lens=(6, 2, 3), in_lens=(4, 9, 12))
        labels[0] = [1, 2, 2, 3, 4, 5]
    else:
        lp, labels, il, ll = _ctc_inputs()
    if case == "blank_last":
        kw["blank"] = 5
        labels = np.where(labels == 5, 1, labels)
    got = _both(lambda a, b, c, d: JF.ctc_loss(a, b, c, d, **kw),
                lambda a, b, c, d: TF.ctc_loss(a, b, c, d, **kw),
                [lp, labels, il, ll])
    if case == "too_long":
        assert float(got[0]) > 1e29          # finite, not inf
        assert np.isfinite(got.detach().numpy()).all()


def test_ctc_loss_layer_and_torch_op_differ_where_a_label_cannot_fit():
    lp, labels, il, ll = _ctc_inputs(lens=(6, 2, 3), in_lens=(4, 9, 12))
    ours = tnn.CTCLoss(reduction="none")(torch.from_numpy(lp),
                                         torch.from_numpy(labels),
                                         torch.from_numpy(il),
                                         torch.from_numpy(ll))
    theirs = torch.nn.functional.ctc_loss(
        torch.from_numpy(lp), torch.from_numpy(labels), torch.from_numpy(il),
        torch.from_numpy(ll), reduction="none")
    assert np.isinf(float(theirs[0])) and np.isfinite(float(ours[0]))
    np.testing.assert_allclose(ours[1:].numpy(), theirs[1:].numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_rnnt_loss(reduction):
    rng = np.random.default_rng(3)
    acts = rng.standard_normal((2, 5, 4, 6)).astype(np.float32)
    label = rng.integers(1, 6, (2, 3)).astype(np.int64)
    il, ll = np.array([5, 4], np.int64), np.array([3, 2], np.int64)
    _both(lambda a, b, c, d: JF.rnnt_loss(a, b, c, d, reduction=reduction),
          lambda a, b, c, d: TF.rnnt_loss(a, b, c, d, reduction=reduction),
          [acts, label, il, ll])


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_functional(weighted, dtype):
    """``F.rms_norm(x, weight=None, epsilon)``: with a weight it is
    ``ops.rms_norm`` (its plain version here), without one the
    reference's float32 formula; float32 values and input gradients
    within 1e-5 of the largest entry, bf16 values within one bf16 ulp
    of the reference's (both round the same float32 result once)."""
    x = _rand((3, 5, 128), 31)
    w = (1.0 + 0.1 * _rand((128,), 32)).astype(np.float32)
    inputs = [x, w] if weighted else [x]
    if dtype == "float32":
        _both(lambda a, *r: JF.rms_norm(a, *r, epsilon=1e-5),
              lambda a, *r: TF.rms_norm(a, *r, epsilon=1e-5), inputs,
              diff=tuple(range(len(inputs))))
        return
    want = JF.rms_norm(JTensor(jnp.asarray(x, jnp.bfloat16)),
                       *[JTensor(jnp.asarray(w, jnp.bfloat16))][:len(
                           inputs) - 1], epsilon=1e-5)._value
    got = TF.rms_norm(torch.tensor(x).to(torch.bfloat16),
                      *[torch.tensor(w).to(torch.bfloat16)][:len(
                          inputs) - 1], epsilon=1e-5)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32), np.float64)
    got = got.float().numpy().astype(np.float64)
    ulp = np.abs(want) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(got - want) <= ulp)


def test_rms_norm_amp_names():
    """Under O2 the weighted form casts as the reference's kernel route
    (``rms_norm_pallas``: not on the black list, so bf16) and the
    unweighted form as ``rms_norm`` (black list: float32)."""
    import importlib
    from paddle_tpu_torch import amp as tamp
    tcast = importlib.import_module("paddle_tpu_torch.amp.auto_cast")
    x = torch.randn(2, 16)
    w = torch.ones(16)
    with tcast._trace_ops() as got, tamp.auto_cast(level="O2"):
        a = TF.rms_norm(x, w)
        b = TF.rms_norm(x)
    assert got == [("rms_norm_pallas", (torch.bfloat16, torch.bfloat16)),
                   ("rms_norm", (torch.float32,))]
    assert a.dtype == torch.bfloat16 and b.dtype == torch.float32
