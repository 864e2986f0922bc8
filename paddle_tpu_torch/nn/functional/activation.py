"""Activations: port of ``paddle_tpu/nn/functional/activation.py``.

Each op is the JAX package's formula in torch ops on x's dtype (the
constants are Python scalars, JAX's weak types), its inputs cast by the
AMP rule under the reference's op name.  Trouble spot: ``hardsigmoid``
is Paddle's ``clip(0.1666667 x + 0.5, 0, 1)``, not torch's ``x/6 +
1/2`` (MobileNetV3's squeeze-excite and the DB head's maps read it).
``rrelu`` and ``gumbel_softmax`` draw their noise from the key generator
with the threefry bits of ``jax.random`` (``inference.threefry``), so a
float32 draw equals the JAX package's for the same seed and draw count.
"""

from __future__ import annotations

import torch

from ...amp.auto_cast import cast as _amp_cast
from ...core import generator as _generator

__all__ = [
    "relu_", "relu6", "elu", "selu", "celu", "silu", "swish", "sigmoid",
    "hardsigmoid", "hardswish", "hardtanh", "hardshrink", "softshrink",
    "tanhshrink", "leaky_relu", "prelu", "rrelu", "log_sigmoid", "maxout",
    "softplus", "softsign", "mish", "softmax", "softmax_", "log_softmax",
    "gumbel_softmax", "glu", "thresholded_relu",
]


def _one(name, x):
    (x,) = _amp_cast(name, x)
    return x


def relu_(x, name=None):
    with torch.no_grad():
        x.copy_(torch.relu(_one("relu", x)))
    return x


def relu6(x, name=None):
    return torch.clamp(_one("relu6", x), 0.0, 6.0)


def elu(x, alpha=1.0, name=None):
    x = _one("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    x = _one("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    x = _one("celu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


def silu(x, name=None):
    x = _one("silu", x)
    return x * torch.sigmoid(x)


def swish(x, name=None):
    return silu(x)


def sigmoid(x, name=None):
    return torch.sigmoid(_one("sigmoid", x))


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    x = _one("hardsigmoid", x)
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    x = _one("hardswish", x)
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(_one("hardtanh", x), min, max)


def hardshrink(x, threshold=0.5, name=None):
    x = _one("hardshrink", x)
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    x = _one("softshrink", x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold,
                                   torch.zeros_like(x)))


def tanhshrink(x, name=None):
    x = _one("tanhshrink", x)
    return x - torch.tanh(x)


def leaky_relu(x, negative_slope=0.01, name=None):
    x = _one("leaky_relu", x)
    return torch.where(x >= 0, x, negative_slope * x)


def prelu(x, weight, data_format="NCHW", name=None):
    x, weight = _amp_cast("prelu", x, weight)
    if weight.numel() == 1:
        w = weight.reshape(())
    elif data_format == "NCHW":
        w = weight.reshape((1, -1) + (1,) * (x.ndim - 2))
    else:
        w = weight.reshape((1,) * (x.ndim - 1) + (-1,))
    return torch.where(x > 0, x, w * x)


def _uniform(shape, device, lo, hi):
    """``jax.random.uniform(key, shape, float32, lo, hi)`` of the next
    key: ``max(lo, u * (hi - lo) + lo)``."""
    from ...inference import threefry
    k = _generator.draw()
    keys = torch.tensor(k.tf, dtype=torch.int64, device=device)
    u = threefry.uniform(keys, tuple(shape))
    return torch.clamp_min(u * (hi - lo) + lo, lo)


def rrelu(x, lower=0.125, upper=0.3333333, training=True, name=None):
    """Randomized leaky ReLU: in training the negative slope of each
    element is uniform in [lower, upper) (float32 draws); otherwise their
    mean."""
    if training:
        r = _uniform(x.shape, x.device, lower, upper)
        x = _one("rrelu", x)
        return torch.where(x >= 0, x, r.to(x.dtype) * x)
    x = _one("rrelu", x)
    return torch.where(x >= 0, x, (lower + upper) / 2.0 * x)


def log_sigmoid(x, name=None):
    return torch.nn.functional.logsigmoid(_one("log_sigmoid", x))


def maxout(x, groups, axis=1, name=None):
    x = _one("maxout", x)
    ax = axis % x.ndim
    c = x.shape[ax]
    shape = x.shape[:ax] + (groups, c // groups) + x.shape[ax + 1:]
    return torch.amax(x.reshape(shape), dim=ax)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    x = _one("softplus", x)
    return torch.where(beta * x > threshold, x,
                       torch.log1p(torch.exp(beta * x)) / beta)


def softsign(x, name=None):
    x = _one("softsign", x)
    return x / (1 + x.abs())


def mish(x, name=None):
    x = _one("mish", x)
    return x * torch.tanh(torch.nn.functional.softplus(x))


def _with_dtype(x, dtype):
    if dtype is None:
        return x
    from ...device import to_dtype
    return x.to(to_dtype(dtype))


def softmax(x, axis=-1, dtype=None, name=None):
    return torch.softmax(_with_dtype(_one("softmax", x), dtype), dim=axis)


def softmax_(x, axis=-1, dtype=None, name=None):
    with torch.no_grad():
        x.copy_(softmax(x, axis, dtype))
    return x


def log_softmax(x, axis=-1, dtype=None, name=None):
    return torch.log_softmax(_with_dtype(_one("log_softmax", x), dtype),
                             dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """Softmax of ``(x + g) / temperature`` with Gumbel noise ``g`` of the
    next key; ``hard`` returns the one-hot argmax with the soft
    gradient (straight through)."""
    from ...inference import threefry
    k = _generator.draw()
    x = _one("gumbel_softmax", x)
    keys = torch.tensor(k.tf, dtype=torch.int64, device=x.device)
    g = threefry.gumbel(keys, tuple(x.shape)).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = (y_hard - y).detach() + y
    return y


def glu(x, axis=-1, name=None):
    x = _one("glu", x)
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    x = _one("thresholded_relu", x)
    return torch.where(x > threshold, x, torch.full_like(x, value))
