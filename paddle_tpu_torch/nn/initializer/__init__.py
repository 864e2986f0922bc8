"""Initializers: port of ``paddle_tpu/nn/initializer/__init__.py``.

Each initializer is called as ``init(shape, dtype)`` and returns a
tensor on torch's default device (``Layer.create_parameter`` runs it
under the parameter's device, or the CPU under ``LazyGuard``).  Random
ones take one key from the port's generator (``core.generator``) per
call, seed a ``torch.Generator`` on that device with it (on the host,
one for each piece of 2^24 elements, filled in parallel: ``_draw``) and
draw in float32 before the cast to ``dtype``, as the reference draws in
float32.
The draws follow the reference's laws, not its threefry bits (README,
"Known differences of the ``nn`` API"); ``calculate_gain``, the fans,
``Constant``, ``Assign`` and ``Dirac`` are exact.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ...core import generator as _generator
from ...device import to_dtype

__all__ = [
    "Constant", "Normal", "TruncatedNormal", "Uniform", "XavierNormal",
    "XavierUniform", "KaimingNormal", "KaimingUniform", "Assign", "Orthogonal",
    "Dirac", "calculate_gain", "set_global_initializer",
]


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "selu": 3.0 / 4.0,
    }
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    return gains.get(nonlinearity, 1.0)


def _fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # linear weight [in, out] (the reference's convention)
        return shape[0], shape[1]
    # conv weight [out, in/groups, *k]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


# elements a host generator fills: a host tensor larger than this is
# drawn in such pieces, each from its own generator, on the host's cores
_HOST_PIECE = 1 << 24


def _draw(shape, fill) -> torch.Tensor:
    """A float32 tensor of ``shape`` on the default device, filled by
    ``fill(tensor, generator)`` from one key of the port's generator.  On
    the card one generator fills it; on the host (a torch generator fills
    serially) a tensor of more than ``_HOST_PIECE`` elements is filled in
    pieces of that size, piece ``i`` from the key folded with ``i``, in a
    thread pool: the values depend on the key alone, not on the threads."""
    key = _generator.draw().mix
    dev = torch.get_default_device()
    out = torch.empty(tuple(shape), dtype=torch.float32)
    flat = out.view(-1)
    if dev.type != "cpu" or flat.numel() <= _HOST_PIECE:
        gen = torch.Generator(device=dev)
        gen.manual_seed(key)
        fill(flat, gen)
        return out
    pieces = flat.split(_HOST_PIECE)

    def one(i):
        gen = torch.Generator()
        gen.manual_seed(_generator.fold_in(key, i))
        fill(pieces[i], gen)

    with ThreadPoolExecutor(max_workers=torch.get_num_threads()) as pool:
        list(pool.map(one, range(len(pieces))))
    return out


def _normal(shape) -> torch.Tensor:
    return _draw(shape, lambda t, g: t.normal_(generator=g))


def _uniform(shape, low, high) -> torch.Tensor:
    return _draw(shape, lambda t, g: t.uniform_(low, high, generator=g))


class Initializer:
    def __call__(self, shape, dtype):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(tuple(shape), self.value, dtype=to_dtype(dtype))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        return _normal(shape).mul_(self.std).add_(self.mean).to(
            to_dtype(dtype))


class TruncatedNormal(Initializer):
    """``jax.random.truncated_normal``'s method: a uniform draw between
    the normal CDF at ``a`` and at ``b``, mapped back through the
    inverse CDF and clipped into ``(a, b)``."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype):
        lo = math.erf(self.a / math.sqrt(2.0))
        hi = math.erf(self.b / math.sqrt(2.0))
        raw = math.sqrt(2.0) * torch.erfinv(_uniform(shape, lo, hi))
        f32 = np.float32
        raw = raw.clamp(float(np.nextafter(f32(self.a), f32(np.inf))),
                        float(np.nextafter(f32(self.b), f32(-np.inf))))
        return (self.mean + self.std * raw).to(to_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        return _uniform(shape, self.low, self.high).to(to_dtype(dtype))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return (std * _normal(shape)).to(to_dtype(dtype))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, -limit, limit).to(to_dtype(dtype))


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        std = gain / math.sqrt(fi)
        return (std * _normal(shape)).to(to_dtype(dtype))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(shape, -limit, limit).to(to_dtype(dtype))


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype):
        v = self.value
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        return v.to(device=torch.get_default_device(),
                    dtype=to_dtype(dtype)).reshape(tuple(shape))


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype):
        rows = shape[0]
        cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        flat = _normal((max(rows, cols), min(rows, cols)))
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols].reshape(tuple(shape))).to(
            to_dtype(dtype))


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype):
        out = np.zeros(shape, dtype=np.float32)
        oc, ic = shape[0], shape[1]
        mins = min(oc // self.groups, ic)
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(mins):
                idx = (g * (oc // self.groups) + i, i) + tuple(centers)
                out[idx] = 1.0
        return torch.from_numpy(out).to(device=torch.get_default_device(),
                                        dtype=to_dtype(dtype))


# Stored and read by nothing, as in the reference: its
# ``Layer.create_parameter`` does not consult them (ROADMAP Queue 3).
_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init
