"""Math ops: port of ``paddle_tpu/tensor/math.py``.

Every op goes through ``core.dispatch`` (AMP under the reference's op
name, spans, per-use hooks) with torch math underneath; results carry
the reference's dtypes (``_helpers.result_type``; integer sums int32,
``mean`` of integers float32).
"""

from __future__ import annotations

import torch

from ..core.dispatch import dispatch
from ._helpers import (asarray, binop, dims, is_scalar, normalize_axis,
                       unop)

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "mod", "remainder",
    "pow", "matmul", "maximum", "minimum", "fmax", "fmin", "exp", "expm1",
    "log", "log2", "log10", "log1p", "sqrt", "rsqrt", "square", "abs", "sign",
    "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh",
    "asinh", "acosh", "atanh", "tanh", "floor", "ceil", "round", "trunc",
    "frac", "reciprocal", "clip", "sum", "nansum", "mean", "nanmean", "max",
    "min", "amax", "amin", "prod", "logsumexp", "cumsum", "cumprod", "cummax",
    "cummin", "isfinite", "isnan", "isinf", "erf", "erfinv", "lerp", "addmm",
    "inner", "outer", "scale", "stanh", "neg", "increment", "kron", "diff",
    "trace", "deg2rad", "rad2deg", "gcd", "lcm", "heaviside", "rsqrt",
    "multiplex", "logit", "digamma", "lgamma", "nan_to_num", "angle",
    "conj", "real", "imag", "sgn", "count_nonzero", "add_n", "hypot",
    "log_normal", "ldexp", "logaddexp", "floor_mod", "inverse",
]


def add(x, y, name=None):
    return binop("add", torch.add, x, y)


def subtract(x, y, name=None):
    return binop("subtract", torch.sub, x, y)


def multiply(x, y, name=None):
    return binop("multiply", torch.mul, x, y)


def divide(x, y, name=None):
    return binop("divide", torch.true_divide, x, y)


def _floor_divide(a, b):
    # the reference's floor division rounds, so no gradient flows
    return torch.floor_divide(*(v.detach() if isinstance(
        v, torch.Tensor) else v for v in (a, b)))


def floor_divide(x, y, name=None):
    return binop("floor_divide", _floor_divide, x, y)


def mod(x, y, name=None):
    return binop("mod", torch.remainder, x, y)


remainder = mod
floor_mod = mod


def pow(x, y, name=None):
    return binop("pow", torch.pow, x, y)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def impl(a, b):
        if transpose_x and a.ndim > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.ndim > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return dispatch("matmul", impl, asarray(x), asarray(y), promote=0)


def maximum(x, y, name=None):
    return binop("maximum", torch.maximum, x, y, scalars=False)


def minimum(x, y, name=None):
    return binop("minimum", torch.minimum, x, y, scalars=False)


def fmax(x, y, name=None):
    return binop("fmax", torch.fmax, x, y, scalars=False)


def fmin(x, y, name=None):
    return binop("fmin", torch.fmin, x, y, scalars=False)


def hypot(x, y, name=None):
    return binop("hypot", torch.hypot, x, y, scalars=False)


def logaddexp(x, y, name=None):
    return binop("logaddexp", torch.logaddexp, x, y, scalars=False)


def ldexp(x, y, name=None):
    return binop("ldexp",
                 lambda a, b: a * torch.pow(2.0, b).to(a.dtype), x, y,
                 scalars=False)


# ---- unary ----
def exp(x, name=None):
    return unop("exp", torch.exp, x)


def expm1(x, name=None):
    return unop("expm1", torch.expm1, x)


def log(x, name=None):
    return unop("log", torch.log, x)


def log2(x, name=None):
    return unop("log2", torch.log2, x)


def log10(x, name=None):
    return unop("log10", torch.log10, x)


def log1p(x, name=None):
    return unop("log1p", torch.log1p, x)


def sqrt(x, name=None):
    return unop("sqrt", torch.sqrt, x)


def rsqrt(x, name=None):
    return unop("rsqrt", torch.rsqrt, x)


def square(x, name=None):
    return unop("square", torch.square, x)


def abs(x, name=None):
    return unop("abs", torch.abs, x)


def sign(x, name=None):
    return unop("sign", torch.sign, x)


def sgn(x, name=None):
    return unop("sgn", torch.sgn, x)


def sin(x, name=None):
    return unop("sin", torch.sin, x)


def cos(x, name=None):
    return unop("cos", torch.cos, x)


def tan(x, name=None):
    return unop("tan", torch.tan, x)


def asin(x, name=None):
    return unop("asin", torch.asin, x)


def acos(x, name=None):
    return unop("acos", torch.acos, x)


def atan(x, name=None):
    return unop("atan", torch.atan, x)


def atan2(x, y, name=None):
    return binop("atan2", torch.atan2, x, y, scalars=False)


def sinh(x, name=None):
    return unop("sinh", torch.sinh, x)


def cosh(x, name=None):
    return unop("cosh", torch.cosh, x)


def asinh(x, name=None):
    return unop("asinh", torch.asinh, x)


def acosh(x, name=None):
    return unop("acosh", torch.acosh, x)


def atanh(x, name=None):
    return unop("atanh", torch.atanh, x)


def tanh(x, name=None):
    return unop("tanh", torch.tanh, x)


def floor(x, name=None):
    return unop("floor", torch.floor, x)


def ceil(x, name=None):
    return unop("ceil", torch.ceil, x)


def round(x, name=None):
    return unop("round", torch.round, x)


def trunc(x, name=None):
    return unop("trunc", torch.trunc, x)


def frac(x, name=None):
    return unop("frac", lambda a: a - torch.trunc(a), x)


def reciprocal(x, name=None):
    return unop("reciprocal", torch.reciprocal, x)


def neg(x, name=None):
    return unop("neg", torch.neg, x)


def erf(x, name=None):
    return unop("erf", torch.erf, x)


def erfinv(x, name=None):
    return unop("erfinv", torch.erfinv, x)


def digamma(x, name=None):
    return unop("digamma", torch.digamma, x)


def lgamma(x, name=None):
    return unop("lgamma", torch.lgamma, x)


def logit(x, eps=None, name=None):
    def impl(a):
        z = a if eps is None else torch.clamp(a, eps, 1.0 - eps)
        out = torch.log(z / (1.0 - z))
        if eps is None:
            out = torch.where((a < 0) | (a > 1),
                              torch.full_like(out, float("nan")), out)
        return out

    return dispatch("logit", impl, asarray(x))


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return dispatch("stanh", lambda a: scale_b * torch.tanh(scale_a * a),
                    asarray(x))


def deg2rad(x, name=None):
    return unop("deg2rad", torch.deg2rad, x)


def rad2deg(x, name=None):
    return unop("rad2deg", torch.rad2deg, x)


def angle(x, name=None):
    return unop("angle", torch.angle, x)


def conj(x, name=None):
    return unop("conj", torch.conj_physical, x)


def real(x, name=None):
    return unop("real", lambda a: torch.real(a).clone()
                if a.is_complex() else a, x)


def imag(x, name=None):
    return unop("imag", lambda a: torch.imag(a).clone() if a.is_complex()
                else torch.zeros_like(a), x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return dispatch(
        "nan_to_num",
        lambda a: torch.nan_to_num(a, nan=nan, posinf=posinf, neginf=neginf),
        asarray(x))


def gcd(x, y, name=None):
    return binop("gcd", torch.gcd, x, y, scalars=False)


def lcm(x, y, name=None):
    return binop("lcm", torch.lcm, x, y, scalars=False)


def _heaviside(a, b):
    # jnp.heaviside: 0 below zero, 1 above, y at zero (its gradient)
    return torch.where(a == 0, b, (a > 0).to(b.dtype))


def heaviside(x, y, name=None):
    return binop("heaviside", _heaviside, x, y, scalars=False)


def clip(x, min=None, max=None, name=None):
    lo = min.detach() if isinstance(min, torch.Tensor) else min
    hi = max.detach() if isinstance(max, torch.Tensor) else max

    def impl(a):
        if lo is None and hi is None:
            return a
        return torch.clamp(a, lo, hi)

    bounds = tuple(b for b in (lo, hi) if b is not None)
    return dispatch("clip", impl, asarray(x),
                    promote=0 if bounds else None, weak=bounds)


def lerp(x, y, weight, name=None):
    if is_scalar(weight):
        return dispatch("lerp", lambda a, b: a + weight * (b - a),
                        asarray(x), asarray(y), promote=0)
    return dispatch("lerp", lambda a, b, w: a + w * (b - a), asarray(x),
                    asarray(y), asarray(weight), promote=0)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    s = float(scale) if is_scalar(scale) else scale

    def impl(a, *rest):
        sv = rest[0] if rest else s
        out = a * sv + bias if bias_after_scale else (a + bias) * sv
        return out.to(a.dtype)

    if is_scalar(scale):
        return dispatch("scale", impl, asarray(x))
    return dispatch("scale", impl, asarray(x), asarray(scale))


def increment(x, value=1.0, name=None):
    out = dispatch("increment", lambda a: torch.add(a, value), asarray(x),
                   promote=0, weak=(value,))
    if isinstance(x, torch.Tensor):
        from ..core.tensor import inplace_update
        return inplace_update(x, out)
    return out


# ---- reductions ----
def _reduce(name, fn, x, axis, keepdim, dtype=None):
    from ..core.dtypes import convert_dtype
    ax = normalize_axis(axis)
    d = convert_dtype(dtype)

    def impl(a):
        out = fn(a, dims(ax, a.ndim), keepdim)
        return out.to(d) if d is not None else out

    return dispatch(name, impl, asarray(x))


def _to_sum(a):
    return a.to(torch.int32) if a.dtype == torch.bool else a


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    return _reduce("sum", lambda a, dm, k: torch.sum(_to_sum(a), dm,
                                                     keepdim=k),
                   x, axis, keepdim, dtype)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return _reduce("nansum", lambda a, dm, k: torch.nansum(
        _to_sum(a), dm, keepdim=k), x, axis, keepdim, dtype)


def _float(a):
    return a if a.is_floating_point() or a.is_complex() else a.float()


def mean(x, axis=None, keepdim=False, name=None):
    return _reduce("mean", lambda a, dm, k: torch.mean(_float(a), dm,
                                                       keepdim=k),
                   x, axis, keepdim)


def nanmean(x, axis=None, keepdim=False, name=None):
    return _reduce("nanmean", lambda a, dm, k: torch.nanmean(
        _float(a), dm, keepdim=k), x, axis, keepdim)


def max(x, axis=None, keepdim=False, name=None):
    return _reduce("max", lambda a, dm, k: torch.amax(a, dm, keepdim=k),
                   x, axis, keepdim)


def min(x, axis=None, keepdim=False, name=None):
    return _reduce("min", lambda a, dm, k: torch.amin(a, dm, keepdim=k),
                   x, axis, keepdim)


amax = max
amin = min


def _prod(a, dm, keepdim):
    out = _to_sum(a)
    for d in sorted((d % a.ndim for d in dm), reverse=True):
        out = torch.prod(out, d, keepdim=keepdim)
    return out


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    return _reduce("prod", _prod, x, axis, keepdim, dtype)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return _reduce("logsumexp", lambda a, dm, k: torch.logsumexp(
        _float(a), dm, keepdim=k), x, axis, keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return _reduce("count_nonzero", lambda a, dm, k: torch.sum(
        a != 0, dm, keepdim=k, dtype=torch.int32), x, axis, keepdim)


def cumsum(x, axis=None, dtype=None, name=None):
    from ..core.dtypes import convert_dtype
    d = convert_dtype(dtype)

    def impl(a):
        arr = a.reshape(-1) if axis is None else _to_sum(a)
        out = torch.cumsum(_to_sum(arr), 0 if axis is None else axis)
        return out.to(d) if d is not None else out

    return dispatch("cumsum", impl, asarray(x))


def cumprod(x, dim=None, dtype=None, name=None):
    from ..core.dtypes import convert_dtype
    d = convert_dtype(dtype)

    def impl(a):
        arr = a.reshape(-1) if dim is None else a
        out = torch.cumprod(_to_sum(arr), 0 if dim is None else dim)
        return out.to(d) if d is not None else out

    return dispatch("cumprod", impl, asarray(x))


def _cumext(name, fn, x, axis):
    def impl(a):
        arr = a.reshape(-1) if axis is None else a
        vals, inds = fn(arr, 0 if axis is None else axis)
        return vals, inds.to(torch.int32)

    return dispatch(name, impl, asarray(x), n_diff=1)


def cummax(x, axis=None, dtype="int64", name=None):
    return _cumext("cummax", torch.cummax, x, axis)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cumext("cummin", torch.cummin, x, axis)


def isfinite(x, name=None):
    return unop("isfinite", torch.isfinite, x)


def isnan(x, name=None):
    return unop("isnan", torch.isnan, x)


def isinf(x, name=None):
    return unop("isinf", torch.isinf, x)


# ---- linear-algebra flavoured math ----
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    def impl(i, a, b):
        return beta * i + alpha * torch.matmul(a, b)

    return dispatch("addmm", impl, asarray(input), asarray(x), asarray(y),
                    promote=0)


def inner(x, y, name=None):
    return dispatch("inner", torch.inner, asarray(x), asarray(y), promote=0)


def outer(x, y, name=None):
    return dispatch("outer", lambda a, b: torch.outer(
        a.reshape(-1), b.reshape(-1)), asarray(x), asarray(y), promote=0)


def kron(x, y, name=None):
    return dispatch("kron", torch.kron, asarray(x), asarray(y), promote=0)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return dispatch("trace", lambda a: torch.diagonal(
        a, offset, axis1, axis2).sum(-1), asarray(x))


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    tensors = [asarray(x)]
    has_prepend = prepend is not None
    has_append = append is not None
    if has_prepend:
        tensors.append(asarray(prepend))
    if has_append:
        tensors.append(asarray(append))

    def impl(a, *rest):
        i = 0
        pre = post = None
        if has_prepend:
            pre = rest[i]
            i += 1
        if has_append:
            post = rest[i]
        return torch.diff(a, n=n, dim=axis, prepend=pre, append=post)

    return dispatch("diff", impl, *tensors)


def multiplex(inputs, index, name=None):
    def impl(idx, *arrays):
        stacked = torch.stack(arrays, 0)
        # out-of-range choices clamp, as JAX's gather does
        sel = idx.reshape(-1).long().clamp(0, len(arrays) - 1)
        return stacked[sel, torch.arange(stacked.shape[1],
                                         device=stacked.device)]

    return dispatch("multiplex", impl, asarray(index),
                    *[asarray(t) for t in inputs],
                    nondiff=[True] + [False] * len(inputs), promote=1)


def add_n(inputs, name=None):
    if isinstance(inputs, torch.Tensor):
        inputs = [inputs]

    def impl(*arrays):
        out = arrays[0]
        for a in arrays[1:]:
            out = out + a
        return out

    return dispatch("add_n", impl, *[asarray(t) for t in inputs], promote=0)


def inverse(x, name=None):
    return unop("inverse", torch.linalg.inv, x)


def log_normal(mean=1.0, std=2.0, shape=None, name=None):
    from .random import _normal_draw
    return _normal_draw("log_normal", shape, None,
                        lambda z: torch.exp(mean + std * z))
