"""Random sampling ops: port of ``paddle_tpu/tensor/random.py``.

Every draw takes one key from the port's generator (``core.generator``,
the reference's key stream: ``fold_in(PRNGKey(seed), offset)``):

- ``rand``, ``uniform`` (and ``uniform_``), ``randint``, ``bernoulli``
  and ``randperm`` rebuild JAX's bits from the key with
  ``inference/threefry.py`` (``_uniform``, ``_randint``'s two split
  words, ``bernoulli``'s ``uniform < p``, ``_shuffle``'s rounds of
  stable sorts by random words), so at float32 they are bit-equal to the
  reference on the host and on the card;
- ``normal``, ``standard_normal``/``randn``, ``normal_`` and
  ``log_normal`` take the same uniforms over ``(nextafter(-1, 0), 1)``
  and ``sqrt(2) * erfinv(u)``: within a few ulps (torch's ``erfinv`` is
  not XLA's);
- ``multinomial``, ``poisson``, ``binomial``, ``standard_gamma`` and
  ``exponential_`` follow the reference's law, not its bits: torch's
  samplers under a ``torch.Generator`` seeded from the key.

New tensors lie on ``set_device``'s device; draws conditioned on a
tensor stay on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import generator as _gen
from ..core.dispatch import dispatch, wrap
from ..core.dtypes import convert_dtype, default_float_dtype
from ._helpers import asarray, normalize_shape

__all__ = [
    "uniform", "uniform_", "normal", "normal_", "standard_normal", "randn",
    "rand", "randint", "randint_like", "randperm", "bernoulli", "multinomial",
    "poisson", "exponential_", "binomial", "standard_gamma",
]

_M32 = 0xFFFFFFFF
_SQRT2 = float(np.float32(np.sqrt(2)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _tf():
    from ..inference import threefry
    return threefry


def _dev():
    from .. import device as _device
    return _device.layer_device()


def _key(device):
    """The next key's threefry words as an int64 key tensor on
    ``device``, and the key."""
    k = _gen.draw()
    return torch.tensor(k.tf, dtype=torch.int64, device=device), k


def _seeded(k, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(k.mix & (2 ** 63 - 1))


def _uniform(shape, dtype, lo, hi, device):
    keys, _ = _key(device)
    u = _tf().uniform(keys, tuple(shape), lo, hi)
    return u if dtype == torch.float32 else u.to(dtype)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    sh = normalize_shape(shape)
    d = convert_dtype(dtype) or default_float_dtype()
    with torch.no_grad():
        return wrap(_uniform(sh, d, min, max, _dev()))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    with torch.no_grad():
        out = _uniform(tuple(x.shape), x.dtype, min, max, x.device)
    return x.set_value(out)


def _std_normal(shape, device):
    u = _uniform(shape, torch.float32, _NORMAL_LO, 1.0, device)
    return _SQRT2 * torch.erfinv(u)


def _normal_draw(name, shape, device, post):
    sh = normalize_shape(shape) if shape is not None else ()
    with torch.no_grad():
        return wrap(post(_std_normal(sh, device or _dev())))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        m = mean.detach() if isinstance(mean, torch.Tensor) else mean
        s = std.detach() if isinstance(std, torch.Tensor) else std
        sh = torch.broadcast_shapes(tuple(np.shape(m) if not isinstance(
            m, torch.Tensor) else m.shape), tuple(np.shape(s) if not
                                                 isinstance(s, torch.Tensor)
                                                 else s.shape))
        dev = (m if isinstance(m, torch.Tensor) else s).device
        return _normal_draw("normal", sh, dev, lambda z: m + s * z)
    return _normal_draw("normal", shape, None, lambda z: mean + std * z)


def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        out = mean + std * _std_normal(tuple(x.shape), x.device)
    return x.set_value(out)


def standard_normal(shape, dtype=None, name=None):
    d = convert_dtype(dtype) or default_float_dtype()
    return _normal_draw("standard_normal", shape, None,
                        lambda z: z if d == torch.float32 else z.to(d))


randn = standard_normal


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, 0.0, 1.0)


def _randint_bits(keys, shape, low, high):
    """``jax.random.randint`` at 32 bits: two words per element from the
    key's two split keys, combined modulo the span in uint32 arithmetic
    (held in int64)."""
    tf = _tf()
    k1, k2 = tf.split(keys, 2).unbind(-2)
    hi_bits = tf.random_bits(k1, shape)
    lo_bits = tf.random_bits(k2, shape)
    span = (high - low) & _M32 if high > low else 1
    # uint32 arithmetic: the square wraps (to 0 for a span above 2**16)
    mult = (((2 ** 16 % span) ** 2) & _M32) % span
    off = (((hi_bits % span) * mult) & _M32) + (lo_bits % span)
    off = (off & _M32) % span
    val = (low + off) & _M32
    return torch.where(val >= 2 ** 31, val - 2 ** 32, val).to(torch.int32)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    sh = normalize_shape(shape)
    d = convert_dtype(dtype)
    with torch.no_grad():
        keys, _ = _key(_dev())
        return wrap(_randint_bits(keys, sh, int(low), int(high)).to(d))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    return randint(low, high, x.shape, dtype or "int64")


def randperm(n, dtype="int64", name=None):
    d = convert_dtype(dtype)
    tf = _tf()
    with torch.no_grad():
        key, _ = _key(_dev())
        x = torch.arange(n, dtype=torch.int64, device=key.device)
        rounds = int(np.ceil(3 * np.log(max(1, n)) /
                             np.log(np.iinfo(np.uint32).max)))
        for _ in range(rounds):
            key, sub = tf.split(key, 2).unbind(-2)
            order = torch.sort(tf.random_bits(sub, (n,)), stable=True)[1]
            x = x[order]
        return wrap(x.to(d))


def bernoulli(x, name=None):
    def impl(p):
        keys, _ = _key(p.device)
        u = _tf().uniform(keys, tuple(p.shape))
        return (u < p).to(p.dtype)

    return dispatch("bernoulli", impl, asarray(x), nondiff=[True])


def multinomial(x, num_samples=1, replacement=False, name=None):
    def impl(p):
        _, k = _key(p.device)
        gen = _seeded(k, p.device)
        probs = p.float() / p.float().sum(-1, keepdim=True)
        return torch.multinomial(probs, num_samples, replacement,
                                 generator=gen).to(torch.int32)

    return dispatch("multinomial", impl, asarray(x), nondiff=[True])


def poisson(x, name=None):
    def impl(lam):
        _, k = _key(lam.device)
        return torch.poisson(lam.float(), generator=_seeded(
            k, lam.device)).to(lam.dtype)

    return dispatch("poisson", impl, asarray(x), nondiff=[True])


def binomial(count, prob, name=None):
    def impl(n, p):
        _, k = _key(p.device)
        n, p = torch.broadcast_tensors(n.float(), p.float())
        return torch.binomial(n.contiguous(), p.contiguous(),
                              generator=_seeded(k, p.device)).to(torch.int32)

    return dispatch("binomial", impl, asarray(count), asarray(prob),
                    nondiff=[True, True])


def standard_gamma(x, name=None):
    def impl(a):
        _, k = _key(a.device)
        devices = [a.device] if a.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            if a.device.type == "cuda":
                torch.cuda.manual_seed(k.mix & (2 ** 63 - 1))
            else:
                torch.manual_seed(k.mix & (2 ** 63 - 1))
            return torch._standard_gamma(a)

    return dispatch("standard_gamma", impl, asarray(x), nondiff=[True])


def exponential_(x, lam=1.0, name=None):
    _, k = _key(x.device)
    with torch.no_grad():
        out = torch.empty_like(x).exponential_(
            lam, generator=_seeded(k, x.device))
    return x.set_value(out)
