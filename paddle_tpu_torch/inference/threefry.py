"""JAX's threefry PRNG, bit for bit, in torch integer ops.

The serving engine's sampled streams are threefry keys (``PRNGKey(seed)``,
``fold_in``, ``split``), so a seeded request must draw the same bits in
the port as in the JAX package.  The specification is the installed JAX
0.9.0 source, ``jax/_src/prng.py`` and ``jax/_src/random.py``:

- ``PRNGKey`` is ``threefry_seed`` (prng.py:802) after ``random_seed``
  (prng.py:549) turned the Python int into a 64-bit integer: with
  ``jax_enable_x64`` off (the default, and the JAX package's setting) that
  integer is truncated to 32 bits, so the key is ``[0, seed mod 2**32]``
  and a seed outside the int64 range raises ``OverflowError``;
- ``threefry2x32`` is the 20-round hash of ``_threefry2x32_lowering``
  (prng.py:883) with ``rotate_left`` and ``apply_round`` (:837, :863);
- ``split`` is ``_threefry_split_foldlike`` (:1155): key ``i`` of ``n`` is
  the hash of the counter pair ``(0, i)``, both output words;
- ``fold_in`` is ``_threefry_fold_in`` (:1167): the hash of ``(0, data)``;
- ``random_bits`` is ``_threefry_random_bits_partitionable`` (:1184):
  ``bits1 ^ bits2`` over the hi/lo words of each element's flat index
  (``iota_2x32_shape``, :989);
- ``uniform``, ``gumbel`` and ``categorical`` are ``_uniform`` (random.py
  :434), ``_gumbel`` (:1722, the low mode: ``minval = finfo(float32).tiny``)
  and ``categorical`` (:1739: the argmax of Gumbel noise plus the logits).

Only the partitionable rule is implemented: it has been JAX's default
(``jax_threefry_partitionable``) since 0.5.

Torch has no full ``uint32`` arithmetic, so a 32-bit word lives in an
``int64`` tensor in ``[0, 2**32)`` and every add and left shift is masked
with ``& 0xFFFFFFFF``: the sum of two words is below ``2**33`` and a word
shifted left by at most 29 bits below ``2**61``, so nothing overflows
before the mask.  A key is an ``int64`` tensor ``[..., 2]``.  Every
function runs on any device with no host read and no ``torch.Generator``,
so it can be captured in a CUDA graph; the uniform floats are built from
the bits exactly as JAX builds them, so they are bit-equal too.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = float(np.finfo(np.float32).tiny)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as a ``[2]`` uint32 array: the seed as
    a 64-bit integer (``OverflowError`` outside that range), truncated to
    its low 32 bits as the 32-bit JAX configuration does."""
    s = int(np.int64(seed))
    return np.array([0, s & _MASK], np.uint32)


def as_key(key, device=None) -> torch.Tensor:
    """A uint32 key array as an ``int64`` key tensor ``[..., 2]`` on
    ``device``."""
    return torch.from_numpy(
        np.asarray(key, np.uint32).astype(np.int64)).to(device)


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash of the counter words ``(x1, x2)`` under the
    key words ``(k1, k2)``: 20 rounds in five blocks of four, a key
    injection after each.  All ``int64`` tensors of 32-bit words that
    broadcast together; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    # fresh tensors of the full broadcast shape, updated in place below
    x0, y = torch.broadcast_tensors((x1 + k1) & _MASK, (x2 + k2) & _MASK)
    x0, y = x0.contiguous(), y.contiguous()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0.add_(y).bitwise_and_(_MASK)
            t = y << r
            y = y.bitwise_right_shift(32 - r).bitwise_or_(t)
            y = y.bitwise_and_(_MASK).bitwise_xor_(x0)
        x0 = x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        y = (y + ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(_MASK)
    return x0, y


def _hash_keys(keys: torch.Tensor, hi, lo):
    """Both hash words of the counters ``(hi, lo)`` under ``keys [..., 2]``
    (the counters broadcast against ``keys.shape[:-1]``)."""
    return threefry2x32(keys[..., 0], keys[..., 1], hi, lo)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` per key: ``keys [..., 2]``, ``data`` an int
    or an integer tensor broadcasting against ``keys.shape[:-1]`` (taken
    modulo ``2**32`` as JAX's uint32 cast does for non-negative values).
    Returns keys of the broadcast shape."""
    if isinstance(data, torch.Tensor):
        lo = data.to(torch.int64) & _MASK
    else:
        lo = int(data) & _MASK
    a, b = _hash_keys(keys, 0, lo)
    return torch.stack([a, b], dim=-1)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` per key: ``keys [..., 2]`` -> ``[..., num, 2]``."""
    lo = torch.arange(num, dtype=torch.int64, device=keys.device)
    a, b = _hash_keys(keys[..., None, :], 0, lo)
    return torch.stack([a, b], dim=-1)


def _iota_2x32(shape: Sequence[int], device):
    """The hi and lo 32-bit words of the flat index of every element of
    ``shape`` (``iota_2x32_shape``)."""
    n = int(np.prod(shape, dtype=np.int64)) if len(shape) else 1
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(
        tuple(shape))
    if n <= _MASK + 1:
        return 0, idx
    return idx >> 32, idx & _MASK


def random_bits(keys: torch.Tensor, shape: Sequence[int] = ()) -> \
        torch.Tensor:
    """``jax.random.bits`` (32-bit) per key: ``keys [..., 2]`` ->
    ``keys.shape[:-1] + shape`` int64 words, each key drawing over its
    own flat index of ``shape``."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _iota_2x32(shape, keys.device)
    kv = keys.reshape(tuple(keys.shape[:-1]) + (1,) * len(shape) + (2,))
    a, b = _hash_keys(kv, hi, lo)
    return a.bitwise_xor_(b)


def uniform(keys: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` (float32) per key: the top 23 bits of each
    word as the mantissa of a float in [1, 2), minus 1, then ``* (maxval
    - minval) + minval`` (the difference taken in float32) and
    ``max(minval, .)``, as ``_uniform`` builds it.  XLA fuses that
    multiply-add (one rounding): with a scale other than 1 it is taken
    in float64, where the product of two float32 values is exact (the
    sum's own rounding can then meet a float32 tie, about once in 2^29
    draws)."""
    bits = random_bits(keys, shape)
    lo, hi = np.float32(minval), np.float32(maxval)
    scale = float(hi - lo)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if scale != 1.0:
        f = (f.double() * scale + float(lo)).float()
    else:
        f = f + float(lo)
    return torch.clamp_min(f, float(lo))


def gumbel(keys: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.gumbel`` (float32, low mode) per key: ``-log(-log(u))``
    of a uniform over ``[tiny, 1)``."""
    u = uniform(keys, shape, TINY, 1.0)
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` along the last axis with one key per
    leading index: ``keys [..., 2]`` with ``keys.shape[:-1]`` a prefix of
    ``logits.shape[:-1]``; each key draws Gumbel noise over the rest of
    the logits' shape.  The argmax of noise plus logits, first index on
    ties; returns int64 indices of ``logits.shape[:-1]``."""
    k = keys.dim() - 1
    g = gumbel(keys, tuple(logits.shape[k:]))
    return torch.argmax(g + logits, dim=-1)
