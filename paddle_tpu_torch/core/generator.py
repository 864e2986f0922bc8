"""Random number generator state.

Port of ``paddle_tpu/core/generator.py``: a ``Generator`` holds a
``(seed, offset)`` pair, and each draw folds the current offset into the
seed's base key and advances the offset by one, so the global seed gives
one stateful stream while every key is a pure function of ``(seed,
offset)``.

A draw (``Generator.draw``) yields a ``Key`` of two parts:

- ``tf``, JAX's threefry key ``fold_in(PRNGKey(seed), offset)``, the key
  the JAX package draws; it is two 32-bit words, hashed here with Python
  integers by the rule of ``inference/threefry.py``, so drawing a key
  touches no device.  Dropout masks are threefry bits from it
  (``nn.functional``), bit-equal to the JAX package's for the same seed
  and draw count;
- ``mix``, a 64-bit integer key under the splitmix64 mixes ``fold_in``
  and ``split`` below.  The train step's stochastic rounding of bf16
  moments draws its noise from it (``jit/train_step.py``).  It does not
  follow the JAX package's bits: the port's rounding noise is its own
  counter hash.  ``next_key()`` returns this part alone.

The trace-key stack (``push_trace_key``/``pop_trace_key``, the reference's
:56-79): while a key is pushed, draws do not touch the generator's
offset; draw ``j`` under the pushed key ``k`` is ``k.fold_in(j)``, as the
reference's ``fold_in(trace_key, counter)``.  ``jit.TrainStep`` pushes its
step key around the loss and ``distributed.recompute`` its segment key
around the segment, so dropout inside them derives from those keys.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Tuple

_M64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B97F4A7C15
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _mix64(z: int) -> int:
    """The splitmix64 finalizer: a bijection of 64-bit integers."""
    z &= _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def key(seed: int) -> int:
    """The base key of a seed."""
    return _mix64(int(seed) + _GOLDEN)


def fold_in(k: int, n: int) -> int:
    """A new key from key ``k`` and the integer ``n``
    (``jax.random.fold_in``)."""
    return _mix64(int(k) ^ _mix64(int(n) + _GOLDEN))


def split(k: int, num: int = 2) -> Tuple[int, ...]:
    """``num`` keys from ``k`` (``jax.random.split``): the splitmix64
    sequence that starts at ``k``."""
    return tuple(_mix64(int(k) + (i + 1) * _GOLDEN) for i in range(num))


def _threefry2x32(k1: int, k2: int, x1: int, x2: int) -> Tuple[int, int]:
    """The threefry-2x32 hash of one counter pair, in Python integers
    (``inference/threefry.threefry2x32`` for one element)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x, y = (x1 + k1) & _M32, (x2 + k2) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x = (x + y) & _M32
            y = (((y << r) | (y >> (32 - r))) & _M32) ^ x
        x = (x + ks[(i + 1) % 3]) & _M32
        y = (y + ks[(i + 2) % 3] + i + 1) & _M32
    return x, y


def tf_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)``: the seed as a 64-bit integer
    (``OverflowError`` outside that range) truncated to 32 bits, as the
    32-bit JAX configuration does."""
    s = int(seed)
    if not -(1 << 63) <= s < (1 << 63):
        raise OverflowError(f"seed {seed} is outside the int64 range")
    return (0, s & _M32)


def tf_fold_in(k: Tuple[int, int], n: int) -> Tuple[int, int]:
    """``jax.random.fold_in`` of a threefry key and a non-negative
    integer (taken modulo 2**32)."""
    return _threefry2x32(k[0], k[1], 0, int(n) & _M32)


class Key(NamedTuple):
    """One draw: the splitmix key ``mix`` and the threefry key ``tf``
    of the same ``(seed, offset)``."""
    mix: int
    tf: Tuple[int, int]

    def fold_in(self, n: int) -> "Key":
        return Key(fold_in(self.mix, n), tf_fold_in(self.tf, n))


def base_key(seed: int) -> Key:
    return Key(key(seed), tf_key(seed))


# pushed keys, innermost last: [key, draws made under it]
_trace_key_stack = []


def push_trace_key(k: Key) -> None:
    """Draws derive from ``k`` until the matching ``pop_trace_key``."""
    _trace_key_stack.append([k, 0])


def pop_trace_key() -> None:
    _trace_key_stack.pop()


def _trace_draw() -> Optional[Key]:
    if not _trace_key_stack:
        return None
    entry = _trace_key_stack[-1]
    k = entry[0].fold_in(entry[1])
    entry[1] += 1
    return k


def trace_draws() -> int:
    """Draws made so far under the innermost pushed key (0 without
    one)."""
    return _trace_key_stack[-1][1] if _trace_key_stack else 0


class Generator:
    """Stateful stream of keys over ``(seed, offset)``."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self.manual_seed(seed)

    def manual_seed(self, seed: int) -> "Generator":
        with self._lock:
            self._seed = int(seed)
            self._base = base_key(seed)
            self._offset = 0
        return self

    def seed(self) -> int:
        return self._seed

    def get_state(self):
        return (self._seed, self._offset)

    def set_state(self, state):
        seed, offset = state
        self.manual_seed(seed)
        self._offset = int(offset)

    def draw(self) -> Key:
        """Draw the next key: under a pushed key, from it; else at the
        current offset, which advances by one."""
        k = _trace_draw()
        if k is not None:
            return k
        with self._lock:
            offset = self._offset
            self._offset += 1
        return self._base.fold_in(offset)

    def peek(self) -> Key:
        """The key the next ``draw`` returns, drawing nothing."""
        if _trace_key_stack:
            entry = _trace_key_stack[-1]
            return entry[0].fold_in(entry[1])
        return self._base.fold_in(self._offset)

    def next_key(self) -> int:
        """Draw the next key's splitmix part (advances the offset)."""
        return self.draw().mix

    def split(self, n: int):
        return split(self.next_key(), n)


_default_generator: Optional[Generator] = None
_lock = threading.Lock()


def default_generator() -> Generator:
    global _default_generator
    if _default_generator is None:
        with _lock:
            if _default_generator is None:
                _default_generator = Generator(0)
    return _default_generator


def seed(value: int) -> Generator:
    """``paddle.seed``: reset the global generator."""
    gen = default_generator()
    gen.manual_seed(value)
    return gen


def get_rng_state():
    return [default_generator().get_state()]


def set_rng_state(states):
    default_generator().set_state(states[0])


def draw() -> Key:
    return default_generator().draw()


def next_key() -> int:
    return default_generator().next_key()
