"""Random number generator state.

Port of ``paddle_tpu/core/generator.py``: a ``Generator`` holds a
``(seed, offset)`` pair and each ``next_key()`` folds the current offset
into the seed's base key and advances the offset, so the global seed
gives one stateful stream while every key is a pure function of
``(seed, offset)``.

Keys are 64-bit integers, not threefry keys.  ``fold_in`` and ``split``
are integer mixes (the splitmix64 finalizer), so keys follow the JAX
package's structure without its bits: the train step draws one key per
call, folds it per parameter and splits that into the m and v streams.
Python integers carry them, so drawing a key touches no device.

The trace-key stack of the JAX package is not ported: the port's train
step runs eagerly and draws its key from the default generator.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


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


class Generator:
    """Stateful stream of keys over ``(seed, offset)``."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self.manual_seed(seed)

    def manual_seed(self, seed: int) -> "Generator":
        with self._lock:
            self._seed = int(seed)
            self._base_key = key(seed)
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

    def next_key(self) -> int:
        """Draw the next key (advances the offset)."""
        with self._lock:
            offset = self._offset
            self._offset += 1
        return fold_in(self._base_key, offset)

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


def next_key() -> int:
    return default_generator().next_key()
