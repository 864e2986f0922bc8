"""The port's host tracer: a copy of the JAX package's pure-Python
``HostTracer`` (``paddle_tpu/runtime/_fallback.py``), the event buffer
``observability.spans`` records into.

Events are ``(kind, t0_ns, t1_ns, tid, value, name)`` tuples: kind 0 is
a range, 1 an instant (2, a counter sample, is the reference's native
tracer's; this one records none).  ``HostTracer.enabled`` is
the fast-path flag every instrumented site tests first, so a disabled
tracer costs one attribute load and a bool test.
"""

from __future__ import annotations

import threading
import time


def now_ns() -> int:
    return time.monotonic_ns()


class _TracerState(threading.local):
    def __init__(self):
        self.stack = []


_trace_enabled = False
_trace_events: list = []
_trace_mu = threading.Lock()
_trace_tls = _TracerState()


class HostTracer:
    enabled = False  # the fast-path flag

    @staticmethod
    def enable():
        global _trace_enabled
        _trace_enabled = True
        HostTracer.enabled = True

    @staticmethod
    def disable():
        global _trace_enabled
        _trace_enabled = False
        HostTracer.enabled = False

    @staticmethod
    def begin(name: str):
        if _trace_enabled:
            _trace_tls.stack.append((name, now_ns()))

    @staticmethod
    def end():
        if _trace_enabled and _trace_tls.stack:
            name, t0 = _trace_tls.stack.pop()
            with _trace_mu:
                _trace_events.append(
                    (0, t0, now_ns(), threading.get_ident(), 0, name))

    @staticmethod
    def instant(name: str):
        if _trace_enabled:
            t = now_ns()
            with _trace_mu:
                _trace_events.append(
                    (1, t, t, threading.get_ident(), 0, name))

    @staticmethod
    def clear():
        with _trace_mu:
            _trace_events.clear()

    @staticmethod
    def events() -> list:
        with _trace_mu:
            return list(_trace_events)
