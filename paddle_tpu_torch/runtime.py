"""The port's host runtime: copies of the JAX package's pure-Python
fallbacks (``paddle_tpu/runtime/_fallback.py``).

- ``HostTracer``, the event buffer ``observability.spans`` records into;
- ``BlockingQueue`` (:21) and ``WorkQueue`` (:186), the bounded prefetch
  queue and the thread pool the ``DataLoader``'s thread workers run on
  (the reference's native C++ pair is not ported).

Events are ``(kind, t0_ns, t1_ns, tid, value, name)`` tuples: kind 0 is
a range, 1 an instant (2, a counter sample, is the reference's native
tracer's; this one records none).  ``HostTracer.enabled`` is
the fast-path flag every instrumented site tests first, so a disabled
tracer costs one attribute load and a bool test.
"""

from __future__ import annotations

import queue as _pyqueue
import threading
import time
from typing import Any, Optional


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


class QueueClosed(Exception):
    pass


class BlockingQueue:
    def __init__(self, capacity: int):
        self._q = _pyqueue.Queue(maxsize=max(capacity, 1))
        self._closed = threading.Event()

    def push(self, obj: Any, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._closed.is_set():
                raise QueueClosed("queue closed")
            try:
                self._q.put(obj, timeout=0.05)
                return True
            except _pyqueue.Full:
                if deadline is not None and time.monotonic() > deadline:
                    return False

    def pop(self, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return self._q.get(timeout=0.05)
            except _pyqueue.Empty:
                if self._closed.is_set() and self._q.empty():
                    raise QueueClosed("queue closed and drained")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError("BlockingQueue.pop timed out")

    def size(self) -> int:
        return self._q.qsize()

    def capacity(self) -> int:
        return self._q.maxsize

    def close(self):
        self._closed.set()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()


class WorkQueue:
    def __init__(self, num_threads: int):
        self._q: "_pyqueue.Queue" = _pyqueue.Queue()
        self._errors: list = []
        self._mu = threading.Lock()
        self._stop = False
        self._threads = [threading.Thread(target=self._loop, daemon=True)
                         for _ in range(max(num_threads, 1))]
        for t in self._threads:
            t.start()

    def _loop(self):
        while True:
            fn = self._q.get()
            if fn is None:
                self._q.task_done()
                return
            try:
                fn()
            except Exception as e:
                with self._mu:
                    self._errors.append(e)
            finally:
                self._q.task_done()

    def submit(self, fn):
        if self._stop:
            raise RuntimeError("WorkQueue.submit on stopped queue")
        self._q.put(fn)

    def wait_idle(self):
        self._q.join()
        with self._mu:
            if self._errors:
                raise self._errors.pop(0)

    def pending(self) -> int:
        return self._q.unfinished_tasks

    def shutdown(self):
        self._stop = True
        for _ in self._threads:
            self._q.put(None)
