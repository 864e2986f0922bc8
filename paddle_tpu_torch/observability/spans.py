"""Structured spans over the port's host tracer + host/device trace
merging: a copy of ``paddle_tpu/observability/spans.py`` with two
changes for PyTorch.

``span(name, **attrs)`` is the structured face of
``runtime.HostTracer``: a range on the calling thread's lane whose
attributes are encoded into the event name (``;k=v`` suffixes that
``parse_span_name`` and the chrome-trace merger decode back into
Perfetto ``args``).  While a torch profiler is active the span also
opens a ``torch.profiler.record_function`` range of the same encoded
name, so the span lands in the profiler's chrome trace beside the
kernels it launched.  When neither the tracer nor a profiler is on,
``__enter__`` is two attribute loads and their bool tests — attrs are
never formatted and no profiler op is dispatched — so instrumented hot
loops (the serving scheduler) pay nothing outside a profiling window.

``merge_chrome_traces`` stitches the host chrome trace and a torch
profiler's chrome export (``prof.export_chrome_trace(path)``, or a
directory of ``*.pt.trace.json`` files as
``torch.profiler.tensorboard_trace_handler`` writes them) into ONE
Perfetto-loadable JSON: host lanes keep pid 0, the profiler's processes
are re-numbered into a disjoint pid range, and metadata (process/thread
names) is preserved.  The two clock domains are not re-aligned.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from typing import Optional

import torch.autograd.profiler as _autograd_profiler

from .. import runtime as rt

_ATTR_SEP = ";"

# tracing-window generation: bumped at every record-window start (after
# HostTracer.clear()).  Ranges opened in an earlier window no longer
# exist on the tracer, so a close crossing a window boundary must become
# a no-op instead of popping an unrelated range.
_trace_gen = 0


def current_trace_generation() -> int:
    return _trace_gen


def bump_trace_generation() -> int:
    global _trace_gen
    _trace_gen += 1
    return _trace_gen


def _esc_attr(v) -> str:
    """Escape ``;``/``=`` in attr values so a value cannot fabricate
    extra attrs on re-parse (inverse is ``_unesc_attr``)."""
    return (str(v).replace("%", "%25").replace(";", "%3B")
            .replace("=", "%3D"))


def _unesc_attr(v: str) -> str:
    return v.replace("%3D", "=").replace("%3B", ";").replace("%25", "%")


def format_span_name(name: str, attrs: dict) -> str:
    if not attrs:
        return name
    return name + _ATTR_SEP + _ATTR_SEP.join(
        f"{k}={_esc_attr(v)}" for k, v in attrs.items())


def parse_span_name(encoded: str):
    """Inverse of ``format_span_name``: ``(name, attrs_dict)``."""
    if _ATTR_SEP not in encoded:
        return encoded, {}
    name, *parts = encoded.split(_ATTR_SEP)
    attrs = {}
    for p in parts:
        k, _, v = p.partition("=")
        if k:
            attrs[k] = _unesc_attr(v)
    return name, attrs


class span:
    """Context manager recording a named host range with attributes.

    with span("serving.decode_block", steps=4, active=7):
        run_block()

    Re-entrant per instance is NOT supported (one range per ``with``);
    nesting distinct spans is (the tracer keeps a per-thread stack).
    Open no profiler around a CUDA stream capture: the profiler's range
    ops are not capturable, so profile warmed windows only.
    """

    __slots__ = ("_name", "_attrs", "_active", "_gen", "_rf")

    def __init__(self, name: str, **attrs):
        self._name = name
        self._attrs = attrs
        self._active = False
        self._gen = 0
        self._rf = None

    def __enter__(self):
        if rt.HostTracer.enabled:
            self._active = True
            self._gen = _trace_gen
            rt.HostTracer.begin(format_span_name(self._name, self._attrs))
        if _autograd_profiler._is_profiler_enabled:
            self._rf = _autograd_profiler.record_function(
                format_span_name(self._name, self._attrs))
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            rf, self._rf = self._rf, None
            rf.__exit__(*exc)
        if self._active:
            self._active = False
            # a window boundary between enter and exit invalidated the
            # opened range — closing now would pop someone else's
            if self._gen == _trace_gen:
                rt.HostTracer.end()
        return False


def instant(name: str, **attrs):
    """Zero-duration marker (request queued / finished) with attrs."""
    if rt.HostTracer.enabled:
        rt.HostTracer.instant(format_span_name(name, attrs))


def _host_events_as_chrome(events) -> list:
    """HostTracer event tuples -> chrome trace events, span-attr names
    decoded into ``args``."""
    out = []
    for kind, t0, t1, tid, value, raw in events:
        name, attrs = parse_span_name(raw)
        e = {"name": name, "pid": 0, "tid": tid, "ts": t0 / 1e3}
        if attrs:
            e["args"] = attrs
        if kind == 0:
            e.update(ph="X", dur=(t1 - t0) / 1e3)
        elif kind == 1:
            e.update(ph="i", s="t")
        else:
            e.update(ph="C", args={"value": value, **attrs})
        out.append(e)
    return out


def _decode_names(events):
    """Decode span-attr suffixes of exported event names into ``args``
    in place (an exported host trace and the profiler's ranges carry
    raw encoded names), so every input form honors the "attrs land as
    Perfetto args" contract."""
    for e in events:
        raw = e.get("name", "")
        if isinstance(raw, str) and _ATTR_SEP in raw:
            e["name"], attrs = parse_span_name(raw)
            if attrs:
                e["args"] = {**attrs, **e.get("args", {})}


def _profiler_exports(path: str) -> list:
    """The torch profiler chrome exports at ``path``: the file itself,
    or every ``*.pt.trace.json[.gz]`` under the directory."""
    if os.path.isfile(path):
        return [path]
    return sorted(
        glob.glob(os.path.join(path, "**", "*.pt.trace.json"),
                  recursive=True)
        + glob.glob(os.path.join(path, "**", "*.pt.trace.json.gz"),
                    recursive=True))


def _load_trace(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def merge_chrome_traces(out_path: str, host=None,
                        device_trace_dir: Optional[str] = None,
                        extra=None) -> dict:
    """Write one chrome/Perfetto JSON combining host spans and a torch
    profiler capture.

    ``host``: path to an exported host chrome trace, a list of
    HostTracer event tuples, or None (= the live tracer buffer).
    ``device_trace_dir``: a torch profiler chrome export — the file
    ``prof.export_chrome_trace(path)`` wrote, or a directory of
    ``*.pt.trace.json`` files; None or a directory without captures
    yields a host-only trace (still valid JSON).  Its events keep their
    names (span ranges decoded into ``args``), its processes are
    renumbered from 1000 upward per (file, pid).
    ``extra``: already-formed chrome event dicts appended verbatim;
    callers own pid disjointness from the device range (>= 1000).

    Returns summary counts: ``{"host_events", "device_events",
    "device_processes", "extra_events", "path"}``.
    """
    events = [{"ph": "M", "pid": 0, "name": "process_name",
               "args": {"name": "host (paddle_tpu_torch.runtime."
                                "HostTracer)"}}]
    if host is None:
        host_events = _host_events_as_chrome(rt.HostTracer.events())
    elif isinstance(host, str):
        with open(host) as f:
            host_events = json.load(f).get("traceEvents", [])
        _decode_names(host_events)
    else:
        host_events = _host_events_as_chrome(host)
    events.extend(host_events)
    n_extra = 0
    if extra is not None:
        for e in extra:
            events.append(e)
            if e.get("ph") != "M":
                n_extra += 1

    n_dev = 0
    pid_map = {}
    if device_trace_dir:
        for path in _profiler_exports(device_trace_dir):
            for e in _load_trace(path):
                pid = e.get("pid")
                if pid is None:
                    continue
                key = (path, pid)
                if key not in pid_map:
                    pid_map[key] = 1000 + len(pid_map)
                e = dict(e)
                e["pid"] = pid_map[key]
                _decode_names([e])
                events.append(e)
                if e.get("ph") != "M":
                    n_dev += 1
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
    return {"host_events": len(host_events), "device_events": n_dev,
            "device_processes": len(pid_map), "extra_events": n_extra,
            "path": out_path}
