"""paddle_tpu_torch.observability — runtime metrics and structured
tracing of the port, the JAX package's ``paddle_tpu.observability``
without its fleet plane:

- :mod:`~paddle_tpu_torch.observability.metrics` — a process-wide
  ``MetricsRegistry`` of named Counter/Gauge/Histogram instruments with
  Prometheus-text and JSON exporters and ``snapshot()``/
  ``diff_snapshots()``; the serving engine records into it.
- :mod:`~paddle_tpu_torch.observability.spans` — ``span(name, **attrs)``
  ranges over ``runtime.HostTracer`` (and ``record_function`` ranges
  while a torch profiler runs) and ``merge_chrome_traces`` to stitch the
  host trace with a torch profiler export into one Perfetto file.
- :mod:`~paddle_tpu_torch.observability.flightrec` — the per-request
  ``FlightRecorder``: a bounded ring of structured lifecycle events the
  serving engine emits, with ``timeline()``/``explain()`` queries and a
  JSON export the JAX package's readers accept.
- :mod:`~paddle_tpu_torch.observability.timeseries` — the
  ``TimeSeriesRecorder``: bounded step-indexed instrument samples with
  windowed aggregates and JSON export.
"""

from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, DEFAULT_BUCKETS, NAME_RE,
    diff_snapshots, get_registry,
)
from .spans import (  # noqa: F401
    format_span_name, instant, merge_chrome_traces, parse_span_name, span,
)
from .flightrec import (  # noqa: F401
    EVENT_KINDS, FlightEvent, FlightRecord, FlightRecorder,
    explain_events, load_flight_record,
)
from .timeseries import TimeSeriesRecorder  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_BUCKETS",
    "NAME_RE", "diff_snapshots", "get_registry",
    "span", "instant", "format_span_name", "parse_span_name",
    "merge_chrome_traces",
    "EVENT_KINDS", "FlightEvent", "FlightRecord", "FlightRecorder",
    "explain_events", "load_flight_record",
    "TimeSeriesRecorder",
]
