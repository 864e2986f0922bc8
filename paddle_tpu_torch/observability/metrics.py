"""Process-wide metrics registry (Counter / Gauge / Histogram): a copy
of ``paddle_tpu/observability/metrics.py`` (standard library only), so
the snapshot, ``diff_snapshots`` and the Prometheus text are byte-equal
to the JAX package's for the same sequence of operations.

The always-on observability substrate the reference provides through
``paddle/fluid/platform/profiler`` stat tables and benchmark counters,
rebuilt as a pull-model instrument registry: hot paths (serving
scheduler, train step, kernel dispatch gates) record into named
instruments; exporters render the registry as Prometheus text or JSON,
and ``snapshot()``/``diff_snapshots()`` give benches a cheap
before/after delta without resetting anything.

Design constraints (the serving decode loop runs instrument updates on
every scheduler iteration):

- **near-zero cost when disabled** — every mutator starts with one
  attribute load + bool test on the owning registry; no locking, no
  label resolution, no timestamping happens on the disabled path.
- **thread-safe** — one lock per instrument guards value mutation;
  registration holds the registry lock.  Reads for export take the same
  locks, so snapshots are internally consistent per instrument.
- **fixed-bucket histograms** — observation cost is a bisect over a
  static bound list; p50/p95/p99 are interpolated from the buckets at
  EXPORT time, never maintained online.

Instrument names must match ``^[a-z][a-z0-9_.]*$`` (dots namespace the
subsystem: ``serving.queue_depth``); the Prometheus exporter maps dots
to underscores.  Re-registering a name returns the existing instrument
when the type and label names agree and raises otherwise —
``tools/check_metrics_names.py`` lints the tree for both rules
statically.
"""

from __future__ import annotations

import bisect
import itertools
import json
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

NAME_RE = re.compile(r"^[a-z][a-z0-9_.]*$")

# monotone registry ids: the stable dedupe identity (see
# ``MetricsRegistry.dedupe_key``)
_REGISTRY_UID = itertools.count()

# default buckets cover sub-ms kernel dispatch through multi-second
# request latencies (seconds)
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_NO_LABELS = ()


def _esc_label_value(v) -> str:
    """Escape a label value for the ``k=v,k2=v2`` snapshot key so
    values containing ``,``/``=``/newlines cannot fabricate extra
    labels when the key is re-parsed (percent-encoding; inverse is
    ``_unesc_label_value``)."""
    return (str(v).replace("%", "%25").replace(",", "%2C")
            .replace("=", "%3D").replace("\n", "%0A"))


def _unesc_label_value(v: str) -> str:
    return (v.replace("%0A", "\n").replace("%3D", "=")
            .replace("%2C", ",").replace("%25", "%"))


def _label_key(label_names: Tuple[str, ...], label_values: Tuple) -> str:
    if not label_names:
        return ""
    return ",".join(f"{k}={_esc_label_value(v)}"
                    for k, v in zip(label_names, label_values))


class _Instrument:
    """Common instrument plumbing: identity, labels, child lookup."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help_str: str,
                 label_names: Tuple[str, ...]):
        self._reg = registry
        self.name = name
        self.help = help_str
        self.label_names = label_names
        self._lock = threading.Lock()

    def _resolve_labels(self, kwargs) -> Tuple:
        # deliberately NOT run on the disabled fast path (unlike the
        # cheap amount<0 check): sorting/comparing label names is real
        # work, and the disabled mode's contract is one attribute load
        # + bool test per call — mislabeled calls surface on enable
        if tuple(sorted(kwargs)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"{self.name}: labels {sorted(kwargs)} do not match "
                f"declared label names {sorted(self.label_names)}")
        return tuple(str(kwargs[k]) for k in self.label_names)


class Counter(_Instrument):
    """Monotonically increasing count (events, tokens, cache misses)."""

    kind = "counter"

    def __init__(self, registry, name, help_str="",
                 label_names: Tuple[str, ...] = _NO_LABELS):
        super().__init__(registry, name, help_str, label_names)
        self._vals: Dict[Tuple, float] = {}

    def inc(self, amount: float = 1, **labels):
        # validate BEFORE the enabled check: a buggy negative delta
        # must not pass silently in disabled mode only to start raising
        # when someone turns metrics on
        if amount < 0:
            raise ValueError(f"{self.name}: counter increment must be >= 0")
        if not self._reg._enabled:
            return
        key = self._resolve_labels(labels) if (labels or self.label_names) \
            else _NO_LABELS
        with self._lock:
            self._vals[key] = self._vals.get(key, 0) + amount

    def value(self, **labels) -> float:
        key = self._resolve_labels(labels) if (labels or self.label_names) \
            else _NO_LABELS
        with self._lock:
            return self._vals.get(key, 0)

    def total(self) -> float:
        """Sum over every label set (``== value()`` for an unlabeled
        counter) — the label-agnostic reading consumers like the
        serving engine's ``stats()`` delta need from a labeled
        counter, whose ``value()`` requires one exact label set."""
        with self._lock:
            return float(sum(self._vals.values()))

    def _snap(self) -> dict:
        with self._lock:
            vals = dict(self._vals)
        return {"type": self.kind, "help": self.help,
                "labels": list(self.label_names),
                "values": {_label_key(self.label_names, k): v
                           for k, v in vals.items()}}


class Gauge(_Instrument):
    """Point-in-time level (queue depth, slot occupancy).  Tracks a
    high-water mark alongside the current value (``hwm``) so peaks
    survive between scrapes."""

    kind = "gauge"

    def __init__(self, registry, name, help_str="",
                 label_names: Tuple[str, ...] = _NO_LABELS):
        super().__init__(registry, name, help_str, label_names)
        self._vals: Dict[Tuple, float] = {}
        self._hwm: Dict[Tuple, float] = {}

    def set(self, value: float, **labels):
        if not self._reg._enabled:
            return
        key = self._resolve_labels(labels) if (labels or self.label_names) \
            else _NO_LABELS
        with self._lock:
            self._vals[key] = value
            if value > self._hwm.get(key, float("-inf")):
                self._hwm[key] = value

    def add(self, delta: float, **labels):
        if not self._reg._enabled:
            return
        key = self._resolve_labels(labels) if (labels or self.label_names) \
            else _NO_LABELS
        with self._lock:
            v = self._vals.get(key, 0) + delta
            self._vals[key] = v
            if v > self._hwm.get(key, float("-inf")):
                self._hwm[key] = v

    def value(self, **labels) -> float:
        key = self._resolve_labels(labels) if (labels or self.label_names) \
            else _NO_LABELS
        with self._lock:
            return self._vals.get(key, 0)

    def hwm(self, **labels) -> float:
        key = self._resolve_labels(labels) if (labels or self.label_names) \
            else _NO_LABELS
        with self._lock:
            return self._hwm.get(key, 0)

    def _snap(self) -> dict:
        with self._lock:
            vals, hwm = dict(self._vals), dict(self._hwm)
        return {"type": self.kind, "help": self.help,
                "labels": list(self.label_names),
                "values": {_label_key(self.label_names, k): v
                           for k, v in vals.items()},
                "hwm": {_label_key(self.label_names, k): v
                        for k, v in hwm.items()}}


def _quantile_from_buckets(q: float, bounds: Sequence[float],
                           counts: Sequence[float]) -> float:
    """Prometheus-style histogram_quantile: linear interpolation inside
    the bucket holding the q-th observation; the +Inf bucket clamps to
    the largest finite bound."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        prev_cum = cum
        cum += c
        if cum >= rank:
            if i >= len(bounds):            # +Inf bucket
                return float(bounds[-1]) if bounds else 0.0
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            if c <= 0:
                return float(hi)
            return float(lo + (hi - lo) * (rank - prev_cum) / c)
    return float(bounds[-1]) if bounds else 0.0


class Histogram(_Instrument):
    """Fixed-bucket distribution with interpolated p50/p95/p99."""

    kind = "histogram"

    def __init__(self, registry, name, help_str="",
                 label_names: Tuple[str, ...] = _NO_LABELS,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(registry, name, help_str, label_names)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError(f"{self.name}: histogram needs >= 1 bucket")
        self.bounds = bounds
        # per label-set: [bucket counts (len bounds + 1 for +Inf), count, sum]
        self._vals: Dict[Tuple, list] = {}

    def observe(self, value: float, **labels):
        if not self._reg._enabled:
            return
        key = self._resolve_labels(labels) if (labels or self.label_names) \
            else _NO_LABELS
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            cell = self._vals.get(key)
            if cell is None:
                cell = [[0] * (len(self.bounds) + 1), 0, 0.0]
                self._vals[key] = cell
            cell[0][i] += 1
            cell[1] += 1
            cell[2] += value

    def summary(self, **labels) -> dict:
        key = self._resolve_labels(labels) if (labels or self.label_names) \
            else _NO_LABELS
        with self._lock:
            cell = self._vals.get(key)
            if cell is None:
                return {"count": 0, "sum": 0.0, "p50": 0.0, "p95": 0.0,
                        "p99": 0.0}
            counts, count, total = list(cell[0]), cell[1], cell[2]
        return {
            "count": count, "sum": total,
            "p50": _quantile_from_buckets(0.50, self.bounds, counts),
            "p95": _quantile_from_buckets(0.95, self.bounds, counts),
            "p99": _quantile_from_buckets(0.99, self.bounds, counts),
        }

    def _snap(self) -> dict:
        with self._lock:
            vals = {k: [list(c[0]), c[1], c[2]]
                    for k, c in self._vals.items()}
        out = {}
        for k, (counts, count, total) in vals.items():
            out[_label_key(self.label_names, k)] = {
                "count": count, "sum": total, "buckets": counts,
                "p50": _quantile_from_buckets(0.50, self.bounds, counts),
                "p95": _quantile_from_buckets(0.95, self.bounds, counts),
                "p99": _quantile_from_buckets(0.99, self.bounds, counts),
            }
        return {"type": self.kind, "help": self.help,
                "labels": list(self.label_names),
                "le": [*self.bounds], "values": out}


class MetricsRegistry:
    """Named instrument registry.  One process-wide default instance
    (``get_registry()``); subsystems may hold private registries (tests
    pass a fresh one into ``ServingEngine`` for isolation)."""

    def __init__(self, enabled: bool = True):
        self._enabled = bool(enabled)
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}
        # stable in-process identity: consumers that deduplicate
        # SHARED registries (fleet_snapshot, the SLO monitor) key on
        # this instead of id() — a remote replica's registry shim can
        # carry the server registry's key across the wire, where
        # object identity is meaningless (every fetch is a fresh dict)
        self.dedupe_key = f"reg{next(_REGISTRY_UID)}"

    # -- lifecycle --
    def enable(self):
        self._enabled = True

    def disable(self):
        """Freeze every instrument: mutators become one-bool-check
        no-ops (the < 2% decode-loop overhead contract)."""
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    # -- registration --
    def _register(self, cls, name: str, help_str: str,
                  label_names: Iterable[str], **kw):
        if not NAME_RE.match(name):
            raise ValueError(
                f"invalid instrument name {name!r}: must match "
                f"{NAME_RE.pattern}")
        label_names = tuple(label_names)
        with self._lock:
            existing = self._instruments.get(name)
            if existing is not None:
                if type(existing) is not cls:
                    raise ValueError(
                        f"instrument {name!r} already registered as "
                        f"{existing.kind}, cannot re-register as "
                        f"{cls.kind}")
                if existing.label_names != label_names:
                    raise ValueError(
                        f"instrument {name!r} already registered with "
                        f"labels {existing.label_names}, got {label_names}")
                if cls is Histogram:
                    want = tuple(sorted(float(b)
                                        for b in kw.get("buckets", ())))
                    if want != existing.bounds:
                        raise ValueError(
                            f"histogram {name!r} already registered "
                            f"with buckets {existing.bounds}, got "
                            f"{want} — silently keeping the old bounds "
                            f"would clamp the new site's observations")
                return existing
            inst = cls(self, name, help_str, label_names, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help_str: str = "",
                labels: Iterable[str] = _NO_LABELS) -> Counter:
        return self._register(Counter, name, help_str, labels)

    def gauge(self, name: str, help_str: str = "",
              labels: Iterable[str] = _NO_LABELS) -> Gauge:
        return self._register(Gauge, name, help_str, labels)

    def histogram(self, name: str, help_str: str = "",
                  labels: Iterable[str] = _NO_LABELS,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help_str, labels,
                              buckets=buckets)

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._instruments.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._instruments)

    # -- export --
    def snapshot(self) -> dict:
        """Plain-dict view of every instrument's current values —
        JSON-serializable, suitable for bench deltas via
        ``diff_snapshots``."""
        with self._lock:
            insts = list(self._instruments.values())
        return {inst.name: inst._snap() for inst in insts}

    def to_json(self, indent=None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus_text(self) -> str:
        """Prometheus exposition format.  Dots become underscores;
        label VALUES are double-quoted and escaped per the exposition
        grammar; histograms emit ``_bucket``/``_sum``/``_count`` series
        plus an interpolated ``<name>_quantile`` GAUGE family (quantile
        as a label) — bare-name ``{quantile=...}`` samples under a
        histogram TYPE would be invalid exposition text and split into
        duplicate unknown families on parse."""
        def plab(lk: str) -> str:
            # snapshot label key "k=v,k2=v2" -> 'k="v",k2="v2"'
            if not lk:
                return ""
            parts = []
            for p in lk.split(","):
                k, _, v = p.partition("=")
                v = (_unesc_label_value(v).replace("\\", "\\\\")
                     .replace('"', '\\"').replace("\n", "\\n"))
                parts.append(f'{k}="{v}"')
            return ",".join(parts)

        lines: List[str] = []
        for name, snap in sorted(self.snapshot().items()):
            pname = name.replace(".", "_")
            if snap["help"]:
                lines.append(f"# HELP {pname} {snap['help']}")
            lines.append(f"# TYPE {pname} {snap['type']}")
            if snap["type"] in ("counter", "gauge"):
                for lk, v in sorted(snap["values"].items()):
                    lines.append(f"{pname}{{{plab(lk)}}} {v}" if lk
                                 else f"{pname} {v}")
            else:  # histogram
                bounds = snap["le"]
                qlines: List[str] = []
                for lk, cell in sorted(snap["values"].items()):
                    lp = plab(lk)
                    prefix = lp + "," if lp else ""
                    cum = 0
                    for b, c in zip(bounds, cell["buckets"]):
                        cum += c
                        lines.append(
                            f'{pname}_bucket{{{prefix}le="{b}"}} {cum}')
                    cum += cell["buckets"][-1]
                    lines.append(
                        f'{pname}_bucket{{{prefix}le="+Inf"}} {cum}')
                    lines.append(f"{pname}_sum{{{lp}}} {cell['sum']}" if lk
                                 else f"{pname}_sum {cell['sum']}")
                    lines.append(f"{pname}_count{{{lp}}} {cell['count']}"
                                 if lk else f"{pname}_count {cell['count']}")
                    for q in ("p50", "p95", "p99"):
                        qv = q[1:] if q != "p50" else "50"
                        qlines.append(
                            f'{pname}_quantile{{{prefix}quantile='
                            f'"0.{qv}"}} {cell[q]}')
                if qlines:
                    lines.append(f"# TYPE {pname}_quantile gauge")
                    lines.extend(qlines)
        return "\n".join(lines) + "\n"


def diff_snapshots(before: dict, after: dict) -> dict:
    """Delta between two ``MetricsRegistry.snapshot()`` dicts: counters
    and histogram buckets subtract (instruments absent from ``before``
    count from zero), gauges keep the ``after`` value (a level has no
    meaningful delta) plus the hwm.  Gauges that moved neither value
    nor hwm inside the window are dropped.  Caveat: ``hwm`` is the
    PROCESS-LIFETIME high-water mark, not a per-window peak — a window
    whose activity stayed below an earlier window's peak reports the
    earlier peak (tracking per-window peaks would need stateful
    watermark resets, which snapshots deliberately avoid).  The shape
    mirrors ``snapshot()`` so the same renderers work on deltas — this
    is what ``bench.py`` embeds per section."""
    out = {}
    for name, snap in after.items():
        prev = before.get(name)
        kind = snap["type"]
        if kind == "counter":
            pv = (prev or {}).get("values", {})
            # zero-delta label cells drop too: a section must not
            # re-report label combinations some earlier section moved
            vals = {k: v - pv.get(k, 0)
                    for k, v in snap["values"].items()
                    if v - pv.get(k, 0)}
            if vals:
                out[name] = {"type": kind, "values": vals}
        elif kind == "gauge":
            # include only gauges that MOVED during the window — a
            # bench section must not re-report levels some earlier
            # section set (value and hwm compared against ``before``)
            pv = (prev or {}).get("values", {})
            ph = (prev or {}).get("hwm", {})
            changed = {
                k: v for k, v in snap["values"].items()
                if pv.get(k) != v or
                ph.get(k) != snap.get("hwm", {}).get(k)}
            if changed:
                out[name] = {"type": kind, "values": changed,
                             "hwm": {k: snap.get("hwm", {}).get(k)
                                     for k in changed}}
        else:  # histogram
            bounds = snap["le"]
            pv = (prev or {}).get("values", {})
            vals = {}
            for lk, cell in snap["values"].items():
                pcell = pv.get(lk)
                counts = list(cell["buckets"])
                count, total = cell["count"], cell["sum"]
                if pcell is not None:
                    counts = [c - p for c, p in zip(counts,
                                                    pcell["buckets"])]
                    count -= pcell["count"]
                    total -= pcell["sum"]
                if count <= 0:
                    continue
                vals[lk] = {
                    "count": count, "sum": total,
                    "p50": _quantile_from_buckets(0.50, bounds, counts),
                    "p95": _quantile_from_buckets(0.95, bounds, counts),
                    "p99": _quantile_from_buckets(0.99, bounds, counts),
                }
            if vals:
                out[name] = {"type": kind, "values": vals}
    return out


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry every built-in instrument
    records into unless handed a private one."""
    return _default_registry
