"""Step-indexed time-series over the metrics registry: a copy of
``paddle_tpu/observability/timeseries.py``.

``MetricsRegistry.snapshot()`` answers "where are the counters NOW";
``diff_snapshots`` answers "what moved between two moments".  Neither
answers the operational question a fleet dashboard asks — "what did
queue depth / token throughput / TPOT look like over the last K
steps" — without the caller keeping its own snapshot history.
``TimeSeriesRecorder`` is that history, kept deliberately in the
repo's deterministic idiom:

- **step-indexed, not wall-indexed** — samples are keyed on the
  engine/router scheduler step the caller passes to ``sample(step)``,
  never on the clock.  Two replays of one trace sample at identical
  steps and produce byte-identical series; the per-sample ``wall``
  field is report-only (the ONE field excluded from determinism
  comparisons, exactly like ``FlightEvent.wall``).
- **bounded** — the ring is a ``deque(maxlen=capacity)``: overflow
  drops the OLDEST samples and ``dropped`` counts the loss, so an
  export is never silently partial (the ``FlightRecorder`` contract).
- **selected instruments** — the recorder samples a caller-chosen
  instrument subset (default: everything registered at first sample),
  each sample storing the instrument's cumulative values per label
  cell.  Cumulative, not deltas: a window aggregate between ANY two
  ring positions is then a subtraction, and a dropped sample loses
  resolution, not mass.
- **window aggregates** — ``aggregates()`` reduces the ring to
  counter deltas + per-step rates, gauge last/min/max (max is the
  honest PER-WINDOW high-water mark ``diff_snapshots`` cannot give —
  its ``hwm`` is process-lifetime), and histogram-delta quantiles via
  the same bucket interpolation the registry exports.

``sample()`` on a disabled recorder is one attribute load + bool test
(the metrics/flightrec disabled contract); the enabled path costs one
``_snap()`` per selected instrument, so keep the selection tight when
sampling every scheduler step.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      _quantile_from_buckets, get_registry)


class TimeSeriesRecorder:
    """Bounded ring of step-indexed instrument samples.

    One recorder per registry view (pass ``timeseries=`` to ``Router``
    to have it sampled once per router step).  Not thread-safe by
    design: the serving scheduler is single-threaded and the sample
    site runs on it.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None, *,
                 capacity: int = 512,
                 instruments: Optional[Sequence[str]] = None,
                 enabled: bool = True, clock=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._registry = (registry if registry is not None
                          else get_registry())
        self.capacity = int(capacity)
        self._enabled = bool(enabled)
        self._clock = clock if clock is not None else time.perf_counter
        # None = "everything registered at first sample" (resolved
        # lazily so construction order vs. instrument registration
        # does not matter); an explicit selection stays fixed
        self._names: Optional[List[str]] = (
            None if instruments is None else sorted(instruments))
        self._ring: deque = deque(maxlen=self.capacity)
        self.dropped = 0
        # histogram bucket bounds per name, captured at first sight so
        # aggregates can interpolate quantiles from stored buckets
        self._bounds: Dict[str, tuple] = {}

    # -- lifecycle --
    def enable(self):
        self._enabled = True

    def disable(self):
        """Freeze the recorder: ``sample`` becomes one attribute load
        + bool test (the <2% decode-loop contract)."""
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def instruments(self) -> List[str]:
        """The sampled instrument names (resolved selection)."""
        return list(self._resolve_names())

    def __len__(self) -> int:
        return len(self._ring)

    def _resolve_names(self) -> List[str]:
        if self._names is None:
            self._names = self._registry.names()
        return self._names

    # -- recording --
    def sample(self, step: int):
        """Record one sample keyed on the caller's scheduler ``step``.
        Every stored field except ``wall`` derives from instrument
        state — replaying a trace reproduces the series byte for
        byte."""
        if not self._enabled:
            return
        data: Dict[str, dict] = {}
        for name in self._resolve_names():
            inst = self._registry.get(name)
            if inst is None:
                continue
            snap = inst._snap()
            if isinstance(inst, Counter):
                data[name] = {"values": dict(snap["values"])}
            elif isinstance(inst, Gauge):
                data[name] = {"values": dict(snap["values"]),
                              "hwm": dict(snap["hwm"])}
            elif isinstance(inst, Histogram):
                if name not in self._bounds:
                    self._bounds[name] = tuple(snap["le"])
                data[name] = {"values": {
                    lk: {"count": c["count"], "sum": c["sum"],
                         "buckets": list(c["buckets"])}
                    for lk, c in snap["values"].items()}}
        if len(self._ring) == self.capacity:
            self.dropped += 1        # deque drops the oldest on append
        self._ring.append({"step": int(step), "wall": self._clock(),
                           "data": data})

    # -- queries --
    def samples(self) -> List[dict]:
        return list(self._ring)

    def steps(self) -> List[int]:
        return [s["step"] for s in self._ring]

    def series(self, name: str, label: str = "") -> List[tuple]:
        """One instrument cell as ``[(step, value), ...]`` over the
        ring — cumulative totals for counters, levels for gauges.
        ``label`` is the snapshot label key (``"tenant=a"``; empty for
        unlabeled instruments); steps where the cell did not exist
        yet are skipped."""
        out = []
        for s in self._ring:
            cell = s["data"].get(name, {}).get("values", {})
            if label in cell:
                v = cell[label]
                out.append((s["step"],
                            v if not isinstance(v, dict)
                            else v["count"]))
        return out

    def rates(self, name: str, label: str = "") -> List[tuple]:
        """Per-step rate between consecutive samples of a counter
        cell: ``[(step, delta / steps_elapsed), ...]``."""
        pts = self.series(name, label)
        out = []
        for (s0, v0), (s1, v1) in zip(pts, pts[1:]):
            dt = max(1, s1 - s0)
            out.append((s1, (v1 - v0) / dt))
        return out

    def aggregates(self) -> dict:
        """Whole-window reduction (oldest surviving sample -> newest):
        counters -> ``delta`` + ``rate_per_step``; gauges -> ``last``
        / ``min`` / ``max`` of the SAMPLED values (``max`` is the
        per-window high-water mark); histograms -> delta
        count/sum/p50/p95/p99 interpolated from the bucket deltas
        (cells whose window delta is empty drop, mirroring
        ``diff_snapshots``)."""
        if not self._ring:
            return {"steps": 0, "instruments": {}}
        first, last = self._ring[0], self._ring[-1]
        steps = max(1, last["step"] - first["step"])
        insts: Dict[str, dict] = {}
        for name in sorted(last["data"]):
            cur = last["data"][name]["values"]
            base = first["data"].get(name, {}).get("values", {})
            if name in self._bounds:                 # histogram
                bounds = self._bounds[name]
                cells = {}
                for lk, c in cur.items():
                    p = base.get(lk)
                    counts = list(c["buckets"])
                    count, total = c["count"], c["sum"]
                    if p is not None:
                        counts = [a - b for a, b in
                                  zip(counts, p["buckets"])]
                        count -= p["count"]
                        total -= p["sum"]
                    if count <= 0:
                        continue
                    cells[lk] = {
                        "count": count, "sum": total,
                        "p50": _quantile_from_buckets(
                            0.50, bounds, counts),
                        "p95": _quantile_from_buckets(
                            0.95, bounds, counts),
                        "p99": _quantile_from_buckets(
                            0.99, bounds, counts)}
                if cells:
                    insts[name] = {"type": "histogram", "values": cells}
            elif "hwm" in last["data"][name]:        # gauge
                mins: Dict[str, float] = {}
                maxs: Dict[str, float] = {}
                for s in self._ring:
                    for lk, v in s["data"].get(name, {}) \
                            .get("values", {}).items():
                        if lk not in mins or v < mins[lk]:
                            mins[lk] = v
                        if lk not in maxs or v > maxs[lk]:
                            maxs[lk] = v
                insts[name] = {"type": "gauge", "last": dict(cur),
                               "min": mins, "max": maxs}
            else:                                    # counter
                delta = {lk: v - base.get(lk, 0)
                         for lk, v in cur.items()
                         if v - base.get(lk, 0)}
                if delta:
                    insts[name] = {
                        "type": "counter", "delta": delta,
                        "rate_per_step": {lk: d / steps
                                          for lk, d in delta.items()}}
        return {"steps": steps,
                "first_step": first["step"], "last_step": last["step"],
                "samples": len(self._ring), "dropped": self.dropped,
                "instruments": insts}

    # -- export --
    def to_dict(self, *, drop_wall: bool = False) -> dict:
        """The full ring as a JSON-ready dict.  ``drop_wall=True``
        zeroes the report-only wall stamps — the canonical form two
        replays of one trace must agree on byte for byte."""
        samples = []
        for s in self._ring:
            samples.append({"step": s["step"],
                            "wall": 0.0 if drop_wall else s["wall"],
                            "data": s["data"]})
        return {"version": 1, "capacity": self.capacity,
                "dropped": self.dropped,
                "instruments": list(self._resolve_names()),
                "bounds": {k: list(v)
                           for k, v in sorted(self._bounds.items())},
                "samples": samples}

    def export(self, path: str) -> dict:
        """Write the ring as JSON (sorted keys, so the file itself is
        deterministic modulo wall); returns the header fields."""
        d = self.to_dict()
        with open(path, "w") as f:
            json.dump(d, f, sort_keys=True)
        return {"version": d["version"], "capacity": d["capacity"],
                "dropped": d["dropped"], "n_samples": len(d["samples"])}
