"""Fleet observability plane: cross-replica trace stitching + the
per-tenant SLO burn-rate monitor.  A copy of
``paddle_tpu/observability/fleet.py`` (standard library only): the
stitched records, merged registry snapshots and alerts are the JAX
package's for the same inputs.

The deployment unit is a FLEET — a ``Router`` over N
replicas with failover and exact-bytes migration — but each replica
keeps its own ``FlightRecorder`` and ``MetricsRegistry``, so a request
that fails over mid-flight has its story split across recorders and
there is no windowed view of SLO attainment at all.  This module is
the missing fleet layer, in the repo's deterministic idiom:

- **stitching** (:func:`stitch_flight_records`) — correlates events
  by request id across the router's recorder and every replica's
  recorder into ONE ordered record.  No global clock is needed: the
  router's ``route``/``migrate``/``retry`` events carry the
  destination replica AND the engine-side request id it assigned
  (``rid``), and within one replica's ring each ``submit`` opens a
  new binding generation, so (replica, engine rid, generation) maps
  to exactly one router-global id even when engine ids collide across
  replicas or are reused after ``crash_reset``.  Ordering is by
  ``(step, replica, seq)`` — steps are scheduler iterations, shared
  by construction in the router's lockstep loop, and per-source
  ``seq`` breaks ties deterministically.
- **fleet explain** (:meth:`StitchedRecord.explain`) — narrates the
  full cross-replica journey: "prefilled on engine 0, replica 0
  killed at step 12, migrated 6 blocks to engine 1, finished at
  step 19".
- **one Perfetto file** (:meth:`StitchedRecord.export_chrome_trace`)
  — one process lane per replica (pid = replica index, the router
  lane after them), one thread per router-global request id, through
  the existing ``merge_chrome_traces`` writer.
- **burn-rate monitoring** (:class:`SLOBurnRateMonitor`) — windowed
  SLO attainment per tenant over the existing
  ``serving.slo.attained/missed`` counters, SRE-style burn rate
  (window miss rate over the error budget ``1 - slo_target``),
  lifetime error-budget accounting, and a CLOSED alert vocabulary
  (``ALERT_KINDS``).  Alerts are emitted as
  flight-recorder events (kind ``alert``) so they are
  replay-deterministic: same trace, same alert, same step.
- **registry federation** (:func:`merge_registry_snapshots`) — merges
  per-replica ``snapshot()`` dicts into one snapshot-shaped dict with
  a ``replica=<i>`` label prefixed onto every cell, which is what
  ``Router.fleet_snapshot()`` returns and ``tools/serving_top.py``
  renders.
"""

from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .flightrec import (ENGINE_EVENT, FlightEvent, FlightRecord,
                        FlightRecorder, _plural, events_from_record,
                        load_flight_record)
from .metrics import (MetricsRegistry, _esc_label_value,
                      _unesc_label_value, get_registry)

# the closed vocabulary of fleet alerts (every entry has a literal
# ``alerts.inc(kind=...)`` site in SLOBurnRateMonitor.observe):
# burn_rate          windowed SLO miss rate crossed the burn threshold
#                    for one tenant (attrs: tenant, burn)
# budget_exhausted   a tenant's lifetime misses consumed its whole
#                    error budget (attrs: tenant, missed, total)
# replica_unhealthy  a replica left the routing set (attrs: engine)
# queue_saturation   the router-held queue reached its saturation
#                    depth (attrs: depth, threshold)
ALERT_KINDS = ("burn_rate", "budget_exhausted", "replica_unhealthy",
               "queue_saturation")

# the router's process lane label in stitched records (engine events
# carry their integer replica index)
ROUTER_LANE = "router"


def orphan_id(replica: int, rid: int) -> int:
    """Deterministic synthetic global id for an engine-local request
    no router binding claims (health probes submitted directly to the
    replica): distinct from every router id (>= 0) and from
    ``ENGINE_EVENT`` (-1), unique per (replica, rid)."""
    return -(1000 + 1000 * int(replica) + int(rid))


@dataclass
class StitchedEvent(FlightEvent):
    """One stitched event: a :class:`FlightEvent` whose ``request`` is
    the router-GLOBAL id, annotated with the source lane (``replica``:
    int replica index, or ``"router"``) and the id the source record
    used (``source_request`` — the per-engine rid, which may collide
    across replicas; the stitcher's whole job is resolving it)."""
    replica: object = None
    source_request: int = 0

    def as_dict(self) -> dict:
        d = super().as_dict()
        d["replica"] = self.replica
        d["source_request"] = self.source_request
        return d


def _load_source(src) -> Tuple[List[FlightEvent], int]:
    """Normalize one stitch input to ``(events, dropped)``.  Accepts a
    live :class:`FlightRecorder`, an export path, a parsed export
    dict, or an event list (a :class:`FlightRecord` carries its own
    drop count; a bare list counts as complete)."""
    if isinstance(src, FlightRecorder):
        return src.events(), src.dropped
    if isinstance(src, str):
        rec = load_flight_record(src)
        return list(rec), rec.dropped
    if isinstance(src, dict):
        return events_from_record(src), int(src.get("dropped", 0))
    return list(src), int(getattr(src, "dropped", 0))


def stitch_flight_records(records: Sequence, *,
                          router=None) -> "StitchedRecord":
    """Correlate per-replica flight records (list index = replica
    index) and the router's record into one :class:`StitchedRecord`.

    With a ``router`` record, engine events are re-keyed to
    router-global ids via the binding map its ``route`` / ``migrate``
    / ``retry`` events carry (``engine=`` + ``rid=`` attrs), FIFO per
    (replica, rid) across submit generations; engine requests no
    binding claims (direct submissions such as health probes) get
    :func:`orphan_id`.  Without one, engine ids pass through verbatim
    — exact for a single replica, ambiguous across several (the
    caller was warned).  Events keep their source ``step``/``seq``
    and order by ``(step, lane, seq)``, router lane first within a
    step (the router routes before it steps its engines)."""
    srcs = [_load_source(r) for r in records]
    router_events: Optional[List[FlightEvent]] = None
    dropped: Dict[str, int] = {}
    if router is not None:
        router_events, rdrop = _load_source(router)
        dropped[ROUTER_LANE] = rdrop
    for i, (_evs, drop) in enumerate(srcs):
        dropped[str(i)] = drop

    # (replica, engine rid) -> router ids, in router emission order:
    # the k-th binding of a pair serves that pair's k-th submit
    # generation on the replica
    bindings: Dict[Tuple[int, int], List[int]] = {}
    if router_events is not None:
        for e in sorted(router_events, key=lambda e: e.seq):
            if e.kind not in ("route", "migrate", "retry",
                              "handoff"):
                continue
            ei, rid = e.attrs.get("engine"), e.attrs.get("rid")
            if ei is None or rid is None:
                continue
            bindings.setdefault((int(ei), int(rid)), []) \
                .append(e.request)

    out: List[StitchedEvent] = []
    if router_events is not None:
        for e in router_events:
            out.append(StitchedEvent(
                e.seq, e.step, e.request, e.kind, e.wall,
                dict(e.attrs), ROUTER_LANE, e.request))
    for i, (evs, _drop) in enumerate(srcs):
        gen: Dict[int, int] = {}
        for e in sorted(evs, key=lambda e: e.seq):
            if e.request == ENGINE_EVENT:
                gid = ENGINE_EVENT
            elif router_events is None:
                gid = e.request
            else:
                if e.kind == "submit":
                    gen[e.request] = gen.get(e.request, -1) + 1
                g = gen.get(e.request, 0)
                blist = bindings.get((i, e.request), [])
                gid = (blist[g] if g < len(blist)
                       else orphan_id(i, e.request))
            out.append(StitchedEvent(
                e.seq, e.step, gid, e.kind, e.wall, dict(e.attrs),
                i, e.request))

    def lane_rank(e: StitchedEvent) -> int:
        return -1 if e.replica == ROUTER_LANE else int(e.replica)

    out.sort(key=lambda e: (e.step, lane_rank(e), e.seq))
    return StitchedRecord(out, replicas=len(srcs), dropped=dropped)


class StitchedRecord:
    """The stitched fleet record: one ordered event list spanning the
    router and every replica, keyed by router-global request ids."""

    def __init__(self, events: List[StitchedEvent], *, replicas: int,
                 dropped: Optional[Dict[str, int]] = None):
        self.events = list(events)
        self.replicas = int(replicas)
        self.dropped = dict(dropped or {})

    @property
    def dropped_total(self) -> int:
        return sum(self.dropped.values())

    def __len__(self) -> int:
        return len(self.events)

    def request_ids(self) -> List[int]:
        """Router-global ids (orphans and engine-scoped lanes
        excluded)."""
        return sorted({e.request for e in self.events
                       if e.request >= 0})

    def timeline(self, request_id: int) -> List[StitchedEvent]:
        return [e for e in self.events if e.request == request_id]

    # -- narration --
    def explain(self, request_id: int) -> str:
        """The request's full cross-replica journey as one sentence —
        every engine-side clause names its replica, failover hops
        name source and destination, and a ring that dropped events
        anywhere in the fleet is called out (the story may have
        holes)."""
        tl = self.timeline(request_id)
        if not tl:
            note = (f"; the fleet's rings dropped "
                    f"{_plural(self.dropped_total, 'event')}"
                    if self.dropped_total else "")
            return (f"request {request_id}: no events in the stitched "
                    f"record (wrong id, or the rings dropped them)"
                    + note)
        parts: List[str] = []
        # per-replica-segment accumulators (chunks/blocks/verifies are
        # per-dispatch events — a sentence per dispatch would bury the
        # journey, so they aggregate until the story changes lanes)
        seg_rep: object = None
        chunks = blocks = accepted = rejected = verifies = 0

        def flush():
            nonlocal chunks, blocks, accepted, rejected, verifies
            if chunks:
                parts.append(f"prefilled in {_plural(chunks, 'chunk')} "
                             f"on engine {seg_rep}")
                chunks = 0
            if verifies:
                parts.append(
                    f"{_plural(accepted, 'spec position')} accepted / "
                    f"{rejected} rejected over "
                    f"{_plural(verifies, 'verify forward')} on engine "
                    f"{seg_rep}")
                accepted = rejected = verifies = 0
            if blocks:
                parts.append(f"rode {_plural(blocks, 'decode block')} "
                             f"on engine {seg_rep}")
                blocks = 0

        has_router = any(e.replica == ROUTER_LANE for e in tl)
        for e in tl:
            rep, k, a = e.replica, e.kind, e.attrs
            if rep != ROUTER_LANE and rep != seg_rep:
                flush()
                seg_rep = rep
            if k == "prefill_chunk":
                chunks += 1
                continue
            if k == "decode_block":
                blocks += 1
                continue
            if k == "spec_verify":
                verifies += 1
                accepted += int(a.get("accepted", 0))
                rejected += int(a.get("rejected", 0))
                continue
            flush()
            if k == "submit":
                if rep == ROUTER_LANE:
                    parts.append(f"submitted at step {e.step}")
                elif not has_router:
                    parts.append(f"submitted at step {e.step} on "
                                 f"engine {rep}")
                # engine-side submit after a router submit is the
                # dispatch itself — the route clause already tells it
            elif k == "route":
                clause = f"routed to engine {a.get('engine', '?')}"
                det = []
                if int(a.get("affinity", 0)):
                    det.append(f"prefix affinity {a['affinity']} "
                               f"tokens")
                if a.get("adapter_hit"):
                    det.append("adapter resident")
                if "reason" in a:
                    det.append(f"by {a['reason']}")
                if det:
                    clause += " (" + ", ".join(det) + ")"
                parts.append(clause)
            elif k == "admit":
                parts.append(f"admitted on engine {rep} at step "
                             f"{e.step} into slot {a.get('slot', '?')}")
            elif k == "prefix_hit":
                parts.append(
                    f"prefix hit ({a.get('tier', '?')}) on engine "
                    f"{rep}: "
                    f"{_plural(int(a.get('blocks', 0)), 'cached block')}"
                    f" mapped at step {e.step}")
            elif k == "preempt":
                parts.append(
                    f"preempted on engine {rep} at step {e.step} "
                    f"({_plural(int(a.get('blocks', 0)), 'block')} to "
                    f"host)")
            elif k == "swap_in":
                parts.append(
                    f"resumed on engine {rep} at step {e.step} via "
                    f"{_plural(int(a.get('blocks', 0)), 'host block')}")
            elif k == "fail":
                if a.get("terminal"):
                    nr = int(a.get("retries", 0))
                    parts.append(
                        f"failed terminally at step {e.step} (retry "
                        f"budget exhausted after {nr} "
                        f"{'retry' if nr == 1 else 'retries'})")
                elif a.get("fault") == "kill":
                    parts.append(f"replica {a.get('engine', '?')} "
                                 f"killed at step {e.step}")
                else:
                    parts.append(
                        f"replica {a.get('engine', '?')} failed under "
                        f"{a.get('fault', '?')} at step {e.step}")
            elif k == "migrate":
                parts.append(
                    f"migrated "
                    f"{_plural(int(a.get('blocks', 0)), 'block')} to "
                    f"engine {a.get('engine', '?')} at exact bytes")
            elif k == "retry":
                how = ("recomputed from prompt"
                       if a.get("path") == "recompute" else "re-queued")
                parts.append(
                    f"failed over to engine {a.get('engine', '?')} "
                    f"({how}, attempt {a.get('attempt', '?')})")
            elif k == "handoff":
                if rep == ROUTER_LANE:
                    parts.append(
                        f"prefilled on engine {a.get('src', '?')}, "
                        f"handed off "
                        f"{_plural(int(a.get('blocks', 0)), 'block')} "
                        f"to engine {a.get('engine', '?')} at "
                        f"chunk-final")
                elif not has_router:
                    parts.append(
                        f"handed off "
                        f"{_plural(int(a.get('blocks', 0)), 'block')} "
                        f"at chunk-final from engine {rep}")
                # engine-side handoff after a router handoff is the
                # same hop — the router clause names both endpoints
            elif k == "finish":
                extra = (f" after {_plural(int(a['tokens']), 'token')}"
                         if "tokens" in a else "")
                where = (f" on engine {rep}" if rep != ROUTER_LANE
                         else "")
                parts.append(f"finished at step {e.step}{extra}{where}")
            elif k == "alert":
                parts.append(f"alert {a.get('kind', '?')} at step "
                             f"{e.step}")
            elif k in ("timeout", "shed", "cancel"):
                verb = {"timeout": "timed out", "shed": "shed",
                        "cancel": "cancelled"}[k]
                parts.append(f"{verb} at step {e.step}")
        flush()
        text = f"request {request_id}: " + "; ".join(parts)
        if self.dropped_total:
            worst = ", ".join(
                f"{'router' if k == ROUTER_LANE else 'replica ' + k}: "
                f"{v}" for k, v in sorted(self.dropped.items()) if v)
            text += (f" [rings dropped "
                     f"{_plural(self.dropped_total, 'event')} "
                     f"({worst}) — the story may have holes]")
        return text

    # -- export --
    def to_dict(self, *, drop_wall: bool = False) -> dict:
        """JSON-ready form.  ``drop_wall=True`` zeroes the report-only
        wall stamps — the canonical form two replays of one trace
        agree on byte for byte."""
        evs = []
        for e in self.events:
            d = e.as_dict()
            if drop_wall:
                d["wall"] = 0.0
            evs.append(d)
        return {"version": 1, "replicas": self.replicas,
                "dropped": dict(sorted(self.dropped.items())),
                "n_events": len(self.events), "events": evs}

    def export(self, path: str) -> dict:
        d = self.to_dict()
        with open(path, "w") as f:
            json.dump(d, f, sort_keys=True)
        return {"version": 1, "replicas": self.replicas,
                "n_events": len(self.events),
                "dropped": dict(self.dropped)}

    def chrome_events(self) -> list:
        """The stitched record as chrome event dicts: one PROCESS lane
        per replica (pid = replica index; the router lane rides
        pid = ``replicas``), one thread per router-global request id,
        instants named ``flightrec.<kind>`` with attrs in ``args`` —
        ready for ``merge_chrome_traces(out, host=[], extra=...)``."""
        out = []
        for pid in range(self.replicas):
            out.append({"ph": "M", "pid": pid, "name": "process_name",
                        "args": {"name": f"replica {pid}"}})
        rpid = self.replicas
        out.append({"ph": "M", "pid": rpid, "name": "process_name",
                    "args": {"name": "router"}})
        for e in self.events:
            pid = rpid if e.replica == ROUTER_LANE else int(e.replica)
            out.append({
                "name": f"flightrec.{e.kind}", "ph": "i", "s": "t",
                "pid": pid, "tid": e.request, "ts": e.wall * 1e6,
                "args": {"request": e.request, "step": e.step,
                         "source_request": e.source_request,
                         **e.attrs}})
        return out

    def export_chrome_trace(self, out_path: str,
                            device_trace_dir: Optional[str] = None
                            ) -> dict:
        """One-call Perfetto export through the existing
        ``merge_chrome_traces`` writer (replica lanes via its
        ``extra=`` hook; a host pid-0 metadata line precedes replica
        0's — Perfetto keeps the last process_name, so the lane reads
        "replica 0")."""
        from .spans import merge_chrome_traces
        return merge_chrome_traces(out_path, host=[],
                                   device_trace_dir=device_trace_dir,
                                   extra=self.chrome_events())


# ---------------------------------------------------------------------------
# registry federation
# ---------------------------------------------------------------------------

def merge_registry_snapshots(snaps: Sequence, *,
                             label: str = "replica") -> dict:
    """Merge per-replica ``MetricsRegistry.snapshot()`` dicts into one
    snapshot-shaped dict, prefixing ``label=<value>`` onto every label
    key (the Prometheus-federation idiom: same series, one extra
    label).  ``snaps`` is a sequence of snapshots (values = list
    indices) or of ``(value, snapshot)`` pairs.  Instruments whose
    kind disagrees across snapshots raise — replicas are homogeneous
    by construction, so a disagreement is a bug, not data."""
    pairs = []
    for i, s in enumerate(snaps):
        if isinstance(s, tuple):
            pairs.append((str(s[0]), s[1]))
        else:
            pairs.append((str(i), s))
    out: dict = {}
    for val, snap in pairs:
        prefix = f"{label}={_esc_label_value(val)}"
        for name, inst in snap.items():
            tgt = out.get(name)
            if tgt is None:
                tgt = {"type": inst["type"], "help": inst.get("help", ""),
                       "labels": [label] + list(inst.get("labels", ())),
                       "values": {}}
                if inst["type"] == "gauge":
                    tgt["hwm"] = {}
                if inst["type"] == "histogram":
                    tgt["le"] = list(inst.get("le", ()))
                out[name] = tgt
            elif tgt["type"] != inst["type"]:
                raise ValueError(
                    f"instrument {name!r} is a {inst['type']} in "
                    f"{label}={val} but a {tgt['type']} in an earlier "
                    f"snapshot — replicas must be homogeneous")
            for lk, v in inst.get("values", {}).items():
                key = prefix + ("," + lk if lk else "")
                tgt["values"][key] = v
            for lk, v in inst.get("hwm", {}).items():
                key = prefix + ("," + lk if lk else "")
                tgt.setdefault("hwm", {})[key] = v
    return out


def _label_value(label_key: str, name: str) -> Optional[str]:
    """The ``name`` label's value out of a snapshot label key
    (``"class=p1,tenant=a"``), unescaped; None when absent."""
    for part in label_key.split(","):
        k, _, v = part.partition("=")
        if k == name:
            return _unesc_label_value(v)
    return None


# ---------------------------------------------------------------------------
# SLO burn-rate monitor
# ---------------------------------------------------------------------------

class _MonitorInstruments:
    """Registry handles for the monitor's observable surface."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        r = registry
        self.burn_rate = r.gauge(
            "serving.slo.burn_rate",
            "windowed SLO burn rate per tenant: the window's miss "
            "rate over the error budget (1 - slo_target); 1.0 burns "
            "the budget exactly at the sustainable rate, above it the "
            "budget drains early (SRE burn-rate alerting over the "
            "serving.slo.attained/missed counters)",
            labels=("tenant",))
        self.alerts = r.counter(
            "serving.alerts",
            "fleet monitor alerts fired, by closed kind vocabulary "
            "(ALERT_KINDS: burn_rate / budget_exhausted / "
            "replica_unhealthy / queue_saturation); each firing also "
            "rides the flight recorder as an 'alert' event, so alerts "
            "are replay-deterministic",
            labels=("kind",))
        self.monitor_steps = r.counter(
            "serving.fleet.monitor_steps",
            "SLOBurnRateMonitor.observe() calls (one per router step "
            "when attached via Router(monitor=...)) — the monitoring "
            "plane's own liveness signal")


class SLOBurnRateMonitor:
    """Windowed per-tenant SLO attainment + closed-vocabulary alerts.

    Reads the per-replica ``serving.slo.attained/missed{class,tenant}``
    counters (summed over classes and deduplicated registries), keeps
    a bounded ring of per-step totals, and fires ``ALERT_KINDS``
    alerts — each alert increments ``serving.alerts{kind}`` AND rides
    the flight recorder as an ``alert`` event, so a replayed trace
    fires the same alert at the same step.  Alerts LATCH: a condition
    fires once on crossing and re-arms only after it clears, so one
    sustained incident is one alert, not one per step.

    Drive it directly (``observe(...)`` once per scheduler step) or
    attach it to a router (``Router(monitor=...)``), which binds the
    router's registry/recorder as defaults and observes at the end of
    every ``router.step()``.
    """

    def __init__(self, *, slo_target: float = 0.99,
                 window_steps: int = 32,
                 burn_threshold: float = 1.0,
                 queue_saturation_depth: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None,
                 flight_recorder: Optional[FlightRecorder] = None):
        if not 0.0 < slo_target < 1.0:
            raise ValueError(
                f"slo_target must be in (0, 1), got {slo_target}")
        if window_steps < 2:
            raise ValueError(
                f"window_steps must be >= 2, got {window_steps}")
        if burn_threshold <= 0:
            raise ValueError(
                f"burn_threshold must be > 0, got {burn_threshold}")
        self.slo_target = float(slo_target)
        self.window_steps = int(window_steps)
        self.burn_threshold = float(burn_threshold)
        self.queue_saturation_depth = (
            None if queue_saturation_depth is None
            else int(queue_saturation_depth))
        self._registry = registry
        self._fr = flight_recorder
        self._m: Optional[_MonitorInstruments] = None
        self._ring: deque = None  # created on first observe
        self._alerts: List[dict] = []
        self._latched: set = set()   # (kind, key) pairs currently firing
        self._prev_health: List[str] = []
        if registry is not None:
            self._m = _MonitorInstruments(registry)

    # -- binding (Router(monitor=...) calls this) --
    def _bind(self, registry: MetricsRegistry,
              flight_recorder: FlightRecorder):
        """Adopt the router's registry/recorder UNLESS explicitly
        constructed with our own (the FlightRecorder.bind_clock
        discipline)."""
        if self._registry is None:
            self._registry = registry
        if self._fr is None:
            self._fr = flight_recorder
        if self._m is None:
            self._m = _MonitorInstruments(self._registry)

    def _instruments(self) -> _MonitorInstruments:
        if self._m is None:
            if self._registry is None:
                self._registry = get_registry()
            self._m = _MonitorInstruments(self._registry)
        return self._m

    # -- observation --
    def _tenant_totals(self, registries) -> Dict[str, List[int]]:
        """{tenant: [attained, missed]} summed over classes and the
        DEDUPLICATED registry set (replicas may share one registry —
        summing it per replica would multiply every outcome)."""
        seen = set()
        out: Dict[str, List[int]] = {}
        for reg in registries:
            # dedupe by the registry's STABLE key when it has one —
            # remote-replica registry shims are fresh objects per
            # fetch, so id() would double-count one shared server
            # registry; id() remains the bare-object fallback
            k = getattr(reg, "dedupe_key", None) or id(reg)
            if reg is None or k in seen:
                continue
            seen.add(k)
            for name, slot in (("serving.slo.attained", 0),
                               ("serving.slo.missed", 1)):
                inst = reg.get(name)
                if inst is None:
                    continue
                for lk, v in inst._snap()["values"].items():
                    tenant = _label_value(lk, "tenant") or "default"
                    out.setdefault(tenant, [0, 0])[slot] += int(v)
        return out

    def _fire(self, kind: str, step: int, **attrs):
        self._alerts.append({"kind": kind, "step": int(step), **attrs})
        if self._fr is not None:
            self._fr.emit("alert", ENGINE_EVENT, step, kind=kind,
                          **attrs)

    def observe(self, *, step: int, registries: Sequence = (),
                health: Sequence[str] = (),
                queue_depth: int = 0,
                max_queue: Optional[int] = None):
        """One monitoring tick.  Deterministic: reads only counters
        and the passed scheduler state, never the clock."""
        m = self._instruments()
        m.monitor_steps.inc()
        if self._ring is None:
            self._ring = deque(maxlen=self.window_steps)
        totals = self._tenant_totals(registries)
        self._ring.append({"step": int(step), "tenants": {
            t: list(v) for t, v in totals.items()}})
        base = self._ring[0]["tenants"]
        budget_frac = 1.0 - self.slo_target
        for tenant in sorted(totals):
            att, miss = totals[tenant]
            batt, bmiss = base.get(tenant, (0, 0))
            datt, dmiss = att - batt, miss - bmiss
            denom = datt + dmiss
            burn = ((dmiss / denom) / budget_frac) if denom else 0.0
            m.burn_rate.set(burn, tenant=tenant)
            key = ("burn_rate", tenant)
            if burn >= self.burn_threshold:
                if key not in self._latched:
                    self._latched.add(key)
                    m.alerts.inc(kind="burn_rate")
                    self._fire("burn_rate", step, tenant=tenant,
                               burn=round(burn, 6))
            else:
                self._latched.discard(key)
            total = att + miss
            key = ("budget_exhausted", tenant)
            if total and miss > budget_frac * total:
                if key not in self._latched:
                    self._latched.add(key)
                    m.alerts.inc(kind="budget_exhausted")
                    self._fire("budget_exhausted", step, tenant=tenant,
                               missed=miss, total=total)
            else:
                self._latched.discard(key)
        for i, state in enumerate(health):
            key = ("replica_unhealthy", i)
            if state == "unhealthy":
                if key not in self._latched:
                    self._latched.add(key)
                    m.alerts.inc(kind="replica_unhealthy")
                    self._fire("replica_unhealthy", step, engine=i)
            else:
                self._latched.discard(key)
        self._prev_health = list(health)
        threshold = (self.queue_saturation_depth
                     if self.queue_saturation_depth is not None
                     else max_queue)
        key = ("queue_saturation", "")
        if threshold is not None and queue_depth >= threshold:
            if key not in self._latched:
                self._latched.add(key)
                m.alerts.inc(kind="queue_saturation")
                self._fire("queue_saturation", step,
                           depth=int(queue_depth),
                           threshold=int(threshold))
        else:
            self._latched.discard(key)

    # -- queries --
    def alerts(self) -> List[dict]:
        """Every alert fired so far (kind, step, context attrs), in
        firing order — deterministic across replays."""
        return list(self._alerts)

    def burn_rates(self) -> Dict[str, float]:
        """Current windowed burn rate per tenant."""
        if not self._ring:
            return {}
        newest, base = self._ring[-1]["tenants"], self._ring[0]["tenants"]
        out = {}
        for t, (att, miss) in sorted(newest.items()):
            batt, bmiss = base.get(t, (0, 0))
            denom = (att - batt) + (miss - bmiss)
            out[t] = (((miss - bmiss) / denom) / (1.0 - self.slo_target)
                      if denom else 0.0)
        return out

    def budgets(self) -> Dict[str, dict]:
        """Lifetime error-budget accounting per tenant: the budget is
        ``(1 - slo_target)`` of all SLO-carrying outcomes; consumed
        is the missed fraction of it (>= 1.0 = exhausted)."""
        if not self._ring:
            return {}
        out = {}
        frac = 1.0 - self.slo_target
        for t, (att, miss) in sorted(self._ring[-1]["tenants"].items()):
            total = att + miss
            budget = frac * total
            out[t] = {"attained": att, "missed": miss, "total": total,
                      "budget": budget,
                      "consumed": (miss / budget) if budget else 0.0}
        return out

    def summary(self) -> dict:
        """The snapshot-ready view ``Router.fleet_snapshot()``
        embeds."""
        by_kind: Dict[str, int] = {}
        for a in self._alerts:
            by_kind[a["kind"]] = by_kind.get(a["kind"], 0) + 1
        return {"slo_target": self.slo_target,
                "window_steps": self.window_steps,
                "burn_threshold": self.burn_threshold,
                "burn_rate": self.burn_rates(),
                "budget": self.budgets(),
                "alerts": list(self._alerts),
                "alerts_by_kind": by_kind}
